"""Window ms a batch of the program's downstream span, the device's idle in it included."""
from harness.spans import downstream_window_ms as read  # noqa: F401
