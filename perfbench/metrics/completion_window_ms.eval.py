"""Window ms a batch of the program's completion span, the device's idle in it included."""
from harness.spans import completion_window_ms as read  # noqa: F401
