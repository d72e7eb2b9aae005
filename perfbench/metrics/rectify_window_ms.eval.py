"""Window ms a batch of the program's rectify span, the device's idle in it included."""
from harness.spans import rectify_window_ms as read  # noqa: F401
