"""Window ms a batch of the program's chamfer span, the device's idle in it included."""
from harness.spans import chamfer_window_ms as read  # noqa: F401
