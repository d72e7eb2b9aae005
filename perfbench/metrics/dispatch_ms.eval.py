"""Host ms a step spends inside the program's step call (profiler off)."""
from harness.readers import dispatch_ms as read  # noqa: F401
