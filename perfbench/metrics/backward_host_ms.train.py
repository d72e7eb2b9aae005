"""Host ms of the program's backward span a step, from the profiled steps."""
from harness.spans import backward_host_ms as read  # noqa: F401
