"""Host ms of the program's optimizer span a step, from the profiled steps."""
from harness.spans import optimizer_host_ms as read  # noqa: F401
