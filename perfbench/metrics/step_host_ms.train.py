"""Host ms of the program's train_step span, from the profiled steps."""
from harness.spans import step_host_ms as read  # noqa: F401
