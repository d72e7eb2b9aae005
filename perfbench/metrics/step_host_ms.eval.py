"""Host ms of the program's eval_step or pretask_eval_step span, from the profiled batches."""
from harness.spans import step_host_ms as read  # noqa: F401
