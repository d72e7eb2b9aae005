"""Host syncs a step inside the program's train_step span, from the profiled steps."""
from harness.spans import host_syncs as read  # noqa: F401
