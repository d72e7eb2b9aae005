"""Host syncs a batch inside the program's eval step span, from the profiled batches."""
from harness.spans import host_syncs as read  # noqa: F401
