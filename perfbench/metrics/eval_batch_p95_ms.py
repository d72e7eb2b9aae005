"""95th percentile of the host time from handing a batch in to holding its labels."""
from harness.readers import batch_p95_ms as read  # noqa: F401
