"""The device's idle share over the profiled steps, in %."""
from harness.readers import device_idle as read  # noqa: F401
