"""Device ms a step in GEMM kernels, from the profiled steps."""
from harness.readers import gemm_ms as read  # noqa: F401
