"""The point kernels' (FPS, kNN, Chamfer) share of their roofline, in %."""
from harness.readers import kernel_roofline as read  # noqa: F401
