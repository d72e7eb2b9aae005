"""FPS, kNN and Chamfer kernel launches a step, counted by name in the device-only profile."""
from harness.spans import point_launches as read  # noqa: F401
