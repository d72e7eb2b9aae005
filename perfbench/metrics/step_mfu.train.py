"""The whole step's model FLOPs against the card's float32 peak, in %."""
from harness.readers import step_mfu as read  # noqa: F401
