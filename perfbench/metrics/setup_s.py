"""Seconds from process start to the start of the window."""
from harness.readers import setup_s as read  # noqa: F401
