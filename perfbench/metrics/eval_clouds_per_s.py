"""Clouds of every batch completed in the window over the window's seconds."""
from harness.readers import clouds_per_s as read  # noqa: F401
