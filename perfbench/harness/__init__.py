"""The benchmark harness: set-up, measurement, tracing and the check."""
