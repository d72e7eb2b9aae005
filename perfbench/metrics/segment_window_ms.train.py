"""Window ms a step of the program's segment span (the seg models' label
embedding, propagation to the query points and seg head), the device's idle
in it included; nothing where the program has no such span."""
from harness.spans import _span_ms


def read(run):
    return _span_ms(run, "segment", "window_ms")
