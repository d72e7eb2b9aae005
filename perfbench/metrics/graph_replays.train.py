"""CUDA graph replays a step inside the program's train step span (counter
``cuda_graph.replays``), from the profiled steps; 0 where the program
replays none."""
from harness.spans import _counter


def read(run):
    return _counter(run, "cuda_graph.replays")
