"""CUDA graph replays a batch inside the program's eval step span (counter
``cuda_graph.replays``), from the profiled batches; 0 where the program
replays none."""
from harness.spans import _counter


def read(run):
    return _counter(run, "cuda_graph.replays")
