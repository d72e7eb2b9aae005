"""Data parallelism over processes, one card each (counterpart of
``upp_tpu/parallel/mesh.py``): the process group and its collectives
(``dist``) and the global batch a train step is one rank's share of
(``shard``)."""
