"""Parallelism over processes (counterpart of ``upp_tpu/parallel/mesh.py``):
the process groups and their collectives, a (data, model) grid of them
(``dist``), the global batch a train step is one data rank's share of
(``shard``), ZeRO-3 sharding of parameters and moments over the data ranks
(``fsdp``) and tensor parallelism of the transformer blocks over the model
ranks (``tensor``)."""
