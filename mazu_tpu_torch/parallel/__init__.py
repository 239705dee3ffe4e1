"""Sharded queries over a (data, bucket) mesh of devices: ``mesh``
(``DistMesh`` over ``torch.distributed``, ``SerialMesh`` in one process),
``sharding`` (the builders) and ``launch`` (a world of ranks for tests and
tools)."""
