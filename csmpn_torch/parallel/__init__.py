"""Scale-out: data parallel over a ``torch.distributed`` process group, one
process per card (``mesh``), and the partition of a complex's edges by
target node with the one-card streaming path over its chunks and the
edge-partitioned layers across ranks (``edge_partition``)."""
