"""Scale-out of the EGCL layer: the partition of a complex's edges by
target node, and the one-card streaming path over its chunks
(``edge_partition``)."""
