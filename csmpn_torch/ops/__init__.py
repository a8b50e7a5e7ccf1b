"""Segment reductions and the hand-written CUDA kernels of the port."""
from .segment import (  # noqa: F401
    knn_graph,
    masked_mean,
    segment_mean,
    segment_sum,
    sort_edges_by_target,
)
