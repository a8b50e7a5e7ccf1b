"""Simplicial data layer: big-graph flattening, static-shape batching, array
datasets and the task dataset facades."""
