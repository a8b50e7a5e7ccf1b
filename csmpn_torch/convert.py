"""Parameter conversion between the reference package's flax trees and the
port's ``state_dict``s.

The port's modules carry the flax parameter names and shapes, so the
conversion is a flattening of the nested dict: the flax path
``egcl_0 / edge_model / linear_0 / weight`` becomes the key
``egcl_0.edge_model.linear_0.weight``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (nested dicts of arrays, with or without the
    top-level ``"params"`` collection) -> ``state_dict`` of the port."""
    if set(tree.keys()) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                walk(v, key)
            else:
                out[key] = torch.from_numpy(np.array(v, dtype=np.float32))

    walk(tree, "")
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse: ``state_dict`` -> nested dict of numpy arrays under
    ``"params"``."""
    tree: Dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.detach().cpu().numpy()
    return {"params": tree}
