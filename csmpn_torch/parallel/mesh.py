"""Data parallel over a ``torch.distributed`` process group, one process per
card.

Counterpart of ``csmpn_tpu/parallel/mesh.py``.  The JAX package shards a
global batch over a ``data`` mesh axis, replicates the parameters and lets
XLA insert the gradient psum.  Here every process holds a replica of the
model on its own device and trains on its own shard of each split (the
loaders' ``shard=(rank, world)``); the trainer all-reduces the gradients
between ``backward`` and the optimizer step, which is what
``DistributedDataParallel`` does.

* :func:`make_mesh`: this process's rank in the default process group,
  the world size and this rank's device (:class:`Mesh`).
* ``shard_batch`` has no function of its own: a rank's local batch moves
  to its device with ``batch.to(mesh.device)``, as any batch does.  The
  global batch is ``world`` local batches, rank 0's rows first: the JAX
  package's multi-process semantic (``make_array_from_process_local_data``).
  Its single-process mesh, which splits one batch over the devices of one
  process, has no counterpart: launch one process per card instead.
* :func:`replicate`: every parameter and buffer broadcast from rank 0.
* :func:`all_reduce_grads`: one all-reduce a dtype over a flat buffer of
  the gradients (and the step's loss) that leaves their mean over the
  ranks: the counterpart of XLA's gradient psum.  Over ``nccl`` it is one
  ``ReduceOp.AVG`` (each rank's values times 1 / world, summed), over
  ``gloo``, which has no AVG, a SUM and then a division by the world
  size.  NCCL runs an in-place SUM over one rank as no device work at
  all, and its AVG as one kernel, so a group of one still runs the
  collective on the card (inside a captured step too).  Over one rank
  AVG multiplies by 1.0, so the card's check at world 1 cannot tell a
  right reduction from a wrong one; the AVG branch at world > 1 is
  unmeasured (the CPU tests run the gloo branch at world 2).  With
  ``reduce="sum"`` it sums instead (one SUM over either backend): the
  gradient of edge-partitioned message passing, whose loss is the sum of
  the ranks' terms.

``batch_sharding``, ``replicated`` and ``shard_stacked`` build JAX
``NamedSharding``s and have no counterpart: a process's tensors live on
its one device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The default process group as data parallel sees it: this
    process's ``rank`` in it, its size ``world`` and this rank's
    ``device``."""
    rank: int
    world: int
    device: torch.device


def is_distributed() -> bool:
    """Whether a process group of more than one rank is up."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def is_master() -> bool:
    """Rank 0 of the process group, or a process without one."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def barrier() -> None:
    """Waits for every rank of a group of more than one rank."""
    if not is_distributed():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def make_mesh(device: Optional[torch.device] = None) -> Mesh:
    """The default process group as a :class:`Mesh`.  ``device`` defaults
    to the current card under ``nccl`` and to the CPU under ``gloo``.
    Raises when no process group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "data parallel needs a process group: launch one process per "
            "card with python -m torch.distributed.run --nproc_per_node N")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(rank=dist.get_rank(),
                world=dist.get_world_size(), device=torch.device(device))


def _by_dtype(tensors: Iterable[torch.Tensor]
              ) -> Dict[torch.dtype, List[torch.Tensor]]:
    out: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault(t.dtype, []).append(t)
    return out


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Copies ``flat`` back into ``tensors`` (one multi-tensor launch)."""
    views, o = [], 0
    for t in tensors:
        views.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    torch._foreach_copy_(tensors, views)


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: Mesh) -> None:
    """Every parameter and buffer of ``model`` set to rank 0's, one
    broadcast a dtype."""
    for tensors in _by_dtype([*model.parameters(),
                              *model.buffers()]).values():
        flat = _flat(tensors)
        dist.broadcast(flat, src=0)
        _unflat(flat, tensors)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], mesh: Mesh,
                     loss: Optional[torch.Tensor] = None,
                     reduce: str = "mean", group=None):
    """Averages the gradients of ``params`` over the ranks in place, and
    with them the scalar ``loss`` if one is given; returns the averaged
    loss (a view of the flat buffer) or None.  ``reduce="sum"`` sums them
    instead: the gradient of a loss that is the sum of the ranks' terms,
    as in edge-partitioned message passing, where each rank
    backpropagates its own term through replicated parameters.
    ``group``: the process group of ``mesh`` (the default group when
    None).

    Each dtype's gradients (the loss among them) go into one flat buffer,
    which one all-reduce averages over the ranks (module docstring).
    Every rank must hold a gradient for the same parameters.  Under CUDA
    graph capture the buffer comes from the graph's pool, so a replay
    reduces into the same memory."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce is 'mean' or 'sum', not {reduce!r}")
    grads = [p.grad for p in params if p.grad is not None]
    extra = [] if loss is None else [loss.detach().reshape(1)]
    avg = reduce == "mean" and dist.get_backend(group) == "nccl"
    out = None
    for tensors in _by_dtype(grads + extra).values():
        flat = _flat(tensors)
        if avg:
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            if reduce == "mean":
                flat.div_(mesh.world)
        if extra and tensors[-1] is extra[0]:
            out = flat[-1]
            tensors = tensors[:-1]
        _unflat(flat, tensors)
    return out
