"""K1 — the sorted segment sum: CUDA kernel wrapper and its plain version.

Port of ``csmpn_tpu/ops/pallas_segment.py`` (``sorted_segment_sum_pallas``).
The kernel is ``csrc/segment_sum.cu``.  On a CUDA tensor the wrapper
launches it (or raises); on a CPU tensor it computes the plain version.

    out[s] = sum_{e : ids[e] == s, mask[e]} data[e]      ids ascending

with an optional masked mean (divide by the rows kept, empty segments give
0).  Ids >= num_segments are sentinels and are dropped.  ``exact=False``
rounds float32 rows to bf16 before the fp32 sum, as the TPU kernel feeds
its matrix unit; bf16 rows are summed in fp32 either way.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = _build.LaunchCounter("sorted_segment_sum")

_argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.csmpn_segment_sum
    if fn.argtypes is None:
        fn.argtypes = _argtypes
        fn.restype = ctypes.c_int
    return fn


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int, exact: bool = True,
                      mask: Optional[torch.Tensor] = None,
                      mean: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1.  Returns (out (N, D) float32,
    kept-row counts (N,) float32)."""
    x = data.float()
    if not exact:
        x = x.to(torch.bfloat16).float()
    keep = segment_ids < num_segments
    if mask is not None:
        keep = keep & mask.bool()
    ids = torch.clamp(segment_ids.long(), max=num_segments)
    x = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    out = x.new_zeros((num_segments + 1, x.shape[1])).index_add_(0, ids, x)
    counts = x.new_zeros(num_segments + 1).index_add_(0, ids, keep.float())
    out, counts = out[:num_segments], counts[:num_segments]
    if mean:
        out = out / torch.clamp(counts, min=1.0)[:, None]
    return out, counts


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, exact: bool = True,
                       mask: Optional[torch.Tensor] = None,
                       mean: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1.  data (E, D) float32 or bfloat16, segment_ids (E,) int32 or
    int64 sorted ascending, mask (E,) bool or None.  Returns (out (N, D)
    float32, counts (N,) float32).  On the card this is one kernel launch
    (the kernel finds the segment bounds in the ids itself and reads the
    bool mask as its bytes) and the two output allocations."""
    if not data.is_cuda:
        return segment_sum_plain(data, segment_ids, num_segments, exact,
                                 mask, mean)
    if data.dim() != 2:
        raise ValueError(f"data must be (E, D), got {tuple(data.shape)}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"data dtype {data.dtype} not supported")
    e, d = data.shape
    if segment_ids.shape != (e,) or segment_ids.device != data.device:
        raise ValueError("segment_ids must be (E,) on the data's device")
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids dtype {segment_ids.dtype} not "
                        f"supported (int32 or int64)")
    if mask is not None and (mask.shape != (e,) or mask.device != data.device
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be (E,) bool on the data's device")
    if num_segments > _build.MAX_COUNT or d > _build.MAX_COUNT:
        raise NotImplementedError(
            f"sorted_segment_sum: {num_segments} segments of {d} columns; "
            f"the kernel takes at most {_build.MAX_COUNT} of each")
    data = data.contiguous()
    segment_ids = segment_ids.contiguous()
    mask = mask.contiguous() if mask is not None else None
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=data.device)
    counts = torch.empty(num_segments, dtype=torch.float32,
                         device=data.device)
    fn = _lib()
    err = fn(data.data_ptr(), 1 if data.dtype == torch.bfloat16 else 0,
             0 if exact else 1, segment_ids.data_ptr(),
             int(segment_ids.dtype == torch.int64),
             mask.data_ptr() if mask is not None else None,
             out.data_ptr(), counts.data_ptr(), e, num_segments, d,
             int(mean), torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "sorted_segment_sum kernel")
    LAUNCHES.add()
    return out, counts
