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
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def csr_offsets(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """offsets[s] = first row with id >= s, for s in 0..N (int64)."""
    r = torch.arange(num_segments + 1, device=segment_ids.device,
                     dtype=segment_ids.dtype)
    return torch.searchsorted(segment_ids, r, side="left")


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int, exact: bool = True,
                       mask: Optional[torch.Tensor] = None,
                       mean: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1.  data (E, D) float32 or bfloat16, segment_ids (E,) int sorted
    ascending, mask (E,) bool or None.  Returns (out (N, D) float32,
    counts (N,) float32)."""
    if not data.is_cuda:
        return segment_sum_plain(data, segment_ids, num_segments, exact,
                                 mask, mean)
    if data.dim() != 2:
        raise ValueError(f"data must be (E, D), got {tuple(data.shape)}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"data dtype {data.dtype} not supported")
    e, d = data.shape
    if segment_ids.shape != (e,) or not segment_ids.is_cuda:
        raise ValueError("segment_ids must be (E,) on the data's device")
    if mask is not None and (mask.shape != (e,) or not mask.is_cuda):
        raise ValueError("mask must be (E,) on the data's device")
    data = data.contiguous()
    offsets = csr_offsets(segment_ids.contiguous(), num_segments)
    mask_u8 = (mask.contiguous().to(torch.uint8) if mask is not None
               else None)
    out = torch.empty((num_segments, d), dtype=torch.float32,
                      device=data.device)
    counts = torch.empty(num_segments, dtype=torch.float32,
                         device=data.device)
    fn = _lib()
    err = fn(data.data_ptr(), 1 if data.dtype == torch.bfloat16 else 0,
             0 if exact else 1, offsets.data_ptr(),
             mask_u8.data_ptr() if mask_u8 is not None else None,
             out.data_ptr(), counts.data_ptr(), num_segments, d, int(mean),
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.check(err, "sorted_segment_sum kernel")
    LAUNCHES.add()
    return out, counts
