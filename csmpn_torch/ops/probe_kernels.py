"""P1-P3 — the envelope probe's kernels: CUDA wrappers and plain versions.

Port of the three Pallas kernels of ``tools/mxu_probe.py``; the kernels are
``csrc/envelope.cu``.  On a CUDA tensor a wrapper launches its kernel (or
raises); on a CPU tensor it computes the plain version.

* P1 ``copy_scale``: ``o = x * 2`` over (R, D) float32 in tiles of
  ``tile_rows`` rows, one CTA per tile (the TPU probe's ``copy.kernel``).
* P2 ``resident_matmul``: ``acc += a_r @ b`` for r = 1..reps with
  ``a_{r+1} = a_r + a_r * 1e-7`` in the operand type (the probe's
  ``resident.kernel``), in one of three modes: ``bf16`` (bf16 operands on
  the tensor cores), ``tf32`` (fp32 operands rounded to tf32 on the tensor
  cores) and ``fp32`` (FFMA on the CUDA cores).
* P3 ``fma_chain``: ``v <- v * 1.0001 + 0.001``, ``steps`` times (the
  probe's ``vpu.kernel``); the kernel fuses each step into one FMA, the
  plain version rounds twice.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build

MODES = ("bf16", "tf32", "fp32")
EPS = 1e-7                      # the resident matmul's perturbation
FMA_MUL, FMA_ADD = 1.0001, 0.001
TILE_M, TILE_N, DEPTH = 64, 128, 32   # P2's CTA tile; K a multiple of DEPTH
SMEM_LIMIT = 232448             # shared memory one CTA can use (H100)

COPY_LAUNCHES = _build.LaunchCounter("probe_copy")
RESIDENT_LAUNCHES = {m: _build.LaunchCounter(f"probe_resident_{m}")
                     for m in MODES}
FMA_LAUNCHES = _build.LaunchCounter("probe_fma_chain")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGS = {
    "csmpn_probe_copy": ([_P, _P, _I64, _I, _I, _P], ctypes.c_int),
    "csmpn_probe_resident": ([_P, _P, _P, _I, _I, _I, _I, _I, _P],
                             ctypes.c_int),
    "csmpn_probe_fma_chain": ([_P, _P, _I64, _I, _P], ctypes.c_int),
}


def _fn(name: str):
    fn = getattr(_build.load("envelope"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGS[name]
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _f32_cuda(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {t.dtype}")
    return t.contiguous()


# ------------------------------------------------------------------ P1

def copy_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain P1: ``x * 2``."""
    return x * 2.0


def copy_scale(x: torch.Tensor, tile_rows: int = 1024) -> torch.Tensor:
    """P1.  x (R, D) float32, D a multiple of 4; one CTA per
    ``tile_rows`` rows.  Exact: equal to ``x * 2`` bit for bit."""
    if not x.is_cuda:
        return copy_scale_plain(x)
    x = _f32_cuda(x, "x")
    if x.dim() != 2 or x.shape[1] % 4 != 0:
        raise ValueError(f"x must be (R, D) with D % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    out = torch.empty_like(x)
    err = _fn("csmpn_probe_copy")(x.data_ptr(), out.data_ptr(), x.shape[0],
                                  x.shape[1], tile_rows, _stream(x))
    _build.check(err, "probe copy kernel")
    COPY_LAUNCHES.add()
    return out


# ------------------------------------------------------------------ P2

def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 rounded to tf32 (10 mantissa bits) as ``cvt.rna.tf32.f32``
    does: to nearest, ties away from zero.  On the bits: add 0x1000 to the
    magnitude, clear the low 13 bits; infinities and NaNs pass as they
    are."""
    bits = x.float().contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) | (bits & ~0x7FFFFFFF)
    return torch.where(mag < 0x7F800000, rounded, bits).view(torch.float32)


@contextlib.contextmanager
def tf32_matmul(allow: bool):
    """Float32 products with TF32 allowed or not, restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def resident_matmul_plain(a: torch.Tensor, b: torch.Tensor, reps: int,
                          mode: str) -> torch.Tensor:
    """Plain P2: a loop over reps of fp32 products (TF32 off) of the
    operands in the mode's type, each added to the fp32 sum, with
    ``a <- a + a * 1e-7`` in the operand type between reps."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dt = torch.bfloat16 if mode == "bf16" else torch.float32
    a, b = a.to(dt), b.to(dt)
    eps = torch.tensor(EPS, dtype=dt, device=a.device)
    bb = round_tf32(b) if mode == "tf32" else b.float()
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32,
                      device=a.device)
    with tf32_matmul(False):
        for _ in range(reps):
            aa = round_tf32(a) if mode == "tf32" else a.float()
            acc = acc + aa @ bb
            a = a + a * eps
    return acc


def resident_smem_bytes(k: int, mode: str) -> int:
    """Shared memory of one P2 CTA (its A and B panels, padded), as the
    kernel computes it."""
    pad = {"bf16": (8, 2), "tf32": (4, 4), "fp32": (0, 4)}[mode]
    return (TILE_M + TILE_N) * (k + pad[0]) * pad[1]


def resident_matmul(a: torch.Tensor, b: torch.Tensor, reps: int,
                    mode: str) -> torch.Tensor:
    """P2.  a (M, K) and b (K, N) float32, read once and held on chip;
    returns the (M, N) float32 sum over reps.  M % 64 == 0,
    N % 128 == 0, K % 32 == 0 and the panels must fit one CTA's shared
    memory (K <= 288 in tf32 and fp32 mode)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not a.is_cuda:
        return resident_matmul_plain(a, b, reps, mode)
    a, b = _f32_cuda(a, "a"), _f32_cuda(b, "b")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m % TILE_M or n % TILE_N or k % DEPTH or k == 0:
        raise ValueError(f"M, K, N = {m}, {k}, {n}: need M % {TILE_M}, "
                         f"N % {TILE_N} and K % {DEPTH} == 0, K > 0")
    if resident_smem_bytes(k, mode) > SMEM_LIMIT:
        raise ValueError(f"K = {k} does not fit one CTA's shared memory in "
                         f"{mode} mode")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    out = torch.empty(m, n, dtype=torch.float32, device=a.device)
    err = _fn("csmpn_probe_resident")(a.data_ptr(), b.data_ptr(),
                                      out.data_ptr(), m, k, n, reps,
                                      MODES.index(mode), _stream(a))
    _build.check(err, f"probe resident matmul kernel ({mode})")
    RESIDENT_LAUNCHES[mode].add()
    return out


# ------------------------------------------------------------------ P3

def fma_chain_plain(x: torch.Tensor, steps: int = 256) -> torch.Tensor:
    """Plain P3: ``v = v * 1.0001 + 0.001``, ``steps`` times (two
    roundings a step)."""
    v = x
    for _ in range(steps):
        v = v * FMA_MUL + FMA_ADD
    return v


def fma_chain(x: torch.Tensor, steps: int = 256) -> torch.Tensor:
    """P3.  x float32 with a multiple of 8 elements; each step one fused
    multiply-add (one rounding)."""
    if not x.is_cuda:
        return fma_chain_plain(x, steps)
    x = _f32_cuda(x, "x")
    if x.numel() % 8:
        raise ValueError(f"x must hold a multiple of 8 elements, got "
                         f"{x.numel()}")
    out = torch.empty_like(x)
    err = _fn("csmpn_probe_fma_chain")(x.data_ptr(), out.data_ptr(),
                                       x.numel(), steps, _stream(x))
    _build.check(err, "probe fma chain kernel")
    FMA_LAUNCHES.add()
    return out
