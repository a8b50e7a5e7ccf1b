"""P1-P3 — the envelope probe's kernels: CUDA wrappers and plain versions.

Port of the three Pallas kernels of ``tools/mxu_probe.py``; the kernels are
``csrc/envelope.cu``.  On a CUDA tensor a wrapper launches its kernel (or
raises); on a CPU tensor it computes the plain version.

* P1 ``copy_scale``: ``o = x * 2`` over (R, D) float32 in tiles of
  ``tile_rows`` rows (the TPU probe's ``copy.kernel``): a grid of one wave
  (``copy_grid``) whose CTAs claim whole tiles and stream them through
  shared memory on TMA bulk copies; ``copy_walk`` mirrors the chunks a CTA
  copies.
* P2 ``resident_matmul``: ``acc += a_r @ b`` for r = 1..reps with
  ``a_{r+1} = a_r + a_r * 1e-7`` in the operand type (the probe's
  ``resident.kernel``), in one of three modes: ``bf16`` (bf16 operands on
  ``wgmma``), ``tf32`` (fp32 operands rounded to tf32 on ``wgmma``) and
  ``fp32`` (FFMA on the CUDA cores).  ``panel_offset`` and ``wgmma_desc``
  mirror the swizzled B panel and the descriptors the kernels give
  ``wgmma`` (csrc/wgmma.cuh).
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
TILE_M, TILE_N = 64, 128       # P2's CTA tile
# K a multiple of DEPTH[mode]; on wgmma at most WGMMA_MAX_K (its A is held
# in registers, one kernel instance per K / 64)
DEPTH = {"bf16": 64, "tf32": 64, "fp32": 32}
WGMMA_MAX_K = 256
SMEM_LIMIT = 232448             # shared memory one CTA can use (H100)
# P1's ring of shared-memory stages
COPY_STAGES, COPY_STAGE_BYTES = 6, 32768
# the ring, then a stage's mbarrier (8 bytes) and chunk (16) each
COPY_SMEM = COPY_STAGES * (COPY_STAGE_BYTES + 8 + 16)
# the 128-byte swizzle of wgmma's K-major B panel (csrc/wgmma.cuh)
ATOM_BYTES, GROUP_BYTES = 128, 1024

COPY_LAUNCHES = _build.LaunchCounter("probe_copy")
RESIDENT_LAUNCHES = {m: _build.LaunchCounter(f"probe_resident_{m}")
                     for m in MODES}
FMA_LAUNCHES = _build.LaunchCounter("probe_fma_chain")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGS = {
    "csmpn_probe_copy_slots": ([_P], ctypes.c_int),
    "csmpn_probe_copy": ([_P, _P, _I64, _I, _I, _I, _P, _P], ctypes.c_int),
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


def copy_grid(tiles: int, slots: int) -> int:
    """P1's grid: one wave, at most ``slots`` CTAs (as many as the card
    holds at once) and no more than there are tiles."""
    return min(tiles, slots)


def copy_chunks(rows: int, row_bytes: int, tile_rows: int,
                chunk: int = COPY_STAGE_BYTES):
    """The bulk copies of P1, as csrc/envelope.cu's ``TileClaims`` cuts
    them: for each tile of ``tile_rows`` rows (the last one ragged), its
    bytes in pieces of at most ``chunk``; a list per tile of (byte offset,
    bytes)."""
    tiles = -(-rows // tile_rows)
    out = []
    for t in range(tiles):
        size = (min(rows, (t + 1) * tile_rows) - t * tile_rows) * row_bytes
        out.append([(t * tile_rows * row_bytes + off, min(chunk, size - off))
                    for off in range(0, size, chunk)])
    return out


def copy_walk(rows: int, row_bytes: int, tile_rows: int, grid: int,
              order=None):
    """The copies each CTA of P1 makes when the CTAs ask the claim counter
    in ``order`` (a sequence of CTA indices, one entry per claim; default
    round robin): every claim takes the next tile, and a CTA stops at its
    first claim past the last tile.  A list per CTA of (byte offset,
    bytes)."""
    chunks = copy_chunks(rows, row_bytes, tile_rows)
    walks = [[] for _ in range(grid)]
    asking = list(order) if order is not None else [
        i % grid for i in range(len(chunks) + grid)]
    done, nxt = set(), 0
    for cta in asking:
        if cta in done:
            continue
        if nxt < len(chunks):
            walks[cta].extend(chunks[nxt])
            nxt += 1
        else:
            done.add(cta)
    return walks


_SLOTS: dict = {}
_CLAIMS: dict = {}


def copy_slots(device: torch.device) -> int:
    """How many CTAs of P1 the card holds at once (its SMs times the CTAs
    an SM takes), asked of the CUDA runtime once."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _SLOTS:
        slots = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = _fn("csmpn_probe_copy_slots")(ctypes.addressof(slots))
        _build.check(err, "probe copy occupancy")
        _SLOTS[index] = slots.value
    return _SLOTS[index]


def copy_claims(device: torch.device, stream: int) -> torch.Tensor:
    """P1's tile-claim counters for a launch on ``stream`` of ``device``.
    They are zero between launches (each launch's last CTA sets them back
    to zero), so the launches of one stream, which run in its order, share
    a pair, and each stream has its own, since launches on two streams may
    run at once.  Under CUDA-graph capture a new pair, zeroed by the graph
    itself, so that no replay shares a counter with another launch.  (A
    kernel that faults leaves the context unable to run any later
    launch.)"""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(2, dtype=torch.int32, device=device)
    key = (device, stream)
    if key not in _CLAIMS:
        _CLAIMS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _CLAIMS[key]


def copy_scale(x: torch.Tensor, tile_rows: int = 1024) -> torch.Tensor:
    """P1.  x (R, D) float32, D a multiple of 4, 16-byte aligned; a grid
    of one wave walks the tiles of ``tile_rows`` rows (``copy_grid``).
    Exact: equal to ``x * 2`` bit for bit.  An empty x launches
    nothing."""
    if not x.is_cuda:
        return copy_scale_plain(x)
    x = _f32_cuda(x, "x")
    if x.dim() != 2 or x.shape[1] % 4 != 0:
        raise ValueError(f"x must be (R, D) with D % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    if x.shape[0] > _build.MAX_COUNT:
        raise ValueError(f"at most {_build.MAX_COUNT} rows, got "
                         f"{x.shape[0]}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    stream = _stream(x)
    grid = copy_grid(-(-x.shape[0] // tile_rows), copy_slots(x.device))
    err = _fn("csmpn_probe_copy")(x.data_ptr(), out.data_ptr(), x.shape[0],
                                  x.shape[1], tile_rows, grid,
                                  copy_claims(x.device, stream).data_ptr(),
                                  stream)
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


def panel_offset(row: int, k: int, rows: int, esize: int) -> int:
    """Byte offset of element (row, k) of a K-major operand panel of
    ``rows`` rows in wgmma's 128-byte swizzle, as csrc/wgmma.cuh stores
    it: atoms of [rows][128 bytes] one after another along K, and in an
    atom the 16-byte unit c of row r at unit c ^ (r % 8)."""
    byte = k * esize
    unit, atom = (byte // 16) % 8, byte // ATOM_BYTES
    return (atom * rows * ATOM_BYTES + row * ATOM_BYTES
            + ((unit ^ (row % 8)) << 4) + byte % 16)


def wgmma_desc(addr: int) -> int:
    """wgmma's shared-memory descriptor of a K-major, 128-byte-swizzled
    operand at shared address ``addr``, as csrc/wgmma.cuh encodes it."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16)
            | ((GROUP_BYTES >> 4) << 32) | (1 << 62))


def desc_fields(desc: int) -> dict:
    """The fields of a descriptor, in bytes where the PTX ISA scales by
    16: start address, leading and stride byte offsets, base offset,
    layout type (1: 128-byte swizzle)."""
    return {"start": (desc & 0x3FFF) << 4,
            "lbo": ((desc >> 16) & 0x3FFF) << 4,
            "sbo": ((desc >> 32) & 0x3FFF) << 4,
            "base_offset": (desc >> 49) & 0x7,
            "layout": (desc >> 62) & 0x3}


def kstep_desc(base: int, step: int, rows: int) -> int:
    """The descriptor of k-step ``step`` (32 bytes of each row) of a panel
    of ``rows`` rows at ``base``: atom step // 4, (step % 4) * 32 bytes
    in."""
    return wgmma_desc(base + (step // 4) * rows * ATOM_BYTES
                      + (step % 4) * 32)


def resident_smem_bytes(k: int, mode: str) -> int:
    """Shared memory of one P2 CTA as the kernel asks for it: on wgmma B's
    panel in the operand type plus 1,024 bytes to align it; on FFMA both
    fp32 panels."""
    if mode == "fp32":
        return (TILE_M + TILE_N) * k * 4
    return TILE_N * k * (2 if mode == "bf16" else 4) + 1024


def resident_shape_error(m: int, k: int, n: int, mode: str):
    """Why the P2 kernel of ``mode`` does not take (M, K) @ (K, N), or
    None: M % 64, N % 128 and K % DEPTH[mode] == 0, K > 0; on wgmma
    K <= 256; the panels within one CTA's shared memory."""
    if m % TILE_M or n % TILE_N or k % DEPTH[mode] or k <= 0:
        return (f"M, K, N = {m}, {k}, {n}: need M % {TILE_M}, N % {TILE_N} "
                f"and K % {DEPTH[mode]} == 0, K > 0 in {mode} mode")
    if mode != "fp32" and k > WGMMA_MAX_K:
        return f"K = {k} > {WGMMA_MAX_K} in {mode} mode"
    if resident_smem_bytes(k, mode) > SMEM_LIMIT:
        return f"K = {k} does not fit one CTA's shared memory in {mode} mode"
    return None


def resident_matmul(a: torch.Tensor, b: torch.Tensor, reps: int,
                    mode: str) -> torch.Tensor:
    """P2.  a (M, K) and b (K, N) float32, read once and held on chip;
    returns the (M, N) float32 sum over reps.  The shapes it takes are
    ``resident_shape_error``'s (K <= 288 in fp32 mode)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if not a.is_cuda:
        return resident_matmul_plain(a, b, reps, mode)
    a, b = _f32_cuda(a, "a"), _f32_cuda(b, "b")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    why = resident_shape_error(m, k, n, mode)
    if why:
        raise ValueError(why)
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if reps == 0:
        return torch.zeros(m, n, dtype=torch.float32, device=a.device)
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
