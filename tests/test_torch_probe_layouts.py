"""The host side of the envelope probe's P1 and P2 on Hopper: the Python
mirrors of what csrc/wgmma.cuh and csrc/envelope.cu lay out, and the
wrappers' shape rules and launches, on the CPU.

(a) wgmma's operand panels: the K-major layout with the 128-byte swizzle
    (``panel_offset``) is a bijection onto the panel's bytes, keeps every
    16-byte unit whole, matches the PTX ISA's 128B swizzle pattern (unit c
    of row r at c ^ (r % 8)) and CUTLASS's Swizzle<3,4,3> of the plain
    address; the descriptor's fields are what the ISA asks; the descriptor
    of every k-step, resolved as the hardware does (start + (r / 8) * SBO
    + (r % 8) * 128 + byte, then the address swizzle), lands on that
    step's slice of B's panel.
(b) P1's walk: at R = 131,072 and a ragged R = 131,109 and every tile
    height, the chunks the CTAs copy cover the rows exactly once, in any
    order of claims, each a multiple of 16 bytes, none crossing a tile, the
    ring within one CTA's shared memory.
(c) ``resident_smem_bytes`` and the shape rules at the wgmma tile, and the
    wrappers on a tensor that says it lies on the card: the mode, grid,
    claim counters and counts they hand the C entry, and what they
    refuse.
The kernels themselves are held to the plain versions on the card by
chip_smoke.py.
"""
import ctypes

import numpy as np
import pytest
import torch

from csmpn_torch.ops import probe_kernels as pk
from csmpn_torch.tools import envelope_probe as ep

ESIZE = {"bf16": 2, "tf32": 4}
K = 256


def swizzle128(addr):
    """CUTLASS's Swizzle<3,4,3>: address bits 4-6 xor bits 7-9."""
    return addr ^ ((addr & 0x380) >> 3)


def offsets(rows, esize, k=K):
    r, kk = np.meshgrid(np.arange(rows), np.arange(k), indexing="ij")
    return np.vectorize(lambda a, b: pk.panel_offset(a, b, rows, esize))(
        r, kk)


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("mode", ["bf16", "tf32"])
@pytest.mark.parametrize("rows", [pk.TILE_M, pk.TILE_N])
def test_panel_layout_is_a_bijection(mode, rows):
    esize = ESIZE[mode]
    off = offsets(rows, esize)
    assert (off % esize == 0).all()
    assert sorted(off.ravel().tolist()) == list(range(0, rows * K * esize,
                                                      esize))


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_panel_keeps_16_byte_units_whole(mode):
    esize = ESIZE[mode]
    per = 16 // esize
    off = offsets(pk.TILE_N, esize)
    units = off.reshape(pk.TILE_N, K // per, per)
    assert (units[:, :, 0] % 16 == 0).all()
    assert (np.diff(units, axis=2) == esize).all()


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_panel_matches_the_128b_swizzle_pattern(mode):
    esize = ESIZE[mode]
    rows = pk.TILE_N
    # the PTX ISA's 128-byte swizzle: in 8 rows of 128 bytes, row r holds
    # the 16-byte units in the order c ^ r
    isa = [[0, 1, 2, 3, 4, 5, 6, 7], [1, 0, 3, 2, 5, 4, 7, 6],
           [2, 3, 0, 1, 6, 7, 4, 5], [3, 2, 1, 0, 7, 6, 5, 4],
           [4, 5, 6, 7, 0, 1, 2, 3], [5, 4, 7, 6, 1, 0, 3, 2],
           [6, 7, 4, 5, 2, 3, 0, 1], [7, 6, 5, 4, 3, 2, 1, 0]]
    per_row = pk.ATOM_BYTES // esize
    for r in range(rows):
        for k in range(0, K, 16 // esize):
            off = pk.panel_offset(r, k, rows, esize)
            atom, unit = divmod((k * esize) // 16, 8)
            assert off == (atom * rows * pk.ATOM_BYTES + r * pk.ATOM_BYTES
                           + isa[r % 8][unit] * 16)
            plain = (k // per_row) * rows * pk.ATOM_BYTES + r * 128 + (
                k % per_row) * esize
            assert off == swizzle128(plain)


def test_descriptor_fields():
    for addr in (0, 0x400, 0x10400, 0x37C00):
        d = pk.wgmma_desc(addr)
        f = pk.desc_fields(d)
        assert f == {"start": addr, "lbo": 16, "sbo": pk.GROUP_BYTES,
                     "base_offset": 0, "layout": 1}
        # nothing outside the fields: bits 14-15, 30-31, 46-48, 52-61
        assert d & ~((0x3FFF) | (0x3FFF << 16) | (0x3FFF << 32)
                     | (0x7 << 49) | (0x3 << 62)) == 0
    assert pk.wgmma_desc(0x1230) & 0x3FFF == 0x123


@pytest.mark.parametrize("mode", ["bf16", "tf32"])
def test_kstep_descriptors_land_on_their_slices(mode):
    """The 128 rows an n128 product reads from the descriptor of k-step s
    of B's panel hold k in [s * kstep, (s + 1) * kstep): bytes 32 s ..
    32 s + 31 of each row, wherever the swizzle put them."""
    esize = ESIZE[mode]
    kstep = 32 // esize
    rows = pk.TILE_N
    base = 0x10400 - 0x400   # a 1,024-aligned panel in shared memory
    for s in range(K // kstep):
        f = pk.desc_fields(pk.kstep_desc(base, s, rows))
        for r in range(rows):
            for byte in range(32):
                canon = (f["start"] + (r // 8) * f["sbo"] + (r % 8) * 128
                         + byte)
                want = base + pk.panel_offset(r, s * kstep + byte // esize,
                                              rows, esize) + byte % esize
                assert swizzle128(canon) == want, (s, r, byte)


# ------------------------------------------------------------------ (b)

ROW_BYTES = ep.COLS * 4
SLOTS = 132     # P1 on an H100: one CTA an SM


def check_cover(walks, rows, tile_rows):
    tile_bytes = tile_rows * ROW_BYTES
    chunks = sorted(c for w in walks for c in w)
    pos = 0
    for off, size in chunks:
        assert off == pos, "a gap or an overlap"
        assert size > 0 and size % 16 == 0 and size <= pk.COPY_STAGE_BYTES
        assert off // tile_bytes == (off + size - 1) // tile_bytes
        pos += size
    assert pos == rows * ROW_BYTES


@pytest.mark.parametrize("rows", [131072, 131109])
@pytest.mark.parametrize("tile_rows", ep.TILES)
def test_copy_walk_covers_every_row_once(rows, tile_rows):
    tiles = -(-rows // tile_rows)
    grid = pk.copy_grid(tiles, SLOTS)
    assert grid == min(tiles, SLOTS)
    walks = pk.copy_walk(rows, ROW_BYTES, tile_rows, grid)
    assert len(walks) == grid and all(walks)
    check_cover(walks, rows, tile_rows)
    # round robin: tile t goes to CTA t % grid
    tile_bytes = tile_rows * ROW_BYTES
    for cta, w in enumerate(walks):
        assert {off // tile_bytes % grid for off, _ in w} == {cta}
    # any order of claims covers the rows once too
    rng = np.random.RandomState(tile_rows + rows)
    order = rng.randint(0, grid, size=8 * (tiles + grid))
    check_cover(pk.copy_walk(rows, ROW_BYTES, tile_rows, grid, order),
                rows, tile_rows)


def test_copy_ring_fits_one_cta():
    assert pk.COPY_STAGE_BYTES % 16 == 0
    assert pk.COPY_SMEM <= pk.SMEM_LIMIT < 2 * pk.COPY_SMEM
    chunks = pk.copy_chunks(131109, ROW_BYTES, 64)
    assert len(chunks) == 2049
    last = 2048 * 64 * ROW_BYTES
    assert chunks[-1] == [(last, pk.COPY_STAGE_BYTES),
                          (last + pk.COPY_STAGE_BYTES,
                           37 * ROW_BYTES - pk.COPY_STAGE_BYTES)]
    assert [len(c) for c in chunks[:-1]] == [2] * 2048


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("mode,want", [
    ("bf16", 128 * K * 2 + 1024), ("tf32", 128 * K * 4 + 1024),
    ("fp32", 192 * K * 4)])
def test_resident_smem_bytes(mode, want):
    assert pk.resident_smem_bytes(K, mode) == want <= pk.SMEM_LIMIT


@pytest.mark.parametrize("m,k,n,mode,ok", [
    (512, 256, 2048, "bf16", True),
    (512, 256, 2048, "tf32", True),
    (64, 64, 128, "tf32", True),
    (512, 192, 2048, "bf16", True),
    (512, 288, 2048, "fp32", True),
    (500, 256, 2048, "bf16", False),     # M % 64
    (512, 256, 2000, "tf32", False),     # N % 128
    (512, 32, 2048, "bf16", False),      # K % 64 on wgmma
    (512, 320, 2048, "bf16", False),     # K > 256 on wgmma
    (512, 320, 2048, "fp32", False),     # FFMA panels past 227 KB
    (512, 0, 2048, "fp32", False),
])
def test_resident_shape_rules(m, k, n, mode, ok):
    why = pk.resident_shape_error(m, k, n, mode)
    assert (why is None) == ok, why


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its kernel path with a stand-in C entry."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


class _Stream:
    cuda_stream = 4321


@pytest.fixture
def entry(monkeypatch):
    calls = []

    def fn(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    monkeypatch.setattr(pk, "_fn", fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    return calls


@pytest.mark.parametrize("mode", pk.MODES)
def test_card_wrapper_hands_the_mode_to_the_entry(entry, mode):
    a = _on_card(torch.randn(128, 64))
    b = _on_card(torch.randn(64, 256))
    before = pk.RESIDENT_LAUNCHES[mode].count
    out = pk.resident_matmul(a, b, 3, mode)
    assert pk.RESIDENT_LAUNCHES[mode].count == before + 1
    (name, args), = entry
    assert name == "csmpn_probe_resident"
    assert args[:3] == (a.data_ptr(), b.data_ptr(), out.data_ptr())
    assert args[3:] == (128, 64, 256, 3, pk.MODES.index(mode), 4321)
    assert out.shape == (128, 256) and out.dtype == torch.float32
    assert len(pk._SIGS[name][0]) == len(args)


def test_card_wrapper_zero_reps_launches_nothing(entry):
    a, b = _on_card(torch.randn(64, 64)), _on_card(torch.randn(64, 128))
    before = pk.RESIDENT_LAUNCHES["bf16"].count
    out = pk.resident_matmul(a, b, 0, "bf16")
    assert not entry and pk.RESIDENT_LAUNCHES["bf16"].count == before
    assert torch.equal(out, torch.zeros(64, 128))


@pytest.mark.parametrize("m,k,n,mode", [
    (96, 64, 128, "bf16"), (64, 64, 192, "bf16"), (64, 32, 128, "tf32"),
    (64, 320, 128, "bf16"), (64, 64, 128, "fp16")])
def test_card_wrapper_refuses_what_no_kernel_takes(entry, m, k, n, mode):
    a, b = _on_card(torch.randn(m, k)), _on_card(torch.randn(k, n))
    with pytest.raises(ValueError):
        pk.resident_matmul(a, b, 2, mode)
    assert not entry


@pytest.fixture
def not_capturing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)


@pytest.mark.parametrize("rows,tile_rows", [(1000, 64), (131109, 4096)])
def test_card_copy_wrapper_launches_one_wave(entry, monkeypatch,
                                             not_capturing, rows, tile_rows):
    monkeypatch.setattr(pk, "copy_slots", lambda dev: 132)
    monkeypatch.setattr(pk, "_CLAIMS", {})
    x = _on_card(torch.randn(rows, 8))
    before = pk.COPY_LAUNCHES.count
    out = pk.copy_scale(x, tile_rows)
    assert pk.COPY_LAUNCHES.count == before + 1
    (name, args), = entry
    assert name == "csmpn_probe_copy"
    grid = min(-(-rows // tile_rows), 132)
    claims = pk.copy_claims(x.device, 4321)
    assert args == (x.data_ptr(), out.data_ptr(), rows, 8, tile_rows, grid,
                    claims.data_ptr(), 4321)
    assert len(pk._SIGS[name][0]) == len(args)


@pytest.mark.parametrize("shape", [(0, 8), (5, 0), (0, 0)])
def test_card_copy_wrapper_empty_launches_nothing(entry, monkeypatch, shape):
    monkeypatch.setattr(pk, "copy_slots", lambda dev: 132)
    before = pk.COPY_LAUNCHES.count
    out = pk.copy_scale(_on_card(torch.randn(*shape)))
    assert out.shape == shape
    assert not entry and pk.COPY_LAUNCHES.count == before


def test_copy_claims_one_pair_a_stream(monkeypatch, not_capturing):
    monkeypatch.setattr(pk, "_CLAIMS", {})
    dev = torch.device("cpu")
    first = pk.copy_claims(dev, 11)
    assert first.tolist() == [0, 0] and first.dtype == torch.int32
    assert pk.copy_claims(dev, 11) is first            # one stream's order
    assert pk.copy_claims(dev, 12) is not first        # another stream
    assert pk.copy_claims(dev, 12).data_ptr() != first.data_ptr()


def test_copy_claims_under_capture_are_the_graphs_own(monkeypatch):
    monkeypatch.setattr(pk, "_CLAIMS", {})
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    dev = torch.device("cpu")
    one, two = pk.copy_claims(dev, 11), pk.copy_claims(dev, 11)
    assert one is not two and one.tolist() == two.tolist() == [0, 0]
    assert not pk._CLAIMS


def test_copy_claims_by_stream_in_the_wrapper(entry, monkeypatch,
                                              not_capturing):
    monkeypatch.setattr(pk, "copy_slots", lambda dev: 132)
    monkeypatch.setattr(pk, "_CLAIMS", {})
    x = _on_card(torch.randn(256, 8))
    pk.copy_scale(x, 64)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 99})())
    pk.copy_scale(x, 64)
    pk.copy_scale(x, 64)
    ptrs = [args[6] for _, args in entry]
    assert [args[7] for _, args in entry] == [4321, 99, 99]
    assert ptrs[1] == ptrs[2] != ptrs[0]


@pytest.mark.parametrize("bad", ["misaligned", "width", "tile"])
def test_card_copy_wrapper_refuses(entry, monkeypatch, bad):
    monkeypatch.setattr(pk, "copy_slots", lambda dev: 132)
    x = torch.randn(65, 8)
    kw = {}
    if bad == "misaligned":
        x = torch.randn(65 * 8 + 1)[1:].view(65, 8)
        assert x.data_ptr() % 16
    elif bad == "width":
        x = torch.randn(65, 6)
    else:
        kw["tile_rows"] = 0
    with pytest.raises(ValueError):
        pk.copy_scale(_on_card(x), **kw)
    assert not entry


def test_copy_slots_asks_the_runtime_once(monkeypatch):
    asked = []

    def slots_entry(ptr):
        asked.append(ptr)
        ctypes.c_int.from_address(ptr).value = 132
        return 0

    monkeypatch.setattr(pk, "_fn", lambda name: slots_entry)
    monkeypatch.setattr(pk, "_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "device", lambda index: _NoDevice())
    dev = torch.device("cuda", 0)
    assert pk.copy_slots(dev) == 132
    assert pk.copy_slots(dev) == 132
    assert len(asked) == 1


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_probe_names_what_each_mode_runs():
    assert ep.HOW == {"bf16": "wgmma m64n128k16 bf16, A from registers",
                      "tf32": "wgmma m64n128k8 tf32, A from registers",
                      "fp32": "FFMA"}
