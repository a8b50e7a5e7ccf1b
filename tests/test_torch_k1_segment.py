"""K1, the sorted segment sum: its plain version against the reference's
``sorted_segment_sum_pallas`` in Pallas interpret mode at the widths the
main paths launch it at (D = 24 and 224 motion, 160 NBA and the bench at
Cl(2), 256 MD17 and the bench at Cl(3), 448 the bench at Cl(4), 896 hulls
and the bench at Cl(5)), with sentinel ids, empty segments and the masked
mean; and the host side of its CUDA wrapper: on the CPU it takes the plain
version and counts no launch, and on a CUDA tensor it makes one kernel
call and its two output allocations, with no offsets computed beforehand
and the bool mask handed over as its bytes.

The kernel itself runs only on the card, where chip_smoke.py holds it to
this plain version.  The reference has no mask or mean: its masked mean is
the Pallas sum of the masked rows over the Pallas sum of the mask, as the
reference's segment ops build it.  Tolerance rtol/atol 1e-4, as
tests/test_segment_ops.py holds the Pallas kernel.
"""
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from csmpn_tpu.ops.pallas_segment import sorted_segment_sum_pallas
from csmpn_torch.ops import segment_kernel as sk

WIDTHS = [24, 160, 224, 256, 448, 896]


def _ids(rng, e, n):
    """Sorted ids over n segments with an empty run in the middle, empty
    leading segments and a sentinel tail (ids >= n)."""
    ids = np.sort(rng.randint(2, n, size=e))
    ids[(ids > n // 3) & (ids < n // 2)] = n // 3       # empty middle run
    ids = np.sort(ids)
    ids[-(e // 10):] = n + 5                            # sentinels
    return ids


def _pallas(x, ids, n, exact):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(sorted_segment_sum_pallas(
            jnp.asarray(x), jnp.asarray(ids.astype(np.int32)), n, 128, 1024,
            exact))


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("variant", ["sum exact", "sum fast",
                                     "masked mean exact"])
def test_plain_k1_matches_pallas_interpret_at_path_widths(d, variant):
    rng = np.random.RandomState(d)
    e, n = 300, 40
    ids = _ids(rng, e, n)
    x = rng.randn(e, d).astype(np.float32)
    exact = "fast" not in variant
    masked = "masked" in variant
    mask = rng.rand(e) > 0.25 if masked else None
    got, counts = sk.sorted_segment_sum(
        torch.from_numpy(x), torch.from_numpy(ids), n, exact,
        torch.from_numpy(mask) if masked else None, mean=masked)
    keep = (ids < n) & (mask if masked else True)
    want_counts = np.bincount(ids[keep], minlength=n)[:n]
    if masked:
        xs = np.where(mask[:, None], x, 0.0).astype(np.float32)
        total = _pallas(xs, ids, n, exact)
        cnt = _pallas(mask.astype(np.float32)[:, None], ids, n, True)[:, 0]
        np.testing.assert_array_equal(cnt, want_counts)
        want = total / np.maximum(cnt, 1.0)[:, None]
    else:
        want = _pallas(x, ids, n, exact)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    assert not got[n // 3 + 1:n // 2].any()             # empty segments
    assert not got[:2].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_takes_plain_and_counts_no_launch(dtype, masked):
    gen = torch.Generator().manual_seed(1)
    e, n, d = 50, 9, 24
    ids = torch.sort(torch.randint(0, n + 2, (e,), generator=gen)).values
    x = torch.randn(e, d, generator=gen).to(dtype)
    mask = torch.rand(e, generator=gen) > 0.4 if masked else None
    before = sk.LAUNCHES.count
    got, cnt = sk.sorted_segment_sum(x, ids, n, False, mask, masked)
    ref, rcnt = sk.segment_sum_plain(x, ids, n, False, mask, masked)
    assert sk.LAUNCHES.count == before
    assert torch.equal(got, ref) and torch.equal(cnt, rcnt)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that the wrapper
    takes its kernel path with a stand-in library."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


class _Stream:
    cuda_stream = 1234


def _forbid(monkeypatch, *names):
    def boom(*args, **kwargs):
        raise AssertionError("K1's wrapper ran an extra device op")
    for name in names:
        monkeypatch.setattr(torch, name, boom)


@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,exact", [(torch.bfloat16, False),
                                         (torch.float32, True),
                                         (torch.float32, False)])
@pytest.mark.parametrize("masked", [False, True])
def test_card_wrapper_launches_one_kernel_without_offsets(
        monkeypatch, ids_dtype, dtype, exact, masked):
    """One call of the C entry with the ids, the bool mask's own bytes and
    the two outputs; no searchsorted, arange or mask conversion first."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    entry.argtypes = sk._argtypes
    monkeypatch.setattr(sk, "_lib", lambda: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    e, n, d = 40, 7, 160
    ids = _on_card(torch.sort(torch.randint(0, n + 1, (e,))).values
                   .to(ids_dtype))
    x = _on_card(torch.randn(e, d).to(dtype))
    mask = _on_card(torch.rand(e) > 0.5) if masked else None
    _forbid(monkeypatch, "searchsorted", "arange", "bucketize")
    before = sk.LAUNCHES.count
    out, counts = sk.sorted_segment_sum(x, ids, n, exact, mask, masked)
    assert sk.LAUNCHES.count == before + 1
    assert len(calls) == 1
    (data_p, is_bf16, rnd, ids_p, ids64, mask_p, out_p, cnt_p, rows, segs,
     width, mean, stream) = calls[0]
    assert data_p == x.data_ptr() and ids_p == ids.data_ptr()
    assert is_bf16 == int(dtype == torch.bfloat16)
    assert rnd == int(not exact)
    assert ids64 == int(ids_dtype == torch.int64)
    assert mask_p == (mask.data_ptr() if masked else None)
    assert (out_p, cnt_p) == (out.data_ptr(), counts.data_ptr())
    assert (rows, segs, width, mean, stream) == (e, n, d, int(masked), 1234)
    assert out.shape == (n, d) and out.dtype == torch.float32
    assert counts.shape == (n,) and counts.dtype == torch.float32
    assert len(sk._argtypes) == 13
    assert sk._argtypes[8] is ctypes.c_longlong


@pytest.mark.parametrize("bad", ["mask_u8", "ids_float", "ids_len"])
def test_card_wrapper_raises_on_what_the_kernel_does_not_take(monkeypatch,
                                                               bad):
    monkeypatch.setattr(sk, "_lib", lambda: pytest.fail("launched"))
    e, n, d = 20, 5, 8
    ids = torch.sort(torch.randint(0, n, (e,))).values
    mask = None
    if bad == "mask_u8":
        mask = _on_card(torch.ones(e, dtype=torch.uint8))
    elif bad == "ids_float":
        ids = ids.float()
    else:
        ids = ids[:-1]
    with pytest.raises((ValueError, TypeError)):
        sk.sorted_segment_sum(_on_card(torch.randn(e, d)), _on_card(ids), n,
                              True, mask, False)
