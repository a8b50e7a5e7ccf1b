"""The port's one-card streaming path (``csmpn_torch.parallel.edge_partition``
and ``csmpn_torch.bench_scaling``) against ``csmpn_tpu.parallel.edge_partition``
on the CPU.

  * ``make_synthetic_complex`` (uniform and with ``locality``),
    ``partition_edges`` (every field, ``edge_perm``, the padded slots'
    targets and the mask) and ``permute_edge_payload`` byte for byte;
  * ``streaming_egcl_apply`` against the reference's on the same
    ``params_from_jax`` weights, each case one of tests/test_parallel.py's
    streaming tests (``TestStreamingEGCL`` and the streaming cases of
    ``TestPartitionedAttrs``): the output at remat on and off, the
    gradients (parameters, h, and the attributes where given), and
    ``chunk_reduce`` against reducing the whole output;
  * both layers with the fused dispatch forced on (exact mode, the plain
    K4/K5 here and the reference's kernels in interpret mode), against each
    other and against the port's unstreamed layer; one forward and one
    backward of the fused kernels a chunk;
  * the wrappers of K1, K2/K3 and K4/K5 raise before any launch on a call
    past the counts their kernels index correctly;
  * ``python -m csmpn_torch.bench_scaling``'s line, its refusals outside a
    process group and its default device.

Tolerances are tests/test_parallel.py's: forward rtol 2e-4 / atol 2e-5,
gradients rtol 5e-4 / atol 1e-5, a ``chunk_reduce`` value rtol 1e-5.
"""
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import CliffordAlgebra as JAlgebra
from csmpn_tpu.nn.egcl import EGCL as JEGCL
from csmpn_tpu.ops import fused_egcl as jfe
from csmpn_tpu.ops import segment as jseg
from csmpn_tpu.parallel import edge_partition as jep
from csmpn_torch import bench_scaling
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax
from csmpn_torch.nn import EGCL
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import fused_egcl as fe
from csmpn_torch.ops import segment as seg
from csmpn_torch.ops import segment_kernel as sk
from csmpn_torch.parallel import edge_partition as tep

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=5e-4, atol=1e-5)
CL3 = (1.0, 1.0, 1.0)
JALG = JAlgebra(CL3)


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


def close(got, want, msg="", **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=msg, **(tol or FWD))


# ----------------------------------------------------------- host tables

@pytest.mark.parametrize("n,deg,seed,locality,shards", [
    (16, 4, 1, None, 4), (24, 4, 11, None, 6), (18, 3, 17, None, 3),
    (40, 5, 3, 2, 5), (64, 8, 0, 7, 8), (12, 3, 24, 1, 4)])
def test_partition_tables_byte_equal(n, deg, seed, locality, shards):
    ei = tep.make_synthetic_complex(n, deg, seed=seed, locality=locality)
    j_ei = jep.make_synthetic_complex(n, deg, seed=seed, locality=locality)
    assert ei.dtype == j_ei.dtype and np.array_equal(ei, j_ei)
    part = tep.partition_edges(ei, n, shards)
    j_part = jep.partition_edges(j_ei, n, shards)
    for f in ("n_shards", "e_shard", "nodes_per_shard"):
        assert getattr(part, f) == getattr(j_part, f), f
    for f in ("edge_index", "edge_mask", "edge_perm"):
        a, b = getattr(part, f), getattr(j_part, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    # padded slots target their chunk's last node, masked out
    nps, e2 = part.nodes_per_shard, part.e_shard
    pad = ~part.edge_mask
    chunk = np.arange(part.edge_mask.size) // e2
    assert np.array_equal(part.edge_index[pad, 1], (chunk[pad] + 1) * nps - 1)
    assert np.array_equal(part.edge_perm < 0, pad)
    payload = np.random.RandomState(seed).randn(ei.shape[1], 2, 8)
    a = tep.permute_edge_payload(part, payload.astype(np.float32))
    b = jep.permute_edge_payload(j_part, payload.astype(np.float32))
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_partition_of_unsorted_repeated_edges_byte_equal(dtype):
    """An edge list in no order with repeated edges: the same slabs and
    the same edge_perm (ties in input order) as the reference's lexsort."""
    ei = tep.make_synthetic_complex(30, 6, seed=9)
    ei = np.concatenate([ei, ei[:, ::4]], axis=1)
    ei = ei[:, np.random.RandomState(9).permutation(ei.shape[1])]
    ei = ei.astype(dtype)
    part, j_part = tep.partition_edges(ei, 30, 5), jep.partition_edges(
        ei, 30, 5)
    assert part.e_shard == j_part.e_shard
    for f in ("edge_index", "edge_mask", "edge_perm"):
        assert getattr(part, f).tobytes() == getattr(j_part, f).tobytes(), f


def test_partition_rejects_ragged_nodes():
    ei = tep.make_synthetic_complex(10, 2, seed=0)
    with pytest.raises(ValueError):
        tep.partition_edges(ei, 10, 4)


@pytest.mark.parametrize("row,bad", [(0, -1), (1, -1), (0, 12), (1, 12)])
def test_partition_rejects_ids_outside_the_nodes(row, bad):
    ei = tep.make_synthetic_complex(12, 2, seed=0)
    ei[row, 5] = bad
    with pytest.raises(ValueError):
        tep.partition_edges(ei, 12, 4)


def test_partition_of_no_edges():
    part = tep.partition_edges(np.zeros((2, 0), np.int64), 8, 2)
    j_part = jep.partition_edges(np.zeros((2, 0), np.int64), 8, 2)
    assert part.e_shard == j_part.e_shard == 0
    assert part.edge_index.shape == j_part.edge_index.shape == (0, 2)


# --------------------------------------- streaming against the reference

def _layer(cin, hid, cout, aggr, seed, h, ei, ea=None, na=None, ca=0, cn=0):
    """The reference layer with PRNGKey(seed) weights, and the port's layer
    on the same weights."""
    jl = JEGCL(JALG, cin, hid, cout, edge_attr_features=ca,
               node_attr_features=cn, aggr=aggr)
    args = (jnp.asarray(ei),) + tuple(
        jnp.asarray(t) for t in (ea, na) if t is not None)
    params = jl.init(jax.random.PRNGKey(seed), jnp.asarray(h), *args)
    tl = EGCL(get_algebra(CL3), cin, hid, cout, edge_attr_features=ca,
              node_attr_features=cn, aggr=aggr)
    tl.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return jl, params, tl


def _case(name):
    """Each case of tests/test_parallel.py's streaming tests: its complex,
    features, layer and chunks."""
    if name in ("monolithic", "grad", "reduce"):
        n, deg, seed, rs, c, cfg, key, shards = {
            "monolithic": (24, 4, 11, 2, 3, (3, 4, 3, "mean"), 5, 6),
            "grad": (12, 3, 13, 3, 2, (2, 3, 2, "sum"), 6, 4),
            "reduce": (18, 3, 17, 4, 2, (2, 3, 2, "mean"), 7, 3)}[name]
        ei = jep.make_synthetic_complex(n, deg, seed=seed)
        h = np.random.RandomState(rs).randn(n, c, 8).astype(np.float32)
        jl, params, tl = _layer(*cfg, key, h, ei)
        return dict(n=n, ei=ei, h=h, ea=None, na=None, jl=jl, params=params,
                    tl=tl, shards=shards)
    # TestPartitionedAttrs._setup: attrs of 2 edge and 1 node channels
    n, deg, seed, shards = {"attrs": (24, 4, 23, 6),
                            "attrs_grad": (12, 3, 24, 4)}[name]
    ei = jep.make_synthetic_complex(n, deg, seed=seed)
    rng = np.random.RandomState(seed)
    h = rng.randn(n, 3, 8).astype(np.float32)
    ea = rng.randn(ei.shape[1], 2, 8).astype(np.float32)
    na = rng.randn(n, 1, 8).astype(np.float32)
    jl, params, tl = _layer(3, 4, 3, "mean", seed, h, ei, ea, na, 2, 1)
    return dict(n=n, ei=ei, h=h, ea=ea, na=na, jl=jl, params=params, tl=tl,
                shards=shards)


def _parts(k):
    return (tep.partition_edges(k["ei"], k["n"], k["shards"]),
            jep.partition_edges(k["ei"], k["n"], k["shards"]))


def _attrs(k, part, requires_grad=False):
    """(node_attr, slab-order edge_attr) as tensors for the port and as
    arrays for the reference."""
    if k["ea"] is None:
        return (None, None), (None, None)
    ea = tep.permute_edge_payload(part, k["ea"])
    t = [torch.from_numpy(x).requires_grad_(requires_grad)
         for x in (k["na"], ea)]
    return tuple(t), (jnp.asarray(k["na"]), jnp.asarray(ea))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["monolithic", "attrs"])
def test_streaming_output_matches_reference(name, remat):
    k = _case(name)
    part, j_part = _parts(k)
    (na, ea), (jna, jea) = _attrs(k, part)
    want = jep.streaming_egcl_apply(k["jl"], k["params"], jnp.asarray(k["h"]),
                                    j_part, remat=remat, node_attr=jna,
                                    edge_attr=jea)
    with torch.no_grad():
        got = tep.streaming_egcl_apply(k["tl"], torch.from_numpy(k["h"]),
                                       part, remat=remat, node_attr=na,
                                       edge_attr=ea)
    close(got, want)
    # and the reference's monolithic layer, as its own test holds it
    args = [jnp.asarray(k["ei"])] + ([jnp.asarray(k["ea"]), jnp.asarray(
        k["na"])] if k["ea"] is not None else [])
    close(got, k["jl"].apply(k["params"], jnp.asarray(k["h"]), *args))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("name", ["grad", "attrs_grad"])
def test_streaming_grads_match_reference(name, remat):
    """Gradients of mean(out ** 2) with respect to the parameters, h and,
    where given, node_attr and edge_attr."""
    k = _case(name)
    part, j_part = _parts(k)
    (na, ea), (jna, jea) = _attrs(k, part, requires_grad=True)
    has_attr = na is not None

    def j_loss(p, hh, nn, ee):
        return jnp.mean(jep.streaming_egcl_apply(
            k["jl"], p, hh, j_part, remat=remat, node_attr=nn,
            edge_attr=ee) ** 2)

    argn = (0, 1, 2, 3) if has_attr else (0, 1)
    j_grads = jax.grad(j_loss, argnums=argn)(
        k["params"], jnp.asarray(k["h"]), jna, jea)
    h = torch.from_numpy(k["h"]).requires_grad_(True)
    out = tep.streaming_egcl_apply(k["tl"], h, part, remat=remat,
                                   node_attr=na, edge_attr=ea)
    torch.mean(out ** 2).backward()
    want = params_from_jax(jax.tree.map(np.asarray, j_grads[0]))
    for pname, p in k["tl"].named_parameters():
        close(p.grad, want[pname], msg=pname, **GRAD)
    close(h.grad, j_grads[1], msg="h", **GRAD)
    if has_attr:
        close(na.grad, j_grads[2], msg="node_attr", **GRAD)
        close(ea.grad, j_grads[3], msg="edge_attr", **GRAD)


@pytest.mark.parametrize("remat", [True, False])
def test_chunk_reduce_matches_reference_and_full_output(remat):
    k = _case("reduce")
    part, j_part = _parts(k)

    def red_j(out):
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def red_t(out):
        return torch.sum(out.float() ** 2)

    v_ref, g_ref = jax.value_and_grad(lambda hh: jep.streaming_egcl_apply(
        k["jl"], k["params"], hh, j_part, remat=remat,
        chunk_reduce=red_j))(jnp.asarray(k["h"]))
    h = torch.from_numpy(k["h"]).requires_grad_(True)
    v = tep.streaming_egcl_apply(k["tl"], h, part, remat=remat,
                                 chunk_reduce=red_t)
    v.backward()
    assert v.dtype == torch.float32 and v.dim() == 0
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    close(h.grad, g_ref, **GRAD)
    # against reducing the port's own whole output
    h2 = torch.from_numpy(k["h"]).requires_grad_(True)
    v_full = red_t(tep.streaming_egcl_apply(k["tl"], h2, part, remat=remat))
    v_full.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_full.detach()),
                               rtol=1e-5)
    close(h.grad, h2.grad, **GRAD)


def test_stream_arrays_are_the_pair_and_keep_tables():
    """A ``StreamArrays`` unpacks as (edge_index, edge_mask), keeps each
    chunk's tables for the next call, and gives the same layer as the
    plain pair; a partition of another shape is refused."""
    k = _case("monolithic")
    part, _ = _parts(k)
    arrays = tep.StreamArrays.of(part, "cpu")
    ei, mask = arrays
    assert torch.equal(ei, torch.from_numpy(part.edge_index))
    assert torch.equal(mask, torch.from_numpy(part.edge_mask))
    h = torch.from_numpy(k["h"])
    with torch.no_grad():
        a = tep.streaming_egcl_apply(k["tl"], h, part, arrays=arrays)
        first = arrays.chunk(0)
        b = tep.streaming_egcl_apply(k["tl"], h, part, arrays=(ei, mask))
    assert arrays.chunk(0) is first
    assert torch.equal(a, b)
    src, dst, m = first
    assert src.dtype == dst.dtype == torch.int32 and m.dtype == torch.bool
    assert int(dst.max()) < part.nodes_per_shard
    order, compact, uniq = arrays.src_sort(1)
    s1 = arrays.chunk(1)[0]
    assert torch.equal(uniq[compact.long()], s1[order.long()])
    other = tep.partition_edges(k["ei"], k["n"], 4)
    with pytest.raises(ValueError):
        tep.streaming_egcl_apply(k["tl"], h, other, arrays=arrays)


@pytest.mark.parametrize("how", ["no_grad", "nothing_requires_grad",
                                 "grad"])
def test_no_aggregates_kept_without_a_gradient(monkeypatch, how):
    """Under ``no_grad``, or where nothing needs a gradient, the layer runs
    the plain chunk loop: the remat function, which keeps every chunk's
    (nps, C, nb) aggregate for its backward, is never entered, and the
    output is the same."""
    k = _case("monolithic")
    part, _ = _parts(k)
    h = torch.from_numpy(k["h"])
    with torch.no_grad():
        want = tep.streaming_egcl_apply(k["tl"], h, part, remat=False)
    entered = []
    fwd = tep._StreamEGCL.forward

    def spy(ctx, *a):
        entered.append(1)
        return fwd(ctx, *a)

    monkeypatch.setattr(tep._StreamEGCL, "forward", staticmethod(spy))
    if how == "no_grad":
        with torch.no_grad():
            got = tep.streaming_egcl_apply(k["tl"], h, part)
    elif how == "nothing_requires_grad":
        k["tl"].requires_grad_(False)
        got = tep.streaming_egcl_apply(k["tl"], h, part)
    else:
        got = tep.streaming_egcl_apply(k["tl"], h, part)
    assert len(entered) == (how == "grad")
    assert got.requires_grad == (how == "grad")
    close(got, want.numpy(), rtol=0, atol=0)


# ----------------------------------------------- the fused dispatch forced

@pytest.fixture
def forced(monkeypatch):
    """Both layers take the fused route (exact mode, CPU); the port's fused
    kernels' forward and backward calls counted."""
    monkeypatch.setattr(jfe, "fused_mp_supported", lambda *a: True)
    monkeypatch.setattr(fe, "fused_mp_supported", lambda *a: True)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fe.mp_forward, fe.mp_backward

    def spy_fwd(*a, **kw):
        calls["fwd"] += 1
        return fwd(*a, **kw)

    def spy_bwd(*a, **kw):
        calls["bwd"] += 1
        return bwd(*a, **kw)

    monkeypatch.setattr(fe, "mp_forward", spy_fwd)
    monkeypatch.setattr(fe, "mp_backward", spy_bwd)
    return calls


def _fused_case(attrs):
    n, shards = 24, 4
    ei = jep.make_synthetic_complex(n, 3, seed=31)
    rng = np.random.RandomState(31)
    h = rng.randn(n, 4, 8).astype(np.float32)
    ea = rng.randn(ei.shape[1], 2, 8).astype(np.float32) if attrs else None
    na = rng.randn(n, 1, 8).astype(np.float32) if attrs else None
    ca, cn = (2, 1) if attrs else (0, 0)
    jl, params, tl = _layer(4, 4, 4, "mean", 31, h, ei, ea, na, ca, cn)
    return dict(n=n, ei=ei, h=h, ea=ea, na=na, jl=jl, params=params, tl=tl,
                shards=shards)


@pytest.mark.parametrize("attrs", [False, True])
def test_fused_dispatch_streaming_matches_reference(forced, attrs):
    """Forced fused route in both packages: output and parameter gradients
    of sum(out * g) against the reference's streamed layer (its Pallas
    kernels in interpret mode) and the port's unstreamed layer; K4's and
    K5's counterparts called once a chunk each."""
    k = _fused_case(attrs)
    part, j_part = _parts(k)
    (na, ea), (jna, jea) = _attrs(k, part)
    g = np.random.RandomState(7).randn(k["n"], 4, 8).astype(np.float32)

    def j_loss(p):
        out = jep.streaming_egcl_apply(k["jl"], p, jnp.asarray(k["h"]),
                                       j_part, node_attr=jna, edge_attr=jea)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, j_out), j_gp = jax.value_and_grad(j_loss, has_aux=True)(k["params"])
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    out = tep.streaming_egcl_apply(k["tl"], torch.from_numpy(k["h"]), part,
                                   node_attr=na, edge_attr=ea)
    assert forced == {"fwd": part.n_shards, "bwd": 0}
    (out * torch.from_numpy(g)).sum().backward()
    assert forced == {"fwd": part.n_shards, "bwd": part.n_shards}
    close(out, j_out)
    grads = {name: p.grad.clone() for name, p in k["tl"].named_parameters()}
    for name, gr in grads.items():
        close(gr, j_grads[name], msg=name, **GRAD)
    # the port's unstreamed layer, fused too
    k["tl"].zero_grad(set_to_none=True)
    args = ([torch.from_numpy(k["ea"]), torch.from_numpy(k["na"])]
            if attrs else [])
    flat = k["tl"](torch.from_numpy(k["h"]), torch.from_numpy(k["ei"]).long(),
                   *args)
    (flat * torch.from_numpy(g)).sum().backward()
    close(out, flat.detach())
    for name, p in k["tl"].named_parameters():
        close(grads[name], p.grad, msg=name, **GRAD)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("reduce", [False, True])
def test_fused_kernels_once_a_chunk(forced, remat, reduce):
    """One forward (K4) and one backward (K5) of the fused kernels a chunk
    and step, with and without remat: the backward starts from d(agg) and
    does not run the forward kernel again."""
    k = _fused_case(False)
    part, _ = _parts(k)
    h = torch.from_numpy(k["h"]).requires_grad_(True)
    red = (lambda out: torch.sum(out ** 2)) if reduce else None
    out = tep.streaming_egcl_apply(k["tl"], h, part, remat=remat,
                                   chunk_reduce=red)
    (out if reduce else out.sum()).backward()
    assert forced == {"fwd": part.n_shards, "bwd": part.n_shards}
    assert torch.isfinite(h.grad).all()


# ------------------------------------------- counts the kernels index

class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card, so that a wrapper takes
    its kernel path (which must raise before it launches)."""

    @property
    def is_cuda(self):
        return True


def _card(shape, dtype=torch.float32):
    """A stand-in card tensor of any size, backed by one element."""
    return torch.Tensor._make_subclass(
        _OnCard, torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape))


def _edge_params(cin, c):
    from csmpn_torch.nn import CEMLP

    em = CEMLP(get_algebra(CL3), cin, c, c)
    return [p.detach() for p in ck.block_params(em, 0)
            + ck.block_params(em, 1)]


BIG = _build.MAX_COUNT + 1


@pytest.mark.parametrize("call", [
    "k4_nodes", "k4_edges", "k5_nodes", "k5_edges", "k2_rows", "k3_rows",
    "k1_segments"])
def test_wrappers_raise_past_the_counts_they_index(monkeypatch, call):
    """A call past ``MAX_COUNT`` rows, targets or segments raises
    NotImplementedError before any library is loaded or kernel launched
    (ctypes would wrap the count into a C int silently)."""
    monkeypatch.setattr(_build, "load",
                        lambda name: pytest.fail(f"{name} loaded"))
    alg = get_algebra(CL3)
    c = 4
    params = _edge_params(c, c)
    n, e = (BIG, 16) if call.endswith("nodes") else (16, BIG)
    with pytest.raises(NotImplementedError):
        if call.startswith("k4"):
            fe.mp_forward(params, alg, _card((n, c, 8)), _card((e, c, 8)),
                          None, _card((e,), torch.int32), None, False)
        elif call.startswith("k5"):
            fe.mp_backward(params, alg, _card((n, c, 8)), _card((e, c, 8)),
                           None, _card((e,), torch.int32), None,
                           _card((n, c, 8)), False)
        elif call in ("k2_rows", "k3_rows"):
            x = _card((BIG, c, 8))
            if call == "k2_rows":
                ck.block_forward(x, params[:10], alg, False)
            else:
                ck.block_backward(x, _card((BIG, c, 8)), params[:10], alg,
                                  False)
        else:
            sk.sorted_segment_sum(_card((16, 256)),
                                  _card((16,), torch.int32), BIG, False)


def test_count_limit_is_the_windows_end():
    """The largest call K4/K5 take: its last window of 32 targets ends at
    ``MAX_COUNT``; one target more raises."""
    kern = fe.fused_kernel(8)
    top = (_build.MAX_COUNT // kern.wn) * kern.wn
    fe.check_counts(kern, top, _build.MAX_COUNT)
    with pytest.raises(NotImplementedError):
        fe.check_counts(kern, top + 1, 16)
    with pytest.raises(NotImplementedError):
        fe.check_counts(kern, 16, _build.MAX_COUNT + 1)
    assert _build.MAX_COUNT + 64 < 2**31


# ------------------------------------------------------ the entry point

SMALL = ["--device=cpu", "--simplices", "256", "--degree", "4", "--stream",
         "4", "--steps", "1"]


@pytest.mark.parametrize("extra", [[], ["--fwd-only"],
                                   ["--precision", "exact", "--locality",
                                    "5"]])
def test_bench_scaling_prints_its_line(capsys, extra):
    res = bench_scaling.main(SMALL + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "simplices", "edges", "chunks",
                         "precision", "mode", "value", "unit",
                         "peak_hbm_gb", "device"}
    assert line["metric"] == "streaming_edges_per_s"
    assert (line["simplices"], line["edges"], line["chunks"]) == (256, 1024,
                                                                   4)
    assert line["mode"] == ("fwd" if extra == ["--fwd-only"] else "fwd+bwd")
    assert line["precision"] == ("exact" if "exact" in extra else "fast")
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["unit"] == "edges/s" and line["device"] == "cpu"
    assert line["peak_hbm_gb"] is None
    assert res["n_edges"] == 1024 and res["part"].n_shards == 4
    loc = 5 if "--locality" in extra else None
    assert np.array_equal(res["part"].edge_index, jep.partition_edges(
        jep.make_synthetic_complex(256, 4, seed=0, locality=loc), 256,
        4).edge_index)


@pytest.mark.parametrize("argv,exc", [
    (SMALL[:1] + ["--simplices", "64"], RuntimeError),
    (SMALL + ["--devices", "2"], ValueError),
    (SMALL[1:], RuntimeError)])
def test_bench_scaling_refuses(monkeypatch, argv, exc):
    """Outside a process group: the mesh sweep (no --stream) needs one,
    and --devices must be the world size (1); the default device needs a
    card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc):
        bench_scaling.main(argv)
