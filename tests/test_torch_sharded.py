"""The port's edge-partitioned message passing across ranks
(``csmpn_torch.parallel.edge_partition``'s halo and all-gather forms and
``csmpn_torch.bench_scaling``'s mesh sweep and sharded streaming) against
``csmpn_tpu.parallel.edge_partition`` on the CPU.

* ``HaloPartition`` and ``HaloStreamPartition`` (every field, ``edge_perm``
  too) byte for byte at tests/test_parallel.py's shapes and others, and at
  200,000 nodes over 8 shards (uniform sources and ``locality`` 512),
  where the port's vectorised build also beats the reference's loops;
* the four layer functions in 2 and 4 ``gloo`` ranks (real processes, each
  world size launched once) against the reference's on the 4-device
  virtual mesh with the same ``params_from_jax`` weights: each rank's
  output rows, the parameter gradients summed over the ranks
  (``all_reduce_grads(reduce="sum")``), d(h) from ``jax.vjp`` with
  respect to ``h`` and, with attributes, d(node_attr) and d(edge_attr);
  with and without attributes, ``chunk_reduce`` and ``remat=False``;
* the halo exchange ships only the real rows (``send_mask`` counts, not
  n_shards**2 * h_max), forward and backward;
* in one process (a ``gloo`` group of one): the layers against the port's
  own flat and streamed layers, and the shard bodies of a 4-shard
  partition run in one process (chip_smoke's ``shards_on_one_card``);
* ``python -m torch.distributed.run --nproc_per_node 2 -m
  csmpn_torch.bench_scaling``'s lines (the sweep in both exchanges,
  sharded streaming), their exchanged rows against the reference's
  partitions;
* the refusals: no process group, ``--devices`` other than the world,
  tables of another partition; a run's tensors freed when its result is
  dropped.

Tolerance rtol 2e-4 / atol 1e-5, exact mode.  Each launch is waited for
120 s at most, and its processes are killed on a timeout.
"""
import gc
import json
import os
import socket
import subprocess
import sys
import time
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from csmpn_tpu.algebra import CliffordAlgebra as JAlgebra
from csmpn_tpu.nn.egcl import EGCL as JEGCL
from csmpn_tpu.ops import segment as jseg
from csmpn_tpu.parallel import edge_partition as jep
from csmpn_tpu.parallel.mesh import make_mesh as jmake_mesh
from csmpn_torch import bench_scaling
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn import EGCL
from csmpn_torch.nn.modules import init_parameters
from csmpn_torch.ops import segment as seg
from csmpn_torch.parallel import edge_partition as tep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=1e-5)
CL3 = (1.0, 1.0, 1.0)
JALG = JAlgebra(CL3)
HALO_FIELDS = ("edge_index", "edge_mask", "send_idx", "send_mask",
               "n_shards", "e_shard", "h_max", "nodes_per_shard",
               "edge_perm")
STREAM_FIELDS = ("edge_index", "edge_mask", "send_idx", "send_mask",
                 "n_shards", "n_chunks", "e_chunk", "h_max",
                 "nodes_per_shard", "nodes_per_chunk", "edge_perm")


@pytest.fixture(autouse=True)
def _exact_mode():
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")
    yield
    seg.set_aggregation_mode("exact")
    jseg.set_aggregation_mode("exact")


def same_tables(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert a.tobytes() == b.tobytes(), f
        else:
            assert a == b, f


def close(got, want, msg=""):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=msg, **TOL)


def _port_layer(seed, attrs=False, aggr="mean"):
    layer = EGCL(get_algebra(CL3), CIN, HID, CIN,
                 edge_attr_features=CA if attrs else 0,
                 node_attr_features=CN if attrs else 0, aggr=aggr)
    init_parameters(layer, torch.Generator().manual_seed(seed))
    return layer


# ----------------------------------------------------------- host tables

@pytest.mark.parametrize("n,deg,seed,locality,shards,chunks", [
    (16, 4, 7, None, 4, 2), (16, 4, 8, None, 4, 1),      # test_parallel.py
    (32, 4, 31, None, 4, 2), (32, 4, 33, None, 4, 2),
    (24, 3, 5, 2, 3, 4), (64, 8, 0, 7, 8, 2), (40, 5, 3, None, 2, 5),
    (30, 2, 9, None, 1, 3)])
def test_halo_tables_byte_equal(n, deg, seed, locality, shards, chunks):
    ei = tep.make_synthetic_complex(n, deg, seed=seed, locality=locality)
    same_tables(tep.partition_edges_halo(ei, n, shards),
                jep.partition_edges_halo(ei, n, shards), HALO_FIELDS)
    same_tables(tep.partition_edges_halo_stream(ei, n, shards, chunks),
                jep.partition_edges_halo_stream(ei, n, shards, chunks),
                STREAM_FIELDS)


def test_halo_tables_of_unsorted_repeated_edges_byte_equal():
    ei = tep.make_synthetic_complex(36, 5, seed=4)
    ei = np.concatenate([ei, ei[:, ::3]], axis=1)
    ei = ei[:, np.random.RandomState(4).permutation(ei.shape[1])]
    same_tables(tep.partition_edges_halo_stream(ei, 36, 3, 2),
                jep.partition_edges_halo_stream(ei, 36, 3, 2),
                STREAM_FIELDS)


@pytest.mark.parametrize("locality", [None, 512])
def test_halo_tables_at_200k_nodes_byte_equal_and_faster(locality):
    """8 shards x 5 chunks of 200,000 nodes, in-degree 4: the reference
    loops over every remote node and remote edge in Python (about 700,000
    remote edges with uniform sources), the port does not."""
    n = 200_000
    ei = tep.make_synthetic_complex(n, 4, seed=0, locality=locality)
    t0 = time.perf_counter()
    got = tep.partition_edges_halo_stream(ei, n, 8, 5)
    t_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = jep.partition_edges_halo_stream(ei, n, 8, 5)
    t_ref = time.perf_counter() - t0
    same_tables(got, want, STREAM_FIELDS)
    print(f"locality {locality}: port {t_port:.3f} s, reference "
          f"{t_ref:.3f} s, {int(got.send_mask.sum())} halo rows")
    assert t_port < t_ref


@pytest.mark.parametrize("stream", [False, True])
def test_halo_tables_refuse_ragged_nodes(stream):
    """30 nodes over 4 shards; 10 nodes a shard in 4 chunks."""
    ei = tep.make_synthetic_complex(30, 2, seed=0)
    with pytest.raises(ValueError):
        if stream:
            tep.partition_edges_halo_stream(ei, 30, 3, 4)
        else:
            tep.partition_edges_halo(ei, 30, 4)


# --------------------------------------------------- the layers, ranks

# name -> (function, attributes, chunk_reduce, aggregation, seed)
CASES = {
    "halo": ("halo", False, False, "mean", 41),
    "halo-attrs": ("halo", True, False, "mean", 42),
    "allgather": ("allgather", False, False, "sum", 43),
    "allgather-attrs": ("allgather", True, False, "mean", 44),
    "stream_halo": ("stream_halo", False, False, "sum", 45),
    "stream_halo-attrs": ("stream_halo", True, False, "mean", 46),
    "stream_halo-reduce": ("stream_halo", True, True, "mean", 47),
    "stream_allgather": ("stream_allgather", False, False, "mean", 49),
    "stream_allgather-attrs": ("stream_allgather", True, False, "mean", 50),
    "stream_allgather-reduce": ("stream_allgather", False, True, "mean",
                                51),
}
WORLDS = (2, 4)
N_NODES, DEGREE, CHUNKS = 32, 4, 2
CIN, HID, CA, CN = 3, 4, 2, 1


def _inputs(name):
    """The case's complex, features, cotangent, attributes (original edge
    order) and the port's layer weights from a seed."""
    fn, attrs, reduce, aggr, seed = CASES[name]
    rng = np.random.RandomState(seed)
    layer = _port_layer(seed, attrs, aggr)
    return dict(
        fn=fn, attrs=attrs, reduce=reduce, aggr=aggr,
        ei=jep.make_synthetic_complex(N_NODES, DEGREE, seed=seed),
        h=rng.randn(N_NODES, CIN, 8).astype(np.float32),
        g=rng.randn(N_NODES, CIN, 8).astype(np.float32),
        ea=(rng.randn(N_NODES * DEGREE, CA, 8).astype(np.float32) if attrs
            else None),
        na=rng.randn(N_NODES, CN, 8).astype(np.float32) if attrs else None,
        state=layer.state_dict())


def _partition(mod, fn, ei, world):
    if fn == "halo":
        return mod.partition_edges_halo(ei, N_NODES, world)
    if fn == "allgather":
        return mod.partition_edges(ei, N_NODES, world)
    if fn == "stream_halo":
        return mod.partition_edges_halo_stream(ei, N_NODES, world, CHUNKS)
    return mod.partition_edges(ei, N_NODES, world * CHUNKS)


def _to_edges(part, slab_rows):
    """Rows in a partition's slab order -> original edge order."""
    perm = np.asarray(part.edge_perm)
    out = np.zeros((perm.max() + 1,) + slab_rows.shape[1:], slab_rows.dtype)
    out[perm[perm >= 0]] = slab_rows[perm >= 0]
    return out


def _reference(k, world=4):
    """The case's JAX function on the ``world``-device virtual mesh, the
    same weights: its output (or scalar) and the gradients of sum(out *
    g) (or of the scalar) with respect to the parameters, h and, with
    attributes, node_attr and edge_attr (original edge order)."""
    jl = JEGCL(JALG, CIN, HID, CIN, edge_attr_features=CA if k["attrs"]
               else 0, node_attr_features=CN if k["attrs"] else 0,
               aggr=k["aggr"])
    mesh = jmake_mesh(world)
    part = _partition(jep, k["fn"], k["ei"], world)

    def red(out):
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def f(p, h, *attrs):
        nn, ee = attrs if attrs else (None, None)
        kw = dict(node_attr=nn, edge_attr=ee)
        if k["fn"].startswith("stream"):
            kw.update(chunk_reduce=red if k["reduce"] else None)
        if k["fn"] == "halo":
            return jep.sharded_egcl_apply_halo(jl, p, h, part, mesh, **kw)
        if k["fn"] == "allgather":
            return jep.sharded_egcl_apply(jl, p, h, part, mesh, **kw)
        if k["fn"] == "stream_halo":
            return jep.sharded_streaming_egcl_apply(jl, p, h, part, mesh,
                                                    **kw)
        return jep.sharded_streaming_egcl_apply_allgather(
            jl, p, h, part, mesh, world, **kw)

    def out_and_grads(cot, *args):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)

    params = jax.tree.map(jnp.asarray, params_to_jax(k["state"]))
    args = (params, jnp.asarray(k["h"]))
    if k["attrs"]:
        args += (jnp.asarray(k["na"]),
                 jnp.asarray(jep.permute_edge_payload(part, k["ea"])))
    cot = jnp.ones(()) if k["reduce"] else jnp.asarray(k["g"])
    out, grads = jax.jit(out_and_grads)(cot, *args)
    grads = [jax.tree.map(np.asarray, gr) for gr in grads]
    if k["attrs"]:
        grads[3] = _to_edges(part, grads[3])
    return np.asarray(out), grads


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from csmpn_torch.algebra import get_algebra
from csmpn_torch.nn import EGCL
from csmpn_torch.ops import segment as seg
from csmpn_torch.parallel import edge_partition as tep
from csmpn_torch.parallel.mesh import Mesh, all_reduce_grads

rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
seg.set_aggregation_mode("exact")
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
sent = []
_a2a = dist.all_to_all_single


def counted(out, inp, *a, **k):
    sent.append(int(inp.shape[0]))
    return _a2a(out, inp, *a, **k)


dist.all_to_all_single = counted
mesh = Mesh(rank, world, torch.device("cpu"))
cases = torch.load(path, weights_only=False)
FNS = {"halo": (tep.partition_edges_halo, tep.sharded_egcl_apply_halo),
       "allgather": (tep.partition_edges, tep.sharded_egcl_apply),
       "stream_halo": (tep.partition_edges_halo_stream,
                       tep.sharded_streaming_egcl_apply),
       "stream_allgather": (tep.partition_edges,
                            tep.sharded_streaming_egcl_apply_allgather)}
results = {}
for name, c in cases.items():
    n, fn = c["n"], c["fn"]
    build, apply = FNS[fn]
    if fn == "stream_halo":
        part = build(c["ei"], n, world, c["chunks"])
    elif fn == "stream_allgather":
        part = build(c["ei"], n, world * c["chunks"])
    else:
        part = build(c["ei"], n, world)
    nps, rows = n // world, part.edge_mask.size // world
    own = slice(rank * nps, (rank + 1) * nps)
    slab = slice(rank * rows, (rank + 1) * rows)
    h = torch.from_numpy(c["h"][own].copy()).requires_grad_(True)
    kw = {}
    if c["attrs"]:
        ea = tep.permute_edge_payload(part, c["ea"])
        kw["edge_attr"] = torch.from_numpy(ea[slab].copy()).requires_grad_(
            True)
        kw["node_attr"] = torch.from_numpy(
            c["na"][own].copy()).requires_grad_(True)
    if c["reduce"]:
        kw["chunk_reduce"] = lambda o: torch.sum(o.float() ** 2)
    layer = EGCL(get_algebra((1.0, 1.0, 1.0)), *c["widths"],
                 edge_attr_features=c["ca"], node_attr_features=c["cn"],
                 aggr=c["aggr"])
    layer.load_state_dict(c["state"])
    del sent[:]
    out = apply(layer, h, part, **kw)
    if c["reduce"]:
        out.backward()
    else:
        (out * torch.from_numpy(c["g"][own])).sum().backward()
    all_reduce_grads(layer.parameters(), mesh, reduce="sum")
    results[name] = {
        "out": out.detach(), "dh": h.grad, "sent": list(sent),
        "grads": {k: p.grad for k, p in layer.named_parameters()},
        "dna": kw["node_attr"].grad if c["attrs"] else None,
        "dea": kw["edge_attr"].grad if c["attrs"] else None,
        "perm": part.edge_perm[slab]}
torch.save(results, f"{path}.{rank}")
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv, log):
    env = {k: v for k, v in os.environ.items() if not k.startswith(
        ("SLURM", "TORCHELASTIC", "MASTER_", "WORLD_SIZE", "RANK",
         "LOCAL_RANK"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True)


def _wait(procs, logs, timeout=120):
    """Waits for ``procs`` (killing them all on a timeout) and returns
    their output, read from ``logs``; each must exit with 0."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for p, log in zip(procs, logs):
        log.seek(0)
        outs.append(log.read())
        log.close()
        assert p.returncode == 0, f"a process failed:\n{outs[-1][-4000:]}"
    return outs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """({case: inputs}, {case: the reference}, {world: [each rank's
    results]}): every case in one launch of 2 and one of 4 gloo ranks,
    running while the reference compiles."""
    inputs = {name: _inputs(name) for name in CASES}
    cases = {name: dict(
        n=N_NODES, chunks=CHUNKS, fn=k["fn"], attrs=k["attrs"],
        reduce=k["reduce"], aggr=k["aggr"], widths=(CIN, HID, CIN),
        ca=CA if k["attrs"] else 0, cn=CN if k["attrs"] else 0, ei=k["ei"],
        h=k["h"], g=k["g"], ea=k["ea"], na=k["na"], state=k["state"])
        for name, k in inputs.items()}
    tmp = tmp_path_factory.mktemp("ranks")
    launched = {}
    for world in WORLDS:
        path, port = str(tmp / f"world{world}.pt"), str(_free_port())
        torch.save(cases, path)
        logs = [open(tmp / f"world{world}.{r}.log", "w+")
                for r in range(world)]
        launched[world] = (path, logs, [
            _spawn([sys.executable, "-c", _WORKER, str(r), str(world), port,
                    path], log) for r, log in enumerate(logs)])
    refs = {name: _reference(k) for name, k in inputs.items()}
    results = {}
    for world, (path, logs, procs) in launched.items():
        _wait(procs, logs)
        results[world] = [torch.load(f"{path}.{r}", weights_only=False)
                          for r in range(world)]
    return inputs, refs, results


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_layer_matches_reference(ranks, world, name):
    inputs, refs, results = ranks
    k = inputs[name]
    want, grads = refs[name]
    want_p = params_from_jax(grads[0])
    nps = N_NODES // world
    for rank, res in enumerate(results[world]):
        got = res[name]
        own = slice(rank * nps, (rank + 1) * nps)
        if k["reduce"]:
            assert got["out"].dim() == 0
            np.testing.assert_allclose(float(got["out"]), float(want),
                                       rtol=1e-5)
        else:
            close(got["out"], want[own], f"rank {rank} output")
        for pname, gr in got["grads"].items():
            close(gr, want_p[pname], f"rank {rank} {pname}")
        close(got["dh"], grads[1][own], f"rank {rank} d(h)")
        if k["attrs"]:
            close(got["dna"], grads[2][own], f"rank {rank} d(node_attr)")
            real = got["perm"] >= 0
            close(got["dea"][real], grads[3][got["perm"][real]],
                  f"rank {rank} d(edge_attr)")
            assert not got["dea"][~real].any()


@pytest.mark.parametrize("name", ["halo", "stream_halo-reduce"])
@pytest.mark.parametrize("world", WORLDS)
def test_halo_ships_only_real_rows(ranks, world, name):
    """Each rank's all_to_all sends the rows it owes (forward) and the
    cotangents of the rows it received (backward), no padding."""
    inputs, _, results = ranks
    part = _partition(tep, inputs[name]["fn"], inputs[name]["ei"], world)
    counts = part.send_mask.sum(-1)
    for rank, res in enumerate(results[world]):
        assert res[name]["sent"] == [int(counts[rank].sum()),
                                     int(counts[:, rank].sum())]
    total = int(part.send_mask.sum())
    assert 0 < total < world * world * part.h_max


# -------------------------------------------------- one process, world 1

@pytest.fixture
def group_of_one():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()




def _grads(layer, run, h, g):
    hh = h.clone().requires_grad_(True)
    layer.zero_grad(set_to_none=True)
    out = run(hh)
    (out * g).sum().backward()
    return out.detach(), hh.grad, [p.grad.clone() for p in
                                   layer.parameters()]


@pytest.mark.parametrize("form", ["halo", "allgather", "stream_halo",
                                  "stream_allgather"])
def test_world_one_matches_the_flat_and_streamed_layers(group_of_one, form):
    ei = tep.make_synthetic_complex(48, 4, seed=2)
    rng = np.random.RandomState(2)
    h = torch.from_numpy(rng.randn(48, CIN, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(48, CIN, 8).astype(np.float32))
    layer = _port_layer(2)
    if form.startswith("stream"):
        part = tep.partition_edges(ei, 48, 3)
        want = _grads(layer, lambda x: tep.streaming_egcl_apply(
            layer, x, part), h, g)
    else:
        want = _grads(layer, lambda x: layer(x, torch.from_numpy(ei)), h, g)
    part = {"halo": lambda: tep.partition_edges_halo(ei, 48, 1),
            "allgather": lambda: tep.partition_edges(ei, 48, 1),
            "stream_halo": lambda: tep.partition_edges_halo_stream(
                ei, 48, 1, 3),
            "stream_allgather": lambda: tep.partition_edges(ei, 48, 3)}[
        form]()
    apply = {"halo": tep.sharded_egcl_apply_halo,
             "allgather": tep.sharded_egcl_apply,
             "stream_halo": tep.sharded_streaming_egcl_apply,
             "stream_allgather": tep.sharded_streaming_egcl_apply_allgather
             }[form]
    arrays = tep.ShardArrays(part, 0, 1, torch.device("cpu"))
    got = _grads(layer, lambda x: apply(layer, x, part, arrays=arrays), h, g)
    for a, b, what in zip(got[:2], want[:2], ("output", "d(h)")):
        close(a, b.numpy(), what)
    for a, b in zip(got[2], want[2]):
        close(a, b.numpy(), "parameter gradient")


@pytest.mark.parametrize("attrs", [False, True])
def test_shards_on_one_card_matches_world_one(attrs):
    """chip_smoke's ``shards_on_one_card``: the shard body of each shard
    of a 4-shard halo partition, its halo rows taken by indexing the full
    h, outputs concatenated and gradients gathered back, against the flat
    layer."""
    sys.path.insert(0, REPO)
    import chip_smoke

    n = 64
    ei = tep.make_synthetic_complex(n, 4, seed=3)
    rng = np.random.RandomState(3)
    h = torch.from_numpy(rng.randn(n, CIN, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(n, CIN, 8).astype(np.float32))
    layer = _port_layer(3, attrs)
    part = tep.partition_edges_halo(ei, n, 4)
    na = ea = ea_slab = None
    if attrs:
        na = torch.from_numpy(rng.randn(n, CN, 8).astype(np.float32))
        ea = rng.randn(ei.shape[1], CA, 8).astype(np.float32)
        ea_slab = torch.from_numpy(tep.permute_edge_payload(part, ea))
        ea = torch.from_numpy(ea)
    want = _grads(layer, lambda x: layer(x, torch.from_numpy(ei), ea, na),
                  h, g)
    got = _grads(layer, lambda x: chip_smoke.shards_on_one_card(
        layer, x, part, na, ea_slab), h, g)
    for a, b, what in zip(got[:2], want[:2], ("output", "d(h)")):
        close(a, b.numpy(), what)
    for a, b in zip(got[2], want[2]):
        close(a, b.numpy(), "parameter gradient")


def test_shard_arrays_refuse_another_partition(group_of_one):
    ei = tep.make_synthetic_complex(24, 3, seed=1)
    layer = _port_layer(1)
    h = torch.zeros(24, CIN, 8)
    part = tep.partition_edges_halo(ei, 24, 1)
    other = tep.partition_edges_halo(ei, 24, 1)
    arrays = tep.ShardArrays(part, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        tep.sharded_egcl_apply_halo(layer, h, other, arrays=arrays)
    with pytest.raises(ValueError):               # 2 shards, 1 rank
        tep.sharded_egcl_apply_halo(layer, h[:12],
                                    tep.partition_edges_halo(ei, 24, 2))
    with pytest.raises(ValueError):               # one slab a rank
        tep.sharded_egcl_apply(layer, h, tep.partition_edges(ei, 24, 2))
    with pytest.raises(ValueError):               # this rank's rows
        tep.sharded_egcl_apply_halo(layer, h[:12], part)


@pytest.mark.parametrize("form", ["halo", "allgather", "stream_halo",
                                  "stream_allgather"])
def test_layers_refuse_without_a_group(form):
    assert not dist.is_initialized()
    ei = tep.make_synthetic_complex(N_NODES, 2, seed=0)
    layer = _port_layer(0)
    part = _partition(tep, form, ei, 1)
    apply = {"halo": tep.sharded_egcl_apply_halo,
             "allgather": tep.sharded_egcl_apply,
             "stream_halo": tep.sharded_streaming_egcl_apply,
             "stream_allgather": tep.sharded_streaming_egcl_apply_allgather
             }[form]
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        apply(layer, torch.zeros(N_NODES, CIN, 8), part)


# ------------------------------------------------------ the entry point

BENCH = ["--device=cpu", "--simplices", "256", "--degree", "4", "--steps",
         "1"]


@pytest.mark.parametrize("argv,exc", [
    (BENCH, RuntimeError),                            # the sweep, no group
    (BENCH + ["--stream", "4", "--devices", "2"], ValueError),
    (BENCH + ["--devices", "2"], ValueError)],
    ids=["sweep-without-a-group", "stream-devices-not-world",
         "sweep-devices-not-world"])
def test_bench_scaling_refuses_outside_a_group(argv, exc):
    assert not dist.is_initialized()
    with pytest.raises(exc):
        bench_scaling.main(argv)


@pytest.mark.parametrize("mode", ["stream", "stream-fwd", "sweep",
                                  "sharded-stream"])
def test_bench_scaling_frees_its_tensors_when_released(group_of_one, mode):
    """Dropping a run's result frees its features at once: no reference
    cycle keeps a step's tensors alive until the garbage collector runs
    (chip_smoke measures the forward-only peak after a fwd+bwd run)."""
    from csmpn_torch.parallel.mesh import Mesh

    gc.collect()
    gc.disable()
    try:
        if mode == "sharded-stream":
            res = bench_scaling.run_sharded_streaming(
                bench_scaling.parse_args(BENCH + ["--stream", "2"]),
                Mesh(0, 1, torch.device("cpu")))
        else:
            res = bench_scaling.main(BENCH + {
                "stream": ["--stream", "4"],
                "stream-fwd": ["--stream", "4", "--fwd-only"],
                "sweep": ["--mesh-list", "1"]}[mode])
        h = res["sizes"][1]["h"] if mode == "sweep" else res["h"]
        alive = weakref.ref(h)
        del res, h
        assert alive() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("extra", [
    ["--mesh-list", "1,2"], ["--exchange", "allgather"],
    ["--stream", "2"], ["--stream", "2", "--exchange", "allgather",
                        "--fwd-only"]],
    ids=["sweep-halo", "sweep-allgather", "stream-halo",
         "stream-allgather-fwd"])
def test_bench_scaling_under_torchrun(extra, tmp_path):
    """Two ranks through ``torch.distributed.run``: rank 0 prints the
    reference's lines, whose exchanged rows are the reference partition's;
    rank 1 prints none."""
    argv = [sys.executable, "-m", "torch.distributed.run",
            "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
            "--master_port", str(_free_port()), "-m",
            "csmpn_torch.bench_scaling"] + BENCH + extra
    log = open(tmp_path / "torchrun.log", "w+")
    out = _wait([_spawn(argv, log)], [log])[0]
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    ei = jep.make_synthetic_complex(256, 4, seed=0)
    halo = "allgather" not in extra
    if "--stream" in extra:
        assert len(lines) == 1
        line = lines[0]
        assert line["metric"] == "sharded_streaming_edges_per_s"
        assert (line["devices"], line["chunks_per_device"], line["edges"],
                line["precision"]) == (2, 2, 1024, "fast")
        assert line["mode"] == ("fwd" if "--fwd-only" in extra
                                else "fwd+bwd")
        part = jep.partition_edges_halo_stream(ei, 256, 2, 2)
        want = int(part.send_mask.sum()) if halo else 256
        assert line["comm_rows"] == want
        assert line["allgather_rows_equiv"] == 256
        assert line["comm_rows_padded"] == (4 * part.h_max if halo else 256)
    else:
        *sizes, eff = lines
        assert [x["mesh_devices"] for x in sizes] == [1, 2]
        for line in sizes:
            n = line["mesh_devices"]
            assert line["metric"] == "edge_partitioned_edges_per_s"
            assert line["exchange"] == ("halo" if halo else "allgather")
            if halo:
                part = jep.partition_edges_halo(ei, 256, n)
                assert line["comm_rows"] == int(part.send_mask.sum())
                assert line["comm_rows_padded"] == n * n * part.h_max
            else:
                assert line["comm_rows"] == (n - 1) * 256
        assert eff["metric"] == "edges_per_s_scaling_efficiency"
        assert eff["mesh_devices"] == 2 and eff["value"] > 0
        losses = [float(x.rsplit("loss ", 1)[1]) for x in out.splitlines()
                  if x.startswith("# mesh")]
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for line in lines:
        assert line["value"] > 0 and line["device"] == "cpu"
