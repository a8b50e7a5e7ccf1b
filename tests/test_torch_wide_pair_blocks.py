"""The pair-form CEMLP block at the widths K2p/K3p do not take (K2pw and
K3pw on the card: every C <= 64 output and Cin <= 160 input channels, at
Cl(5,0) and Cl(4,0)) against the reference package, the routing of a
pair-form launch between K2p/K3p and the wide kernels, and the hulls model
and task entry point at hidden widths above K2p/K3p's limits.

  * the plain K2p and K3p at Cl(5) (42 -> 36, 75 -> 36, 131 -> 64: the
    hulls edge block 0 at hidden 36, its node block 0 at hidden 36 and 64)
    and Cl(4) (83 -> 40), in both modes: the output against the pair-form
    body of the reference's kernel (``_forward_math`` with the tables of
    ``block_tables`` and ``_structural_tables``, its rounding points), dx
    and the 10 parameter gradients against ``jax.vjp`` of it;
  * ``block_route`` for the pair form with the libraries' entries stood
    in: K2p/K3p where their plan takes (Cin, C) in the launch's mode and
    direction, K2pw/K3pw everywhere else in range, NotImplementedError
    past it, naming the range; the CPU wrappers take the plain versions at
    wide widths and count no launch;
  * the hulls model at hidden 40 (one layer, a batch of 2, every CEMLP on
    the block kernels' route, their plain versions on the CPU) against the
    flax model on the same weights: the loss and every gradient;
  * the hulls task through its entry point at --model.hidden_features=36
    on the CPU, 2 steps.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance; model gradients rtol 1e-3 as in tests/test_torch_hulls.py).
Fast mode as tests/test_torch_cl4_kernels.py: both sides round the same
operands to bf16 at the same points, but a different fp32 summation
order can move a value across a bf16 rounding boundary, so 1e-2 (forward)
and 3e-2 (backward) of each tensor's largest magnitude.  The CUDA kernels
are held to these plain versions on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_wide_blocks import _Entry, _Lib
from csmpn_tpu.algebra import get_algebra as jax_algebra
from csmpn_tpu.nn.modules import CEMLP as JCEMLP
from csmpn_tpu.ops import cemlp_kernel as jck
from csmpn_torch.algebra import get_algebra
from csmpn_torch.convert import params_from_jax, params_to_jax
from csmpn_torch.nn.modules import CEMLP, init_parameters
from csmpn_torch.ops import _build
from csmpn_torch.ops import cemlp_kernel as ck
from csmpn_torch.ops import segment as seg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5
FAST_TOL = {"fwd": 1e-2, "bwd": 3e-2}
# (algebra dim, rows, Cin, C): past K2p/K3p's plans in both modes
SHAPES = [(5, 4, 42, 36), (5, 3, 75, 36), (5, 3, 131, 64), (4, 4, 83, 40)]
PAIR_COUNTERS = (ck.PAIR_FWD_LAUNCHES, ck.PAIR_BWD_LAUNCHES,
                 ck.PAIR_CL4_FWD_LAUNCHES, ck.PAIR_CL4_BWD_LAUNCHES,
                 ck.PAIR_WIDE_FWD_LAUNCHES, ck.PAIR_WIDE_BWD_LAUNCHES,
                 ck.PAIR_WIDE_CL4_FWD_LAUNCHES, ck.PAIR_WIDE_CL4_BWD_LAUNCHES)


def _metric(dim):
    return (1.0,) * dim


def _ids(shape):
    return f"cl{shape[0]}_{shape[2]}to{shape[3]}"


def _block(dim, rows, cin, c, seed=0):
    """A one-block CEMLP made by the port from a seed with its parameters
    moved off their constant init, the same parameters as a flax tree with
    the reference's module, an input and an output cotangent."""
    nb = 2 ** dim
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, nb).astype(np.float32)
    g = rng.randn(rows, c, nb).astype(np.float32)
    t = CEMLP(get_algebra(_metric(dim)), cin, c, c, n_layers=1)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(t, gen)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(_metric(dim)), cin, c, c, n_layers=1, fused=False)
    return m, params, x, g, t


def _jax_pair_block(m, dim, cin, c, exact):
    """params, x (rows, cin, nb) -> the block output through the pair-form
    body of the reference's kernel (``_forward_math``)."""
    nb = 2 ** dim
    lin_p = jck._round_up(cin * nb, 128)
    lp = jck._round_up(c * nb, 128)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(dim, _metric(dim), c, lp))
    assert jck._pair_form(nb) and len(const) == 8   # the pair form's tables

    def run(params, x):
        rows = x.shape[0]
        xf = jnp.pad(x.reshape(rows, cin * nb),
                     ((0, 0), (0, lin_p - cin * nb)))

        def body(mod):
            refs = tuple(jck.block_tables(mod, 0, lin_p, lp)) + const
            return jck._forward_math(xf, refs, nb, exact)["out"]

        out = m.apply(params, method=body)
        return out[:, :c * nb].reshape(rows, c, nb)

    return run


def _close(got, want, exact, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    if exact:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=msg)
    else:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_wide_pair_block_matches_jax_pair_math(shape, exact):
    """The plain K2p (output) and K3p (dx and all 10 parameter gradients in
    the flax shapes) against the reference's pair-form body and its
    vjp."""
    dim, rows, cin, c = shape
    m, params, x, g, t = _block(dim, rows, cin, c, seed=cin + c)
    fn = _jax_pair_block(m, dim, cin, c, exact)
    j_out, (j_gp, j_gx) = jax.jit(lambda p, xx, gg: (
        fn(p, xx), jax.vjp(fn, p, xx)[1](gg)))(
        params, jnp.asarray(x), jnp.asarray(g))
    alg = get_algebra(_metric(dim))
    bp = ck.block_params(t, 0)
    got = ck.block_forward_plain(torch.from_numpy(x), bp, alg, exact)
    _close(got, j_out, exact, "fwd", "out")
    dx, grads = ck.block_backward_plain(torch.from_numpy(x),
                                        torch.from_numpy(g), bp, alg, exact)
    _close(dx, j_gx, exact, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    for k, gr in zip(names, grads):
        _close(gr, j_grads[k].numpy(), exact, "bwd", k)


# ------------------------------------------------------------------ routing

# K2p/K3p's plan, stood in: the exact row kernels take up to 59 inputs at
# C <= 28, the fast forward row tiles up to 77, the fast backward's up to
# 83; K2pw/K3pw's library takes C <= 64 and Cin <= 160 and says so through
# its range entry
def _pair_plan_lib(kern, wide):
    def row(cin, c, backward):
        return 1000 * cin if cin <= 59 and c <= 28 else 0

    def fwd_tile(cin, c):
        return 60_000 if cin <= 77 and c <= 28 else 0

    def tile(cin, c):
        return 50_000 if cin <= 83 and c <= 28 else 0

    def wide_smem(cin, c, backward):
        return 200_000 if 1 <= c <= 64 and 1 <= cin <= 160 else 0

    def wide_range(out):
        out[0], out[1] = 64, 160

    return _Lib(**{f"{kern.symbol}_smem_bytes": _Entry(row),
                   f"{kern.symbol}_fwd_tile_smem_bytes": _Entry(fwd_tile),
                   f"{kern.symbol}_tile_smem_bytes": _Entry(tile),
                   f"{wide.symbol}_smem_bytes": _Entry(wide_smem),
                   f"{wide.symbol}_range": _Entry(wide_range)})


@pytest.mark.parametrize("kern", [ck.PAIR, ck.PAIR_CL4],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_block_route_pair_form(monkeypatch, kern, backward, exact):
    """K2p/K3p where their plan takes the widths in this mode and
    direction, K2pw/K3pw (of the same algebra) for every other (Cin, C) in
    range, NotImplementedError beyond it, naming the range."""
    wide = ck.WIDE_OF[kern.n_blades]
    monkeypatch.setattr(_build, "load", lambda name: _pair_plan_lib(kern,
                                                                     wide))
    assert wide.n_blades == kern.n_blades and wide.form == "pair"
    assert wide.n_paths == kern.n_paths and wide.n_grades == kern.n_grades
    assert wide.source in ("cemlp_pair_wide", "cemlp_pair_wide_cl4")
    if exact:
        def takes(cin, c):
            return cin <= 59 and c <= 28
    elif backward:
        def takes(cin, c):
            return cin <= 83 and c <= 28
    else:
        def takes(cin, c):
            return cin <= 77 and c <= 28
    for cin, c in [(34, 28), (59, 28), (60, 28), (77, 28), (78, 28),
                   (83, 28), (84, 28), (42, 36), (75, 36), (131, 64),
                   (160, 64), (2, 64), (1, 1), (160, 29), (3, 48)]:
        got, smem = ck.block_route(kern, cin, c, backward, exact)
        assert got is (kern if takes(cin, c) else wide), (cin, c)
        assert (smem > 0) == takes(cin, c)
    for cin, c in [(34, 65), (161, 64), (161, 4), (320, 128)]:
        with pytest.raises(NotImplementedError, match="pair-form block "
                           "kernels take at most 64 output and 160 input "
                           "channels"):
            ck.block_route(kern, cin, c, backward, exact)


@pytest.mark.parametrize("dim,cin,c", [(5, 75, 36), (4, 83, 40)])
def test_cpu_wrappers_take_plain_versions_at_wide_pair_widths(dim, cin, c):
    for cnt in PAIR_COUNTERS:
        cnt.reset()
    _, _, x, g, t = _block(dim, 3, cin, c)
    alg = get_algebra(_metric(dim))
    params = ck.block_params(t, 0)
    x = torch.from_numpy(x)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    dx, grads = ck.block_backward(x, torch.from_numpy(g), params, alg)
    rdx, rgrads = ck.block_backward_plain(x, torch.from_numpy(g), params,
                                          alg)
    torch.testing.assert_close(dx, rdx)
    assert len(grads) == len(rgrads) == 10
    assert [cnt.count for cnt in PAIR_COUNTERS] == [0] * len(PAIR_COUNTERS)


# -------------------------------------------------------------------- hulls

HULLS_KW = dict(num_samples=6, batch_size=2, num_val_samples=2)


def _datasets(tmp_path_factory):
    from csmpn_tpu.data.hulls import ConvexHullDataset as JD
    from csmpn_torch.data.hulls import ConvexHullDataset as TD

    old = os.environ.get("DATAROOT")
    out = {}
    try:
        for name, cls in (("jax", JD), ("torch", TD)):
            os.environ["DATAROOT"] = str(tmp_path_factory.mktemp(
                f"dataroot_{name}"))
            out[name] = cls(**HULLS_KW)
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old
    return out["jax"], out["torch"]


def test_hulls_model_at_hidden_40_matches_jax(tmp_path_factory):
    """The hulls model at hidden 40 (past K2p/K3p's 28-channel plans), one
    layer, a batch of 2, every CEMLP on the block kernels' route
    (fused=True: the plain pair-form blocks on the CPU), against the flax
    model on the same weights: the loss and every gradient."""
    from csmpn_tpu.models.hulls import HullsModel as JM
    from csmpn_tpu.ops import segment as jseg
    from csmpn_torch.models.hulls import HullsModel as TM

    jds, tds = _datasets(tmp_path_factory)
    jseg.set_aggregation_mode("exact")
    seg.set_aggregation_mode("exact")
    tm = TM(spec=tds.spec, hidden_features=40, num_layers=1)
    cemlps = [m for m in tm.modules() if isinstance(m, CEMLP)]
    assert cemlps and all(m.out_features == 40 for m in cemlps)
    for m in cemlps:
        m.fused = True
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = JM(spec=jds.spec, hidden_features=40, num_layers=1)
    jb = jds.train_dataset.select(np.arange(2))
    tb = tds.train_dataset.select(np.arange(2)).to("cpu")
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jm.apply(p, jb), has_aux=True))(params)
    t_loss, _ = tm(tb)
    t_loss.backward()
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=RTOL)
    jg = params_from_jax(jax.tree.map(np.asarray, j_grads))
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jg[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_hulls_task_at_hidden_36_on_cpu(tmp_path):
    """Two steps of the hulls task through its entry point at
    --model.hidden_features=36 (past K2p/K3p's plans)."""
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.hulls",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=2", "--trainer.val_check_interval=2",
           "--trainer.print_interval=1", "--trainer.log_interval=2",
           "--trainer.limit_val_batches=1",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.hulls.ConvexHullDataset",
           "--dataset.num_samples=6", "--dataset.batch_size=2",
           "--dataset.num_val_samples=2",
           "--model.module=csmpn_torch.models.hulls.HullsModel",
           "--model.hidden_features=36", "--model.num_layers=1",
           "--device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for step in (0, 1):
        assert f"Step: {step} (Training) Loss:" in proc.stdout
    assert "Stopping due to max_steps." in proc.stdout
