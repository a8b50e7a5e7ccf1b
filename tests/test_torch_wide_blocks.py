"""The dense CEMLP block at the widths the row kernels do not take (K2w and
K3w on the card: every C <= 128 output and Cin <= 320 input channels, at
Cl(3,0) and Cl(2,0)) against the reference package, the routing of a
launch between the K2/K3 of csrc/cemlp.cu and the wide ones, and the
models and a task entry point at hidden widths above K2/K3's limits.

  * plain K2 and K3, exact, at Cl(3) (34 -> 40, 154 -> 64, 282 -> 128)
    and Cl(2) (131 -> 64, 259 -> 128): the output against the flat XLA
    oracle ``_block_flat_xla`` (the reference kernel's block math) and the
    composed flax CEMLP, dx and the 10 parameter gradients against
    ``jax.grad`` of the composed CEMLP;
  * the same in fast mode against the body of the reference's kernel
    (``_forward_math`` with the dense tables, its rounding points) and its
    ``jax.vjp``;
  * ``block_route`` with the library's plan entries stood in: K2/K3
    where their plan takes (Cin, C) in the launch's mode and
    direction, K2w/K3w everywhere else in range, NotImplementedError at
    C = 129 and Cin = 321; the CPU wrappers take the plain versions at
    wide widths and count no launch;
  * the motion (hidden 40), MD17 (48) and NBA (72) models, one layer, a
    batch of 2, every CEMLP on the block kernels' route (their plain
    versions on the CPU), on the same weights as the flax models: loss and
    every gradient;
  * the motion task through its entry point at --model.num_hidden=40 on
    the CPU, 2 steps.

Tolerances: rtol 2e-4 / atol 1e-5 in exact fp32 (the reference's parity
tolerance; model gradients rtol 1e-3 as in tests/test_torch_md17.py).
Fast mode as tests/test_torch_kernels.py: both sides round the same
operands to bf16, but a different fp32 summation order can move a value
across a bf16 rounding boundary, so 1e-2 (forward) and 3e-2 (backward) of
each tensor's largest magnitude.  The CUDA kernels are held to these plain
versions on the card by chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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
METRIC = {3: (1.0, 1.0, 1.0), 2: (1.0, 1.0)}
# (algebra dim, rows, Cin, C): wider than K2/K3 take at every
# mode (C > 32 at Cl(3); at Cl(2) 131 -> 64 is past the fast mode's 80
# inputs at C = 64), up to the range's widest output
SHAPES = [(3, 13, 34, 40), (3, 9, 154, 64), (3, 6, 282, 128),
          (2, 11, 131, 64), (2, 7, 259, 128)]


def _ids(shape):
    return f"cl{shape[0]}_{shape[2]}to{shape[3]}"


def _block(dim, rows, cin, c, seed=0):
    """A one-block CEMLP made by the port from a seed with its parameters
    moved off their constant init, the same parameters as a flax tree, the
    reference's composed module, an input and an output cotangent."""
    nb = 2 ** dim
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, cin, nb).astype(np.float32)
    g = rng.randn(rows, c, nb).astype(np.float32)
    t = CEMLP(get_algebra(METRIC[dim]), cin, c, c, n_layers=1)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(t, gen)
    with torch.no_grad():
        for p in t.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(t.state_dict()))
    m = JCEMLP(jax_algebra(METRIC[dim]), cin, c, c, n_layers=1, fused=False)
    return params, m, x, g, t


def _fast_close(got, want, kind, msg=""):
    got = got.detach().numpy()
    want = np.asarray(want)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= FAST_TOL[kind], f"{msg}: rel err {err:.3e}"


def _flat(dim, cin, c):
    nb = 2 ** dim
    return jck._round_up(cin * nb, 128), jck._round_up(c * nb, 128)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_wide_k2_k3_exact_match_reference(shape):
    """Plain K2 against the reference kernel's flat block math and the
    composed CEMLP; plain K3 (dx and all 10 gradients) against jax.grad."""
    dim, rows, cin, c = shape
    nb = 2 ** dim
    params, m, x, g, t = _block(dim, rows, cin, c, seed=cin)
    # the oracle takes one padded width for the block's input and output
    lin_p = lp = max(_flat(dim, cin, c))
    tables = jck.block_tables(m.bind(params), 0, lin_p, lp)
    const = jck._structural_tables(dim, METRIC[dim], c, lp)
    xf = np.zeros((rows, lin_p), np.float32)
    xf[:, :cin * nb] = x.reshape(rows, -1)
    want = np.asarray(jax.jit(jck._block_flat_xla, static_argnums=3)(
        jnp.asarray(xf), tables, tuple(jnp.asarray(a) for a in const), nb))
    alg = get_algebra(METRIC[dim])
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 alg, exact=True)
    np.testing.assert_allclose(got.detach().numpy(),
                               want[:, :c * nb].reshape(rows, c, nb),
                               rtol=RTOL, atol=ATOL)

    def f(p, xx):
        return jnp.sum(m.apply(p, xx) * jnp.asarray(g))

    (j_gp, j_gx), j_out = jax.jit(lambda p, xx: (
        jax.grad(f, argnums=(0, 1))(p, xx), m.apply(p, xx)))(
        params, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(j_out),
                               rtol=RTOL, atol=ATOL)
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), alg, exact=True)
    np.testing.assert_allclose(dx.numpy(), np.asarray(j_gx), rtol=RTOL,
                               atol=ATOL)
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    assert len(names) == len(grads) == 10
    for k, gr in zip(names, grads):
        np.testing.assert_allclose(gr.numpy(), j_grads[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_plain_wide_k2_k3_fast_match_kernel_body(shape):
    """Plain K2 and K3 in fast mode against the body of the reference's
    kernel (``_forward_math``, dense tables, fast rounding) and its vjp:
    the output, dx and all 10 parameter gradients."""
    dim, rows, cin, c = shape
    nb = 2 ** dim
    params, m, x, g, t = _block(dim, rows, cin, c, seed=c)
    lin_p, lp = _flat(dim, cin, c)
    const = tuple(jnp.asarray(a) for a in
                  jck._structural_tables(dim, METRIC[dim], c, lp))

    def run(p, xx):
        xpad = jnp.pad(xx.reshape(rows, cin * nb),
                       ((0, 0), (0, lin_p - cin * nb)))

        def body(mod):
            refs = tuple(jck.block_tables(mod, 0, lin_p, lp)) + const
            return jck._forward_math(xpad, refs, nb, False)["out"]

        return m.apply(p, method=body)[:, :c * nb].reshape(rows, c, nb)

    j_out, (j_gp, j_gx) = jax.jit(lambda p, xx, gg: (
        run(p, xx), jax.vjp(run, p, xx)[1](gg)))(
        params, jnp.asarray(x), jnp.asarray(g))
    alg = get_algebra(METRIC[dim])
    got = ck.block_forward_plain(torch.from_numpy(x), ck.block_params(t, 0),
                                 alg, exact=False)
    _fast_close(got, j_out, "fwd", "out")
    dx, grads = ck.block_backward(torch.from_numpy(x), torch.from_numpy(g),
                                  ck.block_params(t, 0), alg, exact=False)
    _fast_close(dx, j_gx, "bwd", "dx")
    j_grads = params_from_jax(jax.tree.map(np.asarray, j_gp))
    names = [k for k, _ in t.named_parameters()]
    for k, gr in zip(names, grads):
        _fast_close(gr, j_grads[k].numpy(), "bwd", k)


# ------------------------------------------------------------------ routing

class _Entry:
    """A C entry point stood in by a Python function."""

    def __init__(self, fn):
        self.fn = fn
        self.argtypes = None
        self.restype = None

    def __call__(self, *args):
        return self.fn(*args)


class _Lib:
    def __init__(self, **entries):
        self.__dict__.update(entries)


# K2/K3's plan, stood in: the row tiles (fast) take up to 60 inputs at C
# <= 28, the row kernels (exact) up to 40; K2w/K3w's library takes C <= 128
# and Cin <= 320 and says so through its range entry
def _plan_lib(kern, wide):
    def tile(cin, c):
        return 50_000 if cin <= 60 and c <= 28 else 0

    def row(cin, c, backward):
        return 1000 * cin if cin <= 40 and c <= 28 else 0

    def wide_smem(cin, c, backward):
        return 90_000 if 1 <= c <= 128 and 1 <= cin <= 320 else 0

    def wide_range(out):
        out[0], out[1] = 128, 320

    return _Lib(**{f"{kern.symbol}_tile_smem_bytes": _Entry(tile),
                   f"{kern.symbol}_fwd_tile_smem_bytes": _Entry(tile),
                   f"{kern.symbol}_smem_bytes": _Entry(row),
                   f"{wide.symbol}_smem_bytes": _Entry(wide_smem),
                   f"{wide.symbol}_range": _Entry(wide_range)})


@pytest.mark.parametrize("kern", [ck.DENSE, ck.DENSE_CL2],
                         ids=lambda k: k.label)
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_block_route(monkeypatch, kern, backward, exact):
    """Today's kernels where their plan takes the widths in this mode and
    direction, K2w/K3w (of the same algebra) for every other (Cin, C) in
    range, NotImplementedError beyond it, naming the range."""
    wide = ck.WIDE if kern.n_blades == 8 else ck.WIDE_CL2
    monkeypatch.setattr(_build, "load", lambda name: _plan_lib(kern, wide))
    assert wide.n_blades == kern.n_blades
    assert wide.n_paths == kern.n_paths
    assert wide.source in ("cemlp_wide", "cemlp_wide_cl2")
    takes = (lambda cin, c: cin <= 40 and c <= 28) if exact else (
        lambda cin, c: cin <= 60 and c <= 28)
    for cin, c in [(34, 28), (40, 20), (59, 28), (61, 28), (41, 28),
                   (4, 33), (34, 40), (131, 64), (70, 65), (320, 128),
                   (1, 1), (282, 128), (320, 1)]:
        got, smem = ck.block_route(kern, cin, c, backward, exact)
        assert got is (kern if takes(cin, c) else wide), (cin, c)
        assert (smem > 0) == takes(cin, c)
    for cin, c in [(34, 129), (321, 128), (321, 4), (400, 200)]:
        with pytest.raises(NotImplementedError, match="at most 128 output "
                           "and 320 input channels"):
            ck.block_route(kern, cin, c, backward, exact)


@pytest.mark.parametrize("dim,cin,c", [(3, 34, 40), (2, 131, 64)])
def test_cpu_wrappers_take_plain_versions_at_wide_widths(dim, cin, c):
    counters = (ck.FWD_LAUNCHES, ck.BWD_LAUNCHES, ck.CL2_FWD_LAUNCHES,
                ck.CL2_BWD_LAUNCHES, ck.WIDE_FWD_LAUNCHES,
                ck.WIDE_BWD_LAUNCHES, ck.WIDE_CL2_FWD_LAUNCHES,
                ck.WIDE_CL2_BWD_LAUNCHES)
    for cnt in counters:
        cnt.reset()
    _, _, x, g, t = _block(dim, 5, cin, c)
    alg = get_algebra(METRIC[dim])
    params = ck.block_params(t, 0)
    x = torch.from_numpy(x)
    out = ck.block_forward(x, params, alg, exact=True)
    torch.testing.assert_close(out, ck.block_forward_plain(x, params, alg))
    dx, _ = ck.block_backward(x, torch.from_numpy(g), params, alg)
    assert dx.shape == x.shape
    assert [cnt.count for cnt in counters] == [0] * len(counters)


# ------------------------------------------------------------------- models

def _datasets(tmp_path_factory, jcls, tcls, kw):
    old = os.environ.get("DATAROOT")
    out = {}
    try:
        for name, cls in (("jax", jcls), ("torch", tcls)):
            os.environ["DATAROOT"] = str(tmp_path_factory.mktemp(
                f"dataroot_{name}"))
            out[name] = cls(**kw)
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old
    return out["jax"], out["torch"]


def _task(task):
    """(reference dataset, port dataset, reference model, port model,
    keyword arguments) of a task at a hidden width above K2/K3's limit."""
    if task == "motion":
        from csmpn_tpu.data.motion import MotionDataset as JD
        from csmpn_tpu.models.motion import MotionModel as JM
        from csmpn_torch.data.motion import MotionDataset as TD
        from csmpn_torch.models.motion import MotionModel as TM
        return JD, TD, JM, TM, dict(batch_size=4, num_training_samples=11,
                                    num_eval_samples=6), 40
    if task == "md17":
        from csmpn_tpu.data.md17 import MD17Dataset as JD
        from csmpn_tpu.models.md17 import MD17Model as JM
        from csmpn_torch.data.md17 import MD17Dataset as TD
        from csmpn_torch.models.md17 import MD17Model as TM
        return JD, TD, JM, TM, dict(batch_size=2, molecule_type="aspirin",
                                    dis=3, num_train_samples=4,
                                    num_eval_samples=2), 48
    from csmpn_tpu.data.nba import NBADataset as JD
    from csmpn_tpu.models.nba import NBAModel as JM
    from csmpn_torch.data.nba import NBADataset as TD
    from csmpn_torch.models.nba import NBAModel as TM
    return JD, TD, JM, TM, dict(batch_size=2, synth_plays=20), 72


@pytest.mark.parametrize("task", ["motion", "md17", "nba"])
def test_wide_model_matches_jax(tmp_path_factory, task):
    """The model at hidden 40 (motion), 48 (MD17) or 72 (NBA, past the
    Cl(2) lanes' 64), one layer, a batch of 2, with every CEMLP on the
    block kernels' route (fused=True: the plain K2/K3 on the CPU), against
    the flax model on the same weights: the loss and every gradient."""
    from csmpn_tpu.ops import segment as jseg

    jd, td, jm_cls, tm_cls, kw, hidden = _task(task)
    jds, tds = _datasets(tmp_path_factory, jd, td, kw)
    jseg.set_aggregation_mode("exact")
    seg.set_aggregation_mode("exact")
    mkw = dict(getattr(tds, "model_kwargs", {}), num_hidden=hidden,
               num_layers=1)
    tm = tm_cls(spec=tds.spec, **mkw)
    cemlps = [m for m in tm.modules() if isinstance(m, CEMLP)]
    assert any(m.out_features == hidden for m in cemlps)
    for m in cemlps:
        m.fused = True
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = jm_cls(spec=jds.spec, **mkw)
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


def test_motion_task_at_hidden_40_on_cpu(tmp_path):
    """Two steps of the motion task through its entry point at
    --model.num_hidden=40 (past the Cl(3) row kernels' 32 channels)."""
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.motion",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=2", "--trainer.val_check_interval=2",
           "--trainer.print_interval=1", "--trainer.log_interval=2",
           "--trainer.limit_val_batches=1",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.motion.MotionDataset",
           "--dataset.num_training_samples=11", "--dataset.batch_size=4",
           "--dataset.num_eval_samples=6",
           "--model.module=csmpn_torch.models.motion.MotionModel",
           "--model.num_hidden=40", "--model.num_layers=1", "--device=cpu"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for step in (0, 1):
        assert f"Step: {step} (Training) Loss:" in proc.stdout
    assert "Stopping due to max_steps." in proc.stdout
