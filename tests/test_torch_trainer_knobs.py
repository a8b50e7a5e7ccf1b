"""The port's trainer knobs on the CPU, at the motion model's small widths
(hidden 4, one layer, batch 4): steps_per_dispatch, device_data,
eval_batches_per_dispatch, the profile window, max_rss_gb, donate and
mesh, and the port's Trainer against the reference's Trainer.

On the CPU the groups of steps_per_dispatch run eagerly (the CUDA graph of
the step runs on the card only, where chip_smoke.py holds it to the eager
steps), so the grouped and per-step paths do the same arithmetic and are
compared bit for bit.  Against the reference: the training losses within
its parity tolerance (rtol 2e-4, atol 1e-5, tests/test_train.py), the
parameters as stated in that test."""
import collections
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

STEPS = 8
DS_KW = dict(batch_size=4, num_training_samples=11, num_eval_samples=18)


def _in_dataroot(root, make):
    old = os.environ.get("DATAROOT")
    os.environ["DATAROOT"] = root
    try:
        return make()
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    from csmpn_torch.data.motion import MotionDataset

    root = str(tmp_path_factory.mktemp("dataroot_torch"))
    return _in_dataroot(root, lambda: MotionDataset(**DS_KW))


def _model(ds, seed=0):
    from csmpn_torch.models.motion import MotionModel
    from csmpn_torch.nn.modules import init_parameters

    model = MotionModel(spec=ds.spec, num_hidden=4, num_layers=1)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _train(ds, tmp_path, k=1, device_data=False, steps=STEPS,
           schedule=None, trainer_cls=None, val=False, **kw):
    """Trains a fresh model for ``steps`` steps; returns (trainer, model,
    the lr each optimizer step used)."""
    from csmpn_torch.engineer.loggers import ConsoleLogger
    from csmpn_torch.engineer.optim import adam
    from csmpn_torch.engineer.trainer import Trainer

    model = _model(ds)
    opt = adam(model.parameters(), lr=1e-3)
    lrs = []
    opt.register_step_pre_hook(
        lambda o, a, kw_: lrs.append(o.param_groups[0]["lr"]))
    tr = (trainer_cls or Trainer)(
        scheduler=schedule, max_steps=steps, val_check_interval=10 ** 6,
        print_interval=1, log_interval=10 ** 6,
        logger=ConsoleLogger(dir=str(tmp_path / f"run_{k}_{device_data}")),
        steps_per_dispatch=k, device_data=device_data, **kw)
    tr.fit(model, opt, ds.train_loader(seed=123),
           val_loader=ds.val_loader() if val else None)
    return tr, model, lrs


def _assert_same_params(a, b):
    for (name, pa), (_, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        np.testing.assert_array_equal(pa.detach().numpy(),
                                      pb.detach().numpy(), err_msg=name)


def test_steps_per_dispatch_matches_single_step(ds, tmp_path, capsys):
    """K = 4 against K = 1 under a non-constant cosine schedule (warm-up,
    plateau, decay within 8 steps): the same parameters bit for bit, the
    schedule's lr at every step, and a "(Training) Loss:" line a step."""
    from csmpn_torch.engineer.schedulers import cosine_annealing_schedule

    schedule = cosine_annealing_schedule(1e-3, STEPS, warmup_steps=2,
                                         decay_steps=4)
    t1, m1, lr1 = _train(ds, tmp_path, 1, schedule=schedule)
    t4, m4, lr4 = _train(ds, tmp_path, 4, schedule=schedule)
    _assert_same_params(m1, m4)
    assert lr1 == lr4 == [schedule(s) for s in range(STEPS)]
    assert len(set(lr1)) > 3, lr1              # the schedule moved
    assert t1.step_losses == t4.step_losses
    assert t4.global_step == STEPS and len(t4.step_seconds) == STEPS
    out = capsys.readouterr().out
    for s in range(STEPS):
        assert out.count(f"Step: {s} (Training) Loss:") == 2


@pytest.mark.parametrize("k,want", [(4, [3, 11, 23]), (16, [15, 31])])
def test_val_fires_on_group_boundary_crossings(ds, tmp_path, k, want):
    """val_check_interval 10 over 24 steps: a group picks up each boundary
    it crossed, at its last step; a group of 16 spans several epochs (two
    batches an epoch).  The lists tests/test_train.py pins for the
    reference's trainer."""
    from csmpn_torch.engineer.trainer import Trainer

    calls = []

    class CountingTrainer(Trainer):
        def test_loop(self, loader, validation=False):
            calls.append((self.global_step, validation))
            return {}

    from csmpn_torch.engineer.loggers import ConsoleLogger
    from csmpn_torch.engineer.optim import adam

    model = _model(ds)
    loader = ds.train_loader(seed=5)
    tr = CountingTrainer(max_steps=24, val_check_interval=10,
                         print_interval=100, log_interval=10 ** 9,
                         logger=ConsoleLogger(dir=str(tmp_path)),
                         steps_per_dispatch=k)
    tr.fit(model, adam(model.parameters(), lr=1e-3), loader,
           val_loader=loader)
    assert [s for s, v in calls if v] == want


def test_device_data_matches_host(ds, tmp_path):
    """device_data (the split on the device, batches gathered from shipped
    indices) at K = 3 and K = 1 against the host batches at K = 3: the
    same parameters bit for bit."""
    _, host, _ = _train(ds, tmp_path, 3, steps=6)
    _, dev3, _ = _train(ds, tmp_path, 3, device_data=True, steps=6)
    _, dev1, _ = _train(ds, tmp_path, 1, device_data=True, steps=6)
    _assert_same_params(host, dev3)
    _assert_same_params(host, dev1)


def test_device_data_without_index_iter_raises(ds, tmp_path):
    from csmpn_torch.engineer.loggers import ConsoleLogger
    from csmpn_torch.engineer.optim import adam
    from csmpn_torch.engineer.trainer import Trainer

    model = _model(ds)
    tr = Trainer(max_steps=2, device_data=True,
                 logger=ConsoleLogger(dir=str(tmp_path)))
    with pytest.raises(ValueError, match="index_iter"):
        tr.fit(model, adam(model.parameters()),
               list(ds.train_loader(seed=0)))


@pytest.mark.parametrize("shuffle", [True, False])
def test_index_iter_matches_reference(ds, shuffle):
    """Loader.index_iter yields the reference loader's int32 arrays for the
    same seed, epoch after epoch, and shares the epoch's shuffle with
    __iter__."""
    from csmpn_torch.data.loader import Loader
    from csmpn_tpu.data.loader import Loader as JLoader

    data = ds.val_dataset              # 18 samples: 4, 4, 4, 4, 2
    mine = Loader(data, 4, shuffle=shuffle, seed=7)
    ref = JLoader(data, 4, shuffle=shuffle, seed=7)
    for _ in range(3):
        got, want = list(mine.index_iter()), list(ref.index_iter())
        assert len(got) == len(want) == (4 if shuffle else 5)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    # the next epoch of batches is the next epoch of indices
    again = Loader(data, 4, shuffle=shuffle, seed=7)
    for _ in range(3):
        list(again.index_iter())
    idx = next(mine.index_iter())
    batch = next(iter(again))
    want = data.select(idx)
    for k, v in batch.features.items():
        np.testing.assert_array_equal(v, want.features[k], err_msg=k)


def test_eval_batches_per_dispatch_same_metrics(ds, tmp_path, capsys):
    """Eval read back once every K = 1, 2, 3 batches over 4 + 4 + 4 + 4 + 2
    samples (K = 2 leaves a trailing partial group, K = 3 one of mixed
    shapes): identical metrics."""
    from csmpn_torch.engineer.loggers import ConsoleLogger
    from csmpn_torch.engineer.trainer import Trainer

    model = _model(ds)
    got = {}
    for k in (1, 2, 3):
        tr = Trainer(print_interval=100, eval_batches_per_dispatch=k,
                     logger=ConsoleLogger(dir=str(tmp_path)))
        tr.model, tr.optimizer, tr.device = model, None, torch.device("cpu")
        tr._test_metrics = tr._make_metrics(model)
        got[k] = tr.test_loop(ds.val_loader(), validation=False)
    assert len(ds.val_loader()) == 5
    for k in (2, 3):
        assert got[k].keys() == got[1].keys()
        for key in got[1]:
            if not key.endswith("s_it"):       # wall clock, not a metric
                np.testing.assert_array_equal(got[k][key], got[1][key])
    out = capsys.readouterr().out
    assert "(Testing) Batch: 4 / 5" in out and "Batch: 3 / 5" in out


def test_profile_window_writes_a_trace(ds, tmp_path, capsys):
    prof = tmp_path / "prof"
    _train(ds, tmp_path, 2, steps=6, profile_dir=str(prof),
           profile_steps=(2, 4))
    path = prof / "trace_steps_2_4.json"
    assert path.exists(), os.listdir(prof)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("backward" in str(e.get("name", "")).lower() for e in events)
    out = capsys.readouterr().out
    assert f"Profiler trace started -> {prof}" in out
    assert f"Profiler trace written to {path}" in out


def test_max_rss_gb_stops(ds, tmp_path, capsys):
    tr, _, lrs = _train(ds, tmp_path, 1, max_rss_gb=0.001)
    assert "Stopping due to max_rss_gb" in capsys.readouterr().out
    assert tr.global_step == 0 and lrs == []


def test_trainer_mesh_raises_and_donate_is_ignored(ds, tmp_path):
    """mesh (data parallel, tests/test_torch_data_parallel.py) raises
    unless it is a parallel.mesh.Mesh; donate has no PyTorch meaning and
    either value trains the same."""
    from csmpn_torch.engineer.trainer import Trainer

    with pytest.raises(TypeError, match="make_mesh"):
        Trainer(mesh=object())
    _, kept, _ = _train(ds, tmp_path, 2, steps=4, donate=True)
    _, donated, _ = _train(ds, tmp_path, 2, steps=4, donate=False)
    _assert_same_params(kept, donated)


# ------------------------------------------------ against the reference

def test_trainer_matches_reference_trainer(ds, tmp_path_factory, tmp_path):
    """The port's Trainer and the reference's, both at K = 4 with
    device_data, 8 steps of the motion model from the same weights, loader
    seed and constant lr 1e-3 (Adam): the 8 losses within rtol 2e-4 /
    atol 1e-5.  Parameters: every one within 1e-5, about ten times the
    largest difference read on the CPU (1.04e-6, egcl_0.node_model
    .linear_0.weight, of 2,602 values that the reference moves by up to
    8.1e-3).  Adam moves a parameter by about lr a step whatever its
    gradient's size, so a near-zero gradient whose sign the two
    frameworks' float32 sums disagree on would show as a difference near
    1e-3, a hundred times this bound."""
    from csmpn_tpu.data.motion import MotionDataset as JDataset
    from csmpn_tpu.engineer.loggers import ConsoleLogger as JLogger
    from csmpn_tpu.engineer.optim import adam as jadam
    from csmpn_tpu.engineer.trainer import Trainer as JTrainer
    from csmpn_tpu.models.motion import MotionModel as JModel
    from csmpn_torch.convert import params_from_jax, params_to_jax

    lr = 1e-3
    model = _model(ds)
    params = jax.tree.map(jnp.asarray, params_to_jax(model.state_dict()))
    tr, model, _ = _train(ds, tmp_path, 4, device_data=True)

    jds = _in_dataroot(str(tmp_path_factory.mktemp("dataroot_jax")),
                       lambda: JDataset(**DS_KW))
    losses = []

    class RecordingTrainer(JTrainer):
        def _build_steps(self, m, optimizer):
            super()._build_steps(m, optimizer)
            fn = self._multi_step_idx_fn

            def record(*args):
                out = fn(*args)
                losses.extend(np.asarray(out[2]).tolist())
                return out

            self._multi_step_idx_fn = record

    jtr = RecordingTrainer(max_steps=STEPS, val_check_interval=10 ** 6,
                           print_interval=10 ** 6, log_interval=10 ** 6,
                           logger=JLogger(dir=str(tmp_path / "jax_run")),
                           steps_per_dispatch=4,
                           device_data=True, donate=False)
    jparams = jtr.fit(JModel(spec=jds.spec, num_hidden=4, num_layers=1),
                      params, jadam(lr=lr), jds.train_loader(seed=123))
    assert len(losses) == len(tr.step_losses) == STEPS
    np.testing.assert_allclose(tr.step_losses, losses, rtol=2e-4,
                               atol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


# ------------------------------------------------ the pieces around them

def test_set_lr_writes_tensor_lr_in_place():
    """set_lr fills a tensor lr in place (the object a CUDA graph of the
    step reads stays the same) and assigns a float lr."""
    from csmpn_torch.engineer.schedulers import set_lr

    w = torch.zeros(3, requires_grad=True)
    lr_t = torch.tensor(1e-3)
    opt_t = torch.optim.Adam([w], lr=lr_t)
    opt_f = torch.optim.Adam([w], lr=1e-3)
    set_lr(opt_t, 2.5e-4)
    set_lr(opt_f, 2.5e-4)
    assert opt_t.param_groups[0]["lr"] is lr_t
    assert float(lr_t) == float(torch.tensor(2.5e-4))
    assert opt_f.param_groups[0]["lr"] == 2.5e-4


def test_graph_mode_needs_a_capturable_optimizer(ds):
    """Graphs replay the step only for a CUDA model at K > 1, and then the
    optimizer must be capturable with a tensor lr that set_lr writes in
    place."""
    from csmpn_torch.engineer.optim import adam
    from csmpn_torch.engineer.trainer import Trainer

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert Trainer(steps_per_dispatch=4).uses_graphs(cuda)
    assert not Trainer(steps_per_dispatch=4).uses_graphs(cpu)
    assert not Trainer(steps_per_dispatch=1).uses_graphs(cuda)
    model = _model(ds)
    with pytest.raises(ValueError, match="capturable"):
        Trainer._check_graph_optimizer(adam(model.parameters(), lr=1e-3))


def test_chip_smoke_counts_replays_by_kernel_name():
    """chip_smoke counts launches by kernel name, from a captured graph's
    kernel nodes (the exact count under replay) or a profile's kernel runs
    (read beside it): each counter is the kernels its wrapper launches
    once a call (K2 and K3 in both modes, dense and pair form and the wide
    kernels apart), and not the helper launches beside them (the parameter
    image's pack, the partials' reduce); a node's mangled symbol reads as
    the profile's name does."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    ns = "(anonymous namespace)::"
    runs = {f"void {ns}segment_sum_kernel<__nv_bfloat16, false, 8, 0>()": 13,
            f"void {ns}segment_sum_kernel<float, false, 4, 0>()": 1,
            f"void {ns}cemlp_fwd_tile_kernel<{ns}A3, false>()": 18,
            f"void {ns}cemlp_fwd_kernel<{ns}A3>()": 1,
            f"void {ns}pack_tparams_kernel<{ns}A3>()": 18,
            f"void {ns}cemlp_bwd_tile_kernel<{ns}A3, 16>()": 19,
            f"{ns}reduce_partials_kernel(float const*, float*, long)": 34,
            f"void {ns}cemlp_pair_fwd_tile_kernel<{ns}A5>()": 15,
            f"void {ns}cemlp_pair_bwd_tile_kernel<{ns}A5, 16>()": 14,
            f"void {ns}cemlp_pair_bwd_kernel<{ns}A5, {ns}K>()": 1,
            "void at::native::vectorized_gather_kernel<16, long>()": 19}
    assert cs.launches_of(runs, ["k1", "k2", "k3", "k2p", "k3p"]) == {
        "k1": 14, "k2": 19, "k3": 19, "k2p": 15, "k3p": 15}
    anon = "_ZN12_GLOBAL__N_1"
    nodes = [f"{anon}18segment_sum_kernelIfLb1ELi4ELi2EEEvPKT_",
             f"{anon}21cemlp_fwd_tile_kernelINS_3Cl3ELb0EEEvPKf",
             f"{anon}21cemlp_wide_fwd_kernelINS_3Cl3ELb1EEEvPKf",
             f"{anon}21cemlp_wide_bwd_kernelINS_3Cl3ELb1EEEvPKf",
             f"{anon}23cemlp_wide_wgrad_kernelINS_3Cl3ELb1EEEvPKf",
             f"{anon}22reduce_partials_kernelEPKfPfli",
             "_ZN2at6native29vectorized_elementwise_kernelILi4EEEvi"]
    names = collections.Counter(cs.demangled(n) for n in nodes)
    assert cs.demangled(nodes[-2]) == "reduce_partials_kernel"
    assert cs.launches_of(names, ["k1", "k2", "k3", "k2w", "k3w"]) == {
        "k1": 1, "k2": 1, "k3": 0, "k2w": 1, "k3w": 1}


def test_sequence_flags_parse(ds):
    """--trainer.profile_steps=[8,12] reaches the trainer as (8, 12)."""
    from csmpn_torch.engineer.config import _coerce

    assert _coerce("[8,12]", (8, 12), "profile_steps") == (8, 12)
    with pytest.raises(ValueError, match="sequence"):
        _coerce("8", (8, 12), "profile_steps")


def test_motion_task_cli_with_knobs_on_cpu(tmp_path):
    """The motion entry point with the reference's knobs (the form of its
    long runs, at a small size): a "(Training) Loss:" line for each of 8
    steps in groups of 4, validation and test read back two batches at a
    time, the profile window's trace, the stop."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, DATAROOT=str(tmp_path),
               RUNDIR=str(tmp_path / "runs"))
    cmd = [sys.executable, "-m", "csmpn_torch.tasks.motion",
           "--trainer.module=csmpn_torch.engineer.Trainer",
           "--trainer.max_steps=8", "--trainer.val_check_interval=3",
           "--trainer.print_interval=1", "--trainer.limit_val_batches=2",
           "--trainer.steps_per_dispatch=4", "--trainer.device_data=True",
           "--trainer.eval_batches_per_dispatch=2",
           f"--trainer.profile_dir={tmp_path / 'prof'}",
           "--trainer.profile_steps=[4,8]",
           "--optimizer.module=csmpn_torch.engineer.optim.adam",
           "--dataset.module=csmpn_torch.data.motion.MotionDataset",
           "--dataset.num_training_samples=11", "--dataset.batch_size=4",
           "--dataset.num_eval_samples=18",
           "--model.module=csmpn_torch.models.motion.MotionModel",
           "--model.num_hidden=4", "--model.num_layers=1", "--device=cpu"]
    proc = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    out = proc.stdout
    for step in range(8):
        assert f"Step: {step} (Training) Loss:" in out
    for step in (3, 7):
        assert f"Step: {step} (Validation) Batch: 2 / 2" in out
    assert "test/loss" in out and "Stopping due to max_steps." in out
    assert os.path.exists(tmp_path / "prof" / "trace_steps_4_8.json")
