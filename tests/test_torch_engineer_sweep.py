"""The rest of csmpn_torch's engineer stack and its last ops against the
reference package (csmpn_tpu) on the CPU:

  * the sweep runner: the port's sweep files expand to the reference's
    commands with only the package name changed, every module they name
    loads from csmpn_torch, a local sweep over a tiny grid, the SLURM
    jobfile, the wandb flow with a fake wandb module and a fake git runner,
    the clear error without wandb, and the last value of a repeated flag;
  * LorentzMetric and the hand-written roc_curve against sklearn and the
    reference's LorentzMetric, with ties, and under two gloo ranks against
    the single-process value over the rank-major concatenation;
  * cosine_cyclic_schedule, WANDBLogger (a fake wandb module),
    discover_tests, the squeue fallback of max_time;
  * sort_edges_by_target and knn_graph;
  * the motion, MD17 and NBA loaders on files in the reference's real
    formats (as tests/test_real_data_formats.py writes them), byte for byte
    against the reference's datasets built from the same files;
  * no module of csmpn_torch imports sklearn, and wandb only inside the
    functions that need it.

Tolerances: the metrics to 1e-12 (both sides compute in float64 numpy);
the schedule to 1e-5 of the base rate, because the reference computes in
float32 and its angle 2 pi step / cycle (up to 126 here) carries an error
of up to 2^-24 of itself; everything else exact.
"""
import ast
import os
import pickle
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("motion", "hulls", "md17", "nba")
SWEEP_FILES = TASKS + ("engineer/trainer", "optimizer/adam",
                       "optimizer/adamw")


def _yaml(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return yaml.safe_load(f)


# ------------------------------------------------------------ the sweep files

@pytest.mark.parametrize("name", SWEEP_FILES)
def test_port_sweep_file_is_shared_file_renamed(name):
    """Each port sweep file is the shared file's content with csmpn_tpu
    replaced by csmpn_torch, nothing else."""
    with open(os.path.join(REPO, "configs", f"{name}.yaml")) as f:
        shared = f.read()
    with open(os.path.join(REPO, "csmpn_torch", "configs",
                           f"{name}.yaml")) as f:
        port = f.read()
    assert port == shared.replace("csmpn_tpu", "csmpn_torch")


@pytest.mark.parametrize("task", TASKS)
def test_build_commands_match_reference(task):
    from csmpn_tpu.engineer.sweep import build_commands as jbuild
    from csmpn_torch.engineer.config import load_module
    from csmpn_torch.engineer.sweep import build_commands

    extra = ["--trainer.max_steps=8", "--device=cpu"]
    want = [c.replace("csmpn_tpu", "csmpn_torch")
            for c in jbuild(_yaml("configs", f"{task}.yaml"), extra)]
    cfg = _yaml("csmpn_torch", "configs", f"{task}.yaml")
    got = build_commands(cfg, extra)
    assert got == want and len(got) >= 1
    assert all(f"python -u -m csmpn_torch.tasks.{task} " in c for c in got)
    mods = [a.split("=", 1)[1] for a in cfg["command"]
            if isinstance(a, str) and a.startswith("--")
            and a.split("=", 1)[0].endswith(".module")]
    assert len(mods) == 4
    for m in mods:
        assert m.startswith("csmpn_torch.")
        assert callable(load_module(m))


@pytest.mark.parametrize("name", ("engineer/trainer", "optimizer/adam",
                                  "optimizer/adamw"))
def test_sweep_layer_modules_load(name):
    from csmpn_torch.engineer.config import load_module

    for section in _yaml("csmpn_torch", "configs", f"{name}.yaml").values():
        assert callable(load_module(section["module"]))


def test_program_invocation_maps_the_port_package():
    from csmpn_torch.engineer.sweep import build_commands

    cfg = {"program": "csmpn_torch/tasks/md17.py",
           "command": ["${env}", "${interpreter}", "${program}", "${args}"],
           "parameters": {}}
    (cmd,) = build_commands(cfg, [])
    assert cmd == "/usr/bin/env python -u -m csmpn_torch.tasks.md17"
    cfg["program"] = "csmpn_tpu/tasks/md17.py"     # another package
    (cmd,) = build_commands(cfg, [])
    assert cmd.endswith(" csmpn_tpu/tasks/md17.py") and " -m " not in cmd


def _grid_cfg(tmp_path, program):
    cfg = {"program": program,
           "command": ["${env}", "${interpreter}", "${program}",
                       "--fixed=1", "${args}"],
           "parameters": {"a": {"values": [1, 2]}, "b": {"values": ["x"]}}}
    p = tmp_path / "sweep.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return p


def test_sweep_local_runs_each_command_and_stops_on_failure(tmp_path,
                                                            capsys):
    from csmpn_torch.engineer.sweep import sweep_local

    script = tmp_path / "prog.py"
    log = tmp_path / "log.txt"
    script.write_text(
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "sys.exit(3 if '--a=2' in sys.argv and '--fail=1' in sys.argv "
        "else 0)\n")
    cfg = _grid_cfg(tmp_path, str(script))
    assert sweep_local(str(cfg), ["--extra=y"], dry_run=True) == 0
    assert not log.exists()
    assert sweep_local(str(cfg), ["--extra=y"]) == 0
    assert log.read_text().splitlines() == [
        "--fixed=1 --a=1 --b=x --extra=y", "--fixed=1 --a=2 --b=x --extra=y"]
    log.unlink()
    assert sweep_local(str(cfg), ["--fail=1"]) == 3
    assert len(log.read_text().splitlines()) == 2
    assert "Running:" in capsys.readouterr().out


def test_sweep_main_cli_dry_run(tmp_path):
    cfg = tmp_path / "m.yaml"
    cfg.write_text(open(os.path.join(
        REPO, "csmpn_torch", "configs", "motion.yaml")).read())
    proc = subprocess.run(
        [sys.executable, "-m", "csmpn_torch.engineer.sweep", str(cfg),
         "--dry_run", "--trainer.max_steps=2"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert ("Running: /usr/bin/env python -u -m csmpn_torch.tasks.motion"
            in proc.stdout)
    assert proc.stdout.rstrip().endswith("--trainer.max_steps=2")


def test_write_slurm_jobfile(tmp_path):
    from csmpn_torch.engineer.sweep import write_slurm_jobfile

    cfg = _grid_cfg(tmp_path, "csmpn_torch/tasks/hulls.py")
    out = tmp_path / "job.sh"
    write_slurm_jobfile(str(cfg), str(out), partition="p", time="1:00:00",
                        extra_args=["--e=1"])
    text = out.read_text()
    assert "#SBATCH --array=0-1" in text
    assert "#SBATCH --partition=p" in text and "#SBATCH --time=1:00:00" in text
    assert ("  0) /usr/bin/env python -u -m csmpn_torch.tasks.hulls "
            "--fixed=1 --a=1 --b=x --e=1 ;;") in text
    assert "  1) " in text and text.rstrip().endswith("esac")


class FakeWandb:
    calls = []

    @staticmethod
    def sweep(sweep, project=None, entity=None):
        FakeWandb.calls.append((project, entity, sweep["parameters"]))
        return "swp42"


def test_sweep_wandb_with_fake_wandb_and_git(tmp_path):
    from csmpn_torch.engineer.sweep import sweep_wandb

    git = []

    def fake_git(cmd):
        git.append(cmd)
        if cmd == "git status":
            return "On branch main"
        if cmd.startswith("git rev-list"):
            return "0\t2"
        return ""

    cfg = _grid_cfg(tmp_path, "csmpn_torch/tasks/hulls.py")
    job = tmp_path / "agent.sh"
    FakeWandb.calls.clear()
    sid = sweep_wandb(str(cfg), wandb_module=FakeWandb, run_git=fake_git,
                      jobfile=str(job))
    assert sid == "swp42"
    assert FakeWandb.calls == [("csmpn_torch", None,
                                {"a": {"values": [1, 2]},
                                 "b": {"values": ["x"]}})]
    text = job.read_text()
    assert "#SBATCH --array=1-2" in text and "git checkout swp42" in text
    assert "wandb agent ${WANDB_ENTITY}/csmpn_torch/swp42" in text
    assert "git commit --allow-empty -m swp42" in git
    assert "git tag swp42" in git and "git push" not in git


def test_sweep_wandb_refuses_detached_head(tmp_path):
    from csmpn_torch.engineer.sweep import sweep_wandb

    def fake_git(cmd):
        return "HEAD detached at 1234abc" if "status" in cmd else ""

    with pytest.raises(RuntimeError, match="detached"):
        sweep_wandb(str(_grid_cfg(tmp_path, "x.py")),
                    wandb_module=FakeWandb, run_git=fake_git)


@pytest.mark.parametrize("out,want", [("1\t0", "behind"), ("0\t1", "ahead"),
                                      ("2\t3", "diverged"),
                                      ("0\t0", "up-to-date"),
                                      ("fatal: no upstream", "no-upstream")])
def test_git_sync_status(out, want):
    from csmpn_torch.engineer.sweep import git_sync_status

    assert git_sync_status(lambda c: out if "rev-list" in c else "") == want


def test_register_wandb_sweep_clear_error_without_wandb(monkeypatch):
    from csmpn_torch.engineer.sweep import register_wandb_sweep

    monkeypatch.setitem(sys.modules, "wandb", None)    # import fails
    with pytest.raises(RuntimeError, match="not installed"):
        register_wandb_sweep({"parameters": {}})


def test_last_value_of_a_repeated_flag_wins():
    """The sweep appends the extra arguments after the file's: the
    parser keeps the last value of a flag given twice."""
    from csmpn_torch.engineer.config import parse_args

    cfg, _, _ = parse_args([
        "prog", "--trainer.module=csmpn_torch.engineer.Trainer",
        "--trainer.max_steps=10000", "--trainer.val_check_interval=128",
        "--trainer.max_steps=8", "--trainer.val_check_interval=4"])
    assert cfg["trainer"]["max_steps"] == 8
    assert cfg["trainer"]["val_check_interval"] == 4


# ------------------------------------------------------------------ metrics

def _scores(n, seed, ties):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, n)
    preds = np.clip(target * 0.3 + rng.rand(n) * 0.7, 0, 1)
    if ties == "rounded":
        preds = np.round(preds, 1)
    elif ties == "equal":
        preds = np.full(n, 0.5)
    return preds, target


@pytest.mark.parametrize("ties", ["none", "rounded", "equal"])
@pytest.mark.parametrize("n", [2, 7, 300])
def test_roc_curve_matches_sklearn(ties, n):
    from sklearn.metrics import roc_curve as sk_roc
    from csmpn_torch.engineer.metrics import roc_curve

    preds, target = _scores(n, n, ties)
    target[:2] = [0, 1]
    for drop in (True, False):
        want = sk_roc(target, preds, drop_intermediate=drop)
        got = roc_curve(target, preds, drop_intermediate=drop)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_roc_curve_one_class_is_nan():
    import warnings

    from sklearn.metrics import roc_curve as sk_roc
    from csmpn_torch.engineer.metrics import roc_curve

    preds = np.array([0.1, 0.4, 0.4, 0.9])
    for target in (np.zeros(4, int), np.ones(4, int)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = sk_roc(target, preds)
        for g, w in zip(roc_curve(target, preds), want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ties", ["none", "rounded", "equal"])
def test_lorentz_metric_matches_reference_and_sklearn(ties):
    from sklearn.metrics import roc_auc_score
    from csmpn_tpu.engineer.metrics import LorentzMetric as JLorentz
    from csmpn_torch.engineer.metrics import LorentzMetric

    preds, target = _scores(200, 4, ties)
    got, ref = LorentzMetric(), JLorentz()
    for m in (got, ref):
        m.update((preds[:120], target[:120]))
        m.update((preds[120:], target[120:]))
    g, r = got.compute(), ref.compute()
    assert set(g) == {"auc", "eB_0.3", "eB_0.5"}
    for k in r:
        np.testing.assert_allclose(g[k], r[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    np.testing.assert_allclose(g["auc"], roc_auc_score(target, preds),
                               rtol=1e-12)


def test_lorentz_metric_one_class_raises_as_sklearn():
    from csmpn_torch.engineer.metrics import LorentzMetric

    m = LorentzMetric()
    m.update((np.array([0.2, 0.7]), np.array([1, 1])))
    with pytest.raises(ValueError, match="Only one class"):
        m.compute()


def test_binary_auroc_shares_the_roc_core():
    from csmpn_tpu.engineer.metrics import BinaryAUROC as JAUROC
    from csmpn_torch.engineer.metrics import BinaryAUROC

    for ties in ("none", "rounded", "equal"):
        preds, target = _scores(50, 9, ties)
        a, b = BinaryAUROC(), JAUROC()
        a.update((preds, target))
        b.update((preds, target))
        assert a.compute() == b.compute()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_lorentz_metric_two_gloo_ranks(tmp_path):
    """Two ranks hold different lengths; each computes the metric over the
    rank-major concatenation, as one process does over it."""
    from csmpn_torch.engineer.metrics import LorentzMetric

    preds, target = _scores(90, 5, "rounded")
    cut = 37
    np.savez(tmp_path / "d.npz", preds=preds, target=target)
    code = (
        "import sys, json, numpy as np, torch.distributed as dist\n"
        "from csmpn_torch.engineer.metrics import LorentzMetric\n"
        "rank = int(sys.argv[1])\n"
        f"dist.init_process_group('gloo', init_method='tcp://127.0.0.1:"
        f"{_free_port()}', rank=rank, world_size=2)\n"
        f"d = np.load({str(tmp_path / 'd.npz')!r})\n"
        f"sl = slice(0, {cut}) if rank == 0 else slice({cut}, None)\n"
        "m = LorentzMetric()\n"
        "m.update((d['preds'][sl], d['target'][sl]))\n"
        "out = {k: float(v) for k, v in m.compute().items()}\n"
        "dist.destroy_process_group()\n"
        "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=REPO)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    single = LorentzMetric()
    single.update((preds, target))
    want = single.compute()
    import json
    for o, _ in outs:
        got = json.loads(o.strip().splitlines()[-1])
        assert got == {k: float(v) for k, v in want.items()}


# ---------------------------------------------------------------- schedules

def test_cosine_cyclic_schedule_matches_reference():
    from csmpn_tpu.engineer.schedulers import cosine_cyclic_schedule as jcyc
    from csmpn_torch.engineer.schedulers import cosine_cyclic_schedule

    for base, cycle, lr_min in ((1.0, 10, 1e-7), (5e-4, 64, 1e-6)):
        got = cosine_cyclic_schedule(base, max_steps=200, cycle_steps=cycle,
                                     lr_min=lr_min)
        want = jcyc(base, max_steps=200, cycle_steps=cycle, lr_min=lr_min)
        for step in range(201):
            g = got(step)
            assert isinstance(g, float)
            np.testing.assert_allclose(g, float(want(step)), rtol=0,
                                       atol=1e-5 * base, err_msg=str(step))
    s = cosine_cyclic_schedule(1.0, max_steps=100, cycle_steps=10)
    assert s(0) == pytest.approx(1e-7) and s(5) == pytest.approx(1.0)


# ------------------------------------------------------------------ loggers

def test_wandb_logger_with_fake_wandb(monkeypatch, tmp_path):
    from csmpn_torch.engineer.loggers import WANDBLogger

    calls = []

    class Run:
        id = "r1"
        dir = str(tmp_path)

    class Artifact:
        def __init__(self, name, type):
            calls.append(("artifact", name, type))

        def add_file(self, f):
            calls.append(("add_file", f))

    fake = types.SimpleNamespace(run=None, Artifact=Artifact)

    def init(project=None, entity=None, name=None):
        calls.append(("init", project, entity, name))
        fake.run = Run()

    fake.init = init
    fake.define_metric = lambda m, summary: calls.append(("define", m,
                                                          summary))
    fake.log = lambda metrics, step: calls.append(("log", metrics, step))
    fake.log_artifact = lambda a, aliases: calls.append(("log_artifact",
                                                         aliases))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    lg = WANDBLogger(project="p", entity="e", run_name="n")
    assert lg.initialized and lg.dir == str(tmp_path)
    lg.log_metrics({"train/loss": 1.0}, step=3)
    lg.log_metrics({"train/loss": 0.5, "val/loss": 2.0}, step=4)
    lg.save_model("ckpt.pt", alias="best")
    assert calls == [
        ("init", "p", "e", "n"),
        ("define", "train/loss", "max,min,last"),
        ("log", {"train/loss": 1.0}, 3),
        ("define", "val/loss", "max,min,last"),
        ("log", {"train/loss": 0.5, "val/loss": 2.0}, 4),
        ("artifact", "r1-model", "model"), ("add_file", "ckpt.pt"),
        ("log_artifact", ["best"])]
    fake.run = None                        # the run ended: nothing logged
    lg.log_metrics({"x": 1.0}, step=5)
    assert len(calls) == 8


# ----------------------------------------------------------- discover_tests

def test_discover_tests_counts_failures(tmp_path, capsys):
    from csmpn_torch.engineer.discover_tests import discover_and_run

    (tmp_path / "mod_ok.py").write_text("def test():\n    assert True\n")
    (tmp_path / "mod_bad.py").write_text(
        "def test():\n    raise RuntimeError('boom')\n")
    (tmp_path / "mod_plain.py").write_text("x = 1\n")
    assert discover_and_run(str(tmp_path)) == 1
    out = capsys.readouterr().out
    assert "PASS" in out and "FAIL" in out and "boom" in out
    proc = subprocess.run([sys.executable, "-m",
                           "csmpn_torch.engineer.discover_tests",
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1


# ----------------------------------------------------- the squeue fallback

@pytest.mark.parametrize("limit", ["1-02:03:04", "45:00", "7", "12:00:00"])
def test_squeue_fallback_matches_reference(limit, tmp_path, monkeypatch):
    from csmpn_tpu.engineer.trainer import _parse_max_time as jparse
    from csmpn_torch.engineer.trainer import Trainer, _parse_max_time

    squeue = tmp_path / "squeue"
    squeue.write_text(f"#!/bin/sh\necho ' {limit} '\n")
    squeue.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setenv("SLURM_JOB_ID", "123")
    got = _parse_max_time(None)
    assert got is not None and got == jparse(None)
    assert Trainer().max_time == got
    assert _parse_max_time("00:00:05").total_seconds() == 5


def test_squeue_fallback_none_without_job_or_squeue(tmp_path, monkeypatch):
    from csmpn_torch.engineer.trainer import _parse_max_time

    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    assert _parse_max_time(None) is None
    monkeypatch.setenv("SLURM_JOB_ID", "123")
    monkeypatch.setenv("PATH", str(tmp_path))          # no squeue here
    assert _parse_max_time(None) is None


# --------------------------------------------------------------------- ops

def test_sort_edges_by_target_byte_identical():
    from csmpn_tpu.ops.segment import sort_edges_by_target as jsort
    from csmpn_torch.ops import sort_edges_by_target

    rng = np.random.RandomState(0)
    ei = rng.randint(0, 9, (2, 40)).astype(np.int32)
    attr = rng.randn(40, 3, 8).astype(np.float32)
    mask = rng.rand(40) > 0.5
    assert sort_edges_by_target(ei).tobytes() == np.asarray(
        jsort(ei)).tobytes()
    got, want = sort_edges_by_target(ei, attr, mask), jsort(ei, attr, mask)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n,k,exclude_self", [(12, 3, True), (12, 11, True),
                                              (12, 50, True), (9, 4, False),
                                              (9, 20, False)])
def test_knn_graph_matches_reference(n, k, exclude_self):
    import jax.numpy as jnp
    from csmpn_tpu.ops.segment import knn_graph as jknn
    from csmpn_torch.ops import knn_graph

    pos = np.random.RandomState(n + k).randn(n, 3).astype(np.float32)
    want = np.asarray(jknn(jnp.asarray(pos), k, exclude_self))
    got = knn_graph(torch.from_numpy(pos), k, exclude_self)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------ loaders on the real formats

def _write_motion(root):
    d = os.path.join(root, "motion")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(0)
    edges = [(i, i + 1) for i in range(30)] + [(6, 8), (1, 3)]
    X = [rng.randn(331, 31, 3).astype(np.float64) for _ in range(23)]
    with open(os.path.join(d, "motion.pkl"), "wb") as f:
        pickle.dump((edges, X), f)


def _write_md17(root, mol="ethanol"):
    d = os.path.join(root, "md17")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(1)
    z = np.array([6, 1, 1, 8, 1, 1, 6, 1, 1])
    base = rng.randn(len(z), 3)
    t = np.arange(4001)[:, None, None]
    R = base[None] + 0.05 * np.sin(0.01 * t + rng.rand(len(z), 3))
    np.savez(os.path.join(d, f"md17_{mol}.npz"), R=R, z=z)


def _write_nba(root, seqs=10):
    d = os.path.join(root, "nba")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(2)
    data = rng.rand(seqs, 50, 11, 4).astype(np.float32)
    data[..., 0] = 45.0 + data[..., 0] * 45.0
    np.save(os.path.join(d, "all_data.npy"), data)


REAL = {  # task -> (writer, dataset class path, kwargs, data subdirectory)
    "motion": (_write_motion, "motion.MotionDataset",
               dict(batch_size=4, num_training_samples=22,
                    num_eval_samples=12), "motion"),
    "md17": (_write_md17, "md17.MD17Dataset",
             dict(batch_size=2, molecule_type="ethanol",
                  num_train_samples=8, num_eval_samples=4, dis=10000.0),
             "md17"),
    "nba": (_write_nba, "nba.NBADataset", dict(batch_size=2, mode="atk"),
            "nba"),
}
SPLITS = ("train_dataset", "val_dataset", "test_dataset")


def _arrays(ds):
    out = {}
    for s in SPLITS:
        a = getattr(ds, s).arrays
        for k in ("edge_index", "edge_mask", "edge_src_order", "node_mask",
                  "node_types", "x_ind"):
            out[f"{s}.{k}"] = getattr(a, k)
        out.update({f"{s}.feat_{k}": v for k, v in a.features.items()})
        out.update({f"{s}.tgt_{k}": v for k, v in a.targets.items()})
    return out


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("task", sorted(REAL))
def test_loader_on_real_format_byte_identical(task, tmp_path, monkeypatch):
    """Each package builds its dataset from the same real-format file in
    its own DATAROOT: every array and every file it writes are equal byte
    for byte, and the file was read (no stand-in data generated)."""
    import importlib

    write, cls, kw, sub = REAL[task]
    mod, name = cls.rsplit(".", 1)
    out = {}
    for pkg in ("csmpn_tpu", "csmpn_torch"):
        root = str(tmp_path / pkg)
        write(root)
        monkeypatch.setenv("DATAROOT", root)
        ds = getattr(importlib.import_module(f"{pkg}.data.{mod}"), name)(**kw)
        out[pkg] = (ds, _files(os.path.join(root, sub)))
    (jds, jfiles), (tds, tfiles) = out["csmpn_tpu"], out["csmpn_torch"]
    assert "SYNTHETIC" not in tfiles and "SYNTHETIC" not in jfiles
    ja, ta = _arrays(jds), _arrays(tds)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert ja[k].dtype == ta[k].dtype, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    assert (jds.spec.counts_max, jds.spec.e_max) == (
        tds.spec.counts_max, tds.spec.e_max)
    assert getattr(jds, "model_kwargs", None) == getattr(
        tds, "model_kwargs", None)
    assert jfiles.keys() == tfiles.keys()
    for f in jfiles:
        assert jfiles[f] == tfiles[f], f
    batch = next(iter(tds.train_loader()))
    assert batch.batch_size == kw["batch_size"]


# ----------------------------------------------------------------- imports

def test_no_sklearn_and_wandb_only_inside_functions():
    """No module of csmpn_torch imports sklearn (nor jax or csmpn_tpu), and
    wandb is imported only inside WANDBLogger.__init__ and
    register_wandb_sweep, never at module level."""
    pkg = os.path.join(REPO, "csmpn_torch")
    wandb_sites = []
    for dirpath, _, names in os.walk(pkg):
        for name in names:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read(), path)
            parents = {}
            for node in ast.walk(tree):
                for child in ast.iter_child_nodes(node):
                    parents[child] = node
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                tops = {m.split(".")[0] for m in mods}
                assert not tops & {"sklearn", "jax", "csmpn_tpu"}, \
                    (path, node.lineno)
                if "wandb" in tops:
                    fn = node
                    while fn in parents and not isinstance(
                            fn, ast.FunctionDef):
                        fn = parents[fn]
                    assert isinstance(fn, ast.FunctionDef), path
                    wandb_sites.append((os.path.relpath(path, REPO),
                                        fn.name))
    assert sorted(wandb_sites) == [
        ("csmpn_torch/engineer/loggers.py", "__init__"),
        ("csmpn_torch/engineer/sweep.py", "register_wandb_sweep")]
    code = ("import importlib, pkgutil, sys\n"
            "import csmpn_torch\n"
            "for m in pkgutil.walk_packages(csmpn_torch.__path__, "
            "'csmpn_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'wandb', 'jax', 'csmpn_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
