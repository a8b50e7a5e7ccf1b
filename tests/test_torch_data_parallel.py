"""The port's data-parallel path on the CPU: two real processes per launch,
joined in a ``gloo`` process group on localhost.

* the bootstrap (``engineer.fire``): rank, world and local rank from
  torchrun's and SLURM's variables, and a rendezvous in each style;
* the loaders' rank shards against the reference's ``Loader(shard=)``,
  byte for byte;
* the metrics against the reference's classes, and under two ranks
  holding different values against the single-process value over the
  rank-major concatenation;
* two ranks training the motion model (hidden 4, one layer, batch 2 a
  rank, 3 steps, exact): bitwise equal parameters on both ranks, within
  the reference's parity tolerance (rtol 2e-4 / atol 1e-5) of the JAX
  model stepped in one process with ``jax.value_and_grad`` and the
  reference's Adam on each global batch (rank 0's local batch, then rank
  1's); ``max_steps`` stops both ranks at the same step;
* rank-0 checkpoints: rank 0 alone writes, slowly; the other rank waits at
  the barrier and then finds whole files; a restore on both ranks;
* the motion entry point under two processes, and its refusal of
  ``--data_parallel=true`` in one process that sees two cards;
* two ranks building the kernels at once (a stand-in ``nvcc``): both
  finish and each finds the whole library.

Each launch passes ``communicate(timeout=120)`` and kills both processes
on a timeout.  Its rendezvous port lies below the kernel's ephemeral range
in a run of ports of the launching pytest-xdist worker's own
(``_free_port``), and a launch whose rank 0 finds the address taken is
made again on the next port."""
import itertools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 1e-5
DS_KW = dict(batch_size=2, num_training_samples=11, num_eval_samples=6)
LOADER_SEED = 5
STEPS = 3


# A port bound to 0 and released (as this file's launches once took them)
# can be handed to another process before rank 0 binds it: a bind to port 0
# or a connection's local end in another pytest-xdist worker's test (the
# gloo groups of tests/test_torch_sharded.py and others).  Rank 0 then
# fails with EADDRINUSE and rank 1 waits on a store that is not its own.
# The kernel hands out such ports from its ephemeral range (32768-60999 by
# default, /proc/sys/net/ipv4/ip_local_port_range), so this file's ports
# come from below it, a run of PORTS_PER_WORKER for each worker, each port
# used once by its worker.
PORT_BASE, PORTS_PER_WORKER = 20000, 400
ADDR_TAKEN = "EADDRINUSE"
LAUNCH_ATTEMPTS = 3
_ports = itertools.count()


def _free_port() -> int:
    """A port no other test of this run takes: the next of this worker's
    run that binds now."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "gw0")[2:]
    base = PORT_BASE + PORTS_PER_WORKER * (int(worker) if worker.isdigit()
                                           else 0)
    for _ in range(PORTS_PER_WORKER):
        port = base + next(_ports) % PORTS_PER_WORKER
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    raise RuntimeError(f"no free port in {base}-{base + PORTS_PER_WORKER}")


def _launch(argv_fn, env_fn, timeout=120):
    """Two processes (rank 0 and 1) of ``argv_fn(rank)`` with the
    environment ``env_fn(rank, port)``; returns [(returncode, output)].
    Where rank 0 fails because its address is taken, the launch is made
    again on another port (at most LAUNCH_ATTEMPTS launches)."""
    for attempt in range(LAUNCH_ATTEMPTS):
        port = _free_port()
        procs = []
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if not k.startswith(
                ("SLURM", "TORCHELASTIC", "MASTER_", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"))}
            env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO,
                       **env_fn(rank, port))
            procs.append(subprocess.Popen(
                argv_fn(rank), cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append((p.returncode, out))
                if p is procs[0] and p.returncode != 0 and ADDR_TAKEN in out:
                    break   # rank 1 waits on a store that is not its own
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        taken = outs[0][0] != 0 and ADDR_TAKEN in outs[0][1]
        if not taken or attempt == LAUNCH_ATTEMPTS - 1:
            for p in procs[len(outs):]:
                outs.append((p.returncode, p.communicate()[0]))
            return outs


def torchrun_env(rank, port):
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": str(rank)}


def slurm_env(rank, port):
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "SLURM_NTASKS": "2", "SLURM_PROCID": str(rank),
            "SLURM_LOCALID": str(rank)}


# ------------------------------------------------------------ the bootstrap

@pytest.mark.parametrize("style,env,want", [
    ("torchrun", {"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
                  "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     {"rank": 3, "world_size": 4, "local_rank": 1}),
    ("torchelastic", {"TORCHELASTIC_RUN_ID": "x", "WORLD_SIZE": "2",
                      "RANK": "0", "LOCAL_RANK": "0"},
     {"rank": 0, "world_size": 2, "local_rank": 0}),
    ("slurm", {"SLURM_NTASKS": "8", "SLURM_PROCID": "5",
               "SLURM_LOCALID": "1"},
     {"rank": 5, "world_size": 8, "local_rank": 1}),
    ("explicit over slurm", {"SLURM_NTASKS": "8", "SLURM_PROCID": "5",
                             "SLURM_LOCALID": "1", "WORLD_SIZE": "2",
                             "RANK": "1", "LOCAL_RANK": "0",
                             "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     {"rank": 1, "world_size": 2, "local_rank": 0}),
])
def test_bootstrap_resolves_ranks(style, env, want):
    from csmpn_torch.engineer.fire import resolve_ranks, use_distributed

    assert use_distributed(env), style
    assert resolve_ranks(env) == want


@pytest.mark.parametrize("env", [
    {}, {"SLURM_NTASKS": "1", "SLURM_PROCID": "0"},
    {"WORLD_SIZE": "2", "RANK": "0"},          # no rendezvous address
    {"SLURM_NTASKS": "x"}])
def test_bootstrap_single_process(env):
    from csmpn_torch.engineer.fire import use_distributed

    assert not use_distributed(env)


_RENDEZVOUS = r"""
import json, sys
import numpy as np
import torch.distributed as dist
import importlib
from csmpn_torch.engineer.metrics import Loss, MetricCollection
fire = importlib.import_module("csmpn_torch.engineer.fire")
assert fire.use_distributed()
cfg = fire._dist_setup("cpu")
assert dist.get_backend() == "gloo"
coll = MetricCollection({"loss": Loss()})
coll.update(loss=np.full((cfg["rank"] + 1,), float(cfg["rank"] + 1)))
print("RESULT", json.dumps({**cfg, "loss": float(coll.compute()["loss"])}))
"""


def _results(outs):
    got = []
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
        got.append(json.loads(out.rsplit("RESULT ", 1)[1].splitlines()[0]))
    return got


@pytest.mark.parametrize("env_fn", [torchrun_env, slurm_env])
def test_two_process_rendezvous(env_fn):
    outs = _launch(lambda r: [sys.executable, "-c", _RENDEZVOUS], env_fn)
    for rank, got in enumerate(_results(outs)):
        assert got == {"rank": rank, "world_size": 2, "local_devices": 1,
                       "loss": (1.0 + 2.0 * 2) / 3}


# ------------------------------------------------------------- the loaders

@pytest.mark.parametrize("n,world,shuffle", [
    (11, 2, True), (11, 2, False), (10, 2, True), (11, 3, True),
    (7, 4, False), (2, 3, True)])
def test_loader_shards_match_reference(n, world, shuffle):
    """Each rank's batch indices are the reference's, epoch after epoch,
    and every rank has ceil(n / world) samples and as many batches."""
    from csmpn_torch.data.loader import Loader
    from csmpn_tpu.data.loader import Loader as JLoader

    class Data:                          # the loaders read len() alone
        def __len__(self):
            return n

    per = -(-n // world)
    for rank in range(world):
        mine = Loader(Data(), 2, shuffle=shuffle, seed=3,
                      shard=(rank, world))
        ref = JLoader(Data(), 2, shuffle=shuffle, seed=3,
                      shard=(rank, world))
        assert len(mine) == len(ref) == (per // 2 if shuffle
                                         else -(-per // 2))
        for _ in range(3):
            got, want = list(mine.index_iter()), list(ref.index_iter())
            assert len(got) == len(want) == len(mine)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_loader_shards_cover_the_split():
    """Unshuffled, the shards of 11 samples over 3 ranks hold every
    sample, and one wrapped around."""
    from csmpn_torch.data.loader import Loader

    class Data:
        def __len__(self):
            return 11

    idx = [np.concatenate(list(Loader(Data(), 4, shard=(r, 3)).index_iter()))
           for r in range(3)]
    assert [len(i) for i in idx] == [4, 4, 4]
    allidx = np.concatenate(idx)
    assert sorted(set(allidx.tolist())) == list(range(11))
    assert np.bincount(allidx).tolist() == [2] + [1] * 10


# ------------------------------------------------------------- the metrics

def _metric_values(rank):
    """Rank ``rank``'s collections: 5 samples on rank 0, 3 on rank 1."""
    rng = np.random.RandomState(10 + rank)
    n = 5 if rank == 0 else 3
    return {
        "loss": [rng.rand(n)],
        "accuracy": [(rng.rand(n) > 0.5).astype(np.float64)],
        "rmsre": [rng.rand(n, 2)],
        "rrmse": [(rng.rand(n, 2), rng.rand(n, 2) + 1.0)],
        "auroc": [(np.round(rng.rand(n), 1), (rng.rand(n) > 0.4)
                   .astype(np.int64))],
    }


def _compute(module, values):
    classes = {"loss": "Loss", "accuracy": "Accuracy", "rmsre": "RMSRE",
               "rrmse": "RRMSE", "auroc": "BinaryAUROC"}
    out = {}
    for name, cls in classes.items():
        m = getattr(module, cls)()
        for v in values[name]:
            m.update(v)
        out[name] = np.asarray(m.compute(), dtype=np.float64)
    return out


def _concat(a, b):
    """Rank 0's collections, then rank 1's."""
    return {k: a[k] + b[k] for k in a}


def test_metrics_match_reference():
    import csmpn_torch.engineer.metrics as mine
    import csmpn_tpu.engineer.metrics as ref

    for values in (_metric_values(0), _metric_values(1),
                   _concat(_metric_values(0), _metric_values(1))):
        got, want = _compute(mine, values), _compute(ref, values)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------- training and checkpoints

_TRAIN = r"""
import json, os, sys, time
import numpy as np
import importlib
import torch
torch.set_num_threads(1)
from csmpn_torch.engineer import checkpoint as ckpt
from csmpn_torch.engineer.loggers import ConsoleLogger
from csmpn_torch.engineer.optim import adam
from csmpn_torch.engineer.trainer import Trainer
from csmpn_torch.data.motion import MotionDataset
from csmpn_torch.models.motion import MotionModel
from csmpn_torch.nn.modules import init_parameters
from csmpn_torch.ops.segment import set_aggregation_mode
from csmpn_torch.parallel.mesh import make_mesh
import csmpn_torch.engineer.metrics as metrics
fire = importlib.import_module("csmpn_torch.engineer.fire")

out_dir, ds_kw, loader_seed, steps = (sys.argv[1], json.loads(sys.argv[2]),
                                      int(sys.argv[3]), int(sys.argv[4]))
cfg = fire._dist_setup("cpu")
rank = cfg["rank"]
set_aggregation_mode("exact")

# the metrics: each rank its own collections
values = json.loads(sys.argv[5])[rank]
res = {}
for name, cls in (("loss", "Loss"), ("accuracy", "Accuracy"),
                  ("rmsre", "RMSRE"), ("rrmse", "RRMSE"),
                  ("auroc", "BinaryAUROC")):
    m = getattr(metrics, cls)()
    for v in values[name]:
        m.update(tuple(np.asarray(x) for x in v) if name in ("rrmse", "auroc")
                 else np.asarray(v))
    res[name] = np.asarray(m.compute(), dtype=np.float64).tolist()

# one DATAROOT for both ranks: they write the same seeded files at once
ds = MotionDataset(**ds_kw)
model = MotionModel(spec=ds.spec, num_hidden=4, num_layers=1)
gen = torch.Generator().manual_seed(0)
init_parameters(model, gen)
with torch.no_grad():
    for p in model.parameters():
        p.add_(0.05 * torch.randn(p.shape, generator=gen))
        if rank == 1:          # replicate() must overwrite these
            p.add_(1.0)

# rank 0 writes its checkpoints slowly: the other rank must wait for them
if rank == 0:
    save = ckpt._save
    def slow_save(*a, **k):
        time.sleep(1.0)
        save(*a, **k)
    ckpt._save = slow_save

run_dir = os.path.join(out_dir, "run")
shard = (rank, cfg["world_size"])
tr = Trainer(max_steps=steps, val_check_interval=2, print_interval=1,
             log_interval=10 ** 6, limit_val_batches=1,
             logger=ConsoleLogger(dir=run_dir), mesh=make_mesh())
tr.fit(model, adam(model.parameters(), lr=1e-3),
       ds.train_loader(seed=loader_seed, shard=shard),
       val_loader=ds.val_loader(shard=shard))
t_after = time.time()
last = os.path.join(run_dir, "last")
meta = json.load(open(os.path.join(last, "meta.json")))
state = torch.load(os.path.join(last, "state.pt"), weights_only=True)
whole = all(torch.equal(state["model"][k], v)
            for k, v in model.state_dict().items())
np.savez(os.path.join(out_dir, f"params{rank}.npz"),
         **{k: v.detach().numpy() for k, v in model.named_parameters()})

# a restore on both ranks, into a fresh model
model2 = MotionModel(spec=ds.spec, num_hidden=4, num_layers=1)
opt2 = adam(model2.parameters(), lr=1e-3)
tr2 = Trainer(logger=ConsoleLogger(dir=os.path.join(out_dir, "run2")),
              checkpoint=last)
tr2.checkpoint.restore(tr2, model2, opt2)
restored = all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  model2.parameters()))
print("RESULT", json.dumps({
    "metrics": res, "losses": tr.step_losses, "step": tr.global_step,
    "meta_step": meta["step"], "whole": whole, "restored": restored,
    "restored_step": tr2.global_step, "t_after": t_after,
    "files": sorted(os.listdir(run_dir)),
    "last_files": sorted(os.listdir(last))}))
"""


def _jsonable(values):
    return {k: [[np.asarray(x).tolist() for x in v] if isinstance(v, tuple)
                else np.asarray(v).tolist() for v in vs]
            for k, vs in values.items()}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The two-rank training run (torchrun-style variables); returns
    (both ranks' results, both ranks' parameters, their outputs)."""
    out = tmp_path_factory.mktemp("dp_train")
    values = json.dumps([_jsonable(_metric_values(r)) for r in range(2)])

    def env_fn(rank, port):
        return dict(torchrun_env(rank, port), DATAROOT=str(out / "data"))

    outs = _launch(lambda r: [
        sys.executable, "-c", _TRAIN, str(out), json.dumps(DS_KW),
        str(LOADER_SEED), str(STEPS), values], env_fn)
    results = _results(outs)
    params = [dict(np.load(out / f"params{r}.npz")) for r in range(2)]
    return results, params, [o for _, o in outs]


def test_two_rank_metrics_gather(trained):
    """Rank 0 holds 5 samples, rank 1 holds 3: each rank's metric is the
    single-process value over rank 0's samples, then rank 1's."""
    import csmpn_torch.engineer.metrics as mine

    results = trained[0]
    want = _compute(mine, _concat(_metric_values(0), _metric_values(1)))
    for rank in range(2):
        for k, v in want.items():
            np.testing.assert_array_equal(
                np.asarray(results[rank]["metrics"][k]), v, err_msg=k)
    # the mean of the ranks' AUROCs is another number: the gather matters
    per_rank = [_compute(mine, _metric_values(r))["auroc"] for r in range(2)]
    assert abs(np.mean(per_rank) - want["auroc"]) > 1e-3


def test_two_ranks_end_bitwise_equal(trained, capsys):
    """Both ranks: the same parameters bit for bit (rank 1 started from
    other weights, which replicate() overwrote), the same losses, and
    max_steps stopped both at step 3."""
    results, params, outs = trained
    assert params[0].keys() == params[1].keys()
    for k in params[0]:
        assert params[0][k].tobytes() == params[1][k].tobytes(), k
    assert results[0]["losses"] == results[1]["losses"]
    assert len(results[0]["losses"]) == STEPS
    for res, out in zip(results, outs):
        assert res["step"] == STEPS
        assert "Stopping due to max_steps." in out
        lines = [ln for ln in out.splitlines() if "(Training) Loss:" in ln]
        assert len(lines) == STEPS
    assert ([ln for ln in outs[0].splitlines() if "(Training) Loss:" in ln]
            == [ln for ln in outs[1].splitlines()
                if "(Training) Loss:" in ln])


def test_two_ranks_match_reference_on_global_batches(trained, tmp_path):
    """Rank 0's initial weights stepped by the JAX motion model
    (jax.value_and_grad, the reference's Adam, lr 1e-3) on each global
    batch, rank 0's local batch then rank 1's: the losses and every
    parameter within rtol 2e-4 / atol 1e-5."""
    import optax

    from csmpn_torch.convert import params_from_jax, params_to_jax
    from csmpn_torch.data.loader import Loader
    from csmpn_torch.models.motion import MotionModel
    from csmpn_torch.nn.modules import init_parameters
    from csmpn_tpu.data.motion import MotionDataset as JDataset
    from csmpn_tpu.engineer.optim import adam as jadam
    from csmpn_tpu.models.motion import MotionModel as JModel

    results, params, _ = trained
    old = os.environ.get("DATAROOT")
    os.environ["DATAROOT"] = str(tmp_path)
    try:
        jds = JDataset(**DS_KW)
    finally:
        if old is None:
            os.environ.pop("DATAROOT", None)
        else:
            os.environ["DATAROOT"] = old
    tm = MotionModel(spec=jds.spec, num_hidden=4, num_layers=1)
    gen = torch.Generator().manual_seed(0)
    init_parameters(tm, gen)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    jparams = jax.tree.map(jnp.asarray, params_to_jax(tm.state_dict()))
    jm = JModel(spec=jds.spec, num_hidden=4, num_layers=1)
    tx = jadam(lr=1e-3)
    opt_state = tx.init(jparams)
    step = jax.jit(jax.value_and_grad(lambda p, b: jm.apply(p, b)[0]))
    iters = [Loader(jds.train_dataset, DS_KW["batch_size"], shuffle=True,
                    seed=LOADER_SEED, shard=(r, 2)).index_iter()
             for r in range(2)]
    losses = []
    for _ in range(STEPS):
        idx = np.concatenate([next(it) for it in iters])
        loss, grads = step(jparams, jds.train_dataset.select(idx))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        losses.append(float(loss))
    np.testing.assert_allclose(results[0]["losses"], losses, rtol=RTOL,
                               atol=ATOL)
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for name, got in params[0].items():
        np.testing.assert_allclose(got, want[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_rank0_checkpoints(trained):
    """Rank 0 alone wrote `last` and `best_val_loss` (one second late);
    rank 1 left the barrier after it and found whole files (the state it
    trained, meta.json at step 3); a restore on both ranks gives the
    trained parameters and step."""
    results, _, outs = trained
    assert "Saved latest-state checkpoint" in outs[0]
    assert "Saved latest-state checkpoint" not in outs[1]
    assert "saved checkpoint to" in outs[0] and \
        "saved checkpoint to" not in outs[1]
    for res in results:
        assert res["files"] == ["best_val_loss", "last"]
        assert res["last_files"] == ["meta.json", "state.pt"]
        assert res["whole"] and res["restored"]
        assert res["meta_step"] == res["restored_step"] == STEPS


# ------------------------------------------------------- the entry point

def _motion_argv(extra=()):
    return [sys.executable, "-m", "csmpn_torch.tasks.motion",
            "--trainer.module=csmpn_torch.engineer.Trainer",
            "--trainer.max_steps=4", "--trainer.val_check_interval=2",
            "--trainer.print_interval=1", "--trainer.limit_val_batches=1",
            "--dataset.module=csmpn_torch.data.motion.MotionDataset",
            "--dataset.num_training_samples=11", "--dataset.batch_size=2",
            "--dataset.num_eval_samples=6",
            "--optimizer.module=csmpn_torch.engineer.optim.adam",
            "--model.module=csmpn_torch.models.motion.MotionModel",
            "--model.num_hidden=4", "--model.num_layers=1", "--device=cpu",
            "--data_parallel=true", *extra]


def test_motion_cli_two_processes(tmp_path):
    """The motion entry point under two processes: both join the group,
    print the same "(Training) Loss:" lines and validation loss, take
    their shards (3 batches of 2 of the 11 samples an epoch, so step 3 is
    in the second epoch), and only rank 0 writes checkpoints."""
    def env_fn(rank, port):
        return dict(torchrun_env(rank, port), DATAROOT=str(tmp_path),
                    RUNDIR=str(tmp_path / "runs"))

    outs = _launch(lambda r: _motion_argv(["--trainer.log_interval=3"]),
                   env_fn)
    for _, out in outs:
        assert out.count("train/epoch: ") == 2
        assert "train/epoch: 1.0000" in out
    lines = []
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
        assert f"Distributed: {{'rank': {rank}, 'world_size': 2, " \
               f"'local_devices': 1}}" in out
        lines.append([ln for ln in out.splitlines()
                      if "(Training) Loss:" in ln or ln.startswith(
                          ("val/loss", "test/loss"))])
    assert len([ln for ln in lines[0] if "Training" in ln]) == 4
    assert lines[0] == lines[1]
    assert "Saved latest-state" in outs[0][1]
    assert "Saved latest-state" not in outs[1][1]


class _PastTheCheck(Exception):
    pass


@pytest.mark.parametrize("group", ["none", "of one"])
def test_data_parallel_refused_with_two_cards(monkeypatch, tmp_path, group):
    """--data_parallel=true in one process that sees two cards and is part
    of no group raises and names the launch command; the same process as
    the one rank of a group of one (a single-rank torchrun launch) passes
    the check (the run is stopped just after it)."""
    import torch.distributed as dist

    from csmpn_torch.engineer.fire import fire
    from csmpn_torch.tasks import common
    from csmpn_torch.tasks.motion import main

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "TORCHELASTIC_RUN_ID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DATAROOT", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def past(mode):
        raise _PastTheCheck

    monkeypatch.setattr(common, "set_aggregation_mode", past)
    argv = [a for a in _motion_argv()[3:] if a != "--device=cpu"]
    run = lambda: fire(main, ["csmpn_torch/tasks/motion.py", *argv,
                              "--device=cuda"])
    if group == "none":
        with pytest.raises(ValueError, match="torch.distributed.run "
                                             "--nproc_per_node 2"):
            run()
        return
    port = _free_port()
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    # the group fire finds already up (its nccl needs a card)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(_PastTheCheck):
            run()
    finally:
        dist.destroy_process_group()


def test_trainer_rejects_a_mesh_on_another_device(tmp_path):
    """A mesh whose rank lives elsewhere than the model raises."""
    from csmpn_torch.engineer.optim import adam
    from csmpn_torch.engineer.trainer import Trainer
    from csmpn_torch.parallel.mesh import Mesh

    model = torch.nn.Linear(2, 2)
    mesh = Mesh(rank=0, world=1, device=torch.device("meta"))
    tr = Trainer(mesh=mesh, max_steps=1)
    with pytest.raises(ValueError, match="mesh"):
        tr.fit(model, adam(model.parameters()), [])


# ----------------------------------------------------- the kernel build

_FAKE_NVCC = r"""#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    for i in range(20):
        f.write(bytes([i]) * 4096)
        f.flush()
        time.sleep(0.01)
print("ptxas info    : Used 1 registers")
"""

_BUILD = r"""
import os, sys, time
from csmpn_torch.ops import _build
_build.BUILD_DIR = sys.argv[1]
_build.SOURCES = ("segment_sum", "cemlp")
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
_build.build_all()
for name in _build.SOURCES:
    with open(_build._lib_path(name), "rb") as f:
        data = f.read()
    assert data == b"".join(bytes([i]) * 4096 for i in range(20)), len(data)
print("RESULT", '{"ok": true}')
"""


@pytest.mark.parametrize("lag", [0.0, 0.1])
def test_two_ranks_build_the_kernels_at_once(tmp_path, lag):
    """Two ranks start the build into one directory, rank 1 ``lag``
    seconds after rank 0 (each nvcc writes its library over 0.2 s, so at
    0.1 s rank 0's libraries are half written): both finish, and each
    loads only whole libraries."""
    import time

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    start = time.time() + 3.0
    build = tmp_path / "kernels"

    outs = _launch(lambda r: [sys.executable, "-c", _BUILD, str(build),
                              str(start + r * lag)],
                   lambda rank, port: {"CUDA_HOME": str(tmp_path / "cuda")})
    assert all(g == {"ok": True} for g in _results(outs))
    assert not [f for f in os.listdir(build) if f.endswith(".tmp")]
