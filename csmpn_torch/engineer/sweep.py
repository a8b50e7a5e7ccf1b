"""Sweep launchers: the entry point of every task.

    python -m csmpn_torch.engineer.sweep csmpn_torch/configs/motion.yaml \
        [--dry_run] [--section.key=value ...]

Port of ``csmpn_tpu/engineer/sweep.py``.  ``sweep_local`` expands a YAML
``parameters`` grid into the cartesian product of shell commands and runs
them one after another, stopping at the first failure; the extra
arguments follow the grid's, and the config parser keeps the last value of
a repeated flag, so they override the file.  ``write_slurm_jobfile``
writes a SLURM array jobfile for the grid (``main_cluster``), and
``sweep_wandb`` registers the grid as a wandb sweep behind the git guards
and writes an agent jobfile (``main_cluster --wandb``).  The port's sweep
files are ``csmpn_torch/configs/*.yaml``.
"""
from __future__ import annotations

import itertools
import subprocess
import sys
from typing import Dict, List, Optional

import yaml


def expand_grid(config: Dict) -> List[Dict]:
    parameters = {k: v["values"] for k, v in config["parameters"].items()}
    keys, values = zip(*parameters.items()) if parameters else ((), ())
    return [dict(zip(keys, combo))
            for combo in itertools.product(*values)]


def _program_invocation(program: str) -> str:
    """In-package task scripts run as modules (``-m pkg.mod``): invoked as
    files (``python csmpn_torch/tasks/md17.py``) sys.path[0] is the tasks/
    directory, so ``import csmpn_torch`` fails.  Paths outside the package
    pass through."""
    if program.endswith(".py") and "/" in program:
        mod = program[:-3].replace("/", ".")
        if mod.split(".")[0] == "csmpn_torch":
            return f"-m {mod}"
    return program


def build_commands(config: Dict, extra_args: List[str]) -> List[str]:
    base = []
    for c in config["command"]:
        if c == "${env}":
            base.append("/usr/bin/env")
        elif c == "${interpreter}":
            base.append("python -u")
        elif c == "${program}":
            base.append(_program_invocation(config["program"]))
        elif c == "${args}":
            continue
        else:
            base.append(c)
    commands = []
    for combo in expand_grid(config):
        cmd = base + [f"--{k}={v}" for k, v in combo.items()] + extra_args
        commands.append(" ".join(cmd))
    return commands


def sweep_local(config_path: str, extra_args: Optional[List[str]] = None,
                dry_run: bool = False) -> int:
    with open(config_path) as f:
        config = yaml.safe_load(f)
    for cmd in build_commands(config, list(extra_args or [])):
        print("\nRunning:", cmd, "\n")
        if dry_run:
            continue
        result = subprocess.call(cmd, shell=True)
        if result != 0:
            return result
    return 0


def write_slurm_jobfile(config_path: str, out_path: str,
                        partition: str = "gpu", time: str = "24:00:00",
                        extra_args: Optional[List[str]] = None) -> str:
    with open(config_path) as f:
        config = yaml.safe_load(f)
    commands = build_commands(config, list(extra_args or []))
    lines = [
        "#!/bin/bash",
        f"#SBATCH --array=0-{len(commands) - 1}",
        f"#SBATCH --partition={partition}",
        f"#SBATCH --time={time}",
        "",
        "case $SLURM_ARRAY_TASK_ID in",
    ]
    for i, cmd in enumerate(commands):
        lines.append(f"  {i}) {cmd} ;;")
    lines += ["esac", ""]
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    return out_path


def git_detached(run=None) -> bool:
    """Whether HEAD is detached: a sweep refuses to start there (the sweep
    tag must land on a branch)."""
    run = run or _run_git
    return "HEAD detached" in run("git status")


def git_sync_status(run=None) -> str:
    """ahead / behind / diverged / up-to-date against the upstream branch;
    'no-upstream' where there is no remote tracking branch (common in
    offline checkouts)."""
    run = run or _run_git
    run("git fetch")
    status = run("git rev-list --left-right --count HEAD...@{u}")
    try:
        behind, ahead = map(int, status.split())
    except ValueError:
        return "no-upstream"
    if ahead and behind:
        return "diverged"
    if ahead:
        return "ahead"
    if behind:
        return "behind"
    return "up-to-date"


def tag_sweep_commit(sweep_id: str, push: bool = False, run=None) -> None:
    """Pin the exact code state of a sweep: an empty commit and a tag named
    after the sweep id, so workers can ``git checkout <sweep_id>``.  Push is
    opt-in (offline environments)."""
    run = run or _run_git
    run(f"git commit --allow-empty -m {sweep_id}")
    run(f"git tag {sweep_id}")
    if push:
        run("git push")
        run(f"git push origin {sweep_id}")


def _run_git(cmd: str) -> str:
    out = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    return (out.stdout + out.stderr).strip()


def register_wandb_sweep(config: Dict, wandb_module=None) -> str:
    """Register the grid as a wandb sweep and return the sweep id: the
    config is already wandb-sweep-shaped (program/command/parameters).
    ``wandb_module`` is injectable so the flow is testable offline; by
    default the real wandb is imported, with a clear error where it is
    unavailable."""
    if wandb_module is None:
        try:
            import wandb as wandb_module  # noqa: F811
        except ImportError as e:
            raise RuntimeError(
                "wandb is not installed; use `sweep_local` or "
                "`main_cluster` (wandb-free jobfile) instead.") from e
    project = config.get("project", "csmpn_torch")
    entity = config.get("entity")
    return wandb_module.sweep(sweep=config, project=project, entity=entity)


def sweep_wandb(config_path: str, wandb_module=None, run_git=None,
                push: bool = False, jobfile: Optional[str] = None,
                partition: str = "gpu", time: str = "24:00:00") -> str:
    """The ``sweep`` console flow: git-state guard -> wandb sweep
    registration -> SLURM array jobfile whose tasks run ``wandb agent`` ->
    sweep-id git tag.  ``run_git`` (a command string -> its output) is
    injectable.  Returns the sweep id."""
    run_git = run_git or _run_git
    if git_detached(run_git):
        raise RuntimeError("git is a detached HEAD; checkout a branch.")
    status = git_sync_status(run_git)
    if status in ("behind", "diverged"):
        print(f"WARNING: git is {status} vs remote; workers checking out "
              "the sweep tag will not see remote changes.")

    with open(config_path) as f:
        config = yaml.safe_load(f)
    sweep_id = register_wandb_sweep(config, wandb_module)

    project = config.get("project", "csmpn_torch")
    entity = config.get("entity") or "${WANDB_ENTITY}"
    agent = f"WANDB_ENABLED=TRUE wandb agent {entity}/{project}/{sweep_id}"
    n_jobs = len(expand_grid(config))
    if jobfile:
        lines = [
            "#!/bin/bash",
            f"#SBATCH --array=1-{n_jobs}",
            f"#SBATCH --partition={partition}",
            f"#SBATCH --time={time}",
            "",
            f"git checkout {sweep_id}",
            agent,
            "",
        ]
        with open(jobfile, "w") as f:
            f.write("\n".join(lines))
        print(f"Wrote SLURM agent jobfile: {jobfile}")

    tag_sweep_commit(sweep_id, push=push, run=run_git)
    print(f"Registered sweep {sweep_id}; run with: "
          f"git checkout {sweep_id} && {agent}")
    return sweep_id


def main() -> None:
    argv = sys.argv[1:]
    dry = "--dry_run" in argv
    if dry:
        argv = [a for a in argv if a != "--dry_run"]
    sys.exit(sweep_local(argv[0], argv[1:], dry_run=dry))


def main_cluster() -> None:
    """The cluster entry point: expands the grid into a SLURM array
    jobfile.  ``--wandb`` registers the sweep and tags the commit instead
    (needs wandb and a network); without it the jobfile is
    self-contained."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--out", default="sweep_job.sh")
    ap.add_argument("--partition", default="gpu")
    ap.add_argument("--time", default="24:00:00")
    ap.add_argument("--wandb", action="store_true",
                    help="register a wandb sweep and tag the commit")
    ap.add_argument("--push", action="store_true",
                    help="push the sweep tag to origin")
    args, extra = ap.parse_known_args()
    if args.wandb:
        sweep_wandb(args.config, push=args.push, jobfile=args.out,
                    partition=args.partition, time=args.time)
        return
    path = write_slurm_jobfile(args.config, args.out,
                               partition=args.partition, time=args.time,
                               extra_args=extra)
    print(f"Wrote SLURM array jobfile: {path}")


if __name__ == "__main__":
    main()
