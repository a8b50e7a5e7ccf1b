"""Layered YAML + dotted-CLI config system with constructor reflection.

Port of ``csmpn_tpu/engineer/config.py`` (which itself mirrors the
reference's ``engineer/argparse/argparse.py``).

Semantics preserved:
  * repeated ``-C file.yaml`` layering with recursive dict merge
    (argparse.py:94-126);
  * ``--section.module=dotted.path`` declares a component; its constructor
    signature is reflected so ``--section.param=value`` flags are typed from
    the declared defaults (argparse.py:144-174);
  * forced-float exceptions for lr/weight_decay (argparse.py:13);
  * sweep pseudo-args ``--_name=...`` spliced back into argv
    (argparse.py:106-109);
  * run name derived from argv (argparse.py:81-91).
"""
from __future__ import annotations

import ast
import importlib
import inspect
import os
import re
import sys
import typing
from typing import Any, Callable, Dict, List, Tuple

import yaml

EXCEPTIONS = {"weight_decay": float, "lr": float}


def load_module(path: str) -> Callable[..., Any]:
    """Dotted-path import (reference engineer/utils/load_module.py:4-8)."""
    module, obj = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), obj)


def try_literal_eval(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def merge_dict(a: Dict, b: Dict) -> Dict:
    out = {**a}
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = v
    return out


def unflatten(flat: Dict[str, Any], sep: str = ".") -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split(sep)
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def get_default_args(func) -> Dict[str, Any]:
    sig = inspect.signature(func)
    try:
        hints = typing.get_type_hints(func)
    except Exception:
        hints = {}
    args = {}
    for k, v in sig.parameters.items():
        if v.default is inspect.Parameter.empty:
            continue
        hint = hints.get(k)
        optional = (
            typing.get_origin(hint) is typing.Union
            and len(typing.get_args(hint)) == 2
            and typing.get_args(hint)[1] is type(None))
        args[k] = None if optional else v.default
    return args


def _coerce(value: str, default: Any, key: str):
    if key in EXCEPTIONS:
        return EXCEPTIONS[key](value)
    if default is None:
        return try_literal_eval(value)
    if isinstance(default, bool):
        return str(value).lower() == "true"
    if isinstance(default, (tuple, list)):      # e.g. profile_steps=[8,12]
        parsed = try_literal_eval(value)
        if not isinstance(parsed, (tuple, list)):
            raise ValueError(f"--{key} wants a sequence such as [8,12], "
                             f"got {value!r}")
        return type(default)(parsed)
    return type(default)(value)


def get_run_name(argv: List[str]) -> str:
    parts = []
    for v in argv:
        if v.startswith("-C"):
            v = v[3:]
        if v.startswith("--"):
            parts.append(v[2:])
        elif os.path.exists(v):
            parts.append(os.path.splitext(os.path.basename(v))[0])
    name = "_".join(parts)
    if len(name) > 96:  # used as a directory name: keep it filesystem-safe
        import hashlib

        digest = hashlib.sha1(name.encode()).hexdigest()[:8]
        name = f"{name[:88]}_{digest}"
    return name


def parse_args(argv: List[str] = None) -> Tuple[Dict, str, str]:
    """Returns (nested config dict, run_name, experiment_name)."""
    raw_argv = list(sys.argv if argv is None else argv)
    argv = list(raw_argv)
    # splice sweep pseudo-args: --_x='--a=1 --b=2'
    for i, a in enumerate(argv):
        if a.startswith("--_"):
            argv[i] = a.split("=", maxsplit=1)[1]
    argv = [v for chunk in argv for v in chunk.replace("'", "").split()]

    # collect -C yaml files
    yamls, rest = [], []
    i = 0
    while i < len(argv):
        if argv[i] == "-C":
            yamls.append(argv[i + 1])
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    argv = rest

    config: Dict = {}
    for y in yamls:
        with open(y) as f:
            layer = yaml.safe_load(f)
        if layer:
            config = merge_dict(config, layer)

    # module declarations
    module_re = re.compile(r"^--[^-.]+\.module=")
    kept = []
    for a in argv:
        if module_re.match(a):
            k, v = a.split("=", maxsplit=1)
            section = k.split(".")[0][2:]
            print(f"Detected module '{section}' with value {v}. "
                  f"Adding to config...")
            config[section] = {**config.get(section, {}), "module": v}
        else:
            kept.append(a)
    argv = kept

    # flag overrides --section.key=value and globals like --seed
    overrides: Dict[str, str] = {}
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", maxsplit=1)
            overrides[k] = v

    result: Dict[str, Any] = {"seed": int(overrides.pop("seed", 42))}
    for section, body in config.items():
        if not isinstance(body, dict):
            result[section] = body
            continue
        if "module" not in body:
            # plain config section (e.g. sweep blocks); keep as-is
            result[section] = body
            continue
        module_path = body["module"]
        cls = load_module(module_path)
        defaults = get_default_args(
            cls.__init__ if inspect.isclass(cls) else cls)
        section_cfg = {"module": module_path}
        for k, default in defaults.items():
            if k in body:
                v = body[k]
                section_cfg[k] = (
                    _coerce(str(v), default, k) if isinstance(v, str)
                    else (EXCEPTIONS[k](v) if k in EXCEPTIONS else v))
            else:
                section_cfg[k] = default
        # yaml keys that are not ctor params are a config error
        unknown = set(body) - set(section_cfg)
        if unknown:
            raise KeyError(
                f"Got unknown keys for {section} config: {tuple(unknown)}.")
        result[section] = section_cfg

    for k, v in overrides.items():
        parts = k.split(".")
        if len(parts) == 1:
            result[k] = try_literal_eval(v)
            continue
        section, key = parts[0], ".".join(parts[1:])
        if section not in result or not isinstance(result[section], dict):
            raise KeyError(f"Override for undeclared section: {k}")
        default = result[section].get(key)
        result[section][key] = _coerce(v, default, key)

    name = get_run_name(raw_argv[1:])
    experiment = os.path.splitext(os.path.basename(raw_argv[0]))[0]
    return result, name, experiment


def pretty(d: Dict, indent: int = 0) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            print("  " * indent + k)
            pretty(v, indent + 1)
        else:
            print("  " * indent + f"{k}: {v}")
