"""Test-discovery runner: walks a path for ``*.py`` modules exposing a
``test()`` callable and runs each; exits 1 if any failed.

    python -m csmpn_torch.engineer.discover_tests [PATH]

Port of ``csmpn_tpu/engineer/discover_tests.py``.  The primary suite is
pytest (tests/); this runner serves ad-hoc smoke scripts.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def discover_and_run(path: str) -> int:
    failures = 0
    for file in sorted(Path(path).rglob("*.py")):
        spec = importlib.util.spec_from_file_location(file.stem, file)
        module = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(module)
        except Exception as e:
            print(f"SKIP {file}: import failed ({e})")
            continue
        test = getattr(module, "test", None)
        if callable(test):
            print(f"RUN  {file}::test")
            try:
                test()
                print(f"PASS {file}::test")
            except Exception as e:
                failures += 1
                print(f"FAIL {file}::test: {e}")
    return failures


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "."
    sys.exit(1 if discover_and_run(path) else 0)


if __name__ == "__main__":
    main()
