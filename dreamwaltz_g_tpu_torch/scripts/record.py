"""Run a shell script with a ``python`` that records its command lines.

``record_calls(script, *args)`` runs ``bash script args...`` with a ``PATH``
whose first entry holds a ``python`` shim: each call appends its arguments
as one JSON line to a log and exits 0. The script runs no Python at all, so
its calls can be read (and replayed with other values) without training.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
SCRIPTS = Path(__file__).resolve().parent
MODULE = ["-m", "dreamwaltz_g_tpu_torch.main"]

SHIM = """#!/bin/sh
exec {python} -c 'import json, os, sys
with open(os.environ["RECORD_CALLS_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")' "$@"
"""


def record_calls(script, *args: str, env: Optional[dict] = None,
                 cwd=REPO_ROOT) -> List[List[str]]:
    """The command lines ``script`` hands ``python``, in order, each without
    the program name. ``env`` is added to the environment; the script runs
    from ``cwd`` (the repository root by default). Raises
    ``subprocess.CalledProcessError`` when the script fails."""
    with tempfile.TemporaryDirectory(prefix="record_calls_") as tmp:
        tmp = Path(tmp)
        shim = tmp / "bin" / "python"
        shim.parent.mkdir()
        shim.write_text(SHIM.format(python=sys.executable))
        shim.chmod(0o755)
        log = tmp / "calls.jsonl"
        log.touch()
        full = dict(os.environ, **(env or {}))
        full.update(PATH=f"{shim.parent}{os.pathsep}{full.get('PATH', '')}",
                    RECORD_CALLS_LOG=str(log))
        subprocess.run(["bash", str(script), *args], cwd=cwd, env=full,
                       check=True, stdout=subprocess.DEVNULL)
        return [json.loads(ln) for ln in log.read_text().splitlines()]


def main_calls(script, *args: str, **kw) -> List[List[str]]:
    """The calls of the port's CLI that ``script`` (a name under
    ``dreamwaltz_g_tpu_torch/scripts/`` or a path) makes, each argv after
    ``-m dreamwaltz_g_tpu_torch.main``."""
    path = Path(script)
    if not path.is_absolute() and not path.exists():
        path = SCRIPTS / script
    return [c[len(MODULE):] for c in record_calls(path, *args, **kw)
            if c[:len(MODULE)] == MODULE]


def replace_flags(argv: List[str], values: dict) -> List[str]:
    """``argv`` with the value of each flag of ``values`` replaced, and the
    flags it lacks appended with theirs."""
    out = list(argv)
    for flag, value in values.items():
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out
