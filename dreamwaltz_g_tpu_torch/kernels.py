"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (``csrc/*.cuh`` are headers
they share). It is compiled with ``nvcc``
for ``sm_90a`` into ``_build/lib<name>.so`` on first use (or by ``build``,
which starts one ``nvcc`` per source, all at once) and loaded with
``ctypes``. Nothing is compiled or loaded at import time.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
#: C signatures of each kernel library's launch functions: {name: argtypes}
SIGNATURES = {
    "blend_sorted": {
        "blend_sorted_f32": [_P] * 5 + [_I] * 3 + [_F] * 3 + [_P],
        "blend_sorted_info": [_I, _P],
    },
    "blend_train": {
        "blend_train_fwd_f32": [_P] * 6 + [_I] * 6 + [_F] * 3 + [_P],
        "blend_tiles_eval_f32": [_P] * 4 + [_I] * 6 + [_F] * 3 + [_P],
        "blend_train_bwd_f32": [_P] * 10 + [_I] * 6 + [_F] * 2 + [_P],
        "blend_train_info": [_I, _I, _P],
    },
    "flash_attn": {
        "flash_attn_fwd": [_P] * 7 + [_I] * 4 + [_L] * 9 + [_I, _I, _P],
        "flash_attn_bwd": [_P] * 11 + [_I] * 4 + [_L] * 9 + [_I, _P],
        "flash_attn_fwd_info": [_I, _I, _I, _P],
        "flash_attn_bwd_info": [_I, _I, _I, _P],
    },
    "flash_fwd_hopper": {
        "flash_fwd_hopper": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_P],
        "flash_fwd_hopper_info": [_I, _I, _I, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    if not lib.exists():
        return True
    sources = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def build(names: Optional[Iterable[str]] = None, force: bool = False
          ) -> Dict[str, str]:
    """Compile the named kernels (all by default), one ``nvcc`` process per
    source, started together. Returns each build's compiler log (ptxas
    register and shared-memory report); raises on a failed build."""
    names = list(SIGNATURES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        os.replace(tmp, _lib_path(name))
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn_name, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
