"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each ``.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface under ``build/kernels/`` of the checkout
(gitignored), on first use, from the sources beside this module only; all
sources compile at once, one ``nvcc`` each.  An installed package, or a
checkout whose ``build/`` cannot be written, builds into a per-user cache
directory instead (:func:`_build_dir`); a failed build raises, it never
falls back to the kernels' plain twins.  The libraries are loaded with
``ctypes``: tensors pass as ``data_ptr()`` integers, the stream as
``torch.cuda.current_stream().cuda_stream``, and every C entry point returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into a
``RuntimeError``.

Nothing here runs when the module is imported: the CPU tests import every
module, and this machine-independent part must not need ``nvcc``.

Several processes may build at once: :func:`build` holds an
``fcntl.flock`` on ``build/kernels/libtft.lock``, decides what is stale
only once it holds it (so a second process reuses the first one's
libraries), and each ``nvcc`` writes a temporary name of this process's
own that ``os.replace`` moves into place (``utils/buildlock.py``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

from torchft_tpu_torch.utils import buildlock
from torchft_tpu_torch.utils.env import env_str

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")


def _build_dir(pkg_dir: str = _PKG_DIR) -> str:
    """``build/kernels`` of the checkout that holds ``pkg_dir`` (its parent
    has ``pyproject.toml``) when it can be written or made there; else
    ``torchft_tpu_torch/kernels`` under the user's cache directory
    (``$XDG_CACHE_HOME``, default ``~/.cache``)."""
    root = os.path.dirname(pkg_dir)
    local = os.path.join(root, "build", "kernels")
    if os.path.exists(os.path.join(root, "pyproject.toml")):
        probe = local
        while not os.path.exists(probe):
            probe = os.path.dirname(probe)
        if os.access(probe, os.W_OK | os.X_OK):
            return local
    cache = env_str("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "torchft_tpu_torch", "kernels")


BUILD_DIR = _build_dir()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

#: kernel name -> (source file, C entry point, argtypes)
KERNELS: "Dict[str, tuple]" = {
    "flash_fwd": (
        "flash_fwd.cu",
        "tft_flash_fwd",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "flash_bwd_kv": (
        "flash_bwd_kv.cu",
        "tft_flash_bwd_kv",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "flash_bwd_q": (
        "flash_bwd_q.cu",
        "tft_flash_bwd_q",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    ),
    "quant_int8": ("quant_int8.cu", "tft_quant_int8", [_P, _P, _P, _L, _L, _P]),
    "dequant_int8": (
        "dequant_int8.cu", "tft_dequant_int8", [_P, _P, _P, _L, _L, _P],
    ),
    "reduce_int8": (
        "reduce_int8.cu",
        "tft_reduce_int8",
        [_P, _P, _P, _P, _I, _L, _L, _F, _P],
    ),
}

_lock = threading.Lock()
_libs: "Dict[str, ctypes.CDLL]" = {}
#: ptxas report (registers, shared memory, spills) of the last build
build_log: "Dict[str, str]" = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(env_str("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str, suffix: str = "") -> str:
    return os.path.join(BUILD_DIR, f"libtft_{name}{suffix}.so")


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(
        os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def build(names: "Optional[List[str]]" = None, force: bool = False) -> float:
    """Compile the named kernels (default: all) that are missing or older
    than their sources (all of them with ``force``, which refills
    :data:`build_log`), all ``nvcc`` processes at once.  Returns the wall
    seconds spent; raises with the compiler output on any failure."""
    names = list(KERNELS) if names is None else names
    t0 = time.perf_counter()
    if not force and not any(_stale(n) for n in names):
        return 0.0
    with buildlock.locked(os.path.join(BUILD_DIR, "libtft")):
        todo = [n for n in names if force or _stale(n)]
        if not todo:
            return 0.0
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            src = os.path.join(CSRC_DIR, KERNELS[name][0])
            tmp = buildlock.temp_name(_lib_path(name))
            cmd = [
                nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", tmp, src,
            ]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            ok = proc.returncode == 0
            buildlock.replace_or_discard(tmp, _lib_path(name), ok)
            if not ok:
                failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def entry(name: str) -> "ctypes._CFuncPtr":
    """The C entry point of kernel ``name``, building and loading its
    library on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(_lib_path(name))
                fn = getattr(lib, KERNELS[name][1])
                fn.argtypes = KERNELS[name][2]
                fn.restype = ctypes.c_int
                _libs[name] = lib
    return getattr(lib, KERNELS[name][1])


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
