"""Build and load the port's CUDA kernels.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  Builds
happen at first use, into ``kernels/_build/`` (listed in ``.gitignore``),
under a file name that carries a hash of the flags, the source and the
headers under ``csrc/`` it includes, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.  A failed build
raises; there is no fallback.

Nothing here runs at import: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# name -> loaded library, and name -> (seconds, ptxas report) of the build
_libs: dict[str, ctypes.CDLL] = {}
build_reports: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header under ``csrc/`` it includes,
    directly or through another header (``#include "..."``)."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            if (path.parent / inc).is_file():
                todo.append(path.parent / inc)
    return seen


def _target(name: str) -> Path:
    """The library's path, named by a hash of the flags and of every file the
    source is built from, so an edited header rebuilds its kernels too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path, float]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    build_reports[name] = (time.perf_counter() - t0, log)


def build_all(names) -> None:
    """Compile every named source that has no current build, one ``nvcc``
    each, all started together."""
    todo = [n for n in names if n not in _libs and not _target(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    for n, proc, tmp, out, t0 in started:
        _finish(n, proc, tmp, out, t0)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a gradient through kernel ``name``.

    The kernels are forward-only ctypes calls: their outputs carry no
    ``grad_fn``, so a backward pass would silently stop at them.  Training
    computes attention with the plain ``chunked_attention`` and never calls
    a kernel; this turns a call that would cut the gradient into an error,
    before any build or launch.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires grad; "
            "compute with the plain version (training's attention is chunked_attention), "
            "or call it under torch.no_grad()"
        )
