"""Build and load the port's CUDA kernels.

Every ``kernels/csrc/*.cu`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  All sources are compiled together, one ``nvcc``
process each, the first time any kernel is needed.  Outputs go to
``build/kernels/`` at the repository root; the file name carries a hash of
the source and flags, so an edited source is rebuilt and a stale library is
never loaded.  A failed build or load raises with nvcc's output.  ptxas
reports each kernel's registers and spills (``-Xptxas=-v``); the log of
every build is kept in ``build_logs``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
build_seconds: dict[str, float] = {}
build_logs: dict[str, str] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda"
                       "/bin): the CUDA kernels cannot be built")


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source that has no up-to-date library, all nvcc
    processes started together.  Returns name → library path."""
    srcs = sources()
    out = {name: _target(src) for name, src in srcs.items()}
    todo = {name: src for name, src in srcs.items() if not out[name].exists()}
    if not todo:
        return out
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, src in todo.items():
        tmp = out[name].with_suffix(f".tmp{os.getpid()}")
        procs[name] = (tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {todo[name].name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (building all at first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            try:
                lib = ctypes.CDLL(str(paths[name]))
            except OSError as exc:
                raise RuntimeError(f"cannot load {paths[name]}: {exc}") from exc
            _LIBS[name] = lib
        return lib


def refuse_grad(what: str, *tensors) -> None:
    """A kernel's output has no autograd graph.  Raise, rather than return a
    detached result, when grad mode is on and an input requires grad: the
    caller bypassed the kernel's ``torch.autograd.Function`` in
    ``kernels/ops.py`` (autograd runs ``Function.forward`` with grad mode
    off, so the Functions' own launches pass)."""
    import torch
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, and the kernel's output would "
            "carry no gradient; call it through kernels/ops.py's autograd "
            "Function (or under torch.no_grad())")


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
