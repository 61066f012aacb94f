"""Checkpoints (counterpart of ``repro/checkpoint/store.py``), in the
reference's on-disk format:

    <dir>/step_<n:08d>/
        manifest.json    step; per leaf: file, shape, dtype, sha256_16
        <leafpath>.npy   one file per leaf ('/'-joined keys, '/' → '__')

bf16 leaves are stored as their ``u2`` bit patterns with dtype
"bfloat16" in the manifest; a QArray leaf stores its codes and scales as
``…/q`` and ``…/scale``.  Writes go to ``step_<n>.tmp`` and are renamed
once the manifest (written last) is fsync'd, so a killed writer never
leaves a step that ``latest_step`` would pick up.  The port writes its own
tree paths (``params/layers/<i>/…``: a list of per-layer dicts, where the
reference stacks layers under ``params/cycles``);
``weights.load_store`` reads the reference's layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.quant import qarray as qt

SEP = "/"


def _flatten(tree, prefix="") -> dict[str, Any]:
    out = {}
    if qt.is_qarray(tree):
        out[f"{prefix}q"] = tree.q
        out[f"{prefix}scale"] = tree.scale
    elif isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{SEP}"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(skeleton, flat: dict, prefix=""):
    if qt.is_qarray(skeleton):
        return dataclasses.replace(
            skeleton, q=_leaf(skeleton.q, flat[f"{prefix}q"]),
            scale=_leaf(skeleton.scale, flat[f"{prefix}scale"]))
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{SEP}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten_into(v, flat, f"{prefix}{i}{SEP}")
                              for i, v in enumerate(skeleton))
    if skeleton is None:
        return None
    return _leaf(skeleton, flat[prefix[:-1]])


def _leaf(skeleton, t: torch.Tensor):
    """A restored tensor on the skeleton leaf's device and in its type."""
    if isinstance(skeleton, torch.Tensor):
        return t.to(device=skeleton.device, dtype=skeleton.dtype)
    return t


def _host(leaf) -> torch.Tensor:
    """A detached CPU copy (the live tensor is updated in place later)."""
    return torch.as_tensor(leaf).detach().to("cpu", copy=True)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(array to store, true dtype): bf16 as its uint16 bit patterns."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored dtype {arr.dtype}, manifest says {dtype}")
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree, *, hash_leaves: bool = True) -> str:
    """Atomic checkpoint write.  Returns the committed path."""
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for path, leaf in flat.items():
        arr, true_dtype = _to_numpy(_host(leaf))
        fname = path.replace(SEP, "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        digest = (hashlib.sha256(arr.tobytes()).hexdigest()[:16]
                  if hash_leaves else "")
        manifest["leaves"][path] = {
            "file": fname, "shape": list(arr.shape), "dtype": true_dtype,
            "sha256_16": digest}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(directory: str, step: int, skeleton, *, verify: bool = True):
    """Load ``step`` into the structure of ``skeleton``; each leaf takes the
    skeleton leaf's device and type."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for leaf_path, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and meta["sha256_16"]:
            digest = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
            if digest != meta["sha256_16"]:
                raise IOError(f"checkpoint corruption in {leaf_path}")
        flat[leaf_path] = _from_numpy(arr, meta["dtype"])
    return _unflatten_into(skeleton, flat)


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; commits asynchronously."""

    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree):
        self.wait()
        # host copies on the caller's thread: the live tensors are updated
        # in place by the next step.  A flat {'/'-joined path: leaf} dict
        # flattens to the same paths as the tree it came from.
        host = {k: _host(v) for k, v in _flatten(tree).items()}

        def work():
            save(self.directory, step, host, hash_leaves=True)
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, skeleton):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return restore(self.directory, step, skeleton), step
