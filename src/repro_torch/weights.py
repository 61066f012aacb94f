"""Carry reference (JAX) parameters into the port.

``from_jax_params(model, tree)`` takes the tree of ``repro.models.LM.init``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's params: the leading layer axis of ``params["cycles"]`` is unstacked
into a list of per-layer dicts, every float leaf is cast to the model's
dtype and moved to its device, and a key the model does not have (a
prestacked ``_bundle_in``, another mixer's leaves, a head the config ties,
…) raises, as does a key it misses.  The tree holds what the model's
config asks for: an untied ``head``, the learned-position table ``pos``,
LayerNorm ``bias`` leaves, the QKV ``bias``, the GELU FFN's ``wi``/``wo``.  A
quantized leaf — the reference's ``QArray`` (any object with ``q`` and
``scale``) or the ``{"q", "scale"}`` pair a checkpoint stores for it —
becomes the port's ``QArray``: int8 codes stay int8, nibble-packed int4
bytes (uint8) stay packed, scales stay fp32.  A checkpoint stores neither
``bits`` nor the logical last dim of a packed leaf, so a uint8 leaf is
int4 and its logical last dim is the model's own: the linear's rank, or
``d_model`` for the embedding.

``load_store(directory)`` reads a ``repro/checkpoint/store.py::save``
directory (``manifest.json`` plus one ``.npy`` per '/'-joined leaf; bf16
stored as a ``u2`` view) into that same numpy tree, with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from repro_torch.quant import qarray as qt


def _check_keys(tree: dict, allowed, where: str) -> None:
    if not isinstance(tree, dict):
        raise ValueError(f"{where}: expected a dict, got {type(tree).__name__}")
    want = set(allowed)
    extra = set(tree) - want
    missing = want - set(tree)
    if extra or missing:
        raise ValueError(f"{where}: unknown keys {sorted(extra)}, missing "
                         f"{sorted(missing)}")


def _layer_keys(model) -> dict:
    """The reference's per-layer tree of ``model``: group → member → its
    leaf names (None for a norm's leaves, which are not linears)."""
    cfg, spec = model.cfg, model.specs[0]   # one layer kind in the slice

    def linear(lin, bias=False):
        return (*lin.shapes, *(("bias",) if bias else ()))

    norm = dict.fromkeys(("scale",) if cfg.norm == "rmsnorm"
                         else ("scale", "bias"))
    return {"norm1": norm,
            "mixer": {"qkv": linear(spec.mixer.qkv, cfg.qkv_bias),
                      "out": linear(spec.mixer.out)},
            "norm2": norm,
            "ffn": {name: linear(getattr(spec.ffn, name))
                    for name in spec.ffn.names}}


def from_jax_params(model, tree: dict) -> dict:
    """Reference ``LM.init`` tree (numpy leaves, float or quantized) → the
    port's params."""
    cfg = model.cfg
    top = ("embed", "final_norm", "cycles",
           *(("pos",) if cfg.pos_embed == "learned" else ()),
           *(() if cfg.tie_embeddings else ("head",)))
    _check_keys(tree, top, "params")
    layer_keys = _layer_keys(model)
    _check_keys(tree["final_norm"], layer_keys["norm1"], "params/final_norm")
    _check_keys(tree["cycles"], ("blk_0",), "params/cycles")
    dev, dt = model.device, model.dtype

    def conv(a) -> torch.Tensor:
        arr = np.asarray(a)
        if not (np.issubdtype(arr.dtype, np.floating)
                or arr.dtype.name == "bfloat16"):   # ml_dtypes' bf16
            raise ValueError(f"expected a float leaf, got {arr.dtype}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dt)

    def conv_leaf(a, last_dim: int):
        """A float leaf → tensor; a quantized leaf → QArray.  ``last_dim``:
        the leaf's logical last dim in the model."""
        if isinstance(a, dict) and set(a) == {"q", "scale"}:
            q, scale, bits, ld = a["q"], a["scale"], None, None
        elif hasattr(a, "q") and hasattr(a, "scale"):
            q, scale = a.q, a.scale
            bits, ld = getattr(a, "bits", None), getattr(a, "last_dim", None)
        else:
            return conv(a)
        q = np.array(q)         # a writable copy
        want = {np.dtype(np.int8): 8, np.dtype(np.uint8): 4}.get(q.dtype)
        if want is None or bits not in (None, want):
            raise ValueError(f"expected int8 codes or uint8 nibble pairs, got "
                             f"{q.dtype} (bits {bits})")
        if ld not in (None, last_dim) or q.shape[-1] != (
                last_dim if want == 8 else (last_dim + 1) // 2):
            raise ValueError(f"quantized leaf of last dim {ld} with "
                             f"{q.shape[-1]} stored columns; the model has "
                             f"{last_dim}")
        return qt.QArray(q=torch.from_numpy(q).to(dev),
                         scale=torch.from_numpy(
                             np.array(scale, dtype=np.float32)).to(dev),
                         bits=want, last_dim=last_dim)

    def layer(leaf, i):
        if qt.is_qarray(leaf):
            return dataclasses.replace(leaf, q=leaf.q[i].contiguous(),
                                       scale=leaf.scale[i].contiguous())
        return leaf[i].contiguous()

    blk = tree["cycles"]["blk_0"]
    _check_keys(blk, layer_keys, "params/cycles/blk_0")
    spec = model.specs[0]
    linears = {"mixer": spec.mixer, "ffn": spec.ffn}
    layers = [{} for _ in range(cfg.n_layers)]
    for group, members in layer_keys.items():
        sub = blk[group]
        where = f"params/cycles/blk_0/{group}"
        _check_keys(sub, members, where)
        for name, leaves in members.items():
            if leaves is None:      # a norm's scale or bias
                stacked = conv(sub[name])
                for i, lp in enumerate(layers):
                    lp.setdefault(group, {})[name] = stacked[i]
                continue
            _check_keys(sub[name], leaves, f"{where}/{name}")
            lin = getattr(linears[group], name)
            for leaf in leaves:
                stacked = (conv(sub[name][leaf]) if leaf == "bias" else
                           conv_leaf(sub[name][leaf], lin.shapes[leaf][-1]))
                if stacked.shape[0] != len(layers):
                    raise ValueError(f"{group}/{name}/{leaf} stacks "
                                     f"{stacked.shape[0]} layers, model has "
                                     f"{len(layers)}")
                for i, lp in enumerate(layers):
                    lp.setdefault(group, {}).setdefault(name, {})[leaf] = (
                        layer(stacked, i))
    params = {"embed": conv_leaf(tree["embed"], cfg.d_model),
              "final_norm": {k: conv(tree["final_norm"][k])
                             for k in layer_keys["norm1"]}}
    if "pos" in top:
        params["pos"] = conv(tree["pos"])
    if "head" in top:
        _check_keys(tree["head"], model.head.shapes, "params/head")
        params["head"] = {k: conv_leaf(tree["head"][k], shape[-1])
                          for k, shape in model.head.shapes.items()}
    params["layers"] = layers
    return params


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) → float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_store(directory: str) -> dict:
    """Read a ``checkpoint/store.py::save`` step directory (or the newest
    ``step_*`` inside ``directory``) into a nested dict of numpy arrays.
    bf16 leaves come back as float32 holding the same values."""
    if not os.path.exists(os.path.join(directory, "manifest.json")):
        steps = sorted(d for d in os.listdir(directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {directory}")
        directory = os.path.join(directory, steps[-1])
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    for path, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(directory, meta["file"]))
        if str(arr.dtype) != meta["dtype"]:
            if meta["dtype"] != "bfloat16":
                raise ValueError(f"{path}: stored dtype {meta['dtype']} "
                                 "cannot be read without ml_dtypes")
            arr = _bf16_to_f32(arr)
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree
