"""Carry reference (JAX) parameters into the port.

``from_jax_params(model, tree)`` takes the tree of ``repro.models.LM.init``
as numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's params: the reference stacks the layers of each position j of the
layer pattern (P positions) on the leading axis of
``params["cycles"]["blk_j"]`` and keeps the layers past the last whole
cycle as ``tail_0``, ``tail_1``, …, and a MoE model's first dense layers
before them as ``pre_0``, ``pre_1``, …; the port's layers are the
``pre_i``, then layer i past them ``cycles.blk_{i % P}[i // P]``, then the
tails in order.  DeepSeek-V3's ``mtp`` subtree (its
multi-token-prediction head, which the port does not build: ROADMAP A11)
is dropped by name.  Every float leaf is cast to the model's dtype and
moved to its device — the RG-LRU's decay ``lam`` and the SSD's ``A_log``,
``D`` and ``dt_bias`` stay fp32, as the reference keeps them — and a key
the model does not have (a prestacked ``_bundle_in``, another mixer's
leaves, a head the config ties, …) raises, as does a key it misses.  The tree holds what the
model's config asks for: an untied ``head``, the learned-position table
``pos``, LayerNorm ``bias`` leaves, the QKV ``bias``, the GELU FFN's
``wi``/``wo``, MLA's ``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``out`` and
its ``q_norm`` and ``kv_norm``, the RG-LRU's linears (its block-diagonal
gates with their ``bias``), ``conv_w``, ``conv_b`` and ``lam``, the SSD's ``in_proj``,
``out_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and its
gated norm's ``scale`` (and no ``norm2``/``ffn`` in a block without an
FFN), a MoE FFN's dense fp32 ``router``, its experts' ``wi`` and ``wo``
with their leading expert axis kept (each layer's a stack, float or
quantized: a QArray's codes and scales keep the axis too) and a shared
expert's ``gate``, ``up`` and ``wo``.  A
quantized leaf — the reference's ``QArray`` (any object with ``q`` and
``scale``) or the ``{"q", "scale"}`` pair a checkpoint stores for it —
becomes the port's ``QArray``: int8 codes stay int8, nibble-packed int4
bytes (uint8) stay packed, scales stay fp32.  A checkpoint stores neither
``bits`` nor the logical last dim of a packed leaf, so a uint8 leaf is
int4 and its logical last dim is the model's own: the linear's rank, or
``d_model`` for the embedding.

``plan_from_jax(plan)`` maps a speculative draft plan (name → rank, from
the reference's ``LM.draft_plan``) onto the port's names, one to one: the
reference names a linear of pattern position j of its scanned cycles
``cycles.blk_j.<group>.<name>`` (one rank for every cycle) and one of a
tail layer ``tail_t.<group>.<name>``, and one of a first dense layer
``pre_i.<group>.<name>``; the port ``layers.<group>.<name>`` for a
one-position pattern and ``layers.blk_j.…``, ``layers.tail_t.…``
otherwise, and ``layers.pre_i.…`` (``LM.rank_spectra``), e.g.
``cycles.blk_0.ffn.gate`` ↔ ``layers.ffn.gate`` (a dense model), ``cycles.blk_2.mixer.qkv`` ↔
``layers.blk_2.mixer.qkv`` (the hybrid), ``cycles.blk_0.ffn.wi`` ↔
``layers.ffn.wi`` (the experts' stack of a MoE model: one rank for every
expert of every layer).

``load_store(directory)`` reads a ``repro/checkpoint/store.py::save``
directory (``manifest.json`` plus one ``.npy`` per '/'-joined leaf; bf16
stored as a ``u2`` view) into that same numpy tree, with numpy alone.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

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


_F32 = "fp32"   # a plain leaf kept in fp32 (the RG-LRU's decay, SSD gates)
_FP32_LINEARS = {("ffn", "router")}   # linears the reference keeps in fp32


def _layer_keys(model, spec) -> dict:
    """The reference's per-layer tree of one layer of ``spec``: group →
    member → its leaf names (a tuple: a linear), a dict of plain float
    leaves (the SSD's gated norm), None (a plain float leaf: a norm's scale
    or bias, the conv) or ``_F32`` (a plain leaf kept fp32)."""
    cfg = model.cfg

    def linear(lin, bias=False):
        return (*lin.shapes, *(("bias",) if bias else ()))

    norm = dict.fromkeys(("scale",) if cfg.norm == "rmsnorm"
                         else ("scale", "bias"))
    mx = spec.mixer
    if spec.kind == "rglru":
        mixer = {name: linear(getattr(mx, name), name.startswith("gate"))
                 for name in ("in_x", "in_gate", "out", "gate_a", "gate_x")}
        mixer.update(conv_w=None, conv_b=None, lam=_F32)
    elif spec.kind == "ssd":
        mixer = {"in_proj": linear(mx.in_proj), "out_proj": linear(mx.out_proj),
                 "conv_w": None, "conv_b": None, "A_log": _F32, "D": _F32,
                 "dt_bias": _F32, "norm": {"scale": None}}
    elif spec.kind == "mla":
        mixer = {name: linear(getattr(mx, name)) for name in
                 ("wq_a", "wq_b", "wkv_a", "wkv_b", "out")}
        mixer.update(q_norm={"scale": None}, kv_norm={"scale": None})
    else:
        mixer = {"qkv": linear(mx.qkv, cfg.qkv_bias), "out": linear(mx.out)}
    keys = {"norm1": norm, "mixer": mixer}
    if spec.moe:
        ffn = {name: linear(getattr(spec.ffn, name))
               for name in ("router", "wi", "wo")}
        if spec.ffn.shared is not None:   # a dict of linears
            ffn["shared"] = {name: linear(getattr(spec.ffn.shared, name))
                             for name in spec.ffn.shared.names}
        keys.update(norm2=norm, ffn=ffn)
    elif spec.ffn is not None:
        keys.update(norm2=norm, ffn={name: linear(getattr(spec.ffn, name))
                                     for name in spec.ffn.names})
    return keys


def from_jax_params(model, tree: dict) -> dict:
    """Reference ``LM.init`` tree (numpy leaves, float or quantized) → the
    port's params."""
    cfg = model.cfg
    P = len(cfg.pattern)
    n_pre = model.n_dense
    n_cycles, n_tail = divmod(cfg.n_layers - n_pre, P)
    top = ("embed", "final_norm", *(("cycles",) if n_cycles else ()),
           *(f"pre_{i}" for i in range(n_pre)),
           *(f"tail_{t}" for t in range(n_tail)),
           *(("pos",) if cfg.pos_embed == "learned" else ()),
           *(() if cfg.tie_embeddings else ("head",)),
           *(("mtp",) if cfg.mtp else ()))
    _check_keys(tree, top, "params")
    norm_keys = _layer_keys(model, model.specs[0])["norm1"]
    _check_keys(tree["final_norm"], norm_keys, "params/final_norm")
    if n_cycles:
        _check_keys(tree["cycles"], [f"blk_{j}" for j in range(P)],
                    "params/cycles")
    dev, dt = model.device, model.dtype

    def conv(a, dtype=dt) -> torch.Tensor:
        arr = np.asarray(a)
        if not (np.issubdtype(arr.dtype, np.floating)
                or arr.dtype.name == "bfloat16"):   # ml_dtypes' bf16
            raise ValueError(f"expected a float leaf, got {arr.dtype}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    def conv_leaf(a, last_dim: int, dtype=dt):
        """A float leaf → tensor (of ``dtype``); a quantized leaf → QArray.
        ``last_dim``: the leaf's logical last dim in the model."""
        if isinstance(a, dict) and set(a) == {"q", "scale"}:
            q, scale, bits, ld = a["q"], a["scale"], None, None
        elif hasattr(a, "q") and hasattr(a, "scale"):
            q, scale = a.q, a.scale
            bits, ld = getattr(a, "bits", None), getattr(a, "last_dim", None)
        else:
            return conv(a, dtype)
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

    def unstacked(leaf):
        """A tail layer's leaf with the leading layer axis of a cycle's."""
        if qt.is_qarray(leaf):
            return dataclasses.replace(leaf, q=leaf.q[None],
                                       scale=leaf.scale[None])
        return leaf[None]

    layers = [{} for _ in range(cfg.n_layers)]

    def fill(blk, where: str, idx: list[int], stacked: bool) -> None:
        """Carry the reference's layer tree ``blk`` into ``layers[i]`` for
        i in ``idx``: the leading axis of each leaf when ``stacked``."""
        spec = model.specs[idx[0]]
        layer_keys = _layer_keys(model, spec)
        _check_keys(blk, layer_keys, where)
        linears = {"mixer": spec.mixer, "ffn": spec.ffn}

        def put(group, path, leaf):
            if not stacked:
                leaf = unstacked(leaf)
            if leaf.shape[0] != len(idx):
                raise ValueError(f"{where}/{group}/{'/'.join(path)} stacks "
                                 f"{leaf.shape[0]} layers, want {len(idx)}")
            for n, i in enumerate(idx):
                node = layers[i].setdefault(group, {})
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = layer(leaf, n)

        for group, members in layer_keys.items():
            sub = blk[group]
            _check_keys(sub, members, f"{where}/{group}")
            for name, leaves in members.items():
                if leaves is None or leaves == _F32:
                    put(group, (name,), conv(sub[name], torch.float32
                                             if leaves == _F32 else dt))
                    continue
                _check_keys(sub[name], leaves, f"{where}/{group}/{name}")
                if isinstance(leaves, dict):
                    for leaf, inner in leaves.items():
                        if inner is None:
                            put(group, (name, leaf), conv(sub[name][leaf]))
                            continue
                        # a linear of a sub-FFN (the shared expert)
                        where_ = f"{where}/{group}/{name}/{leaf}"
                        _check_keys(sub[name][leaf], inner, where_)
                        lin = getattr(getattr(linears[group], name), leaf)
                        for k in inner:
                            put(group, (name, leaf, k), conv_leaf(
                                sub[name][leaf][k], lin.shapes[k][-1]))
                    continue
                lin = getattr(linears[group], name)
                fp32 = (group, name) in _FP32_LINEARS
                for leaf in leaves:
                    put(group, (name, leaf),
                        conv(sub[name][leaf]) if leaf == "bias" else
                        conv_leaf(sub[name][leaf], lin.shapes[leaf][-1],
                                  torch.float32 if fp32 else dt))

    for i in range(n_pre):
        fill(tree[f"pre_{i}"], f"params/pre_{i}", [i], stacked=False)
    for j in range(P if n_cycles else 0):
        fill(tree["cycles"][f"blk_{j}"], f"params/cycles/blk_{j}",
             list(range(n_pre + j, n_pre + n_cycles * P, P)), stacked=True)
    for t in range(n_tail):
        fill(tree[f"tail_{t}"], f"params/tail_{t}",
             [n_pre + n_cycles * P + t], stacked=False)
    params = {"embed": conv_leaf(tree["embed"], cfg.d_model),
              "final_norm": {k: conv(tree["final_norm"][k])
                             for k in norm_keys}}
    if "pos" in top:
        params["pos"] = conv(tree["pos"])
    if "head" in top:
        _check_keys(tree["head"], model.head.shapes, "params/head")
        params["head"] = {k: conv_leaf(tree["head"][k], shape[-1])
                          for k, shape in model.head.shapes.items()}
    params["layers"] = layers
    return params


def plan_from_jax(plan: dict[str, int]) -> dict[str, int]:
    """A reference draft plan → the port's names (see the module doc)."""
    cycle = re.compile(r"cycles\.blk_(\d+)\.(.*)")
    parts = []
    for name, r in plan.items():
        m = cycle.fullmatch(name)
        if m:
            parts.append((f"blk_{m[1]}", m[2], r))
        elif re.match(r"(tail|pre)_\d+\.", name):
            group, rest = name.split(".", 1)
            parts.append((group, rest, r))
        else:
            raise ValueError(f"draft-plan entry {name!r} is not a linear of "
                             "the reference's cycles, tail or first dense "
                             "layers")
    one = {g for g, _, _ in parts if not g.startswith("pre_")} == {"blk_0"}
    return {f"layers.{rest}" if one and group == "blk_0"
            else f"layers.{group}.{rest}": int(r)
            for group, rest, r in parts}


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
