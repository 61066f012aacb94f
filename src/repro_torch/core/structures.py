"""Structured-linear interface, main-path part (counterpart of
``repro/core/structures.py``): dense and BLAST linears behind one spec, and
the grouped dispatch that runs same-input BLAST bundles (SwiGLU gate+up) as
one kernel launch.

A spec carries ``init(generator, dtype, device, scale)`` → params (a dict of
tensors) and ``apply(params, x)``: ``x (..., d_in) → (..., d_out)``.  BLAST
applies go through ``kernels/ops.blast_matmul`` (the CUDA kernel on the
card, its plain version on the CPU).

Quantized storage: ``spec.quantize(params, bits)`` turns the factors into
per-block int8 or nibble-packed int4 ``QArray``s and ``spec.apply_q`` runs
them — BLAST through ``kernels/ops.blast_matmul_q`` (the int8 or int4
kernel or, with the activation mode set to "int8", the W8A8 or W4A8
kernel), dense as a plain matmul on the codes.  Mixed storage raises
(``check_storage``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.configs.base import StructureConfig
from repro_torch.core import blast as blast_lib
from repro_torch.kernels import ops as kops
from repro_torch.quant import qarray as qt

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    kind: str
    d_in: int
    d_out: int
    shapes: dict[str, tuple[int, ...]]
    init: Callable[..., Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    quantize: Callable[..., Params]            # params → QArray params
    apply_q: Callable[[Params, torch.Tensor], torch.Tensor]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def check_storage(params: Params) -> str:
    """The storage of one linear's params (the reference's ``_storage``):
    'float', 'int8' or 'int4'.  The bias, always float, does not count.  A
    mix of storages and an integer tensor without scales raise."""
    kinds = set()
    for k, v in params.items():
        if k == "bias":
            continue
        if qt.is_qarray(v):
            kinds.add(f"int{v.bits}")
        elif v.is_floating_point():
            kinds.add("float")
        else:
            raise TypeError(f"{k} is a bare {v.dtype} tensor: integer "
                            "weights are QArrays (codes with their scales)")
    if len(kinds) > 1:
        raise NotImplementedError(
            f"mixed storage {sorted(k for k in params if k != 'bias')}: a "
            "linear's factors are all float, all int8 or all int4")
    return kinds.pop() if kinds else "float"


def _block_quantizer(block_axes: dict[str, tuple[int, ...]]):
    """A ``quantize(params, bits)`` that maps each named param to a
    per-block QArray (params not listed — e.g. bias — pass through)."""
    def quantize(params: Params, bits: int = 8) -> Params:
        return {k: (v if block_axes.get(k) is None else
                    qt.quantize(v, bits=bits, block_axes=block_axes[k]))
                for k, v in params.items()}
    return quantize


def _pick_blocks(d_in: int, d_out: int, b: int) -> int:
    """Largest b' ≤ b dividing both dims."""
    bb = min(b, d_in, d_out)
    while bb > 1 and (d_in % bb or d_out % bb):
        bb -= 1
    return max(bb, 1)


def _dense_spec(d_in: int, d_out: int, cfg: StructureConfig) -> LinearSpec:
    def init(generator, dtype=torch.float32, device=None, scale=None):
        std = scale if scale is not None else 1.0 / math.sqrt(d_in)
        w = std * torch.randn((d_in, d_out), generator=generator)
        return {"w": w.to(device=device, dtype=dtype)}

    def apply(params, x):
        return x @ params["w"]

    def apply_q(params, x):
        w = params["w"]
        y = x @ qt.int_values(w).to(x.dtype)     # codes are exact in bf16
        return (y * w.scale[0]).to(x.dtype)      # per-output-channel dequant

    return LinearSpec(kind="dense", d_in=d_in, d_out=d_out,
                      shapes={"w": (d_in, d_out)}, init=init, apply=apply,
                      quantize=_block_quantizer({"w": (0,)}), apply_q=apply_q)


def _blast_spec(d_in: int, d_out: int, cfg: StructureConfig) -> LinearSpec:
    m, n = d_out, d_in
    b = _pick_blocks(n, m, cfg.b)
    r = cfg.rank or blast_lib.rank_for_compression(m, n, b, cfg.keep_ratio,
                                                   align=16)
    p, q = m // b, n // b

    def init(generator, dtype=torch.float32, device=None, scale=None):
        U, S, V = blast_lib.init(generator, m, n, b, r, dtype=dtype,
                                 device=device)
        return {"U": U, "S": S, "V": V}

    def apply(params, x):
        return kops.blast_matmul(x, params["U"], params["S"], params["V"])

    def apply_q(params, x):
        return kops.blast_matmul_q(x, params["U"], params["S"], params["V"],
                                   act=activations_mode())

    return LinearSpec(
        kind="blast", d_in=d_in, d_out=d_out,
        shapes={"U": (b, p, r), "S": (b, b, r), "V": (b, q, r)},
        init=init, apply=apply, meta={"b": b, "r": r},
        # one scale per U_i / V_j factor block, one per s_ij coupling vector
        quantize=_block_quantizer({"U": (1, 2), "S": (2,), "V": (1, 2)}),
        apply_q=apply_q)


_MAKERS = {"dense": _dense_spec, "blast": _blast_spec}


def make_linear(d_in: int, d_out: int, structure: StructureConfig | None = None,
                *, structured: bool = True) -> LinearSpec:
    """Build a linear spec. ``structured=False`` forces dense."""
    cfg = structure or StructureConfig()
    if not structured:
        cfg = StructureConfig(kind="dense")
    if cfg.kind not in _MAKERS:
        raise NotImplementedError(
            f"structure {cfg.kind!r} is not ported yet (ROADMAP A7)")
    return _MAKERS[cfg.kind](d_in, d_out, cfg)


# ---------------------------------------------------------------------------
# Activation mode, dispatch counter and grouped dispatch.
# ---------------------------------------------------------------------------

_DISPATCHES = [0]      # structured-matmul dispatch counter
_ACT_MODE = ["none"]   # activation storage of quantized applies


def set_activations(mode: str) -> None:
    """Select the activation storage of quantized BLAST applies ("none":
    float activations, the int8- or int4-weight kernels; "int8": per-token
    codes, the W8A8 or W4A8 kernels).  Process-wide as in the reference; the engine scopes it
    to its own steps with ``activations``."""
    if mode not in ("none", "int8"):
        raise ValueError(f"activation mode must be 'none'|'int8', got {mode}")
    _ACT_MODE[0] = mode


def activations_mode() -> str:
    return _ACT_MODE[0]


@contextlib.contextmanager
def activations(mode: str):
    """Select the activation storage for the duration of the block."""
    prev = _ACT_MODE[0]
    set_activations(mode)
    try:
        yield
    finally:
        _ACT_MODE[0] = prev


def record_dispatch(n: int = 1) -> None:
    """Count one projection-matmul dispatch (== one kernel launch on the
    CUDA path) where the apply runs in Python: every eager step, and a CUDA
    graph's capture but not its replays — as the reference's counter counts
    traces, not calls of a jitted step."""
    _DISPATCHES[0] += n


def dispatch_count() -> int:
    return _DISPATCHES[0]


def reset_dispatch_count() -> None:
    _DISPATCHES[0] = 0


def group_plan(specs: Sequence[LinearSpec],
               params_list: Sequence[Params]) -> dict | None:
    """Can these same-input linears run as one grouped launch?  Eligible: ≥2
    BLAST members with the same d_in, block count b and storage (all float,
    all int8 or all int4); d_out and rank may differ (zero-padded to the
    group max, which is exact).  Other bundles return None → the caller
    loops per projection (the grouped dense and block-diagonal paths of the
    reference are not on this slice)."""
    if len(specs) < 2:
        return None
    storages = {check_storage(p) for p in params_list}
    if any(s.kind != "blast" or s.d_in != specs[0].d_in for s in specs):
        return None
    b = specs[0].meta["b"]
    if len(storages) != 1 or any(s.meta["b"] != b for s in specs):
        return None
    return {"kind": "blast", "storage": storages.pop(), "d_in": specs[0].d_in,
            "d_outs": [s.d_out for s in specs], "b": b,
            "p": max(s.d_out // b for s in specs),
            # rank from the factor arrays, not the spec (a QArray's shape
            # is logical: ranks, not packed bytes)
            "r": max(int(p["U"].shape[-1]) for p in params_list)}


def _pad_to(a: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    if a.shape[axis] == size:
        return a
    shape = list(a.shape)
    shape[axis] = size - a.shape[axis]
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _split_group(y: torch.Tensor, plan: dict, lead: tuple[int, ...],
                 dtype) -> list[torch.Tensor]:
    """(G, ..., m̂) grouped output → per-member (..., d_out) slices."""
    outs = []
    b = plan["b"]
    for g, d_out in enumerate(plan["d_outs"]):
        yg = y[g]
        p_hat = yg.shape[-1] // b
        p_g = d_out // b
        if p_g != p_hat:
            yg = yg.reshape(*lead, b, p_hat)[..., :p_g]
        outs.append(yg.reshape(*lead, d_out).to(dtype))
    return outs


def _stack_group(params_list: Sequence[Params], plan: dict) -> Params:
    """Pad each member's factors (int8: codes) to (b, width, r̂) and stack
    over G; quantized bundles also stack their scales su/sv (G, b), ss
    (G, b, b).  int4 members stack *packed*: the byte axis pads to
    ⌈r̂/2⌉ with zero bytes (two zero codes each), so the grouped int4
    kernel reads them as they are stored."""
    b, p_hat, r_hat = plan["b"], plan["p"], plan["r"]
    q = plan["d_in"] // b
    packed = plan["storage"] == "int4"
    r_tgt = (r_hat + 1) // 2 if packed else r_hat

    def codes(a):
        if not qt.is_qarray(a):
            return a
        return a.q if packed else qt.int_values(a)

    def stack(name: str, width: int):
        return torch.stack([_pad_to(_pad_to(codes(pp[name]), 2, r_tgt), 1,
                                    width)
                            for pp in params_list]).contiguous()

    out = {"U": stack("U", p_hat), "S": stack("S", b), "V": stack("V", q)}
    if plan["storage"] in ("int8", "int4"):
        for key, name, shape in (("su", "U", (b,)), ("ss", "S", (b, b)),
                                 ("sv", "V", (b,))):
            out[key] = torch.stack([pp[name].scale.reshape(shape)
                                    for pp in params_list]).contiguous()
    return out


@dataclasses.dataclass
class GroupBundle:
    """Pre-stacked grouped-projection factors, built once at engine load by
    ``prestack``; a bundle whose plan no longer matches is ignored."""
    arrays: Params
    plan: dict


def prestack(specs: Sequence[LinearSpec],
             params_list: Sequence[Params]) -> GroupBundle | None:
    plan = group_plan(specs, params_list)
    if plan is None:
        return None
    core = [{k: v for k, v in p.items() if k != "bias"} for p in params_list]
    return GroupBundle(_stack_group(core, plan), plan)


def group_apply(specs: Sequence[LinearSpec], params_list: Sequence[Params],
                x: torch.Tensor, *, plan: dict | None = None,
                stacked: Params | None = None) -> list[torch.Tensor]:
    """Apply G congruent same-input BLAST linears as ONE grouped kernel
    launch (``kernels/ops.blast_matmul_grouped``; for int8 bundles
    ``blast_matmul_grouped_q`` and for int4 bundles
    ``blast_matmul_grouped_q4``, both in the current activation mode).
    Counts one dispatch."""
    if plan is None:
        plan = group_plan(specs, params_list)
    if plan is None:
        raise ValueError("group_apply requires a valid group_plan")
    record_dispatch(1)
    st = stacked if stacked is not None else _stack_group(params_list, plan)
    lead = x.shape[:-1]
    if plan["storage"] in ("int8", "int4"):
        grouped = (kops.blast_matmul_grouped_q4 if plan["storage"] == "int4"
                   else kops.blast_matmul_grouped_q)
        y = grouped(x, st["U"], st["S"], st["V"], st["su"], st["ss"],
                    st["sv"], act=activations_mode())
    else:
        y = kops.blast_matmul_grouped(x, st["U"], st["S"], st["V"])
    return _split_group(y, plan, lead, x.dtype)
