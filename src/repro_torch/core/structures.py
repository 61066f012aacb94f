"""Structured-linear interface, main-path part (counterpart of
``repro/core/structures.py``): dense and BLAST linears behind one spec, and
the grouped dispatch that runs same-input BLAST bundles (SwiGLU gate+up) as
one kernel launch.

A spec carries ``init(generator, dtype, device, scale)`` → params (a dict of
tensors) and ``apply(params, x)``: ``x (..., d_in) → (..., d_out)``.  BLAST
applies go through ``kernels/ops.blast_matmul`` (the CUDA kernel on the
card, its plain version on the CPU).  Integer (int8/int4) storage is not
ported yet (ROADMAP A9) and raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from repro_torch.configs.base import StructureConfig
from repro_torch.core import blast as blast_lib
from repro_torch.kernels import ops as kops

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    kind: str
    d_in: int
    d_out: int
    shapes: dict[str, tuple[int, ...]]
    init: Callable[..., Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


def check_float(params: Params) -> None:
    """Integer factor storage belongs to a later slice."""
    for k, v in params.items():
        if not v.is_floating_point():
            raise NotImplementedError(
                f"{k} is stored as {v.dtype}: int8/int4 storage is not ported "
                "yet (ROADMAP A9)")


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

    return LinearSpec(kind="dense", d_in=d_in, d_out=d_out,
                      shapes={"w": (d_in, d_out)}, init=init, apply=apply)


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

    return LinearSpec(
        kind="blast", d_in=d_in, d_out=d_out,
        shapes={"U": (b, p, r), "S": (b, b, r), "V": (b, q, r)},
        init=init, apply=apply, meta={"b": b, "r": r})


_MAKERS = {"dense": _dense_spec, "blast": _blast_spec}


def make_linear(d_in: int, d_out: int, structure: StructureConfig | None = None,
                *, structured: bool = True) -> LinearSpec:
    """Build a linear spec. ``structured=False`` forces dense."""
    cfg = structure or StructureConfig()
    if not structured:
        cfg = StructureConfig(kind="dense")
    if cfg.kind not in _MAKERS:
        raise NotImplementedError(
            f"structure {cfg.kind!r} is not ported yet (ROADMAP A13)")
    return _MAKERS[cfg.kind](d_in, d_out, cfg)


# ---------------------------------------------------------------------------
# Dispatch counter and grouped dispatch.
# ---------------------------------------------------------------------------

_DISPATCHES = [0]      # structured-matmul dispatch counter


def record_dispatch(n: int = 1) -> None:
    """Count one projection-matmul dispatch (== one kernel launch on the
    CUDA path)."""
    _DISPATCHES[0] += n


def dispatch_count() -> int:
    return _DISPATCHES[0]


def reset_dispatch_count() -> None:
    _DISPATCHES[0] = 0


def group_plan(specs: Sequence[LinearSpec],
               params_list: Sequence[Params]) -> dict | None:
    """Can these same-input linears run as one grouped launch?  Eligible: ≥2
    float BLAST members with the same d_in and block count b; d_out and rank
    may differ (zero-padded to the group max, which is exact).  Other
    bundles return None → the caller loops per projection (the grouped dense
    and block-diagonal paths of the reference are not on this slice)."""
    if len(specs) < 2:
        return None
    for p in params_list:
        check_float({k: v for k, v in p.items() if k != "bias"})
    if any(s.kind != "blast" or s.d_in != specs[0].d_in for s in specs):
        return None
    b = specs[0].meta["b"]
    if any(s.meta["b"] != b for s in specs):
        return None
    return {"kind": "blast", "storage": "float", "d_in": specs[0].d_in,
            "d_outs": [s.d_out for s in specs], "b": b,
            "p": max(s.d_out // b for s in specs),
            # rank from the factor arrays, not the spec
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
    """Pad each member's factors to (b, width, r̂) and stack over G."""
    b, p_hat, r_hat = plan["b"], plan["p"], plan["r"]
    q = plan["d_in"] // b

    def stack(name: str, width: int):
        return torch.stack([_pad_to(_pad_to(pp[name], 2, r_hat), 1, width)
                            for pp in params_list]).contiguous()

    return {"U": stack("U", p_hat), "S": stack("S", b), "V": stack("V", q)}


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
    launch (``kernels/ops.blast_matmul_grouped``).  Counts one dispatch."""
    if plan is None:
        plan = group_plan(specs, params_list)
    if plan is None:
        raise ValueError("group_apply requires a valid group_plan")
    record_dispatch(1)
    st = stacked if stacked is not None else _stack_group(params_list, plan)
    lead = x.shape[:-1]
    y = kops.blast_matmul_grouped(x, st["U"], st["S"], st["V"])
    return _split_group(y, plan, lead, x.dtype)
