"""Structured-linear interface (counterpart of
``repro/core/structures.py``): dense, BLAST and the paper's baselines —
low-rank, Monarch, block-diagonal and Pixelfly (§4) — behind one spec,
and the grouped dispatch that runs same-input BLAST bundles (SwiGLU
gate+up) as one kernel launch and same-input block-diagonal bundles (the
RG-LRU gates) as one batched product.

A spec carries ``init(generator, dtype, device, scale)`` → params (a dict of
tensors) and ``apply(params, x)``: ``x (..., d_in) → (..., d_out)``.  BLAST
applies go through ``kernels/ops.blast_matmul`` (the CUDA kernel on the
card, its plain version on the CPU); the other kinds are plain PyTorch
products on both, as the reference runs them in XLA outside any Pallas
kernel.

Quantized storage: ``spec.quantize(params, bits)`` turns the factors into
per-block int8 or nibble-packed int4 ``QArray``s and ``spec.apply_q`` runs
them — BLAST through ``kernels/ops.blast_matmul_q`` (the int8 or int4
kernel or, with the activation mode set to "int8", the W8A8 or W4A8
kernel), the other kinds as plain products on the codes with their scales
applied to the products (weight-only whatever the activation mode, as in
the reference).  Mixed storage raises (``check_storage``).

Stacked linears (the MoE experts): E linears of one spec with their params
stacked on a leading E axis, each applied to its own input —
``stacked_init``, ``stacked_quantize`` (per expert, per block: the
reference's vmapped ``linear_quantize``) and ``stacked_apply``, a BLAST
stack as ONE batched kernel launch (``kernels/ops.blast_matmul_batched``
and its int8/int4 twins, in the current activation mode).  The rank tools
(``rank_spectrum``, ``truncate_rank``, ``pad_rank``) take a BLAST stack
too, one expert at a time, as the reference vmaps them.
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
        w = std * torch.randn((d_in, d_out), generator=generator,
                              device=generator.device)
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


def _block_diag_spec(d_in: int, d_out: int,
                     cfg: StructureConfig) -> LinearSpec:
    """b diagonal blocks W_i (q, p): y_i = x_i W_i.  Budget m·n/b: with no
    explicit rank, b grows until the params fit ``keep_ratio``, as in the
    reference."""
    b = _pick_blocks(d_in, d_out, cfg.b)
    if cfg.rank is None and cfg.keep_ratio < 1.0 / b:
        b = _pick_blocks(d_in, d_out, max(math.ceil(1.0 / cfg.keep_ratio), b))
    q, p = d_in // b, d_out // b

    def init(generator, dtype=torch.float32, device=None, scale=None):
        w = torch.randn((b, q, p), generator=generator,
                        device=generator.device) / math.sqrt(q)
        return {"w": w.to(device=device, dtype=dtype)}

    def apply(params, x):
        lead = x.shape[:-1]
        y = torch.einsum("...bq,bqp->...bp", x.reshape(*lead, b, q),
                         params["w"])
        return y.reshape(*lead, d_out)

    def apply_q(params, x):
        w = params["w"]
        lead = x.shape[:-1]
        y = torch.einsum("...bq,bqp->...bp", x.reshape(*lead, b, q),
                         qt.int_values(w).to(x.dtype))
        y = y.float() * w.scale[:, :, 0]                 # one scale a block
        return y.reshape(*lead, d_out).to(x.dtype)

    return LinearSpec(kind="block_diag", d_in=d_in, d_out=d_out,
                      shapes={"w": (b, q, p)}, init=init, apply=apply,
                      meta={"b": b},
                      quantize=_block_quantizer({"w": (1, 2)}),
                      apply_q=apply_q)


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


def _low_rank_q(d, u, x: torch.Tensor) -> torch.Tensor:
    """``(x @ w_down) @ w_up`` on per-output-channel codes, each product
    scaled after it; the hidden h is cast to x's type between the two, as
    the reference does.  Returns fp32 (x fp32 or bf16 times fp32 scales)."""
    h = (x @ qt.int_values(d).to(x.dtype)) * d.scale[0]
    return (h.to(x.dtype) @ qt.int_values(u).to(x.dtype)) * u.scale[0]


def _low_rank_init(generator, d_in: int, t: int, d_out: int, dtype, device):
    on = generator.device
    w_down = torch.randn((d_in, t), generator=generator,
                         device=on) / math.sqrt(d_in)
    w_up = torch.randn((t, d_out), generator=generator,
                       device=on) / math.sqrt(t)
    return {"w_down": w_down.to(device=device, dtype=dtype),
            "w_up": w_up.to(device=device, dtype=dtype)}


def _low_rank_spec(d_in: int, d_out: int, cfg: StructureConfig) -> LinearSpec:
    """``y = (x @ w_down) @ w_up`` with w_down (d_in, t), w_up (t, d_out);
    t from the budget t·(d_in + d_out) ≤ keep·d_in·d_out, rounded down to a
    multiple of 16 from 32 up."""
    t = cfg.rank or max(1, int(cfg.keep_ratio * d_in * d_out / (d_in + d_out)))
    if t >= 32:
        t = (t // 16) * 16

    def init(generator, dtype=torch.float32, device=None, scale=None):
        return _low_rank_init(generator, d_in, t, d_out, dtype, device)

    def apply(params, x):
        return (x @ params["w_down"]) @ params["w_up"]

    def apply_q(params, x):
        return _low_rank_q(params["w_down"], params["w_up"], x).to(x.dtype)

    return LinearSpec(kind="low_rank", d_in=d_in, d_out=d_out,
                      shapes={"w_down": (d_in, t), "w_up": (t, d_out)},
                      init=init, apply=apply, meta={"rank": t},
                      quantize=_block_quantizer({"w_down": (0,),
                                                 "w_up": (0,)}),
                      apply_q=apply_q)


def _monarch_spec(d_in: int, d_out: int, cfg: StructureConfig) -> LinearSpec:
    """Monarch (block low-rank): u = blockdiag(L) x over b input blocks, then
    R mixes across blocks.  L (b, q, k); exact form (k·c == m, c = b): R
    (k, b, c), the output laid out (c, k); otherwise the rectangular form,
    R (k, b, p) with p = m / b, the output laid out (b, p).  k is m / b,
    capped by the budget b·q·k + k·b·c ≤ keep·m·n, or the explicit rank."""
    m, n = d_out, d_in
    b = _pick_blocks(n, m, cfg.b)
    q, c, p = n // b, b, m // b
    k = m // c
    if cfg.rank is not None:
        k = cfg.rank
    else:
        k = max(1, min(k, int(cfg.keep_ratio * m * n / (b * (q + c)))))
    exact = k * c == m
    r_last = c if exact else p

    def init(generator, dtype=torch.float32, device=None, scale=None):
        on = generator.device
        L = torch.randn((b, q, k), generator=generator,
                        device=on) / math.sqrt(q)
        R = torch.randn((k, b, r_last), generator=generator,
                        device=on) / math.sqrt(k)
        return {"L": L.to(device=device, dtype=dtype),
                "R": R.to(device=device, dtype=dtype)}

    def apply(params, x):
        lead = x.shape[:-1]
        u = torch.einsum("...bq,bqk->...bk", x.reshape(*lead, b, q),
                         params["L"])
        if exact:
            y = torch.einsum("...bk,kbc->...ck", u, params["R"])
        else:
            y = torch.einsum("...bk,kbp->...bp", u, params["R"])
        return y.reshape(*lead, m)

    def apply_q(params, x):
        Lq, Rq = params["L"], params["R"]
        lead = x.shape[:-1]
        u = torch.einsum("...bq,bqk->...bk", x.reshape(*lead, b, q),
                         qt.int_values(Lq).to(x.dtype))
        u = u.float() * Lq.scale[:, :, 0]                  # (b, 1)
        if exact:
            # the contraction runs over b, so R has one scale per k
            y = torch.einsum("...bk,kbc->...ck", u, qt.int_values(Rq).float())
            y = y * Rq.scale[:, 0, 0]                      # (k,)
        else:
            y = torch.einsum("...bk,kbp->...bp", u, qt.int_values(Rq).float())
            y = y * Rq.scale[0]                            # (b, 1)
        return y.reshape(*lead, m).to(x.dtype)

    return LinearSpec(kind="monarch", d_in=d_in, d_out=d_out,
                      shapes={"L": (b, q, k), "R": (k, b, r_last)},
                      init=init, apply=apply,
                      meta={"b": b, "k": k, "exact": exact},
                      quantize=_block_quantizer(
                          {"L": (1, 2), "R": (1, 2) if exact else (0, 2)}),
                      apply_q=apply_q)


def _pixelfly_blocks(b: int) -> list[tuple[int, int]]:
    """The flat block-butterfly support: block (i, j) is live iff i == j or
    |i − j| is a power of two (Pixelated Butterfly's block-sparse part)."""
    return [(i, j) for i in range(b) for j in range(b)
            if abs(i - j) == 0 or (abs(i - j) & (abs(i - j) - 1)) == 0]


def _pixelfly_spec(d_in: int, d_out: int, cfg: StructureConfig) -> LinearSpec:
    """Pixelfly: the block-sparse butterfly W_s — its ``nnz`` live (q, p)
    blocks dense, ``w`` (nnz, q, p) — plus a low-rank term ``w_down``,
    ``w_up`` of the budget left over, present only when its rank t > 0.

    The block gather (input block of each live block) and the scatter-add
    over repeated output rows are products with fixed one-hot matrices
    (nnz, b) and (b, nnz): no loop over blocks, and their backward is a
    product too, so a step gives the same bits every run (a scatter-add by
    ``index_add_`` sums with atomics on the card)."""
    b = _pick_blocks(d_in, d_out, cfg.b)
    q, p = d_in // b, d_out // b
    live = _pixelfly_blocks(b)
    nnz = len(live)
    sparse = nnz * q * p
    t = max(0, int((cfg.keep_ratio * d_in * d_out - sparse) // (d_in + d_out)))
    if t >= 32:
        t = (t // 16) * 16
    gather = torch.zeros((nnz, b))
    scatter = torch.zeros((b, nnz))
    for e, (i, j) in enumerate(live):
        gather[e, j] = 1.0
        scatter[i, e] = 1.0
    onehot: dict = {}

    def selectors(x: torch.Tensor):
        """The one-hot matrices in x's type on x's device, made once each
        (before a CUDA graph's capture: its warm-up runs eagerly first)."""
        key = (x.device, x.dtype)
        if key not in onehot:
            onehot[key] = (gather.to(device=x.device, dtype=x.dtype),
                           scatter.to(device=x.device, dtype=x.dtype))
        return onehot[key]

    def init(generator, dtype=torch.float32, device=None, scale=None):
        std = 1.0 / math.sqrt(max(q * (2 * int(math.log2(b)) + 1 if b > 1
                                       else 1), 1))
        on = generator.device
        w = std * torch.randn((nnz, q, p), generator=generator, device=on)
        params = {"w": w.to(device=device, dtype=dtype)}
        if t:
            params.update(_low_rank_init(generator, d_in, t, d_out, dtype,
                                         device))
        return params

    def apply(params, x):
        lead = x.shape[:-1]
        g, s = selectors(x)
        xg = torch.einsum("...jq,ej->...eq", x.reshape(*lead, b, q), g)
        yb = torch.einsum("...eq,eqp->...ep", xg, params["w"])
        y = torch.einsum("...ep,ie->...ip", yb, s).reshape(*lead, d_out)
        if "w_down" in params:
            y = y + (x @ params["w_down"]) @ params["w_up"]
        return y

    def apply_q(params, x):
        w = params["w"]
        lead = x.shape[:-1]
        g, s = selectors(x)
        xg = torch.einsum("...jq,ej->...eq", x.reshape(*lead, b, q), g)
        yb = torch.einsum("...eq,eqp->...ep", xg,
                          qt.int_values(w).to(x.dtype))
        yb = yb.float() * w.scale[:, :, 0]                 # (nnz, 1)
        y = torch.einsum("...ep,ie->...ip", yb, s.float()).reshape(*lead,
                                                                   d_out)
        if "w_down" in params:
            y = y + _low_rank_q(params["w_down"], params["w_up"], x)
        return y.to(x.dtype)

    shapes = {"w": (nnz, q, p)}
    qaxes = {"w": (1, 2)}
    if t:
        shapes.update(w_down=(d_in, t), w_up=(t, d_out))
        qaxes.update(w_down=(0,), w_up=(0,))
    return LinearSpec(kind="pixelfly", d_in=d_in, d_out=d_out, shapes=shapes,
                      init=init, apply=apply,
                      meta={"b": b, "nnz": nnz, "rank": t},
                      quantize=_block_quantizer(qaxes), apply_q=apply_q)


_MAKERS = {"dense": _dense_spec, "blast": _blast_spec,
           "low_rank": _low_rank_spec, "monarch": _monarch_spec,
           "block_diag": _block_diag_spec, "pixelfly": _pixelfly_spec}


def make_linear(d_in: int, d_out: int, structure: StructureConfig | None = None,
                *, structured: bool = True) -> LinearSpec:
    """Build a linear spec. ``structured=False`` forces dense."""
    cfg = structure or StructureConfig()
    if not structured:
        cfg = StructureConfig(kind="dense")
    return _MAKERS[cfg.kind](d_in, d_out, cfg)


# ---------------------------------------------------------------------------
# Nested-rank truncation: a rank-r BLAST factor set holds every lower-rank
# model for free — keeping a subset of the rank components of U, S and V
# (or of low-rank w_down columns and w_up rows) gives a cheaper model whose
# factors are column subsets of the full ones.  This is the draft side of
# self-speculative decoding (serve/engine.py).
# ---------------------------------------------------------------------------

_RANK_AXES = {"blast": {"U": 2, "S": 2, "V": 2},
              "low_rank": {"w_down": 1, "w_up": 0}}


def rank_kind(params) -> str | None:
    """'blast' or 'low_rank' for a rank-bearing linear's param dict, else
    None (dense, Monarch, block-diagonal and Pixelfly linears pass
    truncation through).  Key-based, so it works on float and quantized
    storage alike."""
    if not isinstance(params, dict):
        return None
    core = set(params) - {"bias"}
    if core == {"U", "S", "V"}:
        return "blast"
    if core == {"w_down", "w_up"}:
        return "low_rank"
    return None


def linear_rank(params) -> int | None:
    """Rank of a rank-bearing linear (a QArray's shape is logical: ranks,
    not packed int4 bytes)."""
    kind = rank_kind(params)
    if kind is None:
        return None
    return int(params["U" if kind == "blast" else "w_down"].shape[-1])


def _as_f32(a) -> torch.Tensor:
    return qt.dequantize(a) if qt.is_qarray(a) else a.float()


def rank_spectrum(params) -> torch.Tensor | None:
    """Per-component energy e_rho, the exact squared-Frobenius contribution
    of rank component rho to the dense matrix (block rows and columns are
    disjoint, so contributions add), in fp32 (quantized factors are
    dequantized first):

      blast:    e_rho = sum_ij S[i,j,rho]^2 * |U[i,:,rho]|^2 * |V[j,:,rho]|^2
      low_rank: e_t   = |w_down[:,t]|^2 * |w_up[t,:]|^2

    None for kinds with no rank axis; (E, r) for a BLAST stack of E
    experts."""
    kind = rank_kind(params)
    if kind is None:
        return None
    if stack_size(params):
        return torch.stack([rank_spectrum(p) for p in unstack(params)])
    if kind == "low_rank":
        d, u = _as_f32(params["w_down"]), _as_f32(params["w_up"])
        return torch.sum(d * d, dim=0) * torch.sum(u * u, dim=1)
    U, S, V = (_as_f32(params[k]) for k in ("U", "S", "V"))
    su = torch.sum(U * U, dim=1)                      # (b, r)
    sv = torch.sum(V * V, dim=1)                      # (b, r)
    return torch.einsum("ijr,ir,jr->r", S * S, su, sv)


def _gather_rank(arr: torch.Tensor, idx: torch.Tensor, axis: int,
                 full: int) -> torch.Tensor:
    """Gather rank components along ``axis``; axes without the full rank
    extent (per-block scales) pass through."""
    if arr.shape[axis] != full:
        return arr
    return torch.index_select(arr, axis, idx)


def _take_rank(a, idx: torch.Tensor, axis: int, full: int):
    """Rank-gather one factor in its storage format.  int8 QArrays gather
    codes, and their scales where those have the rank's extent (low-rank
    w_down's per-column scales; BLAST's per-block scales have none and stay
    as they are).  Packed int4 with the rank on the packed (last) axis
    unpacks, gathers and repacks (bit-exact).  A gathered last axis gets
    the kept rank as its ``last_dim`` (the reference keeps the full rank
    there for int8, so its int8 draft reports the full rank in
    ``shape``)."""
    if not qt.is_qarray(a):
        return _gather_rank(a, idx, axis, full)
    scale = _gather_rank(a.scale, idx, axis, full)
    last = axis == a.q.ndim - 1
    if a.bits == 4 and last:
        v = torch.index_select(qt.int_values(a), axis, idx)
        return qt.QArray(qt.pack_int4(v), scale, bits=4,
                         last_dim=int(idx.shape[0]))
    q = _gather_rank(a.q, idx, axis, full)
    return qt.QArray(q, scale, bits=a.bits,
                     last_dim=q.shape[-1] if last else a.last_dim)


def truncate_rank(params, r_prime: int):
    """Truncate a rank-bearing linear to its ``r_prime`` highest-energy
    components; other kinds, and ``r_prime >= r``, return the params
    unchanged.

    The kept indices are sorted ascending (``sort(topk(spectrum, r'))``),
    so full-rank truncation is the identity, and since the rank
    contraction is permutation-invariant the truncated apply equals the
    full apply with the dropped components zeroed.  Float, int8 and packed
    int4 storage.  A BLAST stack of experts truncates each expert to its
    own r_prime highest-energy components (a uniform r_prime, per-expert
    choices: the reference's vmapped truncation)."""
    kind = rank_kind(params)
    if kind is None:
        return params
    if stack_size(params):
        return restack([truncate_rank(p, r_prime) for p in unstack(params)])
    full = linear_rank(params)
    r_prime = max(1, min(int(r_prime), full))
    if r_prime == full:
        return dict(params)
    idx = torch.sort(torch.topk(rank_spectrum(params), r_prime).indices).values
    axes = _RANK_AXES[kind]
    return {k: (_take_rank(v, idx, axes[k], full) if k in axes else v)
            for k, v in params.items()}


def pad_rank(params, granule: int):
    """A BLAST linear with its rank axis zero-padded to a multiple of
    ``granule`` (exact: a zero component adds nothing; int4 pads whole
    zero bytes, two zero codes each).  The BLAST wrappers pad each launch's
    factors to the tile kernel's granule; a draft truncated to arbitrary
    ranks is padded once, at load, instead.  A low-rank linear runs no tile
    kernel (two plain products) and is returned as it is: padding would
    only add work, and change the products' summation lengths."""
    if rank_kind(params) != "blast":
        return params
    r = linear_rank(params)
    r_pad = -(-r // granule) * granule
    if r_pad == r:
        return params

    def pad(a):
        if not qt.is_qarray(a):
            return torch.nn.functional.pad(a, (0, r_pad - r))
        if a.bits == 4:
            width = r_pad // 2 - a.q.shape[-1]
            return qt.QArray(torch.nn.functional.pad(a.q, (0, width)),
                             a.scale, bits=4, last_dim=r_pad)
        return qt.QArray(torch.nn.functional.pad(a.q, (0, r_pad - r)),
                         a.scale, bits=a.bits, last_dim=r_pad)

    return {k: (pad(v) if k in _RANK_AXES["blast"] else v)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Stacked linears: E linears of one spec on a leading E axis (MoE experts).
# ---------------------------------------------------------------------------


def stack_size(params) -> int:
    """E for a BLAST linear's params stacked on a leading expert axis (its
    U is (E, b, p, r)), else 0 (only BLAST experts are stacked)."""
    if rank_kind(params) != "blast" or len(params["U"].shape) != 4:
        return 0
    return int(params["U"].shape[0])


def unstack(params: Params) -> list[Params]:
    """A stack of E linears' params → E param dicts (views)."""
    def take(a, e):
        if qt.is_qarray(a):
            return qt.QArray(a.q[e], a.scale[e], bits=a.bits,
                             last_dim=a.last_dim)
        return a[e]
    return [{k: take(v, e) for k, v in params.items()}
            for e in range(stack_size(params))]


def restack(members: Sequence[Params]) -> Params:
    """E linears' param dicts of one shape and storage → their stack."""
    out = {}
    for k, v in members[0].items():
        if qt.is_qarray(v):
            out[k] = qt.QArray(torch.stack([m[k].q for m in members]),
                               torch.stack([m[k].scale for m in members]),
                               bits=v.bits, last_dim=v.last_dim)
        else:
            out[k] = torch.stack([m[k] for m in members])
    return out


def _blast_only(spec: LinearSpec) -> None:
    if spec.kind != "blast":
        raise NotImplementedError(f"stacked {spec.kind} experts are not "
                                  "ported yet (ROADMAP A7.3)")


def stacked_init(spec: LinearSpec, generator: torch.Generator, n: int,
                 dtype, device, scale=None) -> Params:
    """n BLAST linears of ``spec`` drawn in turn from ``generator`` and
    stacked."""
    _blast_only(spec)
    return restack([spec.init(generator, dtype=dtype, device=device,
                              scale=scale) for _ in range(n)])


def stacked_quantize(spec: LinearSpec, params: Params,
                     bits: int = 8) -> Params:
    """Per-expert, per-block QArrays of a stack: each expert's blocks get
    their own scales, equal bit for bit to quantizing each expert alone
    (the block axes move one axis right)."""
    _blast_only(spec)
    axes = {"U": (2, 3), "S": (3,), "V": (2, 3)}
    return {k: qt.quantize(v, bits=bits, block_axes=axes[k])
            for k, v in params.items()}


def stacked_apply(spec: LinearSpec, params: Params,
                  x: torch.Tensor) -> torch.Tensor:
    """E BLAST linears, expert e on its own rows x[e]: x (E, ..., d_in) →
    (E, ..., d_out) in x's type, ONE batched kernel launch (float, int8 or
    nibble-packed int4 factors; with the activation mode "int8" the W8A8 or
    W4A8 kernel).  Float factors go through ``BlastMatmulBatchedFn`` and
    train; quantized ones run forward only.  Counts one dispatch."""
    _blast_only(spec)
    record_dispatch(1)
    storage = check_storage(params)
    U, S, V = params["U"], params["S"], params["V"]
    if storage == "float":
        return kops.blast_matmul_batched(x, U, S, V)
    E, b = U.q.shape[:2]
    scales = (U.scale.reshape(E, b), S.scale.reshape(E, b, b),
              V.scale.reshape(E, b))
    if storage == "int4":
        return kops.blast_matmul_batched_q4(x, U.q, S.q, V.q, *scales,
                                            act=activations_mode())
    return kops.blast_matmul_batched_q(x, U.q, S.q, V.q, *scales,
                                       act=activations_mode())


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
    members of one kind, BLAST or block-diagonal, with the same d_in, block
    count b and storage (all float, all int8 or all int4); d_out and rank
    may differ (zero-padded to the group max, which is exact).  Other
    bundles return None → the caller loops per projection (the grouped
    dense path of the reference is not on a ported slice)."""
    if len(specs) < 2:
        return None
    kind = specs[0].kind
    storages = {check_storage(p) for p in params_list}
    if kind not in ("blast", "block_diag") or any(
            s.kind != kind or s.d_in != specs[0].d_in for s in specs):
        return None
    b = specs[0].meta["b"]
    if len(storages) != 1 or any(s.meta["b"] != b for s in specs):
        return None
    plan = {"kind": kind, "storage": storages.pop(), "d_in": specs[0].d_in,
            "d_outs": [s.d_out for s in specs], "b": b,
            "p": max(s.d_out // b for s in specs)}
    if kind == "blast":
        # rank from the factor arrays, not the spec (a QArray's shape is
        # logical: ranks, not packed bytes)
        plan["r"] = max(int(p["U"].shape[-1]) for p in params_list)
    return plan


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
    kernel reads them as they are stored.  Block-diagonal members stack W
    (G, b, q, p̂) — int4 unpacked to int8 codes — and quantized ones their
    per-block scales sw (G, b)."""
    if plan["kind"] == "block_diag":
        quantized = plan["storage"] != "float"
        out = {"W": torch.stack([
            _pad_to(qt.int_values(pp["w"]) if quantized else pp["w"], 2,
                    plan["p"]) for pp in params_list]).contiguous()}
        if quantized:
            out["sw"] = torch.stack([pp["w"].scale[:, 0, 0]
                                     for pp in params_list]).contiguous()
        return out
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
    ``blast_matmul_grouped_q4``, both in the current activation mode), or
    G block-diagonal ones as one batched product (codes with their block
    scales when quantized, as the reference's einsum).  Counts one
    dispatch."""
    if plan is None:
        plan = group_plan(specs, params_list)
    if plan is None:
        raise ValueError("group_apply requires a valid group_plan")
    record_dispatch(1)
    st = stacked if stacked is not None else _stack_group(params_list, plan)
    lead = x.shape[:-1]
    if plan["kind"] == "block_diag":
        b, G = plan["b"], len(specs)
        xb = x.reshape(*lead, b, plan["d_in"] // b)
        y = torch.einsum("...bq,gbqp->g...bp", xb, st["W"].to(x.dtype))
        if "sw" in st:
            y = y.float() * st["sw"].reshape(G, *([1] * len(lead)), b, 1)
        return _split_group(y.reshape(G, *lead, b * plan["p"]), plan, lead,
                            x.dtype)
    if plan["storage"] in ("int8", "int4"):
        grouped = (kops.blast_matmul_grouped_q4 if plan["storage"] == "int4"
                   else kops.blast_matmul_grouped_q)
        y = grouped(x, st["U"], st["S"], st["V"], st["su"], st["ss"],
                    st["sv"], act=activations_mode())
    else:
        y = kops.blast_matmul_grouped(x, st["U"], st["S"], st["V"])
    return _split_group(y, plan, lead, x.dtype)
