"""Dispatch wrappers of the kernels on the serving path (counterpart of
``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback.  The BLAST wrappers flatten the leading axes
into T and zero-pad T and r to the kernel's tiles, as the reference wrapper
does (zero rows and zero ranks are exact).  The int8 and int4 wrappers
take per-block scales; int4 factors stay nibble-packed (uint8, two codes
per byte along r) into the kernel, and their byte axis is zero-padded to
half the padded rank (a zero byte is two zero codes).  With ``act="int8"``
they quantize x per token first (a plain-PyTorch prologue, as the reference
runs it in XLA outside its Pallas kernel) and zero-pad codes and scales
alike.  ``launches`` counts kernel
launches (plain-version calls are not counted), so a run can show that its
model path went through the kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import blast_matmul as _bm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.quant import qarray as qt

launches: dict[str, int] = {
    "blast_matmul": 0, "blast_matmul_grouped": 0,
    "blast_matmul_q": 0, "blast_matmul_grouped_q": 0,
    "blast_matmul_w8a8": 0, "blast_matmul_grouped_w8a8": 0,
    "blast_matmul_q4": 0, "blast_matmul_grouped_q4": 0,
    "blast_matmul_w4a8": 0, "blast_matmul_grouped_w4a8": 0,
    "flash_attention_prefill": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _pad_last(a: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the trailing rank axis (exact: zero ranks add nothing)."""
    if a.shape[-1] == target:
        return a.contiguous()
    return F.pad(a, (0, target - a.shape[-1])).contiguous()


def _flatten_pad_x(x: torch.Tensor, block_t: int):
    lead = x.shape[:-1]
    T = math.prod(lead)
    xf = x.reshape(T, x.shape[-1])
    T_pad = _round_up(max(T, 1), block_t)
    if T_pad != T:
        xf = F.pad(xf, (0, 0, 0, T_pad - T))
    return xf.contiguous(), lead, T


def blast_matmul(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                 V: torch.Tensor) -> torch.Tensor:
    """x (..., n) → (..., m); U (b,p,r), S (b,b,r), V (b,q,r)."""
    if _on_cpu(x):
        return ref.blast_matmul_ref(x, U, S, V)
    b, p, r = U.shape
    block_t, block_r = _bm.tiles()
    xf, lead, T = _flatten_pad_x(x, block_t)
    r_pad = _round_up(r, block_r)
    U, S, V = (_pad_last(a, r_pad)[None] for a in (U, S, V))
    y = _bm.launch(xf, U, S, V)
    launches["blast_matmul"] += 1
    return y[0, :T].reshape(*lead, b * p)


def blast_matmul_grouped(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """G congruent factor sets over one shared input in one launch:
    x (..., n); U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → (G, ..., m)."""
    if _on_cpu(x):
        return ref.blast_matmul_grouped_ref(x, U, S, V)
    G, b, p, r = U.shape
    block_t, block_r = _bm.tiles()
    xf, lead, T = _flatten_pad_x(x, block_t)
    r_pad = _round_up(r, block_r)
    U, S, V = (_pad_last(a, r_pad) for a in (U, S, V))
    y = _bm.launch(xf, U, S, V)
    launches["blast_matmul_grouped"] += 1
    return y[:, :T].reshape(G, *lead, b * p)


def _grouped_q(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
               V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
               sv: torch.Tensor, act: str, names: tuple[str, str],
               bits: int = 8) -> torch.Tensor:
    """Factor codes (G,b,·,r) — int8, or for ``bits=4`` nibble-packed uint8
    (G,b,·,r/2) — with scales su/sv (G,b), ss (G,b,b) over a shared x
    (..., n) → (G, ..., m) in x's dtype; ``names`` are the launch keys of
    the float-x and the int8-x (W8A8 / W4A8) kernel."""
    if act not in ("none", "int8"):
        raise ValueError(f"act must be 'none'|'int8', got {act!r}")
    packed = bits == 4
    G, b, p, rb = U.shape
    if _on_cpu(x):
        if act == "int8":
            lead = x.shape[:-1]
            xq, sx = qt.quantize_act(x.reshape(-1, x.shape[-1]))
            plain = (ref.blast_matmul_grouped_a4_ref if packed
                     else ref.blast_matmul_grouped_a8_ref)
            y = plain(xq, sx, U, S, V, su, ss, sv)
            return y.reshape(G, *lead, b * p).to(x.dtype)
        plain = (ref.blast_matmul_grouped_q4_ref if packed
                 else ref.blast_matmul_grouped_q_ref)
        return plain(x, U, S, V, su, ss, sv)
    block_t, block_r = _bm.tiles()
    r_pad = _round_up(2 * rb if packed else rb, block_r)     # logical ranks
    U, S, V = (_pad_last(a, r_pad // 2 if packed else r_pad)
               for a in (U, S, V))
    if act == "int8":
        lead = x.shape[:-1]
        T = math.prod(lead)
        xq, sx = qt.quantize_act(x.reshape(T, x.shape[-1]))
        T_pad = _round_up(max(T, 1), block_t)
        if T_pad != T:        # zero codes with zero scales: exact zero rows
            xq = F.pad(xq, (0, 0, 0, T_pad - T))
            sx = F.pad(sx, (0, 0, 0, T_pad - T))
        launch = _bm.launch_w4a8 if packed else _bm.launch_w8a8
        y = launch(xq.contiguous(), sx.contiguous(), U, S, V, su, ss, sv,
                   out_dtype=x.dtype)
        launches[names[1]] += 1
    else:
        xf, lead, T = _flatten_pad_x(x, block_t)
        launch = _bm.launch_q4 if packed else _bm.launch_q
        y = launch(xf, U, S, V, su, ss, sv)
        launches[names[0]] += 1
    return y[:, :T].reshape(G, *lead, b * p)


def blast_matmul_q(x: torch.Tensor, Uq: qt.QArray, Sq: qt.QArray,
                   Vq: qt.QArray, *, act: str = "none") -> torch.Tensor:
    """BLAST over per-block ``QArray`` factors (U/V: one scale per block,
    S: one per coupling vector): x (..., n) → (..., m).  int8 factors run
    the int8 kernel (``act="int8"``: W8A8); all-int4 factors stay
    nibble-packed and run the int4 kernel (``act="int8"``: W4A8)."""
    b = Uq.q.shape[0]
    scales = (Uq.scale.reshape(1, b), Sq.scale.reshape(1, b, b),
              Vq.scale.reshape(1, b))
    if {Uq.bits, Sq.bits, Vq.bits} == {4}:
        y = _grouped_q(x, Uq.q[None], Sq.q[None], Vq.q[None], *scales, act,
                       ("blast_matmul_q4", "blast_matmul_w4a8"), bits=4)
    else:
        U8, S8, V8 = (qt.int_values(a) for a in (Uq, Sq, Vq))
        y = _grouped_q(x, U8[None], S8[None], V8[None], *scales, act,
                       ("blast_matmul_q", "blast_matmul_w8a8"))
    return y[0]


def blast_matmul_grouped_q(x: torch.Tensor, U8: torch.Tensor,
                           S8: torch.Tensor, V8: torch.Tensor,
                           su: torch.Tensor, ss: torch.Tensor,
                           sv: torch.Tensor, *,
                           act: str = "none") -> torch.Tensor:
    """G congruent int8 factor sets over one shared input in one launch:
    x (..., n); codes U8 (G,b,p,r), S8 (G,b,b,r), V8 (G,b,q,r); scales
    su/sv (G,b), ss (G,b,b) → (G, ..., m).  With ``act="int8"`` x is
    quantized once for the whole bundle (grouped W8A8)."""
    return _grouped_q(x, U8, S8, V8, su, ss, sv, act,
                      ("blast_matmul_grouped_q", "blast_matmul_grouped_w8a8"))


def blast_matmul_grouped_q4(x: torch.Tensor, Up: torch.Tensor,
                            Sp: torch.Tensor, Vp: torch.Tensor,
                            su: torch.Tensor, ss: torch.Tensor,
                            sv: torch.Tensor, *,
                            act: str = "none") -> torch.Tensor:
    """G congruent nibble-packed int4 factor sets over one shared input in
    one launch: x (..., n); uint8 Up (G,b,p,r/2), Sp (G,b,b,r/2),
    Vp (G,b,q,r/2) (packed along r, the ``quant/qarray.py`` layout, and
    kept packed into the kernel); scales su/sv (G,b), ss (G,b,b) →
    (G, ..., m).  With ``act="int8"`` x is quantized once for the whole
    bundle (grouped W4A8)."""
    return _grouped_q(x, Up, Sp, Vp, su, ss, sv, act,
                      ("blast_matmul_grouped_q4", "blast_matmul_grouped_w4a8"),
                      bits=4)


def flash_attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            q_offsets: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            kv_len: int | None = None) -> torch.Tensor:
    """Chunked-prefill attention at per-row offsets: q (B, Hq, C, D),
    k, v (B, Hkv, S, D) (any strides with a contiguous last axis),
    q_offsets (B,) → (B, Hq, C, D).  The cache's slot index is the absolute
    position; keys at ``j >= kv_len`` are masked (default: all S)."""
    if _on_cpu(q):
        return ref.attention_prefill_ref(q, k, v, q_offsets, causal=causal,
                                         window=window, kv_len=kv_len)
    S_len = k.shape[2]
    o = _fa.launch(q, k, v, q_offsets, causal=causal, window=window,
                   kv_len=S_len if kv_len is None else kv_len)
    launches["flash_attention_prefill"] += 1
    return o
