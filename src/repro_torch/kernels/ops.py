"""Dispatch wrappers of the kernels (counterpart of ``repro/kernels/ops.py``).

A tensor on the CPU goes to the kernel's plain PyTorch version
(``kernels/ref.py``); a CUDA tensor launches the hand-written kernel or
raises — there is no fallback.  The BLAST wrappers flatten the leading axes
into T and zero-pad r to the kernel's rank granule, as the reference
wrapper does (zero ranks are exact); every one of them runs the tile
kernel, which masks its T edge itself.  The batched wrappers
(``blast_matmul_batched`` and its ``_q``/``_q4`` twins: the MoE experts)
take one input per factor set, x (G, ..., n); the float one trains, the
quantized ones run forward only.  The quantized wrappers take
per-block scales; int4 factors stay nibble-packed (uint8, two codes per
byte along r) into the kernel, and their byte axis is zero-padded to half
the padded rank (a zero byte is two zero codes).  With ``act="int8"`` they
quantize x per token first (a plain-PyTorch prologue, as the reference
runs it in XLA outside its Pallas kernel).  ``mla_attention`` is MLA's
latent attention (DeepSeek-V3: scores over [latent ‖ k_rope], values the
latent; its kernel replaces no Pallas kernel, the reference runs it in
XLA).  ``launches`` counts kernel
launches (plain-version
calls are not counted), so a run can show that its model path went through
the kernels; ``blast_matmul_dx`` counts the B1 launches that compute a
backward pass's dx, ``blast_matmul_batched_dx`` the batched launches that
compute the experts' dx.  A wrapper counts in Python, where it launches; a
captured CUDA graph's replays are counted by its owner
(``launches_apart``, ``add_launches``).

Training.  The float kernels that the training path launches — B1
``blast_matmul``, B2 ``blast_matmul_grouped``, the batched expert launch
``blast_matmul_batched`` and B4 ``flash_attention`` — are
``torch.autograd.Function``s on both devices: the forward dispatches
(CPU → plain version, CUDA → kernel), the backward is the same explicit
PyTorch code on both, so the CPU tests run the backward the card runs.  The
JAX package has no backward kernel (XLA differentiates its mirrors), so:

- BLAST: Aᵀ of a BLAST matrix is a BLAST matrix (U′ = V, S′ = Sᵀ over the
  two block axes, V′ = U), so dx = B1(dy; V, Sᵀ, U) runs the kernel itself
  (the experts' dx: ONE batched launch over every expert's transposed
  factors, each expert's dx its own rows);
  dU, dS and dV are einsums of the stage intermediates z = xV and
  dw = dy·U, recomputed in fp32, summed over each factor set's own rows;
- attention: P is recomputed from q and k chunk by chunk of queries (only
  each chunk's reachable keys), then dV = Pᵀ dO, dS = P ⊙ (dP − rowsum(dO ⊙
  O)), dQ = dS K / √D and dK = dSᵀ Q / √D, with dK and dV summed over the
  query heads of each kv head (GQA).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import blast_matmul as _bm
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mla_attention as _mla
from repro_torch.kernels import ref
from repro_torch.quant import qarray as qt

launches: dict[str, int] = {
    "blast_matmul": 0, "blast_matmul_grouped": 0,
    "blast_matmul_q": 0, "blast_matmul_grouped_q": 0,
    "blast_matmul_w8a8": 0, "blast_matmul_grouped_w8a8": 0,
    "blast_matmul_q4": 0, "blast_matmul_grouped_q4": 0,
    "blast_matmul_w4a8": 0, "blast_matmul_grouped_w4a8": 0,
    "blast_matmul_batched": 0, "blast_matmul_batched_q": 0,
    "blast_matmul_batched_w8a8": 0, "blast_matmul_batched_q4": 0,
    "blast_matmul_batched_w4a8": 0,
    "flash_attention_prefill": 0, "flash_attention_prefill_q8": 0,
    "flash_attention_ring": 0, "flash_attention_ring_q8": 0,
    "flash_attention": 0, "mla_attention": 0,
    "blast_matmul_dx": 0, "blast_matmul_batched_dx": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def launches_apart():
    """Keep a block's launches out of ``launches``: yields a dict that
    receives, on exit, the counts the block made, and leaves ``launches``
    as it was.  A CUDA graph's warm-up and capture run under it; the
    counts made by the capture are what every replay launches
    (``add_launches``), since a replay runs no Python."""
    before = dict(launches)
    made: dict[str, int] = {}
    try:
        yield made
    finally:
        made.update({k: v - before[k] for k, v in launches.items()
                     if v != before[k]})
        launches.update(before)


def add_launches(made: dict[str, int]) -> None:
    """Count the launches of one replay of a captured graph."""
    for name, n in made.items():
        launches[name] += n


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _pad_last(a: torch.Tensor, target: int) -> torch.Tensor:
    """Zero-pad the trailing rank axis (exact: zero ranks add nothing)."""
    if a.shape[-1] == target:
        return a.contiguous()
    return F.pad(a, (0, target - a.shape[-1])).contiguous()


def _float_launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                  V: torch.Tensor, key: str) -> torch.Tensor:
    """The float kernel on x (..., n) and stacked factors (G, b, ·, r) →
    (G, ..., m), counted under ``key``; x is flattened, not padded."""
    lead = x.shape[:-1]
    _, r_pad = _bm.padded_rank(U.shape[-1], None, _bm.float_tiles()[1])
    U, S, V = (_pad_last(a, r_pad) for a in (U, S, V))
    y = _bm.launch(x.reshape(-1, x.shape[-1]).contiguous(), U, S, V)
    launches[key] += 1
    return y.reshape(U.shape[0], *lead, y.shape[-1])


def _blast_launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                  V: torch.Tensor, key: str) -> torch.Tensor:
    """B1 on (..., n) → (..., m): the plain version on the CPU, the kernel
    (counted under ``key``) on CUDA."""
    if _on_cpu(x):
        return ref.blast_matmul_ref(x, U, S, V)
    return _float_launch(x, U[None], S[None], V[None], key)[0]


def _blast_grouped_launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                          V: torch.Tensor) -> torch.Tensor:
    if _on_cpu(x):
        return ref.blast_matmul_grouped_ref(x, U, S, V)
    return _float_launch(x, U, S, V, "blast_matmul_grouped")


def _blast_factor_grads(needs, dy, x, U, S, V):
    """dU, dS, dV (None where not needed) of y = blast(x; U, S, V) for G
    stacked factor sets: x (T, n) shared by every set, or (G, T, n) one
    input per set; dy (G, T, m); U (G,b,p,r), S (G,b,b,r), V (G,b,q,r).
    Einsums of z = xV and dw = dy·U in the accumulation type, each set's
    sums over its own T rows, cast to each factor's type."""
    dU = dS = dV = None
    if not any(needs):
        return dU, dS, dV
    G, b, p, r = U.shape
    q = V.shape[2]
    xs = "tjq" if x.ndim == 2 else "gtjq"
    xb = ref.acc(x).reshape(*x.shape[:-2], -1, b, q)
    dyb = ref.acc(dy).reshape(G, -1, b, p)
    Uf, Sf, Vf = (ref.acc(a) for a in (U, S, V))
    z = torch.einsum(f"{xs},gjqr->gtjr", xb, Vf)
    dw = torch.einsum("gtip,gipr->gtir", dyb, Uf)
    if needs[0]:
        w = torch.einsum("gtjr,gijr->gtir", z, Sf)
        dU = torch.einsum("gtip,gtir->gipr", dyb, w).to(U.dtype)
    if needs[1]:
        dS = torch.einsum("gtir,gtjr->gijr", dw, z).to(S.dtype)
    if needs[2]:
        dz = torch.einsum("gtir,gijr->gtjr", dw, Sf)
        dV = torch.einsum(f"{xs},gtjr->gjqr", xb, dz).to(V.dtype)
    return dU, dS, dV


def _blast_dx(dy: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
              V: torch.Tensor) -> torch.Tensor:
    """dx of y = blast(x; U, S, V): B1 over the transposed BLAST matrix
    (U′ = V, S′ = Sᵀ, V′ = U)."""
    return _blast_launch(dy, V, S.transpose(0, 1).contiguous(), U,
                         "blast_matmul_dx")


class BlastMatmulFn(torch.autograd.Function):
    """B1 with its backward: x (..., n) → (..., m)."""

    @staticmethod
    def forward(ctx, x, U, S, V):
        # launch before saving: a checkpointed layer's recompute stops at
        # its last save, and must still have run its last kernel
        y = _blast_launch(x, U, S, V, "blast_matmul")
        ctx.save_for_backward(x, U, S, V)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, U, S, V = ctx.saved_tensors
        dx = _blast_dx(dy, U, S, V) if ctx.needs_input_grad[0] else None
        grads = _blast_factor_grads(
            ctx.needs_input_grad[1:], dy.reshape(1, -1, dy.shape[-1]),
            x.reshape(-1, x.shape[-1]), U[None], S[None], V[None])
        return (dx, *(None if g is None else g[0] for g in grads))


class BlastMatmulGroupedFn(torch.autograd.Function):
    """B2 with its backward: x (..., n) → (G, ..., m).  dx is the sum over
    g of one B1 launch per factor set."""

    @staticmethod
    def forward(ctx, x, U, S, V):
        y = _blast_grouped_launch(x, U, S, V)
        ctx.save_for_backward(x, U, S, V)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, U, S, V = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = sum(ref.acc(_blast_dx(dy[g], U[g], S[g], V[g]))
                     for g in range(U.shape[0])).to(x.dtype)
        grads = _blast_factor_grads(
            ctx.needs_input_grad[1:], dy.reshape(U.shape[0], -1, dy.shape[-1]),
            x.reshape(-1, x.shape[-1]), U, S, V)
        return (dx, *grads)


def blast_matmul(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                 V: torch.Tensor) -> torch.Tensor:
    """x (..., n) → (..., m); U (b,p,r), S (b,b,r), V (b,q,r)."""
    return BlastMatmulFn.apply(x, U, S, V)


def blast_matmul_grouped(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """G congruent factor sets over one shared input in one launch:
    x (..., n); U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → (G, ..., m)."""
    return BlastMatmulGroupedFn.apply(x, U, S, V)


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
    lead = x.shape[:-1]
    _, stored = _bm.padded_rank(rb, bits, _bm.float_tiles()[1])
    U, S, V = (_pad_last(a, stored) for a in (U, S, V))
    x2 = x.reshape(-1, x.shape[-1])
    if act == "int8":
        xq, sx = qt.quantize_act(x2)
        launch = _bm.launch_w4a8 if packed else _bm.launch_w8a8
        y = launch(xq.contiguous(), sx.contiguous(), U, S, V, su, ss, sv,
                   out_dtype=x.dtype)
        launches[names[1]] += 1
    else:
        launch = _bm.launch_q4 if packed else _bm.launch_q
        y = launch(x2.contiguous(), U, S, V, su, ss, sv)
        launches[names[0]] += 1
    return y.reshape(G, *lead, b * p)


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


def flash_attention_prefill_q8(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, q_offsets: torch.Tensor,
                               *, causal: bool = True,
                               window: int | None = None,
                               kv_len: int | None = None) -> torch.Tensor:
    """``flash_attention_prefill`` over an int8 cache: k, v int8 codes
    (B, Hkv, S, D) with per-(slot, head) bf16 scales k_scale, v_scale
    (B, Hkv, S) (any strides).  K/V are read as ``dequantize_rows`` gives
    them in q's type; the kernel dequantizes each tile as it stages it."""
    if _on_cpu(q):
        return ref.attention_prefill_q8_ref(q, k, v, k_scale, v_scale,
                                            q_offsets, causal=causal,
                                            window=window, kv_len=kv_len)
    o = _fa.launch(q, k, v, q_offsets, causal=causal, window=window,
                   kv_len=k.shape[2] if kv_len is None else kv_len,
                   k_scale=k_scale, v_scale=v_scale)
    launches["flash_attention_prefill_q8"] += 1
    return o


def flash_attention_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         k_pos: torch.Tensor, q_offsets: torch.Tensor, *,
                         window: int | None,
                         kv_len: int | None = None) -> torch.Tensor:
    """Attention over a sliding-window ring cache at per-row offsets: q
    (B, Hq, C, D), k, v (B, Hkv, S, D) (any strides with a contiguous last
    axis), k_pos (B, S) int32 — each slot's absolute position, -1 empty —
    and q_offsets (B,) → (B, Hq, C, D).  Masks by ``k_pos``, not by slot
    index; slots at ``j >= kv_len`` are not read (default: all S)."""
    if _on_cpu(q):
        return ref.attention_ring_ref(q, k, v, k_pos, q_offsets,
                                      window=window, kv_len=kv_len)
    o = _fa.launch_ring(q, k, v, k_pos, q_offsets, window=window,
                        kv_len=k.shape[2] if kv_len is None else kv_len)
    launches["flash_attention_ring"] += 1
    return o


def flash_attention_ring_q8(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_scale: torch.Tensor,
                            v_scale: torch.Tensor, k_pos: torch.Tensor,
                            q_offsets: torch.Tensor, *, window: int | None,
                            kv_len: int | None = None) -> torch.Tensor:
    """``flash_attention_ring`` over an int8 ring: k, v int8 codes
    (B, Hkv, S, D) with per-(slot, head) bf16 scales k_scale, v_scale
    (B, Hkv, S) (any strides).  K/V are read as ``dequantize_rows`` gives
    them in q's type; the kernel dequantizes each tile as it stages it and
    masks by ``k_pos``."""
    if _on_cpu(q):
        return ref.attention_ring_q8_ref(q, k, v, k_scale, v_scale, k_pos,
                                         q_offsets, window=window,
                                         kv_len=kv_len)
    o = _fa.launch_ring(q, k, v, k_pos, q_offsets, window=window,
                        kv_len=k.shape[2] if kv_len is None else kv_len,
                        k_scale=k_scale, v_scale=v_scale)
    launches["flash_attention_ring_q8"] += 1
    return o


def mla_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                  latent: torch.Tensor, k_rope: torch.Tensor,
                  k_pos: torch.Tensor, q_offsets: torch.Tensor, *,
                  scale: float, kv_len: int | None = None) -> torch.Tensor:
    """MLA's latent attention at per-row offsets: q_lat (B, C, H, 512) and
    q_rope (B, C, H, 64) against the latent cache (B, S, 512) ‖ k_rope
    (B, S, 64), the latent also the value, masked by each slot's position
    k_pos (B, S) int32 (-1 empty); slots at ``j >= kv_len`` are not read
    (default: all S) → o_lat (B, C, H, 512) fp32.  On the card q is
    concatenated and cast to the cache's type (bf16: rounded for the tensor
    cores) and the MLA kernel runs."""
    if _on_cpu(latent):
        return ref.mla_attention_ref(q_lat, q_rope, latent, k_rope, k_pos,
                                     q_offsets, scale=scale, kv_len=kv_len)
    q = torch.cat([q_lat.to(latent.dtype), q_rope.to(latent.dtype)], dim=-1)
    o = _mla.launch(q, latent, k_rope, k_pos, q_offsets,
                    kv_len=latent.shape[1] if kv_len is None else kv_len,
                    scale=scale)
    launches["mla_attention"] += 1
    return o


def _attention_launch(q, k, v, causal, window, q_offset, q_chunk):
    if _on_cpu(q):
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, q_chunk=q_chunk)
    o = _fa.launch_full(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, kv_len=k.shape[2])
    launches["flash_attention"] += 1
    return o


def attention_backward(do, q, k, v, o, *, causal, window, q_offset,
                       q_chunk):
    """dq, dk, dv of o = attention(q, k, v), chunked over queries: each
    chunk recomputes its P against only its reachable keys."""
    B, Hq, T, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    kf, vf = ref.acc(k), ref.acc(v)
    dq = torch.zeros((B, Hkv, G, T, D), dtype=kf.dtype, device=q.device)
    dk = torch.zeros((B, Hkv, S_len, D), dtype=kf.dtype, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, T, max(q_chunk, 1)):
        t1 = min(T, t0 + q_chunk)
        lo, hi = ref.attention_reach(t0, t1, causal=causal, window=window,
                                     q_offset=q_offset, kv_len=S_len)
        if hi == lo:
            continue                    # no visible key: zero gradients

        def rows(a):
            return ref.acc(a[:, :, t0:t1]).reshape(B, Hkv, G, t1 - t0, D)

        qc, doc, oc = rows(q), rows(do), rows(o)
        kc, vc = kf[:, :, lo:hi], vf[:, :, lo:hi]
        s = torch.einsum("bhgtd,bhsd->bhgts", qc, kc) * scale
        mask = ref.attention_mask(t0, t1, lo, hi, causal=causal,
                                  window=window, q_offset=q_offset,
                                  device=q.device)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        p = torch.nan_to_num(p, nan=0.0)
        dv[:, :, lo:hi] += torch.einsum("bhgts,bhgtd->bhsd", p, doc)
        dp = torch.einsum("bhgtd,bhsd->bhgts", doc, vc)
        ds = p * (dp - (doc * oc).sum(-1, keepdim=True))
        dq[:, :, :, t0:t1] = torch.einsum("bhgts,bhsd->bhgtd", ds, kc) * scale
        dk[:, :, lo:hi] += torch.einsum("bhgts,bhgtd->bhsd", ds, qc) * scale
    return (dq.reshape(B, Hq, T, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """B4 with its backward: q (B, Hq, T, D), k, v (B, Hkv, S, D) →
    (B, Hq, T, D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk):
        o = _attention_launch(q, k, v, causal, window, q_offset, q_chunk)
        ctx.save_for_backward(q, k, v, o)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        q_chunk=q_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_backward(do, q, k, v, o, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    q_offset: int = 0, q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention (B4): q (B, Hq, T, D); k, v (B, Hkv, S, D)
    (any strides with a contiguous last axis) → (B, Hq, T, D).  Query i
    sits at absolute position ``i + q_offset`` (static).  ``q_chunk`` (the
    reference's rule, ``kernels/ref.q_chunk_size``) sizes the query chunks
    of the CPU path and of the backward pass; the kernel takes the whole
    sequence."""
    chunk = ref.q_chunk_size(q.shape[2], q_chunk)
    return FlashAttentionFn.apply(q, k, v, causal, window, int(q_offset),
                                  chunk)


# -- batched: one input per factor set (the MoE experts) ---------------------
# The float launch trains (``BlastMatmulBatchedFn``); the quantized ones run
# forward only, as the trainer takes float params alone.


def _batched_launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                    V: torch.Tensor, key: str) -> torch.Tensor:
    """x (G, ..., n), set g on x[g] → (G, ..., m): the plain version on the
    CPU, on CUDA one launch of the tile kernel with a per-set x stride
    (counted under ``key``); r is zero-padded inside, x is not."""
    if _on_cpu(x):
        return ref.blast_matmul_batched_ref(x, U, S, V)
    G, lead = x.shape[0], x.shape[1:-1]
    _, r_pad = _bm.padded_rank(U.shape[-1], None, _bm.float_tiles()[1])
    U, S, V = (_pad_last(a, r_pad) for a in (U, S, V))
    y = _bm.launch(x.reshape(G, -1, x.shape[-1]).contiguous(), U, S, V)
    launches[key] += 1
    return y.reshape(G, *lead, y.shape[-1])


class BlastMatmulBatchedFn(torch.autograd.Function):
    """The batched expert launch with its backward: x (G, ..., n) →
    (G, ..., m).  dx is ONE batched launch over every set's transposed
    factors (each set's dx is its own rows: no sum over sets, unlike B2);
    dU, dS, dV sum over each set's own rows."""

    @staticmethod
    def forward(ctx, x, U, S, V):
        # launch before saving (``BlastMatmulFn``: a remat recompute)
        y = _batched_launch(x, U, S, V, "blast_matmul_batched")
        ctx.save_for_backward(x, U, S, V)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, U, S, V = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _batched_launch(dy, V, S.transpose(1, 2).contiguous(), U,
                                 "blast_matmul_batched_dx")
        G = U.shape[0]
        grads = _blast_factor_grads(
            ctx.needs_input_grad[1:], dy.reshape(G, -1, dy.shape[-1]),
            x.reshape(G, -1, x.shape[-1]), U, S, V)
        return (dx, *grads)


def blast_matmul_batched(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """G factor sets, each on its own input, in one launch: x (G, ..., n);
    U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → (G, ..., m) — the reference's
    vmapped expert apply (``src/repro/models/moe.py`` ``_expert_ffn``)."""
    return BlastMatmulBatchedFn.apply(x, U, S, V)


def _batched_q(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
               V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
               sv: torch.Tensor, act: str, bits: int) -> torch.Tensor:
    """``_grouped_q`` with one input per factor set: x (G, ..., n) →
    (G, ..., m) in x's type.  With ``act="int8"`` every row of every set is
    quantized on its own (an empty capacity slot, a zero row, gets scale 1
    and zero codes, as the reference's per-expert ``quantize_act``)."""
    if act not in ("none", "int8"):
        raise ValueError(f"act must be 'none'|'int8', got {act!r}")
    packed = bits == 4
    G, b, p, rb = U.shape
    lead = x.shape[1:-1]
    if _on_cpu(x):
        if act == "int8":
            xq, sx = qt.quantize_act(x)
            plain = (ref.blast_matmul_batched_a4_ref if packed
                     else ref.blast_matmul_batched_a8_ref)
            return plain(xq, sx, U, S, V, su, ss, sv).to(x.dtype)
        plain = (ref.blast_matmul_batched_q4_ref if packed
                 else ref.blast_matmul_batched_q_ref)
        return plain(x, U, S, V, su, ss, sv)
    _, stored = _bm.padded_rank(rb, bits, _bm.float_tiles()[1])
    U, S, V = (_pad_last(a, stored) for a in (U, S, V))
    x3 = x.reshape(G, -1, x.shape[-1])
    name = "blast_matmul_batched_" + (f"w{bits}a8" if act == "int8"
                                      else "q4" if packed else "q")
    if act == "int8":
        xq, sx = qt.quantize_act(x3)
        launch = _bm.launch_w4a8 if packed else _bm.launch_w8a8
        y = launch(xq.contiguous(), sx.contiguous(), U, S, V, su, ss, sv,
                   out_dtype=x.dtype)
    else:
        launch = _bm.launch_q4 if packed else _bm.launch_q
        y = launch(x3.contiguous(), U, S, V, su, ss, sv)
    launches[name] += 1
    return y.reshape(G, *lead, b * p)


def blast_matmul_batched_q(x: torch.Tensor, U8: torch.Tensor,
                           S8: torch.Tensor, V8: torch.Tensor,
                           su: torch.Tensor, ss: torch.Tensor,
                           sv: torch.Tensor, *,
                           act: str = "none") -> torch.Tensor:
    """G int8 factor sets, each on its own input, in one launch: x (G, ...,
    n); codes U8 (G,b,p,r), S8 (G,b,b,r), V8 (G,b,q,r); scales su/sv
    (G,b), ss (G,b,b) → (G, ..., m).  ``act="int8"``: batched W8A8."""
    return _batched_q(x, U8, S8, V8, su, ss, sv, act, 8)


def blast_matmul_batched_q4(x: torch.Tensor, Up: torch.Tensor,
                            Sp: torch.Tensor, Vp: torch.Tensor,
                            su: torch.Tensor, ss: torch.Tensor,
                            sv: torch.Tensor, *,
                            act: str = "none") -> torch.Tensor:
    """As ``blast_matmul_batched_q`` over nibble-packed int4 codes, uint8
    (G,b,·,r/2), kept packed into the kernel.  ``act="int8"``: batched
    W4A8."""
    return _batched_q(x, Up, Sp, Vp, su, ss, sv, act, 4)
