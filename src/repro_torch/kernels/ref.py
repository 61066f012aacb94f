"""Plain PyTorch versions of the kernels (counterparts of
``repro/kernels/ref.py``).  They are the CPU path of ``kernels/ops.py`` and
the oracle each CUDA kernel is held against on the card: fp32 accumulation
(float64 inputs stay float64, so the explicit backward passes can be held
against autograd exactly), the same masks, and the same "fully-masked row
→ 0" rule."""

from __future__ import annotations

import math

import torch

from repro_torch.quant.qarray import dequantize_rows, unpack_int4_planes


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: fp32, or float64 for float64."""
    return t if t.dtype == torch.float64 else t.float()


def blast_matmul_ref(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                     V: torch.Tensor) -> torch.Tensor:
    """Alg. 1: x (..., n) → (..., m); U (b,p,r), S (b,b,r), V (b,q,r)."""
    b, q, r = V.shape
    p = U.shape[1]
    lead = x.shape[:-1]
    xb = acc(x.reshape(*lead, b, q))
    z = torch.einsum("...jq,jqr->...jr", xb, acc(V))
    w = torch.einsum("...jr,ijr->...ir", z, acc(S))
    y = torch.einsum("...ir,ipr->...ip", w, acc(U))
    return y.reshape(*lead, b * p).to(x.dtype)


def blast_matmul_q_ref(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                       V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
                       sv: torch.Tensor) -> torch.Tensor:
    """int8-factor version: dequantize the codes U/S/V with the per-block
    scales (su (b,), ss (b,b), sv (b,)) and run Alg. 1."""
    Uf = U.float() * su.float()[:, None, None]
    Sf = S.float() * ss.float()[:, :, None]
    Vf = V.float() * sv.float()[:, None, None]
    return blast_matmul_ref(x, Uf, Sf, Vf)


def blast_matmul_grouped_ref(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                             V: torch.Tensor) -> torch.Tensor:
    """Grouped oracle == the per-projection loop: x (..., n) shared;
    U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → y (G, ..., m)."""
    return torch.stack([blast_matmul_ref(x, U[g], S[g], V[g])
                        for g in range(U.shape[0])])


def blast_matmul_grouped_q_ref(x: torch.Tensor, U: torch.Tensor,
                               S: torch.Tensor, V: torch.Tensor,
                               su: torch.Tensor, ss: torch.Tensor,
                               sv: torch.Tensor) -> torch.Tensor:
    """Grouped int8-factor version: codes (G,b,·,r); su/sv (G,b), ss (G,b,b)
    → y (G, ..., m)."""
    return torch.stack([
        blast_matmul_q_ref(x, U[g], S[g], V[g], su[g], ss[g], sv[g])
        for g in range(U.shape[0])])


def blast_matmul_a8_ref(xq: torch.Tensor, sx: torch.Tensor, U: torch.Tensor,
                        S: torch.Tensor, V: torch.Tensor, su: torch.Tensor,
                        ss: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """W8A8 version in the kernel's fusion order: stage 1 contracts int8
    activation codes xq (..., n) against int8 V codes, then dequantizes once
    by ``sx · sv_j`` (sx (..., 1) fp32); stages 2–3 run on the fp32 ``z``
    as in the int8-weight path.  Returns fp32 (..., m).

    Stage 1 runs in float64 on the integer codes (a CUDA device has no
    integer ``einsum``).  That is exact for any q: every product is an
    integer of magnitude ≤ 127², so every partial sum over q terms is an
    integer below q·127² < 2^53, which float64 holds exactly in any order.
    The cast of z to fp32 then rounds as the oracle's int32 → fp32 cast
    does."""
    b, q, r = V.shape
    p = U.shape[1]
    lead = xq.shape[:-1]
    xb = xq.reshape(*lead, b, q).double()
    z = torch.einsum("...jq,jqr->...jr", xb, V.double()).float()
    z = z * sx.float()[..., None] * sv.float()[:, None]
    Sf = S.float() * ss.float()[:, :, None]
    w = torch.einsum("...jr,ijr->...ir", z, Sf)
    y = torch.einsum("...ir,ipr->...ip", w, U.float())
    y = y * su.float()[:, None]
    return y.reshape(*lead, b * p)


def blast_matmul_grouped_a8_ref(xq: torch.Tensor, sx: torch.Tensor,
                                U: torch.Tensor, S: torch.Tensor,
                                V: torch.Tensor, su: torch.Tensor,
                                ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Grouped W8A8 version: G sets of int8 codes sharing one set of
    activation codes → y (G, ..., m) fp32."""
    return torch.stack([
        blast_matmul_a8_ref(xq, sx, U[g], S[g], V[g], su[g], ss[g], sv[g])
        for g in range(U.shape[0])])


def blast_matmul_grouped_q4_ref(x: torch.Tensor, Up: torch.Tensor,
                                Sp: torch.Tensor, Vp: torch.Tensor,
                                su: torch.Tensor, ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Grouped int4-factor version: nibble-packed codes (G,b,·,r/2) uint8
    unpacked in plane order, then the int8-code version."""
    U, S, V = (unpack_int4_planes(a) for a in (Up, Sp, Vp))
    return blast_matmul_grouped_q_ref(x, U, S, V, su, ss, sv)


def blast_matmul_grouped_a4_ref(xq: torch.Tensor, sx: torch.Tensor,
                                Up: torch.Tensor, Sp: torch.Tensor,
                                Vp: torch.Tensor, su: torch.Tensor,
                                ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Grouped W4A8 version: nibble-packed factor codes unpacked in plane
    order, then the W8A8 version (fp32 out)."""
    U, S, V = (unpack_int4_planes(a) for a in (Up, Sp, Vp))
    return blast_matmul_grouped_a8_ref(xq, sx, U, S, V, su, ss, sv)


def blast_matmul_batched_ref(x: torch.Tensor, U: torch.Tensor,
                             S: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Batched oracle (the MoE experts): factor set g on its own input x[g]
    — x (G, ..., n); U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → y (G, ..., m)
    in x's type, each set's y the ``blast_matmul_ref`` of x[g] (the
    reference's ``jax.vmap`` of one expert's apply)."""
    G, b, p, _ = U.shape
    q = V.shape[2]
    lead = x.shape[1:-1]
    xb = acc(x).reshape(G, -1, b, q)
    z = torch.einsum("gtjq,gjqr->gtjr", xb, acc(V))
    w = torch.einsum("gtjr,gijr->gtir", z, acc(S))
    y = torch.einsum("gtir,gipr->gtip", w, acc(U))
    return y.reshape(G, *lead, b * p).to(x.dtype)


def blast_matmul_batched_q_ref(x: torch.Tensor, U: torch.Tensor,
                               S: torch.Tensor, V: torch.Tensor,
                               su: torch.Tensor, ss: torch.Tensor,
                               sv: torch.Tensor) -> torch.Tensor:
    """Batched int8-factor version: codes (G,b,·,r) dequantized with su/sv
    (G,b), ss (G,b,b), over x (G, ..., n) → y (G, ..., m) in x's type."""
    Uf = U.float() * su.float()[..., None, None]
    Sf = S.float() * ss.float()[..., None]
    Vf = V.float() * sv.float()[..., None, None]
    return blast_matmul_batched_ref(x, Uf, Sf, Vf)


def blast_matmul_batched_a8_ref(xq: torch.Tensor, sx: torch.Tensor,
                                U: torch.Tensor, S: torch.Tensor,
                                V: torch.Tensor, su: torch.Tensor,
                                ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Batched W8A8 version, ``blast_matmul_a8_ref`` per set: each set's
    int8 activation codes xq (G, ..., n) with fp32 scales sx (G, ..., 1);
    stage 1 exact in float64 → y (G, ..., m) fp32."""
    G, b, p, _ = U.shape
    q = V.shape[2]
    lead = xq.shape[1:-1]
    xb = xq.reshape(G, -1, b, q).double()
    z = torch.einsum("gtjq,gjqr->gtjr", xb, V.double()).float()
    z = z * sx.float().reshape(G, -1, 1, 1) * sv.float()[:, None, :, None]
    Sf = S.float() * ss.float()[..., None]
    w = torch.einsum("gtjr,gijr->gtir", z, Sf)
    y = torch.einsum("gtir,gipr->gtip", w, U.float())
    y = y * su.float()[:, None, :, None]
    return y.reshape(G, *lead, b * p)


def blast_matmul_batched_q4_ref(x: torch.Tensor, Up: torch.Tensor,
                                Sp: torch.Tensor, Vp: torch.Tensor,
                                su: torch.Tensor, ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Batched int4-factor version: nibble-packed codes (G,b,·,r/2) uint8
    unpacked in plane order, then the int8-code version."""
    U, S, V = (unpack_int4_planes(a) for a in (Up, Sp, Vp))
    return blast_matmul_batched_q_ref(x, U, S, V, su, ss, sv)


def blast_matmul_batched_a4_ref(xq: torch.Tensor, sx: torch.Tensor,
                                Up: torch.Tensor, Sp: torch.Tensor,
                                Vp: torch.Tensor, su: torch.Tensor,
                                ss: torch.Tensor,
                                sv: torch.Tensor) -> torch.Tensor:
    """Batched W4A8 version: nibble-packed factor codes unpacked in plane
    order, then the batched W8A8 version (fp32 out)."""
    U, S, V = (unpack_int4_planes(a) for a in (Up, Sp, Vp))
    return blast_matmul_batched_a8_ref(xq, sx, U, S, V, su, ss, sv)


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, T, D); k, v (B, Hkv, S, D); mask (B, T, S) of visible keys
    → (B, Hq, T, D) in q's type; a row that sees no key returns 0."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    qf = acc(q).reshape(B, Hkv, Hq // Hkv, T, D)
    scores = torch.einsum("bhgtd,bhsd->bhgts", qf, acc(k)) / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)   # fully-masked rows → 0
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, acc(v))
    return out.reshape(B, Hq, T, D).to(q.dtype)


def _query_positions(q_offsets: torch.Tensor, T: int, device) -> torch.Tensor:
    """(B, T, 1) absolute position of query (b, t): q_offsets[b] + t."""
    offs = q_offsets.to(device=device, dtype=torch.int64)
    return offs[:, None, None] + torch.arange(T, device=device)[None, :, None]


def attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offsets: torch.Tensor, *, causal: bool = True,
                          window: int | None = None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Prefill-at-offset attention: q (B, Hq, C, D); k, v (B, Hkv, S, D)
    (any strides); q_offsets (B,).  Query (b, t) at absolute position
    ``q_offsets[b] + t`` attends to key j iff ``j <= q_offsets[b] + t``,
    ``j < kv_len`` and (with a window) ``j > q_offsets[b] + t - window``."""
    B, _, T, _ = q.shape
    S_len = k.shape[2]
    kv_len = S_len if kv_len is None else kv_len
    qi = _query_positions(q_offsets, T, q.device)
    kj = torch.arange(S_len, device=q.device)[None, None, :]
    mask = (kj < kv_len).expand(B, T, S_len)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return _masked_attention(q, k, v, mask)


def attention_ring_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_pos: torch.Tensor, q_offsets: torch.Tensor, *,
                       window: int | None,
                       kv_len: int | None = None) -> torch.Tensor:
    """Attention over a ring cache, by key position: q (B, Hq, C, D); k, v
    (B, Hkv, S, D) (any strides); k_pos (B, S) the absolute position of
    each slot (-1: empty); q_offsets (B,).  Query (b, t) at ``q_offsets[b]
    + t`` attends to slot j iff ``j < kv_len``, ``0 <= k_pos[b, j] <=``
    its position and (with a window) ``k_pos[b, j] >`` its position ``-
    window`` — the reference's ``cache_attention`` (``models/ops.py``),
    except that a row with no visible key returns 0."""
    T, S_len = q.shape[2], k.shape[2]
    kv_len = S_len if kv_len is None else kv_len
    qi = _query_positions(q_offsets, T, q.device)
    kp = k_pos.to(device=q.device, dtype=torch.int64)[:, None, :]
    kj = torch.arange(S_len, device=q.device)[None, None, :]
    mask = (kj < kv_len) & (kp >= 0) & (kp <= qi)
    if window is not None:
        mask = mask & (kp > qi - window)
    return _masked_attention(q, k, v, mask)


def attention_prefill_q8_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, k_scale: torch.Tensor,
                             v_scale: torch.Tensor, q_offsets: torch.Tensor,
                             *, causal: bool = True,
                             window: int | None = None,
                             kv_len: int | None = None) -> torch.Tensor:
    """Prefill attention over an int8 cache: k, v int8 codes (B, Hkv, S, D)
    with scales (B, Hkv, S), dequantized to q's type (``dequantize_rows``,
    the reference's int8 cache read), then ``attention_prefill_ref``."""
    return attention_prefill_ref(
        q, dequantize_rows(k, k_scale, q.dtype),
        dequantize_rows(v, v_scale, q.dtype), q_offsets, causal=causal,
        window=window, kv_len=kv_len)


def attention_ring_q8_ref(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, k_pos: torch.Tensor,
                          q_offsets: torch.Tensor, *, window: int | None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Attention over an int8 ring cache, by key position: k, v int8 codes
    (B, Hkv, S, D) with scales (B, Hkv, S), dequantized to q's type
    (``dequantize_rows``), then ``attention_ring_ref`` — the reference's
    read of its int8 ring (``src/repro/models/layers.py``: ``attn_prefill``,
    ``dequantize_rows`` of the ring, then ``cache_attention`` masked by
    ``pos``)."""
    return attention_ring_ref(
        q, dequantize_rows(k, k_scale, q.dtype),
        dequantize_rows(v, v_scale, q.dtype), k_pos, q_offsets,
        window=window, kv_len=kv_len)


ATTN_KEY_TILE = 64      # keys per tile of the bf16 attention kernel
ATTN_M_INIT = -1e30     # its running-max start


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_offsets: torch.Tensor, *, causal: bool = True,
                        window: int | None = None, kv_len: int | None = None,
                        splits: int = 1, keys_per_split: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 prefill kernel's algorithm, plainly (a check of the
    kernel's design; nothing on the main path calls it).  The G query heads
    of each kv head are packed into rows r = t·G + g at positions
    ``q_offsets[b] + t``; split s walks keys [s·kps, min((s + 1)·kps,
    kv_len)) in tiles of ``ATTN_KEY_TILE`` with the online softmax, in
    log2 units (m is the running max of score · log2(e) / √D).  Returns the
    split partials in the kernel's scratch layout: the unnormalised acc
    (splits, B, C, Hq, D), m and l (splits, B, C, Hq); a split in which a
    row sees no key leaves it m = ``ATTN_M_INIT``, l = 0, acc = 0."""
    B, Hq, C, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = S_len if kv_len is None else kv_len
    kps = keys_per_split or max(ATTN_KEY_TILE, kv_len)
    sl2 = math.log2(math.e) / math.sqrt(D)
    qp = acc(q).reshape(B, Hkv, G, C, D).transpose(2, 3).reshape(
        B, Hkv, C * G, D)
    kf, vf = acc(k), acc(v)
    offs = q_offsets.to(device=q.device, dtype=torch.int64)
    pos = offs[:, None] + torch.arange(C * G, device=q.device) // G  # (B, R)
    outs = []
    for s in range(splits):
        m = torch.full((B, Hkv, C * G), ATTN_M_INIT, dtype=qp.dtype,
                       device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qp)
        hi_s = min(kv_len, (s + 1) * kps)
        for j0 in range(s * kps, hi_s, ATTN_KEY_TILE):
            j1 = min(j0 + ATTN_KEY_TILE, hi_s)
            kj = torch.arange(j0, j1, device=q.device)
            vis = torch.ones((B, C * G, j1 - j0), dtype=torch.bool,
                             device=q.device)
            if causal:
                vis = vis & (kj <= pos[..., None])
            if window is not None:
                vis = vis & (kj > pos[..., None] - window)
            sc = torch.einsum("bhrd,bhjd->bhrj", qp, kf[:, :, j0:j1])
            sc = sc.masked_fill(~vis[:, None], float("-inf"))
            mn = torch.maximum(m, sc.amax(-1) * sl2)
            alpha = torch.exp2(m - mn)
            p = torch.exp2(sc * sl2 - mn[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhrj,bhjd->bhrd", p, vf[:, :, j0:j1])
            m = mn
        outs.append((o, m, l))

    def unpack(a):   # (splits, B, Hkv, C·G, ...) → (splits, B, C, Hq, ...)
        a = a.reshape(splits, B, Hkv, C, G, *a.shape[4:])
        return a.transpose(2, 3).reshape(splits, B, C, Hq, *a.shape[5:])

    return tuple(unpack(torch.stack(parts)) for parts in zip(*outs))


def attention_combine_ref(acc_: torch.Tensor, m: torch.Tensor,
                          l: torch.Tensor) -> torch.Tensor:
    """The split combine, plainly: o = Σ_s w_s·acc_s / Σ_s w_s·l_s with
    w_s = 2^(m_s − max_s m_s) over the splits with l_s > 0, 0 where none
    has; partials as ``attention_split_ref`` returns them → (B, Hq, C, D)."""
    w = torch.where(l > 0, torch.exp2(m - m.amax(0)), torch.zeros_like(m))
    L = (w * l).sum(0)
    o = (w[..., None] * acc_).sum(0)
    o = torch.where(L[..., None] > 0, o / L.clamp_min(1e-38)[..., None],
                    torch.zeros_like(o))
    return o.permute(0, 2, 1, 3)


def q_chunk_size(T: int, q_chunk: int = 512) -> int:
    """Query rows per chunk of the chunked plain attention and of its
    backward: the reference's ``chunked_attention`` rule (at most 8 chunks,
    none longer than T)."""
    return min(max(q_chunk, -(-T // 8)), max(T, 1))


def attention_reach(t0: int, t1: int, *, causal: bool, window: int | None,
                    q_offset: int, kv_len: int) -> tuple[int, int]:
    """[lo, hi): the keys that queries t0..t1-1 (at absolute positions
    q_offset + t) can see."""
    hi = min(kv_len, q_offset + t1) if causal else kv_len
    lo = max(0, q_offset + t0 - window + 1) if window is not None else 0
    return lo, max(lo, hi)


def attention_mask(t0: int, t1: int, lo: int, hi: int, *, causal: bool,
                   window: int | None, q_offset: int,
                   device) -> torch.Tensor:
    """(t1 - t0, hi - lo) visibility of keys lo..hi-1 to queries t0..t1-1
    (keys at or past kv_len are outside [lo, hi) already)."""
    qi = q_offset + torch.arange(t0, t1, device=device)[:, None]
    kj = torch.arange(lo, hi, device=device)[None, :]
    mask = torch.ones((t1 - t0, hi - lo), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  q_offset: int = 0, kv_len: int | None = None,
                  q_chunk: int | None = None) -> torch.Tensor:
    """Full-sequence attention with GQA (the plain version of B4):
    q (B, Hq, T, D); k, v (B, Hkv, S, D) (any strides) → (B, Hq, T, D).
    Query i (at absolute position ``i + q_offset``) attends to key j iff
    ``j < kv_len``, ``j <= i + q_offset`` (causal) and
    ``j > i + q_offset - window``; a row with no visible key returns 0.
    ``q_chunk`` processes that many query rows at a time against only
    their reachable keys (the reference's ``chunked_attention``), so
    memory stays bounded; the result is the same softmax."""
    B, Hq, T, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = S_len if kv_len is None else kv_len
    chunk = T if q_chunk is None else q_chunk
    outs = []
    for t0 in range(0, T, max(chunk, 1)):
        t1 = min(T, t0 + chunk)
        lo, hi = attention_reach(t0, t1, causal=causal, window=window,
                                 q_offset=q_offset, kv_len=kv_len)
        qc = acc(q[:, :, t0:t1]).reshape(B, Hkv, G, t1 - t0, D)
        s = torch.einsum("bhgtd,bhsd->bhgts", qc,
                         acc(k[:, :, lo:hi])) / math.sqrt(D)
        mask = attention_mask(t0, t1, lo, hi, causal=causal, window=window,
                              q_offset=q_offset, device=q.device)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        outs.append(torch.einsum("bhgts,bhsd->bhgtd", p, acc(v[:, :, lo:hi])))
    out = torch.cat(outs, dim=3) if len(outs) > 1 else outs[0]
    return out.reshape(B, Hq, T, D).to(q.dtype)


def mla_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      latent: torch.Tensor, k_rope: torch.Tensor,
                      k_pos: torch.Tensor, q_offsets: torch.Tensor, *,
                      scale: float, kv_len: int | None = None
                      ) -> torch.Tensor:
    """MLA's latent attention (``src/repro/models/layers.py``,
    ``mla_prefill`` between ``q_lat`` and ``o_lat``): q_lat (B, C, H, Dl),
    q_rope (B, C, H, Dr) against one shared key per slot, [latent ‖ k_rope]
    (B, S, Dl + Dr), whose first Dl columns are the value.  Query (b, t)
    sits at position q_offsets[b] + t and sees slot j < kv_len iff 0 <=
    k_pos[b, j] <= its position; scores are scaled by ``scale``; a row
    that sees no key gives 0 (the reference's mask of -1e30 gives it the
    mean of its latent slots, which is 0 for an idle row: the engine
    resets it; ROADMAP C3) → (B, C, H, Dl) fp32."""
    S = latent.shape[1] if kv_len is None else kv_len
    lat, rope = acc(latent[:, :S]), acc(k_rope[:, :S])
    s = (torch.einsum("bthc,bsc->bths", acc(q_lat), lat)
         + torch.einsum("bthr,bsr->bths", acc(q_rope), rope)) * scale
    qpos = _query_positions(q_offsets, q_lat.shape[1], q_lat.device)
    kp = k_pos[:, :S].to(qpos.device)
    ok = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qpos)    # (B, C, S)
    p = torch.softmax(s.masked_fill(~ok[:, :, None, :], float("-inf")), -1)
    p = torch.nan_to_num(p, nan=0.0)
    return torch.einsum("bths,bsc->bthc", p, lat)
