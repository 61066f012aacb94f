"""Per-block symmetric int8 and int4 quantization (counterpart of
``repro/quant/qarray.py``): the ``QArray = {q, scale}`` container and the
codecs the quantized serving path builds on.

``quantize(x, bits, block_axes)`` shares ONE symmetric scale per block: the
max-abs is reduced over ``block_axes`` (keepdims), so ``scale`` broadcasts
against ``q`` and dequantization is ``q * scale``.  An all-zero block gets
``scale = 1`` so its codes are 0 and dequantize to exactly 0.  The codes
equal the reference's bit for bit: fp32 ``amax / qmax``, ``x / scale`` in
fp32, round half to even (``torch.round`` as ``jnp.round``), clamp to
±qmax (127 for int8, 7 for int4).
``qmax`` divides as a tensor on ``amax``'s device: PyTorch's CUDA division
by a Python scalar multiplies by its reciprocal instead, which is 1 ulp off
for some blocks and would give the card other scales than the CPU.

int4 codes are stored two per byte along the last axis (``pack_int4``: byte
k holds logical positions 2k in its low and 2k+1 in its high nibble, the
last axis zero-padded to even length); ``last_dim`` keeps the logical size
and ``int_values`` unpacks.  The packed bytes equal the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

_QMAX = {8: 127, 4: 7}


@dataclasses.dataclass(frozen=True)
class QArray:
    """Quantized tensor: integer codes + fp32 per-block scales.

    q:        int8 codes (or uint8 nibble pairs when ``bits == 4``)
    scale:    float scales, broadcastable against the logical values
    bits:     8 or 4
    last_dim: logical size of the last axis (differs from ``q.shape[-1]``
              only for packed int4)
    """

    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    last_dim: int | None = None

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    @property
    def shape(self) -> tuple[int, ...]:
        d = self.q.shape[-1] if self.last_dim is None else self.last_dim
        return (*self.q.shape[:-1], d)


def is_qarray(x) -> bool:
    return isinstance(x, QArray)


def _leaves(tree):
    """Tensors and QArrays of a tree of dicts, lists and tuples.  Other
    objects (a prestacked ``GroupBundle``: a copy of its members) are not
    walked."""
    if isinstance(tree, (torch.Tensor, QArray)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def tree_is_quantized(tree) -> bool:
    """True if any leaf of ``tree`` is a QArray."""
    return any(is_qarray(leaf) for leaf in _leaves(tree))


def tree_nbytes(tree) -> int:
    """Total bytes of all leaves (a QArray counts q + scale)."""
    return sum(leaf.nbytes if is_qarray(leaf)
               else leaf.numel() * leaf.element_size()
               for leaf in _leaves(tree))


def _check_bits(bits: int) -> int:
    if bits not in _QMAX:
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    return _QMAX[bits]


# -- int4 nibble packing (two codes per byte along the last axis) ------------


def pack_int4(v: torch.Tensor) -> torch.Tensor:
    """v: int8 values in [-7, 7], (..., D) → uint8 (..., ceil(D/2)).  The
    nibble is masked in int16, so a negative code keeps its two's-complement
    low four bits."""
    if v.shape[-1] % 2:
        v = torch.nn.functional.pad(v, (0, 1))
    u = (v.to(torch.int16) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def _sign_extend(nib: torch.Tensor) -> torch.Tensor:
    v = nib.to(torch.int8)
    return torch.where(v >= 8, v - 16, v)


def unpack_int4(p: torch.Tensor, last_dim: int) -> torch.Tensor:
    """uint8 nibble pairs (..., P) → int8 values (..., last_dim)."""
    v = torch.stack([p & 0xF, p >> 4], dim=-1).reshape(*p.shape[:-1],
                                                       2 * p.shape[-1])
    return _sign_extend(v)[..., :last_dim]


def unpack_int4_planes(p: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs (..., P) → int8 (..., 2P) in *plane order*
    ``[low nibbles | high nibbles]``: logical positions ``[0, 2, 4, …, 1, 3,
    5, …]``.  The BLAST contraction reduces over this (rank) axis, so any
    order applied alike to U, S and V gives the same sum."""
    return _sign_extend(torch.cat([p & 0xF, p >> 4], dim=-1))


def plane_order(r: int) -> torch.Tensor:
    """Index mapping plane order → logical order for ``ceil(r/2)`` packed
    bytes: ``unpack_int4_planes(p)[..., plane_order(r)] == unpack_int4(p, r)``
    (the odd-r pad nibble dropped)."""
    half = (r + 1) // 2
    idx = torch.empty((r,), dtype=torch.int64)
    idx[0::2] = torch.arange(0, half)           # even ranks: low plane
    idx[1::2] = torch.arange(half, half + r // 2)   # odd ranks: high plane
    return idx


def quantize(x: torch.Tensor, *, bits: int = 8,
             block_axes: tuple[int, ...] | None = None,
             scale_dtype=torch.float32) -> QArray:
    """Per-block symmetric quantization.  One scale per block, where a block
    is the slice spanned by ``block_axes`` (None = one scale per tensor)."""
    qmax = _check_bits(bits)
    xf = x.float()
    dims = tuple(range(x.ndim)) if block_axes is None else tuple(block_axes)
    amax = xf.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                        torch.ones_like(amax))
    v = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        v = pack_int4(v)
    return QArray(q=v, scale=scale.to(scale_dtype), bits=bits,
                  last_dim=x.shape[-1])


def int_values(qa: QArray) -> torch.Tensor:
    """The logical int8 codes (unpacks int4)."""
    _check_bits(qa.bits)
    if qa.bits == 4:
        return unpack_int4(qa.q, 2 * qa.q.shape[-1] if qa.last_dim is None
                           else qa.last_dim)
    return qa.q


def dequantize(qa: QArray, dtype=None) -> torch.Tensor:
    y = int_values(qa).float() * qa.scale.float()
    return y if dtype is None else y.to(dtype)


def quantize_rows(t: torch.Tensor, scale_dtype=torch.bfloat16
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise cache codec: t (..., D) → int8 codes (..., D) and one scale
    per last-axis vector (...,), zero-guarded like ``quantize``.  The codes
    are computed with the fp32 scale ``amax / 127`` and divide by it; the
    scale is then stored as ``scale_dtype``, as the reference stores it.

    The fp32 scale takes one of two forms.  bf16 scales (K/V, a conv tail):
    a division, as eager JAX computes it; rounded to bf16, it equals the
    jitted form's scale in every row tried.  fp32 scales (a recurrent
    state ``h``, stored unrounded): ``amax * float32(1/127)``, the form the
    reference's jitted engine computes — XLA rewrites the division by the
    constant 127 as a multiply by its reciprocal, also without backend
    optimizations, and on 4096 rows of 256 the division gave 175 scales
    one ulp away from the jitted ones, the multiply none (ROADMAP,
    Constraints).  No host work: the int8 caches' writes run inside a
    captured step."""
    tf = t.float()
    amax = tf.abs().amax(dim=-1)
    if scale_dtype == torch.float32:
        scaled = amax * torch.full_like(amax, 1.0 / 127.0)
    else:
        scaled = amax / torch.full_like(amax, 127.0)
    scale = torch.where(amax > 0, scaled, torch.ones_like(amax))
    q = torch.clamp(torch.round(tf / scale[..., None]), -127,
                    127).to(torch.int8)
    return q, scale.to(scale_dtype)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    """codes (..., D) × scales (...,) in fp32, rounded once to ``dtype``."""
    return (q.float() * scale.float()[..., None]).to(dtype)


def quantize_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token activation codes (the A8 half of W8A8): x (..., D) → int8
    codes (..., D) and fp32 per-row scales (..., 1).  A zero row gets scale
    1 and zero codes."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_act(q: torch.Tensor, scale: torch.Tensor,
                   dtype=None) -> torch.Tensor:
    y = q.float() * scale.float()
    return y if dtype is None else y.to(dtype)


def pack_state_cache(quantized: bool, conv: torch.Tensor,
                     h: torch.Tensor) -> dict:
    """A recurrent mixer's cache write (RG-LRU; SSD's has the same leaves):
    the conv tail and the state.  Quantized, both are int8 with per-row
    scales — bf16 for the conv tail (the token caches' convention), fp32
    for the state ``h``, which re-enters the scan every step."""
    if quantized:
        cq, cs = quantize_rows(conv)
        hq, hs = quantize_rows(h, scale_dtype=torch.float32)
        return {"conv": cq, "conv_scale": cs, "h": hq, "h_scale": hs}
    return {"conv": conv, "h": h}


def unpack_state_cache(quantized: bool, cache: dict,
                       dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of ``pack_state_cache`` → (conv in ``dtype``, h in fp32)."""
    if quantized:
        return (dequantize_rows(cache["conv"], cache["conv_scale"], dtype),
                dequantize_rows(cache["h"], cache["h_scale"], torch.float32))
    return cache["conv"], cache["h"]


_WEIGHT_MODES = ("none", "int8", "int4")
_CACHE_MODES = ("none", "int8")
_ACT_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """What gets quantized at serving time.

    weights:     structured-linear and embedding storage
                 ("none"|"int8"|"int4")
    cache:       KV caches ("none"|"int8": int8 codes with per-(slot, head)
                 bf16 scales) and recurrent state (int8 ``conv`` with bf16
                 and ``h`` with fp32 per-row scales)
    activations: per-token int8 layer inputs feeding the integer (W8A8)
                 kernels ("none"|"int8"); requires quantized weights
    """

    weights: str = "none"
    cache: str = "none"
    activations: str = "none"

    def __post_init__(self):
        if self.weights not in _WEIGHT_MODES:
            raise ValueError(f"quant.weights must be one of {_WEIGHT_MODES}")
        if self.cache not in _CACHE_MODES:
            raise ValueError(f"quant.cache must be one of {_CACHE_MODES}")
        if self.activations not in _ACT_MODES:
            raise ValueError(
                f"quant.activations must be one of {_ACT_MODES}")
        if self.activations != "none" and self.weights == "none":
            raise ValueError(
                "quant.activations requires quantized weights "
                "(set quant.weights to int8 or int4)")

    @property
    def weight_bits(self) -> int | None:
        return {"none": None, "int8": 8, "int4": 4}[self.weights]

    @property
    def act_bits(self) -> int | None:
        return {"none": None, "int8": 8}[self.activations]

    @property
    def enabled(self) -> bool:
        return (self.weights != "none" or self.cache != "none"
                or self.activations != "none")
