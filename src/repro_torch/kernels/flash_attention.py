"""Launchers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``)
and their plain PyTorch versions.

- ``launch``: chunked prefill at per-row offsets (B3) — q (B, Hq, C, D)
  against a serving cache k, v (B, Hkv, S, D) with q_offsets (B,);
- ``launch_full``: full-sequence attention at a static ``q_offset`` (B4) —
  q (B, Hq, T, D), k, v (B, Hkv, S, D);
- ``launch`` with ``k_scale`` and ``v_scale``: B3 over an int8 cache — k, v
  int8 codes (B, Hkv, S, D) with their bf16 scales (B, Hkv, S), each
  given with its scales; the kernel dequantizes each K/V tile as it stages
  it, as ``quant.dequantize_rows`` does;
- ``launch_ring``: B3 over a sliding-window ring — each key's position
  read from ``k_pos`` (B, S) int32, the ring's ``pos``, not from its slot
  index (the ring instantiations of both kernels).

Both read q, k and v through their strides (last axis contiguous), so a
(B, S, Hkv, D) serving cache or a (B, T, H, D) view of the qkv projection is
passed as its permuted view and never copied.  The output is allocated
token-major, (B, T, Hq, D), and returned as its (B, Hq, T, D) view: the out
projection then reads it with a free reshape.  The kernels keep no autograd
graph, so a launcher refuses inputs that require grad while grad mode is on
(``build.refuse_grad``); training reaches B4 through
``ops.FlashAttentionFn``.

bf16 runs the tensor-core tile kernel, which copies 16-byte chunks of q, k
and v by cp.async: each must start 16-byte aligned with every stride but
the last a multiple of 8 elements, or the launcher raises.  B3 packs the G
query heads of a kv head into one block's rows and, where the grid would
leave most SMs idle, splits the key axis across blocks (``split_plan``);
the split's fp32 partials go to scratch allocated here (``_split_scratch``)
and a second kernel combines them.  fp32 runs the CUDA-core kernel.  int8
codes are copied 8 bytes at a time: for the bf16 kernel they must start
8-byte aligned with every stride but the last a multiple of 8.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_prefill_ref

plain = attention_prefill_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_ARGTYPES = {
    # q, k, v, offs, o, B, Hq, Hkv, C, D, strides, causal, window, kv_len
    "flash_prefill_f32": [_P] * 5 + [_I] * 5 + [_STRIDES] + [_I] * 3 + [_P],
    # q, k, v, offs, o, part, B, Hq, Hkv, C, D, strides, causal, window,
    # kv_len, warps, splits, keys per split
    "flash_prefill_bf16": [_P] * 6 + [_I] * 5 + [_STRIDES] + [_I] * 6 + [_P],
    # q, k, v, o, B, Hq, Hkv, T, D, strides, causal, window, q_offset, kv_len
    "flash_full_f32": [_P] * 4 + [_I] * 5 + [_STRIDES] + [_I] * 4 + [_P],
    "flash_full_bf16": [_P] * 4 + [_I] * 5 + [_STRIDES] + [_I] * 4 + [_P],
    # part, o, B, C, Hq, D, splits, o strides (b, h, t)
    "flash_combine_bf16": [_P] * 2 + [_I] * 5 + [_STRIDES] + [_P],
    # the prefill entry points over int8 K/V: k_scale and v_scale after v,
    # and 18 strides (the scales' (b, h, s) last)
    "flash_prefill_q8_f32": [_P] * 7 + [_I] * 5 + [_STRIDES] + [_I] * 3
                            + [_P],
    "flash_prefill_q8_bf16": [_P] * 8 + [_I] * 5 + [_STRIDES] + [_I] * 6
                             + [_P],
    # over a ring: q, k, v, kpos, kpos' row stride, offs, o, B, Hq, Hkv, C,
    # D, strides, window, kv_len; bf16: part after o, then warps, splits,
    # keys per split
    "flash_prefill_ring_f32": [_P] * 4 + [ctypes.c_longlong] + [_P] * 2
                              + [_I] * 5 + [_STRIDES] + [_I] * 2 + [_P],
    "flash_prefill_ring_bf16": [_P] * 4 + [ctypes.c_longlong] + [_P] * 3
                               + [_I] * 5 + [_STRIDES] + [_I] * 5 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LIB: list = []
D_MAX = 256         # head dims: any multiple of 8 up to this
KEY_TILE = 64       # keys per tile of the bf16 kernel
MAX_WARPS = 4       # warps (16 query rows each) per block of the bf16 kernel


def _lib():
    if not _LIB:
        lib = build.load("flash_attention")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def split_plan(B: int, Hkv: int, G: int, C: int, kv_len: int,
               sms: int) -> tuple[int, int, int, int]:
    """(warps, row tiles, splits, keys per split) of a bf16 B3 launch, from
    host ints only (the row offsets stay on the device).  A block owns one
    (row b, kv head, tile of packed rows): the G·C packed rows take ⌈G·C/16⌉
    warp fragments, dealt into as few tiles of at most ``MAX_WARPS`` warps
    as hold them, evenly.  Splits: none once the B·Hkv·tiles blocks fill
    half of the ``sms`` SMs; below that, as many as keep every block in the
    first wave, at most one per ``KEY_TILE`` tile of [0, kv_len).  Split s
    takes keys [s·kps, min((s + 1)·kps, kv_len)): contiguous ranges of whole
    tiles, none empty, covering [0, kv_len)."""
    frags = -(-(G * C) // 16)
    tiles = -(-frags // MAX_WARPS)
    warps = -(-frags // tiles)
    blocks = B * Hkv * tiles
    key_tiles = max(1, -(-kv_len // KEY_TILE))
    splits = 1 if 2 * blocks >= sms else sms // blocks
    per = -(-key_tiles // min(splits, key_tiles))
    return warps, tiles, -(-key_tiles // per), per * KEY_TILE


def kv_bucket(kv_len: int, S: int) -> int:
    """The kv_len a serving step passes to B3 when its live keys end at
    ``kv_len``: whole ``KEY_TILE`` tiles, their count rounded up to a power
    of two, at most ``S`` (host ints only).  A CUDA graph fixes kv_len, and
    with it ``split_plan``, at capture, so a step is keyed by its bucket:
    a few buckets cover every position.  Keys past a row's own causal limit
    are masked per row, so a larger kv_len changes no live row beyond the
    split count."""
    tiles = max(1, -(-kv_len // KEY_TILE))
    return min(S, KEY_TILE << (tiles - 1).bit_length())


def _split_scratch(splits: int, B: int, C: int, Hq: int, D: int,
                   device) -> torch.Tensor | None:
    """The split launch's fp32 scratch: acc (splits, B, C, Hq, D), then the
    (m, l) pairs (splits, B, C, Hq, 2); None without a split."""
    if splits == 1:
        return None
    return torch.empty(splits * B * C * Hq * (D + 2), dtype=torch.float32,
                       device=device)


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, kv_len: int, kv_dtype=None) -> None:
    """q, k, v as a kernel takes them; K/V in ``kv_dtype`` (default q's)."""
    B, Hq, C, D = q.shape
    _, Hkv, S_len, _ = k.shape
    kv_dtype = q.dtype if kv_dtype is None else kv_dtype
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{what} takes fp32 or bf16, got {q.dtype}")
    if D > D_MAX or D % 8:
        raise ValueError(f"head dim {D} unsupported: the kernel takes a "
                         f"multiple of 8 up to {D_MAX}")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    for name, a in (("k", k), ("v", v)):
        if a.dtype != kv_dtype or a.device != q.device:
            raise TypeError(f"{name} must be {kv_dtype} on {q.device}")
        if a.shape != (B, Hkv, S_len, D):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{(B, Hkv, S_len, D)}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        # the tile kernel's copies: 16 bytes of bf16, 8 bytes of int8 codes
        align = 16 if a.dtype == torch.bfloat16 else 8
        if q.dtype == torch.bfloat16 and (
                a.data_ptr() % align or any(s % 8 for s in a.stride()[:-1])):
            raise ValueError(
                f"{name} is not {align}-byte aligned for the bf16 kernel's "
                f"copies (data_ptr % {align} = {a.data_ptr() % align}, "
                f"strides {a.stride()}: each but the last must be a "
                "multiple of 8)")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not 0 <= kv_len <= S_len:
        raise ValueError(f"kv_len {kv_len} outside [0, {S_len}]")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{what} kernel: tensor is not on the current CUDA "
                         "device")


def _out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *scales):
    """Token-major output, its (B, Hq, T, D) view and the strides: 12, and
    the two scales' 3 each after them."""
    B, Hq, T, D = q.shape
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)
    st = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
          *(s for sc in scales for s in sc.stride())]
    return out, o, (ctypes.c_longlong * len(st))(*st)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offsets: torch.Tensor, *, causal: bool, window: int | None,
           kv_len: int, k_scale: torch.Tensor | None = None,
           v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """B3; with ``k_scale`` and ``v_scale`` (bf16, (B, Hkv, S), any
    strides), k and v are int8 codes, given with both scales."""
    q8 = k_scale is not None or v_scale is not None
    what = "flash_attention_prefill" + ("_q8" if q8 else "")
    build.refuse_grad(what, q, k, v)
    B, Hq, C, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
        if q8 and (not isinstance(sc, torch.Tensor)
                   or sc.dtype != torch.bfloat16
                   or sc.shape != (B, Hkv, S_len) or sc.device != q.device):
            raise ValueError(
                f"{name} must be a bf16 tensor of shape {(B, Hkv, S_len)} on "
                f"{q.device}: int8 K/V take both scales as a pair")
    _check(what, q, k, v, window, kv_len, torch.int8 if q8 else None)
    offs = q_offsets.to(device=q.device, dtype=torch.int32).contiguous()
    if offs.shape != (B,):
        raise ValueError(f"q_offsets has shape {tuple(offs.shape)}, want {(B,)}")
    out, o, strides = _out(q, k, v, *((k_scale, v_scale) if q8 else ()))
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *((k_scale.data_ptr(), v_scale.data_ptr()) if q8 else ()),
            offs.data_ptr(), out.data_ptr())
    opts = (int(causal), 0 if window is None else int(window), int(kv_len))
    stream = torch.cuda.current_stream().cuda_stream
    name = "flash_prefill" + ("_q8" if q8 else "")
    if q.dtype == torch.bfloat16:
        warps, _, splits, kps = split_plan(B, Hkv, Hq // Hkv, C, kv_len,
                                           build.sm_count(q.device))
        part = _split_scratch(splits, B, C, Hq, D, q.device)
        rc = getattr(_lib(), f"{name}_bf16")(
            *head, None if part is None else part.data_ptr(), B, Hq, Hkv, C,
            D, strides, *opts, warps, splits, kps, stream)
    else:
        rc = getattr(_lib(), f"{name}_f32")(*head, B, Hq, Hkv, C, D, strides,
                                            *opts, stream)
    build.check(rc, what)
    return o


def launch_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                k_pos: torch.Tensor, q_offsets: torch.Tensor, *,
                window: int | None, kv_len: int) -> torch.Tensor:
    """B3 over a ring: k_pos (B, S) int32 on the card with a contiguous last
    axis (the ring's ``pos``, a view of the cache's leaf, or the
    concatenated [ring ‖ chunk] positions of a chunk step); keys at slots
    ``>= kv_len`` are not read.  The launch plan is ``split_plan``'s."""
    what = "flash_attention_ring"
    build.refuse_grad(what, q, k, v)
    B, Hq, C, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    _check(what, q, k, v, window, kv_len)
    if (k_pos.dtype != torch.int32 or k_pos.shape != (B, S_len)
            or k_pos.device != q.device or k_pos.stride(-1) != 1):
        raise ValueError(f"k_pos must be an int32 tensor of shape "
                         f"{(B, S_len)} on {q.device} with a contiguous last "
                         f"axis, got {k_pos.dtype} {tuple(k_pos.shape)} "
                         f"strides {k_pos.stride()}")
    offs = q_offsets.to(device=q.device, dtype=torch.int32).contiguous()
    if offs.shape != (B,):
        raise ValueError(f"q_offsets has shape {tuple(offs.shape)}, want {(B,)}")
    out, o, strides = _out(q, k, v)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
            k_pos.stride(0), offs.data_ptr(), out.data_ptr())
    opts = (0 if window is None else int(window), int(kv_len))
    stream = torch.cuda.current_stream().cuda_stream
    if q.dtype == torch.bfloat16:
        warps, _, splits, kps = split_plan(B, Hkv, Hq // Hkv, C, kv_len,
                                           build.sm_count(q.device))
        part = _split_scratch(splits, B, C, Hq, D, q.device)
        rc = _lib().flash_prefill_ring_bf16(
            *head, None if part is None else part.data_ptr(), B, Hq, Hkv, C,
            D, strides, *opts, warps, splits, kps, stream)
    else:
        rc = _lib().flash_prefill_ring_f32(*head, B, Hq, Hkv, C, D, strides,
                                           *opts, stream)
    build.check(rc, what)
    return o


def launch_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int | None, q_offset: int,
                kv_len: int) -> torch.Tensor:
    build.refuse_grad("flash_attention", q, k, v)
    B, Hq, T, D = q.shape
    _check("flash_attention", q, k, v, window, kv_len)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    out, o, strides = _out(q, k, v)
    fn = getattr(_lib(), f"flash_full_{_SUFFIX[q.dtype]}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            k.shape[1], T, D, strides, int(causal),
            0 if window is None else int(window), int(q_offset), int(kv_len),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention")
    return o


def launch_combine(acc: torch.Tensor, m: torch.Tensor,
                   l: torch.Tensor) -> torch.Tensor:
    """The split-combine kernel alone on partials laid out as the split
    launch writes them — acc (splits, B, C, Hq, D), m and l (splits, B, C,
    Hq), fp32 on the card — → (B, Hq, C, D) bf16: the check of the combine
    step against ``ref.attention_combine_ref``."""
    splits, B, C, Hq, D = acc.shape
    if acc.device.type != "cuda" or D % 8:
        raise ValueError("the combine kernel takes CUDA partials with a head "
                         "dim that is a multiple of 8")
    part = torch.cat([acc.float().reshape(-1),
                      torch.stack([m.float(), l.float()], -1).reshape(-1)])
    out = torch.empty((B, C, Hq, D), dtype=torch.bfloat16, device=acc.device)
    o = out.permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 3)(*o.stride()[:3])
    rc = _lib().flash_combine_bf16(part.data_ptr(), out.data_ptr(), B, C, Hq,
                                   D, splits, strides,
                                   torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention combine")
    return o
