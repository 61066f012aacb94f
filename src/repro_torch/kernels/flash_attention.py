"""Launchers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``)
and their plain PyTorch versions.

- ``launch``: chunked prefill at per-row offsets (B3) — q (B, Hq, C, D)
  against a serving cache k, v (B, Hkv, S, D) with q_offsets (B,);
- ``launch_full``: full-sequence attention at a static ``q_offset`` (B4) —
  q (B, Hq, T, D), k, v (B, Hkv, S, D).

Both read q, k and v through their strides (last axis contiguous), so a
(B, S, Hkv, D) serving cache or a (B, T, H, D) view of the qkv projection is
passed as its permuted view and never copied.  The output is allocated
token-major, (B, T, Hq, D), and returned as its (B, Hq, T, D) view: the out
projection then reads it with a free reshape.  The kernels keep no autograd
graph, so a launcher refuses inputs that require grad while grad mode is on
(``build.refuse_grad``); training reaches B4 through
``ops.FlashAttentionFn``.
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
    "flash_prefill": [_P] * 5 + [_I] * 5 + [_STRIDES] + [_I] * 3 + [_P],
    # q, k, v, o, B, Hq, Hkv, T, D, strides, causal, window, q_offset, kv_len
    "flash_full": [_P] * 4 + [_I] * 5 + [_STRIDES] + [_I] * 4 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LIB: list = []
D_MAX = 256         # head dims: any multiple of 8 up to this


def _lib():
    if not _LIB:
        lib = build.load("flash_attention")
        for name, argtypes in _ARGTYPES.items():
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, kv_len: int) -> None:
    B, Hq, C, D = q.shape
    _, Hkv, S_len, _ = k.shape
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
        if a.dtype != q.dtype or a.device != q.device:
            raise TypeError(f"{name} must be {q.dtype} on {q.device}")
        if a.shape != (B, Hkv, S_len, D):
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{(B, Hkv, S_len, D)}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not 0 <= kv_len <= S_len:
        raise ValueError(f"kv_len {kv_len} outside [0, {S_len}]")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"{what} kernel: tensor is not on the current CUDA "
                         "device")


def _out(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Token-major output, its (B, Hq, T, D) view and the 12 strides."""
    B, Hq, T, D = q.shape
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    return out, o, strides


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offsets: torch.Tensor, *, causal: bool, window: int | None,
           kv_len: int) -> torch.Tensor:
    build.refuse_grad("flash_attention_prefill", q, k, v)
    B, Hq, C, D = q.shape
    _check("flash_attention_prefill", q, k, v, window, kv_len)
    offs = q_offsets.to(device=q.device, dtype=torch.int32).contiguous()
    if offs.shape != (B,):
        raise ValueError(f"q_offsets has shape {tuple(offs.shape)}, want {(B,)}")
    out, o, strides = _out(q, k, v)
    fn = getattr(_lib(), f"flash_prefill_{_SUFFIX[q.dtype]}")
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
            out.data_ptr(), B, Hq, k.shape[1], C, D, strides, int(causal),
            0 if window is None else int(window), int(kv_len),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_prefill")
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
