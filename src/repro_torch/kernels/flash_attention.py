"""Launcher of the chunked-prefill flash-attention CUDA kernel
(``csrc/flash_attention.cu``) and its plain PyTorch version.

``launch`` reads q (B, Hq, C, D) and k, v (B, Hkv, S, D) through their
strides (last axis contiguous), so a (B, S, Hkv, D) serving cache is passed
as its permuted view and never copied.  The output is allocated token-major,
(B, C, Hq, D), and returned as its (B, Hq, C, D) view: the out projection
then reads it with a free reshape.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import attention_prefill_ref

plain = attention_prefill_ref

_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
         + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 3
         + [ctypes.c_void_p])
_LIB: list = []
D_MAX = 128


def _lib():
    if not _LIB:
        lib = build.load("flash_attention")
        for fn in (lib.flash_prefill_f32, lib.flash_prefill_bf16):
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offsets: torch.Tensor, *, causal: bool, window: int | None,
           kv_len: int) -> torch.Tensor:
    B, Hq, C, D = q.shape
    _, Hkv, S_len, _ = k.shape
    if q.device.type != "cuda":
        raise ValueError("flash_attention_prefill kernel needs CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_prefill takes fp32 or bf16, got "
                        f"{q.dtype}")
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
        raise ValueError("flash_attention_prefill kernel: tensor is not on "
                         "the current CUDA device")
    offs = q_offsets.to(device=q.device, dtype=torch.int32).contiguous()
    if offs.shape != (B,):
        raise ValueError(f"q_offsets has shape {tuple(offs.shape)}, want {(B,)}")
    out = torch.empty((B, C, Hq, D), dtype=q.dtype, device=q.device)
    o = out.permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    lib = _lib()
    fn = lib.flash_prefill_f32 if q.dtype == torch.float32 else lib.flash_prefill_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
            out.data_ptr(), B, Hq, Hkv, C, D, strides, int(causal),
            0 if window is None else int(window), int(kv_len),
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "flash_attention_prefill")
    return o
