"""Launcher of the MLA latent-attention CUDA kernels
(``csrc/mla_attention.cu``); the plain version is
``ref.mla_attention_ref``.

``launch`` takes q (B, C, H, Dl + Dr) — [q_lat ‖ q_rope] in the cache's
type —, the latent cache (B, S, Dl) and k_rope (B, S, Dr), each slot's
position (B, S) int32 and the rows' offsets (B,) → o_lat (B, C, H, Dl)
fp32.  Dl = 512 and Dr = 64 are compiled in (DeepSeek-V3's kv_lora and
rope dims).  bf16 runs the tensor-core tile kernel, which copies 16-byte
chunks: every tensor's last axis contiguous, 16-byte aligned, every other
stride a multiple of 8 elements.  fp32 runs the CUDA-core kernel.  The
kernels keep no autograd graph (``build.refuse_grad``)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# q, latent, k_rope, kpos, offs, o, B, C, H, strides, kv_len, scale, stream
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_STRIDES, _I, ctypes.c_float, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LIB: list = []
DL, DR = 512, 64


def _lib():
    if not _LIB:
        lib = build.load("mla_attention")
        for dt in _SUFFIX.values():
            fn = getattr(lib, f"mla_attention_{dt}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def _check(q, latent, k_rope, k_pos, q_offsets, kv_len) -> None:
    B, C, H, D = q.shape
    S = latent.shape[1]
    if q.device.type != "cuda":
        raise ValueError("the MLA attention kernel needs CUDA tensors")
    if q.dtype not in _SUFFIX:
        raise TypeError(f"MLA attention takes fp32 or bf16, got {q.dtype}")
    if D != DL + DR:
        raise ValueError(f"q has {D} dims, the kernel takes {DL} + {DR}")
    for name, a, shape in (("latent", latent, (B, S, DL)),
                           ("k_rope", k_rope, (B, S, DR))):
        if a.dtype != q.dtype or a.device != q.device or a.shape != shape:
            raise ValueError(f"{name} must be {q.dtype} {shape} on "
                             f"{q.device}, got {a.dtype} {tuple(a.shape)}")
    for name, a in (("q", q), ("latent", latent), ("k_rope", k_rope)):
        if a.stride(-1) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
        if q.dtype == torch.bfloat16 and (
                a.data_ptr() % 16 or any(s % 8 for s in a.stride()[:-1])):
            raise ValueError(f"{name} is not 16-byte aligned for the bf16 "
                             f"kernel's copies (strides {a.stride()})")
    if (k_pos.dtype != torch.int32 or k_pos.shape != (B, S)
            or k_pos.device != q.device or k_pos.stride(-1) != 1):
        raise ValueError(f"k_pos must be int32 {(B, S)} on {q.device} with a "
                         f"contiguous last axis")
    if q_offsets.shape != (B,):
        raise ValueError(f"q_offsets has shape {tuple(q_offsets.shape)}, "
                         f"want {(B,)}")
    if not 0 <= kv_len <= S:
        raise ValueError(f"kv_len {kv_len} outside [0, {S}]")
    if q.device.index != torch.cuda.current_device():
        raise ValueError("MLA attention: tensor is not on the current CUDA "
                         "device")


def launch(q: torch.Tensor, latent: torch.Tensor, k_rope: torch.Tensor,
           k_pos: torch.Tensor, q_offsets: torch.Tensor, *, kv_len: int,
           scale: float) -> torch.Tensor:
    build.refuse_grad("mla_attention", q, latent, k_rope)
    _check(q, latent, k_rope, k_pos, q_offsets, kv_len)
    B, C, H, _ = q.shape
    offs = q_offsets.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((B, C, H, DL), dtype=torch.float32, device=q.device)
    st = [*q.stride()[:3], latent.stride(0), latent.stride(1),
          k_rope.stride(0), k_rope.stride(1), k_pos.stride(0),
          *o.stride()[:3]]
    rc = getattr(_lib(), f"mla_attention_{_SUFFIX[q.dtype]}")(
        q.data_ptr(), latent.data_ptr(), k_rope.data_ptr(), k_pos.data_ptr(),
        offs.data_ptr(), o.data_ptr(), B, C, H,
        (ctypes.c_longlong * len(st))(*st), int(kv_len), float(scale),
        torch.cuda.current_stream().cuda_stream)
    build.check(rc, "mla_attention")
    return o
