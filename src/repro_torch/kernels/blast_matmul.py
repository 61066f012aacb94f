"""Launcher of the fused BLAST CUDA kernel (``csrc/blast_matmul.cu``) and its
plain PyTorch version.

``launch`` takes the kernel's own layout — x (T, n), U (G, b, p, r),
S (G, b, b, r), V (G, b, q, r), all contiguous, one dtype (fp32 or bf16),
r a multiple of the kernel's rank tile — and returns y (G, T, m).  Callers
go through ``kernels/ops.py``, which flattens, pads and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import blast_matmul_grouped_ref, blast_matmul_ref

plain = blast_matmul_ref
plain_grouped = blast_matmul_grouped_ref

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LIB: list = []


def _lib():
    if not _LIB:
        lib = build.load("blast_matmul")
        for fn in (lib.blast_matmul_f32, lib.blast_matmul_bf16):
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        for fn in (lib.blast_matmul_tile_t, lib.blast_matmul_tile_r):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def tiles() -> tuple[int, int]:
    """(token rows, ranks) per kernel tile."""
    lib = _lib()
    return lib.blast_matmul_tile_t(), lib.blast_matmul_tile_r()


def launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
           V: torch.Tensor) -> torch.Tensor:
    T, n = x.shape
    G, b, p, r = U.shape
    q = V.shape[2]
    if x.device.type != "cuda":
        raise ValueError("blast_matmul kernel needs CUDA tensors")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"blast_matmul kernel takes fp32 or bf16, got {x.dtype}")
    for name, a in (("U", U), ("S", S), ("V", V)):
        if a.dtype != x.dtype or a.device != x.device:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}, "
                            f"got {a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if (S.shape != (G, b, b, r) or V.shape != (G, b, q, r) or n != b * q):
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, U "
                         f"{tuple(U.shape)}, S {tuple(S.shape)}, V "
                         f"{tuple(V.shape)}")
    if r % tiles()[1]:
        raise ValueError(f"rank {r} is not a multiple of the rank tile "
                         f"{tiles()[1]} (ops.py pads it)")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("blast_matmul kernel: tensor is not on the current "
                         "CUDA device")
    y = torch.empty((G, T, b * p), dtype=x.dtype, device=x.device)
    lib = _lib()
    fn = lib.blast_matmul_f32 if x.dtype == torch.float32 else lib.blast_matmul_bf16
    rc = fn(x.data_ptr(), U.data_ptr(), S.data_ptr(), V.data_ptr(),
            y.data_ptr(), T, G, b, p, q, r,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "blast_matmul")
    return y
