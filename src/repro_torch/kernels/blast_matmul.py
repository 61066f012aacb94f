"""Launchers of the fused BLAST CUDA kernel (``csrc/blast_matmul.cu``) and
its plain PyTorch versions.

All take the kernel's own layout — x (T, n), U (G, b, p, r), S (G, b, b, r),
V (G, b, q, r), all contiguous, r a multiple of the kernel's rank tile — and
return y (G, T, m):

- ``launch``: float factors of x's type (fp32 or bf16);
- ``launch_q``: int8 factor codes with fp32 scales su (G, b), ss (G, b, b),
  sv (G, b), x fp32 or bf16; y has x's type;
- ``launch_w8a8``: int8 activation codes xq (T, n) with fp32 scales sx
  (T, 1) against int8 factor codes; y has ``out_dtype``.

Callers go through ``kernels/ops.py``, which flattens, pads, quantizes the
activations and counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (blast_matmul_grouped_a8_ref,
                                     blast_matmul_grouped_q_ref,
                                     blast_matmul_grouped_ref,
                                     blast_matmul_ref)

plain = blast_matmul_ref
plain_grouped = blast_matmul_grouped_ref
plain_grouped_q = blast_matmul_grouped_q_ref
plain_grouped_a8 = blast_matmul_grouped_a8_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "blast_matmul_f32": [_P] * 5 + [_I] * 6 + [_P],
    "blast_matmul_bf16": [_P] * 5 + [_I] * 6 + [_P],
    "blast_matmul_q_f32": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_q_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_w8a8_f32": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_w8a8_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_tile_t": [],
    "blast_matmul_tile_r": [],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_LIB: list = []


def _lib():
    if not _LIB:
        lib = build.load("blast_matmul")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def tiles() -> tuple[int, int]:
    """(token rows, ranks) per kernel tile."""
    lib = _lib()
    return lib.blast_matmul_tile_t(), lib.blast_matmul_tile_r()


def _check(x, U, S, V, factor_dtype, scales=()) -> tuple[int, ...]:
    """Validate the kernel's layout; returns (T, G, b, p, q, r)."""
    T, n = x.shape
    G, b, p, r = U.shape
    q = V.shape[2]
    if x.device.type != "cuda":
        raise ValueError("blast_matmul kernel needs CUDA tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("blast_matmul kernel: tensor is not on the current "
                         "CUDA device")
    named = [("x", x, x.dtype), ("U", U, factor_dtype), ("S", S, factor_dtype),
             ("V", V, factor_dtype)]
    named += [(k, a, torch.float32) for k, a in scales]
    for name, a, dtype in named:
        if a.dtype != dtype or a.device != x.device:
            raise TypeError(f"{name} must be {dtype} on {x.device}, got "
                            f"{a.dtype} on {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S.shape != (G, b, b, r) or V.shape != (G, b, q, r) or n != b * q:
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, U "
                         f"{tuple(U.shape)}, S {tuple(S.shape)}, V "
                         f"{tuple(V.shape)}")
    want = {"su": (G, b), "ss": (G, b, b), "sv": (G, b), "sx": (T, 1)}
    for name, a in scales:
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{want[name]}")
    if r % tiles()[1]:
        raise ValueError(f"rank {r} is not a multiple of the rank tile "
                         f"{tiles()[1]} (ops.py pads it)")
    return T, G, b, p, q, r


def _run(fn_name: str, ptrs, dims, y) -> torch.Tensor:
    fn = getattr(_lib(), fn_name)
    rc = fn(*(a.data_ptr() for a in ptrs), y.data_ptr(), *dims,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, fn_name)
    return y


def launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
           V: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"blast_matmul kernel takes fp32 or bf16, got {x.dtype}")
    T, G, b, p, q, r = _check(x, U, S, V, x.dtype)
    y = torch.empty((G, T, b * p), dtype=x.dtype, device=x.device)
    return _run(f"blast_matmul_{_SUFFIX[x.dtype]}", (x, U, S, V),
                (T, G, b, p, q, r), y)


def launch_q(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
             V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
             sv: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"blast_matmul_q kernel takes fp32 or bf16 x, got "
                        f"{x.dtype}")
    T, G, b, p, q, r = _check(x, U, S, V, torch.int8,
                              (("su", su), ("ss", ss), ("sv", sv)))
    y = torch.empty((G, T, b * p), dtype=x.dtype, device=x.device)
    return _run(f"blast_matmul_q_{_SUFFIX[x.dtype]}", (x, U, S, V, su, ss, sv),
                (T, G, b, p, q, r), y)


def launch_w8a8(xq: torch.Tensor, sx: torch.Tensor, U: torch.Tensor,
                S: torch.Tensor, V: torch.Tensor, su: torch.Tensor,
                ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    if xq.dtype != torch.int8:
        raise TypeError(f"blast_matmul_w8a8 kernel takes int8 codes, got "
                        f"{xq.dtype}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"blast_matmul_w8a8 kernel writes fp32 or bf16, got "
                        f"{out_dtype}")
    T, G, b, p, q, r = _check(xq, U, S, V, torch.int8,
                              (("sx", sx), ("su", su), ("ss", ss),
                               ("sv", sv)))
    y = torch.empty((G, T, b * p), dtype=out_dtype, device=xq.device)
    return _run(f"blast_matmul_w8a8_{_SUFFIX[out_dtype]}",
                (xq, sx, U, S, V, su, ss, sv), (T, G, b, p, q, r), y)
