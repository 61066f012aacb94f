"""Launchers of the fused BLAST CUDA kernel (``csrc/blast_matmul.cu``) and
its plain PyTorch versions.

All take the kernel's own layout — x (T, n), U (G, b, p, r), S (G, b, b, r),
V (G, b, q, r), all contiguous, r a multiple of the kernel's rank tile — and
return y (G, T, m):

- ``launch``: float factors of x's type (fp32 or bf16);
- ``launch_q``: int8 factor codes with fp32 scales su (G, b), ss (G, b, b),
  sv (G, b), x fp32 or bf16; y has x's type;
- ``launch_w8a8``: int8 activation codes xq (T, n) with fp32 scales sx
  (T, 1) against int8 factor codes; y has ``out_dtype``;
- ``launch_q4`` / ``launch_w4a8``: as ``launch_q`` / ``launch_w8a8`` with
  nibble-packed int4 factor codes, uint8 (G, b, ·, r/2): the kernel reads
  them packed and takes the logical rank r = 2 × bytes.

Callers go through ``kernels/ops.py``, which flattens, pads, quantizes the
activations and counts launches.  The kernel keeps no autograd graph: a
launcher refuses inputs that require grad while grad mode is on
(``build.refuse_grad``); training reaches the float kernel through
``ops.BlastMatmulFn`` / ``ops.BlastMatmulGroupedFn``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (blast_matmul_grouped_a4_ref,
                                     blast_matmul_grouped_a8_ref,
                                     blast_matmul_grouped_q4_ref,
                                     blast_matmul_grouped_q_ref,
                                     blast_matmul_grouped_ref,
                                     blast_matmul_ref)

plain = blast_matmul_ref
plain_grouped = blast_matmul_grouped_ref
plain_grouped_q = blast_matmul_grouped_q_ref
plain_grouped_a8 = blast_matmul_grouped_a8_ref
plain_grouped_q4 = blast_matmul_grouped_q4_ref
plain_grouped_a4 = blast_matmul_grouped_a4_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "blast_matmul_f32": [_P] * 5 + [_I] * 6 + [_P],
    "blast_matmul_bf16": [_P] * 5 + [_I] * 6 + [_P],
    "blast_matmul_q_f32": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_q_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_w8a8_f32": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_w8a8_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_q4_f32": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_q4_bf16": [_P] * 8 + [_I] * 6 + [_P],
    "blast_matmul_w4a8_f32": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_w4a8_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "blast_matmul_tile_t": [],
    "blast_matmul_tile_r": [],
}
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_CODES = {8: torch.int8, 4: torch.uint8}    # factor storage by bits
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
    """Validate the kernel's layout; returns (T, G, b, p, q, r) with r the
    logical rank (twice the row bytes for packed uint8 factors)."""
    T, n = x.shape
    G, b, p, rb = U.shape
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
    if S.shape != (G, b, b, rb) or V.shape != (G, b, q, rb) or n != b * q:
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, U "
                         f"{tuple(U.shape)}, S {tuple(S.shape)}, V "
                         f"{tuple(V.shape)}")
    want = {"su": (G, b), "ss": (G, b, b), "sv": (G, b), "sx": (T, 1)}
    for name, a in scales:
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{want[name]}")
    r = 2 * rb if factor_dtype == torch.uint8 else rb
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
    build.refuse_grad("blast_matmul", x, U, S, V)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"blast_matmul kernel takes fp32 or bf16, got {x.dtype}")
    T, G, b, p, q, r = _check(x, U, S, V, x.dtype)
    y = torch.empty((G, T, b * p), dtype=x.dtype, device=x.device)
    return _run(f"blast_matmul_{_SUFFIX[x.dtype]}", (x, U, S, V),
                (T, G, b, p, q, r), y)


def _launch_q(bits: int, x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
              V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    name = "blast_matmul_q" if bits == 8 else "blast_matmul_q4"
    build.refuse_grad(name, x)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")
    T, G, b, p, q, r = _check(x, U, S, V, _CODES[bits],
                              (("su", su), ("ss", ss), ("sv", sv)))
    y = torch.empty((G, T, b * p), dtype=x.dtype, device=x.device)
    return _run(f"{name}_{_SUFFIX[x.dtype]}", (x, U, S, V, su, ss, sv),
                (T, G, b, p, q, r), y)


def launch_q(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
             V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
             sv: torch.Tensor) -> torch.Tensor:
    return _launch_q(8, x, U, S, V, su, ss, sv)


def launch_q4(x: torch.Tensor, Up: torch.Tensor, Sp: torch.Tensor,
              Vp: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    return _launch_q(4, x, Up, Sp, Vp, su, ss, sv)


def _launch_a8(bits: int, xq: torch.Tensor, sx: torch.Tensor,
               U: torch.Tensor, S: torch.Tensor, V: torch.Tensor,
               su: torch.Tensor, ss: torch.Tensor, sv: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    name = f"blast_matmul_w{bits}a8"
    build.refuse_grad(name, sx)
    if xq.dtype != torch.int8:
        raise TypeError(f"{name} kernel takes int8 codes, got {xq.dtype}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel writes fp32 or bf16, got {out_dtype}")
    T, G, b, p, q, r = _check(xq, U, S, V, _CODES[bits],
                              (("sx", sx), ("su", su), ("ss", ss),
                               ("sv", sv)))
    y = torch.empty((G, T, b * p), dtype=out_dtype, device=xq.device)
    return _run(f"{name}_{_SUFFIX[out_dtype]}",
                (xq, sx, U, S, V, su, ss, sv), (T, G, b, p, q, r), y)


def launch_w8a8(xq: torch.Tensor, sx: torch.Tensor, U: torch.Tensor,
                S: torch.Tensor, V: torch.Tensor, su: torch.Tensor,
                ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _launch_a8(8, xq, sx, U, S, V, su, ss, sv, out_dtype)


def launch_w4a8(xq: torch.Tensor, sx: torch.Tensor, Up: torch.Tensor,
                Sp: torch.Tensor, Vp: torch.Tensor, su: torch.Tensor,
                ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _launch_a8(4, xq, sx, Up, Sp, Vp, su, ss, sv, out_dtype)
