"""Launchers of the fused BLAST CUDA kernels (``csrc/blast_matmul.cu``) and
their plain PyTorch versions.

All take the kernels' own layout — x (T, n), U (G, b, p, r), S (G, b, b, r),
V (G, b, q, r), all contiguous, r a multiple of the kernel's rank granule —
and return y (G, T, m):

- ``launch``: float factors of x's type (fp32 or bf16), through the tile
  kernel (``blast_tile_kernel``: one block per 16-token tile, factor set,
  split of r and group of at most 16 output blocks; any n).  T is not
  padded (the kernel masks its edge); where ⌈T/16⌉·G blocks would leave
  most SMs idle, ``split_plan`` splits r across blocks (and at decode
  groups the output blocks), and a second pass adds the splits' fp32
  partials in order (deterministic);
- ``launch_q``: int8 factor codes with fp32 scales su (G, b), ss (G, b, b),
  sv (G, b), x fp32 or bf16, y of x's type — the same tile kernel and plan,
  its factor tiles staged as codes;
- ``launch_w8a8``: int8 activation codes xq (T, n) with fp32 scales sx
  (T, 1) against int8 factor codes — the same tile kernel and plan, its x
  tile holding the codes and stage 1 on s8 tensor cores; y has
  ``out_dtype``;
- ``launch_q4`` / ``launch_w4a8``: as ``launch_q`` / ``launch_w8a8`` with
  nibble-packed int4 factor codes, uint8 (G, b, ·, r/2): the kernels read
  them packed and take the logical rank r = 2 × bytes.

Each also takes x of shape (G, T, n) — with activation codes sx (G, T, 1)
— for the batched launch (the MoE experts): factor set g on its own rows
x[g], the same tile kernel with a per-set x stride of T·n (and sx stride
T); a (T, n) x is shared by every set (stride 0, the grouped launch).

Callers go through ``kernels/ops.py``, which flattens, pads r, quantizes
the activations and counts launches.  The kernels keep no autograd graph: a
launcher refuses inputs that require grad while grad mode is on
(``build.refuse_grad``); training reaches the float kernel through
``ops.BlastMatmulFn`` / ``ops.BlastMatmulGroupedFn``.
"""

from __future__ import annotations

import ctypes
import functools

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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # inputs, y, part; T, G, b, p, q, r, rps, ipg; the x and sx strides
    "blast_matmul_f32": [_P] * 6 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_bf16": [_P] * 6 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_q_f32": [_P] * 9 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_q_bf16": [_P] * 9 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_w8a8_f32": [_P] * 10 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_w8a8_bf16": [_P] * 10 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_q4_f32": [_P] * 9 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_q4_bf16": [_P] * 9 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_w4a8_f32": [_P] * 10 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_matmul_w4a8_bf16": [_P] * 10 + [_I] * 8 + [_L] * 2 + [_P],
    "blast_float_tile_t": [],
    "blast_float_tile_r": [],
    "blast_float_tile_b": [],
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


def float_tiles() -> tuple[int, int, int]:
    """(token rows per block, rank granule of padding and splits, output
    blocks per block at most) of the tile kernel, which runs every BLAST
    launch."""
    lib = _lib()
    return (lib.blast_float_tile_t(), lib.blast_float_tile_r(),
            lib.blast_float_tile_b())


def padded_rank(stored: int, bits: int | None, tile_r: int) -> tuple[int, int]:
    """(logical ranks, stored length) of a factor rank axis of ``stored``
    elements — ranks, or for nibble-packed int4 (``bits=4``) bytes of two
    ranks each — zero-padded to the granule ``tile_r`` (exact: zero ranks,
    and zero bytes are zero codes)."""
    logical = 2 * stored if bits == 4 else stored
    r = -(-logical // tile_r) * tile_r
    return r, r // 2 if bits == 4 else r


MAX_GROUPS = 4     # output-block groups a launch adds at small T, at most


@functools.lru_cache(maxsize=1024)    # every launch asks; decode is host-bound
def split_plan(T: int, G: int, r: int, b: int, sms: int, tile_t: int,
               tile_r: int, tile_b: int) -> tuple[int, int, int]:
    """(splits, ranks per split, output blocks per group) of a tile-kernel
    launch, whose grid is ⌈T/tile_t⌉ × splits · groups × G blocks (times the
    column chunks the kernel adds where p > 96).  The r range (padded to
    ``tile_r``) is cut into equal runs of whole ``tile_r`` granules, the
    last one possibly shorter, none empty; the b output blocks into equal
    groups of at most ``tile_b``.  Splits: none once the token blocks and
    the groups that b needs fill half of the ``sms`` SMs; below that, as
    many as keep every block in the first wave (one block fits an SM), at
    most one per granule.  Groups: likewise, up to ``MAX_GROUPS`` times
    more while the blocks still fill less than half the SMs (a group copies
    only its own U and S rows: fewer bytes per block at decode)."""
    granules = -(-r // tile_r)
    need = -(-b // tile_b)                  # groups the kernel needs
    blocks = -(-T // tile_t) * G * need
    splits = 1 if 2 * blocks >= sms else sms // blocks
    per = -(-granules // min(splits, granules))
    splits = -(-granules // per)
    used = blocks * splits
    more = 1 if 2 * used >= sms else min(MAX_GROUPS, sms // used)
    return splits, per * tile_r, -(-b // min(need * more, b))


def _check_device(x: torch.Tensor) -> None:
    """Before any library is loaded: x lies on the current CUDA device."""
    if x.device.type != "cuda":
        raise ValueError("blast_matmul kernel needs CUDA tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError("blast_matmul kernel: tensor is not on the current "
                         "CUDA device")


def _check(x, U, S, V, factor_dtype, tile_r: int,
           scales=()) -> tuple[int, ...]:
    """Validate the kernel's layout; returns (T, G, b, p, q, r) with r the
    logical rank (twice the row bytes for packed uint8 factors), a multiple
    of ``tile_r``.  x (T, n), or (G, T, n) batched."""
    T, n = x.shape[-2:]
    G, b, p, rb = U.shape
    batched = x.ndim == 3
    if x.ndim not in (2, 3) or (batched and x.shape[0] != G):
        raise ValueError(f"x has shape {tuple(x.shape)}: want (T, n), or "
                         f"(G, T, n) with G = {G} factor sets")
    q = V.shape[2]
    _check_device(x)
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
    want = {"su": (G, b), "ss": (G, b, b), "sv": (G, b),
            "sx": (G, T, 1) if batched else (T, 1)}
    for name, a in scales:
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, want "
                             f"{want[name]}")
    r = 2 * rb if factor_dtype == torch.uint8 else rb
    if r % tile_r:
        raise ValueError(f"rank {r} is not a multiple of the rank tile "
                         f"{tile_r} (ops.py pads it)")
    return T, G, b, p, q, r


def _check_aligned(**factors) -> None:
    for name, a in factors.items():
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async)")


def _launch_tile(fn_name: str, ins, dtype: torch.dtype,
                 T: int, G: int, b: int, p: int, q: int, r: int,
                 tile_t: int, tile_r: int, tile_b: int) -> torch.Tensor:
    """The tile kernel ``fn_name`` on ``ins`` (x, with activation codes
    their scales sx, then the factors and their scales) as ``split_plan``
    lays it out: y (G, T, b·p) of ``dtype``, with an fp32 workspace for the
    splits' partials.  A (G, T, n) x is batched: set g reads x[g] (and
    sx[g])."""
    dev = ins[0].device
    batched = ins[0].ndim == 3
    xg, sxg = (T * ins[0].shape[-1], T) if batched else (0, 0)
    y = torch.empty((G, T, b * p), dtype=dtype, device=dev)
    if T == 0:
        return y
    n_split, rps, ipg = split_plan(T, G, r, b, build.sm_count(dev), tile_t,
                                   tile_r, tile_b)
    part = (torch.empty((n_split, G, T, b * p), dtype=torch.float32,
                        device=dev) if n_split > 1 else None)
    rc = getattr(_lib(), fn_name)(
        *(a.data_ptr() for a in ins), y.data_ptr(),
        None if part is None else part.data_ptr(), T, G, b, p, q, r, rps,
        ipg, xg, sxg, torch.cuda.current_stream().cuda_stream)
    build.check(rc, f"{fn_name} (T={T}, G={G}, b={b}, p={p}, q={q}, r={r})")
    return y


def launch(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
           V: torch.Tensor) -> torch.Tensor:
    """The float kernel, launched as ``split_plan`` lays it out."""
    build.refuse_grad("blast_matmul", x, U, S, V)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"blast_matmul kernel takes fp32 or bf16, got {x.dtype}")
    _check_device(x)
    tiles_ = float_tiles()
    T, G, b, p, q, r = _check(x, U, S, V, x.dtype, tiles_[1])
    _check_aligned(U=U, S=S, V=V)
    return _launch_tile(f"blast_matmul_{_SUFFIX[x.dtype]}", (x, U, S, V),
                        x.dtype, T, G, b, p, q, r, *tiles_)


def _launch_q(bits: int, x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
              V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    """Weight-only codes through the tile kernel, as ``launch``."""
    name = "blast_matmul_q" if bits == 8 else "blast_matmul_q4"
    build.refuse_grad(name, x)
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel takes fp32 or bf16 x, got {x.dtype}")
    _check_device(x)
    tiles_ = float_tiles()
    T, G, b, p, q, r = _check(x, U, S, V, _CODES[bits], tiles_[1],
                              (("su", su), ("ss", ss), ("sv", sv)))
    _check_aligned(U=U, S=S, V=V)
    return _launch_tile(f"{name}_{_SUFFIX[x.dtype]}",
                        (x, U, S, V, su, ss, sv), x.dtype, T, G, b, p, q, r,
                        *tiles_)


def launch_q(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
             V: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
             sv: torch.Tensor) -> torch.Tensor:
    return _launch_q(8, x, U, S, V, su, ss, sv)


def launch_q4(x: torch.Tensor, Up: torch.Tensor, Sp: torch.Tensor,
              Vp: torch.Tensor, su: torch.Tensor, ss: torch.Tensor,
              sv: torch.Tensor) -> torch.Tensor:
    return _launch_q(4, x, Up, Sp, Vp, su, ss, sv)


def _launch_act(bits: int, xq: torch.Tensor, sx: torch.Tensor,
                U: torch.Tensor, S: torch.Tensor, V: torch.Tensor,
                su: torch.Tensor, ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Activation codes through the tile kernel, as ``launch``."""
    name = f"blast_matmul_w{bits}a8"
    build.refuse_grad(name, sx)
    if xq.dtype != torch.int8:
        raise TypeError(f"{name} kernel takes int8 codes, got {xq.dtype}")
    if out_dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel writes fp32 or bf16, got {out_dtype}")
    _check_device(xq)
    tiles_ = float_tiles()
    T, G, b, p, q, r = _check(xq, U, S, V, _CODES[bits], tiles_[1],
                              (("sx", sx), ("su", su), ("ss", ss),
                               ("sv", sv)))
    _check_aligned(U=U, S=S, V=V)
    return _launch_tile(f"{name}_{_SUFFIX[out_dtype]}",
                        (xq, sx, U, S, V, su, ss, sv), out_dtype, T, G, b, p,
                        q, r, *tiles_)


def launch_w8a8(xq: torch.Tensor, sx: torch.Tensor, U: torch.Tensor,
                S: torch.Tensor, V: torch.Tensor, su: torch.Tensor,
                ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _launch_act(8, xq, sx, U, S, V, su, ss, sv, out_dtype)


def launch_w4a8(xq: torch.Tensor, sx: torch.Tensor, Up: torch.Tensor,
                Sp: torch.Tensor, Vp: torch.Tensor, su: torch.Tensor,
                ss: torch.Tensor, sv: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    return _launch_act(4, xq, sx, Up, Sp, Vp, su, ss, sv, out_dtype)
