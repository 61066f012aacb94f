"""The port past smollm-135m's shapes, on the CPU: BLAST linears whose input
width n = b·q passes 2,048 (where the tile kernel stages the input axis in
panels) and attention at head dim 256.

- The launch plan of the weight-only quantized kernels, in pure Python:
  ``blast_matmul.padded_rank`` pads r to the tile kernel's rank granule
  (int4: the byte axis to half the padded rank), and every split that
  ``split_plan`` makes at that rank covers whole int4 bytes (and whole r
  tiles), the splits cover the row once, and the output-block groups
  cover b once.
- The plain versions that the card's kernels are held to, against the JAX
  package: ``ops.blast_matmul`` and ``ops.blast_matmul_q`` (int8 and int4
  factors) at n = 8192 (b = 16, q = 512) and n = 3072 (b = 6) against the
  reference's oracles (``repro.kernels.ref``) on the reference's own codes
  and scales, fp32, ``atol = rtol = 1e-5`` relative to the output's
  largest entry (sums over 8192 products in another order);
  prefill (B3) and full-sequence (B4) attention at D = 192 and 256 against
  the Pallas kernels in interpret mode, fp32, ``atol = rtol = 1e-5``; and
  B4's autograd Function at D = 256 against ``torch.autograd`` through
  the plain version in float64 (1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import quant
from repro_torch.kernels import blast_matmul as bm
from repro_torch.kernels import ops, ref

SMS, TILE_T, TILE_R, TILE_B = 132, 16, 16, 16   # an H100, the tile kernel
TOL = dict(atol=1e-5, rtol=1e-5)
_AXES = {"U": (1, 2), "S": (2,), "V": (1, 2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _factors(rng, b, p, q, r, scale):
    return {"U": rng.standard_normal((b, p, r)).astype(np.float32) * scale,
            "S": rng.standard_normal((b, b, r)).astype(np.float32) * scale,
            "V": rng.standard_normal((b, q, r)).astype(np.float32) * scale}


# -- the launch plan of the quantized tile-kernel launches --------------------


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("stored", [1, 9, 10, 16, 72, 88, 400])
def test_padded_rank_reaches_the_granule(bits, stored):
    r, length = bm.padded_rank(stored, bits, TILE_R)
    logical = 2 * stored if bits == 4 else stored
    assert r % TILE_R == 0 and logical <= r < logical + TILE_R
    assert length == (r // 2 if bits == 4 else r)


@pytest.mark.parametrize("T", [1, 8, 256, 2048])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("r,b", [(19, 4), (144, 16), (176, 16), (800, 16),
                                 (304, 6), (1712, 16)])
def test_quantized_plan_keeps_int4_bytes_whole(T, G, r, b):
    """Packed int4 factors of logical rank r: the byte axis padded to half
    the padded rank; each split's rank range starts and ends on a whole
    16-rank tile, so on an 8-byte boundary of every packed row (the
    kernel's 8-byte copies), and the splits' bytes add up to the row."""
    r_pad, length = bm.padded_rank((r + 1) // 2, 4, TILE_R)
    splits, rps, ipg = bm.split_plan(T, G, r_pad, b, SMS, TILE_T, TILE_R,
                                     TILE_B)
    bounds = [min(r_pad, s * rps) for s in range(splits + 1)]
    assert bounds[-1] == r_pad and length == r_pad // 2
    spans = list(zip(bounds, bounds[1:]))
    assert all(hi > lo and lo % TILE_R == 0 and hi % TILE_R == 0
               for lo, hi in spans)
    assert all((lo // 2) % 8 == 0 for lo, _ in spans)
    assert sum((hi - lo) // 2 for lo, hi in spans) == length
    groups = -(-b // ipg)
    assert ipg <= TILE_B and groups * ipg >= b > (groups - 1) * ipg


# -- plain versions at n past 2048, against the reference's oracles -----------


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("T,b,p,q,r", [(3, 16, 8, 512, 32), (5, 6, 16, 512, 24)])
def test_blast_matmul_wide_matches_oracle(T, b, p, q, r):
    rng = np.random.default_rng(b * q + r)
    fac = _factors(rng, b, p, q, r, 0.25)
    x = rng.standard_normal((T, b * q)).astype(np.float32)
    want = np.asarray(jref.blast_matmul_ref(
        jnp.asarray(x), *(jnp.asarray(fac[k]) for k in "USV")))
    got = ops.blast_matmul(_t(x), *(_t(fac[k]) for k in "USV")).numpy()
    assert got.shape == (T, b * p)
    _close(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("T,b,p,q,r", [(3, 16, 8, 512, 32),
                                       (5, 16, 4, 512, 19),
                                       (2, 6, 16, 512, 24)])
def test_blast_matmul_q_wide_matches_oracle(bits, T, b, p, q, r):
    """B5 (int8) and B7 (packed int4) with float x: the reference
    quantizes, its oracle dequantizes its own codes (int4: unpacked to the
    logical rank r) and runs Alg. 1; the port quantizes the same floats
    into the same codes and scales."""
    rng = np.random.default_rng(bits * 1000 + b * q + r)
    fac = _factors(rng, b, p, q, r, 1.0)
    x = rng.standard_normal((T, b * q)).astype(np.float32)
    jfac = {k: jq.quantize(jnp.asarray(a), bits=bits, block_axes=_AXES[k])
            for k, a in fac.items()}
    codes = {k: jq.int_values(qa) for k, qa in jfac.items()}
    want = np.asarray(jref.blast_matmul_q_ref(
        jnp.asarray(x), codes["U"], codes["S"], codes["V"],
        jfac["U"].scale.reshape(b), jfac["S"].scale.reshape(b, b),
        jfac["V"].scale.reshape(b)))
    tfac = {k: quant.quantize(_t(a), bits=bits, block_axes=_AXES[k])
            for k, a in fac.items()}
    for k in "USV":
        assert np.array_equal(tfac[k].q.numpy(), np.asarray(jfac[k].q))
    got = ops.blast_matmul_q(_t(x), tfac["U"], tfac["S"], tfac["V"]).numpy()
    assert got.shape == (T, b * p)
    _close(got, want)


# -- attention at head dims past 128 ------------------------------------------


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("C,window", [(1, None), (6, 7)])
def test_prefill_attention_wide_head_matches_pallas(D, C, window):
    B, Hq, Hkv, S = 2, 4, 1, 24
    rng = np.random.default_rng(D + C)
    q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    offs = rng.integers(0, S - C + 1, size=B).astype(np.int32)
    want = np.asarray(jops.flash_attention_prefill(
        q, k, v, offs, window=window, block_q=8, block_kv=8, interpret=True))
    got = ops.flash_attention_prefill(_t(q), _t(k), _t(v), _t(offs),
                                      window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("T,S,causal,window,q_offset", [
    (20, 20, True, None, 0), (16, 16, True, 6, 0), (12, 20, True, None, 8),
    (12, 12, False, None, 0)])
def test_full_attention_wide_head_matches_pallas(D, T, S, causal, window,
                                                 q_offset):
    rng = np.random.default_rng(D + T + S)
    q = rng.standard_normal((2, 4, T, D)).astype(np.float32)
    k = rng.standard_normal((2, 2, S, D)).astype(np.float32)
    v = rng.standard_normal((2, 2, S, D)).astype(np.float32)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset, block_q=8, block_kv=8,
        interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_function_grads_at_head_dim_256():
    """B4's Function (explicit chunked backward) at D = 256 against
    torch.autograd through the plain version, float64."""
    g = torch.Generator().manual_seed(7)
    inputs = [torch.randn(s, generator=g, dtype=torch.float64)
              for s in ((2, 4, 20, 256), (2, 2, 20, 256), (2, 2, 20, 256))]
    a = [t.clone().requires_grad_(True) for t in inputs]
    b = [t.clone().requires_grad_(True) for t in inputs]
    kw = dict(causal=True, window=9)
    y = ops.flash_attention(*a, **kw, q_chunk=8)
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad(y, a, dy)
    want = torch.autograd.grad(ref.attention_ref(*b, **kw), b, dy)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=1e-10, rtol=1e-10)
