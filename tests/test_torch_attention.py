"""Full-sequence attention (B4) and the three autograd Functions of the
training path, on the CPU, against the JAX package.

- B4's plain version (``kernels/ref.attention_ref``, the CPU path of
  ``ops.flash_attention``) against the Pallas kernel in interpret mode,
  and the port's ``chunked_attention`` against the reference's: fp32,
  ``atol = rtol = 1e-5``.
- The Functions' explicit backward passes (``ops.BlastMatmulFn``,
  ``ops.BlastMatmulGroupedFn``, ``ops.FlashAttentionFn``) against
  ``torch.autograd`` through the plain versions in float64 (1e-10: the
  same arithmetic in another order), and against ``jax.grad`` of the
  reference's XLA mirrors in fp32 (1e-5 relative to each gradient's
  largest entry).
- The launchers' guard: a kernel called with inputs that require grad
  raises instead of returning a result without a gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blast as jblast
from repro.kernels import ops as jops
from repro.models import ops as jmops

from repro_torch.kernels import blast_matmul as bm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import ops as mops

TOL = dict(atol=1e-5, rtol=1e-5)
F64 = dict(atol=1e-10, rtol=1e-10)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _qkv(seed, B, Hq, Hkv, T, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


# (Hq, Hkv, T, S, causal, window, q_offset)
ATTN_CASES = [
    (4, 2, 24, 24, True, None, 0),
    (4, 2, 24, 24, False, None, 0),
    (4, 1, 20, 20, True, None, 0),        # T not a multiple of the tile
    (4, 2, 32, 32, True, 6, 0),
    (4, 1, 16, 40, True, None, 24),       # S = T + q_offset
    (4, 2, 13, 21, True, 5, 8),
]


@pytest.mark.parametrize("Hq,Hkv,T,S,causal,window,q_offset", ATTN_CASES)
def test_plain_b4_matches_pallas_kernel(Hq, Hkv, T, S, causal, window,
                                        q_offset):
    q, k, v = _qkv(T + S, 2, Hq, Hkv, T, S, 16)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset, block_q=8, block_kv=8,
        interpret=True)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("Hq,Hkv,T,S,causal,window,q_offset", ATTN_CASES)
def test_chunked_attention_matches_reference(Hq, Hkv, T, S, causal, window,
                                             q_offset):
    q, k, v = _qkv(T * S, 2, Hq, Hkv, T, S, 16)
    want = jax.jit(lambda *a: jmops.chunked_attention(
        *a, causal=causal, window=window, q_offset=q_offset, q_chunk=8))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = mops.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                 window=window, q_offset=q_offset, q_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_attention_fully_masked_rows_are_zero():
    """A window of 1 with q_offset past kv_len leaves rows with no visible
    key: the plain version returns 0 there, as the kernels do."""
    q, k, v = (_t(a) for a in _qkv(1, 1, 2, 1, 4, 6, 8))
    out = ref.attention_ref(q, k, v, window=1, q_offset=4, kv_len=5)
    assert torch.all(out[:, :, 1:] == 0) and torch.any(out[:, :, 0] != 0)


def _jax_vjp(fn, inputs, dy):
    """The reference's gradients of ``fn`` at ``inputs`` (one jitted
    program: eager JAX dispatches the unrolled chunks op by op)."""
    def vjp(*args):
        *xs, d = args
        return jax.vjp(fn, *xs)[1](d)
    return jax.jit(vjp)(*(jnp.asarray(a) for a in (*inputs, dy)))


def _grads(fn, inputs, dy):
    xs = [a.clone().requires_grad_(True) for a in inputs]
    y = fn(*xs)
    return y, torch.autograd.grad(y, xs, dy)


def _close_rel(got, want, rtol):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= rtol * scale, (g, w)


@pytest.mark.parametrize("Hq,Hkv,T,S,causal,window,q_offset", ATTN_CASES)
def test_attention_backward(Hq, Hkv, T, S, causal, window, q_offset):
    """The explicit chunked backward equals autograd through the plain
    version (float64) and jax.grad of the reference's chunked attention
    (fp32)."""
    q, k, v = _qkv(7 * T + S, 2, Hq, Hkv, T, S, 16)
    dy = np.random.default_rng(T).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    f64 = [_t(a, torch.float64) for a in (q, k, v)]
    y, got = _grads(lambda *a: ops.flash_attention(*a, **kw, q_chunk=8), f64,
                    _t(dy, torch.float64))
    assert y.grad_fn.name() == "FlashAttentionFnBackward"
    _, want = _grads(lambda *a: ref.attention_ref(*a, **kw), f64,
                     _t(dy, torch.float64))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F64)
    _, got32 = _grads(lambda *a: mops.chunked_attention(*a, **kw, q_chunk=8),
                      [_t(a) for a in (q, k, v)], _t(dy))
    _close_rel(got32, _jax_vjp(
        lambda *a: jmops.chunked_attention(*a, **kw, q_chunk=8),
        (q, k, v), dy), 1e-5)


def _blast(seed, b, p, q, r, T, G=None):
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    return (rng.standard_normal((T, b * q)).astype(np.float32),
            rng.standard_normal((*lead, b, p, r)).astype(np.float32),
            rng.standard_normal((*lead, b, b, r)).astype(np.float32),
            rng.standard_normal((*lead, b, q, r)).astype(np.float32))


def _jblast(x, U, S, V):
    return jblast.matmul(x, jblast.BlastParams(U, S, V))


@pytest.mark.parametrize("b,p,q,r,T", [(4, 6, 5, 7, 9), (2, 16, 8, 19, 3)])
def test_blast_backward(b, p, q, r, T):
    x, U, S, V = _blast(b * r + T, b, p, q, r, T)
    dy = np.random.default_rng(T).standard_normal((T, b * p)).astype(
        np.float32)
    f64 = [_t(a, torch.float64) for a in (x, U, S, V)]
    y, got = _grads(ops.blast_matmul, f64, _t(dy, torch.float64))
    assert y.grad_fn.name() == "BlastMatmulFnBackward"
    _, want = _grads(ref.blast_matmul_ref, f64, _t(dy, torch.float64))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F64)
    _, got32 = _grads(ops.blast_matmul, [_t(a) for a in (x, U, S, V)],
                      _t(dy))
    _close_rel(got32, _jax_vjp(_jblast, (x, U, S, V), dy), 1e-5)


def test_blast_dx_is_blast_of_transpose():
    """dx = blast(dy; V, Sᵀ, U): Aᵀ of a BLAST matrix is the BLAST matrix
    with U and V swapped and S transposed over its block axes."""
    x, U, S, V = (_t(a, torch.float64) for a in _blast(5, 4, 6, 5, 7, 3))
    dy = torch.randn((3, 4 * 6), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(ops.blast_matmul(xg, U, S, V), xg, dy)
    Ut = ref.blast_matmul_ref(dy, V, S.transpose(0, 1), U)
    torch.testing.assert_close(dx, Ut, **F64)
    from repro_torch.core import blast
    dense = blast.to_dense(blast.BlastParams(U, S, V))
    torch.testing.assert_close(dx, dy @ dense, **F64)


@pytest.mark.parametrize("G,b,p,q,r,T", [(2, 4, 6, 5, 7, 9), (3, 2, 8, 8, 5, 4)])
def test_grouped_blast_backward(G, b, p, q, r, T):
    x, U, S, V = _blast(G + r, b, p, q, r, T, G=G)
    dy = np.random.default_rng(G).standard_normal((G, T, b * p)).astype(
        np.float32)
    f64 = [_t(a, torch.float64) for a in (x, U, S, V)]
    y, got = _grads(ops.blast_matmul_grouped, f64, _t(dy, torch.float64))
    assert y.grad_fn.name() == "BlastMatmulGroupedFnBackward"
    _, want = _grads(ref.blast_matmul_grouped_ref, f64, _t(dy, torch.float64))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F64)
    _, got32 = _grads(ops.blast_matmul_grouped, [_t(a) for a in (x, U, S, V)],
                      _t(dy))
    _close_rel(got32, _jax_vjp(
        lambda x_, U_, S_, V_: jnp.stack([_jblast(x_, U_[g], S_[g], V_[g])
                                          for g in range(G)]),
        (x, U, S, V), dy), 1e-5)


@pytest.fixture
def no_library(monkeypatch):
    """Stub out the kernels' libraries: a test using it needs no card and
    fails if anything tries to launch."""
    def refuse():
        raise AssertionError("a kernel library was loaded")
    monkeypatch.setattr(bm, "_lib", refuse)
    monkeypatch.setattr(fa, "_lib", refuse)


def test_launchers_refuse_inputs_that_require_grad(no_library):
    x = torch.randn(8, 16, requires_grad=True)
    U, S, V = torch.randn(1, 4, 4, 16), torch.randn(1, 4, 4, 16), \
        torch.randn(1, 4, 4, 16)
    q = torch.randn(1, 2, 8, 8, requires_grad=True)
    k = v = torch.randn(1, 1, 8, 8)
    calls = [lambda: bm.launch(x, U, S, V),
             lambda: bm.launch_q(x, U, S, V, None, None, None),
             lambda: fa.launch_full(q, k, v, causal=True, window=None,
                                    q_offset=0, kv_len=8),
             lambda: fa.launch(q, k, v, torch.zeros(1), causal=True,
                               window=None, kv_len=8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
    # without grad mode the guard passes and the device check refuses the
    # CPU tensors, before any library is touched
    with torch.no_grad():
        for call in (calls[0], calls[2], calls[3]):
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                call()
