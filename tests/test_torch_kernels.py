"""The port's kernel wrappers (``repro_torch.kernels.ops``) against the JAX
package's kernel wrappers in interpret mode.

On the CPU the port's wrappers run the kernels' plain PyTorch versions, so
these tests hold that arithmetic — and the wrappers' flattening, padding and
layouts — against the Pallas kernels.  Inputs are made with numpy from fixed
seeds and fed to both packages in fp32; tolerance ``atol = rtol = 1e-5``.
The CUDA kernels themselves are checked on the card by
``test_torch_kernels_gpu.py`` (marked ``gpu``) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import structures as jstructures
from repro.core.structures import StructureConfig as JStructureConfig
from repro.kernels import ops as jops

from repro_torch.configs.base import StructureConfig
from repro_torch.core import structures
from repro_torch.kernels import ops

TOL = dict(atol=1e-5, rtol=1e-5)


def _factors(rng, b, p, q, r, lead=()):
    return (rng.standard_normal((*lead, b, p, r)).astype(np.float32),
            rng.standard_normal((*lead, b, b, r)).astype(np.float32),
            rng.standard_normal((*lead, b, q, r)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lead,b,p,q,r", [
    ((1,), 4, 24, 16, 19),        # T=1, rank not a multiple of 16
    ((2, 5), 4, 16, 16, 14),      # leading axes flattened into T=10
    ((12,), 8, 8, 16, 32),
])
def test_blast_matmul_matches_jax(lead, b, p, q, r):
    rng = np.random.default_rng(hash((lead, b, p, q, r)) % 2**32)
    U, S, V = _factors(rng, b, p, q, r)
    x = rng.standard_normal((*lead, b * q)).astype(np.float32)
    want = np.asarray(jops.blast_matmul(x, U, S, V, interpret=True))
    got = ops.blast_matmul(_t(x), _t(U), _t(S), _t(V)).numpy()
    assert got.shape == (*lead, b * p)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("T,G,b,p,q,r", [
    (1, 2, 4, 16, 16, 19),
    (7, 3, 4, 8, 8, 24),
])
def test_blast_matmul_grouped_matches_jax(T, G, b, p, q, r):
    rng = np.random.default_rng(hash((T, G, b, p, q, r)) % 2**32)
    U, S, V = _factors(rng, b, p, q, r, lead=(G,))
    x = rng.standard_normal((T, b * q)).astype(np.float32)
    want = np.asarray(jops.blast_matmul_grouped(x, U, S, V, interpret=True))
    got = ops.blast_matmul_grouped(_t(x), _t(U), _t(S), _t(V)).numpy()
    assert got.shape == (G, T, b * p)
    np.testing.assert_allclose(got, want, **TOL)


def test_group_apply_pads_members_like_jax():
    """G=2 members with different d_out and rank: the port's group_plan /
    _stack_group / grouped launch / _split_group equal the JAX ones."""
    d_in, b = 64, 4
    st_port = [StructureConfig(kind="blast", b=b, rank=r) for r in (14, 19)]
    st_jax = [JStructureConfig(kind="blast", b=b, rank=r) for r in (14, 19)]
    outs = (96, 64)
    specs = [structures.make_linear(d_in, m, s) for m, s in zip(outs, st_port)]
    jspecs = [jstructures.make_linear(d_in, m, s) for m, s in zip(outs, st_jax)]
    rng = np.random.default_rng(7)
    params = []
    for spec in specs:
        U, S, V = _factors(rng, b, spec.d_out // b, d_in // b, spec.meta["r"])
        params.append({"U": U, "S": S, "V": V})
    x = rng.standard_normal((3, 2, d_in)).astype(np.float32)
    jplan = jstructures.group_plan(jspecs, params)
    plan = structures.group_plan(specs, [{k: _t(v) for k, v in p.items()}
                                         for p in params])
    assert {k: plan[k] for k in ("b", "p", "r", "d_outs")} == \
        {k: jplan[k] for k in ("b", "p", "r", "d_outs")}
    jstack = jstructures._stack_group(params, jplan)
    want = np.asarray(jops.blast_matmul_grouped(
        x, jstack["U"], jstack["S"], jstack["V"], interpret=True))
    tparams = [{k: _t(v) for k, v in p.items()} for p in params]
    stack = structures._stack_group(tparams, plan)
    for k in ("U", "S", "V"):
        np.testing.assert_array_equal(stack[k].numpy(), np.asarray(jstack[k]))
    got = ops.blast_matmul_grouped(_t(x), stack["U"], stack["S"], stack["V"])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ys = structures.group_apply(specs, tparams, _t(x), plan=plan)
    jys = jstructures._split_group(want, jplan, x.shape[:-1], jnp.float32)
    for y, jy in zip(ys, jys):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("C,window", [(1, None), (5, None), (6, 7)])
def test_flash_attention_prefill_matches_jax(C, window):
    B, Hq, Hkv, S, D = 3, 4, 2, 24, 16
    rng = np.random.default_rng(C * 10 + (window or 0))
    q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    offs = rng.integers(0, S - C + 1, size=B).astype(np.int32)
    want = np.asarray(jops.flash_attention_prefill(
        q, k, v, offs, window=window, block_q=8, block_kv=8, interpret=True))
    got = ops.flash_attention_prefill(_t(q), _t(k), _t(v), _t(offs),
                                      window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the cache is read through strides: a (B, S, Hkv, D) layout permuted
    # into (B, Hkv, S, D) gives the same result
    kc = _t(k).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    vc = _t(v).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    got2 = ops.flash_attention_prefill(_t(q), kc, vc, _t(offs), window=window)
    np.testing.assert_allclose(got2.numpy(), want, **TOL)


def test_cpu_path_counts_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    U, S, V = _factors(rng, 4, 4, 4, 5)
    x = _t(rng.standard_normal((2, 16)).astype(np.float32))
    x.requires_grad_(True)
    y = ops.blast_matmul(x, _t(U), _t(S), _t(V))
    y = y + ops.blast_matmul_grouped(x, _t(U)[None], _t(S)[None],
                                     _t(V)[None])[0]
    y.sum().backward()          # the backward's dx runs B1's CPU path too
    q = torch.zeros((1, 2, 1, 8))
    k = torch.zeros((1, 1, 4, 8))
    ops.flash_attention_prefill(q, k, k, torch.zeros(1, dtype=torch.int32))
    ops.flash_attention(q, k, k)
    k8 = torch.zeros((1, 1, 4, 8), dtype=torch.int8)
    s8 = torch.ones((1, 1, 4), dtype=torch.bfloat16)
    ops.flash_attention_prefill_q8(q, k8, k8, s8, s8,
                                   torch.zeros(1, dtype=torch.int32))
    assert ops.launches == {"blast_matmul": 0, "blast_matmul_grouped": 0,
                            "blast_matmul_q": 0, "blast_matmul_grouped_q": 0,
                            "blast_matmul_w8a8": 0,
                            "blast_matmul_grouped_w8a8": 0,
                            "blast_matmul_q4": 0, "blast_matmul_grouped_q4": 0,
                            "blast_matmul_w4a8": 0,
                            "blast_matmul_grouped_w4a8": 0,
                            "flash_attention_prefill": 0,
                            "flash_attention_prefill_q8": 0,
                            "flash_attention": 0, "blast_matmul_dx": 0}


def test_dense_linear_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    spec = structures.make_linear(16, 8, structured=False)
    jspec = jstructures.make_linear(16, 8, structured=False)
    assert spec.kind == jspec.kind == "dense" and spec.shapes == jspec.shapes
    np.testing.assert_allclose(spec.apply({"w": _t(w)}, _t(x)).numpy(),
                               np.asarray(jspec.apply({"w": w}, x)), **TOL)


def test_blast_core_matches_jax():
    """core/blast.py: Alg. 1 as three contractions, the dense matrix and the
    rank solver agree with the reference."""
    from repro.core import blast as jblast
    from repro_torch.core import blast
    m, n, b = 96, 64, 4
    r = blast.rank_for_compression(m, n, b, 0.5, align=16)
    assert r == jblast.rank_for_compression(m, n, b, 0.5, align=16)
    assert blast.num_params(m, n, b, r) == jblast.num_params(m, n, b, r)
    rng = np.random.default_rng(9)
    U, S, V = _factors(rng, b, m // b, n // b, r)
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    jp = jblast.BlastParams(U, S, V)
    tp = blast.BlastParams(_t(U), _t(S), _t(V))
    np.testing.assert_allclose(blast.matmul(_t(x), tp).numpy(),
                               np.asarray(jblast.matmul(x, jp)), **TOL)
    np.testing.assert_allclose(blast.to_dense(tp).numpy(),
                               np.asarray(jblast.to_dense(jp)), **TOL)
    g = torch.Generator().manual_seed(0)
    U2, S2, V2 = blast.init(g, m, n, b, r)
    assert (U2.shape, S2.shape, V2.shape) == ((b, m // b, r), (b, b, r),
                                              (b, n // b, r))
