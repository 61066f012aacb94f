"""Compression in the port — Algorithm 2 (``core/factorize.py``) and the
structure fits of ``core/compress.py`` — against the JAX package, in fp32
on the CPU, on weights drawn with numpy.

The reference draws its starts from JAX keys; each test draws them with
the reference's own calls and hands them to the port (``start=``).  SVD
signs differ between libraries, so the closed forms are judged on their
products.  Tolerances: Algorithm 2's losses and factor products after 20
steps, every optimizer, within 1e-4 relative; the SVD and block
extraction's products within 1e-5; the Adam fits (Monarch, Pixelfly) from
a shared start within 1e-4; ``compress_tree`` over a layer axis as
``compress_linear`` layer by layer.  The reference's factorizations and
its fits are each compiled once, as one program, without backend
optimizations.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcompress
from repro.core import factorize as jfactorize
from repro.core import structures as js

from repro_torch.configs import StructureConfig
from repro_torch.core import blast, compress, factorize, structures
from test_torch_hybrid import _unoptimized

M, N, B, R = 64, 48, 4, 8
SEED = 1
OPTIMIZERS = {"precondition": {},
              "gd": {"precondition": False, "lr": 0.05},
              "spectral": {"spectral_steps": True}}


def _weight(d_in, d_out, seed=0):
    """A power-law spectrum (the reference example's ``synth_weight``),
    drawn with numpy."""
    rng = np.random.default_rng(seed)
    r = min(d_in, d_out)
    u, _ = np.linalg.qr(rng.standard_normal((d_in, r)))
    v, _ = np.linalg.qr(rng.standard_normal((d_out, r)))
    s = np.arange(1, r + 1, dtype=np.float64) ** -1.0
    return ((u * s) @ v.T).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blast_start(seed, m, n, b, r):
    """The reference's start (``factorize``'s draws from ``PRNGKey(seed)``)
    as (U0, S0, V0) tensors, drawn by one compiled program."""
    p, q = m // b, n // b

    def draw(key):
        ku, kv, ks = jax.random.split(key, 3)
        return (1e-2 * jax.random.normal(ku, (b, p, r), dtype=jnp.float32),
                jax.random.uniform(ks, (b, b, r), dtype=jnp.float32),
                1e-2 * jax.random.normal(kv, (b, q, r), dtype=jnp.float32))
    out = _unoptimized(jax.jit(draw))(jax.random.PRNGKey(seed))
    return tuple(torch.from_numpy(np.array(a)) for a in out)


@functools.lru_cache(maxsize=1)
def _reference_factorize():
    """The reference's 20 steps with each optimizer, one program."""
    A = _weight(N, M).T                                  # (m, n)
    fn = _unoptimized(jax.jit(lambda a, k: {
        opt: jfactorize.factorize(a, B, R, steps=20, key=k, **kw)
        for opt, kw in OPTIMIZERS.items()}))
    res = fn(jnp.asarray(A), jax.random.PRNGKey(SEED))
    return A, jax.tree.map(np.asarray, res)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_factorize_matches_reference(opt):
    """20 steps from the reference's start: the loss before each step, the
    final loss and the factors' product within 1e-4 relative;
    ``normalized_error`` within 1e-5."""
    A, want = _reference_factorize()
    want = want[opt]
    got = factorize.factorize(torch.from_numpy(A), B, R, steps=20,
                              start=_blast_start(SEED, M, N, B, R),
                              **OPTIMIZERS[opt])
    np.testing.assert_allclose(got.losses.numpy(), want.losses, rtol=1e-4)
    np.testing.assert_allclose(float(got.final_loss), float(want.final_loss),
                               rtol=1e-4)
    assert float(got.final_loss) < float(want.losses[0])   # it fits
    dense = blast.to_dense(got.params).numpy()
    want_dense = (np.einsum("ipr,ijr,jqr->ipjq", *want.params)
                  .reshape(M, N))
    np.testing.assert_allclose(dense, want_dense,
                               atol=1e-4 * np.abs(want_dense).max())
    np.testing.assert_allclose(
        float(factorize.normalized_error(torch.from_numpy(A), got.params)),
        float(np.linalg.norm(A - want_dense) / np.linalg.norm(A)), rtol=1e-4)


def test_factorize_weight_and_generator_start():
    """``factorize_weight`` factorizes wᵀ and returns w's type; the start a
    generator draws is the reference's distribution, and two draws from one
    seed agree."""
    w = torch.from_numpy(_weight(N, M, seed=1)).to(torch.bfloat16)
    out = factorize.factorize_weight(
        w, B, R, steps=5, generator=torch.Generator().manual_seed(3))
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        "U": ((B, M // B, R), torch.bfloat16),
        "S": ((B, B, R), torch.bfloat16),
        "V": ((B, N // B, R), torch.bfloat16)}
    again = factorize.factorize_weight(
        w, B, R, steps=5, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(out[k], again[k]) for k in out)


# (kind, structure fields): the closed forms, the Adam fits and BLAST
KINDS = {"low_rank": ("low_rank", {}), "block_diag": ("block_diag", {"b": B}),
         "monarch": ("monarch", {"b": B}), "pixelfly": ("pixelfly", {"b": B}),
         "blast": ("blast", {"b": B, "rank": R})}


def _specs(name, d_in=N, d_out=M):
    kind, kw = KINDS[name]
    return (js.make_linear(d_in, d_out, js.StructureConfig(kind=kind, **kw)),
            structures.make_linear(d_in, d_out, StructureConfig(kind=kind,
                                                                **kw)))


def _start(name, jspec):
    """The reference's start for ``compress_linear(key=PRNGKey(SEED))``:
    the Adam fits' ``spec.init``, BLAST's factorize draws."""
    if name == "blast":
        return _blast_start(SEED, jspec.d_out, jspec.d_in, B, R)
    if name in ("monarch", "pixelfly"):
        init = _unoptimized(jax.jit(
            lambda k: jspec.init(k, dtype=jnp.float32)))
        return {k: torch.from_numpy(np.array(v)) for k, v in
                init(jax.random.PRNGKey(SEED)).items()}
    return None


def _product(spec, params, x):
    with torch.no_grad():
        return spec.apply({k: v.float() for k, v in params.items()},
                          torch.from_numpy(x)).numpy()


X = np.random.default_rng(5).standard_normal((6, N)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _reference_fits():
    """Each kind's reference fit (``compress_linear(key=PRNGKey(SEED))``,
    20 steps), its product on X and its matrix, from one program."""
    w = _weight(N, M, seed=2)

    def run(a, k, x):
        out = {}
        for name in KINDS:
            jspec = _specs(name)[0]
            jp = jcompress.compress_linear(a, jspec, key=k, steps=20)
            out[name] = (jspec.apply(jp, x), jspec.apply(jp, jnp.eye(N)))
        return out
    return w, jax.tree.map(np.asarray, _unoptimized(jax.jit(run))(
        jnp.asarray(w), jax.random.PRNGKey(SEED), X))


@pytest.mark.parametrize("name", list(KINDS))
def test_compress_linear_matches_reference(name):
    """Products on a test input: SVD and extraction within 1e-5 of the
    output's scale, the fits within 1e-4; ``reconstruction_error`` within
    1e-4 relative (the reference's is its matrix's, ``apply`` on I); the
    structure's params of the spec's shapes."""
    jspec, spec = _specs(name)
    w, fits = _reference_fits()
    want, dense = fits[name]
    p = compress.compress_linear(torch.from_numpy(w), spec, steps=20,
                                 start=_start(name, jspec))
    assert {k: tuple(v.shape) for k, v in p.items()} == spec.shapes
    tol = 1e-5 if name in ("low_rank", "block_diag") else 1e-4
    np.testing.assert_allclose(_product(spec, p, X), want,
                               atol=tol * np.abs(want).max())
    np.testing.assert_allclose(
        compress.reconstruction_error(torch.from_numpy(w), spec, p),
        np.linalg.norm(dense - w) / np.linalg.norm(w), rtol=1e-4)


def test_compress_tree_layer_axis():
    """Two named weights, one stacked over 2 layers: the layer-by-layer
    result equals ``compress_linear`` of each name's layers in name order,
    drawing their starts from one generator in turn, stacked; BLAST's
    error is below block-diagonal's (the paper's Tables 3/12, on a
    power-law spectrum)."""
    ws = torch.from_numpy(np.stack([_weight(N, M, seed=s) for s in (6, 7)]))
    specs = {"a": _specs("blast")[1], "b": _specs("block_diag")[1]}
    out = compress.compress_tree({"a": ws, "b": ws}, specs, steps=10,
                                 layer_axis=True,
                                 generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    for name in ("a", "b"):
        for i in range(2):
            one = compress.compress_linear(ws[i], specs[name], steps=10,
                                           generator=gen)
            assert all(torch.equal(out[name][k][i], one[k]) for k in one)
    flat = compress.compress_tree({"w": ws[0]}, {"w": specs["a"]}, steps=10,
                                  generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(flat["w"][k], out["a"][k][0]) for k in flat["w"])
    e_blast = compress.reconstruction_error(ws[0], specs["a"], flat["w"])
    e_bd = compress.reconstruction_error(ws[0], specs["b"],
                                         {"w": out["b"]["w"][0]})
    assert e_blast <= e_bd
