"""The port's model (``repro_torch.models``) against the JAX model on
``smollm-135m.reduced()``, with the reference's ``LM.init(PRNGKey(0))``
weights carried across by ``repro_torch.weights``.

Everything runs in fp32 on the CPU; the port's kernel wrappers take their
plain PyTorch versions there.  Tolerances: modules and logits
``atol = rtol = 1e-4``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.models import layers as JL
from repro.models import ops as jops

from repro_torch import configs, quant, weights
from repro_torch.core import structures
from repro_torch.kernels import ref
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import ops
from torch_parity import reference_lm

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) sharing weights."""
    jmodel, jparams = reference_lm()
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, model, weights.from_jax_params(model, tree)


def _layer(jparams, i):
    return jax.tree.map(lambda a: a[i], jparams["cycles"]["blk_0"])


def test_reduced_config_matches_reference(pair):
    jmodel, _, model, _ = pair
    jc, c = jmodel.cfg, model.cfg
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "head_dim_", "d_ff", "param_dtype", "compute_dtype"):
        assert getattr(c, f) == getattr(jc, f), f
    assert (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim_) == (64, 4, 2, 16)
    jblk, blk = jmodel.cycle_specs[0], model.specs[0]
    for name in ("qkv", "out"):
        js, s = getattr(jblk.mixer, name), getattr(blk.mixer, name)
        assert s.shapes == js.shapes, name
    for name in ("gate", "up", "wo"):
        js, s = getattr(jblk.ffn, name), getattr(blk.ffn, name)
        assert s.shapes == js.shapes, name
    assert sorted({s.meta["r"] for s in (blk.mixer.qkv, blk.mixer.out,
                                         blk.ffn.gate, blk.ffn.wo)}) == [14, 19]
    assert blk.mixer.qkv.meta["b"] == 4


def test_attn_prefill_matches_jax(pair):
    jmodel, jparams, model, params = pair
    jspec, spec = jmodel.cycle_specs[0].mixer, model.specs[0].mixer
    B, C, S = 3, 5, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, C, 64)).astype(np.float32)
    n_tok = np.array([5, 2, 3], np.int32)
    jcache = jax.tree.map(lambda a: a[0],
                          jmodel.init_cache(B, S)["cycles"]["blk_0"]["mixer"])
    jlp = _layer(jparams, 0)["mixer"]
    # warm both caches with one earlier chunk so the kernel reads history
    x0 = rng.standard_normal((B, C, 64)).astype(np.float32)
    s0, n0 = np.zeros(B, np.int32), np.array([0, 4, 5], np.int32)
    steps = s0 + n0
    jprefill = jax.jit(functools.partial(JL.attn_prefill, jspec))
    _, jcache = jprefill(jlp, jcache, x0, s0, n0)
    jy, jcache = jprefill(jlp, jcache, x, steps, n_tok)
    cache = model.init_cache(B, S)[0]
    lp = params["layers"][0]["mixer"]
    L.attn_prefill(spec, lp, cache, torch.from_numpy(x0), s0, n0)
    y, cache = L.attn_prefill(spec, lp, cache, torch.from_numpy(x), steps,
                              n_tok)
    live = np.arange(C)[None, :] < n_tok[:, None]
    np.testing.assert_allclose(y.numpy()[live], np.asarray(jy)[live], **TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


def test_ffn_apply_matches_jax(pair):
    jmodel, jparams, model, params = pair
    jspec, spec = jmodel.cycle_specs[0].ffn, model.specs[0].ffn
    x = np.random.default_rng(2).standard_normal((2, 3, 64)).astype(np.float32)
    japply = jax.jit(functools.partial(JL.ffn_apply, jspec))
    for i in range(model.cfg.n_layers):
        jy = japply(_layer(jparams, i)["ffn"], x)
        y = L.ffn_apply(spec, params["layers"][i]["ffn"], torch.from_numpy(x))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def _chunks():
    """Three successive ragged chunks on one cache: (tokens, n_tokens);
    steps advance by n_tokens.  Includes idle (n_tokens=0) rows."""
    rng = np.random.default_rng(3)
    for n in ([8, 3, 0, 5], [2, 8, 4, 0], [1, 1, 8, 1]):
        yield (rng.integers(0, 512, size=(4, 8)).astype(np.int32),
               np.array(n, np.int32))


def _run_prefills(run, params, cache):
    steps = np.zeros(4, np.int32)
    outs = []
    for toks, n in _chunks():
        logits, cache = run(params, cache, toks, steps, n)
        outs.append((np.asarray(logits, np.float32), n > 0))
        steps = steps + n
    return outs


def test_prefill_chunk_logits_match_jax(pair):
    jmodel, jparams, model, params = pair
    want = _run_prefills(jax.jit(jmodel.prefill_chunk), jparams,
                         jmodel.init_cache(4, 32))
    got = _run_prefills(
        lambda p, c, t, s, n: model.prefill_chunk(p, c, torch.from_numpy(t),
                                                  s, n),
        params, model.init_cache(4, 32))
    for (g, live), (w, _) in zip(got, want):
        assert g.shape == w.shape == (4, 1, 512)
        np.testing.assert_allclose(g[live], w[live], **TOL)


def test_prestacked_params_give_the_same_logits(pair):
    _, _, model, params = pair
    toks = torch.from_numpy(np.arange(16, dtype=np.int64).reshape(2, 8))
    steps, n = np.zeros(2), np.array([8, 5])
    a, _ = model.prefill_chunk(params, model.init_cache(2, 16), toks, steps, n)
    b, _ = model.prefill_chunk(model.prestack_params(params),
                               model.init_cache(2, 16), toks, steps, n)
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_decode_step_and_dispatch_count(pair):
    """decode_step is prefill_chunk at C=1; every layer dispatches qkv, out,
    one grouped gate+up and down."""
    _, _, model, params = pair
    params = model.prestack_params(params)
    toks = torch.tensor([[3], [7]])
    structures.reset_dispatch_count()
    a, _ = model.decode_step(params, model.init_cache(2, 8), toks, 0)
    assert structures.dispatch_count() == 4 * model.cfg.n_layers
    b, _ = model.prefill_chunk(params, model.init_cache(2, 8), toks, [0, 0],
                               [1, 1])
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_kernel_semantics_equal_cache_attention_on_live_columns():
    """The prefill kernel masks by slot index (slot == absolute position);
    the reference model masks by the cache's ``pos``.  On engine-shaped
    slot-static caches — rows written contiguously from 0, a slot reset
    (pos = -1, K = V = 0) when a new request takes a row — the kernel's
    plain version equals the reference's ``cache_attention`` on every live
    column.  Dead columns and idle rows may differ; the engine discards
    them."""
    B, S, Hq, Hkv, D, C = 3, 24, 4, 2, 8, 4
    rng = np.random.default_rng(4)
    k = np.zeros((B, S, Hkv, D), np.float32)
    v = np.zeros((B, S, Hkv, D), np.float32)
    pos = np.full((B, S), -1, np.int32)
    fill = np.zeros(B, np.int32)                 # next position per row
    # (n_tokens per row, row to reset before the chunk)
    schedule = [([4, 2, 0], None), ([3, 4, 1], None), ([1, 1, 4], 1),
                ([4, 1, 1], None), ([1, 4, 4], 0), ([1, 1, 1], None)]
    for n_tok, reset in schedule:
        if reset is not None:
            k[reset], v[reset], pos[reset], fill[reset] = 0, 0, -1, 0
        n_tok = np.array(n_tok, np.int32)
        steps = fill.copy()
        for b in range(B):
            for i in range(n_tok[b]):
                p = steps[b] + i
                k[b, p] = rng.standard_normal((Hkv, D))
                v[b, p] = rng.standard_normal((Hkv, D))
                pos[b, p] = p
        q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
        q_pos = steps[:, None] + np.arange(C)[None, :]
        want = np.asarray(jops.cache_attention(q, k, v, pos, q_pos))
        np.testing.assert_allclose(   # the port's copy of the reference op
            ops.cache_attention(*map(torch.from_numpy, (q, k, v, pos, q_pos))
                                ).numpy(), want, **TOL)
        got = ref.attention_prefill_ref(
            torch.from_numpy(q), torch.from_numpy(k).permute(0, 2, 1, 3),
            torch.from_numpy(v).permute(0, 2, 1, 3),
            torch.from_numpy(steps)).numpy()
        live = np.arange(C)[None, :] < n_tok[:, None]            # (B, C)
        np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[live],
                                   want.transpose(0, 2, 1, 3)[live], **TOL)
        fill = fill + n_tok


def test_from_jax_params_rejects_unknown_keys(pair):
    jmodel, jparams, model, _ = pair
    pre = jax.tree.map(np.asarray, jax.jit(jmodel.prestack_params)(jparams))
    with pytest.raises(ValueError, match="_bundle_in"):
        weights.from_jax_params(model, pre)
    tree = jax.tree.map(np.asarray, jparams)
    with pytest.raises(ValueError, match="head"):
        weights.from_jax_params(model, {**tree, "head": {"w": np.zeros(1)}})


def test_load_store_gives_the_same_logits(pair, tmp_path):
    jmodel, jparams, model, params = pair
    path = store.save(str(tmp_path), 3, jparams)
    loaded = weights.from_jax_params(model, weights.load_store(str(tmp_path)))
    toks = torch.from_numpy(np.arange(12, dtype=np.int64).reshape(2, 6))
    steps, n = np.zeros(2), np.array([6, 4])
    want, _ = model.prefill_chunk(params, model.init_cache(2, 8), toks, steps, n)
    got, _ = model.prefill_chunk(loaded, model.init_cache(2, 8), toks, steps, n)
    assert torch.equal(got, want)
    # bf16 leaves are stored as a uint16 view and come back exactly
    bf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    store.save(str(tmp_path / "bf16"), 0, bf)
    tree = weights.load_store(str(tmp_path / "bf16" / "step_00000000"))
    np.testing.assert_array_equal(
        tree["embed"], np.asarray(bf["embed"].astype(jnp.float32)))
    assert path.endswith("step_00000003")


def test_int_storage_raises():
    """A mix of storages raises (an int4 factor beside float ones, an int8
    factor beside float ones), and so does a bare integer tensor."""
    cfg = dataclasses.replace(configs.get("smollm-135m").reduced(), n_layers=1)
    model = build_model(cfg, device="cpu")
    toks = torch.zeros((1, 1), dtype=torch.int64)
    for leaf, error, match in (
            (quant.QArray(torch.zeros((4, 32, 10), dtype=torch.uint8),
                          torch.ones((4, 1, 1)), bits=4, last_dim=19),
             NotImplementedError, "mixed storage"),
            (quant.quantize(torch.ones((4, 32, 19)), block_axes=(1, 2)),
             NotImplementedError, "mixed storage"),
            (torch.zeros((4, 32, 19), dtype=torch.int8), TypeError, "QArray")):
        params = model.init(0)
        params["layers"][0]["mixer"]["qkv"]["U"] = leaf
        with pytest.raises(error, match=match):
            model.prefill_chunk(params, model.init_cache(1, 4), toks, [0], [1])
