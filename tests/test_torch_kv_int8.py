"""The port's int8 KV cache against the JAX package: the row codec
(``quantize_rows`` / ``dequantize_rows``), attention over int8 K/V (the
plain version the CPU runs and the card's kernel is held against), and the
int8-cache model and engine on ``llama7b-blast.reduced()`` (role-different
ranks, ``torch_parity.dense_reference``).

fp32 on the CPU.  Tolerances: the codes and bf16 scales equal eager JAX bit
for bit; attention over dequantized K/V within 1e-5; logits 1e-4; greedy
engine tokens identical up to the first output position where the
reference's top-1/top-2 margin is below 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.models import build_model as jbuild_model
from repro.models import ops as jops

from repro_torch import quant
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SamplingParams, SchedulerConfig)
from torch_parity import (TOL, check_engine_tokens, dense_reference,
                          prefill_logits)


def _rows(rng):
    """(6, 5, 32) rows: random at several scales, all-zero, constant,
    negative constant, one spike."""
    t = rng.standard_normal((6, 5, 32)).astype(np.float32)
    t[1] *= 1e-3
    t[2] *= 300.0
    t[3, :2] = 0.0
    t[3, 2] = 0.3
    t[3, 3] = -7.25
    t[3, 4] = 0.0
    t[3, 4, 17] = 5.0
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equals_eager_jax(dtype):
    t = torch.from_numpy(_rows(np.random.default_rng(0))).to(
        getattr(torch, dtype))
    q, s = quant.quantize_rows(t)
    jt = jnp.asarray(t.float().numpy()).astype(dtype)
    jqv, jsv = jq.quantize_rows(jt)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert q.shape == t.shape and s.shape == t.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(jsv.astype(jnp.float32)))
    assert torch.all(q[3, 0] == 0) and torch.all(s[3, 0] == 1)   # zero row
    for out in ("float32", "bfloat16"):
        got = quant.dequantize_rows(q, s, getattr(torch, out))
        want = jq.dequantize_rows(jqv, jsv, out)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _contiguous_cache(rng, B, S, Hkv, D, schedule):
    """An engine-shaped slot-static cache, float: rows written contiguously
    from slot 0.  Yields (k, v, pos, steps, n_tokens) before each chunk."""
    k = np.zeros((B, S, Hkv, D), np.float32)
    v = np.zeros((B, S, Hkv, D), np.float32)
    pos = np.full((B, S), -1, np.int32)
    fill = np.zeros(B, np.int32)
    for n_tok in schedule:
        n_tok = np.array(n_tok, np.int32)
        for b in range(B):
            for i in range(n_tok[b]):
                p = fill[b] + i
                k[b, p] = rng.standard_normal((Hkv, D))
                v[b, p] = rng.standard_normal((Hkv, D))
                pos[b, p] = p
        yield k, v, pos, fill.copy(), n_tok
        fill = fill + n_tok


def test_int8_attention_plain_version_matches_jax():
    """The int8-K/V plain version (and the CPU path of its wrapper) equals
    the reference's ``cache_attention`` over ``dequantize_rows`` of the
    same codes and scales, within 1e-5, on every live column (the slot
    masking argument of ``test_torch_model.py``)."""
    B, S, Hq, Hkv, D, C = 3, 24, 4, 2, 16, 4
    rng = np.random.default_rng(1)
    for k, v, pos, steps, n_tok in _contiguous_cache(
            rng, B, S, Hkv, D, [[4, 2, 0], [3, 4, 1], [1, 1, 4], [4, 1, 1]]):
        kq, ks = jq.quantize_rows(jnp.asarray(k))
        vq, vs = jq.quantize_rows(jnp.asarray(v))
        q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
        q_pos = steps[:, None] + np.arange(C)[None, :]
        want = np.asarray(jops.cache_attention(
            q, jq.dequantize_rows(kq, ks, jnp.float32),
            jq.dequantize_rows(vq, vs, jnp.float32), pos, q_pos))
        t = [torch.from_numpy(np.array(a)) for a in (kq, vq)]
        sc = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16) for a in (ks, vs)]
        args = (torch.from_numpy(q), t[0].permute(0, 2, 1, 3),
                t[1].permute(0, 2, 1, 3), sc[0].transpose(1, 2),
                sc[1].transpose(1, 2), torch.from_numpy(steps))
        ops.reset_launches()
        got = ops.flash_attention_prefill_q8(*args).numpy()
        assert ops.launches["flash_attention_prefill_q8"] == 0   # CPU path
        np.testing.assert_array_equal(
            got, ref.attention_prefill_q8_ref(*args).numpy())
        live = np.arange(C)[None, :] < n_tok[:, None]
        np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[live],
                                   want.transpose(0, 2, 1, 3)[live],
                                   atol=1e-5, rtol=1e-5)


def _int8_pair():
    """llama7b-blast reduced with ``quant.cache="int8"`` in both packages,
    on the dense reference's weights."""
    jmodel, tree, model, params = dense_reference("llama7b-blast")
    jmodel8 = jbuild_model(dataclasses.replace(
        jmodel.cfg, quant=jq.QuantConfig(cache="int8")))
    model8 = build_model(dataclasses.replace(
        model.cfg, quant=quant.QuantConfig(cache="int8")), device="cpu")
    return jmodel8, tree, model8, params


def test_int8_cache_leaves_and_logits_match_jax():
    """Three ragged ``prefill_chunk`` steps over the int8 cache: every live
    logit within 1e-4, and every cache leaf — pos, the K/V codes and their
    bf16 scales, per layer — equal to the reference's bit for bit."""
    jmodel, tree, model, params = _int8_pair()
    got, want, (cache, jcache) = prefill_logits(jmodel, tree, model, params)
    for (g, live), (w, _) in zip(got, want):
        np.testing.assert_allclose(g[live], w[live], **TOL)
    jc = jcache["cycles"]["blk_0"]["mixer"]
    assert set(jc) == set(cache[0]) == {"pos", "k", "v", "k_scale",
                                        "v_scale"}
    for i, c in enumerate(cache):
        for name, leaf in c.items():
            want_leaf = np.asarray(jc[name][i])
            if name.endswith("scale"):
                assert leaf.dtype == torch.bfloat16
                want_leaf = np.asarray(jc[name][i].astype(jnp.float32))
                leaf = leaf.float()
            elif name != "pos":
                assert leaf.dtype == torch.int8
            np.testing.assert_array_equal(leaf.numpy(), want_leaf,
                                          err_msg=f"layer {i} {name}")
    assert int((cache[0]["k"] != 0).sum()) > 0


def test_int8_cache_greedy_tokens_match_jax_engine():
    jmodel, tree, model, params = _int8_pair()
    check_engine_tokens(jmodel, tree, model, params, chunks=(1, 8, 32))


def test_reset_slot_clears_every_leaf():
    """An admitted row, reset: pos = -1, codes and scales 0, in every
    layer; the other rows keep what they hold.  A finished request leaves
    its row reset."""
    _, _, model, params = _int8_pair()
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=8),
        memory=MemoryConfig(max_len=32)), device="cpu")
    for uid, prompt in ((1, [3, 1, 4, 1, 5]), (2, [9, 2, 6])):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=4))
    eng.run(max_iters=2)
    held = [{k: v[1].clone() for k, v in c.items()} for c in eng.cache]
    for c in eng.cache:
        assert all(bool((leaf[0] != 0).any()) for leaf in c.values())
    eng._reset_slot(0)
    for c, h in zip(eng.cache, held):
        assert torch.all(c["pos"][0] == -1)
        for name in ("k", "v", "k_scale", "v_scale"):
            assert torch.all(c[name][0] == 0), name
        for name, leaf in c.items():
            assert torch.equal(leaf[1], h[name])
    eng.run()
    for c in eng.cache:
        assert all(torch.all(leaf == (-1 if name == "pos" else 0))
                   for name, leaf in c.items())


def test_engine_takes_the_cache_mode_from_the_model():
    """The int8 cache is a model-construction knob: a float model with a
    cache override in ``EngineConfig.quant`` raises, as the reference's
    engine does; an int8-cache model serves with int8 codes and bf16
    scales, also with int8 weights."""
    _, _, model8, params = _int8_pair()
    _, _, model, _ = dense_reference("llama7b-blast")
    with pytest.raises(ValueError, match="model-construction knob"):
        Engine(model, params, EngineConfig(
            quant=quant.QuantConfig(cache="int8")), device="cpu")
    eng = Engine(model8, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=4),
        memory=MemoryConfig(max_len=32),
        quant=quant.QuantConfig(weights="int8", cache="int8")), device="cpu")
    assert eng.cache[0]["k"].dtype == torch.int8
    assert eng.cache[0]["k_scale"].dtype == torch.bfloat16
    assert quant.tree_is_quantized(eng.params)
    assert eng.params["head"]["w"].bits == 8
    reqs = eng.generate_batch([[1, 2, 3], [4]],
                              SamplingParams(max_new_tokens=3))
    assert all(r.done and len(r.output) == 3 for r in reqs)
