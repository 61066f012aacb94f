"""The port's dense decoders past smollm-135m against the JAX package, on
the five configs ported with them — llama7b-blast, gpt2-blast,
qwen1.5-32b, internlm2-1.8b and granite-3-2b — each ``.reduced()``, with
the reference's ``LM.init`` weights carried across by
``repro_torch.weights``.  Together they run an untied vocab head, per-role
BLAST ranks (llama7b-blast with explicit attention and FFN ranks that
differ), LayerNorm, learned positions, the GELU FFN and the QKV bias.  The
weights' norm scales and biases and the QKV bias, which ``init`` leaves at
1 or 0, are moved by seeded noise first (the same tree goes to both
packages), so that each of them changes the logits.  A reference
checkpoint read back by ``weights.load_store`` carries the same leaves.

fp32 on the CPU.  Tolerances: logits ``atol = rtol = 1e-4``; greedy engine
tokens identical at chunk 1/8/32 up to the first output position where the
reference's top-1/top-2 margin is below 1e-4 (``torch_parity``)."""

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store

from repro_torch import weights
from torch_parity import (ROLE_RANKS, TOL, check_engine_tokens,
                          dense_reference, prefill_logits)

ARCHS = ("llama7b-blast", "gpt2-blast", "qwen1.5-32b", "internlm2-1.8b",
         "granite-3-2b")


@pytest.mark.parametrize("name", ARCHS)
def test_logits_match_jax(name):
    """``prefill_chunk`` over three ragged chunks and ``LM.apply`` over a
    full sequence: every live logit within 1e-4 of the reference's.  The
    port builds the shapes the reference builds (per-role ranks too)."""
    jmodel, tree, model, params = dense_reference(name)
    jblk, blk = jmodel.cycle_specs[0], model.specs[0]
    for role in ("mixer", "ffn"):
        for lin in ("qkv", "out", "gate", "up", "wi", "wo"):
            js = getattr(getattr(jblk, role), lin, None)
            if js is not None:
                assert getattr(getattr(blk, role), lin).shapes == js.shapes
    if name in ROLE_RANKS:
        assert (blk.mixer.qkv.meta["r"], blk.ffn.wo.meta["r"]) == \
            ROLE_RANKS[name]
    assert ("head" in params) == (not model.cfg.tie_embeddings)
    assert ("pos" in params) == (model.cfg.pos_embed == "learned")
    got, want, _ = prefill_logits(jmodel, tree, model, params)
    for (g, live), (w, _) in zip(got, want):
        np.testing.assert_allclose(g[live], w[live], **TOL)
    toks = np.random.default_rng(7).integers(0, 512, (2, 24)).astype(np.int32)
    want = np.asarray(jax.jit(jmodel.apply)(tree, toks).logits)
    with torch.no_grad():
        got = model.apply(params, torch.from_numpy(toks)).logits.numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["llama7b-blast", "gpt2-blast"])
def test_greedy_tokens_match_jax_engine(name):
    """The port's engine against the JAX engine at chunk 1, 8 and 32."""
    jmodel, tree, model, params = dense_reference(name)
    check_engine_tokens(jmodel, tree, model, params, chunks=(1, 8, 32))


@pytest.mark.parametrize("name", ARCHS)
def test_load_store_carries_every_leaf(name, tmp_path):
    """A reference checkpoint (``repro/checkpoint/store.py::save``) read by
    ``weights.load_store`` carries the head, the position table and the
    norm and QKV biases: the same logits as the tree carried directly.  A
    leaf the model lacks, or one it misses, raises."""
    jmodel, tree, model, params = dense_reference(name)
    store.save(str(tmp_path), 1, tree)
    loaded = weights.from_jax_params(model, weights.load_store(str(tmp_path)))
    toks = torch.from_numpy(np.arange(12, dtype=np.int64).reshape(2, 6))
    steps, n = np.zeros(2), np.array([6, 4])
    want, _ = model.prefill_chunk(params, model.init_cache(2, 8), toks, steps,
                                  n)
    got, _ = model.prefill_chunk(loaded, model.init_cache(2, 8), toks, steps,
                                 n)
    assert torch.equal(got, want)
    extra = "head" if model.cfg.tie_embeddings else "pos"
    with pytest.raises(ValueError, match=extra):
        weights.from_jax_params(model, {**tree, extra: np.zeros((2, 2))})
    missing = "pos" if "pos" in tree else "head" if "head" in tree else None
    if missing:
        with pytest.raises(ValueError, match="missing"):
            weights.from_jax_params(
                model, {k: v for k, v in tree.items() if k != missing})
