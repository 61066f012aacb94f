"""Training of every served family on the CPU against the JAX package: the
loss, its metrics and every gradient of ``make_loss_fn`` through the port's
autograd Functions, against ``jax.value_and_grad`` of the reference's loss.

The families, at their test files' reduced configs and seeded weights
(``torch_parity.dense_reference``, ``test_torch_hybrid.hybrid_reference``,
``test_torch_ssd.ssd_reference``, ``test_torch_moe.moe_reference``):
gpt2-blast (LayerNorm, learned positions, GELU), recurrentgemma-2b at 8
layers over 80 tokens (past its 16-slot window: B4 with a window, the
RG-LRU scan), mamba2-130m (the SSD's chunked dual form) and
granite-moe-1b-a400m (reduced; at 32 experts top-8; at capacity factor 0.5,
where assignments drop).  Each JAX program is compiled once without XLA's
backend optimizations (``_unoptimized``).

Tolerances (fp32): ``ce``, ``acc``, ``aux`` and the total within 1e-5
relative; every gradient within 1e-4 × its leaf's largest entry.  The
autograd graph must hold the Functions the card runs: per MoE layer two
``BlastMatmulBatchedFn`` (``wi``, ``wo``), per attention layer one
``FlashAttentionFn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.loss import make_loss_fn as jmake_loss_fn

from repro_torch import weights
from repro_torch.train import make_loss_fn
from repro_torch.tree import leaves, unflatten
from test_torch_hybrid import _unoptimized, hybrid_reference
from test_torch_moe import moe_reference
from test_torch_ssd import ssd_reference
from test_torch_train import _grad_fn_names
from torch_parity import dense_reference

E32K8 = {"n_experts": 32, "top_k": 8, "d_expert": 16}

# family → (fixture call, tokens per row: inputs + 1)
FAMILIES = {
    "gpt2-blast": (lambda: dense_reference("gpt2-blast"), 33),
    "recurrentgemma-2b": (hybrid_reference, 81),
    "mamba2-130m": (ssd_reference, 33),
    "granite-moe": (moe_reference, 33),
    "granite-moe-e32k8": (lambda: moe_reference(**E32K8), 33),
    "granite-moe-cf0.5": (lambda: moe_reference(capacity_factor=0.5), 33),
}


def jax_loss_and_grads(jmodel, tree, toks):
    fn = _unoptimized(jax.jit(jax.value_and_grad(jmake_loss_fn(jmodel),
                                                 has_aux=True)))
    return fn(tree, {"tokens": jnp.asarray(toks)})


def assert_grads_close(model, grads, jgrads) -> None:
    """Every gradient within 1e-4 × its leaf's largest reference entry."""
    want = leaves(weights.from_jax_params(model, jax.tree.map(np.asarray,
                                                              jgrads)))
    assert len(grads) == len(want)
    for i, (g, w) in enumerate(zip(grads, want)):
        err = float((g.detach() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (i, tuple(w.shape), err)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    make, T = FAMILIES[family]
    jmodel, tree, model, params = make()
    toks = np.random.default_rng(5).integers(
        0, model.cfg.vocab, (2, T)).astype(np.int32)
    params = weights.from_jax_params(model, tree)     # fresh leaves
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, met = make_loss_fn(model)(params,
                                    {"tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(loss, flat, retain_graph=True)
    (jloss, jmet), jgrads = jax_loss_and_grads(jmodel, tree, toks)
    names = _grad_fn_names(loss)
    kinds = [s.kind for s in model.specs]
    n_attn = sum(k in ("attn", "local_attn") for k in kinds)
    n_moe = sum(bool(s.moe) for s in model.specs)
    assert names.count("FlashAttentionFnBackward") == n_attn
    assert names.count("BlastMatmulBatchedFnBackward") == 2 * n_moe
    if family.startswith("granite-moe"):
        assert n_moe == model.cfg.n_layers and float(met["aux"].detach()) > 0
    for k in ("ce", "acc", "aux", "loss"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert_grads_close(model, grads, jgrads)


@pytest.mark.parametrize("family", ["gpt2-blast", "recurrentgemma-2b",
                                    "mamba2-130m", "granite-moe"])
def test_decay_mask_is_the_reference_rule(family):
    """``LM.decay_mask`` names the leaves the reference's AdamW decays:
    ``ndim >= 2`` in the reference's layout, where a whole cycle's layers
    are stacked on a leading axis (their vectors decay) and the hybrid's
    two tail layers are not (theirs do not)."""
    _, tree, model, params = FAMILIES[family][0]()
    rule = weights.from_jax_params(model, jax.tree.map(
        lambda a: np.full(a.shape, float(a.ndim >= 2), np.float32), tree))
    want = [bool(a.flatten()[0]) for a in leaves(rule)]
    mask = model.decay_mask(params)
    assert mask == want
    by_leaf = unflatten(params, mask)
    assert by_leaf["layers"][0]["norm1"]["scale"]        # a cycle's vector
    assert not by_leaf["final_norm"]["scale"]
    # the hybrid's 8 layers: 2 cycles of 3, then 2 tail layers
    assert by_leaf["layers"][-1]["norm1"]["scale"] == (
        family != "recurrentgemma-2b")
