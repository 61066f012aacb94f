"""The paper's baseline structures in the port — low-rank, Monarch (exact
and rectangular) and Pixelfly (with and without its low-rank term) —
against the JAX package's, in fp32 on the CPU, on weights drawn by the
reference's ``init`` (or with numpy in ``LM.init``'s layout,
``_seeded_tree``).

- each kind's ``apply`` and ``apply_q`` within 1e-5, in float, int8 and
  int4, and with the activation mode "int8", where the reference keeps
  these kinds weight-only; codes and scales bit for bit;
- the rank tools over low-rank linears in three storages: ``rank_spectrum``
  within 1e-5 relative, ``truncate_rank``'s kept components equal, the
  int4 repack exact; ``pad_rank`` leaves a low-rank linear as it is and
  ``stack_size`` is 0 for it (two faults once ``rank_kind`` returned
  "low_rank");
- the exact embeddings into BLAST (``from_low_rank``, ``from_block_diagonal``,
  ``from_monarch``, ``from_dense_svd``) and ``init_paper``: ``to_dense``
  within 1e-5 of the source's matrix and the reference's, the BLAST apply
  within 1e-5 of the source structure's;
- ``configs.VARIANTS`` and ``variant`` against the reference's;
  ``LM.apply`` logits of smollm-135m reduced (one layer) in every variant
  within 1e-4; ``from_jax_params`` of the new kinds' int8 and int4 trees;
  the decay rule over the new kinds; the families past the dense one under
  a new kind (the MoE experts raise: ROADMAP A7.3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.core import blast as jblast
from repro.core import structures as js
from repro.models import build_model as jbuild_model

from repro_torch import configs, quant, weights
from repro_torch.configs import StructureConfig
from repro_torch.core import blast, structures
from repro_torch.models import build_model
from repro_torch.tree import leaves, unflatten
from test_torch_hybrid import _exact, _seeded_tree, _unoptimized
from torch_parity import quantized_params_equal

# (kind, structure fields, d_in, d_out): Monarch exact and rectangular,
# Pixelfly without (b = 4 at keep 0.5) and with its low-rank term
CASES = {"low_rank": ("low_rank", {}, 64, 96),
         "monarch": ("monarch", {"b": 4}, 64, 96),
         "monarch_rect": ("monarch", {"b": 4, "keep_ratio": 0.2}, 64, 96),
         "pixelfly": ("pixelfly", {"b": 4}, 64, 96),
         "pixelfly_lr": ("pixelfly", {"b": 8, "keep_ratio": 0.9}, 64, 64)}
TOL = dict(atol=1e-5, rtol=1e-5)


def _specs(case):
    kind, kw, d_in, d_out = CASES[case]
    return (js.make_linear(d_in, d_out, js.StructureConfig(kind=kind, **kw)),
            structures.make_linear(d_in, d_out, StructureConfig(kind=kind,
                                                                **kw)))


@functools.lru_cache(maxsize=None)
def _reference_params(case):
    """Factors of the reference's shapes drawn with numpy, N(0, 1/fan-in)."""
    jspec, _ = _specs(case)
    rng = np.random.default_rng(len(case))
    return {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
            for k, s in jspec.shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _reference_outputs(case):
    """The reference's apply, its int8 and int4 params and their apply_q on
    one input."""
    jspec, spec = _specs(case)
    x = np.random.default_rng(1).standard_normal((3, 5, spec.d_in)).astype(
        np.float32)

    def run(p, x):
        out = {"apply": jspec.apply(p, x)}
        for bits in (8, 4):
            out[f"q{bits}"] = jspec.quantize(p, bits)
            out[f"apply_q{bits}"] = jspec.apply_q(out[f"q{bits}"], x)
        return out
    return x, jax.tree.map(np.asarray,
                           _exact(run, _reference_params(case), x))


@pytest.mark.parametrize("case", list(CASES))
def test_apply_and_apply_q_match_reference(case):
    """The reference's ``apply_q`` of these kinds reads no activation mode
    (weight-only); the port's gives the same bits in the "int8" mode."""
    jspec, spec = _specs(case)
    assert spec.shapes == jspec.shapes and spec.meta == jspec.meta
    jp = _reference_params(case)
    x, want = _reference_outputs(case)
    np.testing.assert_allclose(spec.apply(_t(jp), torch.from_numpy(x)).numpy(),
                               want["apply"], **TOL)
    for bits in (8, 4):
        qp = spec.quantize(_t(jp), bits)
        for k, leaf in want[f"q{bits}"].items():
            assert (qp[k].bits, qp[k].shape) == (leaf.bits, tuple(leaf.shape))
            np.testing.assert_array_equal(qp[k].q.numpy(), leaf.q)
            np.testing.assert_array_equal(qp[k].scale.numpy(), leaf.scale)
        got = spec.apply_q(qp, torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want[f"apply_q{bits}"], **TOL)
        with structures.activations("int8"):
            np.testing.assert_array_equal(
                spec.apply_q(qp, torch.from_numpy(x)).numpy(), got)


def _low_rank_params(storage):
    spec = _specs("low_rank")[1]
    jp = _reference_params("low_rank")
    if storage == "float":
        return jp, _t(jp)
    bits = int(storage[3:])
    return _reference_outputs("low_rank")[1][f"q{bits}"], spec.quantize(
        _t(jp), bits)


@functools.lru_cache(maxsize=None)
def _reference_truncated(storage):
    """The reference's spectrum and its truncations at 7, 10 and 19, one
    program."""
    def run(p):
        return js.rank_spectrum(p), [js.truncate_rank(p, r)
                                     for r in (7, 10, 19)]
    return jax.tree.map(np.asarray, _exact(run, _low_rank_params(storage)[0]))


@pytest.mark.parametrize("storage", ["float", "int8", "int4"])
def test_low_rank_rank_tools_match_reference(storage):
    """``rank_kind``, ``linear_rank``, ``rank_spectrum`` and
    ``truncate_rank`` (odd kept ranks) over a low-rank linear."""
    jp, p = _low_rank_params(storage)
    assert structures.rank_kind(p) == "low_rank" == js.rank_kind(jp)
    assert structures.linear_rank(p) == js.linear_rank(jp) == 19
    spectrum, truncated = _reference_truncated(storage)
    np.testing.assert_allclose(structures.rank_spectrum(p).numpy(), spectrum,
                               rtol=1e-5)
    for r, want in zip((7, 10, 19), truncated):
        got = structures.truncate_rank(p, r)
        for k in ("w_down", "w_up"):
            g, w = got[k], want[k]
            if storage == "float":
                np.testing.assert_array_equal(g.numpy(), w)
                continue
            # int4: the kept codes repacked into the reference's bytes
            np.testing.assert_array_equal(g.q.numpy(), w.q)
            np.testing.assert_array_equal(g.scale.numpy(), w.scale)
        assert structures.linear_rank(got) == r


@pytest.mark.parametrize("storage", ["float", "int8", "int4"])
def test_pad_rank_and_stack_size_on_low_rank(storage):
    """Regressions: ``pad_rank`` read ``params["U"]`` through
    ``linear_rank`` and padded the last axis of BLAST's factor names only,
    and ``stack_size`` read ``params["U"]`` of any rank-bearing linear.  A
    low-rank linear runs no tile kernel: ``pad_rank`` returns it as it is,
    and it is no stack; a BLAST linear still pads."""
    _, p = _low_rank_params(storage)
    assert structures.pad_rank(p, 16) is p
    assert structures.stack_size(p) == 0
    spec = structures.make_linear(32, 48, StructureConfig(kind="blast", b=4,
                                                          rank=5))
    bp = spec.init(torch.Generator().manual_seed(0))
    if storage != "float":
        bp = spec.quantize(bp, int(storage[3:]))
    padded = structures.pad_rank(bp, 16)
    assert structures.linear_rank(padded) == 16
    x = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    run = spec.apply if storage == "float" else spec.apply_q
    torch.testing.assert_close(run(padded, x), run(bp, x), atol=1e-6,
                               rtol=1e-6)


def _dense_of(spec, params):
    """The (d_out, d_in) matrix A of a linear (y = x @ Aᵀ)."""
    with torch.no_grad():
        return spec.apply(params, torch.eye(spec.d_in)).T


@pytest.mark.parametrize("kind", ["low_rank", "block_diag", "monarch",
                                  "dense_svd"])
def test_exact_embeddings(kind):
    """Each embedding's ``to_dense`` within 1e-5 of the source matrix and of
    the reference's embedding, and its BLAST apply within 1e-5 of the
    source structure's apply."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    b = 4
    if kind == "dense_svd":
        w = rng.standard_normal((64, 96)).astype(np.float32)
        got = blast.from_dense_svd(torch.from_numpy(w), b, 80)   # t = 64
        want = _unoptimized(jax.jit(
            lambda a: jblast.from_dense_svd(a, b, 80)))(jnp.asarray(w))
        assert got.U.shape == (b, 24, 80)
        np.testing.assert_allclose(blast.to_dense(got).numpy(), w.T, **TOL)
        np.testing.assert_allclose(blast.to_dense(got).numpy(),
                                   np.asarray(jblast.to_dense(want)), **TOL)
        return
    case = {"low_rank": "low_rank", "monarch": "monarch"}.get(kind)
    if case is None:
        spec = structures.make_linear(64, 96, StructureConfig(kind=kind, b=b))
        jp = {"w": rng.standard_normal(spec.shapes["w"]).astype(np.float32)}
    else:
        spec = _specs(case)[1]
        jp = _reference_params(case)
    p = _t(jp)
    if kind == "low_rank":
        got = blast.from_low_rank(p["w_down"], p["w_up"], b)
        want = jblast.from_low_rank(jp["w_down"], jp["w_up"], b)
    elif kind == "block_diag":
        got = blast.from_block_diagonal(p["w"])
        want = jblast.from_block_diagonal(jp["w"])
    else:
        got = blast.from_monarch(p["L"], p["R"])
        want = jblast.from_monarch(jp["L"], jp["R"])
        with pytest.raises(ValueError):      # the rectangular form
            blast.from_monarch(*_t(_reference_params("monarch_rect"))
                               .values())
    dense = _dense_of(spec, p).numpy()
    np.testing.assert_allclose(blast.to_dense(got).numpy(), dense, **TOL)
    np.testing.assert_allclose(blast.to_dense(got).numpy(),
                               np.asarray(jblast.to_dense(want)), **TOL)
    np.testing.assert_allclose(blast.matmul(x, got).numpy(),
                               spec.apply(p, x).numpy(), **TOL)


def test_init_paper():
    """App. C.2: U, V ~ N(0, 0.02), s ~ U(0, 2)."""
    U, S, V = blast.init_paper(torch.Generator().manual_seed(0), 256, 128,
                               4, 64)
    assert (U.shape, S.shape, V.shape) == ((4, 64, 64), (4, 4, 64),
                                           (4, 32, 64))
    assert abs(float(U.std()) - 0.02 ** 0.5) < 0.01
    assert abs(float(V.std()) - 0.02 ** 0.5) < 0.01
    assert 0 <= float(S.min()) and float(S.max()) <= 2
    assert abs(float(S.mean()) - 1.0) < 0.05


def test_variants_match_reference():
    assert configs.VARIANTS == jconfigs.VARIANTS
    for arch in ("smollm-135m", "llama7b-blast", "gpt2-blast",
                 "recurrentgemma-2b"):
        for v in configs.VARIANTS:
            got, want = configs.get(arch, v), jconfigs.get(arch, v)
            assert got.structure_ffn is None is want.structure_ffn
            assert dataclasses.asdict(got.structure) == {
                k: val for k, val in dataclasses.asdict(want.structure).items()
                if k != "tp"}, (arch, v)
    assert configs.get("llama7b-blast").structure_ffn.rank == 1488
    with pytest.raises(KeyError):
        configs.variant(configs.get("smollm-135m"), "blast30")


@functools.lru_cache(maxsize=None)
def variant_reference(v: str):
    """(JAX model, numpy tree, port model, port params) of smollm-135m
    reduced to one layer as the variant ``v``, weights drawn with numpy in
    the layout of the reference's ``LM.init`` (``_seeded_tree``)."""
    jmodel = jbuild_model(jconfigs.get("smollm-135m", v).reduced(n_layers=1))
    tree = _seeded_tree(jmodel, np.random.default_rng(11))
    model = build_model(configs.get("smollm-135m", v).reduced(n_layers=1),
                        device="cpu")
    return jmodel, tree, model, weights.from_jax_params(model, tree)


@functools.lru_cache(maxsize=1)
def _all_logits():
    """The reference's ``LM.apply`` logits of every variant, each on its own
    tokens, as one program."""
    models = {v: variant_reference(v)[0] for v in configs.VARIANTS}
    return _unoptimized(jax.jit(lambda trees, toks: {
        v: m.apply(trees[v], toks[v]).logits for v, m in models.items()}))


def reference_logits(v: str, tree, toks):
    """The reference's logits of ``variant_reference(v)``'s model on
    ``toks`` (6 × 38 tokens, the serving file's margins' shape too), from
    the one program of ``_all_logits``; the other variants read zeros."""
    trees = {u: variant_reference(u)[1] for u in configs.VARIANTS}
    trees[v] = tree
    all_toks = {u: np.zeros_like(toks) for u in configs.VARIANTS}
    all_toks[v] = toks
    return _all_logits()(trees, all_toks)[v]


@pytest.mark.parametrize("v", configs.VARIANTS)
def test_logits_match_reference(v):
    """``LM.apply`` logits of each variant within 1e-4 of the reference's,
    the port's linears of the reference's shapes."""
    jmodel, tree, model, params = variant_reference(v)
    jblk, blk = jmodel.cycle_specs[0], model.specs[0]
    for role, names in (("mixer", ("qkv", "out")),
                        ("ffn", ("gate", "up", "wo"))):
        for name in names:
            assert getattr(getattr(blk, role), name).shapes == getattr(
                getattr(jblk, role), name).shapes
    # the serving file's margins take logits of (6, 38) tokens
    toks = np.random.default_rng(7).integers(0, 512, (6, 38)).astype(np.int32)
    with torch.no_grad():
        got = model.apply(params, torch.from_numpy(toks)).logits.numpy()
    want = np.asarray(reference_logits(v, tree, toks))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


# (attention, FFN structure fields) of a one-layer smollm-135m reduced:
# Monarch rectangular (keep 0.2) and Pixelfly without its low-rank term
# (keep 0.4); Pixelfly with it (keep 0.5), whose w_down and w_up are a
# low-rank linear's leaves
QUANTIZED = {"monarch_rect+pixelfly": ({"kind": "monarch", "b": 4,
                                        "keep_ratio": 0.2},
                                       {"kind": "pixelfly",
                                        "keep_ratio": 0.4}),
             "pixelfly_lr": ({"kind": "pixelfly", "keep_ratio": 0.5},) * 2}


@pytest.mark.parametrize("name", list(QUANTIZED))
def test_from_jax_params_quantized(name):
    """``from_jax_params`` carries the reference's int8 and int4 trees of
    each new kind (its ``LM.quantize_params``): every QArray's bits,
    logical shape (the last-dim check of each new leaf), codes (int4:
    packed bytes) and scales equal the reference's."""
    attn, ffn = QUANTIZED[name]
    jcfg = jconfigs.get("smollm-135m").reduced(
        n_layers=1, structure=js.StructureConfig(**attn),
        structure_ffn=js.StructureConfig(**ffn))
    cfg = configs.get("smollm-135m").reduced(
        n_layers=1, structure=StructureConfig(**attn),
        structure_ffn=StructureConfig(**ffn))
    jmodel = jbuild_model(jcfg)
    tree = _seeded_tree(jmodel, np.random.default_rng(19))
    model = build_model(cfg, device="cpu")
    blk = model.specs[0]
    linears = [blk.mixer.qkv, blk.mixer.out, blk.ffn.gate, blk.ffn.up,
               blk.ffn.wo]
    if name == "pixelfly_lr":
        assert all("w_down" in lin.shapes for lin in linears)
    else:
        assert not blk.mixer.qkv.meta["exact"]
        assert all("w_down" not in lin.shapes for lin in linears[2:])
    jq_trees = _unoptimized(jax.jit(lambda p: [jmodel.quantize_params(
        p, jq.QuantConfig(weights=w)) for w in ("int8", "int4")]))(tree)
    for jqt in jq_trees:
        got = weights.from_jax_params(model, jax.tree.map(np.asarray, jqt))
        assert quantized_params_equal(got, jqt) == 1 + sum(
            len(lin.shapes) for lin in linears)


@pytest.mark.parametrize("v", ["low_rank50", "monarch50", "pixelfly50"])
def test_decay_mask_over_new_kinds(v):
    """The reference's rule (``ndim >= 2`` in its layer-stacked layout):
    every factor of the new kinds decays, the final norm does not."""
    _, tree, model, params = variant_reference(v)
    rule = weights.from_jax_params(model, jax.tree.map(
        lambda a: np.full(a.shape, float(a.ndim >= 2), np.float32), tree))
    mask = model.decay_mask(params)
    assert mask == [bool(a.flatten()[0]) for a in leaves(rule)]
    by_leaf = unflatten(params, mask)
    assert all(leaves(by_leaf["layers"][0]["mixer"]))
    assert not by_leaf["final_norm"]["scale"]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-130m",
                                  "granite-moe-1b-a400m"])
def test_other_families_under_new_kinds(arch):
    """The hybrid and SSD families build and run under each new kind (their
    linears go through the same specs); the MoE experts under a new kind
    are not ported yet and raise, naming ROADMAP A7.3."""
    toks = torch.randint(0, 64, (1, 6), generator=torch.Generator()
                         .manual_seed(0))
    for v in ("low_rank50", "monarch50", "pixelfly50"):
        cfg = configs.get(arch, v).reduced(vocab=64, n_layers=3)
        if cfg.moe is not None:
            with pytest.raises(NotImplementedError, match="A7.3"):
                build_model(cfg, device="cpu").init(0)
            continue
        model = build_model(cfg, device="cpu")
        with torch.no_grad():
            logits = model.apply(model.init(0), toks).logits
        assert logits.shape == (1, 6, 64)
        assert bool(torch.isfinite(logits).all())
