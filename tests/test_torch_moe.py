"""The MoE family in the port (``models/moe.py``, the batched expert
kernel's plain versions, stacked-expert linears) against the JAX package,
in fp32 on the CPU.

``granite-moe-1b-a400m.reduced()`` (2 layers, d_model 64, 4 experts top-2
of width 32, BLAST b = 4) — and variants of it at 32 experts top-8 and at
other capacity factors — with weights drawn by numpy in the layout of the
reference's ``LM.init`` (``_seeded_tree``), carried over by
``from_jax_params``; every JAX program compiled without XLA's backend
optimizations (``_unoptimized``):

- routing and dispatch: ``_route`` and ``_dispatch_indices`` against the
  reference's on a grid of skewed routers, capacities and token counts
  (drops, all-tie rows): expert ids, ``slot_token``, ``pos`` and ``keep``
  exactly, gates within 1e-6, ``aux`` within 1e-6;
- ``moe_apply`` at the reduced config and at 32 experts top-8, at capacity
  factors 1.25 (drops) and 64 (dropless): outputs within 1e-5, ``aux``
  within 1e-6;
- the batched plain versions against a loop over the experts of the
  existing plain versions, in the five storages (float, int8, int4, W8A8,
  W4A8) within 1e-6 relative, and stacked quantize against the
  reference's ``moe_quantize``, codes and scales bit for bit;
- the model: ``LM.apply`` logits and ``aux``, and ragged ``prefill_chunk``
  at chunk 1, 8 and 32 (idle rows and dead columns, which the reference
  routes too and which take expert capacity: also at capacity factor 0.5,
  where they change the live rows' outputs), within 1e-4;
- the draft plan over the experts' stack through ``plan_from_jax``;
- a checkpoint directory of the reference's tree, float and int8
  (``checkpoint/store.py::save``), carried over by ``load_store``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.checkpoint import store
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe

from repro_torch import configs, weights
from repro_torch.core import structures
from repro_torch.kernels import ref
from repro_torch.models import build_model, moe
from repro_torch.quant import qarray as qt
from test_torch_hybrid import _seeded_tree, _unoptimized
from torch_parity import TOL, leaves_equal

ARCH = "granite-moe-1b-a400m"
EXACT = dict(atol=1e-5, rtol=1e-5)


def configs_pair(**moe_kw):
    """(JAX config, port config): ``reduced()`` with ``moe_kw`` replacing
    fields of its reduced ``MoECfg``."""
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe_kw)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                             **moe_kw)))


@functools.lru_cache(maxsize=None)
def moe_reference(**moe_kw):
    """(JAX model, numpy params, port model, port params) of the reduced
    config with ``moe_kw``; the weights drawn with numpy (seed 29)."""
    jcfg, cfg = configs_pair(**moe_kw)
    jmodel = jbuild_model(jcfg)
    tree = _seeded_tree(jmodel, np.random.default_rng(29))
    model = build_model(cfg, device="cpu")
    return jmodel, tree, model, weights.from_jax_params(model, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- routing and dispatch ----------------------------------------------------


def _skewed(rng, E, d, Tl, skew, zero_rows):
    """Router weights whose experts' logits grow with ``skew`` along one
    shared direction, tokens that all lean that way (so experts overflow),
    and ``zero_rows`` all-zero tokens (every probability tied)."""
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    w = (rng.standard_normal((d, E)) / np.sqrt(d)
         + skew * np.outer(u, np.linspace(0.0, 1.0, E))).astype(np.float32)
    x = (rng.standard_normal((Tl, d)) + 2.0 * u).astype(np.float32)
    x[:zero_rows] = 0.0
    return w, x


@pytest.mark.parametrize("E,k", [(4, 2), (32, 8)])
@pytest.mark.parametrize("skew", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("Tl,cf", [(8, 1.25), (40, 1.25), (40, 0.5)])
def test_route_and_dispatch_equal_reference(E, k, skew, Tl, cf):
    jcfg, cfg = configs_pair(n_experts=E, top_k=k, capacity_factor=cf)
    jspec, spec = jmoe.make_moe(jcfg), moe.make_moe(cfg)
    rng = np.random.default_rng(E * 100 + int(skew * 10) + Tl)
    w, x = _skewed(rng, E, cfg.d_model, Tl, skew, zero_rows=2)
    jg, je, jaux = jmoe._route(jspec, {"w": jnp.asarray(w)}, jnp.asarray(x))
    g, e, aux = moe._route(spec, {"w": _t(w)}, _t(x))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert e[0].tolist() == list(range(k))   # a zero row ties: lowest ids
    capacity = max(1, int(np.ceil(Tl * k * cf / E)))
    jst, jpos, jkeep = jmoe._dispatch_indices(je, E, capacity)
    st, pos, keep = moe._dispatch_indices(e, E, capacity)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if skew == 4.0:
        assert not keep.all()            # the grid has teeth: drops


@pytest.mark.parametrize("moe_kw", [
    {}, {"capacity_factor": 64.0},
    {"n_experts": 32, "top_k": 8, "d_expert": 16},
    {"n_experts": 32, "top_k": 8, "d_expert": 16, "capacity_factor": 64.0}],
    ids=["reduced", "reduced-dropless", "e32k8", "e32k8-dropless"])
def test_moe_apply_equals_reference(moe_kw):
    jmodel, tree, model, params = moe_reference(**moe_kw)
    jspec, spec = jmodel.cycle_specs[0].ffn, model.specs[0].ffn
    ffn = jax.tree.map(lambda a: a[0], tree["cycles"]["blk_0"]["ffn"])
    x = np.random.default_rng(7).standard_normal((3, 11, 64)).astype(
        np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(jspec, p, x))(ffn, x)
    y, aux = moe.moe_apply(spec, params["layers"][0]["ffn"], _t(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EXACT)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_moe_refusals():
    """Shared experts and first dense layers wait for ROADMAP A7.2, a mesh
    for A9."""
    _, cfg = configs_pair()
    for over in ({"n_shared": 1, "d_shared": 32}, {"first_dense_layers": 1}):
        bad = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **over))
        with pytest.raises(NotImplementedError, match="A7.2"):
            build_model(bad, device="cpu")
    _, _, model, params = moe_reference()
    with pytest.raises(NotImplementedError, match="A9"):
        moe.moe_apply(model.specs[0].ffn, params["layers"][0]["ffn"],
                      torch.zeros((1, 2, 64)), mesh=object())


# -- the batched expert kernel's plain versions and stacked quantize ---------


@pytest.mark.parametrize("storage", ["float", "int8", "int4", "w8a8",
                                     "w4a8"])
def test_batched_plain_equals_expert_loop(storage):
    rng = np.random.default_rng(11)
    E, T, b, p, q, r = 3, 5, 4, 6, 8, 12
    U, S, V = (_t(rng.standard_normal(s).astype(np.float32))
               for s in ((E, b, p, r), (E, b, b, r), (E, b, q, r)))
    x = _t(rng.standard_normal((E, T, b * q)).astype(np.float32))
    x[1, -1] = 0.0                     # an empty capacity slot
    if storage == "float":
        got = ref.blast_matmul_batched_ref(x, U, S, V)
        want = [ref.blast_matmul_ref(x[e], U[e], S[e], V[e])
                for e in range(E)]
    else:
        bits = 4 if storage in ("int4", "w4a8") else 8
        qs = [qt.quantize(a, bits=bits, block_axes=ax)
              for a, ax in ((U, (2, 3)), (S, (3,)), (V, (2, 3)))]
        codes = [a.q for a in qs]
        sc = (qs[0].scale.reshape(E, b), qs[1].scale.reshape(E, b, b),
              qs[2].scale.reshape(E, b))
        if storage in ("int8", "int4"):
            batched = (ref.blast_matmul_batched_q4_ref if bits == 4
                       else ref.blast_matmul_batched_q_ref)
            loop = (ref.blast_matmul_grouped_q4_ref if bits == 4
                    else ref.blast_matmul_grouped_q_ref)
            got = batched(x, *codes, *sc)
            want = [loop(x[e], *(a[e:e + 1] for a in (*codes, *sc)))[0]
                    for e in range(E)]
        else:
            xq, sx = qt.quantize_act(x)
            assert float(sx[1, -1]) == 1.0      # a zero row's scale
            batched = (ref.blast_matmul_batched_a4_ref if bits == 4
                       else ref.blast_matmul_batched_a8_ref)
            loop = (ref.blast_matmul_grouped_a4_ref if bits == 4
                    else ref.blast_matmul_grouped_a8_ref)
            got = batched(xq, sx, *codes, *sc)
            want = [loop(xq[e], sx[e], *(a[e:e + 1] for a in
                                         (*codes, *sc)))[0]
                    for e in range(E)]
    want = torch.stack(want)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("bits", [8, 4])
def test_stacked_quantize_equals_reference(bits):
    jmodel, tree, model, params = moe_reference()
    jspec = jmodel.cycle_specs[0].ffn
    ffn = jax.tree.map(lambda a: a[0], tree["cycles"]["blk_0"]["ffn"])
    want = jmoe.moe_quantize(jspec, ffn, bits)
    got = moe.moe_quantize(model.specs[0].ffn, params["layers"][0]["ffn"],
                           bits)
    assert leaves_equal({k: got[k] for k in ("wi", "wo")},
                        {k: want[k] for k in ("wi", "wo")}) == 6
    assert not qt.is_qarray(got["router"]["w"])   # the router stays float
    assert got["router"]["w"].dtype == torch.float32
    # one expert's slice equals that expert quantized alone
    one = structures.unstack(got["wi"])[2]
    alone = model.specs[0].ffn.wi.quantize(
        structures.unstack(params["layers"][0]["ffn"]["wi"])[2], bits)
    for k in ("U", "S", "V"):
        assert torch.equal(one[k].q, alone[k].q)
        assert torch.equal(one[k].scale, alone[k].scale)


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("moe_kw", [{}, {"n_experts": 32, "top_k": 8,
                                         "d_expert": 16}],
                         ids=["reduced", "e32k8"])
def test_apply_logits_and_aux(moe_kw):
    jmodel, tree, model, params = moe_reference(**moe_kw)
    toks = np.random.default_rng(2).integers(0, 512, (3, 13)).astype(
        np.int32)
    jout = _unoptimized(jax.jit(lambda p, t: jmodel.apply(p, t)))(
        tree, jnp.asarray(toks))
    out = model.apply(params, _t(toks).long())
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               **TOL)
    assert abs(float(out.aux) - float(jout.aux)) <= 1e-6
    assert float(out.aux) > 0


@functools.lru_cache(maxsize=None)
def _jstep(jmodel):
    return _unoptimized(jax.jit(jmodel.prefill_chunk))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("C", [1, 8, 32])
def test_prefill_chunks(C, cf):
    """Three ragged chunks (an idle row, dead columns) from an empty cache:
    the live rows' logits within 1e-4, and every cache leaf.  Capacity is
    over all B·C tokens, dead ones included, as the reference routes them:
    at cf 0.5 they take capacity the live rows would have had, so a dead
    column that attended otherwise than the reference's would show."""
    jmodel, tree, model, params = moe_reference(capacity_factor=cf)
    rng = np.random.default_rng(C)
    jc, c = jmodel.init_cache(4, 96), model.init_cache(4, 96)
    steps = np.zeros(4, np.int32)
    for it in range(3):
        n = rng.integers(0, C + 1, 4).astype(np.int32)
        n[0], n[1] = max(n[0], 1), 0 if it == 1 else n[1]
        toks = rng.integers(0, 512, (4, C)).astype(np.int32)
        jl, jc = _jstep(jmodel)(tree, jc, jnp.asarray(toks),
                                jnp.asarray(steps), jnp.asarray(n))
        lg, c = model.prefill_chunk(params, c, _t(toks).long(),
                                    _t(steps).long(), _t(n).long())
        live = n > 0
        np.testing.assert_allclose(lg.numpy()[live], np.asarray(jl)[live],
                                   **TOL, err_msg=f"chunk {it}")
        steps = steps + n
    for i, layer in enumerate(c):
        want = jax.tree.map(lambda a: np.asarray(a[i]),
                            jc["cycles"]["blk_0"]["mixer"])
        np.testing.assert_array_equal(layer["pos"].numpy(), want["pos"])
        for name in ("k", "v"):
            np.testing.assert_allclose(layer[name].numpy(), want[name],
                                       **TOL)


@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_draft_plan_matches_reference(frac):
    """The experts' stack has one rank a linear (its spectrum averaged over
    the layers, then over the experts, the reference's order), named
    ``cycles.blk_0.ffn.wi`` ↔ ``layers.ffn.wi``; the truncated stack keeps
    each expert's own highest-energy components."""
    jmodel, tree, model, params = moe_reference()
    want = weights.plan_from_jax(jmodel.draft_plan(tree, frac))
    got = model.draft_plan(params, frac)
    assert got == want
    assert {"layers.ffn.wi", "layers.ffn.wo"} <= set(got)
    draft = model.truncate_params(params, got)
    wi = draft["layers"][0]["ffn"]["wi"]
    assert wi["U"].shape[:2] == (4, 4) and wi["U"].shape[-1] == got[
        "layers.ffn.wi"]
    alone = structures.truncate_rank(
        structures.unstack(params["layers"][0]["ffn"]["wi"])[3],
        got["layers.ffn.wi"])
    assert torch.equal(wi["S"][3], alone["S"])


@pytest.mark.parametrize("weights_mode", ["none", "int8"])
def test_checkpoint_directory_carries_over(weights_mode, tmp_path):
    """The router, ``wi`` and ``wo`` with their expert axis come back from a
    ``store.save`` directory (int8: codes and scales as ``{q, scale}``
    pairs) with the logits of the tree carried over directly."""
    jmodel, tree, model, _ = moe_reference()
    if weights_mode != "none":
        tree = jax.tree.map(np.asarray, jmodel.quantize_params(
            tree, jq.QuantConfig(weights=weights_mode)))
    store.save(str(tmp_path), 0, tree)
    from_store = weights.from_jax_params(model,
                                         weights.load_store(str(tmp_path)))
    direct = weights.from_jax_params(model, tree)
    ffn = from_store["layers"][1]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert qt.is_qarray(ffn["wo"]["U"]) == (weights_mode != "none")
    assert ffn["wi"]["U"].shape[0] == model.cfg.moe.n_experts
    toks = _t(np.arange(24, dtype=np.int64).reshape(2, 12))
    want = model.apply(direct, toks).logits
    assert torch.equal(model.apply(from_store, toks).logits, want)
