"""DeepSeek-V3's MLA, shared expert and dense first layers in the port
(``models/mla.py``, ``models/moe.py``, ``models/transformer.py``, the MLA
kernel's plain version) against the JAX package, in fp32 on the CPU.

``deepseek-v3-671b.reduced()`` (3 layers: one dense first layer and a
cycle of two MoE layers; d_model 64, 4 heads, MLA q_lora 32, kv_lora 16,
rope 8, nope 16, v 16; 4 experts top-2 of 32 and a shared expert of 32;
BLAST b = 4), weights drawn by numpy in the layout of the reference's
``LM.init`` (``_seeded_tree``, its ``mtp`` subtree included) and carried
over by ``from_jax_params``; every JAX program compiled without XLA's
backend optimizations (``_unoptimized``), the port's side computed first:

- the configs: ``reduced()`` gives the reference's shapes;
- ``_mla_qkv`` within 1e-5; ``mla_apply`` within 1e-5;
- ``mla_prefill`` over ragged multi-chunk steps (dead columns, an idle
  row): outputs within 1e-4 and every cache leaf (``pos`` exactly), over
  the float cache and the int8 latent cache (codes and bf16 scales bit for
  bit); ``kv_cache_rollback`` of a chunk equal to writing only its
  committed tokens, and to the reference's rollback;
- ``linear_dense_matrix`` in float, int8, int4, W8A8 and W4A8 (the
  identity's rows quantized as the reference's) within 1e-5;
- the MLA kernel's plain version against the reference's einsums within
  1e-5 (a dead column, an empty row, kv_len < S);
- ``moe_apply`` with the shared expert, with drops, within 1e-5;
- the model: ``LM.apply`` logits within 1e-4 and ``aux`` within 1e-5,
  ragged ``prefill_chunk`` at chunk 1 and 8 within 1e-4 with every cache
  leaf; quantized params equal the reference's; the draft plan with the
  first dense layer's ``pre_0`` names;
- the MTP head is not ported: no ``mtp`` params, ``from_jax_params`` drops
  the reference's ``mtp`` subtree by name, ``mtp_logits`` is None and the
  loss refuses the model."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.core import structures as jstructures
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro.models import moe as jmoe

from repro_torch import configs, quant, weights
from repro_torch.core import structures
from repro_torch.kernels import ref
from repro_torch.models import build_model, layers, mla, moe
from repro_torch.train.loss import make_loss_fn
from test_torch_hybrid import _exact, _seeded_tree, _unoptimized
from torch_parity import TOL, leaves_equal

ARCH = "deepseek-v3-671b"
EXACT = dict(atol=1e-5, rtol=1e-5)


def configs_pair(**over):
    """(JAX config, port config): ``reduced()`` with ``over`` replacing
    top-level fields (``moe_kw``: fields of the MoE config)."""
    moe_kw = over.pop("moe_kw", {})
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    return tuple(dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, **moe_kw), **over)
        for c in (jcfg, cfg))


@functools.lru_cache(maxsize=None)
def mla_reference(mtp: bool = True, cache: str = "none", cf: float = 1.25,
                  n_layers: int = 3):
    """(JAX model, numpy params, port model, port params) of the reduced
    config (``mtp``: the reference's MTP head in its tree; ``cache``: the
    cache mode; ``cf``: the capacity factor; ``n_layers``: its depth, the
    first one dense); weights drawn with numpy (seed 31)."""
    jcfg, cfg = configs_pair(n_layers=n_layers,
                             moe_kw={"capacity_factor": cf})
    jcfg = dataclasses.replace(jcfg, mtp=mtp,
                               quant=jq.QuantConfig(cache=cache))
    cfg = dataclasses.replace(cfg, mtp=mtp,
                              quant=quant.QuantConfig(cache=cache))
    jmodel = jbuild_model(jcfg)
    tree = _seeded_tree(jmodel, np.random.default_rng(31))
    model = build_model(cfg, device="cpu")
    return jmodel, tree, model, weights.from_jax_params(model, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer1(tree):
    """The first MoE layer of the reference tree (cycle 0 of blk_0)."""
    return jax.tree.map(lambda a: a[0], tree["cycles"]["blk_0"])


def test_configs_match_reference():
    jcfg, cfg = configs_pair()
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "mtp", "pattern"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert dataclasses.asdict(cfg.mla) == dataclasses.asdict(jcfg.mla)
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    full, jfull = configs.get(ARCH), jconfigs.get(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab) == (
        61, 7168, 128, 129_280)
    assert dataclasses.asdict(full.mla) == dataclasses.asdict(jfull.mla)
    assert dataclasses.asdict(full.moe) == dataclasses.asdict(jfull.moe)
    assert (full.structure.b, full.structure.keep_ratio) == (16, 0.5)


def test_mla_qkv_and_apply():
    jmodel, tree, model, params = mla_reference()
    jspec, spec = jmodel.prefix_specs[0].mixer, model.specs[0].mixer
    p = params["layers"][0]["mixer"]
    jp = tree["pre_0"]["mixer"]
    x = np.random.default_rng(4).standard_normal((2, 9, 64)).astype(
        np.float32)
    pos = np.arange(3, 12)
    got = mla._mla_qkv(spec, p, _t(x), _t(pos))
    want = _unoptimized(jax.jit(
        lambda p, x: jlayers._mla_qkv(jspec, p, x, pos)))(jp, x)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT)
    y = mla.mla_apply(spec, p, _t(x), torch.arange(9))
    jy = _unoptimized(jax.jit(lambda p, x: jlayers.mla_apply(
        jspec, p, x, jnp.arange(9))))(jp, x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EXACT)


def _mla_steps():
    """Three ragged steps of 4 rows: (width, live tokens a row) — an idle
    row, dead columns, decode."""
    return [(8, [8, 3, 0, 5]), (8, [2, 8, 0, 1]), (1, [1, 1, 0, 1])]


@pytest.mark.parametrize("cache", ["none", "int8"])
def test_mla_prefill_ragged(cache):
    """``mla_prefill`` over ragged steps from an empty cache of 24 slots:
    outputs of the live columns within 1e-4 (dead ones too: every query
    sees the slots with 0 <= pos <= its position, as the reference's);
    every cache leaf (int8: codes and scales bit for bit)."""
    jmodel, tree, model, params = mla_reference(cache=cache)
    jspec, spec = jmodel.prefix_specs[0].mixer, model.specs[0].mixer
    p, jp = params["layers"][0]["mixer"], tree["pre_0"]["mixer"]
    c = mla.mla_cache_init(spec, 4, 24, torch.float32, "cpu")
    jc = jlayers.mla_cache_init(jspec, 4, 24, jnp.float32)
    jstep = _unoptimized(jax.jit(lambda p, c, x, s, n: jlayers.mla_prefill(
        jspec, p, c, x, s, n)))
    rng = np.random.default_rng(5)
    steps = np.zeros(4, np.int32)
    for C, n in _mla_steps():
        n = np.array(n, np.int32)
        x = rng.standard_normal((4, C, 64)).astype(np.float32)
        y, c = mla.mla_prefill(spec, p, c, _t(x), _t(steps).long(),
                               _t(n).long())
        jy, jc = jstep(jp, jc, x, jnp.asarray(steps), jnp.asarray(n))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        steps = steps + n
    assert set(c) == set(jc)
    for name, leaf in c.items():
        want = np.asarray(jc[name])
        got = leaf.float().numpy() if leaf.dtype == torch.bfloat16 else (
            leaf.numpy())
        if name == "pos" or cache == "int8":
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    assert (c["pos"][2] == -1).all() and (c["pos"][0] >= 0).sum() == 11


def _copy(cache):
    """A copy of a cache whose leaves keep their spare slot."""
    S = cache["pos"].shape[1]
    return {k: layers._with_spare(v).clone()[:, :S] for k, v in cache.items()}


def test_rollback_equals_committed_write():
    """A chunk rewound to its first n_comm tokens (``kv_cache_window``
    before it, ``kv_cache_rollback`` after) leaves the latent cache equal,
    bit for bit, to writing only those tokens; and to the reference's
    rollback of the same chunk."""
    jmodel, tree, model, params = mla_reference(cache="int8")
    jspec, spec = jmodel.prefix_specs[0].mixer, model.specs[0].mixer
    p, jp = params["layers"][0]["mixer"], tree["pre_0"]["mixer"]
    rng = np.random.default_rng(6)
    x0 = _t(rng.standard_normal((3, 8, 64)).astype(np.float32))
    x1 = _t(rng.standard_normal((3, 5, 64)).astype(np.float32))
    n0 = torch.tensor([8, 4, 6])
    n_comm = torch.tensor([2, 0, 5])
    base = mla.mla_cache_init(spec, 3, 32, torch.float32, "cpu")
    mla.mla_prefill(spec, p, base, x0, torch.zeros(3, dtype=torch.long), n0)
    fed = _copy(base)
    mla.mla_prefill(spec, p, fed, x1, n0, n_comm)
    slot = layers.window_slots(n0, 5, 32)
    saved = layers.kv_cache_window(base, slot)
    rolled = _copy(base)
    mla.mla_prefill(spec, p, rolled, x1, n0, torch.full((3,), 5))
    layers.kv_cache_rollback(rolled, saved, slot, n_comm)
    for k in fed:
        assert torch.equal(rolled[k], fed[k]), k
    jbase = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                            else v.numpy()).astype(jnp.asarray(
                                jlayers.mla_cache_init(jspec, 1, 1,
                                                       jnp.float32)[k]).dtype)
             for k, v in base.items()}
    _, jnew = _unoptimized(jax.jit(lambda p, c, x, s, n: jlayers.mla_prefill(
        jspec, p, c, x, s, n)))(jp, jbase, x1.numpy(), n0.int().numpy(),
                                np.full(3, 5, np.int32))
    jrolled = jlayers.kv_cache_rollback(jbase, jnew, n0.int().numpy(),
                                        n_comm.int().numpy())
    for k in fed:
        got = fed[k].float().numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jrolled[k]).astype(np.float32), err_msg=k)


@pytest.mark.parametrize("storage", ["float", "int8", "int4", "w8a8",
                                     "w4a8"])
def test_linear_dense_matrix(storage):
    """``wkv_b``'s dense matrix (the linear on an identity of kv_lora rows)
    in each storage against the reference's, within 1e-5."""
    jmodel, tree, model, params = mla_reference()
    jspec, spec = jmodel.prefix_specs[0].mixer, model.specs[0].mixer
    p, jp = params["layers"][0]["mixer"]["wkv_b"], tree["pre_0"]["mixer"][
        "wkv_b"]
    bits = {"int8": 8, "w8a8": 8, "int4": 4, "w4a8": 4}.get(storage)
    act = "int8" if storage in ("w8a8", "w4a8") else "none"
    if bits:
        p = layers.linear_quantize(spec.wkv_b, p, bits)
        jp = jlayers.linear_quantize(jspec.wkv_b, jp, bits)
        assert leaves_equal(p, jp) == 3
    with structures.activations(act):
        got = layers.linear_dense_matrix(spec.wkv_b, p)
    try:
        jstructures.set_activations(act)
        want = jlayers.linear_dense_matrix(jspec.wkv_b, jp)
    finally:
        jstructures.set_activations("none")
    assert got.shape == (16, 4 * 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


def test_plain_latent_attention_equals_reference_einsums():
    """``ref.mla_attention_ref`` against the reference's einsums
    (``src/repro/models/layers.py``: scores over the latent and the rope
    key, the position mask at -1e30, softmax, P·latent): rows with dead
    columns, slots past kv_len that hold no key, and an empty row — reset,
    as the engine leaves an idle row: the reference's uniform weights over
    its zero latent give 0, as the plain version's no-key rule does."""
    rng = np.random.default_rng(8)
    B, C, H, S = 3, 4, 2, 12
    q_lat = rng.standard_normal((B, C, H, 16)).astype(np.float32)
    q_rope = rng.standard_normal((B, C, H, 8)).astype(np.float32)
    lat = rng.standard_normal((B, S, 16)).astype(np.float32)
    rope = rng.standard_normal((B, S, 8)).astype(np.float32)
    offs = np.array([3, 0, 6], np.int32)
    live = np.array([4, 2, 0])
    pos = np.where(np.arange(S)[None] < (offs + live)[:, None],
                   np.arange(S)[None], -1).astype(np.int32)
    pos[1, :] = -1                       # an empty row, reset: its latent 0
    lat[1] = 0.0
    scale = 1 / np.sqrt(24)
    got = ref.mla_attention_ref(_t(q_lat), _t(q_rope), _t(lat), _t(rope),
                                _t(pos), _t(offs), scale=scale, kv_len=8)
    q_pos = offs[:, None] + np.arange(C)[None]
    s = (jnp.einsum("bthc,bsc->bhts", q_lat, lat)
         + jnp.einsum("bthr,bsr->bhts", q_rope, rope)) * scale
    ok = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
    p = jax.nn.softmax(jnp.where(ok[:, None], s, -1e30), axis=-1)
    p = jnp.where(jnp.isnan(p), 0.0, p)
    want = jnp.einsum("bhts,bsc->bthc", p, lat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_with_shared_expert(cf):
    """``moe_apply`` of a MoE layer with its shared expert added, at the
    reduced capacity and at 0.5 (drops), within 1e-5."""
    jmodel, tree, model, params = mla_reference(cf=cf)
    jspec, spec = jmodel.cycle_specs[0].ffn, model.specs[1].ffn
    assert spec.shared is not None and jspec.shared is not None
    x = np.random.default_rng(7).standard_normal((3, 11, 64)).astype(
        np.float32)
    y, aux = moe.moe_apply(spec, params["layers"][1]["ffn"], _t(x))
    jy, jaux = _unoptimized(jax.jit(
        lambda p, x: jmoe.moe_apply(jspec, p, x)))(_layer1(tree)["ffn"], x)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **EXACT)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@functools.lru_cache(maxsize=None)
def _jstep(jmodel):
    return _unoptimized(jax.jit(jmodel.prefill_chunk))


def test_model_apply_and_prefill():
    """``LM.apply`` logits within 1e-4 and ``aux`` within 1e-5, and ragged
    ``prefill_chunk`` steps (chunk 8, then decode) with every cache leaf,
    through ``from_jax_params`` of the reference's tree (its ``mtp``
    subtree dropped)."""
    jmodel, tree, model, params = mla_reference()
    toks = np.random.default_rng(2).integers(0, 512, (3, 13)).astype(
        np.int32)
    out = model.apply(params, _t(toks).long())
    jout = _unoptimized(jax.jit(lambda p, t: jmodel.apply(p, t)))(
        tree, jnp.asarray(toks))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jout.logits),
                               **TOL)
    assert abs(float(out.aux) - float(jout.aux)) <= 1e-5
    assert out.mtp_logits is None and jout.mtp_logits is not None
    rng = np.random.default_rng(9)
    c, jc = model.init_cache(4, 48), jmodel.init_cache(4, 48)
    steps = np.zeros(4, np.int32)
    for C, n in _mla_steps() + [(1, [1, 0, 1, 1])]:
        n = np.array(n, np.int32)
        tk = rng.integers(0, 512, (4, C)).astype(np.int32)
        lg, c = model.prefill_chunk(params, c, _t(tk).long(),
                                    _t(steps).long(), _t(n).long())
        jl, jc = _jstep(jmodel)(tree, jc, jnp.asarray(tk),
                                jnp.asarray(steps), jnp.asarray(n))
        live = n > 0
        np.testing.assert_allclose(lg.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        steps = steps + n
    want = [tree_leaves for tree_leaves in (
        jc["pre_0"]["mixer"],
        *(jax.tree.map(lambda a, i=i: a[i], jc["cycles"]["blk_0"]["mixer"])
          for i in range(2)))]
    for i, (layer, w) in enumerate(zip(c, want)):
        np.testing.assert_array_equal(layer["pos"].numpy(),
                                      np.asarray(w["pos"]))
        for name in ("latent", "k_rope"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(w[name]), **TOL,
                                       err_msg=f"{i}.{name}")


@pytest.mark.parametrize("bits", [4])
def test_quantized_params_equal_reference(bits):
    """``LM.quantize_params``: MLA's five linears, the dense FFN, the
    experts' stacks and the shared expert equal the reference's codes and
    scales bit for bit (nibble-packed int4: int8 codes are held by
    ``test_linear_dense_matrix`` and the int8 engine's tokens); norms and
    the router stay float."""
    jmodel, tree, model, params = mla_reference(mtp=False)
    qp = model.quantize_params(params, quant.QuantConfig(
        weights=f"int{bits}"))
    pre, blk = jmodel.prefix_specs[0], jmodel.cycle_specs[0]

    def quantized(tree):
        layer1 = _layer1(tree)
        return [(jlayers.mla_quantize(pre.mixer, tree["pre_0"]["mixer"], bits),
                 jlayers.ffn_quantize(pre.ffn, tree["pre_0"]["ffn"], bits)),
                (jlayers.mla_quantize(blk.mixer, layer1["mixer"], bits),
                 jmoe.moe_quantize(blk.ffn, layer1["ffn"], bits))]
    want = _exact(quantized, tree)
    n = 0
    for got, (jm, jf) in zip(qp["layers"], want):
        n += leaves_equal({k: got["mixer"][k] for k in mla.LINEARS},
                          {k: jm[k] for k in mla.LINEARS})
        names = [k for k in got["ffn"] if k != "router"]
        n += leaves_equal({k: got["ffn"][k] for k in names},
                          {k: jf[k] for k in names})
    assert n == 2 * 15 + 9 + 6 + 9
    assert qp["layers"][1]["mixer"]["q_norm"]["scale"].dtype == torch.float32
    assert not quant.is_qarray(qp["layers"][1]["ffn"]["router"]["w"])


@pytest.mark.parametrize("frac", [0.3, 0.7])
def test_draft_plan_matches_reference(frac):
    """The draft plan names the first dense layer's linears
    ``layers.pre_0.…`` (the reference's ``pre_0.…``) and the MoE cycle's
    ``layers.…``; it equals the reference's (without its MTP head, which
    the port does not build)."""
    jmodel, tree, model, params = mla_reference(mtp=False)
    want = weights.plan_from_jax(jmodel.draft_plan(tree, frac))
    got = model.draft_plan(params, frac)
    assert got == want
    assert {"layers.pre_0.mixer.wkv_b", "layers.pre_0.ffn.gate",
            "layers.mixer.wq_a", "layers.ffn.shared.wo",
            "layers.ffn.wi"} <= set(got)


def test_mtp_head_not_ported():
    """The port builds no MTP head: ``LM.init`` has no ``mtp`` params,
    ``from_jax_params`` drops the reference's ``mtp`` subtree by name (a
    tree that lacks it, or has another unknown key, raises),
    ``LM.apply`` returns ``mtp_logits=None`` and the loss refuses the
    model (ROADMAP A11)."""
    jmodel, tree, model, params = mla_reference()
    assert "mtp" in tree and "mtp" not in params
    assert "mtp" not in model.init(0)
    with pytest.raises(ValueError, match="mtp"):
        weights.from_jax_params(model, {k: v for k, v in tree.items()
                                        if k != "mtp"})
    with pytest.raises(ValueError, match="extra"):
        weights.from_jax_params(model, {**tree, "extra": {}})
    out = model.apply(params, torch.zeros((1, 4), dtype=torch.long))
    assert out.mtp_logits is None
    with pytest.raises(NotImplementedError, match="MTP"):
        make_loss_fn(model)
