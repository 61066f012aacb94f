"""The port's quantized serving path (``repro_torch.quant``, the int8 and W8A8
BLAST wrappers, ``LM.quantize_params``, the engine's quantize-at-load)
against the JAX package on ``smollm-135m.reduced()``, fp32, CPU.

Tolerances:
- codes and scales of ``quantize`` / ``quantize_act`` (eager JAX): equal;
- kernel wrappers against the Pallas kernels in interpret mode:
  ``atol = rtol = 1e-5``;
- ``prefill_chunk`` logits in int8-weight mode: ``atol = rtol = 1e-4``;
- W8A8 logits: every live row within ``atol = 2e-2`` (about 4% of the
  logit scale), and at least 3/4 of the live rows within 1e-4.  The two
  packages feed the per-token activation quantizer the same values only up
  to summation order (~1e-7); a value that close to a rounding boundary
  moves its code by one step (``amax / 127``).  Here that happens once, on
  a 7e-7 input difference in layer 0 of the third chunk, and moves that
  row's logits by 3.5e-3; rows are quantized and attended separately, so
  the other rows keep agreeing to 1e-7.  A wrong scale or layout moves
  every row by O(1);
- greedy tokens: identical where the quantized reference's top-1/top-2
  margin is ≥ 1e-4 (the margin guard of ``test_torch_engine.py``).

The model-level checks live in ``torch_parity.py`` and are shared with
``test_torch_int4.py``.  Every W8A8 JAX step is traced inside ``repro.core.structures.activations``
or restores ``set_activations("none")``: the reference's mode is
process-wide and its engine never resets it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.checkpoint import store
from repro.core import structures as jstructures
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch import quant, weights
from repro_torch.core import structures
from repro_torch.kernels import ops, ref
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from torch_parity import (check_greedy_tokens, check_prefill_logits,
                          quantized_params_equal, reference_pair)

KTOL = dict(atol=1e-5, rtol=1e-5)
MODES = {"int8": ("int8", "none"), "w8a8": ("int8", "int8")}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _factors(rng, b, p, q, r, lead=()):
    """Float factors whose block maxima differ from block to block, so a
    scale read from the wrong block shows."""
    def draw(shape, blocks):
        a = rng.standard_normal((*lead, *shape)).astype(np.float32)
        return a * rng.uniform(0.25, 1.0, (*lead, *blocks)).astype(np.float32)
    return (draw((b, p, r), (b, 1, 1)), draw((b, b, r), (b, b, 1)),
            draw((b, q, r), (b, 1, 1)))


_AXES = {"U": (1, 2), "S": (2,), "V": (1, 2)}


def _jqarray(a, block_axes):
    return jq.quantize(jnp.asarray(a), bits=8, block_axes=block_axes)


# -- codecs ---------------------------------------------------------------


@pytest.mark.parametrize("shape,block_axes", [
    ((16, 36, 19), (1, 2)), ((16, 16, 19), (2,)), ((64, 24), (1,)),
    ((24, 64), (0,)), ((5, 7), None)])
def test_quantize_codes_equal_jax(shape, block_axes):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    a = rng.standard_normal(shape).astype(np.float32)
    a *= rng.uniform(0.01, 3.0, shape[:1] + (1,) * (len(shape) - 1))
    a[0] = 0.0                                  # an all-zero block: scale 1
    want = jq.quantize(jnp.asarray(a), bits=8, block_axes=block_axes)
    got = quant.quantize(_t(a), bits=8, block_axes=block_axes)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    x = rng.standard_normal((7, 3, 40)).astype(np.float32)
    x[0, 1] = 0.0                               # a zero row: scale 1
    wq, ws = jq.quantize_act(jnp.asarray(x))
    gq, gs = quant.quantize_act(_t(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(quant.dequantize_act(gq, gs).numpy(),
                                  np.asarray(jq.dequantize_act(wq, ws)))


def test_quant_config_and_int4_raise():
    for bad in (dict(weights="int2"), dict(cache="int4"),
                dict(activations="int8")):
        with pytest.raises(ValueError):
            quant.QuantConfig(**bad)
    cfg = quant.QuantConfig(weights="int4", cache="int8", activations="int8")
    assert (cfg.weight_bits, cfg.act_bits, cfg.enabled) == (4, 8, True)
    # int4 is ported: code 7 in both nibbles of each byte, logical dim kept
    qa = quant.quantize(torch.ones(5), bits=4)
    assert qa.q.dtype == torch.uint8 and qa.q.tolist() == [0x77, 0x77, 0x07]
    assert (qa.bits, qa.shape) == (4, (5,))
    assert quant.int_values(qa).tolist() == [7] * 5
    with pytest.raises(ValueError, match="bits"):
        quant.quantize(torch.ones(4), bits=2)


# -- kernel wrappers --------------------------------------------------------


@pytest.mark.parametrize("act", ["none", "int8"])
@pytest.mark.parametrize("seed,lead,b,p,q,r", [
    (1, (1,), 4, 24, 16, 19),     # T=1, rank not a multiple of 16
    (2, (2, 5), 4, 16, 16, 14),   # leading axes flattened into T=10
])
def test_blast_matmul_q_matches_jax(act, seed, lead, b, p, q, r):
    rng = np.random.default_rng(seed + 10 * (act == "int8"))
    fac = dict(zip("USV", _factors(rng, b, p, q, r)))
    x = rng.standard_normal((*lead, b * q)).astype(np.float32)
    jfac = {k: _jqarray(a, _AXES[k]) for k, a in fac.items()}
    want = np.asarray(jops.blast_matmul_q(x, jfac["U"], jfac["S"], jfac["V"],
                                          act=act, interpret=True))
    tfac = {k: quant.quantize(_t(a), block_axes=_AXES[k])
            for k, a in fac.items()}
    got = ops.blast_matmul_q(_t(x), tfac["U"], tfac["S"], tfac["V"], act=act)
    assert got.shape == (*lead, b * p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **KTOL)


@pytest.mark.parametrize("act", ["none", "int8"])
def test_blast_matmul_grouped_q_matches_jax(act):
    T, G, b, p, q, r = 7, 2, 4, 16, 8, 19
    rng = np.random.default_rng(11 if act == "none" else 12)
    U, S, V = _factors(rng, b, p, q, r, lead=(G,))
    x = rng.standard_normal((T, b * q)).astype(np.float32)
    codes, scales = {}, {}
    for name, a, shape in (("U", U, (b,)), ("S", S, (b, b)), ("V", V, (b,))):
        qa = [quant.quantize(_t(a[g]), block_axes=_AXES[name])
              for g in range(G)]
        codes[name] = torch.stack([x_.q for x_ in qa])
        scales[name] = torch.stack([x_.scale.reshape(shape) for x_ in qa])
    su, ss, sv = scales["U"], scales["S"], scales["V"]
    want = np.asarray(jops.blast_matmul_grouped_q(
        x, *(codes[k].numpy() for k in "USV"), su.numpy(), ss.numpy(),
        sv.numpy(), act=act, interpret=True))
    got = ops.blast_matmul_grouped_q(_t(x), codes["U"], codes["S"],
                                     codes["V"], su, ss, sv, act=act)
    assert got.shape == (G, T, b * p)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)


def test_dense_apply_q_matches_jax():
    """Dense int8: per-output-channel scales, a plain matmul on the codes."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((16, 8))
         * rng.uniform(0.1, 1.0, (1, 8))).astype(np.float32)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    spec = structures.make_linear(16, 8, structured=False)
    jspec = jstructures.make_linear(16, 8, structured=False)
    qp, jqp = spec.quantize({"w": _t(w)}), jspec.quantize({"w": w})
    np.testing.assert_array_equal(qp["w"].q.numpy(), np.asarray(jqp["w"].q))
    np.testing.assert_allclose(spec.apply_q(qp, _t(x)).numpy(),
                               np.asarray(jspec.apply_q(jqp, x)), **KTOL)


def test_cpu_q_paths_count_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    fac = {k: quant.quantize(_t(a), block_axes=_AXES[k])
           for k, a in zip("USV", _factors(rng, 4, 4, 4, 5))}
    x = _t(rng.standard_normal((2, 16)).astype(np.float32))
    for act in ("none", "int8"):
        ops.blast_matmul_q(x, fac["U"], fac["S"], fac["V"], act=act)
    assert set(ops.launches.values()) == {0}


@pytest.mark.parametrize("q", [96, 1712])
def test_a8_plain_version_is_exact_in_stage_one(q):
    """Stage 1 of the W8A8 plain version equals an integer contraction (here
    at the extreme codes ±127; at q = 1712, qwen1.5-32b's down, the partial
    sums pass 2^24, where an fp32 sum would round)."""
    b, p, r = 2, 3, 5
    xq = torch.full((4, b * q), 127, dtype=torch.int8)
    xq[1] = -127
    V = torch.full((b, q, r), -127, dtype=torch.int8)
    ones = torch.ones(b)
    U = torch.zeros((b, p, r), dtype=torch.int8)
    U[:, 0, 0] = 1
    S = torch.eye(b, dtype=torch.int8)[:, :, None].expand(b, b, r).contiguous()
    y = ref.blast_matmul_a8_ref(xq, torch.ones(4, 1), U, S, V, ones,
                                torch.ones(b, b), ones)
    exact = int((xq[:, :q].long() * V[0, :, 0].long()).sum(-1)[0])
    assert exact == -q * 127 * 127
    assert y[0, 0].item() == exact and y[1, 0].item() == -exact


@pytest.mark.parametrize("q", [1100, 1712])
def test_a8_plain_version_matches_jax_at_wide_q(q):
    """The grouped W8A8 plain version against the JAX oracle (int32 stage
    1) past q = 1040, where an fp32 stage 1 would no longer be exact, on
    random codes."""
    G, b, p, r, T = 2, 2, 3, 5, 5
    rng = np.random.default_rng(q)
    xq = rng.integers(-127, 128, (T, b * q), dtype=np.int8)
    sx = rng.uniform(0.5, 1.0, (T, 1)).astype(np.float32) / 127
    codes = [rng.integers(-127, 128, (G, b, k, r), dtype=np.int8)
             for k in (p, b, q)]
    scales = [rng.uniform(0.5, 1.0, shape).astype(np.float32) / 127
              for shape in ((G, b), (G, b, b), (G, b))]
    want = jref.blast_matmul_grouped_a8_ref(
        *(jnp.asarray(a) for a in (xq, sx, *codes, *scales)))
    got = ref.blast_matmul_grouped_a8_ref(
        *(_t(a) for a in (xq, sx, *codes, *scales)))
    assert got.shape == (G, T, b * p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


# -- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax float params, port model, port float params) sharing
    the reference's weights."""
    return reference_pair()


@pytest.fixture(scope="module")
def jquant(pair):
    """The reference's int8 tree, quantized eagerly (a jitted quantize
    rewrites ``amax / 127`` as a reciprocal multiply, 1 ulp off)."""
    jmodel, jparams, _, _ = pair
    return jmodel.quantize_params(jparams, jq.QuantConfig(weights="int8"))


def test_quantize_params_codes_equal_jax(pair, jquant):
    _, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int8"))
    assert quant.tree_is_quantized(qp) and not quant.tree_is_quantized(params)
    n = quantized_params_equal(qp, jquant)
    assert n == 1 + 15 * model.cfg.n_layers
    assert qp["embed"].scale.shape == (model.cfg.vocab, 1)
    # int8 storage is about a quarter of fp32 (scales are a small extra)
    assert quant.tree_nbytes(qp) < 0.3 * quant.tree_nbytes(params)


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_prefill_chunk_logits_match_jax(pair, jquant, mode):
    jmodel, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int8"))
    check_prefill_logits(jmodel, jquant, model, qp, MODES[mode][1])


def test_quantized_jax_trees_carry_across(pair, jquant, tmp_path):
    """QArray trees and checkpoint directories of them give the logits of
    the port's own quantization."""
    _, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int8"))
    from_tree = weights.from_jax_params(model,
                                        jax.tree.map(np.asarray, jquant))
    store.save(str(tmp_path), 0, jquant)
    stored = weights.load_store(str(tmp_path))
    assert set(stored["embed"]) == {"q", "scale"}
    from_store = weights.from_jax_params(model, stored)
    toks = _t(np.arange(12, dtype=np.int64).reshape(2, 6))
    steps, n = np.zeros(2), np.array([6, 4])
    want, _ = model.prefill_chunk(qp, model.init_cache(2, 8), toks, steps, n)
    for carried in (from_tree, from_store):
        assert carried["layers"][1]["ffn"]["wo"]["V"].q.dtype == torch.int8
        got, _ = model.prefill_chunk(carried, model.init_cache(2, 8), toks,
                                     steps, n)
        assert torch.equal(got, want)
    # a packed int4 leaf carries across packed (int4 is ported); one whose
    # logical size is not the model's raises
    d = model.cfg.d_model
    for rows, cols in ((model.cfg.vocab, d), (4, 4)):
        packed = jax.tree.map(np.asarray,
                              jq.quantize(jnp.ones((rows, cols)), bits=4))
        tree = {**jax.tree.map(np.asarray, jquant), "embed": packed}
        if cols != d:
            with pytest.raises(ValueError, match="last dim"):
                weights.from_jax_params(model, tree)
            continue
        embed = weights.from_jax_params(model, tree)["embed"]
        assert (embed.bits, embed.shape) == (4, (rows, d))
        np.testing.assert_array_equal(embed.q.numpy(), packed.q)


# -- the engine -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_greedy_tokens_match_jax_engine(pair, mode):
    check_greedy_tokens(*pair, *MODES[mode])


def test_activation_mode_is_scoped_per_engine(pair, monkeypatch):
    """An int8-only engine built after a W8A8 engine runs the int8 path;
    the W8A8 engine's steps run the W8A8 path; neither leaks its mode."""
    _, _, model, params = pair
    calls = []
    for name in ("blast_matmul_grouped_q_ref", "blast_matmul_grouped_a8_ref"):
        real = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    cfg = dict(scheduler=SchedulerConfig(slots=2, chunk_size=4),
               memory=MemoryConfig(max_len=32))
    w8a8 = Engine(model, params, EngineConfig(
        **cfg, quant=quant.QuantConfig(weights="int8", activations="int8")),
        device="cpu")
    int8 = Engine(model, params, EngineConfig(
        **cfg, quant=quant.QuantConfig(weights="int8")), device="cpu")
    for eng, want in ((int8, "blast_matmul_grouped_q_ref"),
                      (w8a8, "blast_matmul_grouped_a8_ref"),
                      (int8, "blast_matmul_grouped_q_ref")):
        calls.clear()
        eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
        assert calls and set(calls) == {want}
        assert structures.activations_mode() == "none"


def test_engine_refuses_int8_cache_and_int4_weights(pair):
    _, _, model, params = pair
    # the int8 cache is ported as a model-construction knob: the engine's
    # quant= override of a float model's cache raises, as the reference's
    with pytest.raises(ValueError, match="model-construction knob"):
        Engine(model, params, EngineConfig(
            quant=quant.QuantConfig(cache="int8")), device="cpu")
    model8 = build_model(dataclasses.replace(
        model.cfg, quant=quant.QuantConfig(cache="int8")), device="cpu")
    assert model8.init_cache(2, 8)[0]["k"].dtype == torch.int8
    # int4 weights are ported: the engine quantizes them at load, packed
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=4),
        memory=MemoryConfig(max_len=32),
        quant=quant.QuantConfig(weights="int4")), device="cpu")
    assert eng.params["embed"].bits == 4
    assert eng.params["layers"][0]["mixer"]["qkv"]["U"].q.dtype == torch.uint8
    reqs = eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
    assert reqs[0].done and len(reqs[0].output) == 2
