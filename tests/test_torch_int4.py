"""The port's int4 serving path (nibble-packed int4 codecs, the int4 and
W4A8 BLAST wrappers, packed grouped stacking, ``LM.quantize_params`` with
``bits=4``, the engine's quantize-at-load, ``from_jax_params`` of int4
trees) against the JAX package on ``smollm-135m.reduced()``, fp32, CPU.

Tolerances:
- codes, packed bytes and scales: equal;
- kernel wrappers against the JAX int4 Pallas kernels (B7, B8, B10, B12)
  in interpret mode: ``atol = rtol = 1e-5`` (the port's plain versions
  unpack in plane order like the Pallas kernels, so only the order of the
  fp32 sums differs);
- ``prefill_chunk`` logits in int4 mode: ``atol = rtol = 1e-4``;
- W4A8 logits: the per-row rule of ``tests/test_torch_quant.py`` (every
  live row within 2e-2, at least 3/4 of them within 1e-4): a 1e-7 input
  difference can move a per-token activation code by one step;
- greedy tokens: identical where the quantized reference's top-1/top-2
  margin is ≥ 1e-4.

The model-level checks are ``torch_parity.py``'s, shared with
``test_torch_quant.py``; every W4A8 JAX step runs inside
``repro.core.structures.activations`` or restores
``set_activations("none")``: the reference's mode is process-wide.
"""

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
from repro_torch.configs.base import StructureConfig
from repro_torch.core import structures
from repro_torch.kernels import ops, ref
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from torch_parity import (check_greedy_tokens, check_prefill_logits,
                          quantized_params_equal, reference_pair)

KTOL = dict(atol=1e-5, rtol=1e-5)
MODES = {"int4": ("int4", "none"), "w4a8": ("int4", "int8")}
_AXES = {"U": (1, 2), "S": (2,), "V": (1, 2)}
_SCALE_NDIM = {"U": 1, "S": 2, "V": 1}     # su (b,), ss (b, b), sv (b,)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _factors(rng, b, p, q, r, lead=()):
    """Float factors whose block maxima differ from block to block, so a
    scale read from the wrong block shows."""
    def draw(shape, blocks):
        a = rng.standard_normal((*lead, *shape)).astype(np.float32)
        return a * rng.uniform(0.25, 1.0, (*lead, *blocks)).astype(np.float32)
    return dict(U=draw((b, p, r), (b, 1, 1)), S=draw((b, b, r), (b, b, 1)),
                V=draw((b, q, r), (b, 1, 1)))


# -- codecs ---------------------------------------------------------------


@pytest.mark.parametrize("shape,block_axes", [
    ((16, 36, 19), (1, 2)), ((64, 24), (1,)), ((5, 7), None)])
def test_int4_codecs_equal_jax(shape, block_axes):
    rng = np.random.default_rng(shape[-1])
    a = rng.standard_normal(shape).astype(np.float32)
    a *= rng.uniform(0.01, 3.0, shape[:1] + (1,) * (len(shape) - 1))
    a[0] = 0.0                                  # an all-zero block: scale 1
    want = jq.quantize(jnp.asarray(a), bits=4, block_axes=block_axes)
    got = quant.quantize(_t(a), bits=4, block_axes=block_axes)
    assert got.q.dtype == torch.uint8 and got.bits == 4
    assert got.shape == tuple(want.shape) == shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(quant.int_values(got).numpy(),
                                  np.asarray(jq.int_values(want)))
    np.testing.assert_array_equal(quant.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    planes = quant.unpack_int4_planes(got.q)
    np.testing.assert_array_equal(planes.numpy(),
                                  np.asarray(jq.unpack_int4_planes(want.q)))
    r = shape[-1]
    np.testing.assert_array_equal(quant.plane_order(r).numpy(),
                                  np.asarray(jq.plane_order(r)))
    assert torch.equal(planes[..., quant.plane_order(r)], quant.int_values(got))
    # every code in [-7, 7], odd and even lengths
    v = rng.integers(-7, 8, size=(3, r)).astype(np.int8)
    packed = quant.pack_int4(_t(v))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(v))))
    np.testing.assert_array_equal(quant.unpack_int4(packed, r).numpy(), v)


# -- kernel wrappers --------------------------------------------------------


@pytest.mark.parametrize("act", ["none", "int8"])
@pytest.mark.parametrize("seed,lead,b,p,q,r", [
    (1, (1,), 4, 24, 16, 19),     # T=1, odd rank: 10 bytes, one pad nibble
    (2, (2, 5), 4, 16, 16, 14),   # leading axes flattened into T=10
])
def test_blast_matmul_q_int4_matches_jax(act, seed, lead, b, p, q, r):
    """B7 (act "none") and B10 (act "int8") through ``blast_matmul_q``."""
    rng = np.random.default_rng(seed + 10 * (act == "int8"))
    fac = _factors(rng, b, p, q, r)
    x = rng.standard_normal((*lead, b * q)).astype(np.float32)
    jfac = {k: jq.quantize(jnp.asarray(a), bits=4, block_axes=_AXES[k])
            for k, a in fac.items()}
    want = np.asarray(jops.blast_matmul_q(x, jfac["U"], jfac["S"], jfac["V"],
                                          act=act, interpret=True))
    tfac = {k: quant.quantize(_t(a), bits=4, block_axes=_AXES[k])
            for k, a in fac.items()}
    assert tfac["U"].q.shape[-1] == (r + 1) // 2
    got = ops.blast_matmul_q(_t(x), tfac["U"], tfac["S"], tfac["V"], act=act)
    assert got.shape == (*lead, b * p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **KTOL)


def _packed_group(rng, G, b, p, q, r):
    """Stacked packed codes (G, b, ·, ⌈r/2⌉) and scales of G factor sets."""
    fac = _factors(rng, b, p, q, r, lead=(G,))
    codes, scales = {}, {}
    for k, a in fac.items():
        qa = [quant.quantize(_t(a[g]), bits=4, block_axes=_AXES[k])
              for g in range(G)]
        codes[k] = torch.stack([x_.q for x_ in qa])
        scales[k] = torch.stack([x_.scale.reshape((b,) * _SCALE_NDIM[k])
                                 for x_ in qa])
    return codes, scales


@pytest.mark.parametrize("q", [1100, 1712])
def test_a4_plain_version_matches_jax_at_wide_q(q):
    """The grouped W4A8 plain version (packed codes, odd rank) against the
    JAX oracle on the unpacked codes (int32 stage 1) past q = 1040, where an
    fp32 stage 1 would no longer be exact."""
    G, b, p, r, T = 2, 2, 3, 5, 5
    rng = np.random.default_rng(q)
    xq = rng.integers(-127, 128, (T, b * q), dtype=np.int8)
    sx = rng.uniform(0.5, 1.0, (T, 1)).astype(np.float32) / 127
    codes = [rng.integers(-7, 8, (G, b, k, r), dtype=np.int8)
             for k in (p, b, q)]
    scales = [rng.uniform(0.5, 1.0, shape).astype(np.float32) / 7
              for shape in ((G, b), (G, b, b), (G, b))]
    want = jref.blast_matmul_grouped_a8_ref(
        *(jnp.asarray(a) for a in (xq, sx, *codes, *scales)))
    packed = [quant.pack_int4(_t(c)) for c in codes]
    assert packed[0].shape[-1] == (r + 1) // 2
    got = ref.blast_matmul_grouped_a4_ref(
        _t(xq), _t(sx), *packed, *(_t(a) for a in scales))
    assert got.shape == (G, T, b * p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


@pytest.mark.parametrize("act", ["none", "int8"])
def test_blast_matmul_grouped_q4_matches_jax(act):
    """B8 (act "none") and B12 (act "int8"), odd rank, leading axes."""
    lead, G, b, p, q, r = (3, 3), 2, 4, 16, 8, 19
    rng = np.random.default_rng(11 if act == "none" else 12)
    codes, scales = _packed_group(rng, G, b, p, q, r)
    x = rng.standard_normal((*lead, b * q)).astype(np.float32)
    args = [codes[k] for k in "USV"] + [scales[k] for k in "USV"]
    want = np.asarray(jops.blast_matmul_grouped_q4(
        x, *(a.numpy() for a in args), act=act, interpret=True))
    got = ops.blast_matmul_grouped_q4(_t(x), *args, act=act)
    assert got.shape == (G, *lead, b * p)
    np.testing.assert_allclose(got.numpy(), want, **KTOL)


@pytest.mark.parametrize("kind", ["dense", "blast"])
def test_apply_q_int4_matches_jax(kind):
    """A linear's int4 ``apply_q``: dense on the unpacked codes, BLAST
    through the int4 wrapper (odd rank)."""
    rng = np.random.default_rng(8)
    st = dict(kind=kind, b=4, rank=13)
    spec = structures.make_linear(16, 8, StructureConfig(**st))
    jspec = jstructures.make_linear(16, 8, jstructures.StructureConfig(**st))
    fp = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in spec.shapes.items()}
    qp = spec.quantize({k: _t(a) for k, a in fp.items()}, 4)
    jqp = jspec.quantize({k: jnp.asarray(a) for k, a in fp.items()}, 4)
    for k in fp:
        np.testing.assert_array_equal(qp[k].q.numpy(), np.asarray(jqp[k].q))
    x = rng.standard_normal((3, 16)).astype(np.float32)
    np.testing.assert_allclose(spec.apply_q(qp, _t(x)).numpy(),
                               np.asarray(jspec.apply_q(jqp, x)), **KTOL)


def test_stack_group_packs_like_jax():
    """int4 bundles stack their packed bytes, zero-padded to ⌈r̂/2⌉ bytes
    (members of ranks 19 and 13, so of 10 and 7 bytes)."""
    rng = np.random.default_rng(4)
    specs, jspecs, params, jparams = [], [], [], []
    for d_out, r in ((16, 19), (24, 13)):
        st = dict(kind="blast", b=4, rank=r)
        specs.append(structures.make_linear(
            16, d_out, StructureConfig(**st)))
        jspecs.append(jstructures.make_linear(
            16, d_out, jstructures.StructureConfig(**st)))
        fp = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in specs[-1].shapes.items()}
        params.append(specs[-1].quantize({k: _t(a) for k, a in fp.items()}, 4))
        jparams.append(jspecs[-1].quantize(
            {k: jnp.asarray(a) for k, a in fp.items()}, 4))
    bundle = structures.prestack(specs, params)
    jbundle = jstructures.prestack(jspecs, jparams)
    assert (bundle.plan["storage"], bundle.plan["r"]) == ("int4", 19)
    assert set(bundle.arrays) == set(jbundle.arrays)
    for k, a in bundle.arrays.items():
        np.testing.assert_array_equal(a.numpy(), np.asarray(jbundle.arrays[k]),
                                      err_msg=k)
    assert bundle.arrays["U"].dtype == torch.uint8
    assert bundle.arrays["U"].shape == (2, 4, 6, 10)


def test_cpu_int4_paths_count_no_launches():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    fac = {k: quant.quantize(_t(a), bits=4, block_axes=_AXES[k])
           for k, a in _factors(rng, 4, 4, 4, 5).items()}
    codes, scales = _packed_group(rng, 2, 4, 4, 4, 5)
    x = _t(rng.standard_normal((2, 16)).astype(np.float32))
    for act in ("none", "int8"):
        ops.blast_matmul_q(x, fac["U"], fac["S"], fac["V"], act=act)
        ops.blast_matmul_grouped_q4(x, *(codes[k] for k in "USV"),
                                    *(scales[k] for k in "USV"), act=act)
    assert set(ops.launches.values()) == {0}


# -- the model --------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax float params, port model, port float params) sharing
    the reference's weights."""
    return reference_pair()


@pytest.fixture(scope="module")
def jquant4(pair):
    """The reference's int4 tree, quantized eagerly."""
    jmodel, jparams, _, _ = pair
    return jmodel.quantize_params(jparams, jq.QuantConfig(weights="int4"))


def test_quantize_params_int4_equal_jax(pair, jquant4):
    _, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int4"))
    assert quantized_params_equal(qp, jquant4) == 1 + 15 * model.cfg.n_layers
    assert qp["embed"].q.dtype == torch.uint8
    # packed int4 is about an eighth of fp32 (scales are a small extra)
    assert quant.tree_nbytes(qp) < 0.16 * quant.tree_nbytes(params)


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
def test_prefill_chunk_logits_match_jax(pair, jquant4, mode):
    jmodel, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int4"))
    check_prefill_logits(jmodel, jquant4, model, qp, MODES[mode][1])


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
def test_greedy_tokens_match_jax_engine(pair, mode):
    eng = check_greedy_tokens(*pair, *MODES[mode])
    assert eng.params["embed"].bits == 4


def test_int4_route_and_mode_are_scoped_per_engine(pair, monkeypatch):
    """An int4 engine built after a W4A8 engine runs the int4 plain
    versions; the W4A8 engine runs the W4A8 ones; neither goes through the
    int8 route nor leaks its mode."""
    _, _, model, params = pair
    calls, depth = [], [0]

    def record(name, real):
        def call(*a):           # the outermost plain version the path chose
            if not depth[0]:
                calls.append(name)
            depth[0] += 1
            try:
                return real(*a)
            finally:
                depth[0] -= 1
        return call

    for name in ("blast_matmul_grouped_q_ref", "blast_matmul_grouped_a8_ref",
                 "blast_matmul_grouped_q4_ref", "blast_matmul_grouped_a4_ref"):
        monkeypatch.setattr(ref, name, record(name, getattr(ref, name)))
    cfg = dict(scheduler=SchedulerConfig(slots=2, chunk_size=4),
               memory=MemoryConfig(max_len=32))
    w4a8 = Engine(model, params, EngineConfig(
        **cfg, quant=quant.QuantConfig(weights="int4", activations="int8")),
        device="cpu")
    int4 = Engine(model, params, EngineConfig(
        **cfg, quant=quant.QuantConfig(weights="int4")), device="cpu")
    ops.reset_launches()
    for eng, want in ((int4, "blast_matmul_grouped_q4_ref"),
                      (w4a8, "blast_matmul_grouped_a4_ref"),
                      (int4, "blast_matmul_grouped_q4_ref")):
        calls.clear()
        steps = -eng.stats["steps"]
        eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
        steps += eng.stats["steps"]
        # 3 ungrouped + 1 grouped BLAST launch per layer and step, all int4
        assert calls == [want] * (4 * model.cfg.n_layers * steps)
        assert structures.activations_mode() == "none"
    assert set(ops.launches.values()) == {0}


def test_int4_jax_trees_carry_across(pair, jquant4, tmp_path):
    """int4 QArray trees and checkpoints of them (uint8 ``{q, scale}``
    leaves with neither bits nor the logical last dim) give the logits of
    the port's own int4 quantization.  The reduced model's ranks are odd
    (19: 10 bytes, one pad nibble) and even (14)."""
    _, _, model, params = pair
    qp = model.quantize_params(params, quant.QuantConfig(weights="int4"))
    store.save(str(tmp_path), 0, jquant4)
    stored = weights.load_store(str(tmp_path))
    assert stored["embed"]["q"].dtype == np.uint8
    toks = _t(np.arange(12, dtype=np.int64).reshape(2, 6))
    steps, n = np.zeros(2), np.array([6, 4])
    want, _ = model.prefill_chunk(qp, model.init_cache(2, 8), toks, steps, n)
    for tree in (jax.tree.map(np.asarray, jquant4), stored):
        carried = weights.from_jax_params(model, tree)
        wo_v = carried["layers"][1]["ffn"]["wo"]["V"]
        assert (wo_v.bits, wo_v.shape[-1], wo_v.q.shape[-1]) == (4, 19, 10)
        assert carried["layers"][0]["mixer"]["out"]["S"].shape[-1] == 14
        assert carried["embed"].shape == (model.cfg.vocab, model.cfg.d_model)
        got, _ = model.prefill_chunk(carried, model.init_cache(2, 8), toks,
                                     steps, n)
        assert torch.equal(got, want)
    # a packed leaf whose byte count does not match the model's rank raises
    bad = jax.tree.map(lambda a: a, stored)
    qkv_u = bad["cycles"]["blk_0"]["mixer"]["qkv"]["U"]
    qkv_u["q"] = qkv_u["q"][..., :9]
    with pytest.raises(ValueError, match="last dim"):
        weights.from_jax_params(model, bad)
