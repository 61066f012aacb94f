"""The ssm family in the port (the Mamba-2 SSD mixer, blocks without an FFN,
no positions: mamba2-130m) against the JAX package, in fp32 on the CPU.

``mamba2-130m.reduced(vocab=64, d_model=32, n_layers=2)`` (the reference's
own serving tests' size: 8 heads of 8, d_state 16, chunk 8, BLAST b = 4),
its weights drawn by numpy in the layout of the reference's ``LM.init``
(``_seeded_tree``), carried over by ``from_jax_params``; the JAX programs
compile without XLA's backend optimizations (``_unoptimized``):

- the layout: layer i is the reference's ``cycles.blk_0[i]``, A_log, D and
  dt_bias fp32, no ``norm2``/``ffn``, the cache's ``conv`` and fp32 ``h``;
- ``ssd_apply`` (the chunked dual form, a padded tail at T = 21),
  ``ssd_prefill`` at chunk 1, 8 and 32, ragged rows from a nonzero state,
  and ``ssd_decode``: outputs and both state leaves within 1e-4;
- the model: ``LM.apply`` and ragged ``prefill_chunk`` logits and every
  cache leaf within 1e-4; the dual form against the recurrence;
- ``ssd_prefill(collect=)`` and ``ssd_cache_rollback`` at every n_comm in
  [0, C], float and int8, against the reference's, and the float rollback
  equal to feeding only the committed tokens, bit for bit;
- the int8 and int4 weight codes bit for bit, the int8 state codec over
  the (B, H, P, N) state bit for bit against the jitted reference, the
  int8 cache's model step (state codes within one step, then shared:
  ``share_state``, ROADMAP C10);
- the draft plan's ranks and names."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.models import build_model as jbuild_model
from repro.models import ssd as jssd

from repro_torch import configs, quant, weights
from repro_torch.models import build_model, ssd
from test_torch_hybrid import _exact, _unoptimized
from test_torch_hybrid_serving import _leaf_close, _t
from torch_parity import TOL

ARCH = "mamba2-130m"
SMALL = dict(vocab=64, d_model=32, n_layers=2)


def small_cfgs(cache: str = "none", **kw):
    """(reference config, port config) of the reduced mamba2-130m, with
    the int8 cache if ``cache`` asks for it."""
    import dataclasses
    jcfg = jconfigs.get(ARCH).reduced(**SMALL, **kw)
    cfg = configs.get(ARCH).reduced(**SMALL, **kw)
    return (dataclasses.replace(jcfg, quant=jq.QuantConfig(cache=cache)),
            dataclasses.replace(cfg, quant=quant.QuantConfig(cache=cache)))


def _seeded_tree(jmodel, rng) -> dict:
    """Weights in the layout of the reference's ``LM.init`` (its
    ``jax.eval_shape``), drawn with numpy: norm scales and the conv bias ~
    N(0, 0.1²), the conv ~ N(0, 0.5²) (``init`` makes it the identity),
    A_log ~ U(-1, 1), dt_bias ~ U(-3, 0) (dt = softplus: 0.05–0.7), D ~
    N(1, 0.1²), the embedding ~ N(0, 0.02²), every other matrix ~ N(0,
    1/fan-in)."""
    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "conv_b"):
            a = 0.1 * rng.standard_normal(leaf.shape)
        elif name == "conv_w":
            a = 0.5 * rng.standard_normal(leaf.shape)
        elif name == "A_log":
            a = rng.uniform(-1.0, 1.0, leaf.shape)
        elif name == "dt_bias":
            a = rng.uniform(-3.0, 0.0, leaf.shape)
        elif name == "D":
            a = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def variant(cache: str = "none"):
    """(JAX model, port model) of the reduced mamba2-130m, float or over
    the int8 cache (no parameter changes shape)."""
    jcfg, cfg = small_cfgs(cache)
    return jbuild_model(jcfg), build_model(cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def ssd_reference():
    """(JAX model, numpy params, port model, port params), built once per
    process."""
    jmodel, model = variant()
    tree = _seeded_tree(jmodel, np.random.default_rng(25))
    return jmodel, tree, model, weights.from_jax_params(model, tree)


@functools.lru_cache(maxsize=None)
def _jstep(jmodel):
    return _unoptimized(jax.jit(jmodel.prefill_chunk))


@functools.lru_cache(maxsize=None)
def _japply(jmodel):
    return _unoptimized(jax.jit(lambda p, t: jmodel.apply(p, t).logits))


def cache_leaves(jcache, i):
    """Layer i's cache of the reference tree (one scanned cycle), as
    numpy."""
    return jax.tree.map(lambda a: np.asarray(a[i]),
                        jcache["cycles"]["blk_0"]["mixer"])


def _mixer_pair(layer=0):
    jmodel, tree, model, params = ssd_reference()
    jspec = jssd.make_ssd(jmodel.cfg)
    jp = jax.tree.map(lambda a: a[layer], tree["cycles"]["blk_0"]["mixer"])
    return jspec, jp, model.specs[layer].mixer, params["layers"][layer][
        "mixer"]


def _state(rng, spec, B):
    """A nonzero (conv, h) state of B rows, fp32 numpy."""
    return (rng.standard_normal((B, spec.conv_width - 1,
                                 spec.conv_channels)).astype(np.float32),
            rng.standard_normal((B, spec.n_heads, spec.head_dim,
                                 spec.d_state)).astype(np.float32))


def share_state(cache, jleaves, what):
    """Hold an int8 SSD layer's state (``cache``: the port's leaves)
    against the reference's (``jleaves``, numpy): codes within one step,
    scales within the float state's tolerance over 127 (1e-4 relative,
    1e-6 absolute: a (head, p) row of a tiny ``h`` carries the float
    state's relative error); then give the port the reference's codes and
    scales, so that both go on from one state (ROADMAP C10)."""
    for name in ("conv", "h"):
        got, want = cache[name], _t(jleaves[name])
        assert int((got.int() - want.int()).abs().max()) <= 1, (what, name)
        scale = _t(jleaves[f"{name}_scale"])
        np.testing.assert_allclose(cache[f"{name}_scale"].float().numpy(),
                                   scale.float().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what} {name}")
        cache[name].copy_(want)
        cache[f"{name}_scale"].copy_(scale)


def test_layout_and_weights():
    jmodel, tree, model, params = ssd_reference()
    spec = model.specs[0]
    assert [s.kind for s in model.specs] == ["ssd", "ssd"]
    assert spec.ffn is None and model.slot_resident
    mx = spec.mixer
    assert (mx.d_inner, mx.n_heads, mx.head_dim, mx.d_state, mx.chunk) == (
        64, 8, 8, 16, 8)
    assert mx.in_proj.shapes == dict(jssd.make_ssd(jmodel.cfg).in_proj.shapes)
    for i, lp in enumerate(params["layers"]):
        assert set(lp) == {"norm1", "mixer"}
        src = jax.tree.map(lambda a: np.asarray(a[i]),
                           tree["cycles"]["blk_0"])
        for name in ("A_log", "D", "dt_bias"):
            assert lp["mixer"][name].dtype == torch.float32
            np.testing.assert_array_equal(lp["mixer"][name].numpy(),
                                          src["mixer"][name])
        np.testing.assert_array_equal(lp["mixer"]["norm"]["scale"].numpy(),
                                      src["mixer"]["norm"]["scale"])
    cache = model.init_cache(3, 64)
    assert set(cache[0]) == {"conv", "h"}
    assert cache[0]["conv"].shape == (3, 3, mx.conv_channels)
    assert cache[0]["h"].shape == (3, 8, 8, 16)
    assert cache[0]["h"].dtype == torch.float32
    assert model.cache_axes()[0] == {     # the reference's, less its layer axis
        k: v[1:] for k, v in jmodel.cache_axes()["cycles"]["blk_0"][
            "mixer"].items()}
    # the port's own init: A = -1, D = 1, an identity conv, fp32 gates
    own = model.init(0)["layers"][0]["mixer"]
    assert torch.all(own["A_log"] == 0) and torch.all(own["D"] == 1)
    assert torch.all(own["conv_w"][-1] == 1) and torch.all(
        own["conv_w"][:-1] == 0)
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001


@pytest.mark.parametrize("T", [5, 8, 21])
def test_ssd_apply(T):
    """The chunked dual form at one chunk (5, 8) and past it with a padded
    tail (21 = 2 chunks of 8 and 5)."""
    jspec, jp, spec, p = _mixer_pair()
    x = np.random.default_rng(T).standard_normal((2, T, 32)).astype(
        np.float32)
    want = _unoptimized(jax.jit(lambda p, x: jssd.ssd_apply(
        jspec, p, x, jnp.arange(T))))(jp, jnp.asarray(x))
    got = ssd.ssd_apply(spec, p, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [1, 8, 32])
def test_ssd_prefill(C):
    """Three ragged chunks from a nonzero state (a dead row among them):
    outputs of live columns and both state leaves after each chunk."""
    jspec, jp, spec, p = _mixer_pair()
    rng = np.random.default_rng(6 + C)
    B = 3
    conv, h = _state(rng, spec, B)
    jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
    cache = {"conv": _t(conv), "h": _t(h)}
    step = _unoptimized(jax.jit(lambda c, x, n: jssd.ssd_prefill(
        jspec, jp, c, x, jnp.zeros((B,), jnp.int32), n)))
    for n in ([C, max(C - 3, 1), 0], [1, C, C // 2], [C, 0, 1]):
        n = np.array(n, np.int32)
        x = rng.standard_normal((B, C, 32)).astype(np.float32)
        want, jcache = step(jcache, jnp.asarray(x), jnp.asarray(n))
        got, cache = ssd.ssd_prefill(spec, p, cache, _t(x), None,
                                     _t(n).long())
        live = np.arange(C)[None, :] < n[:, None]
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)
    assert cache["h"].dtype == torch.float32


def test_ssd_decode():
    """``ssd_decode`` (one token a row) against the reference's, from a
    nonzero state: output and both state leaves."""
    jspec, jp, spec, p = _mixer_pair(1)
    rng = np.random.default_rng(9)
    conv, h = _state(rng, spec, 3)
    x = rng.standard_normal((3, 1, 32)).astype(np.float32)
    want, jcache = _unoptimized(jax.jit(lambda c, x: jssd.ssd_decode(
        jspec, jp, c, x, jnp.zeros((3,), jnp.int32))))(
            {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}, jnp.asarray(x))
    got, cache = ssd.ssd_decode(spec, p, {"conv": _t(conv), "h": _t(h)},
                                _t(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("conv", "h"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_apply_logits():
    jmodel, tree, model, params = ssd_reference()
    toks = np.random.default_rng(7).integers(0, 64, (2, 30)).astype(np.int32)
    want = _japply(jmodel)(tree, jnp.asarray(toks))
    got = model.apply(params, torch.from_numpy(toks)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SCHEDULE = [(8, [8, 5, 8, 1]), (8, [8, 8, 0, 2]), (8, [8, 3, 8, 0]),
            (8, [6, 0, 8, 8]), (1, [1, 1, 1, 1]), (1, [1, 0, 1, 1])]


def test_prefill_chunks_and_every_cache_leaf():
    """Ragged chunks of a 30-token prompt beside shorter rows, then decode
    steps: logits and every cache leaf after each step; the last logits of
    row 0 equal the dual form's over its whole sequence (``LM.apply``)."""
    jmodel, tree, model, params = ssd_reference()
    rng = np.random.default_rng(8)
    jcache, cache = jmodel.init_cache(4, 64), model.init_cache(4, 64)
    step = _jstep(jmodel)
    steps = np.zeros(4, np.int32)
    fed = [[] for _ in range(4)]
    for C, n in SCHEDULE:
        n = np.array(n, np.int32)
        toks = rng.integers(0, 64, (4, C)).astype(np.int32)
        want, jcache = step(tree, jcache, jnp.asarray(toks),
                            jnp.asarray(steps), jnp.asarray(n))
        got, cache = model.prefill_chunk(params, cache,
                                         torch.from_numpy(toks), steps, n)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
        for i, c in enumerate(cache):
            ref = cache_leaves(jcache, i)
            assert set(c) == set(ref)
            for name, leaf in c.items():
                np.testing.assert_allclose(leaf.numpy(), ref[name], **TOL,
                                           err_msg=f"{i}/{name}")
        for b in range(4):
            fed[b] += [int(t) for t in toks[b, :n[b]]]
        steps = steps + n
        last = got
    full = model.apply(params, torch.tensor([fed[0]])).logits
    np.testing.assert_allclose(last[0, 0].numpy(), full[0, -1].numpy(),
                               **TOL)


@pytest.mark.parametrize("cache_mode", ["none", "int8"])
def test_collect_and_rollback(cache_mode):
    """One verify-like chunk of C = 6 from a nonzero state, row b rolled
    back to n_comm = b (every value in [0, C]): the outputs, the snapshots
    ``h_snap`` (C + 1) and ``conv_hist`` and the rolled-back leaves against
    ``ssd_prefill(collect=True)`` and ``ssd_cache_rollback``; in float the
    rolled-back state equals feeding only the committed tokens, bit for
    bit."""
    _, tree, _, params = ssd_reference()
    jmodel_q, model_q = variant(cache_mode)
    jspec, spec = jssd.make_ssd(jmodel_q.cfg), model_q.specs[0].mixer
    jp = jax.tree.map(lambda a: a[0], tree["cycles"]["blk_0"]["mixer"])
    p = params["layers"][0]["mixer"]
    C, B = 6, 7
    rng = np.random.default_rng(31)
    quantized = cache_mode == "int8"
    conv, h = _state(rng, spec, B)
    state = jq.pack_state_cache(quantized, jnp.asarray(conv), jnp.asarray(h))
    x = rng.standard_normal((B, C, 32)).astype(np.float32)
    n = np.full((B,), C, np.int32)
    n[1] = 4                        # a ragged row: columns past 4 are dead
    n_comm = np.arange(B, dtype=np.int32).clip(max=C)
    n_comm[1] = 3

    def reference(c, x, n, n_comm):
        y, new = jssd.ssd_prefill(jspec, jp, c, x, jnp.zeros((B,), jnp.int32),
                                  n, collect=True)
        return y, new, jssd.ssd_cache_rollback(jspec, new, n_comm)

    want_y, want_new, want_back = _unoptimized(jax.jit(reference))(
        state, jnp.asarray(x), jnp.asarray(n), jnp.asarray(n_comm))
    cache = {k: _t(v) for k, v in state.items()}
    before = {k: v.clone() for k, v in cache.items()}
    snaps = {}
    y, _ = ssd.ssd_prefill(spec, p, cache, _t(x), None, _t(n).long(),
                           collect=snaps)
    live = np.arange(C)[None, :] < n[:, None]
    np.testing.assert_allclose(y.numpy()[live], np.asarray(want_y)[live],
                               **TOL)
    assert snaps["h_snap"].shape == (B, C + 1, 8, 8, 16)
    for name in ("h_snap", "conv_hist"):
        np.testing.assert_allclose(snaps[name].numpy(),
                                   np.asarray(want_new[name]), **TOL,
                                   err_msg=name)
    ssd.ssd_cache_rollback(spec, cache, snaps, _t(n_comm).long())
    assert set(cache) == set(want_back)
    for name, leaf in cache.items():
        want = np.asarray(want_back[name])
        if not quantized or "scale" in name:
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want.astype(np.float32), **TOL,
                                       err_msg=name)
        else:
            step = np.abs(leaf.numpy().astype(np.int32) - want)
            assert step.max() <= 1, name
            np.testing.assert_array_equal(leaf.numpy()[0], want[0],
                                          err_msg=name)   # n_comm = 0
    if quantized:
        return
    fed = {k: v.clone() for k, v in before.items()}
    ssd.ssd_prefill(spec, p, fed, _t(x), None, _t(n_comm).long())
    for name in ("conv", "h"):
        assert torch.equal(cache[name], fed[name]), name


@pytest.mark.parametrize("bits", [8, 4])
def test_weight_codes(bits):
    """``LM.quantize_params``: every BLAST factor's codes (int4: packed
    bytes) and scales and the embedding's equal the reference's bit for
    bit; A_log, D, dt_bias, the conv and the norms stay float."""
    jmodel, tree, model, params = ssd_reference()
    mode = {8: "int8", 4: "int4"}[bits]
    jqp = _exact(lambda p: jmodel.quantize_params(
        p, jq.QuantConfig(weights=mode)), jax.tree.map(jnp.asarray, tree))
    qp = model.quantize_params(params, quant.QuantConfig(weights=mode))
    ref = weights.from_jax_params(model, jqp)
    for i, (lp, rp) in enumerate(zip(qp["layers"], ref["layers"])):
        for name in ("in_proj", "out_proj"):
            for f in ("U", "S", "V"):
                a, b = lp["mixer"][name][f], rp["mixer"][name][f]
                assert quant.is_qarray(a) and a.bits == bits
                assert torch.equal(a.q, b.q), (i, name, f)
                assert torch.equal(a.scale, b.scale), (i, name, f)
        for name in ("A_log", "D", "dt_bias", "conv_w"):
            assert torch.equal(lp["mixer"][name], params["layers"][i][
                "mixer"][name])
    assert torch.equal(qp["embed"].q, ref["embed"].q)


def test_state_codec_equals_jitted_jax():
    """``pack_state_cache`` over the SSD's (B, H, P, N) state and (B, K-1,
    ch) conv tail against the reference's, jitted as its engine runs it:
    ``h`` codes and its fp32 (B, H, P) scales, the conv codes and bf16
    scales, bit for bit (rows at several scales, a zero row, a spike)."""
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((16, 8, 8, 16))
         * rng.uniform(1e-3, 50.0, (16, 8, 8, 1))).astype(np.float32)
    h[3, 2, 5] = 0.0
    h[4, 1, 0, 7] = 300.0
    conv = (rng.standard_normal((16, 3, 96))
            * rng.uniform(1e-2, 10.0, (16, 3, 1))).astype(np.float32)
    want = _unoptimized(jax.jit(
        lambda c, x: jq.pack_state_cache(True, c, x)))(jnp.asarray(conv),
                                                       jnp.asarray(h))
    got = quant.pack_state_cache(True, _t(conv), _t(h))
    assert got["h_scale"].shape == (16, 8, 8)
    assert got["h_scale"].dtype == torch.float32
    for name in got:
        _leaf_close(got[name], want[name], name)


def test_int8_cache_step():
    """The int8 cache model (int8 ``conv`` with bf16 and ``h`` with fp32
    per-row scales): the ragged chunks and decode steps of
    ``test_prefill_chunks_and_every_cache_leaf``, logits within 1e-4,
    every state within one code step (then shared, ``share_state``)."""
    _, tree, _, params = ssd_reference()
    jmodel, model = variant("int8")
    jcache, cache = jmodel.init_cache(4, 64), model.init_cache(4, 64)
    assert set(cache[0]) == {"conv", "conv_scale", "h", "h_scale"}
    assert cache[0]["h_scale"].shape == (4, 8, 8)
    step = _jstep(jmodel)
    rng = np.random.default_rng(8)
    steps = np.zeros(4, np.int32)
    for C, n in SCHEDULE:
        n = np.array(n, np.int32)
        toks = rng.integers(0, 64, (4, C)).astype(np.int32)
        want, jcache = step(tree, jcache, jnp.asarray(toks),
                            jnp.asarray(steps), jnp.asarray(n))
        got, _ = model.prefill_chunk(params, cache, torch.from_numpy(toks),
                                     steps, n)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL)
        for i, c in enumerate(cache):
            share_state(c, cache_leaves(jcache, i), f"layer {i}")
        steps = steps + n


@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_draft_plan_matches_reference(frac):
    """One rank a linear for every layer (a one-position pattern):
    ``cycles.blk_0.mixer.in_proj`` ↔ ``layers.mixer.in_proj``."""
    jmodel, tree, model, params = ssd_reference()
    want = weights.plan_from_jax(jmodel.draft_plan(tree, frac))
    got = model.draft_plan(params, frac)
    assert got == want
    assert set(got) == {"layers.mixer.in_proj", "layers.mixer.out_proj"}
