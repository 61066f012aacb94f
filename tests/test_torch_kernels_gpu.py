"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports the JAX package.)
Tolerances: fp32 ``atol = rtol = 1e-4``; bf16 ``2e-2`` (MLA's latent
kernel too: its plain version reads the same bf16 q and cache; B3 over
int8 K/V too: its plain version dequantizes the same codes and scales; B3 over a
ring, over float or int8 K/V: its plain version masks by the same key
positions).  The int8, int4,
W8A8 and W4A8 kernels are held to the same: their plain versions take the
same codes and scales (and, with int8 activations, the same activation
codes), so only the order of the float sums differs.
"""

import numpy as np
import pytest
import torch

from repro_torch import quant
from repro_torch.kernels import blast_matmul as bm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# (T, G, b, p, q, r) past the float kernel's resident n = 2048: n = 8192 at
# b = 16 (q = 512), n = 3072 at b = 6, and qwen1.5-32b's down (n = 27392,
# q = 1712), each at T = 8 (r split) and at 2048 tokens (unsplit)
WIDE = [(8, 1, 16, 64, 512, 64), (2048, 2, 16, 64, 512, 48),
        (8, 2, 6, 128, 512, 64), (2048, 1, 6, 128, 512, 32),
        (8, 1, 16, 320, 1712, 32), (2048, 2, 16, 40, 1712, 32)]
# mamba2-130m's two BLAST shapes (T, G, b, p, q, r) at decode and a 256-token
# prefill: in_proj 768 → 3352 (b = 8, odd p = 419: the epilogue's scalar
# stores), out_proj 1536 → 768
MAMBA2 = [(8, 1, 8, 419, 96, 304), (256, 1, 8, 419, 96, 304),
          (8, 1, 16, 48, 96, 224), (256, 1, 16, 48, 96, 224)]


def _factors(rng, b, p, q, r, lead=()):
    return (rng.standard_normal((*lead, b, p, r)).astype(np.float32),
            rng.standard_normal((*lead, b, b, r)).astype(np.float32),
            rng.standard_normal((*lead, b, q, r)).astype(np.float32))


def _ring_inputs(B, Hq, Hkv, C, S, D, dtype, device, seed):
    """B3-over-a-ring inputs: q (B, Hq, C, D) and K/V (B, Hkv, S_k, D) as
    the model's views, key positions (B, S_k) int32 and row offsets.  Row
    b's ring holds positions up to ``last[b]`` (row 0 unwrapped, the others
    wrapped up to three times), slot j the latest p ≤ last with p % S = j,
    -1 where none.  C = 1: the query is the newest position (written
    before the step attends); C > 1: the chunk's keys follow the ring
    (S_k = S + C) at positions last + 1 + t, row 1's second half dead
    (-1)."""
    g = torch.Generator().manual_seed(seed)
    last = torch.randint(S, 4 * S, (B,), generator=g)
    last[0] = S // 3
    j = torch.arange(S)
    pos = last[:, None] - (last[:, None] - j[None, :]) % S
    pos = torch.where(pos >= 0, pos, -1)
    offs = last if C == 1 else last + 1
    if C > 1:
        chunk = offs[:, None] + torch.arange(C)[None, :]
        if B > 1:
            chunk[1, C // 2:] = -1
        pos = torch.cat([pos, chunk], dim=1)
    Sk = pos.shape[1]
    q = torch.randn((B, C, Hq, D), generator=g).to(device, dtype)
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g).to(device, dtype)
            for _ in range(2))
    return (q.transpose(1, 2), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            pos.to(device, torch.int32), offs.to(device, torch.int32))


@pytest.mark.gpu
class TestOnCard:
    """Each kernel, on the card, against its plain version on the same
    inputs; each wrapper call launches exactly once."""

    @pytest.fixture
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("T,G,b,p,q,r", [(1, 1, 4, 24, 16, 19),
                                             (37, 1, 16, 60, 36, 144),
                                             (8, 2, 16, 96, 36, 176),
                                             (300, 2, 16, 96, 36, 176),
                                             (2048, 1, 16, 36, 96, 176),
                                             (37, 1, 16, 36, 60, 19),
                                             (37, 2, 4, 12, 5, 19),
                                             (8, 1, 32, 12, 18, 48),
                                             (600, 1, 32, 12, 18, 48),
                                             (37, 2, 8, 192, 72, 144),
                                             (300, 1, 8, 72, 192, 144),
                                             (16, 1, 16, 192, 128, 32),
                                             (37, 1, 4, 101, 5, 19)]
                             + WIDE + MAMBA2)
    def test_blast_kernels(self, cuda, dtype, tol, T, G, b, p, q, r):
        """The float kernel's paths: r split (T ≤ 300) or whole, output
        blocks grouped (at decode, and b = 32 at any T) or not, p in column
        chunks (p > 96, or tiles too wide for one chunk at n = 2048),
        ragged T, r, q and p; past n = 2048 the input axis in panels of
        whole blocks (n = 8192, 3072) or of rows of one block (n = 27392)."""
        rng = np.random.default_rng(T + G + r)
        U, S, V = (_t(a).to(cuda, dtype) / 4 for a in
                   _factors(rng, b, p, q, r, lead=(G,)))
        x = _t(rng.standard_normal((T, b * q)).astype(np.float32)).to(cuda, dtype)
        ops.reset_launches()
        if G == 1:
            got = ops.blast_matmul(x, U[0], S[0], V[0])
            want = ref.blast_matmul_ref(x, U[0], S[0], V[0])
        else:
            got = ops.blast_matmul_grouped(x, U, S, V)
            want = ref.blast_matmul_grouped_ref(x, U, S, V)
        torch.cuda.synchronize()
        assert sum(ops.launches.values()) == 1
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T", [8, 2048])
    def test_blast_float_repeats_bitwise(self, cuda, dtype, T):
        """Two launches on the same inputs give the same bits: split r (T =
        8) is summed in a fixed order, and nothing uses atomics."""
        rng = np.random.default_rng(T)
        U, S, V = (_t(a).to(cuda, dtype) / 4 for a in
                   _factors(rng, 16, 96, 36, 176, lead=(2,)))
        x = _t(rng.standard_normal((T, 16 * 36)).astype(np.float32)).to(
            cuda, dtype)
        first = ops.blast_matmul_grouped(x, U, S, V)
        second = ops.blast_matmul_grouped(x, U, S, V)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("act,T,G,b,p,q,r", [
        (act, *shape) for act in ("none", "int8")
        for shape in [(1, 1, 4, 24, 16, 19), (37, 1, 16, 60, 36, 144),
                      (37, 2, 4, 8, 8, 21), (8, 2, 16, 96, 36, 176)]
        + WIDE + MAMBA2])
    def test_blast_q_kernels(self, cuda, bits, act, dtype, tol, T, G, b, p,
                             q, r):
        """int8 / int4 weights (act "none") and W8A8 / W4A8 (act "int8"),
        all on the tile kernel, n up to 27392: the kernel and its plain
        version get the same codes (int4: nibble-packed, odd ranks
        included), scales and activation codes."""
        rng = np.random.default_rng(T + G + r)
        x = _t(rng.standard_normal((T, b * q)).astype(np.float32)).to(cuda, dtype)
        qas = [[quant.quantize(_t(a[g]).to(cuda) / 4, bits=bits,
                               block_axes=axes) for g in range(G)]
               for a, axes in zip(_factors(rng, b, p, q, r, lead=(G,)),
                                  ((1, 2), (2,), (1, 2)))]
        codes = [torch.stack([x_.q for x_ in qa]) for qa in qas]
        scales = [torch.stack([x_.scale.reshape(shape) for x_ in qa])
                  for qa, shape in zip(qas, ((b,), (b, b), (b,)))]
        assert codes[0].shape[-1] == (r if bits == 8 else (r + 1) // 2)
        suffix = {(8, "none"): "q", (8, "int8"): "w8a8", (4, "none"): "q4",
                  (4, "int8"): "w4a8"}[bits, act]
        ops.reset_launches()
        if G == 1:
            got = ops.blast_matmul_q(x, *(qa[0] for qa in qas), act=act)[None]
            key = f"blast_matmul_{suffix}"
        else:
            grouped = (ops.blast_matmul_grouped_q4 if bits == 4
                       else ops.blast_matmul_grouped_q)
            got = grouped(x, *codes, *scales, act=act)
            key = f"blast_matmul_grouped_{suffix}"
        if act == "int8":
            xq, sx = quant.quantize_act(x)
            plain = (ref.blast_matmul_grouped_a4_ref if bits == 4
                     else ref.blast_matmul_grouped_a8_ref)
            want = plain(xq, sx, *codes, *scales).to(dtype)
        else:
            plain = (ref.blast_matmul_grouped_q4_ref if bits == 4
                     else ref.blast_matmul_grouped_q_ref)
            want = plain(x, *codes, *scales)
        torch.cuda.synchronize()
        assert ops.launches[key] == 1 and sum(ops.launches.values()) == 1
        assert got.dtype == dtype and got.shape == (G, T, b * p)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("mode", ["float", "int8", "w8a8", "int4",
                                      "w4a8"])
    @pytest.mark.parametrize("E,T,b,p,q,r", [
        (32, 3, 16, 64, 64, 224), (32, 80, 16, 64, 32, 144),
        (4, 37, 4, 24, 16, 19), (3, 1, 16, 96, 36, 176)])
    def test_blast_batched_kernels(self, cuda, mode, dtype, tol, E, T, b, p,
                                   q, r):
        """The batched launch (the MoE experts: set e on its own rows x[e],
        a per-set x stride): granite-moe's ``wi`` and ``wo`` at decode and
        at a chunk, ragged shapes, each storage; every set's last row zero
        (an empty capacity slot: scale 1, zero codes); two launches bit for
        bit; one launch counted under the mode's own key."""
        rng = np.random.default_rng(E + T + r)
        U, S, V = (_t(a).to(cuda) / 4 for a in
                   _factors(rng, b, p, q, r, lead=(E,)))
        x = _t(rng.standard_normal((E, T, b * q)).astype(np.float32)).to(
            cuda, dtype)
        x[:, -1] = 0
        ops.reset_launches()
        if mode == "float":
            U, S, V = (a.to(dtype) for a in (U, S, V))
            key = "blast_matmul_batched"
            run = lambda: ops.blast_matmul_batched(x, U, S, V)  # noqa: E731
            want = ref.blast_matmul_batched_ref(x, U, S, V)
        else:
            bits = 4 if mode in ("int4", "w4a8") else 8
            act = "int8" if mode.startswith("w") else "none"
            qs = [quant.quantize(a, bits=bits, block_axes=axes) for a, axes
                  in ((U, (2, 3)), (S, (3,)), (V, (2, 3)))]
            codes = [a.q for a in qs]
            scales = (qs[0].scale.reshape(E, b), qs[1].scale.reshape(E, b, b),
                      qs[2].scale.reshape(E, b))
            fn = (ops.blast_matmul_batched_q4 if bits == 4
                  else ops.blast_matmul_batched_q)
            key = {"int8": "blast_matmul_batched_q",
                   "w8a8": "blast_matmul_batched_w8a8",
                   "int4": "blast_matmul_batched_q4",
                   "w4a8": "blast_matmul_batched_w4a8"}[mode]
            run = lambda: fn(x, *codes, *scales, act=act)  # noqa: E731
            if act == "int8":
                xq, sx = quant.quantize_act(x)
                plain = (ref.blast_matmul_batched_a4_ref if bits == 4
                         else ref.blast_matmul_batched_a8_ref)
                want = plain(xq, sx, *codes, *scales).to(dtype)
            else:
                plain = (ref.blast_matmul_batched_q4_ref if bits == 4
                         else ref.blast_matmul_batched_q_ref)
                want = plain(x, *codes, *scales)
        got = run()
        torch.cuda.synchronize()
        assert ops.launches[key] == 1 and sum(ops.launches.values()) == 1
        assert got.dtype == dtype and got.shape == (E, T, b * p)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
        assert torch.equal(run(), got)

    @pytest.mark.parametrize("act", ["none", "int8"])
    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("T,G,q", [(8, 1, 36), (2048, 2, 36),
                                       (8, 2, 512)])
    def test_blast_q_repeats_bitwise(self, cuda, act, bits, dtype, T, G, q):
        """Two launches of the quantized tile kernel on the same inputs give
        the same bits, weight-only (act "none") and W8A8 / W4A8 (act
        "int8"): split r (T = 8), unsplit (2048 tokens), and the input axis
        in panels (n = 8192)."""
        b, p, r = 16, 96, 176
        rng = np.random.default_rng(T + G + q)
        x = _t(rng.standard_normal((T, b * q)).astype(np.float32)).to(
            cuda, dtype)
        qas = [[quant.quantize(_t(a[g]).to(cuda) / 4, bits=bits,
                               block_axes=axes) for g in range(G)]
               for a, axes in zip(_factors(rng, b, p, q, r, lead=(G,)),
                                  ((1, 2), (2,), (1, 2)))]
        codes = [torch.stack([x_.q for x_ in qa]) for qa in qas]
        scales = [torch.stack([x_.scale.reshape(shape) for x_ in qa])
                  for qa, shape in zip(qas, ((b,), (b, b), (b,)))]
        grouped = (ops.blast_matmul_grouped_q4 if bits == 4
                   else ops.blast_matmul_grouped_q)
        first = grouped(x, *codes, *scales, act=act)
        second = grouped(x, *codes, *scales, act=act)
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("mode", ["float", "q8", "q4", "w8a8", "w4a8"])
    def test_blast_odd_p_repeats_bitwise(self, cuda, mode, dtype):
        """mamba2-130m's in_proj at decode (T = 8, b = 8, p = 419, q = 96,
        r = 304: r split, the odd p stored column by column): two launches
        of the G = 1 kernel of every mode give the same bits."""
        b, p, q, r = 8, 419, 96, 304
        rng = np.random.default_rng(419)
        x = _t(rng.standard_normal((8, b * q)).astype(np.float32)).to(
            cuda, dtype)
        U, S, V = (_t(a).to(cuda) / 4 for a in _factors(rng, b, p, q, r))
        if mode == "float":
            U, S, V = (a.to(dtype) for a in (U, S, V))
            calls = [ops.blast_matmul(x, U, S, V) for _ in range(2)]
        else:
            bits = 4 if mode in ("q4", "w4a8") else 8
            qas = [quant.quantize(a, bits=bits, block_axes=axes)
                   for a, axes in zip((U, S, V), ((1, 2), (2,), (1, 2)))]
            act = "int8" if mode.startswith("w") else "none"
            calls = [ops.blast_matmul_q(x, *qas, act=act) for _ in range(2)]
        torch.cuda.synchronize()
        assert calls[0].shape == (8, b * p)
        assert torch.equal(calls[0], calls[1])

    @pytest.mark.parametrize("q", [96, 1712])
    def test_a8_stage_one_is_exact(self, cuda, q):
        """The W8A8 kernel's s8 stage 1 and its int32 partial sums are
        exact: with U and S passing z_0 of each block through to column 0
        (unit scales), at the extreme codes ±127, y equals ∓q·127² exactly —
        past 2^24 at q = 1712 (n = 27392: the input axis in panels of rows
        of one block, partials added across warps)."""
        T, b, p, r = 4, 16, 8, 16
        xq = torch.full((T, b * q), 127, dtype=torch.int8, device=cuda)
        xq[1] = -127
        V = torch.full((1, b, q, r), -127, dtype=torch.int8, device=cuda)
        U = torch.zeros((1, b, p, r), dtype=torch.int8, device=cuda)
        U[:, :, 0, 0] = 1
        S = torch.eye(b, dtype=torch.int8, device=cuda)[None, :, :, None]
        S = S.expand(1, b, b, r).contiguous()
        ones = torch.ones((1, b), device=cuda)
        y = bm.launch_w8a8(xq, torch.ones((T, 1), device=cuda), U, S, V,
                           ones, torch.ones((1, b, b), device=cuda), ones,
                           out_dtype=torch.float32)
        want = torch.zeros((1, T, b, p), dtype=torch.float64)
        want[0, :, :, 0] = -q * 127 * 127
        want[0, 1] *= -1
        assert torch.equal(y.cpu().double(), want.reshape(1, T, b * p))

    def test_q4_fp32_error_is_summation_order(self, cuda):
        """At unscaled factors the int4 kernel's fp32 outputs reach ~1e3,
        where a summation order alone moves them past ``1e-4`` absolute
        (so ``test_blast_q_kernels`` scales its factors by 1/4, as the
        int8 test does).  Against a float64 evaluation of the same codes
        and scales, the kernel's error stays within twice the plain
        version's and within 1e-6 of the output scale."""
        T, b, p, q, r = 37, 16, 60, 36, 144
        rng = np.random.default_rng(T + 1 + r)
        x = _t(rng.standard_normal((T, b * q)).astype(np.float32)).to(cuda)
        qas = [quant.quantize(_t(a[0]).to(cuda), bits=4, block_axes=axes)
               for a, axes in zip(_factors(rng, b, p, q, r, lead=(1,)),
                                  ((1, 2), (2,), (1, 2)))]
        got = ops.blast_matmul_q(x, *qas)
        want = ref.blast_matmul_grouped_q4_ref(
            x, *(qa.q[None] for qa in qas),
            *(qa.scale.reshape(s)[None]
              for qa, s in zip(qas, ((b,), (b, b), (b,)))))[0]
        U, S, V = (quant.dequantize(qa).double() for qa in qas)
        z = torch.einsum("tjq,jqr->tjr", x.double().reshape(T, b, q), V)
        exact = torch.einsum("tir,ipr->tip",
                             torch.einsum("tjr,ijr->tir", z, S),
                             U).reshape(T, b * p)
        scale = float(exact.abs().max())
        kernel_err = float((got.double() - exact).abs().max())
        plain_err = float((want.double() - exact).abs().max())
        assert scale > 100
        assert kernel_err <= max(2 * plain_err, 1e-6 * scale), (
            kernel_err, plain_err, scale)

    @pytest.mark.parametrize("bits", [8, 4])
    def test_quantizers_equal_cpu(self, cuda, bits):
        """Codes (int4: packed bytes) and scales on the card equal the
        CPU's bit for bit (the CPU ones equal the JAX package's:
        tests/test_torch_quant.py, tests/test_torch_int4.py)."""
        rng = np.random.default_rng(3)
        for shape, axes in (((16, 96, 176), (1, 2)), ((16, 16, 176), (2,)),
                            ((4096, 576), (1,)), ((16, 96, 175), (1, 2))):
            a = _t(rng.standard_normal(shape).astype(np.float32)
                   * rng.uniform(0.01, 3.0, shape[:1] + (1,) * (len(shape) - 1)
                                 ).astype(np.float32))
            got, want = quant.quantize(a.to(cuda), bits=bits, block_axes=axes), \
                quant.quantize(a, bits=bits, block_axes=axes)
            assert torch.equal(got.q.cpu(), want.q)
            assert torch.equal(got.scale.cpu(), want.scale)
            xq, sx = quant.quantize_act(a.to(cuda))
            wq, ws = quant.quantize_act(a)
            assert torch.equal(xq.cpu(), wq) and torch.equal(sx.cpu(), ws)

    @pytest.mark.parametrize("weights", ["int8", "int4"])
    def test_engine_scopes_its_activation_mode(self, cuda, weights):
        """A weight-only engine built after an int8-activation engine (of
        the same weight storage) launches the weight-only kernels; the
        other one its own (W8A8 or W4A8) kernels."""
        from repro_torch import configs
        from repro_torch.models import build_model
        from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                                       SamplingParams, SchedulerConfig)
        model = build_model(configs.get("smollm-135m").reduced(), device=cuda)
        params = model.init(0)
        cfg = dict(scheduler=SchedulerConfig(slots=2, chunk_size=4),
                   memory=MemoryConfig(max_len=32))
        a8 = Engine(model, params, EngineConfig(**cfg, quant=quant.QuantConfig(
            weights=weights, activations="int8")), device=cuda)
        w_only = Engine(model, params, EngineConfig(
            **cfg, quant=quant.QuantConfig(weights=weights)), device=cuda)
        q, wa = ("q", "w8a8") if weights == "int8" else ("q4", "w4a8")
        for eng, suffix in ((w_only, q), (a8, wa)):
            ops.reset_launches()
            steps = -eng.stats["steps"]
            eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
            torch.cuda.synchronize()
            steps += eng.stats["steps"]
            L = model.cfg.n_layers
            assert steps > 0
            assert {k: v for k, v in ops.launches.items() if v} == {
                f"blast_matmul_{suffix}": 3 * L * steps,
                f"blast_matmul_grouped_{suffix}": L * steps,
                "flash_attention_prefill": L * steps}

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("C,window,D", [(1, None, 64), (32, None, 64),
                                            (20, 9, 16), (3, None, 128),
                                            (1, None, 192), (32, 17, 192),
                                            (1, 13, 256), (32, None, 256)])
    def test_flash_attention_prefill(self, cuda, dtype, tol, C, window, D):
        B, Hq, Hkv, S = 4, 9, 3, 96
        g = torch.Generator().manual_seed(C + D)
        q = torch.randn((B, C, Hq, D), generator=g).to(cuda, dtype)
        k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
        v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
        offs = torch.randint(0, S - C + 1, (B,), generator=g).to(cuda)
        args = (q.transpose(1, 2), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3), offs)
        got = ops.flash_attention_prefill(*args, window=window)
        want = ref.attention_prefill_ref(*args, window=window)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    # (B, Hq, Hkv, T, S, causal, window, q_offset, D): the chip_smoke shapes
    # of B4, and head dims of 128, 192 and 256
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,T,S,causal,window,q_offset,D", [
        (8, 9, 3, 256, 256, True, None, 0, 64),
        (1, 9, 3, 2048, 2048, True, None, 0, 64),
        (2, 9, 3, 200, 200, True, None, 0, 64),
        (2, 9, 3, 256, 256, True, 64, 0, 64),
        (2, 9, 3, 256, 320, True, None, 64, 64),
        (2, 9, 3, 256, 256, False, None, 0, 64),
        (2, 4, 1, 100, 100, True, None, 0, 128),
        (2, 4, 2, 300, 300, True, None, 0, 256),
        (2, 4, 2, 256, 256, True, 64, 0, 192),
        (2, 4, 1, 256, 320, True, None, 64, 256),
        (1, 4, 2, 100, 100, False, None, 0, 192)])
    def test_flash_attention(self, cuda, dtype, tol, B, Hq, Hkv, T, S, causal,
                             window, q_offset, D):
        """B4 on strided views of one (B, T, heads, D) buffer, as the
        attention layer passes them."""
        g = torch.Generator().manual_seed(T + S + D)
        q = torch.randn((B, T, Hq, D), generator=g).to(cuda, dtype)
        kv = torch.randn((B, S, 2 * Hkv, D), generator=g).to(cuda, dtype)
        args = (q.transpose(1, 2), kv[:, :, :Hkv].transpose(1, 2),
                kv[:, :, Hkv:].transpose(1, 2))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        ops.reset_launches()
        got = ops.flash_attention(*args, **kw)
        want = ref.attention_ref(*args, **kw)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention"] == 1
        assert sum(ops.launches.values()) == 1
        assert got.shape == (B, Hq, T, D) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    # B3 through the bf16 kernel's paths (and the fp32 kernel on the same
    # inputs): GQA packing at G = 1, 3 and 10; decode at the first and the
    # last slot (the split path: ``split_plan`` cuts the keys); chunks whose
    # G·C is not a multiple of 16; kv_len < S; windows; head dims 64, 72,
    # 128 and 256.  (B, Hq, Hkv, C, S, D, window, kv_len, offsets)
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len,where", [
        (8, 9, 3, 1, 512, 64, None, None, "first"),
        (8, 9, 3, 1, 512, 64, None, None, "last"),
        (4, 10, 1, 1, 512, 256, None, None, "last"),
        (2, 4, 4, 1, 512, 72, None, None, "last"),
        (8, 9, 3, 32, 512, 64, None, None, "random"),
        (3, 9, 3, 7, 200, 72, None, None, "random"),
        (2, 10, 1, 32, 512, 128, 100, None, "random"),
        (4, 9, 3, 20, 300, 64, 40, 250, "random"),
        (2, 3, 1, 5, 96, 256, None, 60, "random"),
        (1, 6, 2, 3, 1024, 64, 300, 900, "last")])
    def test_flash_attention_prefill_paths(self, cuda, dtype, tol, B, Hq, Hkv,
                                           C, S, D, window, kv_len, where):
        g = torch.Generator().manual_seed(B * C + S + D)
        q = torch.randn((B, C, Hq, D), generator=g).to(cuda, dtype)
        k = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
        v = torch.randn((B, S, Hkv, D), generator=g).to(cuda, dtype)
        offs = {"first": torch.zeros(B, dtype=torch.int32),
                "last": torch.full((B,), S - C, dtype=torch.int32),
                "random": torch.randint(0, S - C + 1, (B,), generator=g,
                                        dtype=torch.int32)}[where].to(cuda)
        args = (q.transpose(1, 2), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3), offs)
        kw = dict(window=window, kv_len=kv_len)
        if (B, C, where) == (8, 1, "last"):
            plan = fa.split_plan(B, Hkv, Hq // Hkv, C, S,
                                 torch.cuda.get_device_properties(
                                     0).multi_processor_count)
            assert plan[2] > 1            # this case takes the split path
        ops.reset_launches()
        got = ops.flash_attention_prefill(*args, **kw)
        want = ref.attention_prefill_ref(*args, **kw)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention_prefill"] == 1
        assert got.shape == (B, Hq, C, D) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    # the bf16 split path as the plan takes it: grids that leave most SMs
    # idle over several key tiles (``SPLIT_SHAPES`` of
    # tests/test_torch_attention_plan.py pins each one's split count at
    # 132 SMs); row 0 at slot 0 leaves later splits with no live key.
    # (B, Hq, Hkv, C, S, D, window, kv_len)
    @pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len", [
        (8, 9, 3, 32, 512, 64, None, None),
        (3, 9, 3, 7, 200, 72, 50, None),
        (2, 10, 1, 4, 320, 256, None, 300),
        (2, 4, 2, 1, 640, 128, 64, None),
        (1, 9, 3, 1, 2048, 64, None, None),
        (4, 10, 1, 32, 512, 128, None, None),
        (2, 6, 2, 16, 1024, 64, 300, 1000),
        (8, 9, 3, 1, 201, 64, None, None)])
    def test_flash_attention_prefill_split(self, cuda, B, Hq, Hkv, C, S, D,
                                           window, kv_len):
        g = torch.Generator().manual_seed(B + C + D)
        q = torch.randn((B, C, Hq, D), generator=g).to(cuda, torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, D), generator=g).to(
            cuda, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
        offs = torch.randint(0, S - C + 1, (B,), generator=g,
                             dtype=torch.int32).to(cuda)
        offs[0] = 0
        kv = S if kv_len is None else kv_len
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert fa.split_plan(B, Hkv, Hq // Hkv, C, kv, sms)[2] > 1
        got = ops.flash_attention_prefill(q.transpose(1, 2), k, v, offs,
                                          window=window, kv_len=kv)
        want = ref.attention_prefill_ref(q.transpose(1, 2), k, v, offs,
                                         window=window, kv_len=kv)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)

    # B3 over int8 K/V (codes and per-(slot, head) bf16 scales from
    # ``quantize_rows``, the model's cache layout): MHA at llama7b-blast's
    # 32 heads of 128, GQA at smollm-135m's 9/3 of 64, decode and chunks at
    # random offsets, the last slot (bf16: split keys), kv_len < S, a
    # window, head dim 72.  (B, Hq, Hkv, C, S, D, window, kv_len, offsets)
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len,where", [
        (8, 32, 32, 1, 512, 128, None, None, "random"),
        (8, 32, 32, 32, 512, 128, None, None, "random"),
        (8, 9, 3, 1, 512, 64, None, None, "last"),
        (8, 9, 3, 32, 512, 64, None, 400, "random"),
        (2, 32, 32, 1, 1024, 128, None, None, "last"),
        (3, 4, 2, 7, 200, 72, 50, None, "random")])
    def test_flash_attention_prefill_q8(self, cuda, dtype, tol, B, Hq, Hkv,
                                        C, S, D, window, kv_len, where):
        g = torch.Generator().manual_seed(B * C + S + D + Hq)
        q = torch.randn((B, C, Hq, D), generator=g).to(cuda, dtype)
        kv = [quant.quantize_rows(torch.randn((B, S, Hkv, D), generator=g)
                                  .to(cuda, dtype)) for _ in range(2)]
        offs = {"last": torch.full((B,), S - C, dtype=torch.int32),
                "random": torch.randint(0, S - C + 1, (B,), generator=g,
                                        dtype=torch.int32)}[where].to(cuda)
        args = (q.transpose(1, 2), kv[0][0].permute(0, 2, 1, 3),
                kv[1][0].permute(0, 2, 1, 3), kv[0][1].transpose(1, 2),
                kv[1][1].transpose(1, 2), offs)
        kw = dict(window=window, kv_len=kv_len)
        ops.reset_launches()
        got = ops.flash_attention_prefill_q8(*args, **kw)
        want = ref.attention_prefill_q8_ref(*args, **kw)
        again = ops.flash_attention_prefill_q8(*args, **kw)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention_prefill_q8"] == 2
        assert ops.launches["flash_attention_prefill"] == 0
        assert got.shape == (B, Hq, C, D) and got.dtype == dtype
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    # B3 over a sliding-window ring (``flash_attention_ring``): key
    # positions from a wrapped ``pos`` (``_ring_inputs``), recurrentgemma-2b's
    # 10/1 × 256 heads at its 2048-slot ring — decode (bf16: split keys)
    # and a 32-token chunk over [ring ‖ chunk] — and smaller rings with a
    # window below S, kv_len < S and GQA 9/3.
    # (B, Hq, Hkv, C, S, D, window, kv_len)
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len", [
        (8, 10, 1, 1, 2048, 256, 2048, None),
        (8, 10, 1, 32, 2048, 256, 2048, None),
        (4, 9, 3, 1, 300, 64, 100, 250),
        (4, 9, 3, 20, 64, 128, 64, None),
        (2, 4, 2, 7, 96, 72, 40, None)])
    def test_flash_attention_ring(self, cuda, dtype, tol, B, Hq, Hkv, C, S,
                                  D, window, kv_len):
        q, k, v, kpos, offs = _ring_inputs(B, Hq, Hkv, C, S, D, dtype, cuda,
                                           seed=B + C + S + D)
        kv = kpos.shape[1] if kv_len is None else kv_len
        kw = dict(window=window, kv_len=kv)
        ops.reset_launches()
        got = ops.flash_attention_ring(q, k, v, kpos, offs, **kw)
        again = ops.flash_attention_ring(q, k, v, kpos, offs, **kw)
        want = ref.attention_ring_ref(q, k, v, kpos, offs, **kw)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention_ring"] == 2
        assert ops.launches["flash_attention_prefill"] == 0
        assert got.shape == (B, Hq, C, D) and got.dtype == dtype
        assert torch.equal(got, again)
        # atol in the output's scale: over a 2048-slot ring |o| is ~0.03,
        # so a fixed 2e-2 would pass a dropped or mis-masked key tile
        atol = tol * min(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=tol)

    # B3 over an int8 ring (``flash_attention_ring_q8``): the ring cases
    # above with K/V as the int8 ring holds them (codes and per-(slot, head)
    # bf16 scales from ``quantize_rows``), against ``attention_ring_q8_ref``
    # (``dequantize_rows``, then the plain ring attention).
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len", [
        (8, 10, 1, 1, 2048, 256, 2048, None),
        (8, 10, 1, 32, 2048, 256, 2048, None),
        (4, 9, 3, 1, 300, 64, 100, 250),
        (4, 9, 3, 20, 64, 128, 64, None),
        (2, 4, 2, 7, 96, 72, 40, None)])
    def test_flash_attention_ring_q8(self, cuda, dtype, tol, B, Hq, Hkv, C,
                                     S, D, window, kv_len):
        q, k, v, kpos, offs = _ring_inputs(B, Hq, Hkv, C, S, D, dtype, cuda,
                                           seed=B + C + S + D + 1)
        codes = [quant.quantize_rows(t.permute(0, 2, 1, 3)) for t in (k, v)]
        args = (q, codes[0][0].permute(0, 2, 1, 3),
                codes[1][0].permute(0, 2, 1, 3), codes[0][1].transpose(1, 2),
                codes[1][1].transpose(1, 2), kpos, offs)
        kv = kpos.shape[1] if kv_len is None else kv_len
        kw = dict(window=window, kv_len=kv)
        ops.reset_launches()
        got = ops.flash_attention_ring_q8(*args, **kw)
        again = ops.flash_attention_ring_q8(*args, **kw)
        want = ref.attention_ring_q8_ref(*args, **kw)
        torch.cuda.synchronize()
        assert ops.launches["flash_attention_ring_q8"] == 2
        assert ops.launches["flash_attention_ring"] == 0
        assert got.shape == (B, Hq, C, D) and got.dtype == dtype
        assert torch.equal(got, again)
        atol = tol * min(1.0, float(want.float().abs().max()))
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=tol)

    def test_ring_kernel_refuses_bad_positions(self, cuda):
        q, k, v, kpos, offs = _ring_inputs(2, 4, 2, 1, 64, 64,
                                           torch.bfloat16, cuda, seed=1)
        for bad in (kpos.long(), kpos[:, :32], kpos.cpu(),
                    kpos.t().contiguous().t()):
            with pytest.raises(ValueError, match="k_pos"):
                ops.flash_attention_ring(q, k, v, bad, offs, window=64)

    def test_q8_kernel_refuses_unpaired_or_misaligned_codes(self, cuda):
        """int8 K/V come with both bf16 scales; the bf16 kernel copies 8
        bytes of codes at a time, and refuses rows that do not start 8-byte
        aligned."""
        q = torch.randn((1, 4, 1, 64), device=cuda, dtype=torch.bfloat16)
        k = torch.zeros((1, 4, 16, 64), device=cuda, dtype=torch.int8)
        sc = torch.ones((1, 4, 16), device=cuda, dtype=torch.bfloat16)
        offs = torch.zeros(1, dtype=torch.int32, device=cuda)
        for scales in ((sc, sc.float()), (sc, None), (None, sc)):
            with pytest.raises(ValueError, match="pair"):
                fa.launch(q, k, k, offs, causal=True, window=None, kv_len=16,
                          k_scale=scales[0], v_scale=scales[1])
        buf = torch.zeros((1, 16, 4 * 64 + 4), device=cuda, dtype=torch.int8)
        kb = buf[:, :, 4:].reshape(1, 16, 4, 64).permute(0, 2, 1, 3)
        with pytest.raises(ValueError, match="8-byte aligned"):
            ops.flash_attention_prefill_q8(q, kb, kb, sc, sc, offs)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_rows_with_no_visible_key_are_zero(self, cuda, dtype):
        """A window past kv_len leaves rows with no visible key: both
        kernels write exactly 0 there (B3 on the split path: one kv head,
        two rows) and agree with the plain versions elsewhere."""
        g = torch.Generator().manual_seed(5)
        q = torch.randn((2, 8, 3, 64), generator=g).to(cuda, dtype)
        k = torch.randn((2, 512, 1, 64), generator=g).to(cuda, dtype)
        v = torch.randn((2, 512, 1, 64), generator=g).to(cuda, dtype)
        offs = torch.tensor([0, 310], dtype=torch.int32, device=cuda)
        args = (q.transpose(1, 2), k.permute(0, 2, 1, 3),
                v.permute(0, 2, 1, 3))
        got = ops.flash_attention_prefill(*args, offs, window=4, kv_len=300)
        want = ref.attention_prefill_ref(*args, offs, window=4, kv_len=300)
        with torch.no_grad():
            full = fa.launch_full(*args, causal=True, window=1, q_offset=4,
                                  kv_len=6)
        full_want = ref.attention_ref(*args, window=1, q_offset=4, kv_len=6)
        torch.cuda.synchronize()
        assert torch.all(got[1] == 0) and torch.any(got[0] != 0)
        assert torch.all(full[:, :, 2:] == 0) and torch.any(full[:, :, :2] != 0)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        for a, b in ((got, want), (full, full_want)):
            torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("C,dead,kv_len", [(1, False, None),
                                               (32, False, None),
                                               (32, True, None),
                                               (20, False, 256)])
    def test_mla_attention(self, cuda, dtype, tol, C, dead, kv_len):
        """The MLA latent kernel at deepseek-v3-671b's width (B = 8, 128
        heads, S = 512, scores over 512 + 64 dims, values the latent)
        against its plain version: random offsets; dead columns (rows of 0
        to C live tokens, row 0 empty: exactly 0); kv_len < S with
        live-looking positions past it, which the kernel must not read.
        bf16 q is rounded the same for both; one launch a call, and two
        launches agree bit for bit."""
        from repro_torch.kernels.flash_attention import kv_bucket
        g = torch.Generator().manual_seed(C + 3 * dead)
        B, H, S = 8, 128, 512
        q_lat, q_rope = (torch.randn((B, C, H, d), generator=g).to(
            cuda, dtype) for d in (512, 64))
        lat, rope = (torch.randn((B, S + 1, d), generator=g).to(
            cuda, dtype)[:, :S] for d in (512, 64))
        offs = torch.randint(0, (kv_len or S) - C + 1, (B,), generator=g)
        n = (torch.randint(0, C + 1, (B,), generator=g) if dead
             else torch.full((B,), C))
        j = torch.arange(S)[None]
        pos = torch.where(j < (offs + n)[:, None], j, -1)
        if dead:
            pos[0] = -1
        kv = kv_bucket(int((offs + n).max()), S) if kv_len is None else kv_len
        if kv_len is not None:
            pos[:, kv_len:] = j[:, kv_len:]
        pos = pos.to(cuda, torch.int32).contiguous()
        offs = offs.to(cuda, torch.int32)
        args = (q_lat, q_rope, lat, rope, pos, offs)
        ops.reset_launches()
        got = ops.mla_attention(*args, scale=192 ** -0.5, kv_len=kv)
        again = ops.mla_attention(*args, scale=192 ** -0.5, kv_len=kv)
        want = ref.mla_attention_ref(*args, scale=192 ** -0.5, kv_len=kv)
        torch.cuda.synchronize()
        assert ops.launches["mla_attention"] == 2
        assert got.dtype == torch.float32 and got.shape == (B, C, H, 512)
        assert torch.equal(got, again)
        if dead:
            assert torch.all(got[0] == 0)
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)

    def test_mla_kernel_refuses_bad_inputs(self, cuda):
        q = torch.zeros((1, 1, 4, 512), device=cuda)
        r = torch.zeros((1, 1, 4, 64), device=cuda)
        lat = torch.zeros((1, 8, 512), device=cuda)
        rope = torch.zeros((1, 8, 64), device=cuda)
        pos = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
        offs = torch.zeros((1,), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="512 \\+ 64"):
            ops.mla_attention(q[..., :256], r, lat, rope, pos, offs,
                              scale=1.0)
        with pytest.raises(ValueError, match="k_pos"):
            ops.mla_attention(q, r, lat, rope, pos.long(), offs, scale=1.0)
        with pytest.raises(ValueError, match="kv_len"):
            ops.mla_attention(q, r, lat, rope, pos, offs, scale=1.0,
                              kv_len=9)

    @pytest.mark.parametrize("which", ["prefill_split", "full"])
    def test_attention_repeats_bitwise(self, cuda, which):
        """Two bf16 launches on the same inputs agree bit for bit: B3 at
        decode on the split path (the combine adds splits in a fixed
        order), and B4 at the training shape."""
        g = torch.Generator().manual_seed(6)
        if which == "full":
            q = torch.randn((8, 256, 9, 64), generator=g).to(cuda, torch.bfloat16)
            kv = torch.randn((8, 256, 6, 64), generator=g).to(cuda,
                                                              torch.bfloat16)
            args = (q.transpose(1, 2), kv[:, :, :3].transpose(1, 2),
                    kv[:, :, 3:].transpose(1, 2))
            run = lambda: ops.flash_attention(*args)  # noqa: E731
        else:
            q = torch.randn((8, 1, 9, 64), generator=g).to(cuda, torch.bfloat16)
            k, v = (torch.randn((8, 512, 3, 64), generator=g).to(
                cuda, torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
            offs = torch.randint(0, 512, (8,), generator=g).to(cuda)
            run = lambda: ops.flash_attention_prefill(  # noqa: E731
                q.transpose(1, 2), k, v, offs)
        first, second = run(), run()
        torch.cuda.synchronize()
        assert torch.equal(first, second)

    def test_split_combine_kernel(self, cuda):
        """The combine kernel alone against its plain version, on split
        partials from the plain split algorithm (some splits and rows with
        no visible key)."""
        g = torch.Generator().manual_seed(7)
        q = torch.randn((3, 9, 4, 72), generator=g).to(cuda)
        k, v = (torch.randn((3, 3, 400, 72), generator=g).to(cuda)
                for _ in range(2))
        offs = torch.tensor([0, 150, 396], dtype=torch.int32, device=cuda)
        acc, m, l = ref.attention_split_ref(q, k, v, offs, window=30,
                                            kv_len=360, splits=3,
                                            keys_per_split=128)
        got = fa.launch_combine(acc, m, l)
        want = ref.attention_combine_ref(acc, m, l)
        torch.cuda.synchronize()
        assert torch.all(l[1:, 0] == 0) and torch.all(l[:, 2] == 0)
        assert torch.all(got[2] == 0) and torch.any(got[:2] != 0)
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)

    def test_bf16_kernel_refuses_misaligned_views(self, cuda):
        """The bf16 kernel copies 16-byte chunks: a view whose rows do not
        start 16-byte aligned raises instead of running."""
        buf = torch.randn((1, 16, 2 * 64 + 4), device=cuda,
                          dtype=torch.bfloat16)
        q = buf[:, :, 4:68].reshape(1, 16, 1, 64).transpose(1, 2)
        k = buf[:, :, 68:132].reshape(1, 16, 1, 64).transpose(1, 2)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention_prefill(q, k, k, torch.zeros(
                1, dtype=torch.int32, device=cuda))
        with pytest.raises(ValueError, match="16-byte aligned"):
            ops.flash_attention(q, k, k)

    @pytest.mark.parametrize("which", ["blast", "grouped", "attention",
                                       "attention256"])
    def test_function_grads(self, cuda, which):
        """The autograd Functions' gradients on the card (kernel forward,
        B1 for BLAST dx) against torch.autograd through the plain versions,
        fp32, within 1e-4 × each gradient's largest entry; attention at head
        dims 64 and 256."""
        from repro_torch.core import blast
        g = torch.Generator().manual_seed(1)
        if which.startswith("attention"):
            D = 256 if which == "attention256" else 64
            inputs = [torch.randn(s, generator=g).to(cuda) for s in
                      ((2, 9, 300, D), (2, 3, 300, D), (2, 3, 300, D))]
            fn, plain = ops.flash_attention, ref.attention_ref
        else:
            G = 2 if which == "grouped" else 1
            sets = [blast.init(g, 576, 1536, 16, 176, device=cuda)
                    for _ in range(G)]
            fac = [torch.stack([s[i] for s in sets]) for i in range(3)]
            x = torch.randn((300, 1536), generator=g).to(cuda)
            if G == 1:
                inputs = [x, *(a[0] for a in fac)]
                fn, plain = ops.blast_matmul, ref.blast_matmul_ref
            else:
                inputs = [x, *fac]
                fn, plain = (ops.blast_matmul_grouped,
                             ref.blast_matmul_grouped_ref)
        a = [t.clone().requires_grad_(True) for t in inputs]
        b = [t.clone().requires_grad_(True) for t in inputs]
        ops.reset_launches()
        y = fn(*a)
        dy = torch.randn(y.shape, generator=g).to(cuda)
        got = torch.autograd.grad(y, a, dy)
        want = torch.autograd.grad(plain(*b), b, dy)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launches.items() if v}
        assert launched == {"blast": {"blast_matmul": 1, "blast_matmul_dx": 1},
                            "grouped": {"blast_matmul_grouped": 1,
                                        "blast_matmul_dx": 2},
                            "attention": {"flash_attention": 1},
                            "attention256": {"flash_attention": 1}}[which]
        for g_, w in zip(got, want):
            assert float((g_ - w).abs().max()) <= 1e-4 * float(w.abs().max())

    @pytest.mark.parametrize("n,m,r", [(1024, 1024, 224), (512, 1024, 144)],
                             ids=["wi", "wo"])
    def test_batched_function_grads(self, cuda, n, m, r):
        """``BlastMatmulBatchedFn`` on the card (the batched launch forward,
        one batched launch over the transposed factors for dx) against
        torch.autograd through the batched plain version: granite-moe's
        ``wi`` and ``wo``, 32 experts of 640 rows (its capacity at batch 8
        × 256), each expert's last rows zero (empty capacity slots), fp32,
        every gradient within 1e-4 × its largest entry."""
        from repro_torch.core import blast
        g = torch.Generator().manual_seed(n + r)
        E, C, b = 32, 640, 16
        sets = [blast.init(g, m, n, b, r, device=cuda) for _ in range(E)]
        fac = [torch.stack([s[i] for s in sets]) for i in range(3)]
        x = torch.randn((E, C, n), generator=g).to(cuda)
        for e in range(E):
            x[e, C - 1 - e % 7:] = 0
        a = [t.clone().requires_grad_(True) for t in (x, *fac)]
        b_ = [t.clone().requires_grad_(True) for t in (x, *fac)]
        ops.reset_launches()
        y = ops.blast_matmul_batched(*a)
        dy = torch.randn(y.shape, generator=g).to(cuda)
        got = torch.autograd.grad(y, a, dy)
        want = torch.autograd.grad(ref.blast_matmul_batched_ref(*b_), b_, dy)
        torch.cuda.synchronize()
        assert {k: v for k, v in ops.launches.items() if v} == {
            "blast_matmul_batched": 1, "blast_matmul_batched_dx": 1}
        for g_, w in zip(got, want):
            assert g_.shape == w.shape
            assert float((g_ - w).abs().max()) <= 1e-4 * float(w.abs().max())

    def test_launchers_refuse_grad_on_card(self, cuda):
        x = torch.randn((8, 64), device=cuda, requires_grad=True)
        U, S, V = (torch.randn(s, device=cuda) for s in
                   ((1, 4, 16, 16), (1, 4, 4, 16), (1, 4, 16, 16)))
        with pytest.raises(RuntimeError, match="requires grad"):
            bm.launch(x, U, S, V)
        q = torch.randn((1, 2, 8, 64), device=cuda, requires_grad=True)
        k = torch.randn((1, 1, 8, 64), device=cuda)
        with pytest.raises(RuntimeError, match="requires grad"):
            fa.launch_full(q, k, k, causal=True, window=None, q_offset=0,
                           kv_len=8)
        with torch.no_grad():
            assert bm.launch(x, U, S, V).shape == (1, 8, 64)
        # the batched launch (one x a factor set) refuses a factor that
        # requires grad
        xe = torch.randn((2, 8, 64), device=cuda)
        Ue = torch.randn((2, 4, 16, 16), device=cuda, requires_grad=True)
        with pytest.raises(RuntimeError, match="requires grad"):
            bm.launch(xe, Ue, *(torch.randn(s, device=cuda) for s in
                                ((2, 4, 4, 16), (2, 4, 16, 16))))


@pytest.mark.gpu
class TestCompressOnCard:
    """Compression (``core/factorize.py``, ``core/compress.py``) on the
    card against the CPU from one start, fp32: plain products and batched
    solves, no kernel of the port's, on the card's libraries."""

    @pytest.fixture
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @pytest.mark.parametrize("opt", [{}, {"precondition": False, "lr": 0.05},
                                     {"spectral_steps": True}])
    def test_factorize_card_equals_cpu(self, cuda, opt):
        """20 steps at 128 × 96, b = 8, r = 16: the loss before each step
        and after the last within 1e-4 relative."""
        from repro_torch.core import factorize
        g = torch.Generator().manual_seed(0)
        A = torch.randn((128, 96), generator=g)
        start = (1e-2 * torch.randn((8, 16, 16), generator=g),
                 torch.rand((8, 8, 16), generator=g),
                 1e-2 * torch.randn((8, 12, 16), generator=g))
        cpu = factorize.factorize(A, 8, 16, steps=20, start=start, **opt)
        card = factorize.factorize(A.to(cuda), 8, 16, steps=20,
                                   start=tuple(t.to(cuda) for t in start),
                                   **opt)
        want = torch.cat([cpu.losses, cpu.final_loss[None]])
        got = torch.cat([card.losses, card.final_loss[None]]).cpu()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)

    @pytest.mark.parametrize("kind", ["low_rank", "block_diag", "monarch",
                                      "pixelfly"])
    def test_compress_linear_card_equals_cpu(self, cuda, kind):
        """Each fit's product on a test input within 1e-4 of its scale (an
        SVD's signs may differ between devices; its product does not)."""
        from repro_torch.configs import StructureConfig
        from repro_torch.core import compress, structures
        spec = structures.make_linear(64, 96, StructureConfig(kind=kind, b=4))
        g = torch.Generator().manual_seed(1)
        w = torch.randn((64, 96), generator=g)
        start = spec.init(torch.Generator().manual_seed(2))
        x = torch.randn((5, 64), generator=g)
        cpu = compress.compress_linear(w, spec, steps=10, start=start)
        card = compress.compress_linear(
            w.to(cuda), spec, steps=10,
            start={k: v.to(cuda) for k, v in start.items()})
        with torch.no_grad():
            want = spec.apply(cpu, x)
            got = spec.apply(card, x.to(cuda)).cpu()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
