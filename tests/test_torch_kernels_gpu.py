"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports the JAX package.)
Tolerances: fp32 ``atol = rtol = 1e-4``; bf16 ``2e-2``.  The int8, int4,
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


def _factors(rng, b, p, q, r, lead=()):
    return (rng.standard_normal((*lead, b, p, r)).astype(np.float32),
            rng.standard_normal((*lead, b, b, r)).astype(np.float32),
            rng.standard_normal((*lead, b, q, r)).astype(np.float32))


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
                                             (37, 1, 4, 101, 5, 19)])
    def test_blast_kernels(self, cuda, dtype, tol, T, G, b, p, q, r):
        """The float kernel's paths: r split (T ≤ 300) or whole, output
        blocks grouped (at decode, and b = 32 at any T) or not, p in column
        chunks (p > 96, or tiles too wide for one chunk at n = 2048),
        ragged T, r, q and p."""
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
    @pytest.mark.parametrize("act", ["none", "int8"])
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("T,G,b,p,q,r", [(1, 1, 4, 24, 16, 19),
                                             (37, 1, 16, 60, 36, 144),
                                             (37, 2, 4, 8, 8, 21),
                                             (8, 2, 16, 96, 36, 176)])
    def test_blast_q_kernels(self, cuda, bits, act, dtype, tol, T, G, b, p,
                             q, r):
        """int8 / int4 weights (act "none") and W8A8 / W4A8 (act "int8"):
        the kernel and its plain version get the same codes (int4:
        nibble-packed, odd ranks included), scales and activation codes."""
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
                                            (20, 9, 16), (3, None, 128)])
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

    # (B, Hq, Hkv, T, S, causal, window, q_offset): the chip_smoke shapes
    # of B4 and a head dim of 128
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("B,Hq,Hkv,T,S,causal,window,q_offset,D", [
        (8, 9, 3, 256, 256, True, None, 0, 64),
        (1, 9, 3, 2048, 2048, True, None, 0, 64),
        (2, 9, 3, 200, 200, True, None, 0, 64),
        (2, 9, 3, 256, 256, True, 64, 0, 64),
        (2, 9, 3, 256, 320, True, None, 64, 64),
        (2, 9, 3, 256, 256, False, None, 0, 64),
        (2, 4, 1, 100, 100, True, None, 0, 128)])
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

    @pytest.mark.parametrize("which", ["blast", "grouped", "attention"])
    def test_function_grads(self, cuda, which):
        """The autograd Functions' gradients on the card (kernel forward,
        B1 for BLAST dx) against torch.autograd through the plain versions,
        fp32, within 1e-4 × each gradient's largest entry."""
        from repro_torch.core import blast
        g = torch.Generator().manual_seed(1)
        if which == "attention":
            inputs = [torch.randn(s, generator=g).to(cuda) for s in
                      ((2, 9, 300, 64), (2, 3, 300, 64), (2, 3, 300, 64))]
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
                            "attention": {"flash_attention": 1}}[which]
        for g_, w in zip(got, want):
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
