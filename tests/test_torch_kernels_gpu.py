"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports the JAX package.)
Tolerances: fp32 ``atol = rtol = 1e-4``; bf16 ``2e-2``.  The int8 and
W8A8 kernels are held to the same: their plain versions take the same codes
and scales (and, for W8A8, the same activation codes), so only the order of
the float sums differs.
"""

import numpy as np
import pytest
import torch

from repro_torch import quant
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
                                             (8, 2, 16, 96, 36, 176)])
    def test_blast_kernels(self, cuda, dtype, tol, T, G, b, p, q, r):
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

    @pytest.mark.parametrize("act", ["none", "int8"])
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                           (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("T,G,b,p,q,r", [(1, 1, 4, 24, 16, 19),
                                             (37, 1, 16, 60, 36, 144),
                                             (37, 2, 4, 8, 8, 21),
                                             (8, 2, 16, 96, 36, 176)])
    def test_blast_q_kernels(self, cuda, act, dtype, tol, T, G, b, p, q, r):
        """int8 weights (act "none") and W8A8 (act "int8"): the kernel and
        its plain version get the same codes, scales and activation codes."""
        rng = np.random.default_rng(T + G + r)
        x = _t(rng.standard_normal((T, b * q)).astype(np.float32)).to(cuda, dtype)
        codes, scales = [], []
        for a, axes, shape in zip(_factors(rng, b, p, q, r, lead=(G,)),
                                  ((1, 2), (2,), (1, 2)),
                                  ((b,), (b, b), (b,))):
            qa = [quant.quantize(_t(a[g]).to(cuda) / 4, block_axes=axes)
                  for g in range(G)]
            codes.append(torch.stack([x_.q for x_ in qa]))
            scales.append(torch.stack([x_.scale.reshape(shape) for x_ in qa]))
        ops.reset_launches()
        if G == 1:
            fac = [quant.QArray(c[0], s.reshape(shape)) for c, s, shape in
                   zip(codes, scales, ((b, 1, 1), (b, b, 1), (b, 1, 1)))]
            got = ops.blast_matmul_q(x, *fac, act=act)[None]
            key = "blast_matmul_w8a8" if act == "int8" else "blast_matmul_q"
        else:
            got = ops.blast_matmul_grouped_q(x, *codes, *scales, act=act)
            key = ("blast_matmul_grouped_w8a8" if act == "int8"
                   else "blast_matmul_grouped_q")
        if act == "int8":
            xq, sx = quant.quantize_act(x)
            want = ref.blast_matmul_grouped_a8_ref(xq, sx, *codes,
                                                   *scales).to(dtype)
        else:
            want = ref.blast_matmul_grouped_q_ref(x, *codes, *scales)
        torch.cuda.synchronize()
        assert ops.launches[key] == 1 and sum(ops.launches.values()) == 1
        assert got.dtype == dtype and got.shape == (G, T, b * p)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)

    def test_quantizers_equal_cpu(self, cuda):
        """Codes and scales on the card equal the CPU's bit for bit (the CPU
        ones equal the JAX package's: tests/test_torch_quant.py)."""
        rng = np.random.default_rng(3)
        for shape, axes in (((16, 96, 176), (1, 2)), ((16, 16, 176), (2,)),
                            ((4096, 576), (1,))):
            a = _t(rng.standard_normal(shape).astype(np.float32)
                   * rng.uniform(0.01, 3.0, shape[:1] + (1,) * (len(shape) - 1)
                                 ).astype(np.float32))
            got, want = quant.quantize(a.to(cuda), block_axes=axes), \
                quant.quantize(a, block_axes=axes)
            assert torch.equal(got.q.cpu(), want.q)
            assert torch.equal(got.scale.cpu(), want.scale)
            xq, sx = quant.quantize_act(a.to(cuda))
            wq, ws = quant.quantize_act(a)
            assert torch.equal(xq.cpu(), wq) and torch.equal(sx.cpu(), ws)

    def test_engine_scopes_its_activation_mode(self, cuda):
        """An int8-only engine built after a W8A8 engine launches the int8
        kernels; the W8A8 engine launches the W8A8 kernels."""
        from repro_torch import configs
        from repro_torch.models import build_model
        from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                                       SamplingParams, SchedulerConfig)
        model = build_model(configs.get("smollm-135m").reduced(), device=cuda)
        params = model.init(0)
        cfg = dict(scheduler=SchedulerConfig(slots=2, chunk_size=4),
                   memory=MemoryConfig(max_len=32))
        w8a8 = Engine(model, params, EngineConfig(**cfg, quant=quant.QuantConfig(
            weights="int8", activations="int8")), device=cuda)
        int8 = Engine(model, params, EngineConfig(
            **cfg, quant=quant.QuantConfig(weights="int8")), device=cuda)
        for eng, keys in ((int8, ("blast_matmul_q", "blast_matmul_grouped_q")),
                          (w8a8, ("blast_matmul_w8a8",
                                  "blast_matmul_grouped_w8a8"))):
            ops.reset_launches()
            eng.generate_batch([[1, 2, 3]], SamplingParams(max_new_tokens=2))
            torch.cuda.synchronize()
            steps = eng.stats["steps"]
            L = model.cfg.n_layers
            assert steps > 0
            assert {k: v for k, v in ops.launches.items() if v} == {
                keys[0]: 3 * L * steps, keys[1]: L * steps,
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
