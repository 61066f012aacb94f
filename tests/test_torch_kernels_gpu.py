"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports the JAX package.)
Tolerances: fp32 ``atol = rtol = 1e-4``; bf16 ``2e-2``.
"""

import numpy as np
import pytest
import torch

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
