"""The bf16 prefill-attention kernel's design (B3), on the CPU.

- ``flash_attention.split_plan``, the launch plan (host ints only): warps
  and row tiles of the GQA-packed rows, and key splits that are contiguous,
  disjoint, whole tiles, and cover [0, kv_len).
- The plain versions of the packed, split algorithm and of the combine
  step (``ref.attention_split_ref``, ``ref.attention_combine_ref``; nothing
  on the main path calls them) against ``ref.attention_prefill_ref`` in
  float64 (1e-10: the same softmax, summed in another order), with splits
  in which no key is live and rows that see no key; and against the JAX
  package's ``flash_attention_prefill_pallas`` in interpret mode on one
  small case, fp32 (1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_prefill_pallas

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

F64 = dict(atol=1e-10, rtol=1e-10)
SMS = 132          # the H100's SMs

# (B, Hkv, G, C, kv_len, sms): smollm-135m decode and prefill chunks,
# recurrentgemma-2b's 10 heads over 1, ragged G·C and kv_len, a grid that
# fills the card, no keys, and a small card
PLAN_SHAPES = [(8, 3, 3, 1, 512, SMS), (8, 3, 3, 32, 512, SMS),
               (8, 1, 10, 1, 512, SMS), (8, 1, 10, 32, 512, SMS),
               (2, 2, 4, 7, 63, SMS), (2, 2, 4, 7, 65, SMS),
               (64, 3, 3, 1, 512, SMS), (1, 1, 1, 1, 2048, SMS),
               (1, 1, 1, 1, 0, SMS), (4, 1, 3, 5, 1000, 16),
               (3, 2, 1, 33, 4096, SMS)]


@pytest.mark.parametrize("B,Hkv,G,C,kv_len,sms", PLAN_SHAPES)
def test_split_plan(B, Hkv, G, C, kv_len, sms):
    warps, tiles, splits, kps = fa.split_plan(B, Hkv, G, C, kv_len, sms)
    rows = G * C
    assert 1 <= warps <= fa.MAX_WARPS
    # the row tiles hold every packed row, and none is empty
    assert tiles * warps * 16 >= rows > (tiles - 1) * warps * 16
    assert warps * 16 - rows < 16 or tiles > 1
    assert splits >= 1 and kps > 0 and kps % fa.KEY_TILE == 0
    ranges = [(s * kps, min(kv_len, (s + 1) * kps)) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == kv_len
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2                    # contiguous, not overlapping
    if kv_len:
        assert all(hi > lo for lo, hi in ranges)        # none empty
    blocks = B * Hkv * tiles
    if 2 * blocks >= sms:
        assert splits == 1
    else:                       # every block in the first wave
        assert blocks * splits <= max(sms, blocks)
        assert splits == 1 or splits > 1 and kv_len > fa.KEY_TILE


# the card tests' split shapes (tests/test_torch_kernels_gpu.py::
# test_flash_attention_prefill_split), each with the split count the plan
# gives it on 132 SMs: (B, Hkv, G, C, kv_len, splits)
SPLIT_SHAPES = [(8, 3, 3, 32, 512, 2), (3, 3, 3, 7, 200, 4),
                (2, 1, 10, 4, 300, 5), (2, 2, 2, 1, 640, 10),
                (1, 3, 3, 1, 2048, 32), (4, 1, 10, 32, 512, 4),
                (2, 2, 3, 16, 1000, 16), (8, 3, 3, 1, 201, 4)]


@pytest.mark.parametrize("B,Hkv,G,C,kv_len,splits", SPLIT_SHAPES)
def test_split_plan_of_card_shapes(B, Hkv, G, C, kv_len, splits):
    assert fa.split_plan(B, Hkv, G, C, kv_len, SMS)[2] == splits


def _inputs(seed, B, Hq, Hkv, C, S, D, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(dtype))
                 for s in ((B, Hq, C, D), (B, Hkv, S, D), (B, Hkv, S, D)))


# (B, Hq, Hkv, C, S, D, window, kv_len, offsets, splits, keys per split):
# the plan's splits at decode; offsets at slot 0 (later splits see no key);
# windows past kv_len (rows that see no key in any split); G = 1 and 10;
# G·C not a multiple of 16; one split
SPLIT_CASES = [
    (8, 9, 3, 1, 512, 8, None, None, "plan", None, None),
    (3, 6, 2, 5, 200, 16, None, None, [0, 100, 195], 4, 64),
    (2, 10, 1, 1, 300, 8, 17, 250, [0, 299], 5, 64),
    (2, 3, 3, 7, 130, 24, None, 100, [93, 120], 2, 64),
    (2, 4, 2, 3, 64, 16, 2, 10, [20, 5], 1, None),
    (2, 9, 3, 20, 300, 8, 40, 250, [0, 280], 3, 128),
]


@pytest.mark.parametrize("B,Hq,Hkv,C,S,D,window,kv_len,offsets,splits,kps",
                         SPLIT_CASES)
def test_split_algorithm_matches_attention(B, Hq, Hkv, C, S, D, window,
                                           kv_len, offsets, splits, kps):
    q, k, v = _inputs(B + C + S, B, Hq, Hkv, C, S, D)
    if offsets == "plan":
        _, _, splits, kps = fa.split_plan(B, Hkv, Hq // Hkv, C, S, SMS)
        assert splits > 1
        offsets = [0, 0, 5, 17, 100, 300, 480, 511]
    offs = torch.tensor(offsets, dtype=torch.int32)
    acc, m, l = ref.attention_split_ref(q, k, v, offs, window=window,
                                        kv_len=kv_len, splits=splits,
                                        keys_per_split=kps)
    assert acc.shape == (splits, B, C, Hq, D) and m.shape == l.shape
    got = ref.attention_combine_ref(acc, m, l)
    want = ref.attention_prefill_ref(q, k, v, offs, window=window,
                                     kv_len=kv_len)
    torch.testing.assert_close(got, want, **F64)
    # a split's empty rows hold the kernel's empty state
    empty = l == 0
    assert torch.all(m[empty] == ref.ATTN_M_INIT)
    assert torch.all(acc[empty] == 0)


def test_split_cases_cover_empty_splits_and_rows():
    """The cases above include splits with no live key for some rows, and
    rows that see no key at all (they return exactly 0)."""
    q, k, v = _inputs(0, 2, 10, 1, 1, 300, 8)
    offs = torch.tensor([0, 299], dtype=torch.int32)
    acc, m, l = ref.attention_split_ref(q, k, v, offs, window=17, kv_len=250,
                                        splits=5, keys_per_split=64)
    assert torch.all(l[1:, 0] == 0)        # row b = 0 lives in split 0
    assert torch.all(l[:, 1] == 0)         # row b = 1 sees no key
    out = ref.attention_combine_ref(acc, m, l)
    assert torch.all(out[1] == 0) and torch.any(out[0] != 0)


def test_combine_ignores_empty_splits():
    """A split with no live key (m = M_INIT, l = 0, acc = 0) changes
    nothing, wherever it stands."""
    q, k, v = _inputs(3, 2, 6, 2, 4, 256, 16)
    offs = torch.tensor([40, 200], dtype=torch.int32)
    acc, m, l = ref.attention_split_ref(q, k, v, offs, splits=4,
                                        keys_per_split=64)
    base = ref.attention_combine_ref(acc, m, l)
    for at in (0, 2, 4):
        acc2 = torch.cat([acc[:at], torch.zeros_like(acc[:1]), acc[at:]])
        m2 = torch.cat([m[:at], torch.full_like(m[:1], ref.ATTN_M_INIT),
                        m[at:]])
        l2 = torch.cat([l[:at], torch.zeros_like(l[:1]), l[at:]])
        torch.testing.assert_close(ref.attention_combine_ref(acc2, m2, l2),
                                   base, atol=0, rtol=0)


def test_split_algorithm_matches_pallas_kernel():
    """fp32, one small case: the plain packed, split algorithm (G = 3, two
    splits, a window) against the TPU kernel in interpret mode."""
    B, Hq, Hkv, C, S, D = 2, 6, 2, 8, 128, 16
    q, k, v = _inputs(11, B, Hq, Hkv, C, S, D, np.float32)
    offs = np.asarray([3, 120], np.int32)
    want = flash_attention_prefill_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(offs), window=50, block_q=8, block_kv=32, interpret=True)
    acc, m, l = ref.attention_split_ref(q, k, v, torch.from_numpy(offs),
                                        window=50, splits=2,
                                        keys_per_split=64)
    got = ref.attention_combine_ref(acc, m, l)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
