"""The float BLAST kernel's launch plan (``kernels/blast_matmul.py``
``split_plan``), on the CPU: every rank granule and every output block is
covered exactly once, no group holds more output blocks than a kernel
block can, no split is made at the training step's 2048 tokens, and a
split launch stays within one wave of blocks — also at 32 factor sets of
3 and 80 rows each (granite-moe's batched expert launches at decode and
at a chunk)."""

import pytest

from repro_torch.kernels import blast_matmul as bm

SMS, TILE_T, TILE_R, TILE_B = 132, 16, 16, 16   # an H100, the kernel's tiles


@pytest.mark.parametrize("T", [1, 3, 8, 37, 80, 256, 300, 2048])
@pytest.mark.parametrize("G", [1, 2, 32])
@pytest.mark.parametrize("r,b", [(19, 4), (112, 16), (144, 16), (176, 16),
                                 (224, 16), (144, 8), (48, 32)])
def test_plan_covers_r_and_blocks_once(T, G, r, b):
    splits, rps, ipg = bm.split_plan(T, G, r, b, SMS, TILE_T, TILE_R, TILE_B)
    granules = -(-r // TILE_R)
    groups = -(-b // ipg)
    assert rps % TILE_R == 0
    assert splits * rps >= granules * TILE_R > (splits - 1) * rps
    assert groups * ipg >= b > (groups - 1) * ipg
    assert ipg <= TILE_B
    need = -(-b // TILE_B)           # groups b needs whatever T is
    if splits > 1 or groups > need:  # split launches fit one wave
        assert -(-T // TILE_T) * G * splits * groups <= SMS
    if T >= 2048:
        assert splits == 1 and groups == need


def test_decode_plan_fills_the_card():
    """At decode (8 tokens) the smollm-135m linears spread over many SMs:
    one split per granule and four output groups."""
    for r in (112, 144, 176):
        splits, rps, ipg = bm.split_plan(8, 1, r, 16, SMS, TILE_T, TILE_R,
                                         TILE_B)
        assert (splits, rps, ipg) == (r // 16, 16, 4)
