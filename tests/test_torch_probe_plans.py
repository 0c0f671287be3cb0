"""The plans of the Hopper bodies of K6 (Winograd conv3x3) and K9 (streaming
copy), and their wrappers' checks, on the CPU.

``copy_plan`` and ``wino3x3_plan`` decide in Python what the kernels
launch, so their coverage is held here: every byte of a copy in exactly one
chunk, every output tile in exactly one block, every input channel in
exactly one split. The C entries' constants are read from their sources and
held to the plans' mirrors. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu_torch.ops.probes import stream as S
from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as W
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS
from complex_prompt_diffusion_tpu_torch.tools.probe_groupnorm import BATCH, COPY_SHAPES

CSRC = Path(__file__).resolve().parents[1] / "complex_prompt_diffusion_tpu_torch" / "csrc"
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on the H100


def _constexprs(src: str) -> dict:
    text = (CSRC / src).read_text()
    return {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", text)}


# ---- K9: copy_plan ----

_COPY_CASES = [(BATCH, hw, c, rows, st) for hw, c in COPY_SHAPES
               for rows in (16, 64, 256, 512, 1024, 2048, hw) if hw % rows == 0
               for st in S.STAGES]
_COPY_CASES += [(2, 256, 64, r, st) for r in (4, 64, 256) for st in S.STAGES]  # phase 10's
_COPY_CASES += [(3, 1024, 40, r, st) for r in (4, 64, 1024) for st in (1, 8)]  # the card tests'
_COPY_CASES += [(1, 7, 24, 7, 3), (5, 36, 8, 12, 4)]  # odd tile counts and shares


@pytest.mark.parametrize("n,hw,c,rows,stages", _COPY_CASES)
def test_copy_plan_covers_every_byte_once(n, hw, c, rows, stages):
    plan = S.copy_plan(n, hw, c, rows, stages)
    total = n * hw * c * 2
    assert plan.tiles * plan.tile_bytes == total and plan.tile_bytes == rows * c * 2
    seen = np.zeros(total // 16, dtype=np.int32)
    for block in range(plan.grid):
        for off, nbytes in plan.block_chunks(block):
            assert off % 16 == 0 and nbytes % 16 == 0 and 16 <= nbytes <= plan.slot
            seen[off // 16:(off + nbytes) // 16] += 1
    assert (seen == 1).all()
    # every share starts a tile's 16-byte unit and every block has work
    assert 1 <= plan.split <= plan.tile_bytes // 16
    assert 1 <= plan.grid <= min(plan.items, S.SMS * plan.ctas_per_sm)


@pytest.mark.parametrize("stages", S.STAGES)
def test_copy_plan_keeps_the_ring_within_the_card(stages):
    """Each block's ring fits its share of an SM's shared memory, and every
    depth keeps about the same bytes in flight an SM."""
    for hw, c in COPY_SHAPES:
        for rows in (16, 64, hw):
            plan = S.copy_plan(BATCH, hw, c, rows, stages)
            assert plan.slot <= S.SLOT_MAX and plan.slot % 16 == 0
            ring = stages * plan.slot + 8 * stages
            assert ring * plan.ctas_per_sm <= SMEM_LIMIT
            assert plan.ctas_per_sm * stages <= S.SLOTS_PER_SM or plan.ctas_per_sm == 1
    # the C entry refuses slots above 32 KB; the plan stays below
    assert S.SLOT_MAX <= 32768
    assert "slot > 32768" in (CSRC / "probe_copy_sm90.cu").read_text()


def test_copy_plan_fills_the_card_where_tiles_are_few():
    """PR-4's body ran one block a tile: 8 blocks at rows = 4096 on
    [8, 4096, 320]. The plan cuts such tiles into shares for every SM, and
    spreads them evenly."""
    for stages in S.STAGES:
        plan = S.copy_plan(8, 4096, 320, 4096, stages)
        assert plan.grid == S.SMS * plan.ctas_per_sm
        assert plan.items % plan.grid == 0
    small = S.copy_plan(8, 4096, 320, 16, 1)
    assert small.split == 1 and small.grid == S.SMS * small.ctas_per_sm


@pytest.mark.parametrize("args", [(8, 4096, 320, 48, 1), (8, 4096, 320, 64, 2),
                                  (8, 4096, 320, 0, 1), (1, 6, 3, 2, 1)])
def test_copy_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        S.copy_plan(*args)


def test_stream_copy_wrappers_refuse_and_run_the_plain_twin_on_cpu():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 64, 24)).astype(np.float32)).bfloat16()
    counts = (S.stream_copy.launches, S.stream_copy_prior.launches)
    for fn in (S.stream_copy, S.stream_copy_prior):
        for convert in (False, True):
            assert torch.equal(fn(x, 16, convert, 4), x)
        with pytest.raises(ValueError):
            fn(x, 48)  # rows must divide HW
        with pytest.raises(ValueError):
            fn(x, 16, False, 2)  # not a depth of the probe
        with pytest.raises(ValueError):
            fn(x[0], 16)  # not [N, HW, C]
    assert (S.stream_copy.launches, S.stream_copy_prior.launches) == counts


# ---- K6: wino3x3_plan ----

_WINO_PLANES = [(2, hw, hw, c, co) for hw, c, co in B1_UNET_CONVS]  # phase 9's convs
_WINO_PLANES += [(8, 32, 32, 640, 640), (2, 32, 32, 1280, 1280), (1, 8, 8, 128, 128),
                 (3, 10, 14, 128, 64), (1, 20, 12, 64, 192), (2, 64, 64, 320, 320),
                 (1, 36, 20, 192, 128)]


@pytest.mark.parametrize("b,h,w,c,co", _WINO_PLANES)
def test_wino3x3_plan_covers_every_tile_and_channel_once(b, h, w, c, co):
    plan = W.wino3x3_plan(b, h, w, c, co)
    assert plan.tw * plan.th == W.SM90_BT and plan.tw in (4, 8, 16)
    tiles = {}
    for block in range(plan.m_blocks):
        for t in plan.tiles(block):
            if t[1] < h // 2 and t[2] < w // 2:  # tiles past the plane are not written
                tiles[t] = tiles.get(t, 0) + 1
    assert len(tiles) == b * (h // 2) * (w // 2) and set(tiles.values()) == {1}
    assert plan.n_blocks * W.SM90_BN >= co > (plan.n_blocks - 1) * W.SM90_BN
    ranges = [plan.c_range(s) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(ch for r in ranges for ch in r) == list(range(c))
    assert plan.launches == (1 if plan.splits == 1 else 2)
    # the patch box of a block fits the kernel's buffer and TMA's box limits
    pw, ph = 2 * plan.tw + 2, 2 * plan.th + 2
    assert pw <= 256 and ph <= 256 and pw * ph * W.SM90_KC * 2 <= 34 * 10 * 128


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 20])
def test_wino3x3_plan_forced_splits_cut_c_into_disjoint_runs(splits):
    plan = W.wino3x3_plan(2, 16, 16, 1280, 1280, splits)
    ranges = [plan.c_range(s) for s in range(plan.splits)]
    assert plan.splits <= splits and plan.splits * plan.chunks_per_split >= plan.kchunks
    flat = [ch for r in ranges for ch in r]
    assert flat == list(range(1280))  # in split order, disjoint


def test_wino3x3_plan_splits_where_blocks_are_few():
    """The 16^2 planes have 128 tiles at UNet batch 2: two 64-tile blocks a
    128-channel slab. The plan splits C there, and leaves the batch-8 32^2
    plane (160 blocks) nearly whole."""
    assert W.wino3x3_plan(2, 16, 16, 1280, 1280).splits > 1
    big = W.wino3x3_plan(8, 32, 32, 640, 640)
    assert big.m_blocks * big.n_blocks == 160 and big.splits <= 2


@pytest.mark.parametrize("args", [(2, 16, 16, 96, 128), (2, 16, 16, 128, 96), (2, 6, 16, 128, 128),
                                  (2, 16, 15, 128, 128)])
def test_wino3x3_plan_refuses_what_the_body_does_not_take(args):
    with pytest.raises(ValueError):
        W.wino3x3_plan(*args)
    with pytest.raises(ValueError):
        W.wino3x3_plan(2, 16, 16, 128, 128, splits=3)  # 2 chunks of 64 channels


def test_wino3x3_mirrors_match_the_c_source():
    k = _constexprs("winograd_sm90.cu")
    assert (int(k["BT"]), int(k["BN"]), int(k["KC"])) == (W.SM90_BT, W.SM90_BN, W.SM90_KC)
    text = (CSRC / "winograd_sm90.cu").read_text()
    assert "tw != 4 && tw != 8 && tw != 16" in text  # the rectangles the plan picks
    assert "C % KC" in text and "Co % 64" in text  # takes what k6_body routes there


def test_wino3x3_routes_by_the_stated_shape_rule():
    bf, f32 = torch.bfloat16, torch.float32
    assert W.k6_body(bf, 640, 1280) == W.k6_body(bf, 64, 64) == "bf16_sm90"
    assert W.k6_body(bf, 96, 128) == W.k6_body(bf, 128, 96) == "prior"
    assert W.k6_body(f32, 640, 640) == "f32_sm90"  # f32 goes to its own Hopper body
    for hw, c, co in B1_UNET_CONVS:  # every ResBlock conv of phase 9 takes the Hopper body
        assert W.k6_body(bf, c, co) == "bf16_sm90"


def _wino_inputs(b, h, w, c, co, dtype, seed=9):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32)).to(dtype)
    k = torch.from_numpy((rng.standard_normal((3, 3, c, co)) * 0.05).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32)).to(dtype)
    return x, k, bias


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wino3x3_bodies_run_the_plain_twin_on_cpu(dtype):
    x, k, bias = _wino_inputs(1, 8, 8, 64, 64, dtype)
    u = W.winograd_weights(k).to(dtype)
    want = W.wino3x3_plain(x, u, bias)
    counts = (W.wino3x3.launches, W.wino3x3_sm90.launches, W.wino3x3_prior.launches)
    assert torch.equal(W.wino3x3(x, k, bias), want)
    assert torch.equal(W.wino3x3_prior(x, k, bias, u=u), want)
    if dtype == torch.bfloat16:
        assert torch.equal(W.wino3x3_sm90(x, k, bias, u=u, splits=1), want)
    else:
        with pytest.raises(ValueError):  # the Hopper body is bf16 only
            W.wino3x3_sm90(x, k, bias)
    assert (W.wino3x3.launches, W.wino3x3_sm90.launches, W.wino3x3_prior.launches) == counts


def test_wino3x3_bodies_refuse_what_they_refused():
    x, k, bias = _wino_inputs(1, 8, 8, 64, 64, torch.bfloat16)
    for fn in (W.wino3x3, W.wino3x3_sm90, W.wino3x3_prior):
        with pytest.raises(ValueError):
            fn(x[:, :6, :6], k, bias)  # a plane below 8
        with pytest.raises(ValueError):
            fn(x, k, bias[:8])  # bias of another width
        with pytest.raises(ValueError):
            fn(x, k, bias, u=W.winograd_weights(k))  # U in f32 for a bf16 x
        with pytest.raises(ValueError):
            fn(x, k[:, :, :32], bias)  # a kernel of another C
    x96, k96, b96 = _wino_inputs(1, 8, 8, 96, 64, torch.bfloat16)
    with pytest.raises(ValueError):  # C % 64 != 0: not the Hopper body's
        W.wino3x3_sm90(x96, k96, b96)
    assert W.wino3x3_prior(x96, k96, b96).shape == (1, 8, 8, 64)
