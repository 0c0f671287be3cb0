"""K5's Hopper bodies: which body each dtype and head dim takes, and the
Python mirror of their blocks (``ops.attention.k5_config``), on the CPU.

The mirror repeats the ``Cfg`` / ``CfgF`` of ``csrc/attention_cm_sm90.cu``
and ``csrc/attention_cm_f32_sm90.cu``; a card test in
``tests/test_torch_cuda.py`` holds it to what the C entries report.
"""

import importlib

import pytest
import torch

A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")

SMEM_MAX = 232448  # the H100's shared memory a block may use
BF16_DS = [d for d in range(8, 257, 8) if (d + 15) // 16 * 16 in A._ATTN_BF16_DP]
F32_DS = list(range(4, 257, 4))


@pytest.mark.parametrize("k_canonical", [False, True])
@pytest.mark.parametrize("dtype,ds", [(torch.bfloat16, BF16_DS), (torch.float32, F32_DS)])
def test_every_accepted_head_dim_fits_one_block(dtype, ds, k_canonical):
    for d in ds:
        c = A.k5_config(dtype, d, k_canonical)
        assert c.smem_bytes <= SMEM_MAX, (d, c)
        if c.body == "f32_unfused":
            continue
        assert c.width >= d and c.width % 8 == 0
        assert c.query_rows in (64, 128) and c.key_tile in (32, 64, 128)
        assert c.stages >= (2 if dtype == torch.bfloat16 else 1)


def test_k5_body_routes_as_documented():
    bf, f32 = torch.bfloat16, torch.float32
    assert {A.k5_body(bf, d) for d in BF16_DS} == {"sm90"}
    assert [d for d in F32_DS if A.k5_body(f32, d) == "f32_sm90"] == list(range(4, 161, 4))
    assert [d for d in F32_DS if A.k5_body(f32, d) == "f32_unfused"] == list(range(164, 257, 4))
    # the SD-1.5 head dims
    assert [A.k5_body(f32, d) for d in (40, 80, 160)] == ["f32_sm90"] * 3
    for d in (4, 12, 104, 112, 136, 200, 240, 264):  # no padded width K1 has
        with pytest.raises(ValueError):
            A.k5_body(bf, d)
    for d in (6, 260):
        with pytest.raises(ValueError):
            A.k5_body(f32, d)
    with pytest.raises(TypeError):
        A.k5_body(torch.float16, 64)


def test_k5_blocks_at_the_sd_head_dims():
    """The tiles the design notes give: bf16 128-key tiles up to d = 128 and
    64 above, with 2 to 4 stages; f32 128 rows x 64 keys to d = 80, 128 x
    32 to 128, 64 x 32 to 160."""
    cfg = {d: A.k5_config(torch.bfloat16, d) for d in (40, 80, 160, 256)}
    assert [(c.width, c.key_tile) for c in cfg.values()] == [(40, 128), (80, 128), (160, 64),
                                                            (256, 64)]
    assert all(2 <= c.stages <= 4 for c in cfg.values())
    f = {d: A.k5_config(torch.float32, d) for d in (40, 80, 96, 128, 160)}
    assert [(c.query_rows, c.key_tile) for c in f.values()] == [(128, 64), (128, 64), (128, 32),
                                                               (128, 32), (64, 32)]
    assert A.k5_config(torch.float32, 256).body == "f32_unfused"


def test_k5_widths_are_the_first_instantiated_width_at_or_above_d():
    assert [A.k5_config(torch.bfloat16, d).width for d in (8, 24, 40, 56, 72, 88, 120, 152, 248)] \
        == [16, 32, 40, 64, 80, 96, 128, 160, 256]
    assert [A.k5_config(torch.float32, d).width for d in (4, 20, 36, 44, 76, 84, 100, 132)] \
        == [16, 32, 40, 48, 80, 96, 128, 160]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_calls_take_the_plain_twin_and_count_no_launch(dtype):
    """attention_dmajor on CPU tensors is its plain twin, and neither its own
    count nor the Hopper bodies' count objects move."""
    from complex_prompt_diffusion_tpu_torch import ops

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 40, 136), generator=g).to(dtype) for _ in range(3))
    names = ("attention_cm", "attention_cm_sm90", "attention_cm_f32_sm90")
    before = [ops.KERNEL_WRAPPERS[n].launches for n in names]
    got = A.attention_dmajor(q, k, v, 0.1, out_hdbs=True)
    assert [ops.KERNEL_WRAPPERS[n].launches for n in names] == before
    assert ops.KERNEL_WRAPPERS["attention_cm_sm90"] is A.attention_cm_sm90_count
    assert ops.KERNEL_WRAPPERS["attention_cm_f32_sm90"] is A.attention_cm_f32_sm90_count
    assert torch.equal(got, A.attention_dmajor_plain(q, k, v, 0.1, False, True))
