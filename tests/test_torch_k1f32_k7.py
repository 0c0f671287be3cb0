"""K1's fused f32 body and the probe K7 on the Hopper loops, on the CPU:
which body K1 routes each f32 head dim to, the Python mirror of the fused
block (``ops.attention.k1_f32_config``, held to the C entry by a card test),
the combinations K7 and its replaced loops take, and the SASS check that
holds each K7 mode to the wgmma of the steps it keeps (on synthetic counts:
``cuobjdump`` runs only on the card). The fused body's plain twin is held to
the JAX package's one-pass Pallas kernel in interpret mode.
"""

import importlib

import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.ops.attention import attention as jax_attention

A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")
PA = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.probes.attention")
T = importlib.import_module("complex_prompt_diffusion_tpu_torch.tools.probe_attention")

SMEM_MAX = 232448  # the H100's shared memory a block may use


def test_k1_routes_every_f32_head_dim():
    """d % 4 == 0: up to 160 the fused body, above it up to 512 the unfused
    3xTF32 kernels; anything else raises."""
    bodies = {d: A.k1_body(torch.float32, d) for d in range(4, 513, 4)}
    assert [d for d, b in bodies.items() if b == "f32_fused"] == list(range(4, 161, 4))
    assert [d for d, b in bodies.items() if b == "f32_sm90"] == list(range(164, 513, 4))
    for d in (0, 2, 42, 516, 1024):
        with pytest.raises(ValueError):
            A.k1_body(torch.float32, d)
    # the bf16 routes stay as they were
    assert [A.k1_body(torch.bfloat16, d) for d in (40, 80, 160, 256, 320, 512)] == \
        ["sm90"] * 4 + ["bf16_wide"] * 2


def test_fused_f32_block_fits_and_is_k5s():
    """At every head dim the fused body takes, the block fits 227 KB and is
    CfgF's: 128 query rows and 64-key tiles up to width 80, 128 x 32 keys up
    to 128, 64 x 32 up to 160, the same block K5's f32 body runs."""
    for d in range(4, 161, 4):
        c = A.k1_f32_config(d)
        assert c.body == "f32_fused" and c.width >= d and c.stages == 1
        assert c.smem_bytes <= SMEM_MAX, (d, c)
        want = (128, 64) if c.width <= 80 else (128, 32) if c.width <= 128 else (64, 32)
        assert (c.query_rows, c.key_tile) == want, (d, c)
        assert c[1:] == A.k5_config(torch.float32, d)[1:]
    for d in (164, 256, 6):
        with pytest.raises(ValueError):
            A.k1_f32_config(d)


@pytest.mark.parametrize("d", [40, 64, 160])
def test_fused_f32_wrapper_on_cpu_is_the_plain_twin_and_matches_jax(d):
    """CPU tensors run the plain twin and count no launch; it agrees with the
    JAX one-pass Pallas kernel (interpret mode) in f32."""
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((1, 256, 2 * d)).astype(np.float32) for _ in range(3))
    before = A.attention_f32_fused_sm90.launches
    got = A.attention_f32_fused_sm90(*map(torch.from_numpy, (q, k, v)), 2)
    assert A.attention_f32_fused_sm90.launches == before
    want = np.asarray(jax_attention(q, k, v, 2, use_pallas=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-5)


def test_fused_f32_wrapper_refuses_other_head_dims_and_dtypes():
    x = torch.zeros((1, 8, 2 * 168))
    with pytest.raises(ValueError):
        A.attention_f32_fused_sm90(x, x, x, 2)  # d = 168: the unfused body's
    with pytest.raises(ValueError):
        A.attention_f32_fused_sm90(*(x[..., :160].bfloat16(),) * 3, 2)
    with pytest.raises(ValueError):  # d = 160 now belongs to the fused body
        A.attention_f32_sm90(*(x[..., :320],) * 3, 2)


def test_k1_key_tile_mirrors_the_loop():
    assert [A.k1_bf16_key_tile(d) for d in (8, 40, 64, 80, 128, 152, 160, 256)] == \
        [128] * 5 + [64] * 3


# (mode, denom, exp, unnormalized, kv_tile, d, dtype) K7 takes
_ACCEPT = [
    ("full", "sum", "exp2", False, None, 40, torch.bfloat16),
    ("full", "sum", "exp2", False, 128, 80, torch.bfloat16),
    ("full", "sum", "exp2", False, 64, 40, torch.bfloat16),  # the other width, d <= 128
    ("full", "sum", "exp2", False, 64, 160, torch.bfloat16),  # K1's own at d = 160
    ("full", "ones", "exp2", True, None, 160, torch.bfloat16),
    ("full", "ones", "exp", False, 128, 40, torch.bfloat16),
    ("full", "sum", "exp", False, None, 80, torch.bfloat16),
    ("scores", "sum", "exp2", False, None, 160, torch.bfloat16),
    ("pv", "sum", "exp2", False, 128, 80, torch.bfloat16),
    ("loads", "sum", "exp2", False, None, 40, torch.bfloat16),
    ("scores", "sum", "exp2", False, None, 40, torch.float32),
    ("scores", "sum", "exp2", False, None, 160, torch.float32),
]
# and what it refuses
_REFUSE = [
    ("full", "sum", "exp2", False, 128, 160, torch.bfloat16),  # 128-key ring does not fit
    ("scores", "sum", "exp2", False, 64, 40, torch.bfloat16),  # ablated: K1's tile only
    ("rowsum", "sum", "exp2", False, 128, 160, torch.bfloat16),
    ("full", "ones", "exp2", False, 64, 80, torch.bfloat16),  # flags: K1's tile only
    ("full", "sum", "exp", False, 64, 40, torch.bfloat16),
    ("full", "sum", "exp2", True, None, 40, torch.bfloat16),  # unnormalized needs ones
    ("full", "ones", "exp", True, None, 40, torch.bfloat16),  # ... with exp2
    ("exp", "ones", "exp2", False, None, 40, torch.bfloat16),
    ("full", "sum", "exp2", False, 32, 40, torch.bfloat16),
    ("full", "sum", "exp2", False, None, 48, torch.bfloat16),  # not a UNet level
    ("full", "sum", "exp2", False, None, 64, torch.bfloat16),
    ("full", "sum", "exp2", False, None, 40, torch.float32),  # f32: scores only
    ("scores", "sum", "exp2", False, None, 44, torch.float32),  # f32: the UNet levels
    ("scores", "sum", "exp2", False, 64, 40, torch.float32),
    ("softmax", "sum", "exp2", False, None, 40, torch.bfloat16),
]


@pytest.mark.parametrize("combo", _ACCEPT, ids=lambda c: "-".join(map(str, c[:6])))
def test_k7_check_accepts(combo):
    tile = PA._check_combo(*combo)
    assert tile == (combo[4] or A.k1_bf16_key_tile(combo[5]))


@pytest.mark.parametrize("combo", _REFUSE, ids=lambda c: "-".join(map(str, c[:6])))
def test_k7_check_refuses(combo):
    with pytest.raises(ValueError):
        PA._check_combo(*combo)


def test_k7_replaced_loops_keep_their_rules():
    """The replaced loops take what they were built for: ablated modes at
    64 keys, d padded to 48 / 80 / 160, f32 scores up to d = 512."""
    PA._check_combo_prior("scores", "sum", "exp2", False, 64, 48, torch.bfloat16)
    PA._check_combo_prior("full", "sum", "exp2", False, 128, 160, torch.bfloat16)
    PA._check_combo_prior("scores", "sum", "exp2", False, 64, 512, torch.float32)
    for combo in (("scores", "sum", "exp2", False, 128, 40, torch.bfloat16),
                  ("full", "ones", "exp2", False, 64, 48, torch.bfloat16),
                  ("full", "sum", "exp2", False, 64, 64, torch.bfloat16)):
        with pytest.raises(ValueError):
            PA._check_combo_prior(*combo)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2 * 48)).astype(np.float32))
               .bfloat16() for _ in range(3))
    before = PA.attention_probe_prior.launches
    got = PA.attention_probe_prior(q, k, v, 2, 0.2, "max")  # d = 48: the replaced loop's
    assert PA.attention_probe_prior.launches == before
    torch.testing.assert_close(got, PA._plain(q, k, v, 2, 0.2, "max", "sum", "exp2", False))


def _sass(drop=None, missing=None):
    """Synthetic per-kernel SASS counts of a library whose K7 instantiations
    hold exactly the products of their steps (the replaced loops' HMMA too);
    ``drop``: an instantiation that lost one wgmma, ``missing``: one absent."""
    counts = {}

    def put(name, **ops):
        counts[name] = {op: ops.get(op, 0) for op in T.SASS_OPS}

    for key in T._k7_sm90_instances():
        dv, bkv, mode, denom, exp2, unnorm = key
        name = (f"_ZN12_GLOBAL__N_16k1sm9021attention_sm90_kernelILi{dv}ELi{bkv}ELi{mode}"
                f"ELi{denom}ELb{exp2}ELb{unnorm}EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16iiiif")
        if key == missing:
            continue
        put(name, HGMMA=T.sm90_hgmma(dv, bkv, mode) - (key == drop), UTMALDG=3)
    for dv in (40, 80, 160):
        bkv = A.k1_bf16_key_tile(dv)
        for canon in (0, 1):
            for mode in (0, 1):
                put(f"_ZN12_GLOBAL__N_16k5sm9024attention_cm_sm90_kernelILi{dv}ELb{canon}"
                    f"ELi{mode}EEEv14CUtensorMap_st", HGMMA=T.sm90_hgmma(dv, bkv, mode),
                    UTMALDG=4)
        for mode in (0, 1):
            put(f"_ZN12_GLOBAL__N_15f32x322attention_f32x3_kernelILi{dv}ELi2ELi{mode}EEEv",
                HGMMA=T.f32x3_hgmma(dv, mode), UTMALDG=3)
    for dp in (48, 80, 160):
        for mode in range(7):
            want = {0: dp, 4: dp // 2, 6: 0}.get(mode, dp // 2)
            put(f"_ZN12_GLOBAL__N_121attention_bf16_kernelILi{dp}ELi{dp}ELi64ELi{mode}ELi0ELb1"
                f"ELb0EEEvPK13__nv_bfloat16", HMMA=want)
        for canon in (0, 1):
            for mode, want in ((0, dp), (1, dp // 2)):
                put(f"_ZN12_GLOBAL__N_12cm24attention_cm_bf16_kernelILi{dp}ELb{canon}"
                    f"ELi{mode}EEEvPK13__nv_bfloat16", HMMA=want)
    for mode in (0, 1):
        put(f"_ZN12_GLOBAL__N_120attention_f32_kernelILi{mode}EEEvPKf", FFMA=100 + mode)
    return counts


@pytest.mark.parametrize("drop,missing,ok", [
    (None, None, True),
    ((40, 128, 1, 0, 1, 0), None, False),  # the scores mode lost a Q K^T wgmma
    ((80, 128, 4, 0, 1, 0), None, False),  # the pv mode lost a P V wgmma
    ((160, 64, 0, 1, 1, 1), None, False),  # h2's full mode lost one
    (None, (40, 64, 0, 0, 1, 0), False),  # the 64-key full mode is not in the library
], ids=["whole", "scores-lost-qk", "pv-lost-pv", "h2-lost-one", "missing"])
def test_k7_sass_check_holds_each_mode_to_its_steps(drop, missing, ok):
    lines, got = T.check_sass(_sass(drop, missing))
    assert got is ok
    assert any("loads: 0 HGMMA" in ln for ln in lines)


def test_k7_sass_counts_follow_the_loop_structure():
    """Q K^T in three places and P V in two (K1's and K5's loops), three
    TF32 products a k-step in the fused body; loads keeps none."""
    m = PA.MODES
    assert T.sm90_hgmma(40, 128, m["full"]) == 3 * 3 + 2 * 8 == 25
    assert T.sm90_hgmma(160, 64, m["scores"]) == 3 * 10
    assert T.sm90_hgmma(80, 128, m["pv"]) == 2 * 8
    assert T.sm90_hgmma(80, 128, m["loads"]) == 0
    assert T.f32x3_hgmma(40, m["full"]) == 15 + 24 and T.f32x3_hgmma(160, m["scores"]) == 60
