"""Port parity of token reduction (``ops/tome.py``): ToMe's merge plan,
merge and unmerge, ToDo's K/V pooling, their exactness on locally
constant tokens, the UNet's three branches, and renders with ToDo and
ToMe (with ``tome_mlp`` / ``tome_crossattn``) through the pipeline.

f32 on the CPU; metrics, tokens and x_T from numpy seeds. The tiny
bundle's level-0 sites have S = 16 (a 32x32 canvas) or 64 (64x64), so
``tome_min_seq`` is lowered for the UNet to take the branches.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.ops import tome as JT
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.ops import tome as T

OP_TOL = 1e-6  # one op on both sides
# a single UNet call, as tests/test_torch_unet_aux.py holds one (the three
# branches differ from JAX's by at most 8.2e-7, on a CPU in f32)
CALL_TOL = 1e-6
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4  # a render (as tests/test_torch_sampler_slice.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(b, s, c, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, c)).astype(np.float32)


def _const_windows(b, h, w, c, seed):
    """Tokens constant over each 2x2 window, [B, h*w, C]."""
    base = np.random.default_rng(seed).standard_normal((b, h // 2, w // 2, c))
    return np.repeat(np.repeat(base, 2, axis=1), 2, axis=2).reshape(b, h * w, c).astype(
        np.float32)


@pytest.mark.parametrize("b,h,w,c,r,sx,sy", [
    (2, 8, 8, 16, 24, 2, 2), (1, 8, 8, 8, 48, 2, 2), (3, 8, 6, 8, 17, 2, 2),
    (2, 6, 8, 12, 10, 2, 1), (1, 16, 16, 8, 100, 2, 2),
])
def test_build_merge_index_maps_equal_jax(b, h, w, c, r, sx, sy):
    """f32 metrics from numpy (no ties): every index map of the plan equal
    to the JAX package's, the one-hot assignment too."""
    x = _rand(b, h * w, c, seed=h * w + r)
    jp = JT.build_merge(jnp.asarray(x), h, w, r, sx, sy)
    pp = T.build_merge(torch.from_numpy(x), h, w, r, sx, sy)
    for name in ("dst_pos", "src_pos", "idx_src", "kept_order", "inv_perm"):
        np.testing.assert_array_equal(getattr(pp, name).numpy(), np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(pp.assign.numpy(), np.asarray(jp.assign))
    assert pp.r == jp.r == r


def test_merge_unmerge_and_downsample_match_jax():
    b, h, w, c, r = 2, 8, 8, 16, 30
    x = _rand(b, h * w, c, seed=3)
    y = _rand(b, h * w - r, c, seed=4)
    jp = JT.build_merge(jnp.asarray(x), h, w, r)
    pp = T.build_merge(torch.from_numpy(x), h, w, r)
    np.testing.assert_allclose(T.tome_merge(pp, torch.from_numpy(x)).numpy(),
                               np.asarray(JT.tome_merge(jp, jnp.asarray(x))),
                               rtol=OP_TOL, atol=OP_TOL)
    np.testing.assert_array_equal(T.tome_unmerge(pp, torch.from_numpy(y)).numpy(),
                                  np.asarray(JT.tome_unmerge(jp, jnp.asarray(y))))
    for hh, ww, sx, sy in ((8, 8, 2, 2), (8, 6, 2, 2), (4, 16, 4, 1)):
        xd = _rand(2, hh * ww, c, seed=hh + ww)
        np.testing.assert_allclose(
            T.downsample_kv(torch.from_numpy(xd), hh, ww, sx, sy).numpy(),
            np.asarray(JT.downsample_kv(jnp.asarray(xd), hh, ww, sx, sy)),
            rtol=OP_TOL, atol=OP_TOL)


def test_merged_count_and_bf16_dtype():
    """r src tokens merge, exactly; a bf16 input keeps its dtype."""
    x = torch.from_numpy(_rand(3, 64, 8, seed=2)).to(torch.bfloat16)
    plan = T.build_merge(x, 8, 8, 17)
    assert ((plan.idx_src < 16).sum(dim=1) == 17).all()
    assert T.tome_merge(plan, x).dtype == torch.bfloat16
    assert T.downsample_kv(x, 8, 8).dtype == torch.bfloat16


def _attn(q, kv):
    c = q.shape[-1]
    p = torch.softmax(q @ kv.transpose(1, 2) * c ** -0.5, dim=-1)
    return p @ kv


@pytest.mark.parametrize("mode", ["merge", "downsample"])
def test_locally_constant_attention_exact(mode):
    """Tokens constant over 2x2 windows: a full merge (r = n_src), or the
    pooled K/V, leaves softmax attention as it was (duplicated keys
    renormalize away)."""
    x = torch.from_numpy(_const_windows(2, 8, 8, 16, seed=6)).double()
    full = _attn(x, x)
    if mode == "merge":
        plan = T.build_merge(x, 8, 8, 48)
        merged = T.tome_merge(plan, x)
        approx = T.tome_unmerge(plan, _attn(merged, merged))
    else:
        approx = _attn(x, T.downsample_kv(x, 8, 8))
    torch.testing.assert_close(approx, full, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(r=0), "outside"), (dict(r=49), "outside"), (dict(h=7), "h\\*w"),
])
def test_build_merge_value_errors_match_jax(kw, match):
    a = dict(h=8, w=8, r=10)
    a.update(kw)
    x = _rand(1, 64, 8)
    with pytest.raises(ValueError, match=match):
        JT.build_merge(jnp.asarray(x), a["h"], a["w"], a["r"])
    with pytest.raises(ValueError, match=match):
        T.build_merge(torch.from_numpy(x), a["h"], a["w"], a["r"])


@pytest.mark.parametrize("s,h,w,sx,sy", [(63, 8, 8, 2, 2), (56, 8, 7, 2, 2)])
def test_downsample_value_errors_match_jax(s, h, w, sx, sy):
    x = _rand(1, s, 8)
    with pytest.raises(ValueError):
        JT.downsample_kv(jnp.asarray(x), h, w, sx, sy)
    with pytest.raises(ValueError):
        T.downsample_kv(torch.from_numpy(x), h, w, sx, sy)


UNET_MODES = [
    dict(tome_mode="downsample"),
    dict(tome_mode="merge", tome_ratio=0.5),
    dict(tome_mode="merge", tome_ratio=0.3, tome_mlp=True, tome_crossattn=True),
]


@pytest.fixture(scope="module")
def tiny():
    return JP.ModelBundle.random("tiny", seed=0)


@pytest.mark.parametrize("kw", UNET_MODES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_unet_branches_match_jax(tiny, kw):
    """One UNet call with token reduction at the 16x16 latent's level 0 (S
    = 256 >= tome_min_seq), held to the JAX package's; the reduction moves
    the output."""
    kw = dict(dict(tome_ratio=0.75, tome_min_seq=256), **kw)
    jcfg = dataclasses.replace(tiny.unet_cfg, **kw)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 600], np.int32)
    ctx = rng.standard_normal((2, 77, jcfg.context_dim)).astype(np.float32)
    want = JM.unet_apply(jcfg, tiny.unet_params, x, t, ctx)
    pcfg = convert.config_from(M.UNetConfig, jcfg)
    pp = convert.unet_params(tiny.unet_params)
    args = tuple(map(torch.from_numpy, (x, t, ctx)))
    got = M.unet_apply(pcfg, pp, *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CALL_TOL, atol=CALL_TOL)
    exact = M.unet_apply(dataclasses.replace(pcfg, tome_ratio=0.0), pp, *args)
    assert not torch.equal(got, exact)


def test_unet_unknown_tome_mode_raises(tiny):
    pcfg = dataclasses.replace(convert.config_from(M.UNetConfig, tiny.unet_cfg),
                               tome_ratio=0.5, tome_min_seq=16, tome_mode="x")
    with pytest.raises(ValueError, match="tome_mode"):
        M.unet_apply(pcfg, convert.unet_params(tiny.unet_params), torch.zeros((1, 8, 8, 4)),
                     torch.tensor([1]), torch.zeros((1, 77, 64)))


RENDERS = [
    ("DDIM", dict(tome_ratio=0.5, tome_mode="downsample"), {}),
    ("DDIM", dict(tome_ratio=0.5, tome_mode="merge"), {}),
    ("DDIM", dict(tome_ratio=0.3, tome_mode="merge"), dict(tome_mlp=True, tome_crossattn=True)),
    ("Euler Ancestral", dict(tome_ratio=0.75, tome_mode="downsample"), {}),
    ("PLMS", dict(tome_ratio=0.5, tome_mode="merge"), dict(tome_mlp=True)),
]


@pytest.mark.parametrize("sampler,render,unet", RENDERS,
                         ids=[f"{s}-{r['tome_mode']}-{i}" for i, (s, r, _) in enumerate(RENDERS)])
def test_txt2img_with_token_reduction_matches_jax(tiny, sampler, render, unet):
    """txt2img at 32x32 batch 2 through CLIP, the UNet and the VAE: the
    RenderConfig's tome_ratio / tome_mode switch the bundle's UNet config
    (tome_min_seq 16, the plan flags on the bundle) in both packages."""
    jb = dataclasses.replace(tiny, unet_cfg=dataclasses.replace(
        tiny.unet_cfg, tome_min_seq=16, **unet))
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    kw = dict(width=32, height=32, batch_size=2, steps=4, sampler=sampler, **render)
    rng = np.random.default_rng(4)
    x_T = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    noises = rng.standard_normal((4, 2, 4, 4, 4)).astype(np.float32)
    _, want = JP.txt2img(jb, "a red cube", "blurry", cfg=JP.RenderConfig(**kw),
                         x_T=jnp.asarray(x_T), noises=jnp.asarray(noises))
    _, got = P.txt2img(pb, "a red cube", "blurry", cfg=P.RenderConfig(**kw),
                       x_T=torch.from_numpy(x_T), noises=torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)


@pytest.mark.parametrize("kw,level0", [
    (dict(tome_ratio=0.75), (4096, 1024, 4096)),
    (dict(tome_ratio=0.75, tome_mode="merge"), (1024, 1024, 4096)),
    (dict(tome_ratio=0.3, tome_mode="merge", tome_mlp=True), (2868, 2868, 2868)),
    (dict(tome_ratio=0.75, tome_mode="merge", tome_min_seq=4097), (4096, 4096, 4096)),
])
def test_token_reduction_kernel_sites(kw, level0):
    """``tools/kernel_cases.unet_sites`` reads the config's token reduction
    as ``unet_apply`` applies it: at SD-1.5's 64x64 latent the five level-0
    sites take (Sq, Skv) and the FF's rows from it; the other levels keep
    theirs."""
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import unet_sites

    cfg = dataclasses.replace(M.UNetConfig.sd15(), **kw)
    sites = unet_sites(cfg, 64)
    sq, skv, rows = level0
    lvl0 = [i for i, (side, *_) in enumerate(sites["attn"]) if side == 64]
    assert len(lvl0) == 5
    for i, (site, ff) in enumerate(zip(sites["self_attn"], sites["ff_rows"])):
        s = sites["attn"][i][0] ** 2
        assert site[:2] == ((sq, skv) if i in lvl0 else (s, s))
        assert ff[0] == (rows if i in lvl0 else s)
