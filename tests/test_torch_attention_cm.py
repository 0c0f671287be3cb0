"""Port parity: attention over channel-major operands (K5's plain twin),
the fused cm self-attention block, the kcanon route and the UNet's cm
option vs JAX.

On CPU tensors the port's K5 wrapper runs its plain PyTorch twin. It is held
against the JAX package's Pallas kernels in interpret mode, called as the
JAX tests call them: ``self_attention_cm(..., interpret=True)``
(``_onepass_kernel_hdbs``) and ``_onepass_attention_kcanon(...,
interpret=True)`` (``_onepass_kernel_kcanon``; called directly, since the
JAX module reads its ``CPD_ATTN_KCANON`` switch once at import). Inputs come
from one numpy seed; everything is f32 on the CPU.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu.pipeline import _unzero_kernels
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M

# ops/__init__ re-exports the function ``attention``: import the modules by name
JA = importlib.import_module("complex_prompt_diffusion_tpu.ops.attention")
A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")
U = importlib.import_module("complex_prompt_diffusion_tpu_torch.models.unet")

# the JAX test's own tolerance for the cm block (tests/test_ops.py)
CM_ATOL, CM_RTOL = 2e-4, 2e-3
# f32 on both sides; the Pallas kernels use exp2 and a ones-row denominator
RTOL, ATOL = 1e-4, 2e-5


def _cm_inputs(b, s, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, c)).astype(np.float32)
    ws = [rng.normal(size=(c, c)).astype(np.float32) * c**-0.5 for _ in range(4)]
    bo = rng.normal(size=(c,)).astype(np.float32) * 0.1
    return x, ws, bo


@pytest.mark.parametrize("b,s,c,h", [(2, 256, 128, 2), (1, 384, 128, 4)])
def test_self_attention_cm_matches_pallas_hdbs_kernel(b, s, c, h):
    x, ws, bo = _cm_inputs(b, s, c, seed=0)
    want = JA.self_attention_cm(jnp.asarray(x), *map(jnp.asarray, ws), jnp.asarray(bo), h,
                                interpret=True)
    tx, tws, tbo = torch.from_numpy(x), [torch.from_numpy(w) for w in ws], torch.from_numpy(bo)
    got = A.self_attention_cm(tx, *tws, tbo, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CM_ATOL, rtol=CM_RTOL)
    # the block equals the split-head route on the same projections
    d = c // h
    ref = A.attention_plain(tx @ tws[0], tx @ tws[1], tx @ tws[2], h, d**-0.5) @ tws[3] + tbo
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=CM_ATOL, rtol=CM_RTOL)
    torch.testing.assert_close(A.self_attention_cm_plain(tx, *tws, tbo, h), got, rtol=0, atol=0)


def test_self_attention_cm_scale_weight_cast_and_alignment():
    x, ws, bo = _cm_inputs(1, 128, 128, seed=1)
    tx, tbo = torch.from_numpy(x), torch.from_numpy(bo)
    tws = [torch.from_numpy(w) for w in ws]
    want = JA.self_attention_cm(jnp.asarray(x), *map(jnp.asarray, ws), jnp.asarray(bo), 2,
                                0.2, interpret=True)
    got = A.self_attention_cm(tx, *tws, tbo, 2, scale=0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=CM_ATOL, rtol=CM_RTOL)
    # weights in another dtype are cast to x's
    got64 = A.self_attention_cm(tx, *[w.double() for w in tws], tbo, 2, scale=0.2)
    assert got64.dtype == torch.float32
    torch.testing.assert_close(got64, got, rtol=0, atol=0)
    with pytest.raises(ValueError, match="128-aligned"):
        A.self_attention_cm(tx[:, :100], *tws, tbo, 2)


def _hd_split(t, heads):
    b, s, inner = t.shape
    return t.reshape(b, s, heads, inner // heads).transpose(0, 2, 1, 3).reshape(
        b * heads, s, inner // heads)


@pytest.mark.parametrize("sq,skv,d", [(256, 256, 40), (128, 200, 80), (256, 136, 64)])
def test_kcanon_route_matches_pallas_kcanon_kernel(sq, skv, d):
    """The port's kcanon route against the Pallas kernel on q_t [BH, D, Sq],
    canonical k [BH, Skv, D] and v_t with its ones-row, including KV lengths
    that are not a multiple of 128 (the JAX wrapper pads and masks them; K5
    masks the tail itself)."""
    heads, b = 2, 2
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (rng.standard_normal((b, s, heads * d)).astype(np.float32)
               for s in (sq, skv, skv))
    scale = d**-0.5
    q_t = _hd_split(q, heads).transpose(0, 2, 1)
    v_t = _hd_split(v, heads).transpose(0, 2, 1)
    v_t = np.concatenate([v_t, np.ones((b * heads, 1, skv), np.float32)], axis=1)
    out_t = JA._onepass_attention_kcanon(jnp.asarray(q_t), jnp.asarray(_hd_split(k, heads)),
                                         jnp.asarray(v_t), scale=scale, block_q=128,
                                         interpret=True)
    want = np.asarray(out_t).reshape(b, heads, d, sq).transpose(0, 3, 1, 2).reshape(
        b, sq, heads * d)
    got = A.attention_kcanon(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # and the port's K1 route on the same operands
    ref = A.flash_attention(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_kcanon_flag_switches_the_dispatch(monkeypatch):
    """``_USE_KCANON`` is read from CPD_ATTN_KCANON at import, as in the JAX
    module; set, attention() sends 128 < KV <= 16384 with d <= 256 through
    the kcanon route, and nothing else."""
    assert A._USE_KCANON == JA._USE_KCANON
    assert (A._ONEPASS_MAX_KV, A.SHORT_KV) == (JA._ONEPASS_MAX_KV, 128)
    calls = []
    real = A.attention_kcanon
    monkeypatch.setattr(A, "attention_kcanon",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    rng = np.random.default_rng(2)

    def qkv(skv, inner):
        return [torch.from_numpy(rng.standard_normal((1, s, inner)).astype(np.float32))
                for s in (64, skv, skv)]

    monkeypatch.setattr(A, "_USE_KCANON", False)
    off = A.attention(*qkv(200, 64), 2)
    assert not calls
    monkeypatch.setattr(A, "_USE_KCANON", True)
    A.attention(*qkv(200, 64), 2)
    assert len(calls) == 1
    A.attention(*qkv(77, 64), 2)  # short KV: the plain path
    A.attention(*qkv(200, 512), 1)  # d = 512 (the VAE mid-block): K1
    assert len(calls) == 1 and off.shape == (1, 64, 64)


def test_dmajor_wrapper_layouts_and_checks():
    """attention_dmajor on strided [B, H, D, S] views, both k forms and both
    output layouts, equals the plain twin on contiguous copies; CPU tensors
    count no launch."""
    rng = np.random.default_rng(3)
    b, h, d, s = 2, 2, 16, 136
    qkv = torch.from_numpy(rng.standard_normal((3, h, d, b, s)).astype(np.float32))
    q, k, v = (qkv[i].permute(2, 0, 1, 3) for i in range(3))
    before = A.attention_dmajor.launches
    got = A.attention_dmajor(q, k, v, 0.25, out_hdbs=True)
    want = A.attention_dmajor_plain(q.contiguous(), k.contiguous(), v.contiguous(), 0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.permute(1, 2, 0, 3).is_contiguous()  # a view of [H, D, B, S]
    k_n = k.transpose(-1, -2).contiguous()
    got_c = A.attention_dmajor(q, k_n, v, 0.25, k_canonical=True)
    assert got_c.is_contiguous()
    torch.testing.assert_close(got_c, want, rtol=1e-6, atol=1e-6)
    assert A.attention_dmajor.launches == before
    with pytest.raises(ValueError):
        A.attention_dmajor(q, k_n, v, 0.25)  # canonical k without the flag
    with pytest.raises(ValueError):
        A.attention_dmajor(q[0], k[0], v[0], 0.25)


def _cm_unet_cfg():
    # one level at C = 128, attention at every block: on a 16x16 latent the
    # self-attention sites have S = 256, inside the cm gate
    return dataclasses.replace(
        JM.UNetConfig.tiny(context_dim=32), dtype="float32", model_channels=128,
        channel_mult=(1,), attention_resolutions=(1,), num_heads=2,
    )


def test_unet_cm_option_matches_jax_unet(monkeypatch):
    """The UNet with ``attn_route="cm"`` against the JAX UNet on its default
    CPU path. The JAX UNet cannot itself take ``use_pallas="cm"`` on the CPU
    (its call passes no ``interpret``, so the Pallas kernel would not run in
    interpret mode): the block-level test above holds K5's function to the
    JAX kernel, and this one holds the gate and the wiring."""
    jcfg = _cm_unet_cfg()
    key = jax.random.PRNGKey(5)
    jp = _unzero_kernels(jax.random.fold_in(key, 1), JM.init_unet(key, jcfg, commit=False))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    want = jax.jit(lambda p, a, b, c: JM.unet_apply(jcfg, p, a, b, c))(jp, x, t, ctx)

    calls = []
    real = U.self_attention_cm
    monkeypatch.setattr(U, "self_attention_cm",
                        lambda *a, **kw: calls.append(tuple(a[0].shape)) or real(*a, **kw))
    cfg = convert.config_from(M.UNetConfig, jcfg, attn_route="cm")
    params = convert.unet_params(jp)
    args = tuple(map(torch.from_numpy, (x, t, ctx)))
    got = M.unet_apply(cfg, params, *args)
    # input block, middle block and two output blocks, all at S = 256, C = 128
    assert calls == [(2, 256, 128)] * 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-4, atol=1e-4)
    base = M.unet_apply(dataclasses.replace(cfg, attn_route="bsc"), params, *args)
    assert len(calls) == 4
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-4, atol=1e-4)


def test_unet_cm_gate_rejects_narrow_and_short_sites(monkeypatch):
    """The JAX gate as it is: S > 128, S % 128 == 0 and C % 128 == 0. The
    tiny config (C = 32, 64) and a short sequence stay on the split route."""
    calls = []
    monkeypatch.setattr(U, "self_attention_cm", lambda *a, **kw: calls.append(1))
    jcfg = dataclasses.replace(JM.UNetConfig.tiny(context_dim=32), dtype="float32")
    cfg = convert.config_from(M.UNetConfig, jcfg, attn_route="cm")
    gen = torch.Generator().manual_seed(0)
    params = convert.unet_params(M.init_unet(gen, cfg))
    x = torch.randn((1, 16, 16, 4), generator=gen)
    M.unet_apply(cfg, params, x, torch.tensor([5]), torch.randn((1, 77, 32), generator=gen))
    assert not calls
    # C = 128 but S = 64 (8x8 latent) and S = 128 are outside the gate too
    wide = convert.config_from(M.UNetConfig, _cm_unet_cfg(), attn_route="cm")
    wparams = convert.unet_params(M.init_unet(gen, wide))
    for hw in ((8, 8), (8, 16)):
        xs = torch.randn((1,) + hw + (4,), generator=gen)
        M.unet_apply(wide, wparams, xs, torch.tensor([5]),
                     torch.randn((1, 77, 32), generator=gen))
    assert not calls
    with pytest.raises(ValueError):
        M.UNetConfig(attn_route="nope")
    assert M.UNetConfig.sd15().attn_route == "bsc"
