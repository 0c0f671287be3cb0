"""Port parity of the UNet's aux interfaces: skips, decoder features,
cross-attention maps (and the DAAM heat maps built from them), the
DeepCache deep feature and shallow pass, and their ValueErrors.

The tiny JAX bundle's UNet (f32) reaches the port through ``convert.py``;
inputs come from numpy seeds. On the CPU the port's kernel wrappers run
their plain twins.
"""

import dataclasses

import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu.guidance import daam as JD
from complex_prompt_diffusion_tpu.models import unet as JU
from complex_prompt_diffusion_tpu.pipeline import ModelBundle as JaxBundle
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.guidance import daam as D
from complex_prompt_diffusion_tpu_torch.models import unet as U

# one f32 call on both sides: the output and the attention maps agree to
# 1e-6; the hidden states (skips, decoder features, the deep feature) carry
# up to 2.6e-6 of reassociation (measured)
CALL_TOL = 1e-6
DEEP_TOL = 3e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unet():
    jb = JaxBundle.random("tiny", seed=0)
    jcfg, jp = jb.unet_cfg, jb.unet_params
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([5, 700], np.int32)
    ctx = rng.standard_normal((2, 77, jcfg.context_dim)).astype(np.float32)
    port = (convert.config_from(M.UNetConfig, jcfg), convert.unet_params(jp))
    return (jcfg, jp), port, (x, t, ctx)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


EXTRAS = [
    dict(return_skips=True),
    dict(return_feats=True),
    dict(collect_attn_maps=True),
    dict(return_deep_at=2),
    dict(return_skips=True, return_feats=True, collect_attn_maps=True, return_deep_at=0),
]


@pytest.mark.parametrize("kw", EXTRAS, ids=lambda kw: "+".join(kw))
def test_extras_match_jax(unet, kw):
    """Every extra in the JAX order (skips, feats, maps, deep), each held
    to the JAX package's."""
    (jcfg, jp), (pcfg, pp), (x, t, ctx) = unet
    want = JM.unet_apply(jcfg, jp, x, t, ctx, **kw)
    got = M.unet_apply(pcfg, pp, *_torch(x, t, ctx), **kw)
    assert len(got) == len(want) == 1 + len(kw)
    _close(got[0], want[0], CALL_TOL)
    names = [n for n in ("return_skips", "return_feats", "collect_attn_maps", "return_deep_at")
             if n in kw]
    for name, g, w in zip(names, got[1:], want[1:]):
        if name == "return_deep_at":
            _close(g, w, DEEP_TOL)
            continue
        assert len(g) == len(w)
        for gi, wi in zip(g, w):
            assert tuple(gi.shape) == tuple(np.shape(wi))
            _close(gi, wi, CALL_TOL if name == "collect_attn_maps" else DEEP_TOL)


def test_attn_maps_are_probabilities(unet):
    """f32 [B, heads, HW, 77] probabilities at each cross-attention site,
    rows summing to 1; the output equals the plain call's."""
    _, (pcfg, pp), (x, t, ctx) = unet
    out, maps = M.unet_apply(pcfg, pp, *_torch(x, t, ctx), collect_attn_maps=True)
    plain = M.unet_apply(pcfg, pp, *_torch(x, t, ctx))
    assert len(maps) == 7
    for m in maps:
        assert m.dtype == torch.float32 and m.shape[:2] == (2, 2) and m.shape[3] == 77
        torch.testing.assert_close(m.sum(-1), torch.ones(m.shape[:3]), rtol=0, atol=1e-5)
    torch.testing.assert_close(out, plain, rtol=1e-6, atol=1e-6)


def test_injection_identity(unet):
    """Re-injecting a call's own skips, and its own hidden states (the
    deep feature at block 0, then each block's output), reproduces the
    output bit for bit in the port, as in the JAX package."""
    _, (pcfg, pp), (x, t, ctx) = unet
    args = _torch(x, t, ctx)
    out, skips, feats, deep0 = M.unet_apply(pcfg, pp, *args, return_skips=True,
                                            return_feats=True, return_deep_at=0)
    again = M.unet_apply(pcfg, pp, *args, inject_skips=skips, inject_skips_stop=99,
                         inject_feats=(deep0,) + feats[:-1], inject_feats_stop=99)
    assert torch.equal(again, out)


def test_injection_matches_jax(unet):
    """Foreign skips and features injected up to the stops: the same output
    as the JAX package's."""
    (jcfg, jp), (pcfg, pp), (x, t, ctx) = unet
    _, jskips, jfeats = JM.unet_apply(jcfg, jp, x, t, ctx, return_skips=True,
                                      return_feats=True)
    rng = np.random.default_rng(11)
    skips = [rng.standard_normal(np.shape(s)).astype(np.float32) for s in jskips]
    feats = [rng.standard_normal(np.shape(f)).astype(np.float32) for f in jfeats]
    # block i's injected feature enters it: the shape of block i - 1's output
    inj = [np.zeros((2, 8, 8, 64), np.float32)] + feats[:-1]
    want = JM.unet_apply(jcfg, jp, x, t, ctx, inject_skips=skips, inject_skips_stop=3,
                         inject_feats=inj, inject_feats_stop=2)
    got = M.unet_apply(pcfg, pp, *_torch(x, t, ctx),
                       inject_skips=[torch.from_numpy(s) for s in skips], inject_skips_stop=3,
                       inject_feats=[torch.from_numpy(f) for f in inj], inject_feats_stop=2)
    _close(got, want, DEEP_TOL)


@pytest.mark.parametrize("j0", [0, 1, 2, 3])
@pytest.mark.parametrize("hoisted", [False, True])
def test_shallow_bitexact_vs_full(unet, j0, hoisted):
    """The shallow pass fed the same call's deep feature is the full pass,
    bit for bit, at every split, with and without the hoisted cross k/v
    (the full tuple: the shallow pass picks its sites)."""
    _, (pcfg, pp), (x, t, ctx) = unet
    args = _torch(x, t, ctx)
    kv = M.precompute_cross_kv(pcfg, pp, args[2]) if hoisted else None
    out_full, deep = M.unet_apply(pcfg, pp, *args, cross_kv=kv, return_deep_at=j0)
    out_shallow = M.unet_apply(pcfg, pp, *args, cross_kv=kv, deep_feature=deep, deep_at=j0)
    assert torch.equal(out_shallow, out_full)
    assert torch.equal(out_full, M.unet_apply(pcfg, pp, *args))


@pytest.mark.parametrize("j0", [0, 2])
def test_shallow_matches_jax(unet, j0):
    """A shallow pass on a foreign deep feature equals the JAX package's."""
    (jcfg, jp), (pcfg, pp), (x, t, ctx) = unet
    _, jdeep = JM.unet_apply(jcfg, jp, x, t, ctx, return_deep_at=j0)
    deep = np.random.default_rng(j0).standard_normal(np.shape(jdeep)).astype(np.float32)
    want = JM.unet_apply(jcfg, jp, x, t, ctx, deep_feature=deep, deep_at=j0)
    got = M.unet_apply(pcfg, pp, *_torch(x, t, ctx), deep_feature=torch.from_numpy(deep),
                       deep_at=j0)
    _close(got, want, CALL_TOL)


def test_kv_counts_and_shallow_subset(unet):
    """The cross k/v bookkeeping is the JAX package's."""
    (jcfg, _), (pcfg, _), _ = unet
    assert U._kv_counts(pcfg) == JU._kv_counts(jcfg)
    full = tuple(range(sum(U._kv_counts(pcfg)[0]) + U._kv_counts(pcfg)[1]
                       + sum(U._kv_counts(pcfg)[2])))
    for j0 in range(4):
        assert U._shallow_cross_kv(pcfg, full, j0) == JU._shallow_cross_kv(jcfg, full, j0)
    for cfg, jc in ((M.UNetConfig.sd15(), JM.UNetConfig.sd15()), (pcfg, jcfg)):
        assert U.deepcache_default_block(cfg) == JU.deepcache_default_block(jc)
    assert U.deepcache_default_block(M.UNetConfig.sd15()) == 9


@pytest.mark.parametrize("kw,match", [
    (dict(deep_feature=True), "requires deep_at"),
    (dict(deep_feature=True, deep_at=4), "out of range"),
    (dict(deep_feature=True, deep_at=-1), "out of range"),
    (dict(deep_feature=True, deep_at=1, return_skips=True), "incompatible"),
    (dict(deep_feature=True, deep_at=1, return_feats=True), "incompatible"),
    (dict(deep_feature=True, deep_at=1, collect_attn_maps=True), "incompatible"),
    (dict(deep_feature=True, deep_at=1, return_deep_at=1), "incompatible"),
    (dict(deep_feature=True, deep_at=1, inject_skips=()), "incompatible"),
    (dict(return_deep_at=99), "out of range"),
])
def test_unet_value_errors_match_jax(unet, kw, match):
    (jcfg, jp), (pcfg, pp), (x, t, ctx) = unet
    kw = dict(kw)
    deep = np.zeros((2, 8, 8, 64), np.float32)
    jkw = {k: (deep if k == "deep_feature" else v) for k, v in kw.items()}
    pkw = {k: (torch.from_numpy(deep) if k == "deep_feature" else v) for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        JM.unet_apply(jcfg, jp, x, t, ctx, **jkw)
    with pytest.raises(ValueError, match=match):
        M.unet_apply(pcfg, pp, *_torch(x, t, ctx), **pkw)


def test_make_deepcache_unets_matches_jax(unet):
    """The pair as the JAX package builds it: the full pass with its deep
    feature, the shallow pass; the chunked pair (batch 1 a call) computes
    the wide one's outputs (to 3e-6: the CPU's conv and matmul blocking
    depends on the batch); an out-of-range split raises ValueError in
    both."""
    (jcfg, jp), (pcfg, pp), (x, t, ctx) = unet
    jfull, jshallow = JU.make_deepcache_unets(jcfg, jp, None)
    pfull, pshallow = U.make_deepcache_unets(pcfg, pp, None)
    args = _torch(x, t, ctx)
    (w_out, w_deep), (g_out, g_deep) = jfull(x, t, ctx), pfull(*args)
    _close(g_out, w_out, CALL_TOL)
    _close(g_deep, w_deep, DEEP_TOL)
    _close(pshallow(*args, g_deep), jshallow(x, t, ctx, np.asarray(g_deep.numpy())), CALL_TOL)
    kv = M.precompute_cross_kv(pcfg, pp, args[2])
    cfull, cshallow = U.make_deepcache_unets(pcfg, pp, 2, cross_kv=kv, batch_chunk=1)
    wfull, wshallow = U.make_deepcache_unets(pcfg, pp, 2, cross_kv=kv)
    (c_out, c_deep), (w2_out, w2_deep) = cfull(*args), wfull(*args)
    for a, b in ((c_out, w2_out), (c_deep, w2_deep),
                 (cshallow(*args, c_deep), wshallow(*args, w2_deep))):
        torch.testing.assert_close(a, b, rtol=DEEP_TOL, atol=DEEP_TOL)
    for block in (4, -1):
        with pytest.raises(ValueError, match="out of range"):
            JU.make_deepcache_unets(jcfg, jp, block)
        with pytest.raises(ValueError, match="out of range"):
            U.make_deepcache_unets(pcfg, pp, block)


@pytest.mark.parametrize("out_size,method", [(16, "bicubic"), (8, "bilinear")])
def test_daam_heat_maps_match_jax(unet, out_size, method):
    """DAAM: the aggregated per-token maps and a word's normalized map from
    the port's attention maps, against the JAX functions on the same maps."""
    _, (pcfg, pp), (x, t, ctx) = unet
    _, maps = M.unet_apply(pcfg, pp, *_torch(x, t, ctx), collect_attn_maps=True)
    jmaps = [m.numpy() for m in maps]
    want = JD.aggregate_heat_maps(jmaps, out_size, method, batch_idx=1)
    got = D.aggregate_heat_maps(maps, out_size, method, batch_idx=1)
    assert tuple(got.shape) == (77, out_size, out_size)
    _close(got, want, CALL_TOL)
    hm = D.word_heat_map(maps, [2, 3], out_size)
    _close(hm, JD.word_heat_map(jmaps, [2, 3], out_size), CALL_TOL)
    assert float(hm.min()) == 0.0 and float(hm.max()) <= 1.0


def test_tome_config_fields_convert():
    """The JAX config's token-reduction fields map onto the port's."""
    jcfg = dataclasses.replace(JM.UNetConfig.tiny(), tome_ratio=0.5, tome_mode="merge",
                               tome_min_seq=16, tome_sx=2, tome_sy=1, tome_mlp=True,
                               tome_crossattn=True)
    got = convert.config_from(M.UNetConfig, jcfg)
    for f in ("tome_ratio", "tome_mode", "tome_min_seq", "tome_sx", "tome_sy", "tome_mlp",
              "tome_crossattn"):
        assert getattr(got, f) == getattr(jcfg, f)
    with pytest.raises(ValueError, match="use_pallas"):
        convert.config_from(M.UNetConfig, dataclasses.replace(jcfg, use_pallas="xla"))
