"""Port parity: the VQ first stage and the tiled VAE encode / decode.

The JAX package's ``models/vae.py`` is the reference; its random trees reach
the port through ``convert.vae_params`` (which now carries a VQ tree's
``quantize`` codebook). Everything runs on the CPU in f32 on the tiny VAE
config (two levels: latents are 1/2 of the image side), where the port's
kernel wrappers take their plain twins. Tolerances: ``vq_quantize``'s z_q,
loss and straight-through gradients within 1e-6, its indices equal except
at near-ties (a gap between the two nearest codes below 1e-6 of the
distance); the encoders and decoders within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.models import vae as JV
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.models import vae as V
from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

VQ_TOL = 1e-6
REL = 1e-4


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module")
def vq_trees():
    """The tiny VAE config, a JAX VQ tree (256 codes) and its port copy."""
    cfg = JV.VAEConfig.tiny()
    jtree = jax.tree_util.tree_map(np.asarray, JV.init_vq_model(jax.random.PRNGKey(3), cfg,
                                                                n_embed=256))
    return cfg, jtree, convert.vae_params(jtree, "cpu")


def _near_ties(z, emb, gap=1e-6):
    """Rows of z whose two nearest codes (float64 distances) lie within
    ``gap`` of the distance."""
    flat = np.asarray(z, np.float64).reshape(-1, z.shape[-1])
    d = ((flat[:, None, :] - np.asarray(emb, np.float64)[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= gap * np.maximum(two[:, 0], 1e-30)


def _midpoints(emb, n):
    """``n`` midpoints of a code and its nearest neighbour whose two nearest
    codes are that pair: near-ties."""
    e = np.asarray(emb, np.float64)
    out = []
    for i in range(len(e)):
        d = ((e - e[i]) ** 2).sum(-1)
        d[i] = np.inf
        j = int(np.argmin(d))
        m = 0.5 * (e[i] + e[j])
        if set(np.argsort(((e - m) ** 2).sum(-1))[:2]) == {i, j}:
            out.append(m)
        if len(out) == n:
            return np.asarray(out, np.float32)
    raise AssertionError("no code pair gives a near-tie")


@pytest.mark.parametrize("n_embed,scale", [(64, 1.0), (512, 0.01)])
def test_vq_quantize_matches_jax(n_embed, scale):
    """Indices equal except at near-ties, which the input plants (midpoints
    of code pairs) and the test finds; z_q and the loss within 1e-6
    (reached: equal); the straight-through gradient of sum(c * z_q) + loss
    within 1e-6."""
    qp = jax.tree_util.tree_map(np.asarray, JV.init_vq_quantizer(jax.random.PRNGKey(n_embed),
                                                                 n_embed, 4))
    emb = qp["embedding"]
    rng = np.random.default_rng(n_embed)
    z = (rng.standard_normal((2, 6, 6, 4)) * scale / n_embed).astype(np.float32)
    z[0, 0, :3] = _midpoints(emb, 3)  # equidistant from their two nearest codes
    ties = _near_ties(z, emb)
    assert ties.any()  # the tie rule is exercised
    jz_q, jloss, jidx = JV.vq_quantize(qp, jnp.asarray(z))
    pq = convert.vae_params({"quantize": qp, **{k: {} for k in ("encoder", "decoder",
                                                                "quant_conv",
                                                                "post_quant_conv")}})
    z_t = torch.from_numpy(z).requires_grad_(True)
    z_q, loss, idx = V.vq_quantize(pq["quantize"], z_t)
    idx, jidx = idx.numpy().reshape(-1), np.asarray(jidx).reshape(-1)
    assert idx.dtype == np.int64 and idx.shape == jidx.shape
    assert np.all((idx == jidx) | ties), np.nonzero((idx != jidx) & ~ties)
    same = (idx == jidx).reshape(z.shape[:-1])
    np.testing.assert_allclose(z_q.detach().numpy()[same], np.asarray(jz_q)[same], rtol=0,
                               atol=VQ_TOL)
    # at a near-tie either code is as near: the loss holds whichever was taken
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=VQ_TOL)
    c = rng.standard_normal(z.shape).astype(np.float32)

    def jobj(zz):
        zq, ls, _ = JV.vq_quantize(qp, zz)
        return jnp.sum(zq * c) + ls

    jgrad = np.asarray(jax.grad(jobj)(jnp.asarray(z)))
    (torch.sum(z_q * torch.from_numpy(c)) + loss).backward()
    np.testing.assert_allclose(z_t.grad.numpy(), jgrad, rtol=0, atol=VQ_TOL)


def test_vq_encode_and_decode_match_jax(vq_trees):
    """32x32 images, 256 codes: the pre-quantization latents and the decode
    within 1e-4 relative; the codes equal (no near-tie at these
    latents)."""
    cfg, jtree, ptree = vq_trees
    pcfg = convert.config_from(M.VAEConfig, cfg)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    h_j = np.asarray(JV.vq_encode(cfg, jtree, jnp.asarray(x), quantize=False))
    h_p = V.vq_encode(pcfg, ptree, torch.from_numpy(x), quantize=False)
    _close(h_p.numpy(), h_j)
    jz_q, jloss, jidx = JV.vq_encode(cfg, jtree, jnp.asarray(x))
    with torch.inference_mode():
        z_q, loss, idx = V.vq_encode(pcfg, ptree, torch.from_numpy(x))
    assert not _near_ties(h_j, jtree["quantize"]["embedding"]).any()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(z_q.numpy(), np.asarray(jz_q), rtol=0, atol=VQ_TOL)
    _close(float(loss), float(jloss))
    with torch.inference_mode():
        dec = V.vq_decode(pcfg, ptree, z_q)
    _close(dec.numpy(), np.asarray(JV.vq_decode(cfg, jtree, jz_q)))


def test_vq_tree_converts_and_bundles(vq_trees):
    """``convert.vae_params`` keeps ``quantize`` (f32 whatever the cast);
    ``ModelBundle.from_jax_params`` takes a VQ tree; the port's own
    ``init_vq_model`` builds the JAX package's layout."""
    cfg, jtree, ptree = vq_trees
    np.testing.assert_array_equal(ptree["quantize"]["embedding"].numpy(),
                                  jtree["quantize"]["embedding"])
    half = convert.vae_params(jtree, "cpu", torch.bfloat16)
    assert half["quantize"]["embedding"].dtype == torch.float32
    assert half["encoder"]["conv_in"]["weight"].dtype == torch.bfloat16
    assert "quantize" not in convert.vae_params({k: v for k, v in jtree.items()
                                                 if k != "quantize"})
    from complex_prompt_diffusion_tpu import pipeline as JP

    jb = JP.ModelBundle.random("tiny", seed=0)
    pb = ModelBundle.from_jax_params(jb.unet_cfg, jb.unet_params, cfg, jtree, jb.clip_cfg,
                                     jb.clip_params, device="cpu")
    assert pb.vae_params["quantize"]["embedding"].shape == (256, 4)
    own = V.init_vq_model(torch.Generator().manual_seed(0), V.VAEConfig.tiny(), n_embed=32)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    want = JV.init_vq_model(jax.random.PRNGKey(0), cfg, n_embed=32)
    assert shapes(own) == shapes(jax.tree_util.tree_map(np.asarray, want))
    emb = own["quantize"]["embedding"]
    assert emb.dtype == torch.float32 and float(emb.abs().max()) <= 1 / 32


@pytest.fixture(scope="module")
def kl_trees():
    cfg = JV.VAEConfig.tiny()
    jtree = jax.tree_util.tree_map(np.asarray, JV.init_vae(jax.random.PRNGKey(5), cfg))
    return cfg, jtree, convert.config_from(M.VAEConfig, cfg), convert.vae_params(jtree)


@pytest.mark.parametrize("shape,tile,overlap", [((1, 24, 20, 4), 16, 8), ((2, 20, 12, 4), 8, 2),
                                                ((1, 8, 8, 4), 16, 8)],
                         ids=["3x2-tiles", "ragged-b2", "passthrough"])
def test_vae_decode_tiled_matches_jax(kl_trees, shape, tile, overlap):
    """Latents larger than a tile (the last tile flush with the edge) and
    one no larger (decoded whole): within 1e-4 relative."""
    cfg, jtree, pcfg, ptree = kl_trees
    z = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = np.asarray(JV.vae_decode_tiled(cfg, jtree, jnp.asarray(z), tile=tile, overlap=overlap))
    with torch.inference_mode():
        got = V.vae_decode_tiled(pcfg, ptree, torch.from_numpy(z), tile=tile, overlap=overlap)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,tile,overlap", [((1, 48, 40, 3), 32, 8), ((1, 16, 16, 3), 32, 8)],
                         ids=["tiled", "passthrough"])
def test_vae_encode_tiled_matches_jax(kl_trees, shape, tile, overlap):
    """The blended posterior mean with logvar -30 (tiled), or the whole
    posterior (an image no larger than a tile): within 1e-4 relative."""
    cfg, jtree, pcfg, ptree = kl_trees
    x = np.random.default_rng(shape[1]).uniform(-1, 1, shape).astype(np.float32)
    want = JV.vae_encode_tiled(cfg, jtree, jnp.asarray(x), tile=tile, overlap=overlap)
    with torch.inference_mode():
        got = V.vae_encode_tiled(pcfg, ptree, torch.from_numpy(x), tile=tile, overlap=overlap)
    _close(got.mean.numpy(), np.asarray(want.mean))
    _close(got.logvar.numpy(), np.asarray(want.logvar))
    if shape[1] > tile:
        assert float(got.logvar.max()) == float(got.logvar.min()) == -30.0


def test_tile_weights_equal_jax():
    for th, tw in ((16, 16), (40, 24), (3, 7)):
        np.testing.assert_array_equal(V._tile_weights(th, tw).numpy(),
                                      np.asarray(JV._tile_weights(th, tw)))
