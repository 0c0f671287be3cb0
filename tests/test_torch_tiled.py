"""Port parity of tiled UNet inference (``models/tiled.py``): tile
positions, the blending window, the fold, chunking with zero-weight
padding, the UNet wrapper, and tiled renders through the pipeline
(``unet_tile``, ``unet_tile_stride``, ``unet_tile_chunk``); the multi-card
form still raises.

f32 on the CPU; inputs, x_T and noises from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.models import tiled as JT
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.models import tiled as T

OP_TOL = 1e-6
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4  # as tests/test_torch_sampler_slice.py
PROMPT, NEGATIVE = "a red cube on a table", "blurry"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: its tensors are small,
    and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("size,tile,stride", [(8, 8, 4), (16, 8, 4), (15, 8, 4), (20, 8, 6),
                                              (128, 64, 48), (64, 64, 48), (5, 8, 4)])
def test_tile_positions_equal_jax(size, tile, stride):
    assert T.tile_positions(size, tile, stride) == JT.tile_positions(size, tile, stride)


@pytest.mark.parametrize("tile,overlap", [(8, 2), (8, 0), (64, 16), (7, 3)])
def test_tile_window_equals_jax(tile, overlap):
    np.testing.assert_array_equal(T.tile_window(tile, overlap).numpy(),
                                  np.asarray(JT.tile_window(tile, overlap)))


def _fns(xp):
    """A pixel-local and a non-local map, the same arithmetic in both
    packages (the non-local one mixes each tile's mean in)."""
    def local(t):
        return (xp.tanh(t) if xp is jnp else torch.tanh(t)) * 3.0 + 1.0

    def mixing(t):
        m = t.mean(axis=(1, 2), keepdims=True) if xp is jnp else t.mean(dim=(1, 2), keepdim=True)
        return t[..., :3] * 0.5 + m[..., :3]

    return {"local": local, "mixing": mixing}


@pytest.mark.parametrize("fn", ["local", "mixing"])
@pytest.mark.parametrize("shape,tile,stride,chunk", [
    ((2, 16, 16, 4), 8, 4, 1), ((1, 16, 16, 4), 8, 4, 4), ((1, 15, 20, 4), 8, 6, 2),
    ((2, 12, 12, 4), 8, None, 3),
])
def test_tiled_apply_equals_jax(fn, shape, tile, stride, chunk):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    want = JT.tiled_apply(_fns(jnp)[fn], jnp.asarray(x), tile, stride, chunk=chunk)
    got = T.tiled_apply(_fns(torch)[fn], torch.from_numpy(x), tile, stride, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OP_TOL, atol=OP_TOL)


def test_fold_properties():
    """A constant field comes back exactly; a single tile is one plain call,
    bit for bit; a pixel-local map is reproduced by any tiling; the padded
    chunks (zero-weight copies) leave the fold as chunk 1 has it."""
    out = T.tiled_apply(lambda t: torch.full(t.shape[:3] + (3,), 5.0), torch.zeros((2, 16, 16, 4)),
                        8, 4)
    torch.testing.assert_close(out, torch.full((2, 16, 16, 3), 5.0), rtol=1e-6, atol=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 8, 4)).astype(
        np.float32))
    assert torch.equal(T.tiled_apply(lambda t: t * 2.0, x, 8), x * 2.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16, 16, 4)).astype(
        np.float32))
    f = _fns(torch)["local"]
    torch.testing.assert_close(T.tiled_apply(f, x, 8, 4), f(x), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(T.tiled_apply(torch.sin, x, 8, 4, chunk=4),
                               T.tiled_apply(torch.sin, x, 8, 4, chunk=1), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def bundles():
    jb = JP.ModelBundle.random("tiny", seed=0)
    return jb, P.ModelBundle.from_jax_bundle(jb, device="cpu")


def test_make_tiled_unet_matches_jax(bundles):
    """The tiny UNet over 4x4 tiles of a 6x6 latent, stride 2, 2 tiles a
    call (t and ctx repeated for them): the JAX package's fold."""
    jb, pb = bundles
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 6, 4)).astype(np.float32)
    t = np.array([400, 400], np.int32)
    ctx = rng.standard_normal((2, 77, jb.unet_cfg.context_dim)).astype(np.float32)
    calls = []

    def punet(x_, t_, c_):
        calls.append(x_.shape[0])
        return M.unet_apply(pb.unet_cfg, pb.unet_params, x_, t_, c_)

    want = JT.make_tiled_unet(lambda a, b, c: JM.unet_apply(jb.unet_cfg, jb.unet_params, a, b, c),
                              4, 2, 2)(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    got = T.make_tiled_unet(punet, 4, 2, 2)(*map(torch.from_numpy, (x, t, ctx)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert calls == [4, 4]  # 4 tiles, 2 a call, at batch 2 each


def test_multi_card_form_raises(tmp_path):
    """The multi-rank form is ported (``tests/test_torch_parallel.py`` holds
    it across spawned ranks): on a one-rank gloo mesh it equals
    ``tiled_apply`` bit for bit, and a mesh without the axis raises
    ValueError."""
    import torch.distributed as dist

    from complex_prompt_diffusion_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(data=1)
        x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, 16, 4))
                             .astype(np.float32))

        def fn(t):
            return t * 2.0 + 1.0

        assert torch.equal(T.tiled_apply_sharded(fn, x, 8, 4, mesh=mesh, chunk=2),
                           T.tiled_apply(fn, x, 8, 4, chunk=2))
        with pytest.raises(ValueError):
            T.make_tiled_unet(lambda *a: a[0], 8, mesh=mesh, axis="tiles")(
                x, torch.zeros(1), None)
        with pytest.raises(ValueError):
            T.tiled_apply_sharded(fn, x, 8, mesh=mesh, axis="tiles")
    finally:
        dist.destroy_process_group()


TILED = [
    ("DDIM", dict(unet_tile=4, unet_tile_stride=2, unet_tile_chunk=3), 48),
    ("Euler Ancestral", dict(unet_tile=4, unet_tile_stride=3), 64),
]


@pytest.mark.parametrize("sampler,kw,size", TILED,
                         ids=[f"{s}-{i}" for i, (s, _, _) in enumerate(TILED)])
def test_tiled_render_matches_jax(bundles, sampler, kw, size):
    """txt2img at 48x48 or 64x64 (a 6x6 or 8x8 latent) batch 2 with the UNet
    folded over its tiles (4 tiles, 3 a call: a zero-weight padding tile;
    9 tiles one a call), in both packages from one x_T and one set of
    noises."""
    jb, pb = bundles
    kw = dict(width=size, height=size, batch_size=2, steps=2, sampler=sampler, **kw)
    lat = size // 8
    rng = np.random.default_rng(9)
    x_T = rng.standard_normal((2, lat, lat, 4))
    if P.get_sampler(sampler)[0] == "sigma":
        x_T = x_T * P._sigma_schedule(pb, P.RenderConfig(**kw))[0]
    x_T = x_T.astype(np.float32)
    noises = rng.standard_normal((3, 2, lat, lat, 4)).astype(np.float32)
    _, want = JP.txt2img(jb, PROMPT, NEGATIVE, cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T),
                         noises=jnp.asarray(noises))
    _, got = P.txt2img(pb, PROMPT, NEGATIVE, cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T),
                       noises=torch.from_numpy(noises))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SLICE_RTOL, atol=SLICE_ATOL)


def test_single_tile_render_equals_untiled(bundles):
    """A tile as large as the latent: the tiled render is the untiled one,
    bit for bit (its cross k/v computed in the step instead of hoisted)."""
    _, pb = bundles
    x_T = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 4, 4)).astype(
        np.float32))
    kw = dict(width=32, height=32, steps=2)
    _, tiled = P.txt2img(pb, PROMPT, cfg=P.RenderConfig(unet_tile=4, **kw), x_T=x_T,
                         decode=False)
    _, plain = P.txt2img(pb, PROMPT, cfg=P.RenderConfig(**kw), x_T=x_T, decode=False)
    assert torch.equal(tiled, plain)
