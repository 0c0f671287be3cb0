"""Port parity of the CLIP towers' new heads: the vision tower (tiny, and
ViT-B/32's widths cut to 2 layers), its HF converter, and the text tower's
"hidden" and "pooled" layers, against the JAX package.

f32 on the CPU; weights from the JAX package's init (numpy trees through
``convert.py``), inputs from numpy seeds. Each JAX function is compiled
once a config.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.models import clip as JC
from complex_prompt_diffusion_tpu.models import params as JPm
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.models import params as Pm

TOL = 1e-5  # max |port - jax| / max |jax|, f32 on both sides


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VISION_CFGS = {
    "tiny": JC.CLIPVisionConfig.tiny(),
    "vit_b32_2l": dataclasses.replace(JC.CLIPVisionConfig.vit_b32(), num_layers=2),
}


@functools.lru_cache(maxsize=None)
def _vision(name):
    """(JAX config, JAX params, the port's config and params, images)."""
    jcfg = VISION_CFGS[name]
    jp = JC.init_clip_vision(np.random.default_rng(11), jcfg, commit=False)
    rng = np.random.default_rng(12)
    images = rng.standard_normal((2, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    return (jcfg, jp, convert.config_from(M.CLIPVisionConfig, jcfg),
            convert.clip_vision_params(jp), images)


@pytest.mark.parametrize("project", [True, False])
@pytest.mark.parametrize("name", sorted(VISION_CFGS))
def test_clip_vision_apply_matches_jax(name, project):
    jcfg, jp, pcfg, pp, images = _vision(name)
    want = jax.jit(functools.partial(JC.clip_vision_apply, jcfg, project=project))(jp, images)
    got = M.clip_vision_apply(pcfg, pp, torch.from_numpy(images), project=project)
    width = jcfg.projection_dim if project else jcfg.hidden_size
    assert tuple(got.shape) == (2, width) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= TOL


def test_clip_vision_config_and_init_mirror_jax():
    """The presets and ``num_patches`` equal the JAX package's; the port's
    random init builds the JAX tree (keys, shapes), and its patch kernel
    converts to the conv weight [D, 3, p, p]."""
    for preset in ("vit_b32", "vit_l14", "tiny"):
        jcfg = getattr(JC.CLIPVisionConfig, preset)()
        pcfg = getattr(M.CLIPVisionConfig, preset)()
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
        assert pcfg.num_patches == jcfg.num_patches
    assert M.CLIP_IMAGE_MEAN == JC.CLIP_IMAGE_MEAN and M.CLIP_IMAGE_STD == JC.CLIP_IMAGE_STD
    jcfg = JC.CLIPVisionConfig.tiny()
    jp = JC.init_clip_vision(np.random.default_rng(0), jcfg, commit=False)
    pp = M.init_clip_vision(torch.Generator().manual_seed(0), M.CLIPVisionConfig.tiny())
    shapes = jax.tree_util.tree_map(np.shape, jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), pp) == shapes
    w = convert.clip_vision_params(pp)["patch_embedding"]
    assert tuple(w.shape) == (64, 3, 8, 8)
    torch.testing.assert_close(w, pp["patch_embedding"].permute(3, 2, 0, 1), rtol=0, atol=0)


def _hf_vision_sd(cfg, pre_ln_key: str, seed: int = 5) -> dict:
    """A synthetic HF CLIPVisionModelWithProjection state dict (torch
    layouts: conv [O, I, kh, kw], linears [out, in])."""
    rng = np.random.default_rng(seed)
    d, v = cfg.hidden_size, "vision_model."

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {
        f"{v}embeddings.class_embedding": arr(d),
        f"{v}embeddings.patch_embedding.weight": arr(d, 3, cfg.patch_size, cfg.patch_size),
        f"{v}embeddings.position_embedding.weight": arr(cfg.num_patches + 1, d),
        f"{v}{pre_ln_key}.weight": arr(d), f"{v}{pre_ln_key}.bias": arr(d),
        f"{v}post_layernorm.weight": arr(d), f"{v}post_layernorm.bias": arr(d),
        "visual_projection.weight": arr(cfg.projection_dim, d),
    }
    for i in range(cfg.num_layers):
        b = f"{v}encoder.layers.{i}"
        for name, (o, n) in {"self_attn.q_proj": (d, d), "self_attn.k_proj": (d, d),
                             "self_attn.v_proj": (d, d), "self_attn.out_proj": (d, d),
                             "mlp.fc1": (4 * d, d), "mlp.fc2": (d, 4 * d)}.items():
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = arr(o, n), arr(o)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = arr(d), arr(d)
    return sd


@pytest.mark.parametrize("pre_ln_key", ["pre_layrnorm", "pre_layernorm"])
def test_convert_clip_vision_hf_matches_jax(pre_ln_key):
    """Both spellings of the pre-LN: the port's tree equals the JAX
    package's leaf for leaf, and encodes as the JAX tree does."""
    jcfg = JC.CLIPVisionConfig.tiny()
    sd = _hf_vision_sd(jcfg, pre_ln_key)
    want = JPm.convert_clip_vision_hf(jcfg, sd)
    got = Pm.convert_clip_vision_hf(M.CLIPVisionConfig.tiny(), sd)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    images = np.random.default_rng(1).standard_normal((1, 32, 32, 3)).astype(np.float32)
    enc = M.clip_vision_apply(M.CLIPVisionConfig.tiny(), convert.clip_vision_params(got),
                              torch.from_numpy(images))
    assert _rel(enc.numpy(), JC.clip_vision_apply(jcfg, want, images)) <= TOL


@functools.lru_cache(maxsize=None)
def _text(projection_dim):
    jcfg = dataclasses.replace(JC.CLIPTextConfig.tiny(), projection_dim=projection_dim)
    jp = JC.init_clip_text(np.random.default_rng(21), jcfg, commit=False)
    rng = np.random.default_rng(22)
    tokens = rng.integers(1, jcfg.vocab_size - 1, (2, jcfg.max_length)).astype(np.int32)
    tokens[:, 9] = jcfg.vocab_size - 1  # the EOT id, the highest
    return jcfg, jp, convert.config_from(M.CLIPTextConfig, jcfg), convert.clip_params(jp), tokens


@pytest.mark.parametrize("layer,layer_idx,projection_dim", [
    ("hidden", 1, None), ("hidden", 0, None), ("pooled", None, None), ("pooled", None, 48),
    ("last", None, 48), ("penultimate", None, None),
])
def test_clip_text_layers_match_jax(layer, layer_idx, projection_dim):
    """"hidden" (no final LN) and "pooled" (the EOT row, through
    text_projection when present, unit norm) against the JAX package."""
    jcfg, jp, pcfg, pp, tokens = _text(projection_dim)
    assert ("text_projection" in pp) == bool(projection_dim)
    want = jax.jit(functools.partial(JC.clip_text_apply, jcfg, layer=layer,
                                     layer_idx=layer_idx))(jp, tokens)
    got = M.clip_text_apply(pcfg, pp, torch.from_numpy(tokens), layer=layer,
                            layer_idx=layer_idx)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got.numpy(), want) <= TOL
    if layer == "pooled":
        np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 1.0,
                                   rtol=1e-6)


def test_clip_text_unknown_layer_is_last_and_hidden_needs_index():
    """An unknown layer name encodes as "last" in both packages (no error);
    "hidden" without ``layer_idx`` raises ValueError in both; the port's
    init makes ``text_projection`` when ``projection_dim`` is set."""
    jcfg, jp, pcfg, pp, tokens = _text(None)
    last_j = JC.clip_text_apply(jcfg, jp, tokens)
    np.testing.assert_array_equal(np.asarray(JC.clip_text_apply(jcfg, jp, tokens, layer="mid")),
                                  np.asarray(last_j))
    t = torch.from_numpy(tokens)
    torch.testing.assert_close(M.clip_text_apply(pcfg, pp, t, layer="mid"),
                               M.clip_text_apply(pcfg, pp, t), rtol=0, atol=0)
    for fn, cfg, p, tok in ((JC.clip_text_apply, jcfg, jp, tokens),
                            (M.clip_text_apply, pcfg, pp, t)):
        with pytest.raises(ValueError, match="layer_idx"):
            fn(cfg, p, tok, layer="hidden")
    init = M.init_clip_text(torch.Generator().manual_seed(0),
                            dataclasses.replace(pcfg, projection_dim=24))
    assert tuple(init["text_projection"]["kernel"].shape) == (64, 24)
    assert "bias" not in init["text_projection"]
