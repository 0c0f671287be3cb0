"""Model definitions of the port: CLIP text and vision towers, UNet (with DeepCache's
pair of calls; tiled inference in ``tiled.py``), VAE (encoder and
decoder, the VQ first stage, tiled encode and decode)."""

from complex_prompt_diffusion_tpu_torch.models import layers
from complex_prompt_diffusion_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPTextConfig,
    CLIPVisionConfig,
    clip_text_apply,
    clip_vision_apply,
    init_clip_text,
    init_clip_vision,
)
from complex_prompt_diffusion_tpu_torch.models.unet import (
    UNetConfig,
    build_plan,
    deepcache_default_block,
    init_unet,
    make_deepcache_unets,
    precompute_cross_kv,
    unet_apply,
)
from complex_prompt_diffusion_tpu_torch.models.vae import (
    DiagonalGaussian,
    VAEConfig,
    init_vae,
    init_vq_model,
    init_vq_quantizer,
    vae_decode,
    vae_decode_tiled,
    vae_encode,
    vae_encode_tiled,
    vq_decode,
    vq_encode,
    vq_quantize,
)

__all__ = [
    "layers",
    "CLIPTextConfig",
    "clip_text_apply",
    "init_clip_text",
    "CLIPVisionConfig",
    "clip_vision_apply",
    "init_clip_vision",
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
    "UNetConfig",
    "build_plan",
    "init_unet",
    "precompute_cross_kv",
    "unet_apply",
    "deepcache_default_block",
    "make_deepcache_unets",
    "VAEConfig",
    "DiagonalGaussian",
    "init_vae",
    "vae_encode",
    "vae_decode",
    "init_vq_quantizer",
    "vq_quantize",
    "init_vq_model",
    "vq_encode",
    "vq_decode",
    "vae_decode_tiled",
    "vae_encode_tiled",
]
