"""Model configuration from CompVis-style YAML configs.

Counterpart of ``complex_prompt_diffusion_tpu/config.py``. Parsing is kept
apart from building: :func:`load_yaml_config` reads a file with PyYAML
(imported there and nowhere else, so the rest needs no PyYAML), and
:func:`bundle_from_config` builds a :class:`~.pipeline.ModelBundle` from
the parsed mapping (the whole file's or its ``model:`` section), which a
caller without PyYAML can give as a Python literal. The ``target:`` class
paths of the conditioning stage map onto an allowlist of configs
(``_COND_STAGE_MAP``); nothing is imported by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S

__all__ = [
    "load_yaml_config",
    "unet_config_from_yaml",
    "vae_config_from_yaml",
    "bundle_from_config",
    "bundle_from_yaml",
]


def load_yaml_config(path: str) -> Dict[str, Any]:
    """The parsed YAML file at ``path``. Needs PyYAML; without it, raises
    ImportError (build from a mapping with :func:`bundle_from_config`)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "load_yaml_config needs PyYAML (the yaml module), which is not installed; "
            "pass the parsed mapping to bundle_from_config instead") from e
    with open(path) as f:
        return yaml.safe_load(f)


def unet_config_from_yaml(params: Dict[str, Any]) -> M.UNetConfig:
    """Map CompVis UNetModel params (config-1.49.yaml / v2-inference.yaml)
    onto UNetConfig."""
    return M.UNetConfig(
        in_channels=params.get("in_channels", 4),
        out_channels=params.get("out_channels", 4),
        model_channels=params.get("model_channels", 320),
        num_res_blocks=params.get("num_res_blocks", 2),
        attention_resolutions=tuple(params.get("attention_resolutions", (4, 2, 1))),
        channel_mult=tuple(params.get("channel_mult", (1, 2, 4, 4))),
        num_heads=params.get("num_heads", -1 if "num_head_channels" in params else 8),
        num_head_channels=params.get("num_head_channels", -1),
        transformer_depth=params.get("transformer_depth", 1),
        context_dim=params.get("context_dim"),
        use_linear_in_transformer=params.get("use_linear_in_transformer", False),
        use_scale_shift_norm=params.get("use_scale_shift_norm", False),
        num_classes=params.get("num_classes"),
    )


def vae_config_from_yaml(first_stage: Dict[str, Any]) -> M.VAEConfig:
    """Map a ``first_stage_config`` (AutoencoderKL ddconfig) onto VAEConfig."""
    dd = first_stage.get("params", {}).get("ddconfig", {})
    return M.VAEConfig(
        in_channels=dd.get("in_channels", 3),
        out_channels=dd.get("out_ch", 3),
        ch=dd.get("ch", 128),
        ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        z_channels=dd.get("z_channels", 4),
        embed_dim=first_stage.get("params", {}).get("embed_dim", 4),
        double_z=dd.get("double_z", True),
        resolution=dd.get("resolution", 512),
    )


# conditioning-stage targets -> (CLIP text preset, the layer it reads)
_COND_STAGE_MAP = {
    "cpd.models.embedder.FrozenCLIPEmbedder": ("sd15", "last"),
    "cpd.models.embedder.FrozenOpenCLIPEmbedder": ("sd21", "penultimate"),
    "ldm.modules.encoders.modules.FrozenCLIPEmbedder": ("sd15", "last"),
    "ldm.modules.encoders.modules.FrozenOpenCLIPEmbedder": ("sd21", "penultimate"),
}


def bundle_from_config(
    conf: Dict[str, Any],
    checkpoint_path: Optional[str] = None,
    vocab_path: Optional[str] = None,
    seed: int = 0,
    *,
    device="cuda",
    dtype: Optional[str] = None,
):
    """Parsed config (the whole file's mapping or its ``model:`` section) ->
    ModelBundle on ``device`` (the GPU unless asked otherwise). The UNet and
    VAE configs, the diffusion tables (``timesteps``, ``linear_start``,
    ``linear_end``), ``parameterization`` and the CLIP layer come from the
    config. With ``checkpoint_path`` the weights are the checkpoint's
    (:meth:`ModelBundle.from_checkpoint`, its UNet in ``dtype`` when given);
    without, random weights drawn from a ``torch.Generator`` seeded with
    ``seed`` on the device, the UNet's stored in its compute dtype."""
    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch.pipeline import ModelBundle, _device
    from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import get_tokenizer

    model = conf.get("model", conf)
    params = model.get("params", {})

    unet_cfg = unet_config_from_yaml(params.get("unet_config", {}).get("params", {}))
    vae_cfg = vae_config_from_yaml(params.get("first_stage_config", {}))

    cond_target = params.get("cond_stage_config", {})
    if isinstance(cond_target, dict):
        cond_target = cond_target.get("target", "")
    version, clip_layer = ("sd15", "last")
    for target, (ver, layer) in _COND_STAGE_MAP.items():
        if cond_target == target or cond_target.endswith(target.rsplit(".", 1)[-1]):
            version, clip_layer = ver, layer
            break

    clip_cfg = M.CLIPTextConfig.sd15() if version == "sd15" else M.CLIPTextConfig.sd21()
    tables = S.make_diffusion_tables(
        num_train_timesteps=params.get("timesteps", 1000),
        beta_start=params.get("linear_start", 0.00085),
        beta_end=params.get("linear_end", 0.012),
    )
    parameterization = params.get("parameterization", "eps")

    if checkpoint_path:
        bundle = ModelBundle.from_checkpoint(checkpoint_path, vocab_path, dtype, device=device)
        return dataclasses.replace(
            bundle,
            unet_cfg=dataclasses.replace(unet_cfg, dtype=bundle.unet_cfg.dtype),
            vae_cfg=vae_cfg,
            tables=tables,
            parameterization=parameterization,
            clip_layer=clip_layer,
        )

    device = _device(device)
    if dtype is not None:
        unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ModelBundle(
        version="sd1" if version == "sd15" else "sd2",
        unet_cfg=unet_cfg,
        unet_params=convert.unet_params(M.init_unet(gen, unet_cfg, device), device,
                                        unet_cfg.compute_dtype),
        vae_cfg=vae_cfg,
        vae_params=convert.vae_params(M.init_vae(gen, vae_cfg, device), device),
        clip_cfg=clip_cfg,
        clip_params=convert.clip_params(M.init_clip_text(gen, clip_cfg, device), device),
        tokenizer=get_tokenizer(vocab_path, pad_with_eos=(version == "sd15")),
        tables=tables,
        device=device,
        parameterization=parameterization,
        clip_layer=clip_layer,
    )


def bundle_from_yaml(
    path: str,
    checkpoint_path: Optional[str] = None,
    vocab_path: Optional[str] = None,
    seed: int = 0,
    *,
    device="cuda",
    dtype: Optional[str] = None,
):
    """YAML file -> ModelBundle: :func:`load_yaml_config`, then
    :func:`bundle_from_config` (see there)."""
    return bundle_from_config(load_yaml_config(path), checkpoint_path, vocab_path, seed,
                              device=device, dtype=dtype)
