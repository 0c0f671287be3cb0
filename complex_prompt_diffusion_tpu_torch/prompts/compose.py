"""ComplexPrompt / WeightedPrompt / CompositionalPrompt.

Counterpart of ``complex_prompt_diffusion_tpu/prompts/compose.py``. Prompt
objects are lightweight host-side descriptions; ``build_spec`` compiles
them to a fixed-shape :class:`~..guidance.GuidanceSpec` on the bundle's
device (f32 embeddings, scales and masks), which the sampling loop batches
through one UNet call. Embeddings come from the port's
``pipeline.encode_prompt`` and are cached per prompt object as f32 numpy
arrays, as in the JAX package. JSON keeps the JAX package's schema
(prompt/scale/mask/conjunctions/negations/transforms) and its class
registry, so a prompt written by either package loads in the other.
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Union

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.prompts.masks import make_mask
from complex_prompt_diffusion_tpu_torch.prompts.parse import parse_weighted_prompt
from complex_prompt_diffusion_tpu_torch.prompts.transforms import (
    PromptLerpTransform,
    Transform,
    transform_from_json,
)

__all__ = [
    "ComplexPrompt",
    "WeightedPrompt",
    "CompositionalPrompt",
    "prompt_from_json",
    "PROMPT_REGISTRY",
]

PROMPT_REGISTRY: Dict[str, type] = {}


def _host(t) -> np.ndarray:
    """A device tensor as an f32 numpy array (the embedding cache)."""
    return t.detach().to("cpu", dtype=torch.float32).numpy()


def _spec(bundle, uncond, factors, scales, masks):
    """A GuidanceSpec of f32 tensors on the bundle's device."""
    from complex_prompt_diffusion_tpu_torch.guidance import GuidanceSpec

    def dev(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=bundle.device)

    return GuidanceSpec(uncond=dev(uncond), factors=dev(factors),
                        scales=dev(np.asarray(scales, np.float32)), masks=dev(masks))


def _register(cls):
    PROMPT_REGISTRY[cls.__name__] = cls
    return cls


def prompt_from_json(data: dict, **kwargs) -> "ComplexPrompt":
    name = data.get("class", "ComplexPrompt")
    if name not in PROMPT_REGISTRY:
        raise KeyError(f"unknown prompt class {name!r}")
    return PROMPT_REGISTRY[name].from_json(data, **kwargs)


@_register
class ComplexPrompt:
    """A prompt + negative prompt + scale + spatial mask + transform path.

    ``bundle`` (a pipeline.ModelBundle) provides the text encoder; it can be
    attached at construction or per call.
    """

    def __init__(
        self,
        prompt: str = "",
        negative_prompt: str = "",
        scale: float = 1.0,
        mask: Union[float, np.ndarray, str] = 1.0,
        bundle: Any = None,
    ):
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        self.scale = float(scale)
        self.mask = mask
        self.bundle = bundle
        self.transforms: List[Transform] = []
        self._cache: Dict[str, np.ndarray] = {}

    # --- embeddings -----------------------------------------------------
    def _bundle(self, bundle=None):
        b = bundle or self.bundle
        if b is None:
            raise ValueError("no ModelBundle attached to this prompt")
        return b

    def token_map(self, bundle=None) -> List[int]:
        """Token ids for the prompt, used by repeated-token masking in
        PromptLerpTransform."""
        b = self._bundle(bundle)
        return list(b.tokenizer([self.prompt])[0])

    def cond_embedding(self, bundle=None) -> np.ndarray:
        """[77, D] conditioning embedding, cached."""
        if "cond" not in self._cache:
            from complex_prompt_diffusion_tpu_torch.pipeline import encode_prompt

            b = self._bundle(bundle)
            self._cache["cond"] = _host(encode_prompt(b, self.prompt)[0])
        return self._cache["cond"]

    def uncond_embedding(self, bundle=None) -> np.ndarray:
        if "uncond" not in self._cache:
            from complex_prompt_diffusion_tpu_torch.pipeline import encode_prompt

            b = self._bundle(bundle)
            self._cache["uncond"] = _host(encode_prompt(b, self.negative_prompt)[0])
        return self._cache["uncond"]

    # --- transform path -------------------------------------------------
    def add_transform(self, transform: Transform) -> "ComplexPrompt":
        """Append an embedding transform."""
        self.transforms.append(transform)
        return self

    def add_prompt_lerp(
        self,
        target: Union["ComplexPrompt", str],
        magnitude: float = 1.0,
        mode: str = "slerp",
        **args,
    ) -> "ComplexPrompt":
        """Shortcut for a LerpCLIP-style transform toward ``target``."""
        if isinstance(target, str):
            target = ComplexPrompt(target, bundle=self.bundle)
        t = PromptLerpTransform({"magnitude": magnitude, "lerp_mode": mode, **args})
        t.target_prompt = target
        self.transforms.append(t)
        return self

    def embedding_path(self, steps: int = 1, bundle=None) -> List[np.ndarray]:
        """Walk the transform path, producing one conditioning embedding per
        path step."""
        b = self._bundle(bundle)
        cond = self.cond_embedding(b)
        if not self.transforms:
            return [cond]
        path = [cond]
        for t in self.transforms:
            if isinstance(t, PromptLerpTransform) and hasattr(t, "target_prompt"):
                target = t.target_prompt
                maps = (self.token_map(b), target.token_map(b))
                path = t.apply(path[-1], target.cond_embedding(b), steps, maps)
            else:
                continue
        return path

    # --- spec compilation ----------------------------------------------
    def _mask_array(self, h: int, w: int) -> np.ndarray:
        if isinstance(self.mask, str):
            return make_mask(self.mask, h, w)[..., None]
        m = np.asarray(self.mask, dtype=np.float32)
        if m.ndim == 0:
            return np.full((1, 1, 1), float(m), np.float32)
        while m.ndim > 2 and m.shape[0] == 1:
            m = m[0]
        if m.ndim == 2:
            m = m[..., None]
        return m.astype(np.float32)

    def build_spec(self, h: int = 64, w: int = 64, bundle=None):
        """Compile to a GuidanceSpec (single factor) on the bundle's
        device."""
        b = self._bundle(bundle)
        mask = self._mask_array(h, w)
        target_shape = (1,) + ((h, w, 1) if mask.size > 1 else (1, 1, 1))
        return _spec(
            b, self.uncond_embedding(b), self.cond_embedding(b)[None],
            [self.scale], np.broadcast_to(mask[None], target_shape),
        )

    # --- rendering ------------------------------------------------------
    def render(self, cfg=None, bundle=None, **kwargs):
        """Render through the port's ``txt2img``; returns (images, latents)."""
        from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, txt2img

        b = self._bundle(bundle)
        cfg = cfg or RenderConfig(**kwargs)
        spec = self.build_spec(cfg.height // 8, cfg.width // 8, b)
        return txt2img(b, spec, cfg=cfg)

    # --- JSON -----------------------------------------------------------
    def to_json(self) -> dict:
        data = {
            "class": self.__class__.__name__,
            "prompt": self.prompt,
            "negative_prompt": self.negative_prompt,
            "scale": self.scale,
            "transforms": [t.to_json() for t in self.transforms],
        }
        if isinstance(self.mask, str):
            data["mask"] = self.mask
        elif np.asarray(self.mask).size == 1:
            data["mask"] = float(np.asarray(self.mask).reshape(()))
        else:
            data["mask"] = np.asarray(self.mask).tolist()
        return data

    def to_json_string(self) -> str:
        return _json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, data: dict, bundle=None, **kwargs):
        obj = cls(
            prompt=data.get("prompt", ""),
            negative_prompt=data.get("negative_prompt", ""),
            scale=data.get("scale", 1.0),
            mask=data.get("mask", 1.0)
            if isinstance(data.get("mask", 1.0), (str, int, float))
            else np.asarray(data["mask"], np.float32),
            bundle=bundle,
        )
        for t in data.get("transforms", []):
            obj.transforms.append(transform_from_json(t))
        return obj

    def clone(self) -> "ComplexPrompt":
        other = type(self).from_json(self.to_json(), bundle=self.bundle)
        other._cache = dict(self._cache)
        return other

    def __repr__(self):
        return f"{self.__class__.__name__}({self.prompt!r}, scale={self.scale})"


@_register
class WeightedPrompt(ComplexPrompt):
    """``"a cat:2.0 a dog:1.0"`` -> weight-normalized sum of CLIP embeddings;
    the subprompts are encoded as one CLIP batch."""

    def cond_embedding(self, bundle=None) -> np.ndarray:
        if "cond" in self._cache:
            return self._cache["cond"]
        from complex_prompt_diffusion_tpu_torch.pipeline import encode_prompt

        b = self._bundle(bundle)
        subprompts, weights = parse_weighted_prompt(self.prompt)
        self.subprompts, self.subweights = subprompts, weights
        if len(subprompts) <= 1:
            return super().cond_embedding(bundle)
        total = sum(weights)
        embs = _host(encode_prompt(b, subprompts))  # [K, 77, D], one CLIP batch
        cond = sum((w / total) * embs[i] for i, w in enumerate(weights))
        self._cache["cond"] = np.asarray(cond)
        return self._cache["cond"]


@_register
class CompositionalPrompt(ComplexPrompt):
    """AND/NOT composition with per-factor scale and spatial mask.
    Compiles to a K-factor GuidanceSpec."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conjunctions: List[ComplexPrompt] = []
        self._negations: List[ComplexPrompt] = []

    def _coerce(self, prompt, scale, mask) -> ComplexPrompt:
        if isinstance(prompt, str):
            prompt = ComplexPrompt(prompt, bundle=self.bundle)
        if scale is not None:
            prompt.scale = scale
        if mask is not None:
            prompt.mask = mask
        return prompt

    def add_conjunction(self, prompt, scale: float = 1.0, mask=1.0):
        """AND factor."""
        self._conjunctions.append(self._coerce(prompt, scale, mask))
        return self

    def add_negation(self, prompt, scale: float = 1.0, mask=1.0):
        """NOT factor: pushes generations away."""
        self._negations.append(self._coerce(prompt, scale, mask))
        return self

    def add_filter(self, prompt, strength: float = 1.0, mask=1.0):
        """Sign of strength picks and/not."""
        if strength == 0:
            return self
        if strength > 0:
            return self.add_conjunction(prompt, scale=strength, mask=mask)
        return self.add_negation(prompt, scale=abs(strength), mask=mask)

    def add_masked_filter(self, prompt, mask, strength: float = 1.0):
        """Filter with a mask-DSL string or array."""
        return self.add_filter(prompt, strength=strength, mask=mask)

    @property
    def factors(self) -> List[ComplexPrompt]:
        return [self] + self._conjunctions + self._negations

    def build_spec(self, h: int = 64, w: int = 64, bundle=None):
        """{"and": [...], "not": [...]} semantics as a
        stacked GuidanceSpec: and-scales positive, not-scales negative."""
        b = self._bundle(bundle)
        factors, scales, masks = [], [], []
        for p in [self] + self._conjunctions:
            factors.append(p.cond_embedding(b))
            scales.append(p.scale)
            masks.append(p._mask_array(h, w))
        for p in self._negations:
            factors.append(p.cond_embedding(b))
            scales.append(-p.scale)
            masks.append(p._mask_array(h, w))

        any_spatial = any(m.size > 1 for m in masks)
        if any_spatial:
            masks = [np.broadcast_to(m, (h, w, 1)) for m in masks]
        else:
            masks = [m.reshape(1, 1, 1) for m in masks]
        return _spec(b, self.uncond_embedding(b), np.stack(factors), scales, np.stack(masks))

    def to_json(self) -> dict:
        data = super().to_json()
        data["conjunctions"] = [c.to_json() for c in self._conjunctions]
        data["negations"] = [n.to_json() for n in self._negations]
        return data

    @classmethod
    def from_json(cls, data: dict, bundle=None, **kwargs):
        obj = super().from_json(data, bundle=bundle, **kwargs)
        for c in data.get("conjunctions", []):
            obj._conjunctions.append(prompt_from_json(c, bundle=bundle))
        for n in data.get("negations", []):
            obj._negations.append(prompt_from_json(n, bundle=bundle))
        return obj
