"""Embedding transform paths (host-side numpy).

A copy of ``complex_prompt_diffusion_tpu/prompts/transforms.py``:
  * :class:`Transform` — args dict with ``lerp_keys`` parameter
    interpolation across steps, JSON round-trip.
  * :class:`PromptLerpTransform` — masked embedding interpolation: choose
    tokens (top-k cosine similarity, repeated-token masking), choose top-k
    embedding dims per token, interpolate only under the mask with
    delta/static multipliers and optional downward bleed.
  * :class:`ConfigLerpTransform` — interpolates sampler config values.

Transforms run once per frame on the host; their output feeds GuidanceSpec
construction. JSON uses an explicit class registry (with the reference's
class names as aliases), never a dynamic import of a dotted path.
"""

from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from complex_prompt_diffusion_tpu_torch.prompts.interp import (
    bleed,
    interpolate_lookup,
    slerp,
)

__all__ = [
    "Transform",
    "PromptLerpTransform",
    "ConfigLerpTransform",
    "transform_from_json",
    "TRANSFORM_REGISTRY",
]

TRANSFORM_REGISTRY: Dict[str, type] = {}


def _register(cls):
    TRANSFORM_REGISTRY[cls.__name__] = cls
    # also accept the reference's class names for JSON compatibility
    for alias in getattr(cls, "JSON_ALIASES", ()):
        TRANSFORM_REGISTRY[alias] = cls
    return cls


def valid_range(size: int, r: Optional[tuple] = None, idxs=None) -> dict:
    """Clamp a (start, end) range to valid bounds."""
    r = (0, size) if r is None else r
    r_min = 0 if idxs is None else min(idxs)
    r_max = size if idxs is None else max(idxs)
    return {
        "start": max(min(r[0], r[1]), r_min),
        "end": min(max(r[0], r[1]), r_max),
    }


class Transform:
    """Base: args dict + per-step parameter interpolation via lerp_keys."""

    JSON_ALIASES: tuple = ("AbstractTransform",)

    def __init__(self, args: Optional[dict] = None):
        self.args = dict(args or {})
        self.param_lerp_keys = self.args.get("lerp_keys", [])
        self.step_results: List[Any] = []

    def lerp_params(self, params: dict, amount: float) -> dict:
        """Scale interpolatable params by ``amount`` in (0, 1]."""
        if amount == 1:
            return params
        result = {}
        for k, v in params.items():
            if k not in self.param_lerp_keys:
                result[k] = v
            elif isinstance(v, bool):
                result[k] = v
            elif isinstance(v, float):
                result[k] = v * amount
            elif isinstance(v, int):
                result[k] = int(v * amount)
            elif isinstance(v, (tuple, list)) and len(v) == 2:
                a, b = v
                if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                    lo = type(a)(a * amount)
                    hi = type(b)(b + b * (1 - amount))
                    result[k] = type(v)((lo, hi))
                else:
                    result[k] = v
            else:
                result[k] = v
        return result

    # JSON ---------------------------------------------------------------
    def to_json(self) -> dict:
        return {"args": self.args, "class": self.__class__.__name__}

    def to_json_string(self) -> str:
        return _json.dumps(self.to_json(), indent=2, sort_keys=True) + "\n"

    @classmethod
    def from_json(cls, data: dict, **kwargs):
        return cls(data.get("args", {}))


def transform_from_json(data: dict, **kwargs) -> Transform:
    name = data.get("class", "")
    if name not in TRANSFORM_REGISTRY:
        raise KeyError(f"unknown transform class {name!r}")
    return TRANSFORM_REGISTRY[name].from_json(data, **kwargs)


@_register
class PromptLerpTransform(Transform):
    """Masked interpolation between a start and a target embedding.

    args (defaults match the reference's):
      magnitude (1.0), lerp_mode ("slerp"), lerp_threshold (0.995),
      do_bleed (False),
      token_k (77), token_idxs, token_range, token_largest (True),
      embed_k (768), embed_idxs, embed_range, embed_largest (True),
      delta_mult (1.0), static_mult (1.0), lerp_keys ([...]).
    """

    JSON_ALIASES = ("LerpCLIPEmbeddingTransform",)

    DEFAULTS = dict(
        magnitude=1.0,
        lerp_threshold=0.995,
        lerp_mode="slerp",
        do_bleed=False,
        token_k=77,
        token_idxs=None,
        token_range=None,
        token_largest=True,
        embed_k=768,
        embed_idxs=None,
        embed_range=None,
        embed_largest=True,
        delta_mult=1.0,
        static_mult=1.0,
    )

    def __init__(self, args: Optional[dict] = None):
        super().__init__(args)
        for k, v in self.DEFAULTS.items():
            self.args.setdefault(k, v)
        self.interp = interpolate_lookup.get(self.args["lerp_mode"], slerp)

    # --- selection helpers ----------------------
    def _token_idxs(
        self, c_start: np.ndarray, c_end: np.ndarray,
        token_maps: Tuple, params: dict,
    ) -> np.ndarray:
        T, _ = c_start.shape
        token_k = params["token_k"]
        if token_k is not None and params["token_largest"] is not None:
            k = max(min(T, token_k), 0)
            if k == T:
                return np.arange(k)
            if k == 0:
                return np.array([], dtype=np.int64)
            # per-token cosine similarity between start and end embeddings
            num = np.sum(c_start * c_end, axis=1)
            den = np.linalg.norm(c_start, axis=1) * np.linalg.norm(c_end, axis=1)
            sim = num / np.maximum(den, 1e-12)
            if params["token_largest"] and token_maps is not None:
                # zero out positions whose token ids are identical in both
                # prompts
                repeat_mask = np.array(
                    [float(p1 != p2) for p1, p2 in zip(token_maps[0], token_maps[1])]
                )
                sim = sim * repeat_mask[: len(sim)]
            order = np.argsort(-sim if params["token_largest"] else sim, kind="stable")
            return order[:k]
        if params["token_range"] is not None:
            rng = valid_range(T, r=params["token_range"], idxs=params["token_idxs"])
            if params["token_idxs"] is None:
                return np.arange(rng["start"], rng["end"])
            return np.asarray(params["token_idxs"])
        return np.asarray(params["token_idxs"] if params["token_idxs"] else [], dtype=np.int64)

    def _embed_mask(self, c_delta: np.ndarray, token_idxs: np.ndarray, params: dict):
        T, E = c_delta.shape
        rng = valid_range(E, r=params["embed_range"], idxs=params["embed_idxs"])
        total = (
            len(params["embed_idxs"])
            if params["embed_idxs"] is not None
            else rng["end"] - rng["start"]
        )
        k = params["embed_k"] or total
        k = max(min(k, total), 0)
        embed_idxs = (
            np.asarray(params["embed_idxs"])
            if params["embed_idxs"] is not None
            else np.arange(rng["start"], rng["end"])
        )
        sl = c_delta[token_idxs][:, rng["start"] : rng["end"]]
        order = np.argsort(-sl if params["embed_largest"] else sl, axis=1, kind="stable")
        selected = order[:, :k] + rng["start"]

        mask = np.zeros((T, E), dtype=bool)
        allowed = np.zeros(E, dtype=bool)
        allowed[embed_idxs] = True
        for row, t in enumerate(token_idxs):
            cols = selected[row]
            mask[t, cols[allowed[cols]]] = True
        return mask

    def step(
        self,
        c_start: np.ndarray,
        c_end: np.ndarray,
        params: dict,
        token_maps: Optional[Tuple] = None,
    ) -> np.ndarray:
        """One interpolation step [T, E] -> [T, E]."""
        c_start = np.asarray(c_start, np.float64)
        c_end = np.asarray(c_end, np.float64)
        token_idxs = self._token_idxs(c_start, c_end, token_maps, params)
        if token_idxs.shape[0] == 0:
            return c_start * params["static_mult"]
        c_delta = self.interp(
            c_start, c_end, params["magnitude"], params["lerp_threshold"]
        )
        mask = self._embed_mask(c_delta, token_idxs, params)
        delta = c_delta * mask
        d_max, d_min = delta.max(), delta.min()
        if params["do_bleed"]:
            delta = bleed(delta)
        delta = np.clip(delta, d_min, d_max)
        static = c_start * ~mask
        return delta * params["delta_mult"] + static * params["static_mult"]

    def apply(
        self,
        c_start: np.ndarray,
        c_end: np.ndarray,
        steps: int = 1,
        token_maps: Optional[Tuple] = None,
    ) -> List[np.ndarray]:
        """Interpolation path over ``steps``: params are lerp'd by (s+1)/steps."""
        if not self.param_lerp_keys or all(
            k not in self.args for k in self.param_lerp_keys
        ):
            steps = 1
        out = []
        for s in range(max(1, steps)):
            params = self.lerp_params(self.args, (s + 1) / max(1, steps))
            out.append(self.step(c_start, c_end, params, token_maps))
        self.step_results = out
        return out


@_register
class ConfigLerpTransform(Transform):
    """Interpolate sampler/render config values across steps.
    ``apply`` yields one
    config dict per step with lerp_keys scaled."""

    JSON_ALIASES = ("SampleConfigTransform",)

    def __init__(self, args: Optional[dict] = None, target: Optional[dict] = None):
        super().__init__(args)
        self.target = dict(target or {})

    def to_json(self) -> dict:
        data = super().to_json()
        data["target"] = self.target
        return data

    @classmethod
    def from_json(cls, data: dict, **kwargs):
        return cls(data.get("args", {}), data.get("target", {}))

    def apply(self, steps: int = 1):
        for s in range(max(1, steps)):
            params = self.lerp_params(dict(self.target), (s + 1) / max(1, steps))
            self.step_results.append(params)
            yield params
