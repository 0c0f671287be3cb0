"""Weighted-prompt syntax parser: ``"a cat:2.0 a dog:1.0"``.

A copy of ``complex_prompt_diffusion_tpu/prompts/parse.py``: repeatedly split
at the first ':', take the following token as the weight (default 1.0 when
missing or unparsable); remainder text gets weight 1.0.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["parse_weighted_prompt"]


def parse_weighted_prompt(text: str) -> Tuple[List[str], List[float]]:
    """Return (subprompts, weights). An input without ':' yields itself with
    weight 1.0; empty input yields ([], [])."""
    prompts: List[str] = []
    weights: List[float] = []
    remaining = len(text)
    while remaining > 0:
        if ":" in text:
            idx = text.index(":")
            prompt = text[:idx]
            remaining -= idx
            text = text[idx + 1 :]
            idx = text.index(" ") if " " in text else len(text)
            if idx != 0:
                try:
                    weight = float(text[:idx])
                except ValueError:
                    weight = 1.0
            else:
                weight = 1.0
            remaining -= idx
            text = text[idx + 1 :]
            prompts.append(prompt)
            weights.append(weight)
        else:
            if len(text) > 0:
                prompts.append(text)
                weights.append(1.0)
            remaining = 0
    return prompts, weights
