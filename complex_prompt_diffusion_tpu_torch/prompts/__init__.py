"""Prompt algebra — the framework's namesake feature (host-side).

Counterpart of ``complex_prompt_diffusion_tpu/prompts``: prompt objects stay
host-side Python and compile down to a fixed-shape
:class:`~..guidance.GuidanceSpec` (stacked factor embeddings, scales, masks)
on the bundle's device, so the sampling loop never sees Python objects.

Components:
  * tokenizer — CLIP BPE (vocab files) with a deterministic fallback
  * parse — "a cat:2.0 a dog:1.0" weighted-prompt syntax
  * masks — the programmatic spatial-mask DSL ("left_third_valid", ...)
  * interp — slerp/lerp/plerp/bleed embedding interpolation
  * schedule — the "[a:b:0.5]" scheduled/alternating prompt grammar (a
    hand-written parser; the JAX package's uses lark)
  * compose — ComplexPrompt / WeightedPrompt / CompositionalPrompt
  * transforms — embedding transform paths (LerpCLIP, sequences, configs)
"""

from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import (
    ClipBPETokenizer,
    HashTokenizer,
    get_tokenizer,
)
from complex_prompt_diffusion_tpu_torch.prompts.parse import parse_weighted_prompt
from complex_prompt_diffusion_tpu_torch.prompts.masks import make_mask
from complex_prompt_diffusion_tpu_torch.prompts.interp import slerp, lerp, plerp, bleed
from complex_prompt_diffusion_tpu_torch.prompts.schedule import (
    get_prompt_sequence,
    expand_schedule,
)
from complex_prompt_diffusion_tpu_torch.prompts.compose import (
    ComplexPrompt,
    WeightedPrompt,
    CompositionalPrompt,
)

__all__ = [
    "ClipBPETokenizer",
    "HashTokenizer",
    "get_tokenizer",
    "parse_weighted_prompt",
    "make_mask",
    "slerp",
    "lerp",
    "plerp",
    "bleed",
    "get_prompt_sequence",
    "expand_schedule",
    "ComplexPrompt",
    "WeightedPrompt",
    "CompositionalPrompt",
]
