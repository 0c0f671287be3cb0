"""A synthetic byte-level BPE vocab (the one tests/test_tokenizer_native.py
builds) and a fixed corpus over it, for holding the native tokenizer to
the Python one without CLIP's vocab files.

The corpus has lower-case non-ASCII letters only and no HTML entities: the
C++ core takes any non-ASCII character for a letter, lower-cases ASCII
only and does not unescape entities (the Python tokenizers' ``_clean``
does), so those are where the two differ by design.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np

from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import bytes_to_unicode

MERGES = (("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>"), ("d", "o"),
          ("do", "g</w>"), ("a", "n"), ("an", "d</w>"), ("1", "2"), ("o", "f</w>"))
PIECES = ("the", "cat", "and", "dog", "of", "an", "a", "12", "7", "!", "...", ",", "(", ")",
          "'s", "'ll", "-", "_", "café", "über", "THE", "Cat", "  ", " ", "\t", "x9y",
          "naïve", "lighthouse", "sunset")


def write_synthetic_vocab(directory) -> Tuple[str, str]:
    """Write ``vocab.json`` (every byte unit, alone and word-final, the
    merged pairs, BOS and EOS) and ``merges.txt`` into ``directory``;
    returns their paths."""
    d = Path(directory)
    units = list(bytes_to_unicode().values())
    vocab = (units + [u + "</w>" for u in units] + [a + b for a, b in MERGES]
             + ["<|startoftext|>", "<|endoftext|>"])
    (d / "vocab.json").write_text(json.dumps({tok: i for i, tok in enumerate(vocab)}))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES))
    return str(d / "vocab.json"), str(d / "merges.txt")


def corpus(n: int, seed: int = 0, most: int = 14) -> List[str]:
    """``n`` strings of 1 to ``most - 1`` pieces each, from ``seed``."""
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(PIECES, size=rng.integers(1, most))) for _ in range(n)]
