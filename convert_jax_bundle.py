#!/usr/bin/env python3
"""Convert a bundle the JAX package saved into one the PyTorch port loads.

The JAX package's ``pipeline.save_bundle`` stores the parameter trees as an
orbax checkpoint (``params/``: an OCDBT store with orbax 0.11) beside
``meta.json``. The port's ``pipeline.load_bundle`` reads its own layout
(``params.pt`` through ``torch.save``, the same ``meta.json`` keys), and
the machines the port runs on need neither orbax nor tensorstore. So the
conversion runs on a host that has the JAX package and orbax:

    python3 convert_jax_bundle.py JAX_BUNDLE_DIR PORT_BUNDLE_DIR

It runs the JAX package's ``load_bundle``, the port's
``ModelBundle.from_jax_bundle`` (on the CPU: the weights keep their dtypes)
and the port's ``save_bundle``. This is the one file of the port that
imports jax and orbax; nothing in ``complex_prompt_diffusion_tpu_torch``
or ``chip_smoke.py`` imports it.
"""

from __future__ import annotations

import argparse
import os
import sys


def convert(src: str, dst: str, vocab_path=None):
    """Read the JAX bundle directory ``src`` and write the port's bundle to
    ``dst``; returns the port's bundle (on the CPU)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from complex_prompt_diffusion_tpu import pipeline as JP
    from complex_prompt_diffusion_tpu_torch import pipeline as P

    jb = JP.load_bundle(src, vocab_path)
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu", tokenizer=jb.tokenizer)
    P.save_bundle(pb, dst)
    return pb


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="a directory the JAX package's save_bundle wrote")
    ap.add_argument("dst", help="the directory to write the port's bundle to")
    ap.add_argument("--vocab", default=None, help="the CLIP BPE vocabulary, if not the default")
    args = ap.parse_args(argv)
    pb = convert(args.src, args.dst, args.vocab)
    print(f"converted {args.src} -> {args.dst}: version {pb.version}, "
          f"UNet {pb.unet_cfg.model_channels} channels, {pb.unet_cfg.dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
