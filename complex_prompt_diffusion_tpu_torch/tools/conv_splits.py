"""Split-K sweep of K4's Hopper bodies at the batch-1 UNet's conv shapes, on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.conv_splits
    python -m complex_prompt_diffusion_tpu_torch.tools.conv_splits --dtype float32

For each distinct 3x3 conv of a batch-1 UNet call (UNet batch 2) it times
the Hopper body of ``--dtype`` (bf16: ``conv3x3_sm90``, split counts 1, 2,
3, 4, 6 and 8; f32: ``conv3x3_f32_sm90``, every count from 1 to 16, and the
exact decode's B1 32x32 512->512 too) with the split count forced, the count
``conv3x3_plan`` chooses, and cuDNN's ``F.conv2d`` (TF32 off) on the same
tensors, each a CUDA-graph replay (``hotcold.graph_ms``), beside the card's
name and power limit. The f32 rows also give the time of one k-step of a
block, fitted from the unsplit run (waves of blocks x k-steps a block). The
constants of the plan's cost model (``ops/conv.py``) were fitted to this
sweep.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.ops.conv import (
    SM90_SMS,
    conv3x3_f32_sm90,
    conv3x3_plan,
    conv3x3_sm90,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS

SPLITS = {"bfloat16": (1, 2, 3, 4, 6, 8), "float32": tuple(range(1, 17))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(SPLITS), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_splits needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    body = conv3x3_sm90 if dt == torch.bfloat16 else conv3x3_f32_sm90
    shapes = [(2, hw, c, co) for hw, c, co in B1_UNET_CONVS]
    if dt == torch.float32:
        shapes.append((1, 32, 512, 512))
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"conv_splits: K4 {body.__name__}, ms by forced split count ({METHOD}; {card})")
    for b, hw, c, co in shapes:
        x = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(dt)
        w = ((torch.rand((co, c, 3, 3), generator=gen, device=dev) * 2 - 1) * (9 * c) ** -0.5).to(
            dt).contiguous(memory_format=torch.channels_last)
        bias = (torch.rand((co,), generator=gen, device=dev) * 0.2 - 0.1).to(dt)
        plan = conv3x3_plan(b, hw, hw, c, co, dtype=dt)
        # counts that give the same runs of k-steps as a smaller one are left out
        counts = [s for s in SPLITS[args.dtype] if s <= plan.ksteps
                  and -(-plan.ksteps // -(-plan.ksteps // s)) == s]
        row = {s: graph_ms(lambda s=s: body(x, w, bias, splits=s)) for s in counts}
        lib = graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w, bias, padding=1))
        best = min(row, key=row.get)
        planned = row.get(plan.splits)
        if planned is None:
            planned = graph_ms(lambda: body(x, w, bias))
        fit = ""
        if dt == torch.float32:
            waves = math.ceil(plan.m_tiles * plan.n_tiles / SM90_SMS)
            fit = f", unsplit {1e3 * row[1] / (waves * plan.ksteps):.3f} us a k-step of a block"
        print(f"  B{b} {hw}x{hw} {c}->{co}: " + " ".join(f"s{s}={t:.4f}" for s, t in row.items())
              + f" | plan s{plan.splits} ({planned:.4f}, {100 * (planned / row[best] - 1):.1f}% "
              f"over best s{best}){fit}, cuDNN {lib:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
