"""Split-K sweep of K4's sm90 body at the batch-1 UNet's conv shapes, on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.conv_splits

For each distinct 3x3 conv of a batch-1 UNet call (UNet batch 2) it times
``conv3x3_sm90`` with the split count forced to 1, 2, 3, 4, 6 and 8, the
count ``conv3x3_plan`` chooses, and cuDNN's ``F.conv2d`` (TF32 off) on the
same tensors, each a CUDA-graph replay (``hotcold.graph_ms``), beside the
card's name and power limit. The constants of the plan's cost model
(``ops/conv.py``) were fitted to this sweep.
"""

from __future__ import annotations

import subprocess

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3_plan, conv3x3_sm90
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS

SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("conv_splits needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"conv_splits: K4 sm90 body, ms by forced split count ({METHOD}; {card})")
    for hw, c, co in B1_UNET_CONVS:
        x = torch.randn((2, hw, hw, c), generator=gen, device=dev).to(torch.bfloat16)
        w = ((torch.rand((co, c, 3, 3), generator=gen, device=dev) * 2 - 1) * (9 * c) ** -0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        b = (torch.rand((co,), generator=gen, device=dev) * 0.2 - 0.1).to(torch.bfloat16)
        plan = conv3x3_plan(2, hw, hw, c, co)
        row = {s: graph_ms(lambda s=s: conv3x3_sm90(x, w, b, splits=s)) for s in SPLITS}
        lib = graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1))
        best = min(row, key=row.get)
        print(f"  B2 {hw}x{hw} {c}->{co}: " + " ".join(f"s{s}={t:.4f}" for s, t in row.items())
              + f" | plan s{plan.splits} ({row.get(plan.splits, float('nan')):.4f}), best s{best},"
              f" cuDNN {lib:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
