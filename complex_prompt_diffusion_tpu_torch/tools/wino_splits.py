"""Split sweep of K6's Hopper bodies at phase 9's ResBlock conv shapes, on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.wino_splits --dtype float32
    python -m complex_prompt_diffusion_tpu_torch.tools.wino_splits --dtype bfloat16

For each distinct 3x3 conv of phase 9 (UNet batch 2; f32 also the exact
decode's B1 32x32 512->512) it times the Hopper body of ``--dtype`` (bf16:
``wino3x3_sm90``, f32: ``wino3x3_f32_sm90``) with the split count of C
forced, every count from 1 to 16 that gives distinct runs of chunks, with U
made ahead, then the count ``wino3x3_plan`` chooses, K4 (``conv3x3``) and
cuDNN's ``F.conv2d`` (TF32 off) on the same tensors, each a CUDA-graph
replay (``hotcold.graph_ms``), beside the card's name and power limit. Each
row also gives the time of one chunk of a block, fitted from the unsplit
run (waves of blocks x chunks a block). The chunk weights
``_CHUNK_WEIGHT_US`` of the plan's cost model (``ops/probes/winograd.py``)
come from this sweep: the bf16 one is that time, the f32 one a weight
fitted to the picks (at which the plan picks the fastest split, within 1%,
at every shape swept), not a time.
"""

from __future__ import annotations

import argparse
import math
import subprocess

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.ops.conv import conv3x3
from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
    SM90_SMS,
    wino3x3_f32_sm90,
    wino3x3_plan,
    wino3x3_sm90,
    winograd_weights,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import B1_UNET_CONVS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wino_splits needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    dt = getattr(torch, args.dtype)
    body = wino3x3_f32_sm90 if dt == torch.float32 else wino3x3_sm90
    shapes = [(2, hw, c, co) for hw, c, co in dict.fromkeys(B1_UNET_CONVS)]
    if dt == torch.float32:
        shapes.append((1, 32, 512, 512))
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"wino_splits: K6 {body.__name__}, ms by forced split count ({METHOD}; {card})")
    with torch.inference_mode():
        for b, hw, c, co in shapes:
            x = torch.randn((b, hw, hw, c), generator=gen, device=dev).to(dt)
            k = ((torch.rand((3, 3, c, co), generator=gen, device=dev) * 2 - 1)
                 * (9 * c) ** -0.5).to(dt)
            bias = (torch.rand((co,), generator=gen, device=dev) * 0.2 - 0.1).to(dt)
            u = winograd_weights(k).to(dt)
            w = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            plan = wino3x3_plan(b, hw, hw, c, co, dtype=dt)
            # counts that give the same runs of chunks as a smaller one are left out
            counts = [s for s in range(1, 17) if s <= plan.kchunks
                      and -(-plan.kchunks // -(-plan.kchunks // s)) == s]
            row = {s: graph_ms(lambda s=s: body(x, k, bias, u=u, splits=s)) for s in counts}
            best = min(row, key=row.get)
            planned = row.get(plan.splits)
            if planned is None:
                planned = graph_ms(lambda: body(x, k, bias, u=u))
            k4 = graph_ms(lambda: conv3x3(x, w, bias))
            lib = graph_ms(lambda: F.conv2d(x.permute(0, 3, 1, 2), w, bias, padding=1))
            waves = math.ceil(plan.m_blocks * plan.n_blocks / SM90_SMS)
            sweep = " ".join(f"s{s}={t:.4f}" for s, t in row.items())
            print(f"  B{b} {hw}x{hw} {c}->{co}: {sweep} | plan s{plan.splits} ({planned:.4f}, "
                  f"{100 * (planned / row[best] - 1):.1f}% over best s{best}), unsplit "
                  f"{1e3 * row[1] / (waves * plan.kchunks):.3f} us a chunk of a block, K4 "
                  f"{k4:.4f}, cuDNN {lib:.4f} ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
