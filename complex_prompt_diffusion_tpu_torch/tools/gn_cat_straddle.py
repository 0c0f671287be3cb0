"""What the a/b boundary costs K3's two-source slab form
(``ops.groupnorm.group_norm_silu_cat``), on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.gn_cat_straddle

At C = Ca + Cb = 1920 (32 groups of 60 channels, two groups a slab block:
120 channels) on the 16^2 and 24^2 planes of a UNet-batch-2 call, it moves
the boundary: Ca = 1280 and 640 put it inside a block (that block takes a
TMA box of each source), Ca = 1200, 1320 and 1440 between blocks. For each
it times the planned two-source call, the split form (the body the slab
replaced where it fits) and the one-input K3 on the materialized concat,
each a CUDA-graph replay with the L2 hot (``hotcold.graph_ms``), and holds
the two-source result to its plain twin. Every line carries the card's name
and power limit.
"""

from __future__ import annotations

import subprocess

import torch

from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    GnPlan,
    group_norm_cat_plan,
    group_norm_nhwc,
    group_norm_silu_cat,
    group_norm_silu_cat_plain,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms

C = 1920
SPLITS = (1280, 640, 1200, 1320, 1440)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gn_cat_straddle needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"gn_cat_straddle: K3 two-source ms a call (GroupNorm + SiLU, bf16), {METHOD}, L2 hot "
          f"({card})")
    for n, side in ((2, 16), (2, 24)):
        x = (2 * torch.randn((n, side, side, C), generator=gen, device=dev) + 0.5).to(
            torch.bfloat16)
        gamma = (1 + 0.5 * torch.randn(C, generator=gen, device=dev)).to(torch.bfloat16)
        beta = (0.5 * torch.randn(C, generator=gen, device=dev)).to(torch.bfloat16)
        for ca in SPLITS:
            a, b = x[..., :ca].contiguous(), x[..., ca:].contiguous()
            plan = group_norm_cat_plan(n, side * side, ca, C - ca, 32, sms)
            kc = plan.tiles * (C // 32)
            straddles = plan.form == "slab" and ca % kc != 0
            got = torch.cat(group_norm_silu_cat(a, b, gamma, beta), -1).float()
            want = torch.cat(group_norm_silu_cat_plain(a, b, gamma, beta), -1).float()
            rel = float((got - want).abs().max() / want.abs().max())
            split = GnPlan("split", max(1, min(sms // n, side * side)), 2)
            ms = graph_ms(lambda: group_norm_silu_cat(a, b, gamma, beta))
            split_ms = graph_ms(lambda: group_norm_silu_cat(a, b, gamma, beta, plan=split))
            one_ms = graph_ms(lambda: group_norm_nhwc(x, gamma, beta, 32, 1e-5, True))
            print(f"  {n}x{side}x{side} ({ca} | {C - ca}): plan {plan.form} {plan.tiles}, a block "
                  f"straddling the boundary: {straddles}; rel {rel:.3e}; two-source {ms:.4f} ms, "
                  f"split form {split_ms:.4f} ms, one input on the concat "
                  f"{one_ms:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
