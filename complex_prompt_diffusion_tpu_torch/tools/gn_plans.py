"""Form and tile sweep of K3 (``csrc/groupnorm_sm90.cu``) at the render's
GroupNorm shapes, on the card, with L2-hot and L2-cold times.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.gn_plans

For every shape of ``kernel_cases.GN_UNET_PLANES`` at UNet batch 8 (the b4
step) and 2 (the b1 step) in bf16, and of ``GN_DECODE_PLANES`` at batch 1
and 4 (bf16) and 4 (f32), it times a whole ``group_norm_nhwc`` call
(GroupNorm + SiLU) under the plan ``group_norm_plan`` chooses, then under
the slab form's three fewest group counts a block (g) and the split form at
a half, one and two times the planned tiles a sample (s), each a CUDA-graph
replay with the L2 hot (``hotcold.graph_ms``). The planned call and the
replaced body (``group_norm_prior``) are also timed cold
(``hotcold.hot_cold_ms``: input sets in rotation that exceed twice the L2),
and the 61 calls of a b4 and of a b1 step are summed over the UNet shapes,
hot and cold, for both bodies. Every line carries the card's name and power
limit. The plan's rule is checked against this sweep.
"""

from __future__ import annotations

import subprocess

import torch

from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    GnPlan,
    group_norm_nhwc,
    group_norm_plan,
    group_norm_prior,
    slab_groups,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms, hot_cold_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
    GN_B4_CALLS,
    GN_DECODE_PLANES,
    GN_UNET_PLANES,
    HBM_BYTES_PER_S,
)


def _shapes():
    bf16, f32 = torch.bfloat16, torch.float32
    out = [((b, side, side, c), bf16) for b in (8, 2) for side, c in GN_UNET_PLANES]
    for b, dt in ((1, bf16), (4, bf16), (4, f32)):
        out += [((b, side, side, c), dt) for side, c in GN_DECODE_PLANES]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gn_plans needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"gn_plans: K3 ms a call (GroupNorm + SiLU) by plan, {METHOD}, L2 hot, then the "
          f"planned call and the replaced body L2 hot / cold; bound = 1 read + 1 write at "
          f"3.35 TB/s ({sms} SMs; {card})")
    sums = {}  # UNet batch -> [K3 hot, K3 cold, replaced hot, replaced cold], over 61 calls
    with torch.inference_mode():
        for shape, dt in _shapes():
            n, h, w, c = shape
            hw = h * w

            def make(i, shape=shape, dt=dt, c=c):
                gen = torch.Generator(device=dev).manual_seed(i)
                x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dt)
                gamma = (torch.randn(c, generator=gen, device=dev) * 0.5 + 1).to(dt)
                beta = (torch.randn(c, generator=gen, device=dev) * 0.5).to(dt)
                return x, gamma, beta

            sets = [make(0)]
            x, gamma, beta = sets[0]
            esize = x.element_size()
            plan = group_norm_plan(n, hw, c, 32, dt, sms)
            plans = [GnPlan("slab", k, 1) for k in slab_groups(hw, c, 32, esize)[:3]]
            t0 = max(1, sms // n)
            plans += [GnPlan("split", t, 2) for t in dict.fromkeys((max(1, t0 // 2), t0, 2 * t0))
                      if t <= hw]
            cells = []
            for p in plans:
                ms = graph_ms(lambda p=p: group_norm_nhwc(x, gamma, beta, 32, 1e-6, True, plan=p))
                tag = f"g{p.tiles}" if p.form == "slab" else f"s{p.tiles}"
                cells.append(f"{tag}{'*' if p == plan else ''}={ms:.4f}")
            nbytes = 2.0 * x.numel() * esize
            new = hot_cold_ms(make, lambda *a: group_norm_nhwc(*a, 32, 1e-6, True), nbytes, sets)
            old = hot_cold_ms(make, lambda *a: group_norm_prior(*a, 32, 1e-6, True), nbytes, sets)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            name = "bf16" if dt == torch.bfloat16 else "f32"
            print(f"  {name} {'x'.join(map(str, shape))}: {' '.join(cells)} (* = planned); "
                  f"planned hot / cold {new.hot_ms:.4f} / {new.cold_ms:.4f}; replaced body "
                  f"{old.hot_ms:.4f} / {old.cold_ms:.4f}; bound {bound:.4f} ({card})", flush=True)
            if (h, c) in GN_UNET_PLANES and dt == torch.bfloat16 and n in (8, 2):
                calls = GN_B4_CALLS[GN_UNET_PLANES.index((h, c))]
                row = (new.hot_ms, new.cold_ms, old.hot_ms, old.cold_ms)
                sums[n] = [a + calls * b for a, b in zip(sums.get(n, [0.0] * 4), row)]
            del x, gamma, beta, sets
            torch.cuda.empty_cache()
    for ub, step in ((8, "b4"), (2, "b1")):
        s = sums[ub]
        print(f"gn_plans: the {sum(GN_B4_CALLS)} GroupNorms of a {step} CFG step (UNet batch "
              f"{ub}): K3 hot / cold {s[0]:.4f} / {s[1]:.4f} ms, replaced body "
              f"{s[2]:.4f} / {s[3]:.4f} ms ({card})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
