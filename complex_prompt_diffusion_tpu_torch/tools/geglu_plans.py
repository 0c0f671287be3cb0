"""Tile-width and split-K sweep of K2 at the render's GEGLU FF shapes, on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.geglu_plans
    python -m complex_prompt_diffusion_tpu_torch.tools.geglu_plans --dtype float32

For each (M, C) of ``kernel_cases.GEGLU_ROWS`` (the b4 step's four levels
at UNet batch 8, then the b1 step's other rows at UNet batch 2) it times a
whole ``geglu_ff`` call in ``--dtype`` (bf16: ``csrc/geglu_ff_sm90.cu``;
f32: ``csrc/geglu_ff_f32_sm90.cu``, one tile width a GEMM) under the plan
``geglu_plan`` chooses, and with one GEMM's choice forced at a time:
GEMM1's tile width by split count (GEMM2 as planned), then GEMM2's (GEMM1
as planned); beside the plain twin (two cuBLAS GEMMs, TF32 off, and the
elementwise GEGLU), and the planned call's device time by kernel
(``torch.profiler``: GEMM1, GEMM2, the reduces). Each time is a CUDA-graph
replay (``hotcold.graph_ms``), with the card's name and power limit. The
cost model of ``ops/mlp.py`` is checked against this sweep.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from complex_prompt_diffusion_tpu_torch.ops.mlp import (
    F32_WIDTHS1,
    F32_WIDTHS2,
    GEGLU1_WIDTHS,
    GEGLU2_WIDTHS,
    _forced_plan,
    geglu_ff,
    geglu_ff_plain,
    geglu_plan,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import GEGLU_ROWS

SPLITS = {"bfloat16": (1, 2, 3, 4, 6, 8), "float32": tuple(range(1, 17))}
WIDTHS = {"bfloat16": (GEGLU1_WIDTHS, GEGLU2_WIDTHS), "float32": (F32_WIDTHS1, F32_WIDTHS2)}


def _by_kernel(fn, calls: int = 10) -> str:
    """Device ms a call of ``fn`` by K2 kernel, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us <= 0:
            continue
        name = ("GEMM1" if "true" in e.key else "GEMM2") if "geglu_gemm" in e.key else (
            "reduce" if "splitk" in e.key or "reduce" in e.key else "other")
        by[name] = by.get(name, 0.0) + us / 1e3 / calls
    return ", ".join(f"{k} {v:.4f}" for k, v in sorted(by.items()))


def _args(dev, gen, m, c, dt):
    h4 = 4 * c

    def u(*shape, bound):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound).to(dt)

    x = torch.randn((m, c), generator=gen, device=dev).to(dt)
    return (x, u(c, 2 * h4, bound=c ** -0.5), u(2 * h4, bound=c ** -0.5),
            u(h4, c, bound=h4 ** -0.5), u(c, bound=h4 ** -0.5))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=sorted(SPLITS), default="bfloat16")
    opts = ap.parse_args(argv)
    dt = getattr(torch, opts.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("geglu_plans needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"geglu_plans: K2 {opts.dtype} ms a call by forced tile width (bn) and split count "
          f"(s) of one GEMM, the other as planned ({METHOD}; {card})")
    for m, c in GEGLU_ROWS:
        args = _args(dev, gen, m, c, dt)
        h4 = 4 * c
        plan = geglu_plan(m, c, h4, dt)
        t_plan = graph_ms(lambda: geglu_ff(*args, plan=plan))
        t_plain = graph_ms(lambda: geglu_ff_plain(*args))
        print(f"  M{m} C{c}: plan GEMM1 bn{plan.gemm1.bn} s{plan.gemm1.splits}, GEMM2 "
              f"bn{plan.gemm2.bn} "
              f"s{plan.gemm2.splits}: {t_plan:.4f} ms (device ms by kernel, profiler: "
              f"{_by_kernel(lambda: geglu_ff(*args, plan=plan))}); plain twin {t_plain:.4f} ms "
              f"({card})", flush=True)
        w1, w2 = WIDTHS[opts.dtype]
        for which, widths, ksteps in (("GEMM1", w1, plan.gemm1.ksteps),
                                      ("GEMM2", w2, plan.gemm2.ksteps)):
            rows, times = [], {}
            planned = plan.gemm1 if which == "GEMM1" else plan.gemm2
            for bn in widths:
                if bn - 64 >= (h4 if which == "GEMM1" else c):
                    continue
                cells = []
                for s in SPLITS[opts.dtype]:
                    # counts that give the same runs of k-steps as a smaller one
                    if s > ksteps or -(-ksteps // -(-ksteps // s)) != s:
                        continue
                    kw = ({"bn1": bn, "splits1": s, "bn2": plan.gemm2.bn,
                           "splits2": plan.gemm2.splits} if which == "GEMM1" else
                          {"bn1": plan.gemm1.bn, "splits1": plan.gemm1.splits, "bn2": bn,
                           "splits2": s})
                    p = _forced_plan(m, c, h4, dtype=dt, **kw)
                    times[bn, s] = graph_ms(lambda p=p: geglu_ff(*args, plan=p))
                    cells.append(f"s{s}={times[bn, s]:.4f}")
                rows.append(f"bn{bn}: " + " ".join(cells))
            best = min(times, key=times.get)
            at_plan = times.get((planned.bn, planned.splits))
            over = f"{100 * (at_plan / times[best] - 1):.1f}%" if at_plan else "not swept"
            print(f"    {which} " + " | ".join(rows) + f" | plan bn{planned.bn} "
                  f"s{planned.splits} {over} over best bn{best[0]} s{best[1]}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
