"""A/B of source trees of the port on one card, each run in a process of its own.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.tree_ab --what render_b1 \\
        --tree parent=scratch_tree/parent --tree new=.
    python -m complex_prompt_diffusion_tpu_torch.tools.tree_ab --what kernels:conv3x3 \\
        --tree new=. --tree variant=scratch_tree/variant

Each ``--tree NAME=DIR`` is a checkout of the repository (``DIR`` holds
``complex_prompt_diffusion_tpu_torch/``; copies go in a directory that
``.gitignore`` lists, such as an unpacked ``git archive`` of the parent
commit). Every run is a fresh Python process whose import path starts with
its tree, so it builds that tree's kernels into that tree's ``build/`` and
runs that tree's code; nothing is swapped inside a process. Runs go forward
and back over the trees (A B B A for two, A B C C B A for three), repeated
``--rounds`` times. Workloads:

* ``kernels:NAME[,NAME]``: the phase-1 cases of ``chip_smoke.py`` (the
  ``kernel_cases`` beside this file, calling each tree's wrappers), each
  checked against its plain twin, then timed as phase 1 times it
  (``hotcold.graph_ms`` beside this file: a CUDA graph of 20 launches
  replayed after two eager warm-ups); a case whose dtype a tree's wrapper
  rejects is left out of the comparison. The cases' inputs come from one
  seed, so each output's SHA-256 is compared across trees too: the line
  says whether every tree wrote the same bits;
* ``render_b1``: phase 4 of ``chip_smoke.py`` after a 3-step warm-up render:
  SD-1.5 with random weights (seed 0), txt2img 512x512, batch 1, DDIM 50,
  CFG 7.5, bf16 VAE decode; seconds to first image and s/step as phase 4
  times them, then ``--iters`` steady CFG steps: wall ms a step without the
  profiler, and device-busy ms a step (the sum of the kernels' device times
  under ``torch.profiler``), so wall minus busy is the time the card waits
  for the host.

It prints every run's numbers, then for each number the minimum and median
over each tree's runs, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

_TAG = "tree_ab-result "
_RUN_TIMEOUT_S = 900  # one run: a kernel build and a 50-step render take ~1 min
TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |kernel - plain| / max |plain|


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _kernels(names) -> tuple:
    import hashlib

    import torch
    from hotcold import graph_ms  # beside this file, on sys.path[0]
    from kernel_cases import kernel_cases

    out, hashes = {}, {}
    for case in kernel_cases(torch.device("cuda"), names):
        try:
            got = case.run().float()
        except TypeError as e:  # a dtype this tree's kernel does not take
            print(f"{case.kernel} {case.label}: not run ({e})", flush=True)
            continue
        hashes[f"{case.kernel} {case.label}"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()
        want = case.plain().float()
        rel = float((got - want).abs().max() / want.abs().max())
        if not rel <= TOL[case.dtype]:
            raise SystemExit(f"{case.kernel} {case.label}: relative error {rel:.3e}")
        del got, want
        out[f"{case.kernel} {case.label} ms"] = graph_ms(case.run)
        torch.cuda.empty_cache()
    return out, hashes


def _render_b1(iters: int) -> dict:
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.guidance import cfg_epsilon, stacked_context
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        decode_latents,
        make_guidance_spec,
        txt2img,
    )

    dev = torch.device("cuda")
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast_vae("bfloat16")
    prompt = "a watercolor painting of a lighthouse at dusk"

    def render(steps):
        cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                           width=512, height=512, batch_size=1, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, latents = txt2img(bundle, prompt, cfg=cfg, decode=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode_latents(bundle, latents)
        torch.cuda.synchronize()
        return t0, t1, time.perf_counter(), latents

    render(3)
    t0, t1, t2, latents = render(50)
    out = {"s to first image": t2 - t0, "s/step": (t1 - t0) / 50}

    spec = make_guidance_spec(bundle, prompt)
    t = torch.tensor(801, device=dev)
    scale = torch.tensor(7.5, device=dev)
    with torch.inference_mode():
        cross_kv = M.precompute_cross_kv(bundle.unet_cfg, bundle.unet_params,
                                         stacked_context(spec, 1))

        def step():
            return cfg_epsilon(lambda xx, tt, ctx: M.unet_apply(
                bundle.unet_cfg, bundle.unet_params, xx, tt, ctx, cross_kv=cross_kv),
                latents, t, spec, scale, gcfg=RenderConfig().guidance)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        out["steady wall ms/step"] = 1e3 * (time.perf_counter() - t0) / iters
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out["device busy ms/step"] = busy_us / 1e3 / iters
    return out


def _child(args) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tree_ab needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hashes = {}
    if args.what == "render_b1":
        out = _render_b1(args.iters)
    elif args.what.startswith("kernels:"):
        out, hashes = _kernels(args.what.split(":", 1)[1].split(","))
    else:
        raise SystemExit(f"unknown workload {args.what!r}")
    print(_TAG + json.dumps({"numbers": out, "hashes": hashes}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR",
                    help="a checkout to run (two or more)")
    ap.add_argument("--what", default="render_b1", help="render_b1 or kernels:NAME[,NAME]")
    ap.add_argument("--rounds", type=int, default=2, help="forward-and-back passes")
    ap.add_argument("--iters", type=int, default=10, help="steady steps a timing (render_b1)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args)

    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) < 2:
        raise SystemExit("give two or more --tree NAME=DIR")
    for name, d in trees.items():
        if not (Path(d) / "complex_prompt_diffusion_tpu_torch").is_dir():
            raise SystemExit(f"tree {name}: no complex_prompt_diffusion_tpu_torch/ under {d}")
    card = _card()
    names = list(trees)
    order = (names + names[::-1]) * args.rounds
    print(f"tree_ab {args.what} on {card}: runs {' '.join(order)}", flush=True)
    results = {n: [] for n in names}
    hashes = {n: [] for n in names}
    for name in order:
        root = str(Path(trees[name]).resolve())
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child", "--what", args.what,
             "--iters", str(args.iters)],
            cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
            timeout=_RUN_TIMEOUT_S,
        )
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(_TAG)]
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"run of {name} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        res = json.loads(lines[-1][len(_TAG):])
        hashes[name].append(res["hashes"])
        res = res["numbers"]
        results[name].append(res)
        print(f"  {name}: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()), flush=True)
    print(f"tree_ab {args.what}: min / median over {2 * args.rounds} runs of each tree ({card})")
    shared = set.intersection(*(set(r) for runs in results.values() for r in runs))
    for key in (k for k in results[names[0]][0] if k in shared):
        cells = []
        for n in names:
            vals = [r[key] for r in results[n]]
            cells.append(f"{n} {min(vals):.4f} / {statistics.median(vals):.4f}")
        print(f"  {key:40s} " + "   ".join(cells))
    runs = [h for n in names for h in hashes[n]]
    for key in (k for k in runs[0] if all(k in h for h in runs)):
        same = len({h[key] for h in runs}) == 1
        print(f"  {key:40s} output bits {'identical in every run' if same else 'DIFFER'} "
              f"({runs[0][key][:16]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
