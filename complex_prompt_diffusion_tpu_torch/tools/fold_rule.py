"""The fold rule of the 3xTF32 GEMM bodies (``csrc/tf32x3.cuh``: ``kFold``), on the card.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.fold_rule

A GEMM body of K2 and K4 in f32 takes ``kFold`` k-steps (32 reduction
elements each) into a fresh wgmma accumulator, then adds it into an f32 sum.
For each run length (1, 2, 4 and 8 k-steps, and one run of the whole
reduction) this copies the package into ``build/fold_rule/`` with ``kFold``
set to it, and runs, in a process of that copy's own (which builds its
kernels), the longest reductions of a UNet on the f32 bodies:

* K4's 16x16 2560->1280 conv at UNet batch 2 (K = 9C = 23040), unsplit
  (one unit sums all 720 k-steps) and with ``conv3x3_plan``'s splits;
* K2 at M512 C1280 (GEMM2 reduces over H4 = 5120), both GEMMs unsplit, and
  as ``geglu_plan`` plans it.

Each case prints its error against the TF32-off twin (max |kernel - twin| /
max |twin|), whether a second call wrote the same bits, and its time
(``hotcold.graph_ms``), beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_OUT = _PKG / "build" / "fold_rule"
_TAG = "fold_rule-result "
_WHOLE = 1 << 30  # a run longer than any reduction: one accumulator for all of K
RUNS = (1, 2, 4, 8, _WHOLE)
_RUN_TIMEOUT_S = 600  # one run: a kernel build and eight timings


def _child() -> int:
    import torch

    from complex_prompt_diffusion_tpu_torch.ops import conv as C
    from complex_prompt_diffusion_tpu_torch.ops import mlp as F2
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import graph_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23040)

    def u(*shape, bound):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * bound

    def measure(fn, want):
        got = fn()
        return (float((got - want).abs().max() / want.abs().max()),
                bool(torch.equal(got, fn())), graph_ms(fn))

    out = {}
    x = torch.randn((2, 16, 16, 2560), generator=gen, device=dev)
    w = u(1280, 2560, 3, 3, bound=(9 * 2560) ** -0.5).contiguous(
        memory_format=torch.channels_last)
    b = u(1280, bound=0.1)
    want = C.conv3x3_plain(x, w, b)
    planned = C.conv3x3_plan(2, 16, 16, 2560, 1280, dtype=torch.float32).splits
    for splits in (1, planned):
        key = f"K4 f32 B2 16x16 2560->1280 (K 23040) s{splits}"
        out[key] = measure(lambda: C.conv3x3_f32_sm90(x, w, b, splits=splits), want)
    m, c, h4 = 512, 1280, 5120
    args = (torch.randn((m, c), generator=gen, device=dev), u(c, 2 * h4, bound=c ** -0.5),
            u(2 * h4, bound=c ** -0.5), u(h4, c, bound=h4 ** -0.5), u(c, bound=h4 ** -0.5))
    want = F2.geglu_ff_plain(*args)
    plan = F2.geglu_plan(m, c, h4, torch.float32)
    for name, p in (("unsplit", F2._forced_plan(m, c, h4, splits1=1, splits2=1,
                                                dtype=torch.float32)),
                    (f"s{plan.gemm1.splits}/s{plan.gemm2.splits}", plan)):
        key = f"K2 f32 M512 C1280 (K 1280, 5120) {name}"
        out[key] = measure(lambda p=p: F2.geglu_ff_f32_sm90(*args, plan=p), want)
    print(_TAG + json.dumps(out), flush=True)
    return 0


def _tree(run: int) -> Path:
    """A copy of the package with kFold = ``run``; returns the copy's root."""
    root = _OUT / f"fold{run}"
    dst = root / _PKG.name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_PKG, dst, ignore=shutil.ignore_patterns("build", "__pycache__"))
    hdr = dst / "csrc" / "tf32x3.cuh"
    text, n = re.subn(r"constexpr int kFold = \d+;", f"constexpr int kFold = {run};",
                      hdr.read_text())
    if n != 1:
        raise SystemExit(f"{hdr}: no single 'constexpr int kFold = N;' to set")
    hdr.write_text(text)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    if ap.parse_args(argv).child:
        return _child()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"fold_rule: error against the TF32-off twin and ms (CUDA-graph replay) by run "
          f"length, k-steps of 32 a fresh accumulator takes ({card})", flush=True)
    for run in RUNS:
        root = _tree(run)
        proc = subprocess.run([sys.executable, "-m", f"{_PKG.name}.tools.fold_rule", "--child"],
                              cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                              capture_output=True, text=True, timeout=_RUN_TIMEOUT_S)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(_TAG)]
        if proc.returncode != 0 or not lines:
            raise SystemExit(f"run {run} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        label = "whole K" if run == _WHOLE else f"{run}"
        for key, (err, same, ms) in json.loads(lines[-1][len(_TAG):]).items():
            print(f"  run {label:>7}: {key}: rel {err:.3e}, "
                  f"{'same' if same else 'OTHER'} bits twice, {ms:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
