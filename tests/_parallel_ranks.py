"""Rank programs of the parallel tests: each runs in a process that
``torch.multiprocessing`` spawns (gloo, ``file://`` rendezvous in a fresh
directory of a test's temporary directory) and writes what it found to
``rank<r>.pt`` there.

This module imports no jax (the spawned ranks import it, not the test
files), so a rank starts in about the time torch takes to import.
"""

import os
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(fn, n: int, tmp: str, *args, timeout: float = 120.0) -> list:
    """Run ``fn(rank, n, tmp, *args)`` on ``n`` spawned gloo ranks; return
    each rank's result (what it returned), failing on a rank's error or
    when the ranks outlast ``timeout`` seconds (the processes are killed)."""
    # a fresh rendezvous file a spawn: a world's file left behind would hand
    # the next world its dead ranks' addresses
    rendezvous = tempfile.mkdtemp(dir=tmp, prefix="rendezvous-")
    ctx = mp.start_processes(_main, args=(fn, n, tmp, rendezvous) + args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{fn.__name__} on {n} ranks outlasted {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(n)]


def with_biases(tree, seed: int):
    """``tree`` (a UNet tree of dicts and lists, numpy or JAX leaves) with
    every ``bias`` leaf drawn from N(0, 0.05^2) (numpy, ``seed``, in walk
    order): the init's zero biases would hide a bias added on every rank."""
    rng = np.random.default_rng(seed)

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return (0.05 * rng.standard_normal(t.shape)).astype(t.dtype) if key == "bias" else t

    return walk(tree)


def _main(rank, fn, n, tmp, rendezvous, *args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(rendezvous, 'file')}",
                            rank=rank, world_size=n)
    try:
        out = fn(rank, n, tmp, *args)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _bundle(tmp):
    """The port bundle the test saved under ``tmp/bundle``: read by rank 0,
    broadcast to the others (``replicate``)."""
    from complex_prompt_diffusion_tpu_torch import pipeline as P
    from complex_prompt_diffusion_tpu_torch.parallel import make_mesh, replicate

    b = P.load_bundle(os.path.join(tmp, "bundle"), device="cpu") if dist.get_rank() == 0 else None
    return replicate(make_mesh(), b)


def _render(bundle, prompt, cfg_kw, x_T):
    """txt2img's latents with ``RenderConfig(**cfg_kw)`` from ``x_T``, and
    the all-reduces of each UNet call (through the models package and
    inside ``models/unet.py``, where DeepCache's pair calls it)."""
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import pipeline as P
    from complex_prompt_diffusion_tpu_torch.models import unet as U

    counts = []
    inner = U.unet_apply

    def counted(*a, **kw):
        shard = kw.get("shard")
        before = shard.all_reduces if shard is not None else 0
        out = inner(*a, **kw)
        counts.append((shard.all_reduces if shard is not None else 0) - before)
        return out

    M.unet_apply = U.unet_apply = counted
    try:
        _, lat = P.txt2img(bundle, prompt, cfg=P.RenderConfig(**cfg_kw), x_T=x_T, decode=False)
    finally:
        M.unet_apply = U.unet_apply = inner
    return lat, counts


def tp_render(rank, n, tmp, model, conv_split=False):
    """The tiny bundle tensor-parallel over ``model`` ranks (data = n /
    model): the latents, the all-reduces of every UNet call, the applied
    spec tree and the JAX rule's."""
    from complex_prompt_diffusion_tpu_torch.parallel import make_mesh
    from complex_prompt_diffusion_tpu_torch.parallel.tp import shard_bundle, unet_tp_shardings

    b = _bundle(tmp)
    mesh = make_mesh(model=model)
    tb = shard_bundle(b, mesh, conv_split=conv_split)
    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    lat, counts = _render(tb, inp["prompt"], inp["cfg"], inp["x_T"])
    return {"lat": lat, "counts": counts, "specs": tb.shard.specs,
            "jax_rule": unet_tp_shardings(b.unet_params, mesh, conv_split=conv_split),
            "q_width": tb.unet_params["input_blocks"][1][1]["blocks"][0]["attn1"]["to_q"][
                "kernel"].shape[1]}


def two_rank_suite(rank, n, tmp):
    """Every two-rank case in one world: TP at model 2 (and with
    conv_split, and with DeepCache), DP at data 2 (b4, each rank two), the
    tiled render with its tiles over data 2, and the spec trees."""
    from complex_prompt_diffusion_tpu_torch import pipeline as P
    from complex_prompt_diffusion_tpu_torch.parallel import gather_batch, make_mesh, shard_batch
    from complex_prompt_diffusion_tpu_torch.parallel.tp import shard_bundle, unet_tp_shardings

    inp = torch.load(os.path.join(tmp, "inputs.pt"))
    prompt, x_1 = inp["prompt"], inp["x_T"][:1]
    b = _bundle(tmp)
    out = {}
    tp_mesh = make_mesh(model=2)
    for key, split in (("tp2", False), ("tp2_conv_split", True)):
        tb = shard_bundle(b, tp_mesh, conv_split=split)
        lat, counts = _render(tb, prompt, inp["cfg"], x_1)
        out[key] = {"lat": lat, "counts": counts, "specs": tb.shard.specs,
                    "jax_rule": unet_tp_shardings(b.unet_params, tp_mesh, conv_split=split)}
    # DeepCache on the sharded bundle: the shallow passes run the sharded sites too
    lat, counts = _render(shard_bundle(b, tp_mesh), prompt, inp["deepcache_cfg"], x_1)
    out["tp2_deepcache"] = {"lat": lat, "counts": counts}
    dp_mesh = make_mesh(data=2)
    db = shard_bundle(b, dp_mesh)
    lat, counts = _render(db, prompt, dict(inp["cfg"], batch_size=2),
                          shard_batch(dp_mesh, inp["x_T"]))
    out["dp2"] = {"local": lat, "lat": gather_batch(dp_mesh, lat), "counts": counts}
    out["tiled_dp2"] = {"lat": P.sample_latents(db, P.make_guidance_spec(db, prompt),
                                                P.RenderConfig(**inp["tiled_cfg"]),
                                                x_init=inp["x_tiled"])}
    return out
