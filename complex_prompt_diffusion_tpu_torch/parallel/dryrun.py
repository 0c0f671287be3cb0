"""One sharded training step over n ranks: the multi-rank dry run.

Counterpart of ``__graft_entry__.py``'s ``dryrun_multichip`` in the JAX
package, which jits one training step on an n-device ("data", "model")
mesh. The port's ranks are processes: :func:`dryrun_multichip` spawns n
gloo ranks on the CPU (``file://`` rendezvous in a temporary directory),
each of which

  * builds the mesh: model = 2 when n >= 4 and even, else 1; data = n /
    model;
  * takes the f32 ``UNetConfig.tiny(context_dim=32)`` weights, biases
    drawn nonzero, from rank 0 (``replicate``) and its tensor-parallel shards (``shard_unet_params``);
  * runs one Adan step of ``train.make_train_step(..., shard=)``: the
    batch split over "data", autograd through the UNet's model-group
    all-reduces (Megatron's pair, ``ShardCtx.enter`` / ``all_reduce``),
    the gradients averaged over "data" (``tp.reduce_grads``);
  * holds the loss and the gradients (made whole: gathered from the model
    group) to one process's on the whole batch and model (rank 0 computes
    them; rtol 1e-4, atol 1e-4 of the largest gradient), and checks
    that the step moved the weights and its loss is finite.

Rank 0 prints ``dryrun_multichip ok: mesh=(DxM) ...``; a failed rank makes
the call raise.

    python -m complex_prompt_diffusion_tpu_torch.parallel.dryrun 4
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

__all__ = ["dryrun_multichip"]

TOL = 1e-4  # the sharded gradients against one process's: rtol, and atol over the largest


def _worker(rank: int, n: int, init_file: str) -> None:
    import dataclasses

    import torch.distributed as dist

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch import train as T
    from complex_prompt_diffusion_tpu_torch.ops.sharding import ShardCtx
    from complex_prompt_diffusion_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from complex_prompt_diffusion_tpu_torch.parallel.mesh import (
        flatten_with_path,
        tree_map_with_path,
    )
    from complex_prompt_diffusion_tpu_torch.parallel.tp import (
        reduce_grads,
        shard_unet_params,
        unet_tp_shardings,
        unshard_unet_params,
    )
    from complex_prompt_diffusion_tpu_torch.pipeline import _unzero_kernels
    from complex_prompt_diffusion_tpu_torch.train.optimizers import tree_leaves, tree_unflatten

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=n)
    try:
        model_size = 2 if n % 2 == 0 and n >= 4 else 1
        data_size = n // model_size
        mesh = make_mesh(data=data_size, model=model_size)
        cfg = dataclasses.replace(M.UNetConfig.tiny(context_dim=32), dtype="float32")
        params = None
        if rank == 0:
            # the zero-init output layers and biases get values: every
            # gradient is live, and a bias added on every model rank shows
            gen = torch.Generator().manual_seed(0)
            params = tree_map_with_path(
                lambda path, a: 0.02 * torch.randn(a.shape, generator=gen)
                if path[-1] == "bias" else a,
                convert.unet_params(_unzero_kernels(gen, M.init_unet(gen, cfg))))
        params = replicate(mesh, params)
        ctx = ShardCtx(mesh)
        ctx.specs = flatten_with_path(unet_tp_shardings(params, mesh, cfg=cfg))
        local = shard_unet_params(params, ctx)

        batch_size = data_size * 2
        gen = torch.Generator().manual_seed(1)
        batch = {"latents": torch.randn(batch_size, 8, 8, 4, generator=gen),
                 "context": torch.randn(batch_size, 7, 32, generator=gen)}
        t = torch.randint(0, 1000, (batch_size,), generator=gen)
        noise = torch.randn(batch_size, 8, 8, 4, generator=gen)
        tables = S.make_diffusion_tables()
        mine = {k: shard_batch(mesh, v) for k, v in
                (("x0", batch["latents"]), ("ctx", batch["context"]), ("t", t), ("noise", noise))}

        def grads_of(p, shard, x0, ctx_, t_, noise_):
            leaves = [a.detach().requires_grad_(True) for a in tree_leaves(p)]
            loss = T.p_losses(lambda q, x, tt, c: M.unet_apply(cfg, q, x, tt, c, shard=shard),
                              tree_unflatten(p, leaves), tables, x0, ctx_, t_, noise_)
            return loss.detach(), tree_unflatten(p, torch.autograd.grad(loss, leaves))

        ctx.all_reduces = 0
        loss, grads = grads_of(local, ctx, mine["x0"], mine["ctx"], mine["t"], mine["noise"])
        per_forward = ctx.all_reduces
        grads = unshard_unet_params(ctx, reduce_grads(ctx, grads))
        loss_all = loss.clone()  # the mean over the data group's slices
        dist.all_reduce(loss_all)
        loss_all /= n
        opt = T.adan(learning_rate=1e-4)
        step = T.make_train_step(cfg, tables, opt, shard=ctx)
        new_local, _, step_loss = step(local, opt.init(local), shard_batch(mesh, batch),
                                       t=mine["t"], noise=mine["noise"])
        moved = any(not torch.equal(a, b)
                    for a, b in zip(tree_leaves(new_local), tree_leaves(local)))
        if not (moved and torch.isfinite(step_loss) and torch.equal(step_loss, loss)):
            raise AssertionError(f"rank {rank}: the Adan step moved {moved}, loss "
                                 f"{float(step_loss)} against {float(loss)}")
        if rank == 0:
            ref_loss, ref_grads = grads_of(params, None, batch["latents"], batch["context"],
                                           t, noise)
            torch.testing.assert_close(loss_all, ref_loss, rtol=TOL, atol=TOL)

            atol = TOL * max(float(g.abs().max()) for g in tree_leaves(ref_grads))
            want = flatten_with_path(ref_grads)
            for path, g in flatten_with_path(grads).items():
                torch.testing.assert_close(g, want[path], rtol=TOL, atol=atol,
                                           msg=lambda m, path=path: f"gradient {path}: {m}")
            sharded = sum("model" in spec for spec in ctx.specs.values())
            print(f"dryrun_multichip ok: mesh=({data_size}x{model_size}) ranks={n} "
                  f"loss={float(loss_all):.5f} sharded_leaves={sharded} "
                  f"all_reduces_per_forward={per_forward} (gloo, CPU)", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Spawn ``n_devices`` gloo ranks on the CPU and run the sharded step
    (module docstring); raises if a rank fails."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(n_devices, os.path.join(tmp, "rendezvous")), nprocs=n_devices,
                 join=True)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
