"""Parallelism over ``torch.distributed`` ranks: the ("data", "model")
mesh, data-parallel rendering and tensor-parallel (Megatron-style) UNet
sharding.

Counterpart of ``complex_prompt_diffusion_tpu/parallel``. The JAX package
is one controller whose GSPMD partitioner inserts the collectives; the port
runs one process a rank, every rank calling the same entry points:

  * ``mesh.py``: :func:`make_mesh`, :func:`replicate` (weights from rank 0),
    :func:`shard_batch` / :func:`gather_batch` (a batch split over "data");
  * ``tp.py``: ``unet_tp_shardings`` (the JAX rule's spec tree),
    ``shard_bundle`` (each rank's shards and the ``ShardCtx`` the UNet's
    sites all-reduce through), ``reduce_grads`` (a sharded train step);
  * ``dryrun.py``: ``dryrun_multichip(n)``, one sharded train step on n
    spawned gloo ranks.

A data-parallel render is each rank's slice through ``sample_latents`` /
``txt2img``, no collective in a UNet call; a tensor-parallel one runs every
rank on the same inputs, three all-reduces a transformer block.
"""

from complex_prompt_diffusion_tpu_torch.parallel.mesh import (
    data_parallel_sharding,
    gather_batch,
    make_mesh,
    replicate,
    shard_batch,
)

__all__ = ["make_mesh", "replicate", "shard_batch", "gather_batch", "data_parallel_sharding"]
