"""The ("data", "model") mesh over ``torch.distributed`` ranks, and the
helpers that place trees on it.

Counterpart of ``complex_prompt_diffusion_tpu/parallel/mesh.py``. The JAX
package is one controller over a ``jax.sharding.Mesh`` of devices; the port
runs one process a rank (``torch.distributed``, any backend: gloo on the
CPU and for ranks that share a card, NCCL across cards) and every rank
calls these functions together:

  * :func:`make_mesh` -- a ``DeviceMesh`` of the world's ranks, shaped
    (data, model), ranks row-major (the model groups are contiguous ranks);
  * :func:`replicate` -- a tree (a ModelBundle too) from global rank 0 on
    every rank, each tensor broadcast; the other ranks pass nothing and
    allocate what rank 0 describes, so no rank but 0 builds the weights;
  * :func:`shard_batch` -- this rank's contiguous slice of every tensor's
    batch axis along "data";
  * :func:`gather_batch` -- the inverse: the data group's slices
    concatenated, on every rank (gloo gathers CPU tensors only: under
    gloo the slices are staged through the host);
  * :func:`data_parallel_sharding` -- the spec a batch takes, ("data",).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "replicate", "shard_batch", "gather_batch", "data_parallel_sharding",
           "mesh_shape"]


def make_mesh(devices=None, data: Optional[int] = None, model: int = 1):
    """A ("data", "model") ``DeviceMesh`` over the ranks of the initialised
    default process group (``devices``: that many ranks, which must be the
    world, as the JAX package's mesh takes every device it is given).
    ``data`` defaults to world // model; data x model must be the world
    (ValueError, with the JAX package's message)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    n = dist.get_world_size() if devices is None else len(devices)
    if data is None:
        data = n // model
    if data * model != n or n != dist.get_world_size():
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    # NCCL groups carry CUDA tensors, gloo ones CPU tensors and CUDA ones
    # for all_reduce and broadcast (ranks sharing a card)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, (data, model), mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{"data": D, "model": M}: the JAX mesh's ``shape`` mapping."""
    return {name: int(mesh.size(i)) for i, name in enumerate(mesh.mesh_dim_names)}


def data_parallel_sharding(mesh) -> tuple:
    """The spec of a [batch, ...] tensor: batch split over "data"."""
    return ("data",)


class _Tensor(NamedTuple):
    """What rank 0 tells the others of one tensor leaf."""

    shape: tuple
    stride: tuple  # a channels_last conv weight keeps its layout
    dtype: torch.dtype
    device: str


def tree_map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over ``tree``: dicts, lists and dataclass
    instances are walked (``path`` holds their keys, indices and field
    names), anything else is a leaf (a tuple too: a spec, a
    :class:`_Tensor`). The parallel layer's one tree walker."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree) if f.init})
    return fn(path, tree)


def flatten_with_path(tree) -> dict:
    """{leaf path: leaf} of ``tree`` (:func:`tree_map_with_path`'s paths)."""
    flat = {}
    tree_map_with_path(flat.__setitem__, tree)
    return flat


def _tensors(fn, tree):
    """``fn`` over the tensor leaves of ``tree``; other leaves kept."""
    return tree_map_with_path(lambda _, a: fn(a) if isinstance(a, torch.Tensor) else a, tree)


def replicate(mesh, tree: Any = None, device=None):
    """``tree`` as global rank 0 holds it, on every rank of ``mesh``: rank 0
    broadcasts its structure and non-tensor leaves (pickled), then each
    tensor, which the other ranks receive into fresh tensors on ``device``
    with rank 0's strides (default device: the one rank 0's tensor lies
    on; ``torch.device`` leaves, a bundle's ``device``, follow ``device``
    too). The other ranks' ``tree`` is ignored. Rank 0 gets its own
    tensors back (moved to ``device`` when given)."""
    rank = dist.get_rank()
    leaves: list = []

    def describe(t):
        leaves.append(t)
        return _Tensor(tuple(t.shape), tuple(t.stride()), t.dtype, str(t.device))

    box = [_tensors(describe, tree) if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    mine = iter(leaves)
    received = []

    def make(path, spec):
        if isinstance(spec, torch.device) and device is not None:
            return torch.device(device)
        if not isinstance(spec, _Tensor):
            return spec
        if rank == 0:
            t = next(mine)
            t = t if device is None else t.to(device)
        else:
            t = torch.empty_strided(spec.shape, spec.stride, dtype=spec.dtype,
                                    device=device or spec.device)
        received.append(t)
        return t

    out = tree_map_with_path(make, box[0])
    for t in received:
        dist.broadcast(t, src=0)
    return out


def _data_coords(mesh):
    names = mesh.mesh_dim_names
    i = names.index("data")
    return int(mesh.size(i)), int(mesh.get_local_rank("data"))


def shard_batch(mesh, tree):
    """This rank's contiguous slice, along "data", of the batch axis (axis
    0) of every tensor in ``tree`` (which must divide by the data size:
    the JAX package's placement raises there too). Slices are contiguous
    copies."""
    size, r = _data_coords(mesh)

    def take(t):
        n = t.shape[0]
        if n % size:
            raise ValueError(f"batch axis of {n} does not divide over {size} data ranks")
        return t[r * (n // size):(r + 1) * (n // size)].contiguous()

    return _tensors(take, tree)


def gather_batch(mesh, tree):
    """Every data rank's slice of each tensor in ``tree``, concatenated
    along the batch axis in rank order, on every rank (on the tensor's
    device). Under gloo the gather runs on host copies: gloo gathers no
    CUDA tensor."""
    size, _ = _data_coords(mesh)
    group = mesh.get_group("data")
    via_host = dist.get_backend(group) == "gloo"

    def gather(t):
        src = (t.detach().cpu() if via_host else t.detach()).contiguous()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts).to(t.device)

    return _tensors(gather, tree)
