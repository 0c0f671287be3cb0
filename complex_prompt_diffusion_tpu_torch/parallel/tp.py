"""Tensor-parallel inference and training: Megatron-style UNet sharding
over the mesh's "model" axis.

Counterpart of ``complex_prompt_diffusion_tpu/parallel/tp.py``. The rules,
by (parent module, leaf name), are the JAX package's:

  * attention ``to_q`` / ``to_k`` / ``to_v`` kernels: column-parallel,
    spec (None, "model");
  * attention ``to_out`` kernel: row-parallel, ("model", None);
  * feed-forward ``proj`` (GEGLU in) kernel and bias: column-parallel;
  * feed-forward ``out`` kernel: row-parallel;
  * everything else replicated, spec () (convs, norms, the time
    embedding, the row-parallel biases); with ``conv_split`` (probe mode)
    conv weights with Cin % model == 0 and Cin >= 8 model also split their
    input channels.

The port is multi-controller, so :func:`shard_bundle` keeps on each rank
only its shard of each split leaf and installs an ``ops.sharding.ShardCtx``
beside the UNet config (``ModelBundle.shard``); the UNet then runs each
split site on its shard and all-reduces over the model group
(``models/unet.py``). Two things differ from a contiguous cut of the JAX
specs: the GEGLU ``proj`` columns are [value | gate], so a rank takes its
share of each in matching pairs (a contiguous cut would hand value and gate
to different ranks, which the JAX package's model-only mesh answers by
running XLA there); and a site whose heads (or FF hidden width) do not
divide by the model size keeps its weights whole, where the JAX package
replicates the site. :func:`unet_tp_shardings` gives the JAX rule's tree;
with ``cfg`` the tree shard_bundle applies.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from complex_prompt_diffusion_tpu_torch.ops.sharding import ShardCtx
from complex_prompt_diffusion_tpu_torch.parallel.mesh import (
    flatten_with_path,
    mesh_shape,
    tree_map_with_path,
)

__all__ = ["unet_tp_shardings", "shard_bundle", "shard_unet_params", "unshard_unet_params",
           "reduce_grads"]

_COLUMN = ("to_q", "to_k", "to_v")
_REPLICATED = ()


def _spec_for(path, leaf, conv_split: bool, model_size: int) -> tuple:
    """The JAX package's ``_spec_for`` on the port's tree: ``path`` holds
    dict keys (str) and list indices (int); conv weights are ``weight``
    [O, I, kh, kw], so the input-channel split is axis 1."""
    names = [k if isinstance(k, str) else None for k in path]
    name = names[-1] if names else None
    parent = names[-2] if len(names) >= 2 else None
    is_ff = "ff" in names
    if name == "kernel":
        if parent in _COLUMN or (is_ff and parent == "proj"):
            return (None, "model")
        if parent == "to_out" or (is_ff and parent == "out"):
            return ("model", None)
    if (name == "weight" and conv_split and leaf.ndim == 4
            and leaf.shape[1] % model_size == 0 and leaf.shape[1] >= model_size * 8):
        return (None, "model", None, None)
    if name == "bias" and (parent in _COLUMN or (is_ff and parent == "proj")):
        return ("model",)
    return _REPLICATED


def unet_tp_shardings(unet_params: Any, mesh, *, conv_split: bool = False, cfg=None):
    """The spec tree of the UNet params (same structure; each leaf a tuple
    naming the mesh axis of each tensor axis, () replicated), by the JAX
    package's rule. With ``cfg`` (the UNet's config), the tree
    :func:`shard_unet_params` applies: the attention sites whose heads do
    not divide by the model size, and the FFs whose hidden width does not
    (``ShardCtx.splits_heads`` / ``splits_hidden``), replicated."""
    from complex_prompt_diffusion_tpu_torch.models.unet import build_plan

    model_size = mesh_shape(mesh).get("model", 1)
    specs = tree_map_with_path(
        lambda path, leaf: _spec_for(path, leaf, conv_split, model_size), unet_params)
    if cfg is None:
        return specs
    ctx = ShardCtx(mesh)
    input_plan, middle_plan, output_plan = build_plan(cfg)

    def whole(tree):
        return tree_map_with_path(lambda path, spec: _REPLICATED, tree)

    def fix(block_plan, block_specs):
        for desc, sub in zip(block_plan, block_specs):
            if desc[0] != "attn":
                continue
            inner = desc[2] * desc[3]
            for blk in sub["blocks"]:
                if not ctx.splits_heads(desc[2]):
                    blk["attn1"], blk["attn2"] = whole(blk["attn1"]), whole(blk["attn2"])
                if not ctx.splits_hidden(4 * inner):
                    blk["ff"] = whole(blk["ff"])

    for bp, sp in zip(input_plan, specs["input_blocks"]):
        fix(bp, sp)
    fix(middle_plan, specs["middle_block"])
    for bp, sp in zip(output_plan, specs["output_blocks"]):
        fix(bp, sp)
    return specs


def _take(path, leaf, spec, rank: int, size: int):
    """This rank's shard of ``leaf`` by ``spec`` (a contiguous copy): the
    GEGLU proj's value and gate halves each cut, and the two shares
    concatenated, so that a rank's gate columns match its value columns."""
    if "model" not in spec:
        return leaf
    dim = spec.index("model")
    if "ff" in path and "proj" in path:
        value, gate = leaf.chunk(2, dim=dim)
        return torch.cat([value.chunk(size, dim=dim)[rank], gate.chunk(size, dim=dim)[rank]],
                         dim=dim).contiguous()
    return leaf.chunk(size, dim=dim)[rank].contiguous()


def shard_unet_params(unet_params, ctx: ShardCtx):
    """Each split leaf of ``unet_params`` cut to this rank's shard by the
    context's ``specs``."""
    rank, size = ctx.axis_rank(ctx.model_axis), ctx.model_size
    return tree_map_with_path(
        lambda path, leaf: _take(path, leaf, ctx.specs[path], rank, size), unet_params)


def unshard_unet_params(ctx: ShardCtx, local):
    """The inverse of :func:`shard_unet_params` on every rank: each split
    leaf of ``local`` (or of a tree of its shape, such as its gradients)
    gathered from the model group and concatenated along its split axis,
    the GEGLU proj's value and gate halves each rebuilt."""
    m = ctx.model_size

    def whole(path, t):
        spec = ctx.specs[path]
        if m == 1 or "model" not in spec:
            return t
        dim = spec.index("model")
        parts = [torch.empty_like(t) for _ in range(m)]
        dist.all_gather(parts, t.contiguous(), group=ctx.group(ctx.model_axis))
        if "ff" in path and "proj" in path:
            halves = [p.chunk(2, dim=dim) for p in parts]
            return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=dim)
        return torch.cat(parts, dim=dim)

    return tree_map_with_path(whole, local)


def shard_bundle(bundle, mesh, *, conv_split: bool = False):
    """The bundle on this rank of ``mesh``: its UNet weights cut to the
    rank's tensor-parallel shards over "model" (the same bundle must be on
    every rank: :func:`parallel.mesh.replicate`), the VAE and CLIP as they
    are, and a fresh ``ShardCtx`` (``bundle.shard``, holding the applied
    specs) that the entry points pass to every UNet call. On a mesh with
    one model rank nothing is cut: the context then marks the bundle
    data-parallel (tiled inference shards its tiles over "data").
    ``conv_split``: the probe mode's input-channel split of the convs."""
    ctx = ShardCtx(mesh, conv_split=conv_split)
    ctx.specs = flatten_with_path(unet_tp_shardings(bundle.unet_params, mesh, conv_split=conv_split,
                                             cfg=bundle.unet_cfg))
    return dataclasses.replace(bundle, unet_params=shard_unet_params(bundle.unet_params, ctx),
                               shard=ctx)


def reduce_grads(ctx: ShardCtx, grads):
    """The gradients of a tensor-parallel train step, as one process on the
    whole model and batch would have them: each leaf averaged over the data
    group. (Over the model group there is nothing to do: the UNet's
    ``ShardCtx.enter`` / ``all_reduce`` pair gives every model rank its
    shards' and the replicated leaves' whole gradients.)"""
    d = ctx.axis_size(ctx.data_axis)
    if d == 1:
        return grads

    def mean(path, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group(ctx.data_axis))
        return g / d

    return tree_map_with_path(mean, grads)
