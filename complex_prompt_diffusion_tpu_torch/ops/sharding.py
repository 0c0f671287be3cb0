"""The tensor-parallel context of a sharded UNet.

Counterpart of ``complex_prompt_diffusion_tpu/ops/sharding.py``. The JAX
package is single-controller SPMD: a ``ShardCtx`` rides in
``UNetConfig.use_pallas``, its kernels wrap themselves in ``shard_map`` and
GSPMD inserts the collectives. The port is multi-controller: one process a
rank, each holding its shard of the weights (``parallel.tp.shard_bundle``)
and calling the same entry points; the collectives are explicit
``torch.distributed`` calls over the mesh's process groups.

:class:`ShardCtx` carries the mesh (a ("data", "model")
``torch.distributed`` ``DeviceMesh``, ``parallel.mesh.make_mesh``), decides
which UNet sites are split over the model axis
(:meth:`ShardCtx.splits_heads`, :meth:`ShardCtx.splits_hidden`) and runs
Megatron's pair of operators around each: :meth:`ShardCtx.enter` where a
column shard starts (the identity forward, an all-reduce of the gradient
backward) and :meth:`ShardCtx.all_reduce` at the row-parallel exit (an
all-reduce forward, counted; the identity backward). So every model rank
gets its shards' and the replicated leaves' whole gradients. It holds
process groups, so it is not a config value: it travels beside the UNet
config (``ModelBundle.shard``, ``unet_apply(..., shard=)``), never inside
it, and no saved field or hash of a config sees it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["ShardCtx", "axis_if_divisible", "local_heads", "local_hidden"]


def local_heads(heads: int, model: int) -> int:
    """The heads a rank of a model-``model`` mesh runs at an attention site
    of ``heads``: heads / model where they divide, else all of them (the
    site keeps its weights whole)."""
    return heads // model if model > 1 and heads % model == 0 else heads


def local_hidden(hidden: int, model: int) -> int:
    """The GEGLU hidden width (H4) a rank runs: hidden / model where each
    share is a multiple of 8 (K2's width rule), else all of it."""
    return hidden // model if model > 1 and hidden % (8 * model) == 0 else hidden


def _axis_index(mesh, name: str) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


@dataclasses.dataclass(eq=False)
class ShardCtx:
    """The mesh and axis names of a sharded bundle, the specs that sharded
    its UNet (``specs``: {leaf path: spec}, ``parallel.tp.unet_tp_shardings``
    with the UNet's config flattened; None before sharding) and the count of the all-reduces its UNet calls ran
    (``all_reduces``, which :meth:`all_reduce` adds to; set it to 0 before
    a call to count that call's). ``conv_split`` (probe mode): the 3x3 and
    1x1 convs contract a Cin shard a rank and all-reduce the partial
    outputs."""

    mesh: Any
    data_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    conv_split: bool = False
    specs: Any = None
    all_reduces: int = 0

    def axis_size(self, name: Optional[str]) -> int:
        """Ranks along the mesh axis ``name`` (1 for None or an axis the
        mesh lacks)."""
        i = None if name is None else _axis_index(self.mesh, name)
        return 1 if i is None else int(self.mesh.size(i))

    def axis_rank(self, name: Optional[str]) -> int:
        """This rank's coordinate along the axis ``name`` (0 where it has
        one rank)."""
        if self.axis_size(name) == 1:
            return 0
        return int(self.mesh.get_local_rank(name))

    def group(self, name: str):
        """The process group of this rank's line along ``name``."""
        return self.mesh.get_group(name)

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    def splits_heads(self, heads: int) -> bool:
        """Whether an attention site of ``heads`` heads runs a head shard a
        rank: where the heads divide by the model size. Elsewhere the site
        keeps its weights whole and runs every head (the JAX package
        replicates such a site)."""
        return local_heads(heads, self.model_size) != heads

    def splits_hidden(self, hidden: int) -> bool:
        """Whether a GEGLU FF of ``hidden`` (H4) units runs a hidden shard a
        rank: where each rank's share is a whole multiple of 8 (K2's
        width rule)."""
        return local_hidden(hidden, self.model_size) != hidden

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where a column shard starts: itself; in a backward pass its
        gradient is summed over the model group (each rank's shard gives
        a part of it). No forward collective, so nothing is counted."""
        if not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _Enter.apply(t, self.group(self.model_axis))

    def all_reduce(self, t: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The sum of the partial products ``t`` over the model group (in
        place where no gradient is taken), plus ``bias`` once; in a
        backward pass the gradient passes through (each rank's partial gets
        the whole output's). Counted in ``all_reduces``."""
        self.all_reduces += 1
        group = self.group(self.model_axis)
        if torch.is_grad_enabled() and t.requires_grad:
            t = _Reduce.apply(t, group)
        else:
            dist.all_reduce(t, group=group)
        return t if bias is None else t + bias.to(t.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def axis_if_divisible(ctx: ShardCtx, name: Optional[str], dim: int):
    """``name`` when sharding a dimension of ``dim`` over that axis is
    well formed (more than one rank, and ``dim`` divides by their count),
    else None."""
    size = ctx.axis_size(name)
    if size > 1 and dim % size == 0:
        return name
    return None
