"""Diffusion training losses, the train step and EMA.

Counterpart of ``complex_prompt_diffusion_tpu/train/loop.py``:

  * :func:`q_sample`, :func:`get_v` and :func:`p_losses`: the DDPM training
    loss (target eps, x0 or v; l2 or l1; the loss_simple weighting plus the
    elbo term with ``elbo_weight``, default 0 as in the SD configs);
  * :func:`make_train_step`: a functional step ``(params, opt_state, batch,
    generator) -> (params, opt_state, loss)`` over the UNet's parameter
    tree, gradients by ``torch.autograd.grad`` (through the kernels'
    backward rules on the card, ``_build.kernel_with_plain_vjp``);
  * :func:`ema_update`, :class:`LitEma` and :func:`ema_scope`: the EMA
    shadow with the warmup decay min(decay, (1+n)/(10+n)), functional as in
    the JAX package (every method returns a new ``LitEma``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.schedules import DiffusionTables
from complex_prompt_diffusion_tpu_torch.train.optimizers import (
    Optimizer,
    apply_updates,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

__all__ = ["q_sample", "get_v", "p_losses", "make_train_step", "ema_update", "LitEma",
           "ema_scope"]


def _coeffs(tables: DiffusionTables, t, like):
    """sqrt(ac_t) and sqrt(1 - ac_t) as f32, shaped to broadcast over
    ``like`` [B, ...]."""
    shape = (-1,) + (1,) * (like.ndim - 1)
    t = torch.as_tensor(t, device=like.device).long()

    def take(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=like.device)[t].reshape(shape)

    return take(tables.sqrt_alphas_cumprod), take(tables.sqrt_one_minus_alphas_cumprod)


def q_sample(tables: DiffusionTables, x0, t, noise):
    """Forward diffusion draw x_t = sqrt(ac_t) x0 + sqrt(1 - ac_t) noise."""
    sac, s1m = _coeffs(tables, t, x0)
    return sac * x0 + s1m * noise


def get_v(tables: DiffusionTables, x0, noise, t):
    """v-parameterization target sqrt(ac_t) noise - sqrt(1 - ac_t) x0."""
    sac, s1m = _coeffs(tables, t, x0)
    return sac * noise - s1m * x0


def p_losses(
    apply_fn: Callable,
    params,
    tables: DiffusionTables,
    x0: torch.Tensor,
    context: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    parameterization: str = "eps",
    loss_type: str = "l2",
    elbo_weight: float = 0.0,
    l_simple_weight: float = 1.0,
):
    """DDPM training loss, a scalar. ``apply_fn(params, x_t, t, ctx)``."""
    x_noisy = q_sample(tables, x0, t, noise)
    model_out = apply_fn(params, x_noisy, t, context)
    if parameterization == "eps":
        target = noise
    elif parameterization == "x0":
        target = x0
    elif parameterization == "v":
        target = get_v(tables, x0, noise, t)
    else:
        raise ValueError(parameterization)
    if loss_type == "l2":
        per = (model_out - target) ** 2
    elif loss_type == "l1":
        per = torch.abs(model_out - target)
    else:
        raise ValueError(loss_type)
    per_sample = per.mean(dim=tuple(range(1, per.ndim)))
    loss = l_simple_weight * per_sample.mean()
    if elbo_weight:
        lvlb_w = torch.as_tensor(_lvlb_weights(tables), device=per.device)
        loss = loss + elbo_weight * (lvlb_w[torch.as_tensor(t, device=per.device).long()]
                                     * per_sample).mean()
    return loss


def _lvlb_weights(tables: DiffusionTables) -> np.ndarray:
    """eps-parameterization elbo weights in f32, with the [0] = [1] patch
    (the first weight divides by a zero posterior variance)."""
    with np.errstate(divide="ignore"):
        w = tables.betas ** 2 / (2 * tables.posterior_variance * tables.alphas
                                 * (1 - tables.alphas_cumprod))
    w = np.asarray(w, np.float32)
    w[0] = w[1]
    return w


def make_train_step(
    unet_cfg: M.UNetConfig,
    tables: DiffusionTables,
    optimizer: Optimizer,
    *,
    parameterization: str = "eps",
    loss_type: str = "l2",
    elbo_weight: float = 0.0,
    shard=None,
):
    """A functional train step ``(params, opt_state, batch, generator) ->
    (params, opt_state, loss)``. ``batch = {"latents": [B, h, w, 4],
    "context": [B, 77, D]}``; ``params`` the UNet's tree (f32 master
    weights under the config's compute dtype, or any other). t ~ U{0, T-1}
    and the noise ~ N(0, 1) are drawn from ``generator`` on the latents'
    device, unless the step is given them (``t=``, ``noise=``: the tests
    pass the JAX package's draws). The new parameters are fresh tensors;
    ``loss`` is detached (with ``shard``, this rank's loss: the mean over
    its batch slice).

    ``shard``: the ``ops.sharding.ShardCtx`` of tensor-parallel ``params``
    (this rank's shards, ``parallel.tp.shard_unet_params``, the context's
    ``specs`` set) and of this rank's slice of the batch along "data": the
    UNet calls all-reduce over the model group with autograd through them
    (Megatron's pair, ``ShardCtx.enter`` / ``all_reduce``, gives a model
    rank its shards' whole gradients), and the gradients are averaged over
    the data group (``parallel.tp.reduce_grads``) before the update."""

    def apply_fn(params, x, t, ctx):
        return M.unet_apply(unet_cfg, params, x, t, ctx, shard=shard)

    def train_step(params, opt_state, batch, generator=None, *, t=None, noise=None):
        x0, ctx = batch["latents"], batch["context"]
        b = x0.shape[0]
        if t is None:
            t = torch.randint(0, tables.num_train_timesteps, (b,), generator=generator,
                              device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=x0.device,
                                dtype=torch.float32)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = p_losses(apply_fn, tree_unflatten(params, leaves), tables, x0, ctx, t, noise,
                            parameterization=parameterization, loss_type=loss_type,
                            elbo_weight=elbo_weight)
            grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
        if shard is not None:
            from complex_prompt_diffusion_tpu_torch.parallel.tp import reduce_grads

            grads = reduce_grads(shard, grads)
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, loss.detach()

    return train_step


def ema_update(ema_params, params, decay: float = 0.9999, step: Optional[int] = None):
    """EMA shadow update ``e * decay + (1 - decay) * p``, with the warmup
    decay min(decay, (1+step)/(10+step)) (in f32, as the JAX package takes
    it) when ``step`` is given."""
    if step is not None:
        d = np.float32(min(decay, (1.0 + step) / (10.0 + step)))
        decay, keep = float(d), float(np.float32(1.0) - d)
    else:
        keep = 1.0 - decay
    with torch.no_grad():
        out = torch._foreach_mul(tree_leaves(ema_params), decay)
        torch._foreach_add_(out, torch._foreach_mul(tree_leaves(params), keep))
        return tree_unflatten(ema_params, out)


@dataclasses.dataclass(frozen=True)
class LitEma:
    """Functional LitEma: shadow weights, the warmup decay and the
    store/copy_to/restore validation swap. Every method returns a new
    ``LitEma`` (``copy_to`` the weights to evaluate with); ``num_updates``
    drives the warmup decay min(decay, (1+n)/(10+n)), off with
    ``use_num_updates=False`` (a fixed decay)."""

    shadow: Any
    decay: float = 0.9999
    num_updates: int = 0
    use_num_updates: bool = True
    stored: Any = None

    @staticmethod
    def create(params, decay: float = 0.9999, use_num_updates: bool = True):
        """The shadow starts as a copy of the online weights."""
        return LitEma(shadow=tree_map(lambda p: p.detach().clone(), params), decay=decay,
                      use_num_updates=use_num_updates)

    def update(self, params) -> "LitEma":
        """One shadow decay step."""
        n = self.num_updates + 1 if self.use_num_updates else self.num_updates
        step = n if self.use_num_updates else None
        return dataclasses.replace(
            self, shadow=ema_update(self.shadow, params, self.decay, step=step), num_updates=n)

    def store(self, params) -> "LitEma":
        """Remember the online weights before a swap-in."""
        return dataclasses.replace(self, stored=params)

    def copy_to(self):
        """The weights to run validation with."""
        return self.shadow

    def restore(self):
        """The online weights remembered by :meth:`store`."""
        if self.stored is None:
            raise ValueError("LitEma.restore called without a prior store")
        return self.stored


@contextlib.contextmanager
def ema_scope(params, ema: Optional[LitEma], enabled: bool = True):
    """Within the block, evaluate with the EMA weights; the caller's own
    ``params`` binding is its restore. Yields the EMA shadow when enabled
    and available, the online weights otherwise."""
    if enabled and ema is not None:
        yield ema.copy_to()
    else:
        yield params
