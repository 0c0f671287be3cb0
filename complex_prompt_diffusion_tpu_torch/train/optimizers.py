"""The Adan optimizer over parameter trees.

Counterpart of ``complex_prompt_diffusion_tpu/train/optimizers.py`` (Xie et
al., arXiv:2208.06677), with the same update:

  m_t = b1 m + (1-b1) g
  d_t = b2 d + (1-b2) (g - g_prev)
  n_t = b3 n + (1-b3) (g + b2 (g - g_prev))^2
  update = (m_t/bc1 + b2 d_t/bc2) / (sqrt(n_t/bc3) + eps)
  no_prox=False: p = (p - lr*update) / (1 + lr*wd)
  no_prox=True:  p = p*(1 - lr*wd) - lr*update

with g_prev = g on the first step, optional global grad-norm clipping
(``max_grad_norm``) and a constant or callable learning rate (called with
the step count, 1 on the first update). The JAX version is an optax
``GradientTransformation``; here :func:`adan` returns the same pair of
functions, ``init(params) -> state`` and ``update(grads, state, params) ->
(updates, state)``, with the updates as deltas that :func:`apply_updates`
adds, so a step rounds as ``optax.apply_updates`` does. Parameters, gradients
and the state are trees of tensors (nested dicts and lists, the port's
parameter layout); the arithmetic runs in each tensor's dtype, as
``torch._foreach_*`` ops over all the leaves at once (a handful of
multi-tensor launches an update, where a loop over the UNet's ~700 tensors
would launch ~20 000 kernels from the host), rounding op by op as the JAX
update does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

__all__ = ["adan", "AdanState", "Optimizer", "apply_updates", "tree_map", "tree_leaves",
           "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts and lists/tuples),
    with the matching leaves of ``rest``; lists come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """``tree``'s structure holding ``leaves`` (in :func:`tree_leaves`'
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclasses.dataclass(frozen=True)
class AdanState:
    count: int
    exp_avg: Any
    exp_avg_sq: Any
    exp_avg_diff: Any
    pre_grad: Any


class Optimizer(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, state)``."""

    init: Callable
    update: Callable


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf."""
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params), tree_leaves(updates)))


def adan(
    learning_rate=1e-3,
    b1: float = 0.98,
    b2: float = 0.92,
    b3: float = 0.99,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    max_grad_norm: float = 0.0,
    no_prox: bool = False,
) -> Optimizer:
    def init_fn(params):
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, memory_format=torch.preserve_format),
                            params)

        return AdanState(count=0, exp_avg=zeros(), exp_avg_sq=zeros(), exp_avg_diff=zeros(),
                         pre_grad=zeros())

    @torch.no_grad()
    def update_fn(grads, state, params):
        if params is None:
            raise ValueError("adan requires params for the decoupled decay")
        count = state.count + 1
        g = tree_leaves(grads)
        if max_grad_norm > 0:
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            clip = torch.clamp(max_grad_norm / (gnorm + eps), max=1.0)
            g = torch._foreach_mul(g, clip)
        # first step: pre_grad := grad
        diff = torch._foreach_sub(g, g if count == 1 else tree_leaves(state.pre_grad))

        def decay(old, beta, new):  # beta * old + (1 - beta) * new
            out = torch._foreach_mul(tree_leaves(old), beta)
            torch._foreach_add_(out, torch._foreach_mul(new, 1 - beta))
            return out

        exp_avg = decay(state.exp_avg, b1, g)
        exp_avg_diff = decay(state.exp_avg_diff, b2, diff)
        upd = torch._foreach_add(g, torch._foreach_mul(diff, b2))  # g + b2 (g - g_prev)
        sq = torch._foreach_mul(upd, 1 - b3)
        torch._foreach_mul_(sq, upd)
        exp_avg_sq = torch._foreach_mul(tree_leaves(state.exp_avg_sq), b3)
        torch._foreach_add_(exp_avg_sq, sq)
        del upd, sq
        # the bias corrections in f32, as the JAX update computes them
        f32 = np.float32
        bc1, bc2, bc3 = (float(f32(1) - f32(b) ** f32(count)) for b in (b1, b2, b3))
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        # u = (m / bc1 + b2 d / bc2) / (sqrt(n / bc3) + eps)
        denom = torch._foreach_div(exp_avg_sq, bc3)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_mul(exp_avg_diff, b2)
        torch._foreach_div_(u, bc2)
        torch._foreach_add_(u, torch._foreach_div(exp_avg, bc1))
        torch._foreach_div_(u, denom)
        del denom
        p = tree_leaves(params)
        torch._foreach_mul_(u, lr)
        if no_prox:  # p (1 - lr wd) - lr u
            new_p = torch._foreach_mul(p, 1 - lr * weight_decay)
            torch._foreach_sub_(new_p, u)
        else:  # (p - lr u) / (1 + lr wd)
            new_p = torch._foreach_sub(p, u)
            torch._foreach_div_(new_p, 1 + lr * weight_decay)
        del u
        torch._foreach_sub_(new_p, p)  # the delta (optax's convention)
        return tree_unflatten(params, new_p), AdanState(
            count=count, exp_avg=tree_unflatten(params, exp_avg),
            exp_avg_sq=tree_unflatten(params, exp_avg_sq),
            exp_avg_diff=tree_unflatten(params, exp_avg_diff),
            pre_grad=tree_unflatten(params, g))

    return Optimizer(init_fn, update_fn)
