"""The kernels' backward rules on the CPU.

Each JAX kernel of the package is a ``jax.custom_vjp``: a Pallas forward, and
a backward that recomputes the op in XLA and takes that op's VJP. The port's
counterpart is ``_build.kernel_with_plain_vjp``: the hand-written kernel
forward, and the VJP of the plain PyTorch twin recomputed on the saved
inputs. Here, without a card:

  * the helper itself, with a CPU stand-in for the kernel (the twin, or the
    twin plus a small offset so that the forward value is seen to be the
    stand-in's): ``torch.autograd.gradcheck`` in f64, ``None`` for inputs
    that need no gradient, f32 weights under bf16 activations getting f32
    gradients, the ``out_hdbs`` view of K5's output, the forward skipped by
    autograd where nothing requires grad;
  * every twin's VJP (what a CPU tensor takes, and what the backward rule
    runs on the card) against ``jax.vjp`` of the JAX ``custom_vjp`` wrapper
    itself with its Pallas forward in interpret mode (``use_pallas=True,
    interpret=True``, as the JAX package's own gradient tests run it): K1
    in its three rules (merged, one-pass [B, H, S, D], streaming), K5's cm
    block, K2, K3 with and without SiLU, K4 and K6.

Inputs come from numpy seeds, f32 on both sides unless stated.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.ops import conv as JC
from complex_prompt_diffusion_tpu.ops import groupnorm as JG
from complex_prompt_diffusion_tpu.ops import mlp as JF
from complex_prompt_diffusion_tpu.ops.probes import winograd as JW
from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops import conv as C
from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G
from complex_prompt_diffusion_tpu_torch.ops import mlp as F2
from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as W

# the packages' ops/__init__ re-export the function ``attention``: the modules by name
A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")
JA = importlib.import_module("complex_prompt_diffusion_tpu.ops.attention")

# a VJP in f32 on both sides, max |a - b| / max |b|: sums over the reduced
# axes in another order (and, for K6, the Winograd transform against the
# direct conv's VJP)
VJP_TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _np(shape, seed, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _port_vjp(fn, args, cot, wrt):
    """fn's VJP on torch copies of ``args`` for the cotangent ``cot``, with
    respect to the positions ``wrt``."""
    ts = [torch.from_numpy(a.copy()).requires_grad_(i in wrt) for i, a in enumerate(args)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt], torch.from_numpy(cot))
    return out, grads


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return out, vjp(jnp.asarray(cot))


def _close(got, want):
    got, want = np.asarray(got.detach()), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= VJP_TOL * np.abs(want).max()


# ---- (i) the helper ----

def _offset_kernel(plain):
    """A CPU stand-in for a kernel: the plain twin's value plus 1e-3, with
    no graph (as a ctypes launch's output has none)."""
    def kernel(*args):
        return (plain(*args) + 1e-3).detach()

    return kernel


def test_helper_gradcheck_in_f64():
    """K2's twin computes in x's dtype, so it is a function of f64 inputs
    and gradcheck holds its VJP through the Function to finite differences."""
    rng = _rng(0)
    args = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
            for s in ((3, 5, 8), (8, 32), (32,), (16, 8), (8,))]

    def fn(*a):
        return _build.kernel_with_plain_vjp(lambda *t: F2.geglu_ff_plain(*t).detach(),
                                            F2.geglu_ff_plain, (), *a)

    assert torch.autograd.gradcheck(fn, tuple(args))


def test_helper_forward_is_the_kernels_and_backward_the_twins():
    rng = _rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32)).requires_grad_()
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2)
            for s in ((16, 64), (64,), (32, 16), (16,))]
    out = _build.kernel_with_plain_vjp(_offset_kernel(F2.geglu_ff_plain), F2.geglu_ff_plain,
                                       (), x, *args)
    want = F2.geglu_ff_plain(x, *args)
    assert torch.equal(out.detach(), want.detach() + 1e-3)
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (got,) = torch.autograd.grad(out, x, cot)
    (ref,) = torch.autograd.grad(want, x, cot)
    assert torch.equal(got, ref)


def test_helper_gives_none_where_no_gradient_is_needed():
    """x needs no gradient: the backward returns None for it (and for the
    kernel, the twin and the nondiff arguments), and the twin is recomputed
    with only the weight and the bias requiring grad."""
    rng = _rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 32, 3, 3)).astype(np.float32) * 0.1)
    b = torch.zeros(16).requires_grad_()
    w.requires_grad_()
    seen = []

    def plain(*t):
        seen.append([a.requires_grad for a in t])
        return C.conv3x3_plain(*t)

    out = _build.kernel_with_plain_vjp(_offset_kernel(C.conv3x3_plain), plain, (), x, w, b)
    grads = out.grad_fn.apply(torch.ones_like(out))
    assert seen == [[False, True, True]]
    assert all(g is None for g in grads[:4])  # the kernel, the twin, nondiff, x
    ref = torch.autograd.grad(C.conv3x3_plain(x, w, b).sum(), (w, b))
    assert torch.equal(grads[4], ref[0]) and torch.equal(grads[5], ref[1])


def test_helper_keeps_each_inputs_dtype():
    """f32 master weights under bf16 activations: the twin casts them to
    x's dtype inside, as the kernel does, so each gradient comes back in its
    own input's dtype."""
    rng = _rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32)).bfloat16()
    x.requires_grad_()
    w1, b1, w2, b2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.2)
                      .requires_grad_() for s in ((16, 64), (64,), (32, 16), (16,)))
    out = _build.kernel_with_plain_vjp(_offset_kernel(F2.geglu_ff_plain), F2.geglu_ff_plain,
                                       (), x, w1, b1, w2, b2)
    assert out.dtype == torch.bfloat16
    grads = torch.autograd.grad(out.float().square().sum(), (x, w1, b1, w2, b2))
    assert [g.dtype for g in grads] == [torch.bfloat16] + [torch.float32] * 4
    ref = torch.autograd.grad(F2.geglu_ff_plain(x, w1, b1, w2, b2).float().square().sum(),
                              (x, w1, b1, w2, b2))
    # the cotangent differs by the stand-in's offset only: same dtypes, near values
    for g, r in zip(grads, ref):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("out_hdbs", [False, True])
def test_helper_through_k5s_output_views(out_hdbs):
    """K5 hands back a view of a fresh [H, D, B, S] tensor under
    ``out_hdbs``; its cotangent arrives in that layout and the gradients
    equal autograd's through the twin's same view."""
    rng = _rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 8, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    args = (0.3, False, out_hdbs)
    out = _build.kernel_with_plain_vjp(_offset_kernel(A.attention_dmajor_plain),
                                       A.attention_dmajor_plain, args, q, k, v)
    want = A.attention_dmajor_plain(q, k, v, *args)
    assert out.stride() == want.stride()
    # what the cm block does with it: a [C, B*S] view, then a product
    wo = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))

    def head(o):
        return torch.matmul(o.permute(1, 2, 0, 3).reshape(16, 32).t(), wo).square().sum()

    got = torch.autograd.grad(head(out), (q, k, v))
    ref = torch.autograd.grad(head(want + 1e-3), (q, k, v))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_helper_runs_the_kernel_alone_without_grad():
    """No tensor requires grad, or grad mode is off: the kernel runs alone
    and its output carries no graph."""
    calls = []

    def kernel(x):
        calls.append(1)
        return x * 2

    x = torch.ones(3)
    assert _build.kernel_with_plain_vjp(kernel, None, (), x).grad_fn is None
    xg = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert _build.kernel_with_plain_vjp(kernel, None, (), xg).grad_fn is None
    with torch.inference_mode():
        assert _build.kernel_with_plain_vjp(kernel, None, (), xg).grad_fn is None
    assert len(calls) == 3


# ---- (ii) the twins' VJPs against the JAX rules ----

@pytest.mark.parametrize("d", [40, 80])
def test_k1_merged_rule(d):
    """``attention`` at 128 < KV: ``_onepass_merged_diff``, [B, S, H*D]."""
    heads = 2
    args = [_np((1, 256, heads * d), 10 + i) for i in range(3)]
    cot = _np((1, 256, heads * d), 13)
    want, wg = _jax_vjp(lambda q, k, v: JA.attention(q, k, v, heads, use_pallas=True,
                                                     interpret=True), args, cot)
    got, gg = _port_vjp(lambda q, k, v: A.flash_attention(q, k, v, heads), args, cot, (0, 1, 2))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


@pytest.mark.parametrize("block_k", [None, 128])
def test_k1_bhsd_rules(block_k):
    """``flash_attention`` over [B, H, S, D]: the one-pass rule
    (``_onepass_attention_diff``) and, with a key block, the streaming one
    (``_pallas_attention_diff``); the port's twin on the merged layout."""
    b, h, s, d = 1, 2, 256, 32
    args = [_np((b, h, s, d), 20 + i) for i in range(3)]
    cot = _np((b, h, s, d), 23)

    def merged(t):
        return t.transpose(1, 2).reshape(b, s, h * d)

    want, wg = _jax_vjp(lambda q, k, v: JA.flash_attention(q, k, v, block_k=block_k,
                                                           use_pallas=True, interpret=True),
                        args, cot)
    got, gg = _port_vjp(lambda q, k, v: A.flash_attention(merged(q), merged(k), merged(v), h)
                        .reshape(b, s, h, d).transpose(1, 2), args, cot, (0, 1, 2))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


def test_k5_cm_block_rule():
    """The channel-major block (``_self_attention_cm_diff``): x and all five
    weights."""
    b, s, c, heads = 1, 256, 128, 2
    args = [_np((b, s, c), 30)] + [_np((c, c), 31 + i, 0.1) for i in range(4)] + [
        _np((c,), 35, 0.1)]
    cot = _np((b, s, c), 36)
    want, wg = _jax_vjp(lambda *a: JA.self_attention_cm(*a, heads, interpret=True), args, cot)
    got, gg = _port_vjp(lambda *a: A.self_attention_cm(*a, heads), args, cot, range(6))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


def test_k2_rule():
    """``_ff_diff``: x, W1, b1, W2 and b2 at the Pallas kernel's widths."""
    m, c = 64, 128
    args = [_np((m, c), 40), _np((c, 8 * c), 41, 0.05), _np((8 * c,), 42, 0.05),
            _np((4 * c, c), 43, 0.05), _np((c,), 44, 0.05)]
    cot = _np((m, c), 45)
    want, wg = _jax_vjp(lambda *a: JF.geglu_ff(*a, use_pallas=True, interpret=True), args, cot)
    got, gg = _port_vjp(F2.geglu_ff, args, cot, range(5))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


@pytest.mark.parametrize("silu", [False, True])
def test_k3_rule(silu):
    """``_gn_pallas_diff``: x, gamma and beta, with and without SiLU."""
    x = _np((2, 8, 8, 64), 50, 2.0) + 0.5
    args = [x, 1 + _np((64,), 51, 0.3), _np((64,), 52, 0.3)]
    cot = _np(x.shape, 53)
    fn = JG.group_norm_silu if silu else JG.group_norm
    want, wg = _jax_vjp(lambda *a: fn(*a, num_groups=32, eps=1e-6, interpret=True), args, cot)
    got, gg = _port_vjp(lambda *a: G.group_norm_nhwc(*a, 32, 1e-6, silu), args, cot, range(3))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


def test_k4_rule():
    """``conv3x3``'s rule: x, the kernel (the port's [Co, C, 3, 3] weight
    against JAX's HWIO) and the bias."""
    x = _np((2, 16, 16, 64), 60)
    k = _np((3, 3, 64, 32), 61, 0.05)
    bias = _np((32,), 62)
    cot = _np((2, 16, 16, 32), 63)
    want, (wx, wk, wb) = _jax_vjp(lambda a, kk, bb: JC.conv3x3(a, kk, bb, True), (x, k, bias),
                                  cot)
    w = np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    got, (gx, gw, gb) = _port_vjp(C.conv3x3, (x, w, bias), cot, (0, 1, 2))
    _close(got, want)
    _close(gx, wx)
    _close(gw.permute(2, 3, 1, 0), wk)
    _close(gb, wb)


def test_k6_rule():
    """``wino3x3``'s rule (the VJP of the direct conv in JAX): x, the HWIO
    kernel (through the weight transform) and the bias, at the Pallas
    kernel's width."""
    x = _np((1, 8, 8, 128), 70)
    k = _np((3, 3, 128, 128), 71, 0.05)
    bias = _np((128,), 72)
    cot = _np((1, 8, 8, 128), 73)
    want, wg = _jax_vjp(lambda a, kk, bb: JW.wino3x3(a, kk, bb, True), (x, k, bias), cot)
    got, gg = _port_vjp(W.wino3x3, (x, k, bias), cot, (0, 1, 2))
    _close(got, want)
    for g, w in zip(gg, wg):
        _close(g, w)


def test_every_launch_counter_exists_from_import():
    """Every counter ``ops.KERNEL_WRAPPERS`` names exists from import, the
    dispatch entries' too, though their bodies (split out of them) add to
    them: a counter set only by ``chip_smoke.reset_launches`` would hide a
    missing one there."""
    from complex_prompt_diffusion_tpu_torch import ops

    for name, w in ops.KERNEL_WRAPPERS.items():
        assert isinstance(w.launches, int), name
    assert isinstance(G.group_norm_nhwc.calls, int) and isinstance(G.group_norm_nhwc.planned, int)
