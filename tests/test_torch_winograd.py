"""Port parity: the Winograd F(2x2,3x3) conv probe (K6's plain twin) vs JAX.

On CPU tensors the port's ``wino3x3`` runs the plain PyTorch twin of the K6
CUDA kernel. It is held against the JAX package's Pallas kernel in interpret
mode at the JAX test's own sizes, and against the direct conv. Inputs come
from one numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu.ops.probes import winograd as JW
from complex_prompt_diffusion_tpu_torch.ops.probes import winograd as W


def _inputs(b, h, w, ci, co, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.05).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32)
    return x, k, bias


def _direct(x, k, bias):
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), bias, padding=1)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize(
    "b,h,w,ci,co",
    [(1, 8, 8, 128, 128), (2, 16, 16, 256, 128), (1, 32, 32, 128, 256), (1, 8, 12, 24, 20)],
)
def test_matches_pallas_kernel_and_direct_conv(b, h, w, ci, co):
    x, k, bias = _inputs(b, h, w, ci, co)
    got = W.wino3x3(*map(torch.from_numpy, (x, k, bias)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, h, w, co)
    if ci % 128 == 0:  # the Pallas kernel's own sizes (tests/test_ops.py)
        want = JW.wino3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    ref = _direct(*map(torch.from_numpy, (x, k, bias)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4)


def test_winograd_weights_equal():
    _, k, _ = _inputs(1, 8, 8, 24, 40, seed=4)
    got = W.winograd_weights(torch.from_numpy(k))
    want = JW.winograd_weights(jnp.asarray(k))
    assert tuple(got.shape) == (16, 24, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # bf16 weights are transformed in f32
    got16 = W.winograd_weights(torch.from_numpy(k).bfloat16())
    assert got16.dtype == torch.float32


def test_bf16_against_direct_conv():
    """bf16 activations and weights: the rounding of the transformed tiles
    and weights stays at the documented ~5e-3 of the direct conv's scale."""
    x, k, bias = _inputs(2, 16, 16, 64, 48, seed=5)
    tx, tk, tb = (torch.from_numpy(a).bfloat16() for a in (x, k, bias))
    got = W.wino3x3(tx, tk, tb)
    assert got.dtype == torch.bfloat16
    ref = _direct(tx.float(), tk.float(), tb.float())
    rel = float((got.float() - ref).abs().max() / ref.abs().max())
    assert rel <= 1.5e-2, rel
    assert float((got.float() - ref).norm() / ref.norm()) <= 5e-3


def test_precomputed_u_and_launch_count():
    x, k, bias = map(torch.from_numpy, _inputs(1, 8, 8, 16, 8, seed=6))
    before = W.wino3x3.launches
    a = W.wino3x3(x, k, bias)
    u = W.winograd_weights(k)
    b = W.wino3x3(x, k, bias, u=u)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(W.wino3x3_plain(x, u, bias), a, rtol=0, atol=0)
    assert W.wino3x3.launches == before  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        W.wino3x3(x, k, bias, u=u[:, :8])
    with pytest.raises(ValueError):
        W.wino3x3(x, k, bias[:4])


def test_supported_guard():
    """The shape rule of the JAX guard; its VMEM-fit clause is dropped, so
    the two shapes the TPU rejects for size are admitted here."""
    ok = W.wino3x3_supported
    assert ok((2, 32, 32, 640), (3, 3, 640, 640), 1, 1)
    assert ok((2, 8, 8, 1280), (3, 3, 1280, 1280), 1, None)
    assert JW.wino3x3_supported((2, 32, 32, 640), (3, 3, 640, 640), 1, 1)
    for shape, kshape in (((2, 64, 64, 320), (3, 3, 320, 320)),
                          ((2, 16, 16, 1280), (3, 3, 1280, 1280))):
        assert ok(shape, kshape, 1, 1) and not JW.wino3x3_supported(shape, kshape, 1, 1)
    for args in (((1, 9, 8, 128), (3, 3, 128, 128), 1, 1),   # odd plane
                 ((1, 8, 8, 128), (3, 3, 128, 128), 2, 1),   # stride 2
                 ((1, 8, 8, 128), (3, 3, 128, 128), 1, 0),   # no padding
                 ((1, 8, 8, 128), (1, 1, 128, 128), 1, 1),   # 1x1 kernel
                 ((1, 6, 6, 8), (3, 3, 8, 8), 1, 1)):        # plane below 8
        assert not ok(*args) and not JW.wino3x3_supported(*args)
    assert not ok((1, 8, 8, 16), (3, 3, 8, 8), 1, 1)  # channel mismatch
    x, k, bias = map(torch.from_numpy, _inputs(1, 6, 6, 8, 8))
    with pytest.raises(ValueError):
        W.wino3x3(x, k, bias)
