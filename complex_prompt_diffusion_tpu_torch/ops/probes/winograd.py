"""Winograd F(2x2,3x3) conv3x3 with the K6 CUDA kernel (an opt-in probe).

Counterpart of ``complex_prompt_diffusion_tpu/ops/probes/winograd.py``:
the same 3x3 stride-1 'same' conv as ``ops/conv.py`` computed with 16
multiplies per 2x2 output tile (4 per output point instead of 9), at the
price of add-only tile transforms. As in the JAX package, no layer
dispatches it: ``models/layers.conv2d`` never calls it.

  * ``U = G g G^T`` (:func:`winograd_weights`, f32 math, then cast to x's
    dtype) is computed here in the wrapper;
  * the kernel (``csrc/winograd.cu``) gathers each 4x4 input tile with its
    halo from NHWC x, transforms it (``V = B^T d B``: adds only, in f32,
    rounded once to x's dtype), takes the 16 products ``V_ij [tiles, C] x
    U_ij [C, Co]`` with f32 accumulation, applies the output transform
    ``A^T M A`` and the bias in f32 and writes NHWC. The transformed tiles
    never reach device memory.

Numerics: the weight transform's halves are exact in bf16 and f32; in bf16
the rounding of V and U gives about 5e-3 relative deviation from the direct
bf16 conv, the same order as that conv's own deviation from f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["wino3x3", "wino3x3_plain", "wino3x3_supported", "winograd_weights"]

# G for F(2x2,3x3): exact in bf16/f32 except the halves (exact in f32).
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
# A^T rows (output transform): y0 = m0+m1+m2, y1 = m1-m2-m3
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))


_G_ON = {}  # device -> G, copied to a device once, so a CUDA graph can capture the transform


def winograd_weights(kernel):
    """[3, 3, C, Co] -> U = G g G^T as [16, C, Co] (f32 math)."""
    g = _G_ON.get(kernel.device)
    if g is None:
        g = _G_ON[kernel.device] = torch.tensor(_G, dtype=torch.float32, device=kernel.device)
    u = torch.einsum("ik,klcf->ilcf", g, kernel.float())
    u = torch.einsum("ilcf,jl->ijcf", u, g)
    return u.reshape(16, kernel.shape[2], kernel.shape[3])


def wino3x3_supported(x_shape, k_shape, stride: int, padding) -> bool:
    """The shape rule of the JAX guard: stride-1 3x3 'same' convs (padding 1
    or the default) on even planes with H, W >= 8. ``k_shape`` is HWIO. The
    JAX guard's second clause, that the working set fits the TPU's VMEM, has
    no counterpart on this card and is dropped."""
    if stride != 1 or padding not in (None, 1):
        return False
    if len(k_shape) != 4 or k_shape[0] != 3 or k_shape[1] != 3:
        return False
    _, h, w, c = x_shape
    if h % 2 or w % 2 or h < 8 or w < 8:
        return False
    return k_shape[2] == c


def _butterfly(a0, a1, a2, a3):
    """B^T applied along one axis of a 4-vector of planes."""
    return a0 - a2, a1 + a2, a2 - a1, a1 - a3


def wino3x3_plain(x, u, bias):
    """Plain PyTorch twin of K6, the kernel's arithmetic: 4x4 input tiles
    from a zero-padded f32 copy of x, ``B^T d B`` in f32 rounded once to x's
    dtype, the 16 products in f32 (exact products of the rounded values,
    f32 sums; PyTorch runs f32 matmuls without TF32 by default), ``A^T M A``
    and the bias in f32, one rounding to x's dtype. ``u``: [16, C, Co] in
    x's dtype."""
    b, h, w, _ = x.shape
    th, tw = h // 2, w // 2
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    # d[k][l]: element (k, l) of every tile, [B, TH, TW, C]
    d = [[xp[:, k:k + 2 * th:2, l:l + 2 * tw:2] for l in range(4)] for k in range(4)]
    wk = [_butterfly(*d[k]) for k in range(4)]  # wk[k][j]
    y = [[None, None], [None, None]]
    for j in range(4):
        col = _butterfly(wk[0][j], wk[1][j], wk[2][j], wk[3][j])  # V_ij over i
        for i in range(4):
            v = col[i].to(x.dtype).float()
            m = torch.matmul(v, u[i * 4 + j].float())
            for a in range(2):
                for bb in range(2):
                    coeff = _AT[a][i] * _AT[bb][j]
                    if coeff:
                        t = m if coeff > 0 else -m
                        y[a][bb] = t if y[a][bb] is None else y[a][bb] + t
    bias = bias.float()
    rows = [torch.stack([y[a][0] + bias, y[a][1] + bias], dim=3) for a in range(2)]
    out = torch.stack(rows, dim=2)  # [B, TH, 2, TW, 2, Co]
    return out.reshape(b, h, w, -1).to(x.dtype)


def wino3x3(x, kernel, bias, u=None):
    """K6 wrapper: 3x3 stride-1 'same' conv + bias via Winograd F(2x2,3x3),
    NHWC ``x`` [B, H, W, C] x HWIO ``kernel`` [3, 3, C, Co].

    ``u``: ``winograd_weights(kernel).to(x.dtype)`` computed ahead, for a
    caller that reuses one weight over many calls; by default it is
    computed here. CPU tensors run :func:`wino3x3_plain`. CUDA tensors
    launch ``csrc/winograd.cu`` (bf16 on the tensor cores with C % 8 == 0
    and Co % 8 == 0; f32 with exact FMAs and Co % 4 == 0) or raise. Shapes
    outside :func:`wino3x3_supported` raise on every device.
    ``wino3x3.launches`` counts kernel launches."""
    if x.ndim != 4 or not wino3x3_supported(x.shape, kernel.shape, 1, 1):
        raise ValueError(
            f"wino3x3 takes NHWC x with even H, W >= 8 and a [3, 3, C, Co] kernel; "
            f"got x{tuple(x.shape)} kernel{tuple(kernel.shape)}"
        )
    b, h, w, c = x.shape
    co = kernel.shape[3]
    if tuple(bias.shape) != (co,):
        raise ValueError(f"bias{tuple(bias.shape)} does not match Co={co}")
    if u is None:
        u = winograd_weights(kernel).to(x.dtype)
    elif tuple(u.shape) != (16, c, co) or u.dtype != x.dtype:
        raise ValueError(f"u must be [16, {c}, {co}] in {x.dtype}")
    if not x.is_cuda:
        return wino3x3_plain(x, u, bias)
    lib = _build.kernel_library()
    if x.dtype == torch.bfloat16:
        if c % 8 or co % 8:
            raise ValueError(f"K6 bf16 needs C % 8 == 0 and Co % 8 == 0; got {c}, {co}")
        fn = lib.cpd_wino3x3_bf16
    elif x.dtype == torch.float32:
        if co % 4:
            raise ValueError(f"K6 f32 needs Co % 4 == 0; got {co}")
        fn = lib.cpd_wino3x3_f32
    else:
        raise TypeError(f"K6 supports bfloat16 and float32 activations, got {x.dtype}")
    x = x.contiguous()
    u = u.contiguous()
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((b, h, w, co), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), u.data_ptr(), bias.data_ptr(), y.data_ptr(), b, h, w, c, co,
             _build.stream_ptr(x.device))
    _build.check(err, "Winograd conv3x3 (K6)")
    wino3x3.launches += 1
    return y


wino3x3.launches = 0
