"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.
The library is built at first use into ``build/`` beside this file (listed
in ``.gitignore``), named by a hash of the sources and flags, so an edited
kernel rebuilds and an unchanged one loads in milliseconds. A plain-C build
takes seconds; binding through PyTorch's extension headers would take
minutes per build.

A missing ``nvcc``, a compile error or a load error raises
:class:`KernelBuildError`. There is no fallback: a wrapper that was handed a
CUDA tensor either launches its kernel or raises.

Each exported C function returns ``cudaGetLastError()`` after its launch
(0 = success); :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["KernelBuildError", "kernel_library", "check", "stream_ptr", "refuse_grad",
           "kernel_with_plain_vjp"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures of the exported launchers (all return an int cudaError_t)
_SIGNATURES = {
    # q, k, v, o, B, H, Sq, Skv, D, q_bstride, q_rstride, k_bstride,
    # k_rstride, v_bstride, v_rstride, scale, stream
    "cpd_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _F, _P),
    "cpd_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _L, _L, _L, _L, _L, _L, _F, _P),
    "cpd_attention_sm90_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _F, _P),
    "cpd_attention_f32_fused_sm90": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _L, _L, _L, _L, _L, _L, _F, _P),
    # D, int[4]: query rows, key tile, 1, smem bytes of the fused f32 block
    "cpd_attention_f32_fused_sm90_config": (_I, _P),
    # q, k, v, o, workspace, workspace floats, B, H, Sq, Skv, D, the strides as
    # above, scale, query rows a pass, int* kernels launched, stream
    "cpd_attention_f32_sm90": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _F, _I, _P, _P),
    # q, k, v, o, workspace, workspace bytes, then as cpd_attention_f32_sm90
    "cpd_attention_bf16_wide_sm90": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                     _L, _L, _L, _L, _L, _L, _F, _I, _P, _P),
    # q, k, v, o, B, H, Sq, Skv, D, then the element strides (batch, head,
    # d; for a canonical k: batch, head, key row) of q, k, v and o,
    # k_canonical, scale, stream
    "cpd_attention_cm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _I, _F, _P),
    "cpd_attention_cm_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                             _I, _F, _P),
    # K5's Hopper bodies: bf16 takes cpd_attention_cm_bf16's arguments
    "cpd_attention_cm_sm90_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                   _I, _F, _P),
    # q, k, v, o, workspace, workspace floats, B, H, Sq, Skv, D, the 12
    # strides, k_canonical, scale, query rows a pass (unfused), int* kernels
    # launched, stream
    "cpd_attention_cm_f32_sm90": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                  _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                  _I, _F, _I, _P, _P),
    # D, k_canonical, int[5]: query rows, key tile, stages, smem bytes, fused
    "cpd_attention_cm_sm90_bf16_config": (_I, _I, _P),
    "cpd_attention_cm_f32_sm90_config": (_I, _I, _P),
    # x, u, bias, y, B, H, W, C, Co, stream
    "cpd_wino3x3_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cpd_wino3x3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, u, bias, y, workspace, B, H, W, C, Co, U's row stride Cu, then the
    # plan (tw, splits, chunks_per_split), int* kernels launched, stream
    "cpd_wino3x3_sm90_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # K6's f32 Hopper body: the same arguments (x, u, bias and y in f32)
    "cpd_wino3x3_f32_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # x, w1, b1, w2, b2, hidden, out, ws1, ws2, M, C, H4, then the plan (bn1,
    # splits1, steps1, bn2, splits2, steps2), int* kernels launched, stream
    "cpd_geglu_ff_sm90_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _I, _I, _P, _P),
    # K2's f32 body: x, w1, b1, w2, b2, hidden, out, ws1, ws2, M, C, H4, then
    # the plan (splits1, steps1, splits2, steps2), int* kernels launched,
    # stream
    "cpd_geglu_ff_f32_sm90": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _P, _P),
    # x, gamma, beta, y, part, N, HW, C, G, S, eps, silu, stream
    "cpd_group_norm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "cpd_group_norm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # x, gamma, beta, y, parts, is_f32, N, HW, C, G, eps, silu, form, tiles,
    # int* kernels launched, stream
    "cpd_group_norm_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P, _P),
    # the two-source form: a, b, gamma, beta, ya, yb, parts, is_f32, N, HW,
    # Ca, Cb, G, eps, silu, form, tiles, int* kernels launched, stream
    "cpd_group_norm_cat_sm90": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                _I, _P, _P),
    # box_px, Ca, kc, esize, int* bytes of a two-source slab box
    "cpd_group_norm_cat_box_bytes": (_I, _I, _I, _I, _P),
    # int* bytes of a sample a slab block holds
    "cpd_group_norm_sm90_tile_max": (_P,),
    # x, w, bias, bias_is_f32, y, B, H, W, C, Co, stream
    "cpd_conv3x3_bf16": (_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # x, w, bias, y, B, H, W, C, Co, stream
    "cpd_conv3x3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w, bias, bias_is_f32, y, workspace, B, H, W, C, Co, the weight's
    # channel stride Cw, then the plan (wt, ht, splits, steps_per_split),
    # stream
    "cpd_conv3x3_sm90_bf16": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P),
    # K4's f32 body: x, w, bias, y, workspace, B, H, W, C, Co, Cw, then the
    # plan (wt, ht, splits, steps_per_split), stream
    "cpd_conv3x3_f32_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P),
    # K4's narrow bodies: x, w, bias, bias_is_f32, is_f32, y, B, H, W, C, Co,
    # stream
    "cpd_conv3x3_narrow": (_P, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _P),
    # iters, double* ns per encode, a device address to map
    "cpd_tmap_encode_bench": (_I, _P, _P),
    # the probes. K7: cpd_attention_bf16's arguments up to scale, then mode,
    # denom, use_exp2, unnormalized, kv_tile, stream (its replaced loop,
    # _prior, the same)
    "cpd_probe_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _I, _I, _P),
    "cpd_probe_attention_prior_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _I, _I, _P),
    # cpd_attention_f32's arguments up to scale, then mode, stream
    "cpd_probe_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _F, _I, _P),
    "cpd_probe_attention_prior_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _L, _L, _L, _L, _L, _L, _F, _I, _P),
    # cpd_attention_cm_bf16's arguments up to scale, then mode, stream
    "cpd_probe_attention_cm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                    _I, _F, _I, _P),
    "cpd_probe_attention_prior_cm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                          _I, _F, _I, _P),
    # K8: x, gamma, beta, y, parts, N, HW, C, G, eps, mode, mma, form, tiles,
    # runs, int* kernels launched, stream
    "cpd_probe_group_norm_sm90": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                                  _P, _P),
    # K8's replaced body: x, gamma, beta, y, part, N, HW, C, G, splits, eps,
    # mode, mma, stream
    "cpd_probe_group_norm_prior_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                        _P),
    # K9: x, y, N, HW, C, rows, convert, stages, stream
    "cpd_probe_copy_bf16": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # K9's Hopper body: x, y, tiles, tile bytes, then the plan (split, slot,
    # chunks, grid), stages, convert, int* kernels launched, stream
    "cpd_probe_copy_sm90_bf16": (_P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _P, _P),
}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be compiled or loaded."""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError(
        "nvcc not found (not on PATH and no CUDA toolkit under CUDA_HOME); "
        "the CUDA kernels of complex_prompt_diffusion_tpu_torch must be "
        "compiled on a machine with the CUDA toolkit"
    )


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources under {CSRC}")
    return srcs, sorted(CSRC.glob("*.cuh"))


def _finish(cmd, proc) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
        )


@functools.lru_cache(maxsize=None)
def kernel_library() -> ctypes.CDLL:
    """Compile (once per hash of sources and flags) and load the kernel
    library."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / f"cpd_kernels_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        # one nvcc per source, all started together, then one link
        jobs = []
        for src in srcs:
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            jobs.append((cmd, obj, proc))
        for cmd, _, proc in jobs:
            _finish(cmd, proc)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
        for _, obj, _ in jobs:
            obj.unlink()
        os.replace(tmp, lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise KernelBuildError(f"cannot load {lib_path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError as e:
            raise KernelBuildError(f"{lib_path} lacks the entry point {name}") from e
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err}")


def refuse_grad(what: str, *tensors) -> None:
    """Raise before a kernel body or probe launches where autograd would
    need to see through it.

    The CUDA kernels write into fresh buffers through ctypes, so a body's
    output carries no ``grad_fn``: under grad mode, with an argument that
    requires grad, a result would silently cut the graph. The seven dispatch
    entries (``flash_attention``, ``attention_dmajor``, ``geglu_ff``,
    ``group_norm_nhwc``, ``group_norm_silu_cat``, ``conv3x3``, ``wino3x3``)
    differentiate through :func:`kernel_with_plain_vjp` and call their
    bodies with grad off, so this raises only for a body or a probe (K7-K9,
    which have no backward rule in the JAX package either) called
    directly."""
    if _grad_wanted(tensors):
        raise RuntimeError(
            f"{what} has no backward rule of its own: its CUDA output would carry no "
            "gradient. Differentiate through its dispatch entry (flash_attention, "
            "attention_dmajor, geglu_ff, group_norm_nhwc, group_norm_silu_cat, conv3x3, "
            "wino3x3), or call it under torch.no_grad() or torch.inference_mode(), or on "
            "CPU tensors (the differentiable plain twin)")


def _grad_wanted(tensors) -> bool:
    import torch

    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


@functools.lru_cache(maxsize=None)
def _plain_vjp_function():
    """The ``torch.autograd.Function`` of :func:`kernel_with_plain_vjp`,
    made at first use (torch is imported lazily here)."""
    import torch

    class KernelWithPlainVJP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, kernel_fn, plain_fn, nondiff, *tensors):
            ctx.plain_fn, ctx.nondiff = plain_fn, nondiff
            ctx.save_for_backward(*tensors)  # the residuals: the inputs, as JAX's rules keep
            return kernel_fn(*tensors, *nondiff)

        @staticmethod
        def backward(ctx, *grad_outs):
            needs = ctx.needs_input_grad[3:]
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(n) if t is not None else None
                       for t, n in zip(ctx.saved_tensors, needs)]
                out = ctx.plain_fn(*ins, *ctx.nondiff)
                outs = out if isinstance(out, tuple) else (out,)
                pairs = [(o, g) for o, g in zip(outs, grad_outs) if g is not None]
                wrt = [t for t, n in zip(ins, needs) if n]
                grads = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                                 [g for _, g in pairs], allow_unused=True))
            return (None, None, None, *(next(grads) if n else None for n in needs))

    return KernelWithPlainVJP


def kernel_with_plain_vjp(kernel_fn, plain_fn, nondiff: tuple, *tensors):
    """``kernel_fn(*tensors, *nondiff)``, differentiable as
    ``plain_fn(*tensors, *nondiff)`` is: the port of the JAX package's
    ``jax.custom_vjp`` rules, whose forward is the Pallas kernel and whose
    backward recomputes the op in XLA and takes that op's VJP.

    Where grad mode is on and a tensor requires grad, the call runs in a
    ``torch.autograd.Function``: its forward launches the kernel (with grad
    off, so the body's :func:`refuse_grad` stays quiet) and saves the
    inputs; its backward recomputes ``plain_fn`` on them under grad and
    returns ``torch.autograd.grad`` of it for the cotangent (``None`` for
    an input that needs none, each gradient in its input's dtype). A kernel
    with several outputs returns them as a tuple, as ``plain_fn`` does; the
    backward takes a cotangent for each and passes the pairs whose
    cotangent is not ``None``. The
    backward launches no kernel: it is plain PyTorch (cuBLAS and cuDNN
    inside ``torch.matmul`` and the convs), as JAX's rule is XLA. Anywhere
    else the kernel runs alone. ``tensors`` may hold ``None``; ``nondiff``
    holds the rest of the arguments (heads, scale, groups, eps, flags,
    plans), as ``nondiff_argnums`` do in JAX."""
    if not _grad_wanted(tensors):
        return kernel_fn(*tensors, *nondiff)
    return _plain_vjp_function().apply(kernel_fn, plain_fn, nondiff, *tensors)


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
