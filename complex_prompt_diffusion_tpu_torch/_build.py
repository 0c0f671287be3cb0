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

__all__ = ["KernelBuildError", "kernel_library", "check", "stream_ptr"]

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
    # q, k, v, o, B, H, Sq, Skv, D, then the element strides (batch, head,
    # d; for a canonical k: batch, head, key row) of q, k, v and o,
    # k_canonical, scale, stream
    "cpd_attention_cm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                              _I, _F, _P),
    "cpd_attention_cm_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                             _I, _F, _P),
    # x, u, bias, y, B, H, W, C, Co, stream
    "cpd_wino3x3_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cpd_wino3x3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x, w1, b1, hidden, M, C, H4, stream
    "cpd_geglu_gemm1_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    # hidden, w2, b2, out, M, H4, C, stream
    "cpd_geglu_gemm2_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, gamma, beta, y, part, N, HW, C, G, S, eps, silu, stream
    "cpd_group_norm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "cpd_group_norm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    # x, w, bias, bias_is_f32, y, B, H, W, C, Co, stream
    "cpd_conv3x3_bf16": (_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P),
    # x, w, bias, y, B, H, W, C, Co, stream
    "cpd_conv3x3_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # the probes. K7: cpd_attention_bf16's arguments up to scale, then mode,
    # denom, use_exp2, unnormalized, kv_tile, stream
    "cpd_probe_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _L, _L, _L, _L, _L, _L, _F, _I, _I, _I, _I, _I, _P),
    # cpd_attention_f32's arguments up to scale, then mode, stream
    "cpd_probe_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _F, _I, _P),
    # cpd_attention_cm_bf16's arguments up to scale, then mode, stream
    "cpd_probe_attention_cm_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                    _I, _F, _I, _P),
    # K8: x, gamma, beta, y, part, N, HW, C, G, splits, eps, mode, mma, stream
    "cpd_probe_group_norm_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    # K9: x, y, N, HW, C, rows, convert, stages, stream
    "cpd_probe_copy_bf16": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
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


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer value."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
