"""ctypes binding of the native C++ BPE tokenizer (``cpd_tokenizer.cpp``
beside this file).

Counterpart of ``complex_prompt_diffusion_tpu/prompts/tokenizer_native.py``:
the C++ core does the splitting, the byte mapping and the BPE merges of
:class:`~.tokenizer.ClipBPETokenizer`'s ``encode_text``; the sequence
contract (BOS, EOS, padding, 77) stays in the shared Python base class.

The library is built at first use by the host C++ compiler (``$CXX``, else
``g++``) into the package's ``build/`` directory (listed in
``.gitignore``), named by a hash of the source and the flags, so an
unchanged source loads at once. Unlike the JAX package's ``load_library``,
which caches a failed build and returns None from then on, a failed build
raises :class:`TokenizerBuildError` with the compiler's output, every
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import ClipBPETokenizer, _TokenizerBase

__all__ = ["NativeClipTokenizer", "TokenizerBuildError", "get_native_tokenizer",
           "load_library"]

SOURCE = Path(__file__).resolve().parent / "cpd_tokenizer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")


class TokenizerBuildError(RuntimeError):
    """The native tokenizer could not be compiled or loaded."""


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per hash of the source and flags) and load
    ``libcpd_tokenizer``; raises :class:`TokenizerBuildError`."""
    cxx = os.environ.get("CXX", "g++")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib_path = BUILD_DIR / f"libcpd_tokenizer_{h.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise TokenizerBuildError(f"cannot run {' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise TokenizerBuildError(
                f"{cxx} failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib_path)
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError as e:
        raise TokenizerBuildError(f"cannot load {lib_path}: {e}") from e
    lib.cpd_tok_create.restype = ctypes.c_void_p
    lib.cpd_tok_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.cpd_tok_encode.restype = ctypes.c_int
    lib.cpd_tok_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.cpd_tok_bos.restype = ctypes.c_int
    lib.cpd_tok_bos.argtypes = [ctypes.c_void_p]
    lib.cpd_tok_eos.restype = ctypes.c_int
    lib.cpd_tok_eos.argtypes = [ctypes.c_void_p]
    lib.cpd_tok_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeClipTokenizer(_TokenizerBase):
    """C++-backed tokenizer with the vocab and merges of a
    :class:`ClipBPETokenizer`, sharing its sequence contract."""

    def __init__(self, py_tok: ClipBPETokenizer):
        lib = load_library()
        self._lib = lib
        # the vocab in id order, the merges in rank order
        id_to_tok = sorted(py_tok.encoder.items(), key=lambda kv: kv[1])
        vocab_buf = "\n".join(t for t, _ in id_to_tok).encode("utf-8")
        merges = sorted(py_tok.bpe_ranks.items(), key=lambda kv: kv[1])
        merges_buf = "\n".join(f"{a} {b}" for (a, b), _ in merges).encode("utf-8")
        self._handle = lib.cpd_tok_create(vocab_buf, merges_buf)
        self.bos_id = lib.cpd_tok_bos(self._handle)
        self.eos_id = lib.cpd_tok_eos(self._handle)
        self.pad_id = py_tok.pad_id
        self._buf = (ctypes.c_int * 4096)()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.cpd_tok_destroy(self._handle)
            self._handle = None

    def encode_text(self, text: str) -> List[int]:
        n = self._lib.cpd_tok_encode(self._handle, text.encode("utf-8"), self._buf,
                                     len(self._buf))
        return list(self._buf[:n])


def get_native_tokenizer(vocab_path: str, merges_path: Optional[str] = None,
                         pad_with_eos: bool = True) -> NativeClipTokenizer:
    """A native tokenizer from vocab files (``ClipBPETokenizer``'s formats).
    Where the JAX package returns None on any failure, this raises."""
    return NativeClipTokenizer(ClipBPETokenizer(vocab_path, merges_path, pad_with_eos))
