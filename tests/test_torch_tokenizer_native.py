"""The port's native (C++) tokenizer: ids equal to the JAX package's native
tokenizer and to both packages' Python BPE tokenizers, on the synthetic
byte-level vocab of tests/test_tokenizer_native.py, over a fixed corpus;
the shared sequence contract; the build into the package's ``build/`` and
a failed build that raises with the compiler's output, every time.
"""

import os
import shutil
import stat
from pathlib import Path

import numpy as np
import pytest

from complex_prompt_diffusion_tpu.prompts import tokenizer as JT
from complex_prompt_diffusion_tpu.prompts import tokenizer_native as JTN
from complex_prompt_diffusion_tpu_torch.prompts import tokenizer as T
from complex_prompt_diffusion_tpu_torch.prompts import tokenizer_native as TN
from complex_prompt_diffusion_tpu_torch.tools import synth_vocab as SV

PROMPTS = [
    "the cat and the dog",
    "The CAT!",
    "a photo of 123 cats, high quality",
    "it's the dog's toy",
    "  spaces   everywhere   ",
    "punctuation!!! ... (parens) [brackets]",
    "mixed42numbers7and-dashes_underscores",
    "",
    "café naïve über",
    "we'll see, they've gone; I'm here, you're there, he'd go",

]


def _corpus(n=200, seed=0):
    """The prompts above and a fixed corpus of ``n`` strings of words,
    digits, punctuation, contractions, whitespace and lower-case non-ASCII
    letters (``tools/synth_vocab.py`` says why no others)."""
    return PROMPTS + SV.corpus(n, seed)


@pytest.fixture(scope="module")
def vocab_files(tmp_path_factory):
    return SV.write_synthetic_vocab(tmp_path_factory.mktemp("vocab"))


@pytest.fixture(scope="module")
def toks(vocab_files, tmp_path_factory):
    """The port's native and Python tokenizers, the JAX package's native
    (its own ``load_library`` and ``make``, run on a copy of ``native/`` so
    that it races no other test's build there; None where that fails) and
    Python ones."""
    d = tmp_path_factory.mktemp("native")
    for f in ("Makefile", "cpd_tokenizer.cpp"):
        shutil.copy(Path(JTN.__file__).resolve().parents[2] / "native" / f, d)
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (("_NATIVE_DIR", str(d)), ("_LIB", None), ("_LIB_FAILED", False)):
            mp.setattr(JTN, name, value)
        jnative = JTN.get_native_tokenizer(*vocab_files)
    return (TN.get_native_tokenizer(*vocab_files), T.ClipBPETokenizer(*vocab_files),
            jnative, JT.ClipBPETokenizer(*vocab_files))


def test_native_ids_equal_every_tokenizer(toks):
    native, py, jnative, jpy = toks
    assert jnative is not None, "the JAX package's native tokenizer did not build"
    for text in _corpus():
        ids = native.encode_text(text)
        assert ids == py.encode_text(text) == jpy.encode_text(text), text
        assert ids == jnative.encode_text(text), text


@pytest.mark.parametrize("text", ["<|startoftext|>the cat<|endoftext|>", "cats &amp; dogs",
                                  "Ñandú"])
def test_native_quirks_equal_jaxs_native(toks, text):
    """Where the C++ core differs from the Python tokenizers (the special
    tokens' text, which its splitter does not keep whole; HTML entities,
    which it does not unescape; upper-case non-ASCII letters, which it does
    not lower-case), in both packages alike: a reference-side
    difference, kept. The port's native ids equal the JAX package's."""
    native, py, jnative, _ = toks
    assert native.encode_text(text) == jnative.encode_text(text)
    assert native.encode_text(text) != py.encode_text(text)


@pytest.mark.parametrize("pad_with_eos", [True, False])
def test_sequence_contract_equals_jax(vocab_files, pad_with_eos):
    """BOS, EOS, the padding (EOS for SD 1.x, 0 for SD 2.x) and the 77-token
    cut, from the shared base class, on long and short prompts."""
    native = TN.get_native_tokenizer(*vocab_files, pad_with_eos=pad_with_eos)
    jpy = JT.ClipBPETokenizer(*vocab_files, pad_with_eos=pad_with_eos)
    texts = ["the cat and the dog", "a " * 120, ""]
    got, want = native(texts), jpy(texts)
    assert got.shape == (3, 77) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (native.bos_id, native.eos_id, native.pad_id) == (jpy.bos_id, jpy.eos_id, jpy.pad_id)
    np.testing.assert_array_equal(native(texts, max_length=12), jpy(texts, max_length=12))


def test_library_builds_into_the_package(toks):
    """The port builds its own copy of the source into its git-ignored
    ``build/``, named by a hash of the source and flags; never into
    ``native/``."""
    lib = TN.load_library()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == os.path.realpath(TN.BUILD_DIR)
    assert os.path.basename(path).startswith("libcpd_tokenizer_")
    assert TN.SOURCE.parent.name == "prompts" and TN.SOURCE.suffix == ".cpp"


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """A compiler that fails: TokenizerBuildError with its output, on every
    call (no cached failure, unlike the JAX package's ``load_library``)."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cpd_tokenizer.cpp:1: error: fake compiler error' >&2\n"
                   "exit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "build")
    TN.load_library.cache_clear()
    try:
        for _ in range(2):
            with pytest.raises(TN.TokenizerBuildError, match="failed \\(3\\)(.|\n)*fake compiler"):
                TN.load_library()
        assert not list((tmp_path / "build").glob("*.so"))
    finally:
        TN.load_library.cache_clear()
