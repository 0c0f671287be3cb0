"""Port parity of the host-side prompt algebra: the weighted-prompt parser,
the mask DSL, the interpolations, the transforms, the schedule grammar and
the prompts' JSON.

Where the port's module is a copy of the JAX package's numpy code (parse,
masks, interp, transforms) the outputs must be equal, not close. The
schedule grammar is parsed by lark's Earley parser in the JAX package and
by a hand-written parser in the port: both must give the same expansion,
or both raise, over the reference's doctest table, the grammar's known
quirks, a fixed seeded corpus of 2000 strings built from the grammar's
constructs and 500 random strings over its characters, at 1, 4 and 10
steps.
"""

import copy
import json
import pathlib
import subprocess
import sys

import lark
import numpy as np
import pytest

from complex_prompt_diffusion_tpu.prompts import compose as JC
from complex_prompt_diffusion_tpu.prompts import interp as JI
from complex_prompt_diffusion_tpu.prompts import masks as JMK
from complex_prompt_diffusion_tpu.prompts import parse as JPA
from complex_prompt_diffusion_tpu.prompts import schedule as JS
from complex_prompt_diffusion_tpu.prompts import transforms as JT
from complex_prompt_diffusion_tpu_torch import prompts as PROMPTS
from complex_prompt_diffusion_tpu_torch.prompts import compose as C
from complex_prompt_diffusion_tpu_torch.prompts import interp as I
from complex_prompt_diffusion_tpu_torch.prompts import masks as MK
from complex_prompt_diffusion_tpu_torch.prompts import parse as PA
from complex_prompt_diffusion_tpu_torch.prompts import schedule as S
from complex_prompt_diffusion_tpu_torch.prompts import transforms as T

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ---- the weighted-prompt parser ----

@pytest.mark.parametrize("text", [
    "", "a cat", "a cat:2.0 a dog:1.0", "a cat:2 a dog", "a:b:c", "x: 3", "x:abc rest",
    "a cat:0.5", ":", "a:", "a: b:1.5 c", "red:1e-1 blue:-2 green",
])
def test_parse_weighted_prompt_equals_jax(text):
    assert PA.parse_weighted_prompt(text) == JPA.parse_weighted_prompt(text)


# ---- the mask DSL ----

_DIRECTIONS = ("top", "t", "north", "bottom", "bot", "b", "south", "left", "l", "west", "right",
               "r", "east")


@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (8, 6), (13, 3), (64, 64)])
def test_masks_equal_jax(hw):
    h, w = hw
    n = 0
    for d in _DIRECTIONS:
        for size in MK._SIZES:
            for minority in MK._MINOR_VALID + MK._MINOR_HIDDEN:
                style = f"{d}_{size}_{minority}"
                got = MK.make_mask(style, h, w)
                assert got.dtype == np.float32 and got.shape == (h, w)
                np.testing.assert_array_equal(got, JMK.make_mask(style, h, w))
                n += 1
        for style in (d, f"{d}_third"):  # the size and minority defaults
            np.testing.assert_array_equal(MK.make_mask(style, h, w), JMK.make_mask(style, h, w))
    assert n == len(_DIRECTIONS) * len(MK._SIZES) * 7
    assert MK._SIZES == JMK._SIZES and MK._SIZES["fifrth"] == 5  # the typo alias


def test_mask_perspective_and_errors_equal_jax():
    np.testing.assert_array_equal(MK.make_mask("perspective", 9, 9),
                                  JMK.make_mask("perspective", 9, 9))
    for style in ("middle_half_valid", "left_eleventh_valid", "left_half_maybe"):
        for fn in (MK.make_mask, JMK.make_mask):
            with pytest.raises(ValueError):
                fn(style, 4, 4)


# ---- interpolation ----

def _pair(seed, shape=(6, 16)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


@pytest.mark.parametrize("t", [0.0, 0.3, 0.5, 1.0, 1.4, -0.2])
def test_slerp_lerp_equal_jax(t):
    a, b = _pair(1)
    np.testing.assert_array_equal(I.slerp(a, b, t), JI.slerp(a, b, t))
    np.testing.assert_array_equal(I.lerp(a, b, t), JI.lerp(a, b, t))
    # |dot| above the threshold falls back to lerp; both range-clip
    np.testing.assert_array_equal(I.slerp(a, a + 1e-4 * b, t), JI.slerp(a, a + 1e-4 * b, t))
    np.testing.assert_array_equal(I.slerp(a, b, t, threshold=0.0),
                                  JI.slerp(a, b, t, threshold=0.0))


def test_plerp_and_bleed_equal_jax():
    rng = np.random.default_rng(2)
    xp, yp = rng.normal(size=(3, 4)), rng.normal(size=(3, 4))
    for x in (-2.0, 0.1, 0.7, 3.0):
        np.testing.assert_array_equal(I.plerp(xp, yp, x), JI.plerp(xp, yp, x))
    d = rng.normal(size=(77, 32))
    np.testing.assert_array_equal(I.bleed(d), JI.bleed(d))
    np.testing.assert_array_equal(I.bleed(d[None]), JI.bleed(d[None]))
    assert I.interpolate_lookup.keys() == JI.interpolate_lookup.keys()


# ---- transforms ----

def _embeddings(seed, t=12, e=24):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(t, e)).astype(np.float32)
    b = (a + rng.normal(size=(t, e)) * 0.7).astype(np.float32)
    return a, b


_MAPS = ([1, 5, 7, 7, 9, 2, 2, 0, 0, 0, 0, 0], [1, 5, 8, 7, 4, 2, 3, 0, 0, 0, 0, 0])

TRANSFORM_ARGS = [
    {},
    dict(token_k=4, embed_k=5),
    dict(token_k=4, embed_k=5, token_largest=False, embed_largest=False),
    dict(token_k=None, token_range=(2, 9), embed_range=(3, 20), embed_k=4),
    dict(token_k=None, token_range=(2, 9), token_idxs=[3, 5], embed_idxs=[1, 2, 7, 9], embed_k=3),
    dict(token_k=0),
    dict(token_k=5, do_bleed=True, delta_mult=0.8, static_mult=1.1),
    dict(lerp_mode="lerp", magnitude=0.6, token_k=6),
]


@pytest.mark.parametrize("args", TRANSFORM_ARGS, ids=range(len(TRANSFORM_ARGS)))
def test_prompt_lerp_step_equals_jax(args):
    """One step with and without token maps (repeated-token masking)."""
    a, b = _embeddings(3)
    got_t, want_t = T.PromptLerpTransform(dict(args)), JT.PromptLerpTransform(dict(args))
    for maps in (None, _MAPS):
        np.testing.assert_array_equal(got_t.step(a, b, got_t.args, maps),
                                      want_t.step(a, b, want_t.args, maps))


@pytest.mark.parametrize("steps", [1, 3, 4])
@pytest.mark.parametrize("lerp_keys", [[], ["magnitude"], ["magnitude", "token_k", "embed_range",
                                                          "do_bleed"]])
def test_prompt_lerp_apply_equals_jax(steps, lerp_keys):
    """The path over ``steps`` with params lerp'd by (s + 1) / steps: floats,
    ints, a pair and a bool among the lerp keys; bleed on."""
    a, b = _embeddings(4)
    args = dict(magnitude=0.9, token_k=8, embed_k=10, embed_range=(2, 20), do_bleed=True,
                lerp_keys=lerp_keys)
    got = T.PromptLerpTransform(dict(args)).apply(a, b, steps, _MAPS)
    want = JT.PromptLerpTransform(dict(args)).apply(a, b, steps, _MAPS)
    assert len(got) == len(want) == (steps if lerp_keys else 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_config_lerp_valid_range_and_registry_equal_jax():
    args = {"lerp_keys": ["scale", "steps", "pair", "flag"]}
    target = {"scale": 7.5, "steps": 40, "pair": (2.0, 4.0), "flag": True, "name": "x"}
    got = list(T.ConfigLerpTransform(args, target).apply(4))
    assert got == list(JT.ConfigLerpTransform(args, target).apply(4))
    for size, r, idxs in ((10, None, None), (10, (8, 3), None), (10, (1, 30), [2, 6]),
                          (5, (-4, 2), None)):
        assert T.valid_range(size, r, idxs) == JT.valid_range(size, r, idxs)
    assert T.TRANSFORM_REGISTRY.keys() == JT.TRANSFORM_REGISTRY.keys()
    assert {"LerpCLIPEmbeddingTransform", "SampleConfigTransform"} <= T.TRANSFORM_REGISTRY.keys()


# ---- the schedule grammar ----

# the reference's doctest table (tests/test_prompts.py), at 10 steps
DOCTEST = [
    ("test", [[10, "test"]]),
    ("a [b:3]", [[3, "a "], [10, "a b"]]),
    ("a [b: 3]", [[3, "a "], [10, "a b"]]),
    ("a [[[b]]:2]", [[2, "a "], [10, "a [[b]]"]]),
    ("[(a:2):3]", [[3, ""], [10, "(a:2)"]]),
    ("a [b : c : 1] d", [[1, "a b  d"], [10, "a  c  d"]]),
    ("a[b:[c:d:2]:1]e", [[1, "abe"], [2, "ace"], [10, "ade"]]),
    ("a [unbalanced", [[10, "a [unbalanced"]]),
    ("a [b:.5] c", [[5, "a  c"], [10, "a b c"]]),
    ("a [{b|d{:.5] c", [[10, "a [{b|d{:.5] c"]]),
    ("((a][:b:c [d:3]", [[3, "((a][:b:c "], [10, "((a][:b:c d"]]),
]


@pytest.mark.parametrize("prompt,expected", DOCTEST)
def test_schedule_doctest_table(prompt, expected):
    assert S.expand_schedule(prompt, 10) == expected == JS.expand_schedule(prompt, 10)


# (prompt, steps, expected): the grammar's quirks, each pinned in both packages
QUIRKS = [
    ("[a:b:-1]", 4, [[-4, "a"], [4, "b"]]),  # a negative number: a negative boundary
    ("[a:b:0]", 4, [[0, "a"], [4, "b"]]),
    ("[[a:2]|b]", 4, [[1, ""], [2, "b"], [3, "a"], [4, "b"]]),  # an alternate's first item
    ("[a:[b|c]:0.5]", 4, [[1, "a"], [2, "a"], [3, "b"], [4, "c"]]),
    ("[cow|horse] field", 4, [[1, "cow field"], [2, "horse field"], [3, "cow field"],
                              [4, "horse field"]]),
    ("[ a|b]", 2, [[1, " a"], [2, "b"]]),  # a leading space: one plain run
    ("[(x)|b]", 2, [[1, "("], [2, "b"]]),  # an emphasis: its first bracket
    ("[a:1] b]", 4, [[1, " b]"], [4, "a b]"]]),  # a stray bracket: a literal token
    ("a|b", 4, [[4, "a|b"]]),  # a bar outside brackets: no parse, one constant entry
    ("a\\", 4, [[4, "a\\"]]),  # a trailing backslash: no parse
    ("[a|]", 1, [[1, "a"]]),  # the empty option is never chosen at 1 step
    ("[a:b:3]", 1, [[1, "a"]]),  # min(steps, when)
    ("[a:b:0.25]", 10, [[2, "a"], [10, "b"]]),  # int(2.5)
]


@pytest.mark.parametrize("prompt,steps,expected", QUIRKS, ids=range(len(QUIRKS)))
def test_schedule_quirks(prompt, steps, expected):
    assert S.expand_schedule(prompt, steps) == expected == JS.expand_schedule(prompt, steps)


@pytest.mark.parametrize("prompt,steps", [("[a|]", 4), ("[|a]", 1), ("[a||b]", 2),
                                          ("(.[|]\\ b][)", 4), ("x [[a|]:b:2]", 4)])
def test_schedule_empty_alternate_raises_in_both(prompt, steps):
    """The JAX package's renderer raises lark's VisitError when an alternate
    renders an empty option (outside its try); the port raises ValueError."""
    with pytest.raises(lark.exceptions.VisitError):
        JS.expand_schedule(prompt, steps)
    with pytest.raises(ValueError):
        S.expand_schedule(prompt, steps)


_WORDS = ("a", "b", "cat", "dog", "a red fox", "x", " ", "  ", "blue sky ", " c", "\\[", "d\\:e")
_NUMS = ("-1", "0", "0.25", "0.5", "1", "3", "12")


def _construct(rng, depth: int) -> str:
    """One of the grammar's constructs, nested to ``depth`` more levels:
    [a:b:N], [a:N], [a::N], [a|b|c], (x:1.2), [x], (x) or plain text."""
    def part():
        if depth <= 0 or rng.random() < 0.55:
            return _WORDS[rng.integers(len(_WORDS))] if rng.random() > 0.08 else ""
        return _construct(rng, depth - 1)

    def seq():
        return "".join(part() for _ in range(rng.integers(1, 3)))

    n = _NUMS[rng.integers(len(_NUMS))]
    sp = " " if rng.random() < 0.2 else ""
    k = rng.integers(8)
    if k == 0:
        return f"[{seq()}:{seq()}:{sp}{n}]"
    if k == 1:
        return f"[{seq()}:{sp}{n}]"
    if k == 2:
        return f"[{seq()}::{sp}{n}]"
    if k == 3:
        return "[" + "|".join(seq() for _ in range(rng.integers(2, 4))) + "]"
    if k == 4:
        return f"({seq()}:1.2)"
    if k == 5:
        return f"[{seq()}]"
    if k == 6:
        return f"({seq()})"
    return seq()


def _corpus(n: int = 2000, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = [_construct(rng, int(rng.integers(0, 4))) for _ in range(rng.integers(1, 4))]
        out.append((" ", "", ", ")[rng.integers(3)].join(parts))
    return out


def _random_strings(n: int = 500, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    alphabet = list("ab :|[]()\\.5")
    return ["".join(rng.choice(alphabet, size=rng.integers(1, 21))) for _ in range(n)]


CORPUS = _corpus() + _random_strings()
CHUNKS = 10


def _jax_expansions(prompt: str, steps_list) -> list:
    """``JS.expand_schedule`` at each step count, the string parsed once:
    the same calls on a fresh copy of the tree for each count."""
    try:
        tree = JS._parser().parse(prompt)
    except lark.exceptions.LarkError:
        return [("ok", [[steps, prompt]]) for steps in steps_list]
    out = []
    for steps in steps_list:
        t = copy.deepcopy(tree)
        try:
            out.append(("ok", [[b, JS._render_at(t, b)] for b in JS._boundaries(t, steps)]))
        except lark.exceptions.VisitError:
            out.append(("raise", None))
    return out


def _port_expansion(prompt: str, steps: int):
    try:
        return "ok", S.expand_schedule(prompt, steps)
    except ValueError:
        return "raise", None


def test_schedule_corpus_is_fixed():
    """The corpus is the seeded one its counts were taken on (the JAX
    package raises on 238 of its 7500 expansions)."""
    assert len(CORPUS) == 2500 and len(set(CORPUS)) > 2300
    assert CORPUS[0] == _corpus(1)[0] and CORPUS[-1] == _random_strings()[-1]
    nested = sum(1 for p in CORPUS[:2000] if p.count("[") + p.count("(") >= 3)
    assert nested > 400


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_schedule_matches_lark_on_the_corpus(chunk):
    """Every string of this tenth of the corpus at 1, 4 and 10 steps: the
    same expansion, or both raise."""
    steps_list = (1, 4, 10)
    bad = []
    for prompt in CORPUS[chunk::CHUNKS]:
        want = _jax_expansions(prompt, steps_list)
        for steps, w in zip(steps_list, want):
            got = _port_expansion(prompt, steps)
            if got != w:
                bad.append((prompt, steps, got, w))
    assert not bad, bad[:5]


def test_get_prompt_sequence_equals_jax():
    prompts = ["a [b:c:0.5]", "[x|y] z", "a [b:c:0.5]", "plain"]
    assert S.get_prompt_sequence(prompts, 6) == JS.get_prompt_sequence(prompts, 6)


# ---- JSON across the packages ----

def _compositional(mod):
    p = mod.CompositionalPrompt("a castle", negative_prompt="blurry", scale=1.2,
                                mask="left_half_valid")
    p.add_conjunction("a dragon", scale=1.5, mask="right_third_valid")
    p.add_negation("fog", scale=0.5, mask=np.eye(4, dtype=np.float32))
    p.add_filter(mod.WeightedPrompt("a cat:2.0 a dog:1.0"), strength=-0.7)
    p.add_transform(mod.PromptLerpTransform({"magnitude": 0.5, "lerp_keys": ["magnitude"]}))
    return p


def test_prompt_json_loads_across_packages():
    """JSON written by either package loads in the other, to an equal dict
    and the same class at every level."""
    for src, dst in ((JC, C), (C, JC)):
        data = json.loads(_compositional(src).to_json_string())
        obj = dst.prompt_from_json(data)
        assert type(obj).__name__ == "CompositionalPrompt"
        assert obj.to_json() == data
        assert [type(n).__name__ for n in obj._negations] == ["ComplexPrompt", "WeightedPrompt"]
        assert type(obj.transforms[0]).__name__ == "PromptLerpTransform"
    wp = C.WeightedPrompt("a cat:2.0 a dog:1.0", scale=2.0)
    assert JC.prompt_from_json(wp.to_json()).to_json() == wp.to_json()
    assert C.PROMPT_REGISTRY.keys() == JC.PROMPT_REGISTRY.keys()
    for name, mod in (("LerpCLIPEmbeddingTransform", T), ("SampleConfigTransform", T)):
        t = mod.transform_from_json({"class": name, "args": {"x": 1}})
        assert JT.transform_from_json(t.to_json()).to_json() == t.to_json()
    with pytest.raises(KeyError):
        C.prompt_from_json({"class": "os.system"})


def test_prompts_package_exports_and_imports_no_lark():
    assert set(PROMPTS.__all__) == set(__import__(
        "complex_prompt_diffusion_tpu.prompts", fromlist=["x"]).__all__)
    code = ("import sys; import complex_prompt_diffusion_tpu_torch.prompts as p; "
            "p.expand_schedule('[a:b:0.5] c', 4); "
            "import complex_prompt_diffusion_tpu_torch.manager, complex_prompt_diffusion_tpu_torch.render; "
            "assert not {'lark', 'jax'} & set(sys.modules), sorted(sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
