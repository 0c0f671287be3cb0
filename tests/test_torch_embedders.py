"""Port parity: the T5 encoder and the transformer text encoder
(``models/embedders.py``) against the JAX package's.

The JAX trees (numpy, from the JAX init) reach the port through
``convert.embedder_params``; tokens are drawn from numpy with fixed
seeds. f32 on the CPU. The cases mirror ``tests/test_embedders.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu.models import embedders as JE
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch.models import embedders as E
from complex_prompt_diffusion_tpu_torch.tools.synth_checkpoint import hf_t5_state_dict

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

# f32 encoders of 2-6 layers: einsum and matmul orders differ between XLA
# and PyTorch; the largest difference seen is ~2e-6 on outputs of unit scale
ATOL = RTOL = 2e-5


def _tokens(seed, n, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(n, s)).astype(np.int32)


def _jax_tree(init, cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), cfg, commit=False))


def test_t5_config_presets_equal():
    for name in ("v1_1_large", "tiny"):
        assert dataclasses.asdict(getattr(E.T5Config, name)()) == dataclasses.asdict(
            getattr(JE.T5Config, name)())


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_bucket_equal(bidirectional):
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        np.testing.assert_array_equal(
            E.relative_position_bucket(rel, buckets, dist, bidirectional),
            JE.relative_position_bucket(rel, buckets, dist, bidirectional))


def test_t5_encode_matches_jax():
    """``T5Config.tiny`` on JAX's init, two sequences of 12 tokens."""
    cfg = E.T5Config.tiny()
    jtree = _jax_tree(JE.init_t5_encoder, JE.T5Config.tiny())
    tokens = _tokens(1, 2, 12, cfg.vocab_size)
    want = np.asarray(JE.t5_encode(JE.T5Config.tiny(), jtree, jnp.asarray(tokens)))
    got = E.t5_encode(cfg, convert.embedder_params(jtree), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_t5_bidirectional_and_port_init():
    """A later token changes earlier positions (no causal mask); the port's
    own init has JAX's tree structure and shapes."""
    cfg = E.T5Config.tiny()
    params = E.init_t5_encoder(torch.Generator().manual_seed(0), cfg)
    t1 = torch.tensor([[1, 5, 9, 2]])
    t2 = t1.clone()
    t2[0, 3] = 700
    z1, z2 = E.t5_encode(cfg, params, t1), E.t5_encode(cfg, params, t2)
    assert not torch.allclose(z1[:, 0], z2[:, 0])
    jtree = _jax_tree(JE.init_t5_encoder, JE.T5Config.tiny())
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), params) == shapes


@pytest.mark.parametrize("prefix", ["encoder.", "text_encoder.encoder."])
def test_convert_t5_hf_leaf_equal_to_jax(prefix):
    """An HF-T5-keyed dict written from a random tree by
    ``synth_checkpoint.hf_t5_state_dict``: the port's converter and JAX's
    give the same leaves (a relabelling and transposes: exact), and the
    tree read back is the one written."""
    cfg = E.T5Config.tiny()
    jtree = _jax_tree(JE.init_t5_encoder, JE.T5Config.tiny(), seed=3)
    sd = {k: v.numpy() for k, v in hf_t5_state_dict(jtree, prefix=prefix).items()}
    if prefix != "encoder.":  # only the tied copy under the prefix
        del sd["shared.weight"]
    want = JE.convert_t5_hf(JE.T5Config.tiny(), sd, prefix=prefix) if prefix == "encoder." \
        else None
    got = E.convert_t5_hf(cfg, sd, prefix=prefix)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_tree = jax.tree_util.tree_leaves_with_path(jtree)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_tree]
    for (_, a), (_, b) in zip(flat_got, flat_tree):
        assert np.array_equal(a, b)
    if want is not None:
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        assert all(np.array_equal(a, np.asarray(b)) for (_, a), (_, b) in zip(flat_got, flat_want))
        out = E.t5_encode(cfg, convert.embedder_params(got), torch.tensor([[1, 2, 3]]))
        ref = JE.t5_encode(JE.T5Config.tiny(), want, jnp.asarray([[1, 2, 3]]))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


FLAGS = [
    {},
    {"causal": True},
    {"talking_heads": True},
    {"use_rmsnorm": True},
    {"use_scalenorm": True},
    {"rel_pos_bias": True},
    {"rel_pos_bias": True, "causal": True},
    {"macaron": True},
    {"sandwich_coef": 1},
    {"gate_residual": True},
    {"use_rezero": True},
]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "plain")
def test_transformer_text_apply_matches_jax(flags):
    """``TransformerTextConfig.tiny`` with each opt-in flag, on JAX's init
    (ReZero's gate set to 0.5 so that its attention counts), 2 x 8 tokens."""
    cfg = E.TransformerTextConfig.tiny(**flags)
    jcfg = JE.TransformerTextConfig.tiny(**flags)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.layer_types == jcfg.layer_types
    jtree = _jax_tree(JE.init_transformer_text, jcfg)
    if cfg.use_rezero:
        for layer in jtree["layers"]:
            if "rezero_g" in layer:
                layer["rezero_g"] = np.full((1,), 0.5, np.float32)
    tokens = _tokens(2, 2, 8, cfg.vocab_size)
    want = np.asarray(JE.transformer_text_apply(jcfg, jtree, jnp.asarray(tokens)))
    got = E.transformer_text_apply(cfg, convert.embedder_params(jtree), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 8, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the port's own init has JAX's tree structure and shapes
    own = E.init_transformer_text(torch.Generator().manual_seed(0), cfg)
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), own)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), jtree))


def test_transformer_text_plans_and_flag_behaviour():
    """The execution plans (macaron, sandwich, its bound) and the flags'
    effects JAX's tests pin: causal masks the future, ReZero at init
    ignores the attention weights."""
    assert E.TransformerTextConfig.tiny(macaron=True).layer_types == ("f", "a", "f") * 2
    assert E.TransformerTextConfig.tiny(sandwich_coef=1).layer_types == ("a", "a", "f", "f")
    for cls in (E.TransformerTextConfig, JE.TransformerTextConfig):
        with pytest.raises(ValueError, match="sandwich coefficient"):
            cls.tiny(sandwich_coef=5).layer_types
    gen = torch.Generator().manual_seed(0)
    cfg = E.TransformerTextConfig.tiny(causal=True)
    params = E.init_transformer_text(gen, cfg)
    t1 = torch.tensor([[1, 5, 9, 12, 700, 3, 2, 0]])
    t2 = t1.clone()
    t2[0, 6] = 999
    o1, o2 = (E.transformer_text_apply(cfg, params, t) for t in (t1, t2))
    torch.testing.assert_close(o1[:, :6], o2[:, :6], rtol=0, atol=1e-5)
    assert not torch.allclose(o1[:, 6], o2[:, 6])
    cfg = E.TransformerTextConfig.tiny(use_rezero=True)
    params = E.init_transformer_text(gen, cfg)
    base = E.transformer_text_apply(cfg, params, t1)
    params["layers"][0]["out"]["kernel"] = params["layers"][0]["out"]["kernel"] + 1.0
    assert torch.equal(base, E.transformer_text_apply(cfg, params, t1))
    params["layers"][0]["rezero_g"] = torch.ones(1)
    assert not torch.allclose(base, E.transformer_text_apply(cfg, params, t1))


def test_clip_t5_encode_returns_both_as_jax():
    outs = E.clip_t5_encode(lambda t: torch.ones(1, 3, 8), lambda t: torch.zeros(1, 4, 16),
                            None, None)
    jouts = JE.clip_t5_encode(lambda t: jnp.ones((1, 3, 8)), lambda t: jnp.zeros((1, 4, 16)),
                              None, None)
    assert [tuple(o.shape) for o in outs] == [tuple(o.shape) for o in jouts]
