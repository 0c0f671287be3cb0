"""Port parity: the parallel layer (``parallel/``, ``ops/sharding.py``,
the sharded tiled path) on spawned gloo ranks against the JAX package.

Two ranks (``_parallel_ranks.two_rank_suite``, one spawn for the file) run
the tiny bundle tensor-parallel at model 2 (and with ``conv_split``),
data-parallel at data 2 and tiled with its tiles over data 2; the JAX
package renders the same weights and x_T on one device and through its
own ``shard_bundle(make_mesh(model=2))`` (the conftest's 8 CPU devices).
Tolerances: the JAX package's own for its TP tests (2e-4; conv_split
2e-4); the data-parallel render against the unsharded port render's
slices and the sharded tiled render against the unsharded one 1e-6 (the
same ops on the same rows; the tiles' fold adds in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.parallel.mesh import make_mesh as j_make_mesh
from complex_prompt_diffusion_tpu.parallel.tp import shard_bundle as j_shard_bundle
from complex_prompt_diffusion_tpu.parallel.tp import unet_tp_shardings as j_unet_tp_shardings
from complex_prompt_diffusion_tpu_torch import pipeline as P

import _parallel_ranks as R
from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

TP_TOL = 2e-4  # the JAX package's tolerance for its TP render against one device
EXACT_TOL = 1e-6  # DP slices and sharded tiles against the unsharded port render
CFG = dict(steps=3, width=32, height=32, seed=5)
PROMPT = "a cat"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX tiny bundle (its UNet biases drawn nonzero, so that a bias
    added on every rank shows) and its port twin, saved for the ranks; the
    inputs; and the two-rank suite's results."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    jb = JP.ModelBundle.random("tiny", seed=0)
    jb = dataclasses.replace(jb, unet_params=R.with_biases(jb.unet_params, 7))
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    P.save_bundle(pb, str(tmp / "bundle"))
    rng = np.random.default_rng(11)
    inputs = {"prompt": PROMPT, "cfg": CFG,
              "x_T": torch.from_numpy(rng.standard_normal((4, 4, 4, 4)).astype(np.float32)),
              "tiled_cfg": dict(steps=2, width=64, height=64, unet_tile=4, unet_tile_stride=2,
                                unet_tile_chunk=2),
              "deepcache_cfg": dict(CFG, steps=4, deepcache_interval=2),
              "x_tiled": torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32))}
    torch.save(inputs, tmp / "inputs.pt")
    results = R.spawn(R.two_rank_suite, 2, str(tmp), timeout=240)
    return {"jb": jb, "pb": pb, "inputs": inputs, "ranks": results}


def _jax_txt2img(bundle, x_T):
    _, lat = JP.txt2img(bundle, PROMPT, cfg=JP.RenderConfig(**CFG), x_T=jnp.asarray(x_T),
                        decode=False)
    return np.asarray(lat)


def test_tp2_render_matches_jax_one_device_and_sharded(world):
    """Model 2 on 2 ranks: every rank's latents within 2e-4 of JAX's
    txt2img on one device and of JAX's own ``shard_bundle(make_mesh(
    model=2))``; both ranks agree; 21 all-reduces each UNet call of the
    tiny UNet (3 for each of its 7 transformer blocks)."""
    x_T = world["inputs"]["x_T"][:1].numpy()
    want = _jax_txt2img(world["jb"], x_T)
    tb = j_shard_bundle(world["jb"], j_make_mesh(model=2))
    want_sharded = _jax_txt2img(tb, x_T)
    ranks = [r["tp2"] for r in world["ranks"]]
    for r in ranks:
        got = r["lat"].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TP_TOL)
        np.testing.assert_allclose(got, want_sharded, rtol=0, atol=TP_TOL)
        assert r["counts"] and set(r["counts"]) == {21}
    assert torch.equal(ranks[0]["lat"], ranks[1]["lat"])


def test_tp2_conv_split_matches_jax(world):
    """The probe mode: the convs' input channels split too (one
    all-reduce a split conv): within 2e-4 of JAX's one-device render."""
    want = _jax_txt2img(world["jb"], world["inputs"]["x_T"][:1].numpy())
    for r in world["ranks"]:
        got = r["tp2_conv_split"]
        np.testing.assert_allclose(got["lat"].numpy(), want, rtol=0, atol=TP_TOL)
        assert all(c > 21 for c in got["counts"])


def test_tp2_deepcache_render_equals_unsharded(world):
    """DeepCache at interval 2 on the model-2 bundle (the JAX package's TP
    DeepCache case): full and shallow passes both run the sharded sites
    (21 all-reduces a full call, fewer a shallow one), within 2e-4 of the
    one-process DeepCache render."""
    cfg = world["inputs"]["deepcache_cfg"]
    _, want = P.txt2img(world["pb"], PROMPT, cfg=P.RenderConfig(**cfg),
                        x_T=world["inputs"]["x_T"][:1], decode=False)
    for r in world["ranks"]:
        got = r["tp2_deepcache"]
        torch.testing.assert_close(got["lat"], want, rtol=0, atol=TP_TOL)
        assert 21 in got["counts"] and 0 < min(got["counts"]) < 21, got["counts"]


@pytest.mark.parametrize("conv_split", [False, True])
def test_tp_spec_tree_equals_jax_unet_tp_shardings(world, conv_split):
    """The port's spec tree (the JAX rule on the port's tree) equals JAX's
    ``unet_tp_shardings`` leaf by leaf, ``conv_split`` included (the port's
    conv weights are OIHW where JAX's kernels are HWIO: the Cin split sits
    on axis 1 there, axis 2 here, and the leaf is ``weight`` for
    ``kernel``); the applied tree is the same at model 2, where every
    tiny site divides."""
    key = "tp2_conv_split" if conv_split else "tp2"
    port = world["ranks"][0][key]
    mesh = j_make_mesh(model=2)
    jspecs = j_unet_tp_shardings(world["jb"].unet_params, mesh, conv_split=conv_split)
    flat_j = {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
              jax.tree_util.tree_leaves_with_path(jspecs)}

    def port_paths(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from port_paths(v, f"{path}['{k}']")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from port_paths(v, f"{path}[{i}]")
        else:
            yield path, tree

    hwio = {}
    for path, spec in port_paths(port["jax_rule"]):
        if path.endswith("['weight']"):
            path = path[:-len("['weight']")] + "['kernel']"
            spec = (spec[2], spec[3], spec[1], spec[0]) if spec else spec  # OIHW -> HWIO
        hwio[path] = tuple(s for s in spec)
    strip = {k: tuple(v) for k, v in flat_j.items()}
    # JAX's P() and P(None, ...) trailing Nones: compare as spelled out
    assert hwio.keys() == strip.keys()
    for k in strip:
        assert hwio[k] == strip[k] or (not hwio[k] and not any(strip[k])), (k, hwio[k], strip[k])
    applied = port["specs"]  # ShardCtx.specs: {leaf path: spec}
    assert sum(1 for s in applied.values() if "model" in s) == sum(
        1 for _, s in port_paths(port["jax_rule"]) if "model" in s)
    blk = ("input_blocks", 1, 1, "blocks", 0)
    assert applied[blk + ("attn1", "to_q", "kernel")] == (None, "model")
    assert applied[blk + ("attn1", "to_out", "kernel")] == ("model", None)
    assert applied[blk + ("attn1", "to_out", "bias")] == ()
    assert applied[blk + ("ff", "proj", "kernel")] == (None, "model")
    assert applied[blk + ("norm1", "scale")] == ()


def test_dp_render_equals_unsharded_slices(world):
    """Data 2, b4: each rank renders its two through ``sample_latents``
    with no collective in a UNet call; the gathered latents equal the
    one-process b4 render's (1e-6) on every rank."""
    pb = world["pb"]
    spec = P.make_guidance_spec(pb, PROMPT)
    want = P.sample_latents(pb, spec, P.RenderConfig(**dict(CFG, batch_size=4)),
                            x_init=world["inputs"]["x_T"])
    for rank, r in enumerate(world["ranks"]):
        got = r["dp2"]
        assert got["counts"] and set(got["counts"]) == {0}
        torch.testing.assert_close(got["local"], want[2 * rank:2 * rank + 2], rtol=0,
                                   atol=EXACT_TOL)
        torch.testing.assert_close(got["lat"], want, rtol=0, atol=EXACT_TOL)


def test_sharded_tiled_render_equals_unsharded(world):
    """Tiled inference on a data-2 bundle: the tiles shard over the ranks
    (``tiled_apply_sharded``), every rank gets the whole canvas, equal to
    the one-process tiled render (1e-6: the fold adds in another order)."""
    pb = world["pb"]
    spec = P.make_guidance_spec(pb, PROMPT)
    want = P.sample_latents(pb, spec, P.RenderConfig(**world["inputs"]["tiled_cfg"]),
                            x_init=world["inputs"]["x_tiled"])
    for r in world["ranks"]:
        torch.testing.assert_close(r["tiled_dp2"]["lat"], want, rtol=0, atol=EXACT_TOL)


def test_shard_ctx_is_not_a_config_value(world, tmp_path):
    """The shard context rides beside the config: ``save_bundle`` of a
    bundle that carries one writes no trace of it (``meta.json`` keeps JAX's
    keys, the configs their fields), and the UNet config has no field for
    it."""
    import json

    pb = world["pb"]
    assert pb.shard is None
    assert "shard" not in {f.name for f in dataclasses.fields(type(pb.unet_cfg))}
    P.save_bundle(dataclasses.replace(pb, shard=object()), str(tmp_path))
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert set(meta) == {"version", "parameterization", "clip_layer", "unet_cfg", "vae_cfg",
                         "clip_cfg"}
    assert meta["unet_cfg"] == json.loads(json.dumps(dataclasses.asdict(pb.unet_cfg)))
    assert P.load_bundle(str(tmp_path), device="cpu").shard is None
