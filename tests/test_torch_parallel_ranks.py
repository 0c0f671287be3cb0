"""Port parity: tensor parallelism at model 4 and 8 on spawned gloo ranks
against the JAX package, the collective counts of an SD-1.5 UNet call,
the mesh's checks and ``parallel.dryrun.dryrun_multichip``.

Tolerance: the JAX package's own for its TP renders, 2e-4 against its
one-device render; the dry run holds the sharded gradients to one
process's at 1e-4 (``parallel/dryrun.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.ops.sharding import ShardCtx
from complex_prompt_diffusion_tpu_torch.parallel.mesh import flatten_with_path
from complex_prompt_diffusion_tpu_torch.parallel.tp import shard_unet_params, unet_tp_shardings

import _parallel_ranks as R
from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)

TP_TOL = 2e-4
CFG = dict(steps=2, width=32, height=32, seed=3)
PROMPT = "a cat"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX tiny bundle's render on one device (its UNet biases drawn
    nonzero, so that a bias added on every rank shows), and the directory
    the ranks read its port twin and the inputs from."""
    tmp = tmp_path_factory.mktemp("ranks")
    jb = JP.ModelBundle.random("tiny", seed=0)
    jb = dataclasses.replace(jb, unet_params=R.with_biases(jb.unet_params, 7))
    P.save_bundle(P.ModelBundle.from_jax_bundle(jb, device="cpu"), str(tmp / "bundle"))
    x_T = np.random.default_rng(3).standard_normal((1, 4, 4, 4)).astype(np.float32)
    torch.save({"prompt": PROMPT, "cfg": CFG, "x_T": torch.from_numpy(x_T)}, tmp / "inputs.pt")
    _, want = JP.txt2img(jb, PROMPT, cfg=JP.RenderConfig(**CFG), x_T=jnp.asarray(x_T),
                         decode=False)
    return str(tmp), np.asarray(want)


@pytest.mark.parametrize("model, all_reduces", [(4, 7), (8, 7)])
def test_tp_render_matches_jax_one_device(tiny, model, all_reduces):
    """Model 4 and 8 on as many ranks: the tiny UNet's 2 heads divide by
    neither, so its attention sites keep their weights whole and run every
    head (the JAX package replicates them; its ``test_tp_uneven_shard_
    rejected`` is the model-8 case), while the FFs (hidden 128 and 256)
    split: one all-reduce for each of the 7 FFs a UNet call. Within 2e-4
    of JAX's one-device txt2img on every rank."""
    tmp, want = tiny
    for r in R.spawn(R.tp_render, model, tmp, model, timeout=240):
        np.testing.assert_allclose(r["lat"].numpy(), want, rtol=0, atol=TP_TOL)
        assert r["counts"] and set(r["counts"]) == {all_reduces}
        assert r["q_width"] == 32  # level 0's attention: whole on every rank


def test_make_mesh_checks_the_world(tmp_path):
    """data x model must be the world (the JAX package's message); a
    one-rank world makes a 1 x 1 mesh."""
    import torch.distributed as dist

    from complex_prompt_diffusion_tpu_torch.parallel import make_mesh
    from complex_prompt_diffusion_tpu_torch.parallel.mesh import mesh_shape

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(model=2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
            make_mesh(data=2)
        with pytest.raises(ValueError, match=r"mesh 1x2 != 1 devices"):
            make_mesh(model=2, data=1)
        assert mesh_shape(make_mesh()) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


class _CountingMesh:
    """A stand-in (data, model) mesh for a rank of a model-``m`` mesh: the
    shapes only, no process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = (data, model)

    def size(self, i):
        return self.shape[i]

    def get_local_rank(self, name):
        return 0


class _CountingCtx(ShardCtx):
    """A ShardCtx whose all-reduce counts and adds the bias, with no
    collective: the sites' bookkeeping on the meta device."""

    def all_reduce(self, t, bias=None):
        self.all_reduces += 1
        return t if bias is None else t + bias.to(t.dtype)


@pytest.mark.parametrize("model, want", [(2, 48), (8, 48), (1, 0)])
def test_sd15_unet_call_collective_counts(model, want):
    """One SD-1.5 UNet call (512^2 CFG batch, on the meta device: shapes,
    no arithmetic) under a model-``model`` shard context: 3 all-reduces for
    each of its 16 transformer blocks, 48 (the JAX package pins 48 for its
    TP-8 SD-1.5 step, ``TestCollectiveCounts.TP8_SD15_MAX``); 0 on a
    data-parallel context. Every attention site's q/k/v hold heads / model
    heads."""
    cfg = M.UNetConfig.sd15()
    params = convert.unet_params(M.init_unet(None, cfg, device="meta"), "meta",
                                 cfg.compute_dtype)
    mesh = _CountingMesh(8 // model, model)
    ctx = _CountingCtx(mesh)
    ctx.specs = flatten_with_path(unet_tp_shardings(params, mesh, cfg=cfg))
    local = shard_unet_params(params, ctx)
    q = local["input_blocks"][1][1]["blocks"][0]["attn1"]["to_q"]["kernel"]
    assert tuple(q.shape) == (320, 320 // model)
    x = torch.empty((2, 64, 64, 4), device="meta")
    t = torch.empty((2,), device="meta")
    context = torch.empty((2, 77, 768), device="meta")
    out = M.unet_apply(cfg, local, x, t, context, shard=ctx)
    assert tuple(out.shape) == (2, 64, 64, 4)
    assert ctx.all_reduces == want


def test_dryrun_multichip_4():
    """``dryrun_multichip(4)``: a 2 x 2 mesh, one sharded Adan step, the
    gradients held to one process's (it raises on a mismatch or a failed
    rank)."""
    from complex_prompt_diffusion_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)

