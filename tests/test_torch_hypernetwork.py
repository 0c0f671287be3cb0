"""Port parity of hypernetworks: ``models/params.attach_hypernetwork``
(the nested and flat layouts, the missing-slot error), the UNet's
hypernetwork transforms of the cross-attention context (in the step and
in the hoisted ``precompute_cross_kv``), a tiny txt2img with a
hypernetwork, and the multiplier leaf through ``convert`` and ``cast``,
against the JAX package.

f32 on the CPU; weights from the JAX package's init through
``convert.py``, inputs from numpy seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import pipeline as JP
from complex_prompt_diffusion_tpu.models import params as JPm
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import pipeline as P
from complex_prompt_diffusion_tpu_torch.models import params as Pm

UNET_TOL = 1e-5  # max |port - jax| / max |jax| of a UNet eval or its k/v
RENDER_TOL = 1e-4  # of a render's latents
DIM, HIDDEN = 64, 16  # the tiny UNet's context width, the hypernetwork's


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hyper_sd(slots=("k", "v"), layout="nested", seed=0):
    """Random hypernetwork weights for the context width DIM: nested
    ({dim: {slot: {linear1, linear2}}}, [in, out] kernels) or flat
    ("<dim>.<slot>.<linear>.<weight|bias>", torch [out, in] weights)."""
    rng = np.random.default_rng(seed)
    nested = {DIM: {}}
    for kv in slots:
        nested[DIM][kv] = {
            "linear1": {"kernel": (rng.standard_normal((DIM, HIDDEN)) * 0.2).astype(np.float32),
                        "bias": (rng.standard_normal(HIDDEN) * 0.1).astype(np.float32)},
            "linear2": {"kernel": (rng.standard_normal((HIDDEN, DIM)) * 0.2).astype(np.float32),
                        "bias": (rng.standard_normal(DIM) * 0.1).astype(np.float32)},
        }
    if layout == "nested":
        return nested
    return {f"{DIM}.{kv}.{lin}.{'weight' if k == 'kernel' else 'bias'}": (a.T if k == "kernel"
                                                                         else a)
            for kv, mlp in nested[DIM].items() for lin, p in mlp.items() for k, a in p.items()}


@pytest.fixture(scope="module")
def jb():
    return JP.ModelBundle.random("tiny", seed=0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _sites(tree):
    """The cross-attention (attn2) dicts of a UNet tree, in plan order."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            if "attn2" in t:
                out.append(t["attn2"])
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(tree)
    return out


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_attach_hypernetwork_matches_jax(jb, layout):
    """On the JAX tree the port attaches the JAX package's modules, leaf for
    leaf; on the port's tensor tree it attaches their conversion (f32
    tensors, the multiplier an f32 scalar). The input trees are left as
    they were."""
    sd = _hyper_sd(layout=layout)
    jtree = _np_tree(jb.unet_params)
    want = JPm.attach_hypernetwork(jtree, sd, multiplier=0.7)
    got = Pm.attach_hypernetwork(jtree, sd, multiplier=0.7)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert len(_sites(got)) == len(_sites(jtree)) == 7  # the tiny UNet's cross-attention sites
    assert all("hyper_k" in s and "hyper_v" in s for s in _sites(got))
    assert not any("hyper_k" in s for s in _sites(jtree))
    ptree = convert.unet_params(jtree)
    pgot = Pm.attach_hypernetwork(ptree, sd, multiplier=0.7)
    pwant = convert.unet_params(want)
    for a, b in zip(jax.tree_util.tree_leaves(pgot), jax.tree_util.tree_leaves(pwant)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mult = _sites(pgot)[0]["hyper_k"]["multiplier"]
    assert mult.dtype == torch.float32 and mult.ndim == 0 and float(mult) == np.float32(0.7)
    assert not any("hyper_k" in s for s in _sites(ptree))


def test_attach_hypernetwork_missing_slot_raises_in_both(jb):
    sd = _hyper_sd()
    del sd[DIM]["v"]["linear2"]
    for attach in (JPm.attach_hypernetwork, Pm.attach_hypernetwork):
        with pytest.raises(ValueError, match="missing"):
            attach(_np_tree(jb.unet_params), sd)


def _unet_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
            np.array([10, 700], np.int32),
            rng.standard_normal((2, 77, DIM)).astype(np.float32))


@pytest.mark.parametrize("slots", [("k", "v"), ("k",)])
def test_unet_with_hypernetwork_matches_jax(jb, slots):
    """A UNet eval with the hypernetwork (on k and v, or on k alone) within
    1e-5 of the JAX package's; the hoisted k/v (``precompute_cross_kv``)
    within 1e-5 of the JAX package's, and the eval on them equal to the
    in-step projections; the hypernetwork moves the output."""
    jtree = JPm.attach_hypernetwork(_np_tree(jb.unet_params), _hyper_sd(slots))
    cfg = convert.config_from(M.UNetConfig, jb.unet_cfg)
    ptree = convert.unet_params(jtree)
    x, t, ctx = _unet_inputs()
    want = jax.jit(lambda p, *a: JM.unet_apply(jb.unet_cfg, p, *a))(jtree, x, t, ctx)
    xt, tt, ct = map(torch.from_numpy, (x, t, ctx))
    got = M.unet_apply(cfg, ptree, xt, tt, ct)
    assert _rel(got.numpy(), want) <= UNET_TOL
    kv_want = JM.precompute_cross_kv(jb.unet_cfg, jtree, ctx)
    kv_got = M.precompute_cross_kv(cfg, ptree, ct)
    assert len(kv_got) == len(kv_want) == 7
    for (k, v), (kw, vw) in zip(kv_got, kv_want):
        assert _rel(k.numpy(), kw) <= UNET_TOL and _rel(v.numpy(), vw) <= UNET_TOL
    torch.testing.assert_close(M.unet_apply(cfg, ptree, xt, tt, ct, cross_kv=kv_got), got,
                               rtol=0, atol=0)
    plain = M.unet_apply(cfg, convert.unet_params(_np_tree(jb.unet_params)), xt, tt, ct)
    assert float((got - plain).abs().max()) > 1e-3


def test_hypernetwork_multiplier_zero_is_none(jb):
    """Multiplier 0 leaves the context as it is: the eval equals the one
    without a hypernetwork (to rounding: k and v are then two products
    instead of one fused one), in both packages."""
    cfg = convert.config_from(M.UNetConfig, jb.unet_cfg)
    x, t, ctx = _unet_inputs(4)
    jzero = JPm.attach_hypernetwork(_np_tree(jb.unet_params), _hyper_sd(), multiplier=0.0)
    jfn = jax.jit(lambda p, *a: JM.unet_apply(jb.unet_cfg, p, *a))
    np.testing.assert_allclose(np.asarray(jfn(jzero, x, t, ctx)),
                               np.asarray(jfn(_np_tree(jb.unet_params), x, t, ctx)),
                               rtol=1e-6, atol=1e-6)
    args = tuple(map(torch.from_numpy, (x, t, ctx)))
    zero = Pm.attach_hypernetwork(convert.unet_params(_np_tree(jb.unet_params)), _hyper_sd(),
                                  multiplier=0.0)
    torch.testing.assert_close(M.unet_apply(cfg, zero, *args),
                               M.unet_apply(cfg, convert.unet_params(jb.unet_params), *args),
                               rtol=1e-6, atol=1e-6)


def test_txt2img_with_hypernetwork_matches_jax(jb):
    """A 3-step DDIM txt2img of the tiny bundle with a hypernetwork (hoisted
    k/v on), x_T from a numpy seed: latents within 1e-4 of the JAX
    package's."""
    jhb = dataclasses.replace(
        jb, unet_params=JPm.attach_hypernetwork(_np_tree(jb.unet_params), _hyper_sd()))
    pb = P.ModelBundle.from_jax_bundle(jb, device="cpu")
    phb = dataclasses.replace(pb, unet_params=Pm.attach_hypernetwork(pb.unet_params,
                                                                     _hyper_sd()))
    kw = dict(steps=3, width=64, height=64, seed=2)
    x_T = np.random.default_rng(5).standard_normal((1, 8, 8, 4)).astype(np.float32)
    _, want = JP.txt2img(jhb, "a red cube", cfg=JP.RenderConfig(**kw), x_T=jnp.asarray(x_T),
                         decode=False)
    _, got = P.txt2img(phb, "a red cube", cfg=P.RenderConfig(**kw), x_T=torch.from_numpy(x_T),
                       decode=False)
    assert _rel(got.numpy(), want) <= RENDER_TOL


def test_multiplier_leaf_converts_and_casts_as_jax(jb):
    """The multiplier, a Python float in the JAX tree, is an f32 scalar
    after ``convert`` (as JAX puts it on the device), stays f32 where the
    JAX bundle keeps it, and rounds to bf16 under ``cast("bfloat16")``, as
    the JAX bundle's cast rounds it."""
    jtree = JPm.attach_hypernetwork(jb.unet_params, _hyper_sd(), multiplier=0.3)
    jcast = dataclasses.replace(jb, unet_params=jtree).cast("bfloat16")
    jm = _sites(jcast.unet_params)[0]["hyper_k"]["multiplier"]
    pb = P.ModelBundle.from_jax_bundle(dataclasses.replace(jb, unet_params=jtree), device="cpu")
    pm = _sites(pb.unet_params)[0]["hyper_k"]["multiplier"]
    assert pm.dtype == torch.float32 and float(pm) == np.float32(0.3)
    cm = _sites(pb.cast("bfloat16").unet_params)[0]["hyper_k"]["multiplier"]
    assert str(jm.dtype) == "bfloat16" and cm.dtype == torch.bfloat16
    assert float(cm) == float(jm) != np.float32(0.3)
