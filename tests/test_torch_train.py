"""Port parity of the training package: ``train/loop.py`` (q_sample, the
targets, ``p_losses`` and its gradients through the tiny UNet, the train
step, EMA), ``train/optimizers.py`` (Adan) and ``train/schedulers.py``,
against the JAX package's.

The tiny UNet runs in f32 on the CPU (the port's plain twins), its JAX
weights made from a seed with every zero-initialized kernel given small
random values (numpy), so that every parameter gets a gradient, and carried
across by ``convert.unet_params``; the JAX gradients go through the same
mapping. t and the noise are the JAX package's draws, injected.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _one_thread import one_torch_thread  # noqa: F401 (an autouse fixture: registered by the import)
from complex_prompt_diffusion_tpu import models as JM
from complex_prompt_diffusion_tpu import schedules as JS
from complex_prompt_diffusion_tpu.train import loop as JL
from complex_prompt_diffusion_tpu.train import optimizers as JO
from complex_prompt_diffusion_tpu.train import schedulers as JSch
from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch import train as T
from complex_prompt_diffusion_tpu_torch.train import loop as L
from complex_prompt_diffusion_tpu_torch.train import optimizers as O
from complex_prompt_diffusion_tpu_torch.train import schedulers as Sch

OP_TOL = 1e-6  # elementwise f32 on both sides (relative)
# the loss of a whole f32 tiny-UNet call, and each gradient leaf: max |a - b|
# <= GRAD_TOL * max(max |b|, GRAD_FLOOR * the largest gradient of the
# tree); sums over every activation in another order. The floor is for the
# biases in front of a GroupNorm, whose gradient is zero but for rounding
# (~1e-9 on both sides)
LOSS_RTOL, GRAD_TOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-2
# Adan in f32 on both sides: rounding of the same ops (and of XLA's f32
# pow against numpy's in the bias corrections); values of O(1)
ADAN_TOL = 1e-5


@pytest.fixture(scope="module")
def tables():
    return JS.make_diffusion_tables(), S.make_diffusion_tables()


@pytest.fixture(scope="module")
def unet():
    """The tiny f32 UNet: (JAX config, JAX params, port config, port params)."""
    jcfg = dataclasses.replace(JM.UNetConfig.tiny(context_dim=32), dtype="float32")
    params = JM.init_unet(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def unzero(a):
        a = np.asarray(a)
        if a.ndim >= 2 and not a.any():
            return (rng.standard_normal(a.shape) * 0.02).astype(a.dtype)
        return a

    params = jax.tree.map(lambda a: jnp.asarray(unzero(a)), params)
    pcfg = convert.config_from(M.UNetConfig, jcfg)
    return jcfg, params, pcfg, convert.unet_params(params, "cpu")


def _batch(seed, b=2, side=8):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, side, side, 4)).astype(np.float32),
            rng.standard_normal((b, 7, 32)).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _port(a):
    return torch.from_numpy(np.array(a))


def _flat(tree, pre=""):
    """{path: leaf} of a tree of dicts and lists (jax.tree rebuilds dicts in
    sorted key order, the port keeps insertion order: compare by path)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{pre}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{pre}/{i}").items()}
    return {pre: tree}


def _trees_close(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= tol, k


def test_q_sample_and_v_target(tables):
    jt, pt = tables
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32) for _ in range(2))
    t = np.array([3, 700])
    for jf, pf in ((JL.q_sample, L.q_sample),):
        assert _rel(pf(pt, _port(x0), _port(t), _port(noise)),
                    jf(jt, x0, jnp.asarray(t), noise)) <= OP_TOL
    assert _rel(L.get_v(pt, _port(x0), _port(noise), _port(t)),
                JL.get_v(jt, x0, noise, jnp.asarray(t))) <= OP_TOL


def test_lvlb_weights_patch_the_first(tables):
    jt, pt = tables
    want = np.asarray(JL._lvlb_weights(jt))
    got = L._lvlb_weights(pt)
    assert got.dtype == np.float32 and np.isfinite(got).all() and got[0] == got[1]
    assert _rel(got, want) <= OP_TOL


_JAX_VG = {}


def _jax_value_and_grad(unet, tables, x0, ctx, t, noise, **kw):
    """The JAX loss and gradients at ``params``: ``jax.value_and_grad`` of
    ``p_losses`` through the tiny UNet, jitted once a loss configuration
    (the module's inputs are fixed)."""
    jcfg = unet[0]
    key = tuple(sorted(kw.items()))
    if key not in _JAX_VG:
        def loss(p):
            return JL.p_losses(lambda pp, x, tt, c: JM.unet_apply(jcfg, pp, x, tt, c), p,
                               tables[0], x0, ctx, jnp.asarray(t), noise, **kw)

        _JAX_VG[key] = jax.jit(jax.value_and_grad(loss))
    return _JAX_VG[key]


def _loss_inputs():
    x0, ctx = _batch(2)
    t = np.array([17, 640])
    noise = np.random.default_rng(3).standard_normal(x0.shape).astype(np.float32)
    return x0, ctx, t, noise


def _port_value_and_grad(pcfg, pt, pparams, x0, ctx, t, noise, **kw):
    leaves = [p.detach().requires_grad_() for p in O.tree_leaves(pparams)]
    it = iter(leaves)
    diff = O.tree_map(lambda _: next(it), pparams)
    loss = T.p_losses(lambda p, x, tt, c: M.unet_apply(pcfg, p, x, tt, c), diff, pt,
                      _port(x0), _port(ctx), _port(t), _port(noise), **kw)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), O.tree_map(lambda _: next(grads), pparams)


def _to_jax_layout(tree):
    """The port's parameter tree back in the JAX layout (conv weights
    [O, I, kh, kw] -> HWIO kernels), as jnp arrays."""
    if isinstance(tree, dict):
        out = {k: _to_jax_layout(v) for k, v in tree.items() if k != "weight"}
        if "weight" in tree and tree["weight"].ndim == 4:
            out["kernel"] = jnp.asarray(tree["weight"].detach().permute(2, 3, 1, 0).numpy())
        return out
    if isinstance(tree, list):
        return [_to_jax_layout(v) for v in tree]
    return jnp.asarray(tree.detach().numpy())


def _grads_close(grads, jgrads):
    got, want = _flat(grads), _flat(convert.unet_params(jgrads, "cpu"))
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert float((got[k] - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), floor), k


@pytest.mark.parametrize("param,loss_type,elbo", [("eps", "l2", 0.0), ("x0", "l1", 0.0),
                                                  ("v", "l2", 0.5)])
def test_p_losses_value_and_grad_through_the_tiny_unet(tables, unet, param, loss_type, elbo):
    """The loss and every parameter's gradient, the JAX side by
    ``jax.value_and_grad``, the port's by ``torch.autograd.grad``."""
    _, pt = tables
    _, jparams, pcfg, pparams = unet
    x0, ctx, t, noise = _loss_inputs()
    kw = dict(parameterization=param, loss_type=loss_type, elbo_weight=elbo)
    jloss, jgrads = _jax_value_and_grad(unet, tables, x0, ctx, t, noise, **kw)(jparams)
    loss, grads = _port_value_and_grad(pcfg, pt, pparams, x0, ctx, t, noise, **kw)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    _grads_close(grads, jgrads)


def test_train_step_with_adan_matches_jax(tables, unet):
    """Two steps of the port's ``make_train_step`` with Adan (clipping,
    weight decay) on a fixed batch with t and the noise injected, against
    the parts the JAX step composes: at the step's parameters, the loss and
    the gradients of ``jax.value_and_grad(p_losses)``; then JAX's ``adan``
    update and ``optax.apply_updates`` fed the port's own gradients (Adan
    normalizes each element, so it would turn the rounding noise of the
    gradients that are zero but for rounding, those of the biases in front
    of a GroupNorm, into steps of random sign on both sides)."""
    jt, pt = tables
    _, jparams, pcfg, pparams = unet
    x0, ctx, t, noise = _loss_inputs()
    opt_kw = dict(learning_rate=1e-3, weight_decay=0.01, max_grad_norm=1.0)
    jopt, popt = JO.adan(**opt_kw), T.adan(**opt_kw)
    pstep = T.make_train_step(pcfg, pt, popt)
    jvg = _jax_value_and_grad(unet, tables, x0, ctx, t, noise, parameterization="eps",
                              loss_type="l2", elbo_weight=0.0)
    jupdate = jax.jit(jopt.update)

    def as_jax(tree):  # the port's layout, as jnp arrays (Adan is elementwise)
        return jax.tree.map(lambda a: jnp.asarray(a.detach().numpy()), tree)

    jstate, pstate = jopt.init(as_jax(pparams)), popt.init(pparams)
    batch = {"latents": _port(x0), "context": _port(ctx)}
    for _ in range(2):
        jloss, jgrads = jvg(_to_jax_layout(pparams))
        loss, grads = _port_value_and_grad(pcfg, pt, pparams, x0, ctx, t, noise)
        _grads_close(grads, jgrads)
        jupd, jstate = jupdate(as_jax(grads), jstate, as_jax(pparams))
        want = optax.apply_updates(as_jax(pparams), jupd)
        pparams, pstate, ploss = pstep(pparams, pstate, batch, t=_port(t), noise=_port(noise))
        assert torch.equal(ploss, loss) and not ploss.requires_grad
        assert abs(float(ploss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
        _trees_close(pparams, want, ADAN_TOL)
    assert pstate.count == 2


def test_train_step_draws_from_its_generator(tables, unet):
    _, pt = tables
    _, _, pcfg, pparams = unet
    x0, ctx = _batch(5)
    batch = {"latents": _port(x0), "context": _port(ctx)}
    opt = T.adan(learning_rate=1e-3)
    step = T.make_train_step(pcfg, pt, opt)
    runs = [step(pparams, opt.init(pparams), batch, torch.Generator().manual_seed(s))[2]
            for s in (0, 0, 1)]
    assert float(runs[0]) == float(runs[1]) != float(runs[2])


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "blocks": [{"b": rng.standard_normal(5).astype(np.float32)},
                       {"b": rng.standard_normal(2).astype(np.float32)}]}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_port(tree):
    return O.tree_map(_port, tree)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(no_prox=True, weight_decay=0.02),
    dict(weight_decay=0.02, max_grad_norm=0.5),
    dict(learning_rate="callable", weight_decay=0.01, max_grad_norm=10.0),
], ids=["default", "no_prox", "clip", "callable_lr"])
def test_adan_three_updates(kw):
    kw = dict(kw)
    if kw.get("learning_rate") == "callable":
        kw["learning_rate"] = lambda n: 1e-2 / (1 + n)
    jopt, popt = JO.adan(**kw), T.adan(**kw)
    params = _tree(0)
    jp, pp = _to_jax(params), _to_port(params)
    js, ps = jopt.init(jp), popt.init(pp)
    for i in range(3):
        grads = _tree(10 + i)
        ju, js = jopt.update(_to_jax(grads), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, ju)
        pu, ps = popt.update(_to_port(grads), ps, pp)
        pp = O.apply_updates(pp, pu)
        _trees_close(pp, jp, ADAN_TOL)
        for name in ("exp_avg", "exp_avg_sq", "exp_avg_diff", "pre_grad"):
            _trees_close(getattr(ps, name), getattr(js, name), ADAN_TOL)
    assert ps.count == int(js.count) == 3


def test_adan_requires_params():
    opt = T.adan()
    with pytest.raises(ValueError, match="params"):
        opt.update(_to_port(_tree(1)), opt.init(_to_port(_tree(0))), None)


STEPS = [0, 1, 5, 99, 100, 101, 250, 999, 1000, 1001, 5000]


@pytest.mark.parametrize("name,args", [
    ("LambdaWarmUpCosineScheduler", (100, 1e-4, 1e-2, 1e-6, 1000)),
    ("LambdaWarmUpCosineScheduler2", ([50, 100], [0.1, 0.2], [1.0, 0.8], [1e-3, 1e-2],
                                      [400, 800])),
    ("LambdaLinearScheduler", ([100], [1.0], [1.0], [1e-6], [10000000000000])),
    ("LambdaLinearScheduler", ([10, 20], [0.1, 0.5], [1.0, 0.9], [0.0, 0.1], [300, 700])),
])
def test_schedulers_at_steps(name, args):
    got = getattr(Sch, name)(*args)
    want = getattr(JSch, name)(*args)
    assert [float(got(n)) for n in STEPS] == [float(want(n)) for n in STEPS]
    assert getattr(T, name) is getattr(Sch, name)


@pytest.mark.parametrize("step", [None, 1, 7])
def test_ema_update(step):
    e, p = _tree(20), _tree(21)
    got = T.ema_update(_to_port(e), _to_port(p), 0.999, step=step)
    want = JL.ema_update(_to_jax(e), _to_jax(p), 0.999, step=step)
    _trees_close(got, want, OP_TOL)


def test_lit_ema_matches_jax_and_swaps():
    p0, p1, p2 = _tree(30), _tree(31), _tree(32)
    for use in (True, False):
        jema = JL.LitEma.create(_to_jax(p0), decay=0.9, use_num_updates=use)
        pema = L.LitEma.create(_to_port(p0), decay=0.9, use_num_updates=use)
        for p in (p1, p2):
            jema, pema = jema.update(_to_jax(p)), pema.update(_to_port(p))
        assert pema.num_updates == jema.num_updates
        _trees_close(pema.shadow, jema.shadow, OP_TOL)
    online = _to_port(p2)
    pema = pema.store(online)
    assert pema.copy_to() is pema.shadow and pema.restore() is online
    with L.ema_scope(online, pema) as w:
        assert w is pema.shadow
    with L.ema_scope(online, pema, enabled=False) as w:
        assert w is online
    with pytest.raises(ValueError, match="store"):
        L.LitEma.create(online).restore()
    # the shadow is a copy: moving the online weights leaves it alone
    src = _to_port(p0)
    ema = L.LitEma.create(src)
    src["w"] += 1
    assert not torch.equal(ema.shadow["w"], src["w"])
