"""Port parity: the probes of the TPU tuning scripts (K7, K8, K9's plain twins)
against the scripts' own Pallas kernels.

``scripts/perf_attn8.py`` .. ``perf_attn12.py`` and ``perf_gn4.py`` ..
``perf_gn8.py`` are the instruments the TPU kernels were tuned with. The
GroupNorm scripts run their benchmarks at import, so each script is loaded
through an ``ast`` filter that keeps its imports, its function definitions
and its constants, and nothing else (no module-level run, no JAX config
change); the scripts stay as they are. Their ``pl.pallas_call`` sites run
with ``interpret=True`` and the scripts' own BlockSpecs, on the CPU.

Every input comes from one numpy seed and is rounded to bf16 the same way in
both frameworks. Tolerances: outputs in bf16 within 2e-2 of the largest
value (bf16's rounding of the output and of P, and the two frameworks' exp);
f32 outputs within 1e-4 relative; the copies bit for bit.
"""

import ast
import functools
import math
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from complex_prompt_diffusion_tpu_torch.ops.attention import attention_dmajor, attention_kcanon
from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA
from complex_prompt_diffusion_tpu_torch.ops.probes import groupnorm as PG
from complex_prompt_diffusion_tpu_torch.ops.probes import stream as PS

ROOT = Path(__file__).resolve().parents[1]
BF16_TOL = 2e-2
LN2 = math.log(2.0)  # scale * log2(e) == 1: the scripts' unscaled exp2


@functools.lru_cache(maxsize=None)
def _script(name):
    """The script's imports, functions and constants, its pallas_call in
    interpret mode."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    keep = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef)):
            keep.append(node)
        elif isinstance(node, ast.Assign) and all(isinstance(t, ast.Name) for t in node.targets):
            used = {n.id for n in ast.walk(node.value) if isinstance(n, ast.Name)}
            if not used & {"sys", "B"}:  # not the command-line batch size
                keep.append(node)
    ns = {"__name__": f"tpu_probe_script_{name}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), name, "exec"), ns)
    shim = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
    shim.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns["pl"] = shim
    return ns


def _bf16(a):
    """(jax bf16, torch bf16) of one f32 numpy array."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _close(got, want, tol=BF16_TOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else jnp.float32(got),
                     dtype=np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else jnp.float32(want),
                      dtype=np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _qkv_t(bh=2, d=40, s=256, dv=None, seed=0):
    """q, k [BH, d, S] and v [BH, dv, S] (the scripts' transposed layout),
    as (jax, torch) pairs."""
    rng = np.random.default_rng(seed)
    return tuple(_bf16(rng.standard_normal((bh, n, s)).astype(np.float32))
                 for n in (d, d, dv or d))


def _bsc(t):
    """[BH, d, S] -> the port's [B = BH, S, H*D = d] (one head)."""
    return t.transpose(1, 2).contiguous()


def _t_of(x):
    """The port's [B, S, d] (one head) -> [B, d, S]."""
    return x.transpose(1, 2)


# ---- perf_attn8: flash_t, online softmax on [BH, D, S] ----

@pytest.mark.parametrize("bq,bk", [(128, 128), (256, 64)])
def test_attn8_flash_t(bq, bk):
    (qj, qt), (kj, kt), (vj, vt) = _qkv_t(seed=1)
    want = _script("perf_attn8")["flash_t"](qj, kj, vj, scale=40**-0.5, block_q=bq, block_k=bk)
    for tile in (64, 128):  # K7's KV-tile width, the counterpart of the (bq, bk) sweep
        got = PA.attention_probe(_bsc(qt), _bsc(kt), _bsc(vt), 1, 40**-0.5, kv_tile=tile)
        _close(_t_of(got), want)
    got = attention_dmajor(qt[:, None], kt[:, None], vt[:, None], 40**-0.5)  # K5, d-major
    _close(got[:, 0], want)


# ---- perf_attn9: onepass V1 / V2 / V3 ----

@pytest.mark.parametrize("variant,denom,exp", [(1, "sum", "exp"), (2, "ones", "exp"),
                                               (3, "ones", "exp2")])
@pytest.mark.parametrize("d", [40, 80])
def test_attn9_onepass(variant, denom, exp, d):
    (qj, qt), (kj, kt), (vj, vt) = _qkv_t(d=d, seed=2)
    want = _script("perf_attn9")["onepass"](qj, kj, vj, scale=d**-0.5, block_q=128,
                                           variant=variant)
    got = PA.attention_probe(_bsc(qt), _bsc(kt), _bsc(vt), 1, d**-0.5, "full", denom, exp)
    _close(_t_of(got), want)


# ---- perf_attn10: run_mode A-G ----

@pytest.mark.parametrize("mode,port_mode", [("A", "scores"), ("B", "max"), ("C", "exp"),
                                            ("D", "full"), ("E", "pv"), ("F", "scores"),
                                            ("G", "rowsum")])
def test_attn10_ablation(mode, port_mode):
    (qj, qt), (kj, kt), (vj, vt) = _qkv_t(dv=41, seed=3)
    if mode == "D":  # the full kernel's denominator row of V: ones
        vj = vj.at[:, 40].set(1.0)
        vt[:, 40] = 1.0
    want = _script("perf_attn10")["run_mode"](qj, kj, vj, block_q=128, mode=mode)
    q, k, v = _bsc(qt), _bsc(kt), _bsc(vt[:, :40])
    if mode == "F":
        q, k, v = q.float(), k.float(), v.float()
    kw = dict(denom="ones") if mode == "D" else {}
    got = PA.attention_probe(q, k, v, 1, LN2, port_mode, **kw)
    _close(_t_of(got), want)


# ---- perf_attn11: h1 (q d-major, k canonical, v d-major) and h2 (all S-major, unnormalized) ----

def test_attn11_h1():
    (qj, qt), (kj, kt), (vj, vt) = _qkv_t(seed=4)
    d, s, scale = 40, 256, 40**-0.5
    q_pre = jnp.pad(qj * (scale * PA.LOG2E), ((0, 0), (0, 128 - d), (0, 0)))
    k_n = jnp.pad(kj.transpose(0, 2, 1), ((0, 0), (0, 0), (0, 128 - d)))
    v_t = jnp.concatenate([vj, jnp.ones((2, 1, s), vj.dtype)], 1)
    want = _script("perf_attn11")["h1"](q_pre, k_n, v_t, block_q=128)
    got = attention_dmajor(qt[:, None], kt.transpose(1, 2)[:, None], vt[:, None], scale,
                           k_canonical=True)  # K5, kcanon mode
    _close(got[:, 0], want)


def test_attn11_h2():
    (qj, qt), (kj, kt), (vj, vt) = _qkv_t(seed=5)
    d, scale = 40, 40**-0.5
    q_n = jnp.pad(qj.transpose(0, 2, 1) * (scale * PA.LOG2E), ((0, 0), (0, 0), (0, 128 - d)))
    k_t = jnp.pad(kj, ((0, 0), (0, 128 - d), (0, 0)))
    v_n = jnp.pad(vj.transpose(0, 2, 1), ((0, 0), (0, 0), (0, 128 - d))).at[:, :, d].set(1.0)
    want = _script("perf_attn11")["h2"](q_n, k_t, v_n, block_q=128)  # [BH, S, 128] f32
    got = PA.attention_probe(_bsc(qt), _bsc(kt), _bsc(vt), 1, scale, "full", "ones",
                             unnormalized=True)  # [B, H, S, d + 8] f32, l in column d
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, 256, 48)
    _close(got[:, 0, :, :d + 1], want[..., :d + 1])
    assert not got[..., d + 1:].any()
    _close(PA.h2_attention(_bsc(qt), _bsc(kt), _bsc(vt), 1, scale),
           (want[..., :d] / want[..., d:d + 1]).astype(jnp.bfloat16))


# ---- perf_attn12: the UNet-interface wrappers ----

@pytest.mark.parametrize("form", ["v3", "v3-f32", "h1"])
def test_attn12_wrappers(form):
    rng = np.random.default_rng(6)
    (qj, q), (kj, k), (vj, v) = (_bf16(rng.standard_normal((2, 256, 2 * 40)).astype(np.float32))
                                 for _ in range(3))
    ns = _script("perf_attn12")
    if form == "h1":
        want = ns["h1_attention"](qj, kj, vj, 2, 40**-0.5, block_q=128)
        got = attention_kcanon(q, k, v, 2, 40**-0.5)
    else:
        want = ns["v3_attention"](qj, kj, vj, 2, 40**-0.5, block_q=128,
                                  f32_scores=form == "v3-f32")
        if form == "v3":
            got = PA.v3_attention(q, k, v, 2, 40**-0.5)
        else:  # K5's f32 loop on f32 copies (the script kept P V in bf16)
            got = PA.v3_attention(q.float(), k.float(), v.float(), 2, 40**-0.5)
    _close(got, want)
    # the QK-only forms: the scores of key 0, each against its plain definition
    s0 = torch.einsum("bshd,bhd->bsh", q.float().view(2, 256, 2, 40),
                      k.float().view(2, 256, 2, 40)[:, 0]) * (40**-0.5 * PA.LOG2E)
    want0 = s0[..., None].expand(-1, -1, -1, 40).reshape(2, 256, 80)
    _close(PA.v3_attention(q, k, v, 2, 40**-0.5, attn=PA.attention_dmajor_scores), want0)
    _close(PA.attention_probe(q, k, v, 2, 40**-0.5, "scores"), want0)


# ---- perf_gn4: chunked (statistics + apply over HW chunks) and flat_onepass ----

def _gn_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    gamma = (rng.standard_normal(shape[-1]) * 0.5 + 1).astype(np.float32)
    beta = (rng.standard_normal(shape[-1]) * 0.5).astype(np.float32)
    return _bf16(x), (jnp.asarray(gamma), torch.from_numpy(gamma)), (jnp.asarray(beta),
                                                                     torch.from_numpy(beta))


@pytest.mark.parametrize("ch", [256, 128, 64])
def test_gn4_chunked(ch):
    (xj, x), (gj, g), (bj, b) = _gn_inputs((2, 16, 16, 64), 7)
    want = _script("perf_gn4")["chunked"](xj, gj, bj, ch)
    _close(PG.group_norm_probe(x, g, b, splits=256 // ch), want)


def test_gn4_flat_onepass():
    (xj, x), (gj, g), (bj, b) = _gn_inputs((2, 16, 16, 64), 8)
    want = _script("perf_gn4")["flat_onepass"](xj, gj, bj, 256)
    _close(PG.group_norm_probe(x, g, b), want)


# ---- perf_gn5: merged / nohi / mxu ----

@pytest.mark.parametrize("kind", ["merged", "nohi", "mxu"])
def test_gn5_kinds(kind):
    (xj, x), (gj, g), (bj, b) = _gn_inputs((2, 8, 8, 320), 9)
    want = _script("perf_gn5")["make"](kind, (2, 8, 8, 320))(xj, gj, bj)
    _close(PG.group_norm_probe(x, g, b, mma=kind == "mxu"), want)


def test_gn5_mxu_rounds_x2_to_bf16():
    """The mxu statistics take x^2 rounded to bf16: the variance moves by
    at most 2^-9 of E[x^2], well inside the output's bf16 rounding."""
    (_, x), (_, g), (_, b) = _gn_inputs((2, 8, 8, 320), 10)
    a = PG.group_norm_probe_plain(x, g, b, mma=True).float()
    e = PG.group_norm_probe_plain(x, g, b).float()
    assert float((a - e).abs().max() / e.abs().max()) <= 1e-2


# ---- perf_gn6: copy / stats / norm / full / bf16sig ----

@pytest.mark.parametrize("mode", ["copy", "stats", "norm", "full", "bf16sig"])
def test_gn6_modes(mode):
    (xj, x), (gj, g), (bj, b) = _gn_inputs((2, 8, 8, 320), 11)
    want = _script("perf_gn6")["make"](mode, (2, 8, 8, 320))(xj, gj, bj)
    got = PG.group_norm_probe(x, g, b, mode)
    if mode in ("copy", "stats"):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.float32(want)))
    else:
        _close(got, want)


# ---- K8 on both of K3's forms: the twins at shapes where K3's plan takes each ----

# (2, 8, 8, 320): the slab form; (1, 64, 64, 320): the split form (132
# tiles of 31 or 32 pixels at batch 1)
_FORM_SHAPES = [((2, 8, 8, 320), "slab"), ((1, 64, 64, 320), "split")]


@pytest.mark.parametrize("shape,form", _FORM_SHAPES)
@pytest.mark.parametrize("mode", ["copy", "stats", "norm", "full", "bf16sig"])
def test_gn6_modes_at_both_forms(shape, form, mode):
    n, h, w, c = shape
    assert PG.probe_plan(n, h * w, c, 32, mode, None, 132).form == form
    (xj, x), (gj, g), (bj, b) = _gn_inputs(shape, 31)
    want = _script("perf_gn6")["make"](mode, shape)(xj, gj, bj)
    got = PG.group_norm_probe(x, g, b, mode)
    if mode in ("copy", "stats"):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.float32(want)))
    else:
        _close(got, want)


@pytest.mark.parametrize("shape,form", _FORM_SHAPES)
@pytest.mark.parametrize("kind", ["merged", "mxu"])
def test_gn5_kinds_at_both_forms(shape, form, kind):
    n, h, w, c = shape
    assert PG.probe_plan(n, h * w, c, 32).form == form
    (xj, x), (gj, g), (bj, b) = _gn_inputs(shape, 32)
    want = _script("perf_gn5")["make"](kind, shape)(xj, gj, bj)
    _close(PG.group_norm_probe(x, g, b, mma=kind == "mxu"), want)


@pytest.mark.parametrize("ch", [4096, 1024, 256])
def test_gn4_chunked_on_a_split_form_plane(ch):
    """perf_gn4's chunked form on a 64^2 plane: K8 runs K3's split form with
    the sample cut into hw / chunk runs (1, 4 and 16), each of K3's split
    tiles streaming its share of every run, every count the twin's values."""
    shape = (1, 64, 64, 320)
    (xj, x), (gj, g), (bj, b) = _gn_inputs(shape, 33)
    want = _script("perf_gn4")["chunked"](xj, gj, bj, ch)
    plan = PG.probe_plan(1, 4096, 320, 32, "full", 4096 // ch)
    assert (plan.form, plan.runs) == ("split", 4096 // ch)
    assert plan.tiles == min(132, ch)
    _close(PG.group_norm_probe(x, g, b, splits=4096 // ch), want)


# ---- perf_gn7 / perf_gn8: the streaming copies ----

@pytest.mark.parametrize("ch", [256, 64])
@pytest.mark.parametrize("conv", [False, True])
def test_gn7_copy(ch, conv):
    (xj, x), = (_bf16(np.random.default_rng(12).standard_normal((2, 256, 64)).astype(np.float32)),)
    want = _script("perf_gn7")["make"]((2, 256, 64), ch, conv)(xj)
    got = PS.stream_copy(x, ch, conv)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.float32(want)))


@pytest.mark.parametrize("nbuf,stages", [(0, 1), (3, 3), (4, 4), (8, 8)])
def test_gn8_buffered_copy(nbuf, stages):
    (xj, x), = (_bf16(np.random.default_rng(13).standard_normal((2, 256, 64)).astype(np.float32)),)
    want = _script("perf_gn8")["make"]((2, 256, 64), 128, nbuf)(xj)
    got = PS.stream_copy(x, 128, False, stages)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jnp.float32(want)))


# ---- the wrappers on the CPU ----

def test_probe_wrappers_on_cpu_launch_nothing_and_reject_what_k7_k9_lack():
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2 * 40)).astype(np.float32)).bfloat16()
               for _ in range(3))
    counts = (PA.attention_probe.launches, PG.group_norm_probe.launches, PS.stream_copy.launches)
    a = PA.attention_probe(q, k, v, 2, 0.2)
    torch.testing.assert_close(PA.attention_probe(q, k, v, 2, 0.2, kv_tile=128), a, rtol=0,
                               atol=0)
    x = q.reshape(1, 8, 10, 64)
    PG.group_norm_probe(x, torch.ones(64), torch.zeros(64), splits=4)
    PS.stream_copy(q, 16)
    assert counts == (PA.attention_probe.launches, PG.group_norm_probe.launches,
                      PS.stream_copy.launches)
    # ablated modes run at K1's own key tile (128 keys at d = 40)
    for kw in (dict(mode="scores", denom="ones"), dict(mode="pv", kv_tile=64),
               dict(unnormalized=True), dict(kv_tile=32), dict(mode="softmax")):
        with pytest.raises(ValueError):
            PA.attention_probe(q, k, v, 2, 0.2, **kw)
    with pytest.raises(ValueError):  # a ones column only at d = 40, 80, 160
        w = torch.zeros((1, 64, 96), dtype=torch.bfloat16)
        PA.attention_probe(w, w, w, 2, 0.2, denom="ones")
    with pytest.raises(ValueError):
        PG.group_norm_probe(x, torch.ones(64), torch.zeros(64), "copy", splits=2)
    with pytest.raises(ValueError):
        PS.stream_copy(q, 48)  # rows must divide HW


def test_port_never_imports_jax_or_the_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (read from the source, so a lazy import inside a function counts
    too)."""
    files = sorted((ROOT / "complex_prompt_diffusion_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "complex_prompt_diffusion_tpu"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert len(files) > 30 and not bad, bad


def _gn_sass(full=30, stats=30, copy=0, rsq=2, hmma=16):
    """Per-kernel SASS counts of K8's instantiations of K3's Hopper kernels
    (slab, statistics and apply kernels in K8's translation unit), keyed by
    mangled names as cuobjdump prints them."""
    tu = "_ZN51_GLOBAL__N__e73a7672_18_probe_groupnorm_cu_e620f378"
    counts = {}

    def put(name, shfl=0, c_rsq=0, c_hmma=0):
        counts[tu + name] = {"HMMA": c_hmma, "FFMA": 0, "SHFL": shfl, "MUFU.RSQ": c_rsq}

    for mode, mma, shfl, c_rsq, c_hmma in ((0, 0, full, rsq, 0), (1, 0, copy, 0, 0),
                                           (2, 0, stats, rsq, 0), (4, 0, full, rsq, 0),
                                           (0, 1, full, rsq, hmma)):
        put(f"14gn_slab_kernelI13__nv_bfloat16Li{mode}ELb{mma}EEEv14CUtensorMap_st", shfl, c_rsq,
            c_hmma)
    for mma in (0, 1):
        put(f"15gn_stats_kernelI13__nv_bfloat16Lb{mma}ELb0EEEvPKT_P6float2iiii", full, 0,
            hmma if mma else 0)
    for mode, c_rsq in ((0, rsq), (1, 0), (2, rsq), (4, rsq)):
        put(f"15gn_apply_kernelI13__nv_bfloat16Li{mode}ELb0EEEvPKT_PK6float2S4_S4_PS2_iiiiifi",
            0, c_rsq)
    # the forced chunks' instantiations (RUNS true) are not the ones checked
    put("15gn_stats_kernelI13__nv_bfloat16Lb0ELb1EEEvPKT_P6float2iiii")
    put("15gn_apply_kernelI13__nv_bfloat16Li0ELb1EEEvPKT_PK6float2S4_S4_PS2_iiiiifi")
    return counts


@pytest.mark.parametrize("counts,ok", [
    (_gn_sass(), True),
    (_gn_sass(stats=0), False),  # a build that dropped the statistics of "stats"
    (_gn_sass(copy=30), False),  # "copy" is meant to hold no statistics
    (_gn_sass(rsq=0), False),
    (_gn_sass(hmma=0), False),  # the tensor-core statistics lost their MMAs
    ({}, False),
])
def test_k8_sass_check_needs_the_statistics(counts, ok):
    """K8's "stats" mode writes ``x + rstd * gamma * 0``, equal to its plain
    twin whether or not the statistics ran, so phase 10 holds its SASS to
    the full mode's shuffles and rsqrt; the check must fail on a build
    without them."""
    from complex_prompt_diffusion_tpu_torch.tools.probe_groupnorm import check_sass

    lines, got = check_sass(counts)
    assert got is ok
    assert len(lines) == (3 if counts else 2)  # a header, then a line a form (or what is missing)
