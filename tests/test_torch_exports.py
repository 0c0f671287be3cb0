"""The port's public surface against the JAX package's: every public name
of every JAX module that defines ``__all__`` (its ``__all__``, and the
public functions and classes it defines) resolves on the port's
counterpart, less the TPU-only ones, and the JAX-bundle converter stays
outside the port's imports.
"""

import ast
import importlib
import inspect
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "complex_prompt_diffusion_tpu"

# public names of a JAX module the port does not have, by module, each with
# its reason
TPU_ONLY = {
    "models.layers": {
        "as_np_rng": "converts a JAX PRNG key to a numpy Generator for host-side init; the "
                     "port's init functions draw from a torch.Generator",
    },
}


def _modules_with_all() -> list:
    """Every module of the JAX package whose source defines ``__all__``, by
    dotted name under the package (a package by its ``__init__``)."""
    out = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        if not any(line.startswith("__all__") for line in path.read_text().splitlines()):
            continue
        parts = path.relative_to(JAX_PKG).with_suffix("").parts
        out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


MODULES = _modules_with_all()


def _public(mod) -> list:
    """A module's ``__all__`` and the public functions and classes it
    defines itself."""
    own = [n for n, v in vars(mod).items() if not n.startswith("_")
           and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == mod.__name__]
    return list(dict.fromkeys([*mod.__all__, *own]))


@pytest.mark.parametrize("name", MODULES)
def test_port_resolves_every_name_jax_exports(name):
    jax_mod = importlib.import_module(f"complex_prompt_diffusion_tpu.{name}")
    port = importlib.import_module(f"complex_prompt_diffusion_tpu_torch.{name}")
    missing = [n for n in _public(jax_mod)
               if not hasattr(port, n) and n not in TPU_ONLY.get(name, {})]
    assert not missing, f"{name}: {missing}"


def test_tpu_only_names_are_jax_names_the_port_lacks():
    """Each TPU-only entry names a public name of its JAX module, one the
    port does not have, with a reason: the list cannot go stale."""
    assert "models.layers" in MODULES and "ops.groupnorm" in MODULES
    for name, names in TPU_ONLY.items():
        jax_mod = importlib.import_module(f"complex_prompt_diffusion_tpu.{name}")
        port = importlib.import_module(f"complex_prompt_diffusion_tpu_torch.{name}")
        for n, reason in names.items():
            assert n in _public(jax_mod) and not hasattr(port, n) and reason, (name, n)


def _imported(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


def test_convert_jax_bundle_is_imported_by_nothing_of_the_port():
    """``convert_jax_bundle.py`` imports jax and orbax (through the JAX
    package): no module of the port and no line of ``chip_smoke.py``
    imports it or names it, and of the root scripts that import the port it
    is the only one that imports the JAX package or jax."""
    files = sorted((ROOT / "complex_prompt_diffusion_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        assert "convert_jax_bundle" not in path.read_text(), path
    both = []
    for path in sorted(ROOT.glob("*.py")):
        mods = {m.split(".")[0] for m in _imported(path)}
        if "complex_prompt_diffusion_tpu_torch" in mods and (
                mods & {"jax", "orbax", "complex_prompt_diffusion_tpu"}):
            both.append(path.name)
    assert both == ["convert_jax_bundle.py"]
    assert {"complex_prompt_diffusion_tpu", "complex_prompt_diffusion_tpu_torch"} <= {
        m.split(".")[0] for m in _imported(ROOT / "convert_jax_bundle.py")}
