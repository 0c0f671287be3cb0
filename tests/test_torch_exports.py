"""The port's public surface against the JAX package's: every name a JAX
subpackage (or module of the last slice) exports resolves on the port's
counterpart, and the JAX-bundle converter stays outside the port's
imports.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# names of a JAX ``__all__`` the port does not have, by module: TPU-only
# surface (none is left: the list stays to say so)
TPU_ONLY = {}

MODULES = ["utils", "schedules", "ops", "guidance", "models", "models.embedders", "parallel",
           "parallel.mesh", "parallel.tp", "ops.sharding", "samplers", "prompts", "train"]


@pytest.mark.parametrize("name", MODULES)
def test_port_resolves_every_name_jax_exports(name):
    jax_mod = importlib.import_module(f"complex_prompt_diffusion_tpu.{name}")
    port = importlib.import_module(f"complex_prompt_diffusion_tpu_torch.{name}")
    missing = [n for n in jax_mod.__all__
               if not hasattr(port, n) and n not in TPU_ONLY.get(name, ())]
    assert not missing, f"{name}: {missing}"


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
