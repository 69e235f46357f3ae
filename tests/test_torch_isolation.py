"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, and the
deprecated entry-point names of the reference do not appear in it."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN_ROOTS = {"jax", "jaxlib", "repro", "flax", "optax"}
DEPRECATED = {"run_experiment_sweep", "run_bandit_experiment",
              "run_bandit_sweep", "HFLSimulation"}


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


SERVE_SLICE = ("configs/base.py", "configs/qwen2_1_5b.py",
               "configs/rwkv6_1_6b.py", "models/layers.py",
               "models/transformer.py", "models/rwkv6.py",
               "models/registry.py", "models/convert.py",
               "kernels/flash_attention/ops.py",
               "kernels/flash_attention/kernel.py",
               "kernels/flash_attention/ref.py", "kernels/rwkv6_scan/ops.py",
               "kernels/rwkv6_scan/kernel.py", "kernels/rwkv6_scan/ref.py",
               "launch/serve.py", "serving/engine.py",
               "configs/mixtral_8x22b.py", "models/moe.py",
               "kernels/moe_router/ops.py", "kernels/moe_router/kernel.py",
               "kernels/moe_router/ref.py", "configs/granite_8b.py",
               "configs/granite_20b.py", "configs/qwen2_5_14b.py",
               "configs/kimi_k2_1t_a32b.py", "configs/zamba2_1_2b.py",
               "configs/paligemma_3b.py",
               "configs/seamless_m4t_large_v2.py", "models/mamba2.py",
               "models/zamba2.py", "models/encdec.py")


def test_port_files_found():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").exists()
    for rel in SERVE_SLICE:
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


def test_every_port_module_imports_with_jax_blocked():
    """Each module of the port imports in a process where ``jax`` and the
    reference package ``repro`` cannot be imported at all."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            .removesuffix(".__init__")
            for p in PORT_FILES if p.name != "chip_smoke.py"]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in FORBIDDEN_ROOTS]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_deprecated_names(path):
    tree = ast.parse(path.read_text())
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            used.add(node.attr)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            used.add(node.name)
        elif isinstance(node, ast.alias):
            used.add(node.asname or node.name.split(".")[-1])
    assert not (used & DEPRECATED), f"{path} uses {used & DEPRECATED}"
