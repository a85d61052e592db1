"""The port stands alone: no module of `repro_torch`, not chip_smoke.py and
no example under `examples/torch/` imports jax or anything of the JAX
package `repro`; and chip_smoke.py
refuses to report a result without a CUDA device or without the repository
beside it.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

REPO = pathlib.Path(__file__).resolve().parents[1]
SMOKE = REPO / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names)); print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert int(out[0]) >= 30, out
    assert out[1] == "[]", f"the port imported {out[1]}"


LM_SLICE_MODULES = (
    "repro_torch.core.parallelism", "repro_torch.launch.mesh", "repro_torch.models.config",
    "repro_torch.models.layers", "repro_torch.models.frontend", "repro_torch.models.transformer",
    "repro_torch.configs.registry", "repro_torch.serve.engine", "repro_torch.serve.lm.engine",
    "repro_torch.data.synthetic", "repro_torch.train.step", "repro_torch.launch.specs", "repro_torch.launch.train",
) + tuple(f"repro_torch.configs.{m}" for m in (
    "dbrx_132b", "deepseek_7b", "demo_100m", "gemma3_1b", "hubert_xlarge", "internlm2_1_8b",
    "moonshot_v1_16b_a3b", "phi3_vision_4_2b", "qwen2_0_5b", "recurrentgemma_2b", "rwkv6_1_6b", "fixar_ddpg"))


def test_lm_slice_modules_are_walked_and_import_alone():
    """The mesh, the rules, the LM zoo's modules and its training path
    (data, train step, specs, the train CLI) are among those the walk above
    imports, and each imports in a fresh interpreter with
    neither jax nor repro loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')}\n"
        f"want = {LM_SLICE_MODULES!r}\n"
        "print(sorted(set(want) - names))\n"
        "for n in want: importlib.import_module(n)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert out == ["[]", "[]"], out


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_neither_jax_nor_repro():
    roots = _imported_roots(SMOKE)
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_sources_import_neither_jax_nor_repro():
    for path in (REPO / "src" / "repro_torch").rglob("*.py"):
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}, path


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "examples").glob("*.py")))
def test_example_ports_import_neither_jax_nor_repro(name):
    """Each of the reference's examples has a port under `examples/torch/`
    that imports the port's package, numpy and the standard library only."""
    roots = _imported_roots(REPO / "examples" / "torch" / f"{name}.py")
    assert "repro_torch" in roots, roots
    assert not roots & {"jax", "jaxlib", "repro", "flax", "optax"}, roots
    assert roots - {"repro_torch", "torch", "numpy"} <= set(sys.stdlib_module_names), roots


def test_chip_smoke_fails_without_cuda():
    """Without a CUDA device the script must exit non-zero and print no
    status line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device path is not reachable")
    res = subprocess.run([sys.executable, str(SMOKE)], cwd=REPO, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
