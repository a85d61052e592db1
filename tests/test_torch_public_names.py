"""The port's public surface against the reference's, module by module.

For every module of the JAX package `repro` (each `.py` under `src/repro`),
the port's module of the same path under `repro_torch` must exist and
offer every public name the reference's offers: its `__all__`, or else the
classes, functions and aliases defined in it and its UPPERCASE constants;
for a package, every public name its `__init__.py` binds (the port's
`__init__.py` must bind it itself, not by a side effect of another import:
`import repro.rl` gives `repro.rl.loop`).  Left out by name, with the
reason: the Pallas entry points, whose counterparts are the port's CUDA
wrappers under other names (PERF.md §6).
"""

import ast
import importlib
import inspect
import pathlib

import pytest

pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
REF = REPO / "src" / "repro"
PORT = REPO / "src" / "repro_torch"

LEFT_OUT_MODULES: dict = {}
# the Pallas entry points (and Pallas's compiler-params shim): the port's
# kernels are CUDA, reached through `*_cuda` wrappers of its own
PALLAS_NAMES = {
    "repro.kernels._compat": {"CompilerParams"},
    "repro.kernels.fxp_matmul.kernel": {"fxp_dense_pallas"},
    "repro.kernels.fxp_mlp.kernel": {"fxp_mlp_pallas", "fxp_mlp_bwd_pallas", "ddpg_critic_step_pallas",
                                     "ddpg_actor_step_pallas"},
    "repro.kernels.quantize.kernel": {"monitor_quant_pallas"},
}


def _module_names():
    out = []
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        if ".".join(parts) not in LEFT_OUT_MODULES:
            out.append((".".join(parts), path))
    return out


def _bound(path: pathlib.Path, imports: bool = True) -> set:
    """Public names a module's source binds at top level (imports, defs,
    classes, assignments)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)) and imports:
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_") and n != "annotations"}


def _public(name: str, path: pathlib.Path) -> set:
    mod = importlib.import_module(name)
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    if path.name == "__init__.py":
        return _bound(path) - {"dataclasses", "Callable", "Optional", "Any"}
    defined = {n for n in dir(mod) if not n.startswith("_")
               and getattr(getattr(mod, n), "__module__", None) == name
               and (inspect.isclass(getattr(mod, n)) or callable(getattr(mod, n)))}
    return defined | {n for n in _bound(path, imports=False) if n.isupper()}


@pytest.mark.parametrize("name, path", _module_names(), ids=[n for n, _ in _module_names()])
def test_port_offers_every_public_name_of_the_reference(name, path):
    port_name = "repro_torch" + name[len("repro"):]
    port_path = PORT / path.relative_to(REF)
    assert port_path.is_file(), f"{port_name} is missing ({port_path.relative_to(REPO)})"
    want = _public(name, path) - PALLAS_NAMES.get(name, set())
    port = importlib.import_module(port_name)
    if path.name == "__init__.py":  # bound by the package itself
        have = _bound(port_path) | set(getattr(port, "__all__", ()))
        missing = sorted(n for n in want if n not in have)
    else:
        missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"{port_name} lacks {missing}"
