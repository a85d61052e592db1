"""The port's fault-tolerance control plane, `repro_torch.runtime.ft` (a
copy of the reference's stdlib-only module): heartbeats, failure and
straggler detection, elastic mesh planning, rebalancing, the data
skip-ahead and the supervisor.

Every test of the reference's `tests/test_runtime.py` runs here on the
port's copy: the file's source with `from repro.` pointed at
`repro_torch.`, collected as `test_runtime__<name>`.  Beside them, the
port's module and the reference's give the same plans on a grid of
cluster shapes.
"""

import pathlib
import re

import pytest

pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

from repro.runtime import ft as rft

from repro_torch.runtime import ft as pft

REFERENCE = pathlib.Path(__file__).resolve().parent / "test_runtime.py"


def _mirror() -> None:
    src = re.sub(r"^from repro\.", "from repro_torch.", REFERENCE.read_text(), flags=re.M)
    ns = {"__name__": f"{__name__}.test_runtime", "__file__": str(REFERENCE)}
    exec(compile(src, str(REFERENCE), "exec"), ns)
    assert ns["ft"] is pft
    for name, obj in ns.items():
        if name.startswith("test_") and callable(obj):
            globals()[f"test_runtime__{name[5:]}"] = obj


_mirror()


def test_every_reference_runtime_test_is_mirrored():
    ref = re.findall(r"^def (test_\w+)", REFERENCE.read_text(), flags=re.M)
    assert ref and all(f"test_runtime__{n[5:]}" in globals() for n in ref)


@pytest.mark.parametrize("survivors", [16, 40, 64, 100, 256, 511])
@pytest.mark.parametrize("model_parallel", [1, 4, 16])
def test_elastic_plans_match_reference(survivors, model_parallel):
    got = pft.plan_elastic_mesh(survivors, model_parallel=model_parallel, original_data=16)
    want = rft.plan_elastic_mesh(survivors, model_parallel=model_parallel, original_data=16)
    assert got.__dict__ == want.__dict__


def test_too_few_survivors_raise_as_in_the_reference():
    for mod in (pft, rft):
        with pytest.raises(ValueError, match="cannot keep model_parallel"):
            mod.plan_elastic_mesh(8, model_parallel=16)


def test_rebalance_weights_match_reference():
    times = {0: 0.5, 1: 0.7, 2: 1.9, 3: 0.5}
    assert pft.rebalance_weights(times) == rft.rebalance_weights(times)
