"""A closed engine releases what it holds: the bundle's `/healthz` source
holds the engine weakly, so `close()` and the last reference dropping
free the engine and its params with no garbage-collection pass, while a
live engine's `/healthz` and `stats()` read as before."""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (one intra-op thread a worker)

from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.obs import Observability
from repro_torch.rl import ddpg
from repro_torch.serve.lm import LMEngine
from repro_torch.serve.policy import PolicyEngine


def _lm_engine(obs):
    cfg = registry.get_smoke("qwen2_0_5b")
    params = T.init_params(0, cfg, device="cpu")
    return LMEngine(params, cfg, lanes=2, max_seq=32, device="cpu", obs=obs), params["embed"]["embedding"]


def _policy_engine(obs):
    actor = ddpg.init_actor(3, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    return PolicyEngine(actor, device="cpu", obs=obs), actor["l0"]["w"]


@pytest.mark.parametrize("make", [_lm_engine, _policy_engine], ids=["lm", "policy"])
def test_closed_engine_frees_its_params_without_gc(make):
    obs = Observability()
    eng, leaf = make(obs)
    ref = weakref.ref(leaf)
    del leaf
    name, source = next(iter(obs._health.items()))
    assert source() == eng.health()  # unchanged while the engine lives
    stats = eng.stats()
    assert stats == eng.stats()
    gc.disable()
    try:
        eng.close()
        del eng
        assert ref() is None, "the closed engine's params outlived it"
    finally:
        gc.enable()
    assert source()["ok"] and source()["released"]
    assert obs._health[name] is source
