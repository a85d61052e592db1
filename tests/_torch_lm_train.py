"""Shared set-up of the LM training parity tests (`tests/test_torch_lm_train_*.py`).

The same numpy params, ranges and batch go through the JAX reference's
`jax.value_and_grad(models.transformer.loss_fn)` (jitted once per arch and
QAT setting, without its remat: the same values, a faster compile) and
the port's `train.step.value_and_grad` (`torch.autograd`), float32 smoke
configs, B = 2, S = 32.

Tolerances (module docstrings of the test files repeat them):
  * loss: |Δ| ≤ 2e-5·|loss| + 2e-5, the LM forward's float32 contract
    (tests/test_torch_lm_model.py);
  * each gradient leaf: max |Δ| ≤ 1e-4·max|g_leaf| + 1e-6 with QAT off or
    in the monitor phase (sums in another order through the layers and
    their backward; the monitor sites round to Q15.16, where an input one
    ulp apart can take the neighbouring point), 1e-3·max|g_leaf| + 1e-6 in
    the quant phase (one 16-bit affine code flip at a site, the
    reference's quant-phase contract, tests/kernels/test_fxp_mlp_step.py);
  * updated ranges: rtol 1e-4 / atol 5e-5, counts exact (the forward's).

The quant phase runs on ranges a monitor-phase forward captured on another
batch, as training freezes them: on the batch that set a range its extreme
elements sit on the fake-quantizer's clip edge, where the clip's gradient is
0, ½ or 1 by the float32 rounding of the element, so neither package's
gradient there is a contract of the other's.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as rreg
from repro.models import transformer as RT
from repro_torch import convert, tree
from repro_torch.configs import registry as preg
from repro_torch.train import step as PS

B, S = 2, 32
MODES = ("off", "monitor", "quant")
LOSS_TOL = 2e-5
GRAD_TOL = {"off": 1e-4, "monitor": 1e-4, "quant": 1e-3}
RANGE_RTOL, RANGE_ATOL = 1e-4, 5e-5


def configs(arch: str, **kw):
    """(reference config, port config), float32."""
    return (dataclasses.replace(rreg.get_smoke(arch), dtype="float32", **kw),
            dataclasses.replace(preg.get_smoke(arch), dtype="float32", **kw))


def batch(rc, seed: int, s: int = S, b: int = B) -> dict:
    """A numpy training batch: tokens or frontend embeddings, labels with a
    few masked positions."""
    rng = np.random.default_rng(seed)
    out = {}
    if rc.frontend != "audio_stub":
        out["tokens"] = rng.integers(0, rc.vocab_size, (b, s)).astype(np.int32)
    if rc.frontend == "vision_stub":
        out["frontend"] = rng.normal(size=(b, rc.frontend_len, rc.frontend_dim)).astype(np.float32)
    if rc.frontend == "audio_stub":
        out["frontend"] = rng.normal(size=(b, s, rc.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, rc.vocab_size, (b, s)).astype(np.int32)
    labels[0, :3] = -100
    out["labels"] = labels
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def setup(arch: str):
    """(rc, pc, reference params, numpy params, frozen numpy ranges for the
    quant phase: what the monitor phase captured on another batch)."""
    rc, pc = configs(arch)
    rp = RT.init_params(jax.random.key(0), rc)
    (_, ex), _ = _ref_fn(arch, True, 0)(rp, to_jax(batch(rc, seed=7)), RT.init_ranges(rc), jnp.asarray(False))
    return rc, pc, rp, jax.tree.map(np.asarray, rp), jax.tree.map(np.asarray, ex["ranges"])


@functools.lru_cache(maxsize=None)
def _ref_fn(arch: str, qat: bool, ce_chunk: int):
    rc = configs(arch)[0]

    def f(p, b, r, q):
        return RT.loss_fn(p, b, rc, ranges=r if qat else None, quant_phase=q if qat else None, ce_chunk=ce_chunk,
                          remat=False)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _ranges_in(arch: str, mode: str, rc):
    if mode == "off":
        return None
    return RT.init_ranges(rc) if mode == "monitor" else jax.tree.map(jnp.asarray, setup(arch)[4])


@functools.lru_cache(maxsize=None)
def reference(arch: str, mode: str, ce_chunk: int = 0, seed: int = 1):
    """The reference's (loss, [(path, grad leaf)], new ranges) as numpy."""
    rc, _, rp, _, _ = setup(arch)
    (loss, ex), g = _ref_fn(arch, mode != "off", ce_chunk)(rp, to_jax(batch(rc, seed)), _ranges_in(arch, mode, rc),
                                                         jnp.asarray(mode == "quant"))
    grads = [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in jax.tree_util.tree_flatten_with_path(g)[0]]
    ranges = None if mode == "off" else jax.tree.map(np.asarray, ex["ranges"])
    return float(loss), grads, ranges


def port(arch: str, mode: str, ce_chunk: int = 0, seed: int = 1, **cfg_kw):
    """The port's (loss, [grad leaf], new ranges) on the same inputs."""
    rc, pc, _, np_params, np_ranges = setup(arch)
    if cfg_kw:
        pc = dataclasses.replace(pc, **cfg_kw)
    params = convert.lm_params_from_numpy(np_params, device="cpu")
    ranges = None
    if mode == "monitor":
        ranges = convert.lm_ranges_from_numpy(jax.tree.map(np.asarray, RT.init_ranges(rc)), device="cpu")
    elif mode == "quant":
        ranges = convert.lm_ranges_from_numpy(np_ranges, device="cpu")
    loss, ex, grads = PS.value_and_grad(pc, params, ranges, to_torch(batch(rc, seed)), torch.tensor(mode == "quant"),
                                        ce_chunk=ce_chunk)
    return float(loss), tree.leaves(grads), ex["ranges"]


def assert_loss(got: float, want: float, what: str = "") -> None:
    assert abs(got - want) <= LOSS_TOL * abs(want) + LOSS_TOL, f"{what}: loss {got} against {want}"


def assert_grads(got: list, want: list, rel: float, what: str = "") -> None:
    """Leaf by leaf: max |Δ| ≤ rel·max|g_leaf| + 1e-6 (`want` as
    (path, array) pairs in pytree order, `got` tensors in the same order)."""
    assert len(got) == len(want), what
    for t, (path, w) in zip(got, want):
        g = t.detach().numpy().astype(np.float64)
        w = w.astype(np.float64)
        assert g.shape == w.shape, (what, path)
        if w.size:
            err, scale = np.abs(g - w).max(), np.abs(w).max()
            assert err <= rel * scale + 1e-6, f"{what} {path}: max |Δ| {err} > {rel}·{scale} + 1e-6"


def assert_ranges(got, want, what: str = "") -> None:
    """The port's range tree against the reference's (numpy) at the
    forward's contract, counts exactly."""
    ref = [(jax.tree_util.keystr(p), w) for p, w in jax.tree_util.tree_flatten_with_path(want)[0]]
    mine = tree.flatten_with_path(got)
    assert [p for p, _ in mine] == [p for p, _ in ref], what
    for (path, w), (_, g) in zip(ref, mine):
        g = g.numpy()
        assert g.dtype == w.dtype, (what, path)
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(g, w, rtol=RANGE_RTOL, atol=RANGE_ATOL, err_msg=f"{what} {path}")
