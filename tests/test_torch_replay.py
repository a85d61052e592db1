"""Port parity: `repro_torch.rl.replay` against the JAX reference's ring
buffer: the same adds (numpy, from a seed) leave the same storage, cursor
and size, bitwise, including B > capacity (FIFO: the newest rows win), and
`take` at the indices the reference's `sample` draws returns its batch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.rl import replay as rreplay

from repro_torch.rl import replay as preplay

OBS, ACT = 3, 2


def _rows(rng, b):
    return {
        "obs": rng.normal(size=(b, OBS)).astype(np.float32),
        "action": rng.normal(size=(b, ACT)).astype(np.float32),
        "reward": rng.normal(size=(b,)).astype(np.float32),
        "next_obs": rng.normal(size=(b, OBS)).astype(np.float32),
        "done": rng.uniform(size=(b,)) < 0.5,
    }


def _assert_same(buf_p, buf_r):
    for f in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_array_equal(getattr(buf_p, f).numpy(), np.asarray(getattr(buf_r, f)), err_msg=f)
    assert buf_p.ptr == int(buf_r.ptr) and buf_p.size == int(buf_r.size)


@pytest.mark.parametrize("sizes", [[1, 1, 3], [4, 5, 2, 6], [11], [3, 13, 1]], ids=["small", "wrap", "over", "mixed"])
def test_adds_match_reference(sizes):
    cap = 8
    rng = np.random.default_rng(sum(sizes))
    buf_r = rreplay.init(cap, OBS, ACT)
    buf_p = preplay.init(cap, OBS, ACT, device="cpu")
    for b in sizes:
        rows = _rows(rng, b)
        buf_r = rreplay.add_batch(buf_r, jax.tree.map(jnp.asarray, rows))
        buf_p = preplay.add_batch(buf_p, {k: torch.from_numpy(v) for k, v in rows.items()})
        _assert_same(buf_p, buf_r)


def test_sample_at_the_reference_indices():
    rng = np.random.default_rng(0)
    rows = _rows(rng, 6)
    buf_r = rreplay.add_batch(rreplay.init(10, OBS, ACT), jax.tree.map(jnp.asarray, rows))
    buf_p = preplay.add_batch(preplay.init(10, OBS, ACT, device="cpu"), {k: torch.from_numpy(v) for k, v in rows.items()})
    key = jax.random.key(3)
    want = rreplay.sample(buf_r, key, 5)
    idx = jax.random.randint(key, (5,), 0, jnp.maximum(buf_r.size, 1))  # what `sample` draws
    got = preplay.take(buf_p, torch.from_numpy(np.asarray(idx).astype(np.int64)))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_sample_draws_valid_rows_only():
    buf = preplay.init(16, OBS, ACT, device="cpu")
    rows = _rows(np.random.default_rng(1), 4)
    buf = preplay.add_batch(buf, {k: torch.from_numpy(v) for k, v in rows.items()})
    batch = preplay.sample(buf, torch.Generator().manual_seed(0), 64)
    assert batch["obs"].shape == (64, OBS) and batch["done"].dtype == torch.bool
    stored = {tuple(r) for r in rows["obs"].tolist()}
    assert {tuple(r) for r in batch["obs"].tolist()} <= stored
