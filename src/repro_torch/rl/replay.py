"""Ring-buffer replay on the training loop's device (port of
`repro.rl.replay`).

`add`/`add_batch` store a batch of transitions (`add_batch` takes the dict
layout `sample` returns and `ddpg.update` consumes); `sample` draws a
uniform random batch.  Unlike the reference's pure functions, `add` writes
into the buffer's storage in place (no copy of the whole buffer per step)
and returns the buffer with its cursor advanced.  `ptr` and `size` are 0-d
int64 tensors on the buffer's device, as the reference keeps them, and
`sample` bounds its draw on the device: neither reads the device on the
host, so a CUDA graph can capture a store and a sample.  (A loop that needs
the size on the host computes it: min(transitions stored, capacity).)
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class ReplayBuffer:
    obs: Tensor  # (cap, obs_dim)
    action: Tensor  # (cap, act_dim)
    reward: Tensor  # (cap,)
    next_obs: Tensor  # (cap, obs_dim)
    done: Tensor  # (cap,) bool
    ptr: Tensor  # 0-d int64: next write slot
    size: Tensor  # 0-d int64: valid entries

    @property
    def capacity(self) -> int:
        return int(self.obs.shape[0])


def init(capacity: int, obs_dim: int, act_dim: int, *, device: DeviceLike = None) -> ReplayBuffer:
    dev = resolve_device(device)
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
    return ReplayBuffer(
        obs=zeros(capacity, obs_dim),
        action=zeros(capacity, act_dim),
        reward=zeros(capacity),
        next_obs=zeros(capacity, obs_dim),
        done=zeros(capacity, dtype=torch.bool),
        ptr=zeros(dtype=torch.int64),
        size=zeros(dtype=torch.int64),
    )


def add(buf: ReplayBuffer, obs, action, reward, next_obs, done) -> ReplayBuffer:
    """Add a batch of B transitions (B may be 1), wrapping modulo capacity.

    B > capacity keeps FIFO order: only the newest `capacity` rows can
    survive the ring, so the leading rows are dropped before the write and
    every slot is written once; `ptr` still advances by the full B (mod
    capacity), landing just past the newest row kept."""
    b = int(obs.shape[0])
    cap = buf.capacity
    keep = min(b, cap)
    idx = (buf.ptr + (b - keep) + torch.arange(keep, device=buf.obs.device)) % cap
    for store, rows in (
        (buf.obs, obs),
        (buf.action, action),
        (buf.reward, reward),
        (buf.next_obs, next_obs),
        (buf.done, done),
    ):
        store[idx] = rows[b - keep :].to(store.dtype)
    return dataclasses.replace(buf, ptr=(buf.ptr + b) % cap, size=torch.clamp(buf.size + b, max=cap))


def add_batch(buf: ReplayBuffer, batch: dict[str, Tensor]) -> ReplayBuffer:
    """`add` in the dict transition layout (`obs`/`action`/`reward`/
    `next_obs`/`done`, each with a leading batch axis)."""
    return add(buf, batch["obs"], batch["action"], batch["reward"], batch["next_obs"], batch["done"])


def take(buf: ReplayBuffer, idx: Tensor) -> dict[str, Tensor]:
    """The transitions at slots `idx`, in the dict layout."""
    idx = idx.to(buf.obs.device)
    return {
        "obs": buf.obs[idx],
        "action": buf.action[idx],
        "reward": buf.reward[idx],
        "next_obs": buf.next_obs[idx],
        "done": buf.done[idx],
    }


def sample(buf: ReplayBuffer, generator: torch.Generator, batch: int) -> dict[str, Tensor]:
    """Uniform random batch of B transitions (paper: 'a random batch of B
    transitions ... sampled in order to send to FPGA').  The slots are
    ⌊u·size⌋ for u uniform in [0, 1) (float64), drawn from `generator`:
    the bound is the device-side size, never read on the host."""
    n = torch.clamp(buf.size, min=1).to(generator.device)
    u = torch.rand((batch,), generator=generator, dtype=torch.float64, device=generator.device)
    idx = torch.minimum((u * n.to(torch.float64)).to(torch.int64), n - 1)
    return take(buf, idx)


__all__ = ["ReplayBuffer", "init", "add", "add_batch", "take", "sample"]
