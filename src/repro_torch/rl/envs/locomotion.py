"""Surrogate continuous-control locomotion environments (port of
`repro.rl.envs.locomotion`): MuJoCo stand-ins with the paper's observation
and action dimensions, episode length 1000, termination on fall for Hopper,
and a forward-progress reward with control cost, over an articulated-chain
model:

  joints:   θ̈ᵢ = g·uᵢ − 2·θ̇ᵢ − 4·θᵢ           (torque gain g, damping, stiffness)
  thrust:   F   = Σᵢ cᵢ · sin(θᵢ) · θ̇ᵢ           (coordinated paddling)
  body:     v̇   = F − 0.5·v,   ḣ = spring,  pitch damped, driven by joints
  reward:   rᵗ  = v − c·‖u‖²

The dynamics are the reference's, line for line, on a leading fleet axis
(`envs/base.py`).  Scenario knobs are config: `torque_gain` scales the
actuation, `obs_noise` adds zero-mean Gaussian observation noise drawn
from the generator the caller passes to `step`.

Dims match the paper: HalfCheetah 17/6, Hopper 11/3, Swimmer 8/2; and the
pendulum swing-up (3/1, 200 steps) for fast tests.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.rl.envs.base import EnvSpec, EnvState, FunctionalEnv

Tensor = torch.Tensor

_DT = 0.05


def _draw_device(generator: torch.Generator, device: DeviceLike) -> tuple[torch.device, torch.device]:
    gdev = generator.device
    return gdev, torch.device(device) if device is not None else gdev


@dataclasses.dataclass(frozen=True)
class ChainEnv(FunctionalEnv):
    """Generic articulated chain. aux state = [v, height, pitch] subset."""

    spec: EnvSpec
    n_joints: int
    n_aux: int  # how many aux channels (v always first)
    terminate_on_fall: bool = False
    fall_height: float = -1.0
    ctrl_cost: float = 0.05
    torque_gain: float = 8.0  # actuation scale (scenario knob)
    obs_noise: float = 0.0  # observation-noise stddev (scenario knob)

    def init(self, generator: torch.Generator, n: int, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]:
        gdev, dev = _draw_device(generator, device)
        dof = self.n_joints + self.n_aux
        q = (0.1 * torch.randn((n, dof), generator=generator, device=gdev)).to(dev)
        qd = (0.1 * torch.randn((n, dof), generator=generator, device=gdev)).to(dev)
        state = EnvState(q=q, qd=qd, t=torch.zeros((n,), dtype=torch.int32, device=dev))
        return state, self._obs(state, generator)

    def _obs_clean(self, s: EnvState) -> Tensor:
        a = self.n_aux
        return torch.cat([s.q[:, :a], s.qd[:, :a], s.q[:, a:], s.qd[:, a:]], dim=-1).to(torch.float32)

    def _obs(self, s: EnvState, generator: Optional[torch.Generator]) -> Tensor:
        obs = self._obs_clean(s)
        if obs.shape[-1] != self.spec.obs_dim:
            raise ValueError(f"{self.spec.name}: obs {obs.shape[-1]} != {self.spec.obs_dim}")
        if self.obs_noise:
            if generator is None:
                raise ValueError(f"{self.spec.name} has observation noise: pass a generator")
            noise = torch.randn(obs.shape, generator=generator, device=generator.device).to(obs.device)
            obs = obs + self.obs_noise * noise
        return obs

    def step(self, s: EnvState, action: Tensor, generator: Optional[torch.Generator] = None):
        u = torch.clamp(action, -1.0, 1.0)
        a = self.n_aux
        aux, theta = s.q[:, :a], s.q[:, a:]
        auxd, thetad = s.qd[:, :a], s.qd[:, a:]

        # joint dynamics
        thetadd = self.torque_gain * u - 2.0 * thetad - 4.0 * theta
        thetad_n = thetad + _DT * thetadd
        theta_n = theta + _DT * thetad_n

        # thrust from coordinated paddling; alternating joints push opposite
        idx = torch.arange(self.n_joints, device=u.device)
        signs = torch.where(idx % 2 == 0, 1.0, -1.0).to(torch.float32)
        thrust = torch.sum(signs * torch.sin(theta) * thetad, dim=-1)

        # aux: [v, height?, pitch?] with simple damped dynamics
        v = aux[:, 0]
        v_n = v + _DT * (thrust - 0.5 * v)
        aux_n = [v_n]
        auxd_n = [thrust - 0.5 * v]
        if a >= 2:  # height: spring to 0, kicked by joint energy
            h, hd = aux[:, 1], auxd[:, 1]
            hdd = -4.0 * h - 1.0 * hd + 0.1 * torch.sum(torch.abs(thetad), dim=-1) - 0.2
            hd_n = hd + _DT * hdd
            aux_n.append(h + _DT * hd_n)
            auxd_n.append(hd_n)
        if a >= 3:  # pitch: damped, driven by joint asymmetry
            p, pd = aux[:, 2], auxd[:, 2]
            pdd = -2.0 * p - 1.0 * pd + 0.05 * torch.sum(u * signs, dim=-1)
            pd_n = pd + _DT * pdd
            aux_n.append(p + _DT * pd_n)
            auxd_n.append(pd_n)

        q_n = torch.cat([torch.stack(aux_n, dim=-1), theta_n], dim=-1)
        qd_n = torch.cat([torch.stack(auxd_n, dim=-1), thetad_n], dim=-1)
        t_n = s.t + 1
        ns = EnvState(q=q_n, qd=qd_n, t=t_n)

        reward = v_n - self.ctrl_cost * torch.sum(torch.square(u), dim=-1)
        done = t_n >= self.spec.episode_length
        if self.terminate_on_fall:
            height = aux_n[1] if a >= 2 else torch.zeros_like(v_n)
            done = done | (height < self.fall_height)
        return ns, self._obs(ns, generator), reward.to(torch.float32), done


@dataclasses.dataclass(frozen=True)
class ChainEnv17(ChainEnv):
    """ChainEnv whose observation drops the first aux position (the
    untracked root x / v slot), Gym's 'positions exclude root x'."""

    def _obs_clean(self, s: EnvState) -> Tensor:
        a = self.n_aux
        return torch.cat([s.q[:, 1:a], s.q[:, a:], s.qd[:, :a], s.qd[:, a:]], dim=-1).to(torch.float32)


def make_halfcheetah(**scenario) -> ChainEnv17:
    # aux pos (h, pitch) [v-pos dropped] + θ(6) | auxd(3) + θd(6) = 17
    return ChainEnv17(spec=EnvSpec("halfcheetah", obs_dim=17, act_dim=6), n_joints=6, n_aux=3, **scenario)


def make_hopper(**scenario) -> ChainEnv17:
    # aux pos (h, pitch) + θ(3) | auxd(3) + θd(3) = 11; falls when h low
    return ChainEnv17(
        spec=EnvSpec("hopper", obs_dim=11, act_dim=3),
        n_joints=3,
        n_aux=3,
        terminate_on_fall=True,
        fall_height=-0.7,
        **scenario,
    )


def make_swimmer(**scenario) -> ChainEnv:
    # aux(2) + auxd(2) + θ(2) + θd(2) = 8
    return ChainEnv(spec=EnvSpec("swimmer", obs_dim=8, act_dim=2), n_joints=2, n_aux=2, ctrl_cost=1e-4, **scenario)


def make_pendulum(**scenario) -> "PendulumEnv":
    return PendulumEnv(spec=EnvSpec("pendulum", obs_dim=3, act_dim=1, episode_length=200), **scenario)


@dataclasses.dataclass(frozen=True)
class PendulumEnv(FunctionalEnv):
    """Classic underactuated pendulum swing-up (exact dynamics, fast
    learning check for tests)."""

    spec: EnvSpec
    max_torque: float = 2.0
    g: float = 10.0
    dt: float = 0.05

    def init(self, generator: torch.Generator, n: int, *, device: DeviceLike = None) -> tuple[EnvState, Tensor]:
        gdev, dev = _draw_device(generator, device)
        th = (torch.rand((n, 1), generator=generator, device=gdev) * (2 * math.pi) - math.pi).to(dev)
        thd = (torch.rand((n, 1), generator=generator, device=gdev) * 2.0 - 1.0).to(dev)
        state = EnvState(q=th, qd=thd, t=torch.zeros((n,), dtype=torch.int32, device=dev))
        return state, self._obs(state)

    def _obs(self, s: EnvState) -> Tensor:
        th, thd = s.q[:, 0], s.qd[:, 0]
        return torch.stack([torch.cos(th), torch.sin(th), thd], dim=-1).to(torch.float32)

    def step(self, s: EnvState, action: Tensor, generator: Optional[torch.Generator] = None):
        th, thd = s.q[:, 0], s.qd[:, 0]
        u = torch.clamp(action[:, 0], -1.0, 1.0) * self.max_torque
        norm_th = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = norm_th**2 + 0.1 * thd**2 + 0.001 * u**2
        thd_n = thd + self.dt * (-3 * self.g / 2 * torch.sin(th + math.pi) + 3.0 * u)
        thd_n = torch.clamp(thd_n, -8.0, 8.0)
        th_n = th + self.dt * thd_n
        t_n = s.t + 1
        ns = EnvState(q=th_n[:, None], qd=thd_n[:, None], t=t_n)
        done = t_n >= self.spec.episode_length
        return ns, self._obs(ns), (-cost).to(torch.float32), done


REGISTRY = {
    "halfcheetah": make_halfcheetah,
    "hopper": make_hopper,
    "swimmer": make_swimmer,
    "pendulum": make_pendulum,
}


def make(name: str, **scenario):
    """Build a registered env; scenario knobs (`torque_gain`, `obs_noise`,
    ...) pass through to the env dataclass, and `episode_length` overrides
    the spec's horizon for any env."""
    ep = scenario.pop("episode_length", None)
    env = REGISTRY[name](**scenario)
    if ep is not None:
        env = dataclasses.replace(env, spec=dataclasses.replace(env.spec, episode_length=ep))
    return env


__all__ = [
    "ChainEnv",
    "ChainEnv17",
    "PendulumEnv",
    "make_halfcheetah",
    "make_hopper",
    "make_swimmer",
    "make_pendulum",
    "REGISTRY",
    "make",
]
