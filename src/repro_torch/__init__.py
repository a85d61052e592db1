"""repro_torch — the PyTorch/CUDA port of `repro`, for an NVIDIA H100.

The JAX package `repro` is the reference; this package mirrors its module
names (`core/`, `kernels/<name>/{kernel,ops,ref}.py`, `rl/`, `obs/`,
`runtime/engine/`, `serve/policy/`) so each port file has one obvious
counterpart.  It imports torch and numpy only — never jax, and nothing of
`repro`.

Slice 1 is frozen-QAT policy serving: `serve.policy.PolicyEngine` answers
act requests through two hand-written Hopper kernels, the fused MLP
forward (`kernels/fxp_mlp`, `csrc/fxp_mlp_fwd.cu`) and the dual-precision
dense layer (`kernels/fxp_matmul`, `csrc/fxp_dense.cu`).

Slice 2 is DDPG training: `rl.loop.train_host` acts, steps the env fleet
(`rl/envs`), stores and samples replay (`rl/replay`) and runs
`rl.ddpg.update` with QAT (`core.qat.QATContext`) and fixed-point Adam
(`optim`); with backend "pallas" every forward is the fused kernel (saving
its residuals under autograd) and every backward the fused backward
(`csrc/fxp_mlp_bwd.cu`).  `PolicyEngine.from_ddpg` serves the trained
actor.

Device rule: entry points run on `cuda` unless the caller passes
`device="cpu"`; with no CUDA device and no explicit device they raise
(`repro_torch.device.resolve_device`).  Kernel wrappers follow the device
of the tensors they are given: CPU tensors take the plain PyTorch version,
CUDA tensors launch the kernel or raise.
"""
