"""Whole-network fused MLP forward (port of `repro.kernels.fxp_mlp`).

One launch runs the whole actor forward: per layer the range monitor, the
phase-selected QAT site projection, the dual-precision dense pass and the
bias + activation epilogue, with inter-layer activations kept in shared
memory.  See `csrc/fxp_mlp_fwd.cu` for the kernel and its design notes.
"""

from repro_torch.kernels.fxp_mlp.ops import fused_cost_hint, fxp_mlp_forward, fxp_mlp_infer
from repro_torch.kernels.fxp_mlp.ref import ref_fxp_mlp, ref_mlp_forward

__all__ = ["fxp_mlp_forward", "fxp_mlp_infer", "fused_cost_hint", "ref_fxp_mlp", "ref_mlp_forward"]
