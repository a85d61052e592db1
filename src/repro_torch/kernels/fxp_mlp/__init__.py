"""Whole-network fused MLP forward and backward (port of
`repro.kernels.fxp_mlp`).

One launch runs the whole actor or critic forward: per layer the range
monitor, the phase-selected QAT site projection, the dual-precision dense
pass and the bias + activation epilogue, with inter-layer activations kept
in shared memory (`csrc/fxp_mlp_fwd.cu`).  For training it also stores the
residuals, and the backward (`csrc/fxp_mlp_bwd.cu`) runs the whole
dx/dW/db chain with the sites' straight-through masks.
"""

from repro_torch.kernels.fxp_mlp.ops import (fused_cost_hint, fxp_mlp_forward, fxp_mlp_infer, fxp_mlp_train,
                                             fxp_mlp_train_step)
from repro_torch.kernels.fxp_mlp.ref import ref_fxp_mlp, ref_mlp_backward, ref_mlp_forward

__all__ = [
    "fxp_mlp_forward",
    "fxp_mlp_train",
    "fxp_mlp_train_step",
    "fxp_mlp_infer",
    "fused_cost_hint",
    "ref_fxp_mlp",
    "ref_mlp_forward",
    "ref_mlp_backward",
]
