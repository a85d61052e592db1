"""Fixed-point formats, range monitors and QAT state (port of `repro.core`).

The reference's re-exports, but for `core.parallelism` (not ported yet:
`ROADMAP.md`, mesh serving)."""

from repro_torch.core.fixedpoint import (
    FXP16,
    FXP32,
    QFormat,
    affine_dequantize,
    affine_params,
    affine_quantize,
    dequantize,
    fake_quant,
    fake_quant_affine,
    fxp_matmul_raw,
    quantize,
)
from repro_torch.core.qat import QATConfig, QATContext, QATState, quantize_grads, quantize_weights
from repro_torch.core.ranges import RangeStat, init_ranges
