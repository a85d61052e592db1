"""Fixed-point formats, range monitors, QAT state and adaptive parallelism
(port of `repro.core`, with the reference's re-exports)."""

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
from repro_torch.core.parallelism import (
    Logical,
    ShardingRules,
    constrain,
    rules_for,
    serve_rules,
    train_rules,
    tree_shardings,
)
