from repro_torch.kernels.quantize.ops import monitor_quant
from repro_torch.kernels.quantize.ref import ref_monitor_quant

__all__ = ["monitor_quant", "ref_monitor_quant"]
