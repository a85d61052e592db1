from repro_torch.kernels.quantize.ops import monitor_quant, qat_fold, qat_site_params
from repro_torch.kernels.quantize.ref import ref_monitor_quant, ref_qat_fold, ref_qat_site_params

__all__ = ["monitor_quant", "ref_monitor_quant", "qat_site_params", "qat_fold", "ref_qat_site_params", "ref_qat_fold"]
