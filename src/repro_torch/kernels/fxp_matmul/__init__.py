from repro_torch.kernels.fxp_matmul.ops import chain_cost_hint, fxp_dense, fxp_dense_chain
from repro_torch.kernels.fxp_matmul.ref import limb_split, ref_flops, ref_fxp_dense

__all__ = ["fxp_dense", "fxp_dense_chain", "chain_cost_hint", "limb_split", "ref_fxp_dense", "ref_flops"]
