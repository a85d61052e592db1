"""Hand-written Hopper kernels for FIXAR's compute hot-spots.

fxp_matmul — dual-precision dense layer (kernel A, `csrc/fxp_dense.cu`)
fxp_mlp    — whole-network fused MLP forward with QAT sites fused between
             layers (kernel B, `csrc/fxp_mlp_fwd.cu`), with the training
             residuals on request, its backward (kernel 3,
             `csrc/fxp_mlp_bwd.cu`) and the fused DDPG step (kernels 4 and
             5, `csrc/fxp_ddpg_step.cu`)
quantize   — the standalone Algorithm-1 monitor + quantizer (kernel 6,
             `csrc/fxp_monitor_quant.cu`) and a training step's QAT site
             bookkeeping (kernel 7, `csrc/fxp_qat_sites.cu`: the sites'
             affine operands, the range folds and the step's tick)

Each kernel ships kernel.py (the ctypes wrapper that launches the CUDA
kernel and counts its launches), ops.py (the public function: CPU tensors
take the plain version, CUDA tensors the kernel) and ref.py (the plain
PyTorch versions).  `_build.py` compiles `csrc/*.cu` with nvcc at first use.
"""
