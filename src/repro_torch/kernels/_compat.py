"""Tiny helpers shared by the kernel modules (port of `repro.kernels._compat`)."""


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m."""
    return (x + m - 1) // m * m


def mlp_flops(dims) -> int:
    """MAC-pair FLOPs for ONE item through an MLP with layer dims `dims` —
    the single source for the kernels' dispatcher cost hints."""
    return 2 * sum(k * n for k, n in zip(dims[:-1], dims[1:]))


__all__ = ["round_up", "mlp_flops"]
