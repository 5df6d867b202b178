"""Hand-written CUDA kernels for the compact RDP forward (``csrc/*.cu``).

Each kernel sits beside its plain PyTorch version (taken for CPU tensors)
and a ``Kernel`` record whose ``launches`` count its wrapper bumps on every
launch.  ``ops`` holds the FFN-level compositions, ``ref`` the oracles.
"""
from . import ops, ref
from ._build import Kernel, build_all
from .fused_ffn import FUSED_FFN, fused_ffn_fwd, fused_ffn_plain
from .rdp_matmul import (RDP_COLS, RDP_ROWS, rdp_matmul_cols,
                         rdp_matmul_cols_plain, rdp_matmul_rows,
                         rdp_matmul_rows_plain)

KERNELS = [RDP_COLS, RDP_ROWS, FUSED_FFN]


def reset_launches() -> None:
    """Set every kernel's launch count to zero."""
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "ops", "ref", "Kernel", "build_all", "KERNELS", "reset_launches",
    "RDP_COLS", "RDP_ROWS", "FUSED_FFN",
    "rdp_matmul_cols", "rdp_matmul_rows", "fused_ffn_fwd",
    "rdp_matmul_cols_plain", "rdp_matmul_rows_plain", "fused_ffn_plain",
]
