"""Hand-written CUDA kernels for the compact RDP and TDP forward and
backward (``csrc/*.cu``).

Each kernel sits beside its plain PyTorch version (taken for CPU tensors)
and a ``Kernel`` record whose ``launches`` count its wrapper bumps on every
launch.  ``autodiff`` and ``fused_ffn.FusedFFN`` are the autograd rules
that pair the forward kernels with the backward ones, ``ops`` holds the
FFN-level compositions, ``ref`` the oracles.
"""
from . import autodiff, ops, ref
from ._build import Kernel, build_all
from .fused_ffn import FUSED_FFN, fused_ffn_fwd, fused_ffn_plain
from .rdp_matmul import (RDP_COLS, RDP_ROWS, rdp_matmul_cols,
                         rdp_matmul_cols_plain, rdp_matmul_rows,
                         rdp_matmul_rows_plain)
from .rdp_matmul_bwd import (COLS_DGRAD, COLS_WGRAD, ROWS_DGRAD, ROWS_WGRAD,
                             rdp_cols_dgrad, rdp_cols_dgrad_plain,
                             rdp_cols_wgrad, rdp_cols_wgrad_plain,
                             rdp_rows_dgrad, rdp_rows_dgrad_plain,
                             rdp_rows_wgrad, rdp_rows_wgrad_plain)
from .tdp_matmul import TDP_MATMUL, tdp_matmul, tdp_matmul_plain
from .tdp_matmul_bwd import (TDP_DGRAD, TDP_WGRAD, tdp_dgrad, tdp_dgrad_plain,
                             tdp_wgrad, tdp_wgrad_plain)

KERNELS = [RDP_COLS, RDP_ROWS, FUSED_FFN, COLS_DGRAD, COLS_WGRAD, ROWS_DGRAD,
           ROWS_WGRAD, TDP_MATMUL, TDP_DGRAD, TDP_WGRAD]


def reset_launches() -> None:
    """Set every kernel's launch count to zero."""
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "autodiff", "ops", "ref", "Kernel", "build_all", "KERNELS",
    "reset_launches",
    "RDP_COLS", "RDP_ROWS", "FUSED_FFN",
    "COLS_DGRAD", "COLS_WGRAD", "ROWS_DGRAD", "ROWS_WGRAD",
    "rdp_matmul_cols", "rdp_matmul_rows", "fused_ffn_fwd",
    "rdp_matmul_cols_plain", "rdp_matmul_rows_plain", "fused_ffn_plain",
    "rdp_cols_dgrad", "rdp_cols_wgrad", "rdp_rows_dgrad", "rdp_rows_wgrad",
    "rdp_cols_dgrad_plain", "rdp_cols_wgrad_plain", "rdp_rows_dgrad_plain",
    "rdp_rows_wgrad_plain",
    "TDP_MATMUL", "TDP_DGRAD", "TDP_WGRAD", "tdp_matmul", "tdp_dgrad",
    "tdp_wgrad", "tdp_matmul_plain", "tdp_dgrad_plain", "tdp_wgrad_plain",
]
