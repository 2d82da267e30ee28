"""Uniform apply and diagonal for the operator representations on the path.

Port of mfmg_tpu/solve/operator.py (reference include/mfmg/common/
operator.hpp:25-52).  The operators are ``nn.Module``s whose ``forward`` is
the apply: the fine-grid ``StencilOperator`` (float32 or bfloat16 planes),
the coarse ``BlockStencilOperator`` and the assembled ``ELLMatrix``.
"""

from __future__ import annotations

import torch


def apply_op(op, x: torch.Tensor) -> torch.Tensor:
    return op(x)


def operator_diagonal(op) -> torch.Tensor:
    """Diagonal of an operator (Jacobi/Chebyshev smoother setup), in the
    operator's storage dtype."""
    from mfmg_torch.ops.block_stencil import BlockStencilOperator
    from mfmg_torch.ops.sparse import ELLMatrix
    from mfmg_torch.ops.stencil import StencilOperator

    if isinstance(op, ELLMatrix):
        rows = torch.arange(op.shape[0], device=op.cols.device)[:, None]
        return torch.where(op.cols == rows, op.vals,
                           torch.zeros_like(op.vals)).sum(dim=1)
    if isinstance(op, StencilOperator):
        return op.center_plane().reshape(-1)
    if isinstance(op, BlockStencilOperator):
        zero = op.offsets.index((0,) * len(op.agg_shape))
        return torch.diagonal(op.coeffs[zero], dim1=-2, dim2=-1).reshape(-1)
    raise TypeError(f"operator type {type(op).__name__} is not ported yet "
                    f"(ROADMAP Queue 1, Slice E)")
