"""Sum-factorized Q_k matrix-free operator apply.

Port of mfmg_tpu/ops/sumfac.py, the high-order form of the reference's
matrix-free operator (tests/laplace_matrix_free.hpp:129-156;
hierarchy_driver.cc dispatches fe_degree 1..10).  Where the quadrature mode
of ops/local_apply.py contracts through a per-cell (n_q, dim, n_loc)
gradient table, this factors the tensor-product structure of Q_k:

  reference gradient   t_a = (D_1d on axis a, V_1d elsewhere) u
  metric contraction   s_a = K[c,q,a,b] t_b
  integration          y  += (D_1d^T on axis a, V_1d^T elsewhere) s_a

with the per-cell data shrunk to the (n_q, dim, dim) metric K
(fem/geometry.py compute_metric).  In ``sumfac_apply``, the plain version,
every contraction is one batched matmul over all cells.  The local dof and
quadrature orderings are the reference element's x-fastest flatten, so
index i reshapes to the tensor axes (..., i_z, i_y, i_x) in C order.  The
cell results are summed per dof by gather in a fixed order
(ops/local_apply.py ``gather_sum``), the same bits on every run.

On the card, a 3-D operator of Q1-Q3 (``KERNEL_SHAPES``) applies through
the hand-written kernel ``csrc/sumfac_apply.cu`` (``sumfac_apply_cuda``):
one wrapper call, a cell pass and a node pass, counted in
``cuda_library.LAUNCHES["sumfac"]``; its node pass reads the incidence
as int32 offsets and positions (``incidence_csr``).  Every other shape,
and every CPU tensor, takes ``sumfac_apply``.  Each apply runs in a
"sumfac.apply" span (utils/trace.py).
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch
from torch import nn

from mfmg_torch.ops import cuda_library as cl
from mfmg_torch.ops.local_apply import gather_sum, incidence
from mfmg_torch.utils.trace import span

# (n1, nq1) of the 3-D operators csrc/sumfac_apply.cu is built for: Q1-Q3
# at k + 1 Gauss points a side
KERNEL_SHAPES = ((2, 2), (3, 3), (4, 4))


def incidence_csr(inc: torch.Tensor, n_entries: int):
    """The padded incidence (ops/local_apply.py ``incidence``, padding
    ``n_entries``) as int32 (offsets (n + 1,), positions): row t's
    positions are positions[offsets[t]:offsets[t + 1]], in the same order."""
    if n_entries >= 2**31:
        raise ValueError(f"{n_entries} cell entries do not fit int32 positions")
    real = inc < n_entries
    offsets = torch.zeros(inc.shape[0] + 1, dtype=torch.int64)
    torch.cumsum(real.sum(dim=1), 0, out=offsets[1:])
    return offsets.to(torch.int32), inc[real].to(torch.int32)


class SumFactoredOperator(nn.Module):
    """cells (n_cells, n_loc) int64, x-fastest local order; constrained
    (n_dofs,) bool Dirichlet mask; diag (n_dofs,) the raw diagonal (the
    identity-row scale at constrained dofs); op_diag (n_dofs,) the operator
    diagonal, precomputed on the host; K (n_cells, n_q, dim, dim) the metric
    (JxW * coeff * Jinv Jinv^T); V, D (n_q_1d, k+1) the 1-D shape value and
    derivative tables.  inc is the padded incidence of ``gather_sum``;
    inc_ptr, inc_pos the same as int32 offsets and positions, which the
    kernel's node pass reads; kernel_shape whether the card applies it by
    the kernel."""

    def __init__(self, cells, constrained, diag, op_diag, K, V, D):
        super().__init__()
        cells = torch.as_tensor(cells).to(torch.int64)
        for name, t in (("cells", cells), ("constrained", constrained),
                        ("diag", diag), ("op_diag", op_diag), ("K", K),
                        ("V", V), ("D", D)):
            self.register_buffer(name, t)
        inc = incidence(cells.cpu().numpy(), diag.shape[0])
        ptr, pos = incidence_csr(inc, cells.numel())
        for name, t in (("inc", inc), ("inc_ptr", ptr), ("inc_pos", pos)):
            self.register_buffer(name, t.to(cells.device))
        # 3-D with (n1, nq1) in KERNEL_SHAPES: the card applies it by the kernel
        self.kernel_shape = (K.shape[-1] == 3
                             and (V.shape[1], V.shape[0]) in KERNEL_SHAPES)

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def forward(self, u):
        """y = A u: on a CUDA tensor, where ``kernel_shape`` holds (3-D,
        Q1-Q3), ``sumfac_apply_cuda``; on the CPU, and on the card for a
        2-D operator or degree 4 and up, the batched matmuls of
        ``sumfac_apply``."""
        with span("sumfac.apply"):
            if u.get_device() >= 0 and self.kernel_shape:
                return sumfac_apply_cuda(self, u)
            return sumfac_apply(self, u)


def _contract_axis(w: torch.Tensor, M: torch.Tensor, spatial_axis: int,
                   dim: int) -> torch.Tensor:
    """Contract the 1-D operator M (out, in) along spatial axis d of w, of
    shape (n_cells, a_{dim-1}, ..., a_0): axis d sits at tensor position
    dim - d (x last)."""
    ax = dim - spatial_axis
    return torch.movedim(torch.movedim(w, ax, -1) @ M.T, -1, ax)


def sumfac_apply(op: SumFactoredOperator, u: torch.Tensor) -> torch.Tensor:
    dim = op.K.shape[-1]
    n_cells = op.cells.shape[0]
    n1, nq1 = op.V.shape[1], op.V.shape[0]
    n_q = op.K.shape[1]

    uz = torch.where(op.constrained, torch.zeros_like(u), u)
    w0 = uz[op.cells].reshape((n_cells,) + (n1,) * dim)
    # forward: reference-space gradients at the quadrature points
    t = []
    for a in range(dim):
        w = w0
        for d in range(dim):
            w = _contract_axis(w, op.D if d == a else op.V, d, dim)
        t.append(w.reshape(n_cells, n_q))
    t = torch.stack(t, dim=-1)                          # (c, q, dim)
    s = torch.einsum("cqab,cqb->cqa", op.K, t)          # metric contraction
    # backward: integrate with the transposed 1-D operators
    y_loc = torch.zeros((n_cells,) + (n1,) * dim, dtype=u.dtype,
                        device=u.device)
    for a in range(dim):
        w = s[..., a].reshape((n_cells,) + (nq1,) * dim)
        for d in range(dim):
            w = _contract_axis(w, (op.D if d == a else op.V).T, d, dim)
        y_loc = y_loc + w
    y = gather_sum(y_loc.reshape(-1), op.inc)
    return torch.where(op.constrained, op.diag * u, y)


# the buffers the kernel reads, in the order of its C interface, with their
# types ("T": u's type)
_KERNEL_BUFFERS = (("constrained", torch.bool), ("diag", "T"), ("K", "T"),
                   ("cells", torch.int64), ("V", "T"), ("D", "T"),
                   ("inc_ptr", torch.int32), ("inc_pos", torch.int32))
# the C entry point (csrc/sumfac_apply.cu): float64 flag, n1, nq1, u, the
# buffers above, y_loc, y, n_dofs, n_cells
_SUMFAC_APPLY = cl.Entry("mfmg_sumfac_apply", *(ctypes.c_int,) * 3,
                         *(ctypes.c_void_p,) * 11, ctypes.c_int, ctypes.c_int)
# per operator, its buffers as last checked for the kernel: (device, type,
# weak references to the buffers, the kernel's fixed arguments)
_CHECKED = weakref.WeakKeyDictionary()


def _check_buffers(op: SumFactoredOperator, dev: int, dt: torch.dtype):
    bufs = op._buffers
    for name, want in _KERNEL_BUFFERS:
        want = dt if want == "T" else want
        t = bufs[name]
        if t.dtype is not want or t.get_device() != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on the "
                             f"device of u (cuda:{dev}), got {t.dtype} on "
                             f"{t.device}{'' if t.is_contiguous() else ', strided'}")
    V = bufs["V"]
    ptrs = tuple(bufs[k].data_ptr() for k, _ in _KERNEL_BUFFERS)
    refs = tuple((k, weakref.ref(bufs[k])) for k, _ in _KERNEL_BUFFERS)
    return dev, dt, refs, (int(dt is torch.float64), V.shape[1], V.shape[0]), ptrs


def sumfac_apply_cuda(op: SumFactoredOperator, u: torch.Tensor) -> torch.Tensor:
    """y = A u by csrc/sumfac_apply.cu: one call, a cell pass and a node
    pass over the stored buffers.  Takes float32 or float64 u, diag, K, V
    and D of one type, int64 cells, bool flags and int32 incidence, all
    contiguous on u's device, and a 1-D u of n_dofs entries; raises
    ValueError on anything else.

    The solve applies the operator ~100 times, so the host's work per call
    is kept short: the operator's buffers are checked once and their
    pointers kept while they stay the same tensors (``_CHECKED``)."""
    dev = u.get_device()
    dt = u.dtype
    n = op.diag.shape[0]
    if dt is not torch.float32 and dt is not torch.float64:
        raise ValueError(f"the sumfac kernel takes float32 or float64, got {dt}")
    if u.dim() != 1 or u.shape[0] != n:
        raise ValueError(f"u must be 1-D of {n} entries, got {tuple(u.shape)}")
    c = _CHECKED.get(op)
    bufs = op._buffers
    if (c is None or c[0] != dev or c[1] is not dt
            or any(r() is not bufs[k] for k, r in c[2])):
        c = _CHECKED[op] = _check_buffers(op, dev, dt)
    n_cells, n_loc = bufs["cells"].shape
    u = u.contiguous()
    y = torch.empty(n, dtype=dt, device=u.device)
    y_loc = torch.empty(n_cells * n_loc, dtype=dt, device=u.device)
    cl.launch(_SUMFAC_APPLY, "sumfac", dev, *c[3], u.data_ptr(), *c[4],
              y_loc.data_ptr(), y.data_ptr(), n, n_cells)
    return y


def build_sumfac_operator(mesh, coeff_at_q: np.ndarray, diag_raw: np.ndarray,
                          A_loc: np.ndarray, dtype=torch.float32,
                          device="cpu") -> SumFactoredOperator:
    """The operator from host setup data (mfmg_tpu/ops/sumfac.py:117-142).
    A_loc serves only the operator diagonal (one host sum at setup); the
    device never holds the O(n_loc^2) cell matrices."""
    from mfmg_torch.fem.geometry import compute_metric
    from mfmg_torch.fem.reference import reference_element

    ref = reference_element(mesh.dim, mesh.degree)
    K = compute_metric(mesh, coeff_at_q)
    d_loc = np.einsum("cii->ci", A_loc)
    op_diag = np.zeros(mesh.n_nodes)
    np.add.at(op_diag, mesh.cells.reshape(-1), d_loc.reshape(-1))
    op_diag = np.where(mesh.boundary_dofs, diag_raw, op_diag)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return SumFactoredOperator(
        cells=torch.as_tensor(mesh.cells, device=device),
        constrained=torch.as_tensor(mesh.boundary_dofs, device=device),
        diag=dev(diag_raw), op_diag=dev(op_diag), K=dev(K), V=dev(ref.v1d),
        D=dev(ref.g1d))
