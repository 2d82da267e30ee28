"""The level-0 agglomerate eigensolve on the card, as dense batched algebra.

Port of mfmg_tpu/eigen/device_eig.py.  The level-0 setup's largest costs
on the host are the dense agglomerate batch (32,768 blocks of 125 x 125 at
129^3), its batched LAPACK eigensolve and the Galerkin blocks read from it.
Here the whole pipeline runs on the device and the dense batch never exists
on the host:

  1. assembly as one matrix product: on translation-invariant structured
     meshes each cell matrix is A_loc[c] = sum_q s[c, q] B_q, so the batch
     is A[a] = einsum('apq,pqij->aij', s_blocked, KPQ), KPQ being the
     (block cell, quadrature point) scatter of B_q, built once on the host;
     only the (n_agg, n_bc, n_q) coefficient table and KPQ upload;
  2. the smallest eigenpairs by Cholesky inverse subspace iteration: the
     pinned batch plus eps I is SPD, L = cholesky(A + eps I), and
     X <- L^-T L^-1 X with column normalisation and a Gram Cholesky
     re-orthonormalisation, ``_N_ITER`` steps over ``_N_PROBE`` columns;
  3. Rayleigh-Ritz in the probe subspace (a batched 8 x 8 eigh) keeps the
     n_ev smallest pairs; only they come back to the host.

``device_galerkin_blocks`` then forms the Galerkin blocks K = Rb A Rb^T
against the batch that stayed on the device.  Every product runs in full
float32 (the package turns TF32 off at import), the reference's
``Precision.HIGHEST``.  Semantics follow the host "pin" path
(amge_host.templates.hpp:384-394): constrained diagonals pinned to 200,
the eigenvalues of the unshifted pinned matrix (the host path's shift moves
eigenvalues only).

There is no fallback: a failed factorization or a non-finite result raises,
naming the agglomerate.  ``supports`` routes by structure (a CUDA device, a
translation-invariant structured mesh, the closed-form block partition);
the hierarchy also routes by operator and type (the Laplace form, float32);
where either is False it takes the host path.
"""

from __future__ import annotations

import numpy as np
import torch

from mfmg_torch.amge.local_problems import block_layout
from mfmg_torch.eigen.batched_eigh import CONSTRAINED_DIAG, eigh_batched

_N_PROBE = 8       # oversampled subspace columns
_N_ITER = 8        # inverse-iteration steps (each amplifies by ~lam_k/eps)
# eps = EPS_REL x the agglomerate's mean diagonal sets the per-step
# amplification (lam2 + eps) / eps: small enough for ~1e5 over the 8 steps,
# large enough that the probe columns do not all collapse onto v1 in one
# step (the reference saw its float32 Gram Cholesky go singular at 1e-5)
EPS_REL = 1e-2
GRAM_JITTER = 1e-5  # on the unit-diagonal Gram, well above float32 roundoff


def supports(mesh, agg_ids=None, device="cuda", geom=None) -> bool:
    """Whether the device pipeline applies: a CUDA device, a structured mesh
    with lexicographic dofs and no hanging nodes, translation-invariant
    cells (``geom.G_shared``, when geom is given), and, when agg_ids is
    given, the agglomeration IS the closed-form block partition (a
    uniform-size partition of another shape must not slip through on
    agglomerate 0's extent).  The block partition has no padding, so no
    batch is needed to ask.  On the CPU the host path stays, as the
    reference keeps it off its accelerator."""
    if torch.device(device).type != "cuda":
        return False
    if (not mesh.is_structured or getattr(mesh, "dof_renumbered", False)
            or getattr(mesh, "hanging", None) is not None):
        return False
    if geom is not None and geom.G_shared is None:
        return False
    if agg_ids is not None:
        nc = np.asarray(mesh.structured_shape)
        mi = mesh.cell_multi_index()
        sel = agg_ids == agg_ids[0]
        bdims = mi[sel].max(axis=0) - mi[sel].min(axis=0) + 1
        if np.any(nc % bdims):
            return False
        n_agg_dim = nc // bdims
        stride = np.cumprod(np.concatenate([[1], n_agg_dim[:-1]]))
        if not np.array_equal((mi // bdims) @ stride, agg_ids):
            return False
    return True


def probe_block(n_agg: int, m: int, n_probe: int, device) -> torch.Tensor:
    """The start block X0 of the inverse iteration: (n_agg, m, n_probe)
    standard normal float32, drawn on the device from a generator seeded 0."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return torch.randn((n_agg, m, n_probe), generator=gen, dtype=torch.float32,
                       device=device)


def kpq_scatter(G_shared: np.ndarray, local_cells: np.ndarray,
                m: int) -> np.ndarray:
    """KPQ (n_bc, n_q, m, m) float32: B_q = G_q^T G_q of the shared cell
    scattered to block cell p's local dofs."""
    B = np.einsum("qdi,qdj->qij", G_shared, G_shared).astype(np.float32)
    KPQ = np.zeros((len(local_cells), B.shape[0], m, m), dtype=np.float32)
    for p, li in enumerate(local_cells):
        KPQ[p][:, li[:, None], li[None, :]] += B
    return KPQ


def _raise_at(bad: torch.Tensor, what: str):
    idx = torch.nonzero(bad).flatten()
    if idx.numel():
        raise FloatingPointError(
            f"device eigensolve: {what} at {idx.numel()} agglomerate(s), the "
            f"first {int(idx[0])}")


@torch.no_grad()
def device_smallest_eigenpairs(problem, agg_ids, batch, n_ev: int,
                               keep_A: bool = False, device="cuda", mark=None):
    """The pipeline for the 'pin' constrained mode on ``device``.  Returns
    (evals (n_agg, n_ev) float64, evecs (n_agg, m, n_ev) float64) like the
    host path (L2-normalized, zero at constrained dofs), and with keep_A
    also the pinned float32 batch A (n_agg, m, m) on the device, for
    ``device_galerkin_blocks``.  batch may be light (no A_agg).  mark(stage),
    when given, is called at the end of each stage ("upload", "assembly",
    "Cholesky", "inverse iteration", "Rayleigh-Ritz"), the device's work
    done: the setup's stage times."""
    device = torch.device(device)

    def done(stage):
        if mark is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            mark(stage)

    if not getattr(problem, "laplace_form", False):
        raise ValueError("the device eigensolve assembles the Laplace form "
                         "from geom and coeff_at_q; a problem with its own "
                         "cell matrices (local_matrix_fn) takes the host path")
    geom = problem.geom
    if geom.G_shared is None:
        raise ValueError("the device eigensolve needs translation-invariant "
                         "cells (geom.G_shared); supports() routes such "
                         "meshes to the host")
    # the block partition's index structure, shared with the batch builder
    cells_per_agg, local_cells, _, m = block_layout(problem.mesh, agg_ids)
    n_agg = cells_per_agg.shape[0]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    KPQ = dev(kpq_scatter(geom.G_shared, local_cells, m))
    s = (geom.JxW * problem.coeff_at_q).astype(np.float32)       # (cells, q)
    s_blocked = dev(s[cells_per_agg]).reshape(n_agg, -1)
    keep = dev((~batch.constrained).astype(np.float32))          # (n_agg, m)
    # mean-diagonal shift per agglomerate (the host path's), float32
    shifts = dev(((batch.diag * batch.valid).sum(axis=1)
                  / batch.sizes).astype(np.float32))
    done("upload")

    X = probe_block(n_agg, m, _N_PROBE, device) * keep[:, :, None]
    A = (s_blocked @ KPQ.reshape(-1, m * m)).reshape(n_agg, m, m)
    del KPQ, s_blocked
    A = A + A.mT
    A *= 0.5
    # Dirichlet elimination and pin: constrained rows and columns zeroed,
    # their diagonal set to CONSTRAINED_DIAG.  The matrix stays unshifted:
    # the shift would move the inverse iteration's ratio (lam1 + shift) /
    # (lamk + shift) near 1; against the raw spectrum it is ~(lam1 + eps) /
    # lamk per step.
    pin = torch.where(keep > 0, A.diagonal(dim1=1, dim2=2), CONSTRAINED_DIAG)
    A *= keep[:, :, None]
    A *= keep[:, None, :]
    A.diagonal(dim1=1, dim2=2).copy_(pin)
    del pin
    done("assembly")
    # eps regularizes the exactly singular interior (pure-Neumann) blocks
    A_solve = A.clone()
    A_solve.diagonal(dim1=1, dim2=2).add_((EPS_REL * shifts)[:, None])
    L, info = torch.linalg.cholesky_ex(A_solve)
    del A_solve
    _raise_at(info != 0, "the Cholesky factorization of A + eps I failed")
    done("Cholesky")

    eye = torch.eye(_N_PROBE, dtype=torch.float32, device=device)
    gram_bad = torch.zeros(n_agg, dtype=torch.bool, device=device)
    for _ in range(_N_ITER):
        Y = torch.linalg.solve_triangular(L, X, upper=False)
        Y = torch.linalg.solve_triangular(L.mT, Y, upper=True)
        Y = Y * keep[:, :, None]
        cn = torch.linalg.vector_norm(Y, dim=1, keepdim=True)
        Y = Y / torch.where(cn == 0, 1.0, cn)
        C, ginfo = torch.linalg.cholesky_ex(Y.mT @ Y + GRAM_JITTER * eye)
        gram_bad |= ginfo != 0
        X = torch.linalg.solve_triangular(C.mT, Y, upper=True, left=False)
    del L, Y, C
    _raise_at(gram_bad, "the Gram Cholesky of the probe block failed")
    done("inverse iteration")

    T = X.mT @ (A @ X)
    T = 0.5 * (T + T.mT)
    w, V = eigh_batched(T)
    evecs = X @ V[:, :, :n_ev]
    nrm = torch.linalg.vector_norm(evecs, dim=1, keepdim=True)
    evecs = evecs / torch.where(nrm == 0, 1.0, nrm)
    evals = w[:, :n_ev]
    _raise_at(~(torch.isfinite(evals).all(dim=1)
                & torch.isfinite(evecs).all(dim=2).all(dim=1)),
              "a non-finite eigenpair")
    evals = evals.cpu().numpy().astype(np.float64)
    evecs = evecs.cpu().numpy().astype(np.float64)
    evecs *= (batch.valid & ~batch.constrained)[:, :, None]
    done("Rayleigh-Ritz")
    if keep_A:
        return evals, evecs, A
    return evals, evecs


@torch.no_grad()
def device_galerkin_blocks(batch_light, A_dev, dof_rows, dof_vals, n_rows):
    """AggBlocks with K = Rb A Rb^T formed on A_dev's device against the
    batch the eigensolve kept there.  The host library builds the row
    structure and the dense Rb (float64, kept for the level-1 Gram); Rb
    uploads in float32 and K comes back in float32.  n_rows (R's rows) is
    the host path's argument; the row blocks do not need it.  A_dev holds
    the pinned diagonal (200) at constrained dofs instead of the assembled
    one; K does not see it, since R is zero there (the eigenvectors are)."""
    from mfmg_torch import native
    from mfmg_torch.amge.multilevel import AggBlocks

    dm = np.where(batch_light.valid, batch_light.dof_map, 0)
    arows, t_s, Rb = native.agg_row_blocks(dm, batch_light.valid,
                                           batch_light.valid, dof_rows,
                                           dof_vals)
    Rb_d = torch.from_numpy(Rb.astype(np.float32)).to(A_dev.device)
    K = (Rb_d @ A_dev) @ Rb_d.mT
    return AggBlocks(arows, t_s, Rb, K.cpu().numpy())
