"""Batched dense symmetric eigensolver for agglomerate coarse spaces (host).

Port of the host LAPACK ``syevx`` path of mfmg_tpu/eigen/batched_eigh.py in
"pin" mode, the analog of the reference "lapack" eigensolver
(dealii/amge_host.templates.hpp:384-394, 446-467):
  * the diagonal is shifted by the mean diagonal (changes eigenvalues,
    never eigenvectors),
  * constrained (Dirichlet) dofs get their diagonal pinned to 200 so their
    decoupled eigenvectors sort far above the physical smallest modes,
  * the n_ev smallest eigenpairs are kept; eigenvalues are un-shifted.

It makes the same LAPACK call as the reference package (``ssyevx`` for
float32 hierarchies, ``dsyevx`` for float64), so both packages compute the
same basis on the same host.  The "identity"/"raw" modes and the device
eigensolve are not ported yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.linalg as sla
from scipy.linalg import lapack as _lap

from mfmg_torch.amge.local_problems import AgglomerateBatch

CONSTRAINED_DIAG = 200.0  # amge_host.templates.hpp:393


def batched_smallest_eigenpairs(batch: AgglomerateBatch, n_ev: int,
                                constrained_mode: str = "pin",
                                host_dtype=np.float64):
    """Returns (eigenvalues (n_agg, n_ev), eigenvectors (n_agg, m_max, n_ev)),
    L2-normalized eigenvectors, zero on padding."""
    if constrained_mode != "pin":
        raise NotImplementedError(f"constrained_mode {constrained_mode!r} is "
                                  f"not ported yet (ROADMAP Queue 1, Slice E)")
    if n_ev > 8:
        raise NotImplementedError("more than 8 eigenvectors per agglomerate "
                                  "(the full batched eigh) is not ported yet "
                                  "(ROADMAP Queue 1, Slice E)")
    n_agg, m_max = batch.dof_map.shape
    if np.any(batch.sizes < n_ev):
        raise ValueError("an agglomerate has fewer dofs than requested eigenvectors")
    shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes

    # LAPACK's subset driver on the unpadded submatrices; only the n_ev
    # smallest pairs are computed
    syevx = _lap.ssyevx if np.dtype(host_dtype) == np.float32 else _lap.dsyevx
    syevx_lwork = (_lap.ssyevx_lwork if np.dtype(host_dtype) == np.float32
                   else _lap.dsyevx_lwork)
    lwork_cache: dict = {}

    def _lwork(sz):
        lw = lwork_cache.get(sz)
        if lw is None:
            wk, info = syevx_lwork(sz, lower=1)
            lw = int(wk) if info == 0 else 8 * sz
            lwork_cache[sz] = lw
        return lw

    Mh = batch.A_agg
    evals = np.zeros((n_agg, n_ev))
    evecs = np.zeros((n_agg, m_max, n_ev))

    def _pinned(i, sz):
        Mi = np.array(Mh[i, :sz, :sz], dtype=host_dtype)
        dv = np.einsum("ii->i", Mi)
        dv += host_dtype(shifts[i])
        dv[batch.constrained[i, :sz]] = CONSTRAINED_DIAG
        return Mi

    def _solve_range(lo, hi):
        # LAPACK releases the GIL, so threads scale on the host cores
        for i in range(lo, hi):
            sz = int(batch.sizes[i])
            w, v, m_found, ifail, info = syevx(
                _pinned(i, sz), range="I", il=1, iu=n_ev, lower=1,
                overwrite_a=1, lwork=_lwork(sz))
            if info != 0 or m_found < n_ev:
                w, v = sla.eigh(_pinned(i, sz), subset_by_index=[0, n_ev - 1],
                                driver="evr", check_finite=False)
            evals[i] = w[:n_ev].astype(np.float64) - shifts[i]
            evecs[i, :sz] = v[:, :n_ev].astype(np.float64)

    n_workers = min(os.cpu_count() or 1, 8)
    if n_workers > 1 and n_agg >= 4 * n_workers:
        from concurrent.futures import ThreadPoolExecutor

        from mfmg_torch.utils.threads import blas_single_thread
        bounds = np.linspace(0, n_agg, n_workers + 1).astype(int)
        with blas_single_thread():
            with ThreadPoolExecutor(n_workers) as pool:
                futs = [pool.submit(_solve_range, bounds[k], bounds[k + 1])
                        for k in range(n_workers)]
                for f in futs:
                    f.result()
    else:
        _solve_range(0, n_agg)
    return evals, evecs * batch.valid[:, :, None]
