"""Shift-invert ARPACK per agglomerate: the port of mfmg_tpu/eigen/arpack.py
(the reference's "arpack" dispatch, amge_host.templates.hpp:350-483).

Each agglomerate's pinned, shifted local matrix goes through scipy's
``eigsh`` (the Fortran ARPACK the reference links through deal.II) in
shift-invert mode (sigma=0, which="LM", ncv = 2 nev + 2, the reference's
n_arnoldi at :416), on the host, one agglomerate after another.  An
agglomerate too small for the Arnoldi basis, or whose factorization fails,
takes a dense subset eigh.

The reference runs large batches (n_agg >= 4 x workers) in a pool of
threads that share one default_rng(0), so each agglomerate's start vector
depends on how they interleave; and eigsh returns to Python once per
Arnoldi step, so such threads mostly wait for the interpreter lock.  The
port draws every start vector up front, in agglomerate order (the stream
of the reference's sequential path), and runs large batches in forked
worker processes, one per core of the affinity mask, each on a contiguous
range of agglomerates: the results are those of the sequential path,
whatever the workers.  An interior agglomerate (no constrained dof, its
spectrum shifted by its mean diagonal) is the slow case of shift-invert
ARPACK here (scripts/eigensolver_timings.py times both kinds).
"""

from __future__ import annotations

import os

import numpy as np

from mfmg_torch.eigen.lobpcg import _build_batched_operator


def batched_arpack_smallest(batch, eig_cfg, constrained_mode: str = "pin"):
    """Smallest eigenpairs of every agglomerate by shift-invert ARPACK.

    Returns (evals (n_agg, n_ev), evecs (n_agg, m_max, n_ev)) as numpy
    float64, zero-padded like the other batched eigensolvers.
    """
    n_ev = eig_cfg.n_eigenvectors
    n_agg, m = batch.dof_map.shape
    Mop, shifts = _build_batched_operator(batch, constrained_mode)

    evals = np.zeros((n_agg, n_ev))
    evecs = np.zeros((n_agg, m, n_ev))
    # the reference's start vectors: uniform random, zero at constrained
    # dofs (dealii_mesh_evaluator.cc:43-55), one draw per agglomerate that
    # takes ARPACK, in agglomerate order
    rng = np.random.default_rng(0)
    v0s = {}
    for g in range(n_agg):
        sz = int(batch.sizes[g])
        if sz >= 2 * n_ev + 3:
            v0 = rng.uniform(0.0, 1.0, size=sz)
            v0[np.asarray(batch.constrained[g, :sz])] = 0.0
            v0s[g] = v0 if v0.any() else None

    tol, maxit = eig_cfg.tolerance, eig_cfg.max_iterations
    n_workers = len(os.sched_getaffinity(0))
    if n_workers > 1 and n_agg >= 4 * n_workers:
        # forked worker processes, each given a contiguous range; they
        # run numpy and scipy only (no torch, no CUDA), so the parent's
        # other threads do not reach them ("spawn" would make every
        # caller's main module importable, a demand on its scripts)
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        bounds = np.linspace(0, n_agg, n_workers + 1).astype(int)
        ranges = list(zip(bounds[:-1], bounds[1:]))
        with ProcessPoolExecutor(
                n_workers, mp_context=multiprocessing.get_context("fork")) as pool:
            parts = list(pool.map(_solve_range, *zip(*[
                (Mop[lo:hi], batch.sizes[lo:hi], [v0s.get(g) for g in range(lo, hi)],
                 shifts[lo:hi]) for lo, hi in ranges]),
                [n_ev] * n_workers, [tol] * n_workers, [maxit] * n_workers))
        for (lo, hi), (w, v) in zip(ranges, parts):
            evals[lo:hi], evecs[lo:hi] = w, v
    else:
        evals[:], evecs[:] = _solve_range(Mop, batch.sizes,
                                          [v0s.get(g) for g in range(n_agg)],
                                          shifts, n_ev, tol, maxit)
    return evals, evecs * batch.valid[:, :, None]


def _solve_range(Mop, sizes, v0s, shifts, n_ev, tol, maxit):
    """(evals (n, n_ev), evecs (n, m, n_ev)) of a range of agglomerates, in
    order, with one BLAS thread (ARPACK makes hundreds of tiny BLAS calls
    per agglomerate)."""
    from mfmg_torch.utils.threads import blas_single_thread
    n, m = Mop.shape[:2]
    evals = np.zeros((n, n_ev))
    evecs = np.zeros((n, m, n_ev))
    with blas_single_thread():
        for i in range(n):
            w, v = _solve_one(Mop[i], int(sizes[i]), v0s[i], n_ev, tol, maxit,
                              shifts[i])
            evals[i], evecs[i, :v.shape[0]] = w, v
    return evals, evecs


def _solve_one(M, sz, v0, n_ev, tol, maxit, shift):
    """(eigenvalues (n_ev,) ascending, less ``shift``, zero-padded;
    eigenvectors (sz, n_ev)) of one agglomerate's M[:sz, :sz]: shift-invert
    eigsh, or the dense subset eigh for an agglomerate too small for the
    Arnoldi basis (scipy needs n_ev < ncv <= sz) or whose sigma=0
    factorization fails (a singular local operator in the "raw" or
    "identity" modes); an agglomerate of fewer dofs than n_ev yields sz
    pairs, the rest stay zero."""
    import scipy.linalg as sla
    from scipy.sparse.linalg import eigsh
    Mg = np.asarray(M[:sz, :sz], dtype=np.float64)
    if sz >= 2 * n_ev + 3:
        ncv = min(2 * n_ev + 2, sz)              # n_arnoldi (templates.hpp:416)
        try:
            w, v = eigsh(Mg, k=n_ev, sigma=0.0, which="LM", ncv=ncv, tol=tol,
                         v0=v0, maxiter=maxit * sz)
            order = np.argsort(w)
            return w[order] - shift, v[:, order]
        except Exception:
            pass
    ne = min(n_ev, sz)
    w, v = sla.eigh(Mg, subset_by_index=[0, ne - 1], driver="evr",
                    check_finite=False)
    out_w, out_v = np.zeros(n_ev), np.zeros((sz, n_ev))
    out_w[:ne], out_v[:, :ne] = w[:ne] - shift, v[:, :ne]
    return out_w, out_v
