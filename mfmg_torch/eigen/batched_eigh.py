"""Batched dense symmetric eigensolver for agglomerate coarse spaces (host).

Port of mfmg_tpu/eigen/batched_eigh.py, the analog of the reference
"lapack" eigensolver (dealii/amge_host.templates.hpp:384-394, 446-467).
constrained_mode selects the reference path reproduced:
  * "pin" (the matrix path): the diagonal is shifted by its mean (changes
    eigenvalues, never eigenvectors) and constrained (Dirichlet) dofs get
    their diagonal pinned to 200, so their decoupled eigenvectors sort far
    above the physical smallest modes;
  * "identity" (the matrix-free path): no shift, constrained dofs still
    pinned to 200 (mfmg_tpu/eigen/batched_eigh.py:41-49 says why);
  * "raw" (the reference's CUDA path): no shift, and the constrained
    diagonal keeps its assembled value.
The n_ev smallest eigenpairs are kept; eigenvalues are un-shifted.

It makes the same LAPACK call as the reference package (``ssyevx`` for
float32 hierarchies, ``dsyevx`` for float64), so both packages compute the
same basis on the same host.  ``use_device=True`` is the reference's device
branch: the whole padded, shifted and pinned batch through one batched
``torch.linalg.eigh`` on ``device`` (the card unless the caller asks for the
CPU); it serves ``backend="device"`` where the device pipeline
(``eigen/device_eig.py``) does not apply.  More than 8 eigenvectors on the
host take one full batched ``np.linalg.eigh`` of that padded batch, as in
the reference.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.linalg as sla
import torch
from scipy.linalg import lapack as _lap

from mfmg_torch.amge.local_problems import AgglomerateBatch

CONSTRAINED_DIAG = 200.0  # amge_host.templates.hpp:393
# matrices per torch.linalg.eigh call: on an H100 (CUDA 12.8, torch 2.11)
# cuSOLVER's batched syev refused the 129^3 batch of 32,768 8 x 8 matrices
# with INVALID_VALUE, and ran it in chunks of 16,384 (PERF.md)
EIGH_BATCH = 16384


def eigh_batched(M: torch.Tensor):
    """torch.linalg.eigh over a batch of symmetric matrices, EIGH_BATCH at a
    time."""
    if M.shape[0] <= EIGH_BATCH:
        return torch.linalg.eigh(M)
    parts = [torch.linalg.eigh(M[i:i + EIGH_BATCH])
             for i in range(0, M.shape[0], EIGH_BATCH)]
    return torch.cat([w for w, _ in parts]), torch.cat([v for _, v in parts])


def batched_smallest_eigenpairs(batch: AgglomerateBatch, n_ev: int,
                                constrained_mode: str = "pin",
                                host_dtype=np.float64, use_device: bool = False,
                                device="cuda"):
    """Returns (eigenvalues (n_agg, n_ev), eigenvectors (n_agg, m_max, n_ev)),
    L2-normalized eigenvectors, zero on padding.  use_device: the batched
    torch.linalg.eigh on ``device`` in host_dtype's precision, in place of
    host LAPACK."""
    n_agg, m_max = batch.dof_map.shape
    if np.any(batch.sizes < n_ev):
        raise ValueError("an agglomerate has fewer dofs than requested eigenvectors")
    if constrained_mode == "pin":
        shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes
    elif constrained_mode in ("identity", "raw"):
        shifts = np.zeros(n_agg)
    else:
        raise ValueError(f"unknown constrained_mode {constrained_mode!r}")
    pin = constrained_mode in ("pin", "identity")
    if use_device or n_ev > 8:
        return _full_eigh(batch, n_ev, shifts, pin, host_dtype,
                          device if use_device else None)

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
        if pin:
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


def _full_eigh(batch: AgglomerateBatch, n_ev, shifts, pin, host_dtype,
               device):
    """The padded batch M (shifted diagonal, constrained dofs pinned where
    pin, padding ~100x above every physical entry so its unit eigenvectors
    sort last) through one full batched eigh: torch.linalg.eigh on device,
    or np.linalg.eigh on the host for device None."""
    M = batch.A_agg.copy()
    ar = np.arange(batch.m_max)
    M[:, ar, ar] += shifts[:, None] * batch.valid
    di = M[:, ar, ar]
    if pin:
        di = np.where(batch.constrained, CONSTRAINED_DIAG, di)
    pad_value = 100.0 * max(np.abs(M).max(), CONSTRAINED_DIAG)
    M[:, ar, ar] = np.where(~batch.valid, pad_value, di)
    if device is None:
        w, v = np.linalg.eigh(M.astype(host_dtype))
        w, v = w.astype(np.float64), v.astype(np.float64)
    else:
        dt = torch.float64 if np.dtype(host_dtype) == np.float64 else torch.float32
        w, v = eigh_batched(torch.as_tensor(M, dtype=dt, device=device))
        w, v = w.cpu().numpy().astype(np.float64), v.cpu().numpy().astype(np.float64)
    evals = w[:, :n_ev] - shifts[:, None]
    return evals, v[:, :, :n_ev] * batch.valid[:, :, None]
