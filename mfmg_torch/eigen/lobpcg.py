"""Batched LOBPCG, the port of mfmg_tpu/eigen/lobpcg.py (the reference's
Anasazi adapter, dealii/anasazi.templates.hpp:36-105: "SM" smallest
magnitude, Hermitian, optional full orthogonalization, a non-relative
tolerance, the optional warm start of amge_host.templates.hpp:226-266).

All agglomerates iterate together on the device: the state is the batched
block (n_agg, m, n_ev) in float64, and each iteration's Rayleigh-Ritz is a
batched Householder QR of the (n_agg, m, 3 n_ev) trial basis
(``householder_qr``, LAPACK's conventions) and ``torch.linalg.eigh`` of
(n_agg, 3 n_ev, 3 n_ev) blocks.
Termination follows the reference:

  * block g converges when every requested Ritz pair has ||A x - theta x||
    <= tol (the adapter's non-relative tolerance, floored at 1e-10);
  * converged blocks are frozen (masked out of the update);
  * the loop exits once every block has converged, or at max_iterations;
    the host reads the active mask once per iteration (one sync).

full_ortho True (the reference driver's choice) orthonormalizes the whole
[X R P] trial basis by QR before the Rayleigh-Ritz; False solves the pencil
(S^T A S, S^T S) on the raw basis, whitened by a masked eigh of the Gram.

The reference computes in float64 where x64 is on (its CPU tests) and in
float32 on its accelerator; the port is held against the former, so it
computes in float64 on every device.  On the card, batched small eigh goes
through cuSOLVER, whose roundoff and eigenvector signs differ from CPU
LAPACK: compare eigenvalues, spans and iteration counts, not raw vectors.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from mfmg_torch.eigen.batched_eigh import CONSTRAINED_DIAG


def _build_batched_operator(batch, constrained_mode):
    """The reference's pinned, shifted and padded batch, in the batch's own
    dtype (mfmg_tpu/eigen/lobpcg.py:35-49), and the shifts."""
    M = batch.A_agg.copy()
    ar = np.arange(batch.m_max)
    if constrained_mode == "pin":
        shifts = (batch.diag * batch.valid).sum(axis=1) / batch.sizes
    else:
        shifts = np.zeros(batch.n_agg)
    M[:, ar, ar] += shifts[:, None] * batch.valid
    di = M[:, ar, ar]
    if constrained_mode in ("pin", "identity"):
        di = np.where(batch.constrained, CONSTRAINED_DIAG, di)
    pad_value = 100.0 * max(np.abs(M).max(), CONSTRAINED_DIAG)
    di = np.where(~batch.valid, pad_value, di)
    M[:, ar, ar] = di
    return M, shifts


def householder_qr(S):
    """Reduced QR of a batch S (B, m, k), m >= k, by Householder
    reflections with LAPACK's conventions (dgeqr2's dlarfg, then dorg2r):
    column j's reflector maps x to beta e_1 with beta = -sign(x_1) ||x||,
    and a column that is already zero below its diagonal gets none (tau =
    0), so Q completes the span of a rank-deficient S as LAPACK does.  A
    loop over the k columns of batched elementwise products, in place of
    ``torch.linalg.qr``, which took 191 ms per call at the 65^3 main
    configuration's (4096, 125, 6) on an H100 against this loop's 3.3 ms
    (scripts/eigensolver_timings.py)."""
    B, m, k = S.shape
    R = S.clone()
    vs, taus = [], []
    for j in range(k):
        x = R[:, j:, j]
        alpha = x[:, 0]
        xnorm = torch.linalg.norm(x[:, 1:], dim=1)
        reflect = xnorm > 0
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        safe = torch.where(reflect, beta, torch.ones_like(beta))
        tau = torch.where(reflect, (beta - alpha) / safe, torch.zeros_like(beta))
        scale = torch.where(reflect, 1.0 / (alpha - safe), torch.zeros_like(beta))
        v = torch.cat([torch.ones_like(alpha)[:, None], x[:, 1:] * scale[:, None]], 1)
        w = (v[:, :, None] * R[:, j:, j:]).sum(dim=1)
        R[:, j:, j:] -= tau[:, None, None] * v[:, :, None] * w[:, None, :]
        vs.append(v)
        taus.append(tau)
    Q = torch.zeros_like(S)
    Q[:, torch.arange(k), torch.arange(k)] = 1.0
    for j in reversed(range(k)):
        v, tau = vs[j], taus[j]
        w = (v[:, :, None] * Q[:, j:, j:]).sum(dim=1)
        Q[:, j:, j:] -= tau[:, None, None] * v[:, :, None] * w[:, None, :]
    return Q, torch.triu(R[:, :k, :])


def _unit_cols(V):
    nrm = torch.linalg.norm(V, dim=1, keepdim=True)
    return V / torch.where(nrm < 1e-300, torch.ones_like(nrm), nrm)


def _sym(T):
    return 0.5 * (T + T.mT)


def batched_lobpcg_smallest(batch, eig_cfg, constrained_mode: str = "pin",
                            initial_guess: np.ndarray | None = None,
                            max_iterations: int | None = None,
                            return_info: bool = False, device="cuda",
                            stats: dict | None = None):
    """Smallest eigenpairs of every agglomerate by one batched LOBPCG on
    ``device`` (the card unless the caller asks for the CPU).

    initial_guess: optional (n_agg, m_max, n_ev) warm start (the reference's
    use_initial_guess path); its zero columns are re-drawn.  The start
    block is the reference's numpy stream (default_rng(0)), drawn on the
    host.  Returns (evals (n_agg, n_ev), evecs (n_agg, m_max, n_ev)) as
    numpy float64; with return_info also {"iterations": loop count,
    "converged": (n_agg,) bool, "block_iterations": (n_agg,) the
    iterations each block took before it froze}.  ``stats`` (a dict)
    receives "device_s", the seconds of the iterations, and "iterations".
    """
    n_ev = eig_cfg.n_eigenvectors
    tol = max(eig_cfg.tolerance, 1e-10)
    full_ortho = bool(getattr(eig_cfg, "full_ortho", True))
    if max_iterations is None:
        max_iterations = eig_cfg.max_iterations
    n_agg, m = batch.dof_map.shape
    Mop, shifts = _build_batched_operator(batch, constrained_mode)
    A = torch.as_tensor(Mop, device=device).to(torch.float64)

    mask = batch.valid & ~batch.constrained
    rng = np.random.default_rng(0)
    if initial_guess is None:
        X0 = rng.uniform(0.0, 1.0, size=(n_agg, m, n_ev))
    else:
        X0 = np.array(initial_guess, dtype=float)
        # re-randomize zero columns (the reference fixes degenerate warm
        # starts, amge_host.templates.hpp:244-265)
        dead = np.linalg.norm(X0, axis=1) < 1e-14
        X0 = np.where(dead[:, None, :], rng.uniform(size=X0.shape), X0)
    X0 = X0 * mask[:, :, None]

    def rayleigh_ritz_qr(S):
        # full-ortho path: orthonormalize the trial basis, ordinary eigh;
        # also the Ritz coefficients in the S basis (c = RR^{-1} V from
        # S = Q RR), from which the caller forms the conjugate direction
        if S.shape[2] > S.shape[1]:
            # more trial columns than dofs: the reduced QR's RR is not
            # square; the whitened pencil handles the rank-deficient basis
            return rayleigh_ritz_raw(S)
        Q, RR = householder_qr(S)
        w, V = torch.linalg.eigh(_sym(Q.mT @ (A @ Q)))
        Vk = V[:, :, :n_ev]
        # degenerate basis columns make RR singular: regularize its
        # diagonal (the affected coefficients only feed the P update)
        d = torch.diagonal(RR, dim1=1, dim2=2).abs()
        scale = d.max(dim=1, keepdim=True).values
        eye = torch.eye(RR.shape[-1], dtype=RR.dtype, device=RR.device)
        RRr = RR + (1e-14 * scale + 1e-300)[:, :, None] * eye
        c = torch.linalg.solve_triangular(RRr, Vk, upper=True)
        return w[:, :n_ev], Q @ Vk, c

    def rayleigh_ritz_raw(S):
        # the pencil on the raw basis; its Gram is whitened by a masked
        # eigh: deficient directions get zero weight and their Ritz slots
        # are pushed to the top of the spectrum
        g, E = torch.linalg.eigh(_sym(S.mT @ S))
        gmax = torch.clamp(g[:, -1:], min=1e-300)
        ok = g > 1e-12 * gmax
        winv = torch.where(ok, 1.0 / torch.sqrt(torch.clamp(g, min=1e-300)),
                           torch.zeros_like(g))
        W = E * winv[:, None, :]
        Tr = _sym(W.mT @ (S.mT @ (A @ S)) @ W)
        big = (1.0 + Tr.abs().amax(dim=(1, 2), keepdim=True)) * 1e6
        Tr = Tr + big * torch.diag_embed((~ok).to(Tr.dtype))
        w, V = torch.linalg.eigh(Tr)
        c = W @ V[:, :, :n_ev]
        X = S @ c
        nrm = torch.linalg.norm(X, dim=1, keepdim=True)
        return w[:, :n_ev], X / torch.where(nrm == 0, torch.ones_like(nrm), nrm), c

    rayleigh_ritz = rayleigh_ritz_qr if full_ortho else rayleigh_ritz_raw

    def residual(X, theta):
        R = A @ X - X * theta[:, None, :]
        return R, torch.linalg.norm(R, dim=1)          # (n_agg, n_ev)

    t0 = time.perf_counter()
    X = torch.from_numpy(X0).to(device)
    theta, X, _ = rayleigh_ritz_qr(X)
    P = torch.zeros_like(X)
    active = torch.ones(n_agg, dtype=torch.bool, device=device)
    block_iters = torch.zeros(n_agg, dtype=torch.int64, device=device)
    it = 0
    while it < max_iterations and bool(active.any()):
        R, _ = residual(X, theta)
        # unit-normalize the R and P blocks: spans are unchanged and the QR
        # of the trial basis stays well conditioned near convergence
        S = torch.cat([X, _unit_cols(R), _unit_cols(P)], dim=2)
        theta_n, Xn, c = rayleigh_ritz(S)
        # the classical LOBPCG conjugate direction: the R, P components of
        # the new Ritz vectors (Knyazev 2001, eq. 4.3)
        Pn = _unit_cols(S[:, :, n_ev:] @ c[:, n_ev:, :])
        keep = active[:, None, None]
        X = torch.where(keep, Xn, X)
        P = torch.where(keep, Pn, P)
        theta = torch.where(active[:, None], theta_n, theta)
        block_iters += active
        _, rn = residual(X, theta)
        active = active & (rn.max(dim=1).values > tol)
        it += 1
    evals = theta.cpu().numpy() - shifts[:, None]
    evecs = X.cpu().numpy()
    if stats is not None:
        stats.update(device_s=time.perf_counter() - t0, iterations=it)
    # normalize, zero padding
    evecs = evecs * batch.valid[:, :, None]
    nrm = np.linalg.norm(evecs, axis=1, keepdims=True)
    evecs = np.where(nrm > 0, evecs / np.where(nrm == 0, 1, nrm), evecs)
    if return_info:
        info = {"iterations": it, "converged": ~active.cpu().numpy(),
                "block_iterations": block_iters.cpu().numpy()}
        return evals, evecs, info
    return evals, evecs
