"""The multigrid hierarchy: host setup, then a V-cycle of PyTorch modules.

Port of mfmg_tpu/amge/hierarchy.py (reference include/mfmg/common/
hierarchy.hpp:155-309) for every operator of the reference: the stencil,
the assembled (ELL) and the matrix-free ("matrix_free", "sumfac") paths.
Each level is a ``LevelData`` module (operator, smoother, transfer, coarse
solver); setup runs on the host in numpy/scipy exactly as in the
reference, and each level is moved to the hierarchy's device once, when it
is appended.

Setup pipeline per level (hierarchy.hpp:178-234):
    operator -> smoother -> agglomerates -> batched eigensolve -> R (PoU
    weighted) -> A_coarse = R A R^T (per-agglomerate Galerkin blocks with
    fast_ap, the host SpGEMM without; fast_ap is on by default for the
    stencil and matrix-free operators, whose setup then never assembles the
    fine matrix) -> transfer (structured or window on
    a structured agglomerate grid, else R and R^T as ELL matrices) ->
    coarse operator (block stencil inside its window, else ELL) -> recurse
    / coarse solver.

Level 0 on the card takes the reference's device route (its accelerator
route, mfmg_tpu/amge/hierarchy.py:494-517): a light agglomerate batch, the
eigensolve as dense batched algebra on the device (eigen/device_eig.py),
and the Galerkin blocks against the batch it keeps there.  Where the
pipeline does not apply (the CPU, a distorted mesh, a float64 hierarchy, a
problem with its own cell matrices) level 0 takes the host route: the dense batch in the host library and LAPACK ``syevx`` (or, for
``backend="device"``, one batched ``torch.linalg.eigh`` on the device).
``Hierarchy.setup_route`` records which.

On CUDA, ``_finalize_cuda_kernels`` swaps the level-0 Chebyshev smoother for
the K2-backed ``FusedChebyshevSmoother`` and fills the level-0 ``fused`` slot
with the single-kernel coarse tail (ops/fused_cycle.py) where the levels fit
it; every fine stencil apply goes through K1.  Without a tail (on the CPU,
or for other level structures) the cycle is the generic recursion, as in
the reference.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from mfmg_torch.amge.agglomeration import build_agglomerates
from mfmg_torch.amge.local_problems import build_agglomerate_batch
from mfmg_torch.amge.restriction import build_restriction, check_restriction
from mfmg_torch.config import Config
from mfmg_torch.eigen.batched_eigh import batched_smallest_eigenpairs
from mfmg_torch.ops.fused_cycle import (build_fused_tail,
                                        fused_correction_apply,
                                        fused_subcycle_apply)
from mfmg_torch.solve.cg import cg_solve
from mfmg_torch.solve.coarse import build_coarse_solver
from mfmg_torch.solve.operator import apply_op
from mfmg_torch.solve.smoothers import build_smoother
from mfmg_torch.utils.device import checked_device


class LevelData(nn.Module):
    """Per-level state (analog of mfmg::Level, common/level.hpp:22-77)."""

    def __init__(self, op, smoother=None, transfer=None, coarse=None,
                 fused=None):
        super().__init__()
        self.op = op                      # StencilOperator | BlockStencilOperator
                                          # | ELLMatrix | MatrixFreeOperator
                                          # | SumFactoredOperator
        self.smoother = smoother          # None on the coarsest level
        self.transfer = transfer          # restriction into the next level:
                                          # Structured-, GeneralWindow- or
                                          # ELLTransfer
        self.coarse = coarse              # coarse solver on the coarsest level
        self.fused = fused                # FusedTail: the whole coarse tail in
                                          # one kernel launch (level 0 only)


def _vcycle(levels, b, x, level, n_smoothing_steps, is_preconditioner,
            cycle_type="v"):
    """Recursive multigrid cycle (hierarchy.hpp:246-309)."""
    if level == 0 and is_preconditioner:
        x = torch.zeros_like(b)
    return _cycle(levels, b, x, level, n_smoothing_steps, cycle_type)


def _cycle(levels, b, x, level, n_smoothing_steps, cycle_type):
    lvl = levels[level]
    if level == len(levels) - 1:
        return lvl.coarse.apply(b)
    awr = hasattr(lvl.smoother, "apply_with_residual")
    res = None
    for i in range(n_smoothing_steps):
        if awr and i == n_smoothing_steps - 1:
            # the fused smoother emits the V-cycle residual in the same call
            x, res = lvl.smoother.apply_with_residual(lvl.op, b, x)
        else:
            x = lvl.smoother.apply(lvl.op, b, x)
    if res is None:
        res = apply_op(lvl.op, x) - b    # negative residual (hierarchy.hpp:282-286)
    fused = lvl.fused if level == 0 else None
    if (fused is not None and cycle_type == "v"
            and n_smoothing_steps == fused.nss and fused.fine_grid is not None):
        # the whole coarse tail (restrict, level >= 1 cycle, prolong,
        # correction) in one kernel launch (ops/fused_cycle.py)
        x = fused_correction_apply(fused, x, res)
    elif (fused is not None and cycle_type == "v"
          and n_smoothing_steps == fused.nss):
        # fine grid beyond the full-tail gate: the fine transfer around the
        # single-kernel level-1 sub-cycle (windowed L1 -> L2 inside)
        b_coarse = lvl.transfer.restrict(res)
        x = x - lvl.transfer.prolong(fused_subcycle_apply(fused, b_coarse))
    else:
        b_coarse = lvl.transfer.restrict(res)
        x_coarse = torch.zeros_like(b_coarse)
        sub_cycles = {"v": ("v",), "w": ("w", "w"), "f": ("f", "v")}[cycle_type]
        for sub in sub_cycles:
            x_coarse = _cycle(levels, b_coarse, x_coarse, level + 1,
                              n_smoothing_steps, sub)
        x = x - lvl.transfer.prolong(x_coarse)
    for _ in range(n_smoothing_steps):
        x = lvl.smoother.apply(lvl.op, b, x)
    return x


def vcycle(levels, b, x, n_smoothing_steps=1, is_preconditioner=True,
           cycle_type="v"):
    return _vcycle(levels, b, x, 0, n_smoothing_steps, is_preconditioner,
                   cycle_type)


# operators whose setup never assembles the fine matrix under fast_ap
# (mfmg_tpu/amge/hierarchy.py:159)
MF_TYPES = ("matrix_free", "sumfac", "stencil")


def _torch_dtype(name) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _np_dtype(dt: torch.dtype):
    return np.float64 if dt == torch.float64 else np.float32


class Hierarchy:
    """Public entry point: the constructor runs the full setup
    (hierarchy.hpp:159-236), level 0's eigensolve and Galerkin blocks on the
    device where the device route applies, and places every level on
    ``device``.  ``setup_route`` is "device" or "host"; ``setup_seconds``
    holds the seconds of each setup stage; ``per_cell_levels`` the levels
    whose restrictor took the per-cell patch path.

    device is "cuda" unless the caller asks for the CPU; "cuda" needs a CUDA
    device and never falls back to the CPU.
    Supported configurations: operator="stencil" (structured meshes with
    lexicographic dofs only; an unstructured or renumbered mesh raises the
    reference's ValueError), "ell" (the default), "matrix_free" or "sumfac"
    on any mesh of fem/ (hyper_cube, renumbered cubes, hyper_ball, adaptive
    meshes with hanging nodes, where the Galerkin product goes through the
    condensed A), the "block" (closed-form or walked), "block_dealii",
    "rcb"/"zoltan" and "metis" partitioners, the "lapack" eigensolver in
    every constrained mode ("auto" is "identity" for the matrix-free
    operators, "pin" otherwise, as in the reference), every smoother of
    the reference (Jacobi, Chebyshev with the Lanczos or deal.II CG
    estimate, multicolor or lexicographic Gauss-Seidel, ILU(0)), and the
    "direct" coarse solver, at any max_levels; the other eigensolvers, the
    other coarse solvers and distributed setup raise NotImplementedError
    naming their ROADMAP item.
    """

    def __init__(self, problem, config: Config | None = None, device="cuda"):
        self.config = config or Config()
        self.problem = problem
        self.device = checked_device(device)
        self.dtype = _torch_dtype(self.config.dtype)
        self.levels = nn.ModuleList()
        self.setup_seconds = {}
        self.setup_route = None
        self.per_cell_levels = []
        self._exact_op_cache = None
        self._device_A = None
        self._level0_blocks = None
        self._check_supported()
        self._setup()

    def _check_supported(self):
        cfg = self.config
        unsupported = []
        if cfg.distributed_setup:
            unsupported.append("distributed_setup (ROADMAP Queue 1, item 8)")
        if cfg.eigensolver.type != "lapack":
            unsupported.append(f"eigensolver {cfg.eigensolver.type!r} "
                               f"(ROADMAP Queue 1, item 5)")
        if unsupported:
            raise NotImplementedError("mfmg_torch does not support "
                                      + ", ".join(unsupported) + " yet")

    # ------------------------------------------------------------- setup --
    def _setup(self):
        from mfmg_torch.amge.multilevel import (_dof_row_structure,
                                                agg_galerkin_blocks,
                                                galerkin_product_from_blocks)
        from mfmg_torch.ops.block_stencil import block_stencil_from_csr
        from mfmg_torch.ops.sparse import ell_from_scipy, ell_transfer_from_scipy
        from mfmg_torch.ops.stencil import stencil_from_cell_matrices
        from mfmg_torch.ops.structured_transfer import (
            general_window_transfer_from_csr, structured_transfer_from_batch)

        self._t_mark = time.perf_counter()
        mark = self._mark
        cfg = self.config
        problem = self.problem
        stencil = cfg.operator == "stencil"
        # fast_ap auto: the per-agglomerate Galerkin blocks for the stencil
        # and matrix-free paths (the fine matrix is never assembled), the
        # host SpGEMM for the assembled ELL path
        # (mfmg_tpu/amge/hierarchy.py:155-171)
        fast_ap = (cfg.operator in MF_TYPES if cfg.fast_ap is None
                   else bool(cfg.fast_ap))
        if problem.mesh.hanging is not None:
            # the coarse operator must be Galerkin in the condensed matrix
            # (master rows carry w A w corrections the raw per-agglomerate
            # blocks do not see): the product goes through the assembled,
            # condensed A
            fast_ap = False
        self._fast_ap = fast_ap
        if stencil:
            # coeff_dtype (e.g. bfloat16) reduces the fine apply's byte
            # stream in the preconditioner only; the outer CG uses the
            # exact-dtype operator
            coeff_dt = (_torch_dtype(cfg.coeff_dtype) if cfg.coeff_dtype
                        else self.dtype)
            op = stencil_from_cell_matrices(problem.mesh, problem.A_loc,
                                            problem.constrained,
                                            problem.diag_raw, dtype=coeff_dt)
        elif cfg.operator in ("matrix_free", "sumfac"):
            op = problem.matrix_free_operator(
                dtype=self.dtype, device=self.device,
                mode="sumfac" if cfg.operator == "sumfac" else "local_matrix")
        else:
            op = problem.ell_operator(dtype=self.dtype, device=self.device)
        # the fine matrix is assembled unless a matrix-free-style operator
        # has fast_ap (the cell matrices then feed the smoother's estimate)
        A_per_level = [None if (fast_ap and cfg.operator in MF_TYPES)
                       else problem.A]
        self._A_shapes = [(problem.n_dofs, problem.n_dofs)]
        self._A_nnzs = [problem.A.nnz if A_per_level[0] is not None
                        else self._op_nnz(op)]
        mark("fine operator")

        n_ev0 = cfg.eigensolver.n_eigenvectors
        n_evd = cfg.eigensolver.n_eigenvectors_deep or n_ev0
        agg_grid = None
        for level in range(cfg.max_levels):
            if level == cfg.max_levels - 1:
                A_c = A_per_level[level]
                if A_c is None:
                    A_c = problem.A          # max_levels == 1
                coarse = build_coarse_solver(A_c, cfg.coarse, dtype=self.dtype,
                                             device=self.device)
                self._append(LevelData(op, coarse=coarse))
                mark(f"coarse solver (n={A_c.shape[0]})")
                break
            smoother = build_smoother(op, cfg.smoother, dtype=self.dtype,
                                      A_scipy=A_per_level[level],
                                      problem=problem if level == 0 else None)
            mark(f"smoother L{level}")
            R = self._build_restrictor(level, A_per_level)
            mark(f"restrictor L{level}")
            if fast_ap and level == 0:
                # matrix-free Galerkin product R A R^T from per-agglomerate
                # blocks Rb_a A_a Rb_a^T (reused by the level-1 restrictor)
                batch = self._level0_eigendata[0]
                dof_rows, dof_vals = _dof_row_structure(R)
                if self._device_A is not None:
                    from mfmg_torch.eigen.device_eig import \
                        device_galerkin_blocks
                    blocks = device_galerkin_blocks(batch, self._device_A,
                                                    dof_rows, dof_vals,
                                                    R.shape[0])
                    # free the device batch (2 GB at 129^3) before the
                    # levels are placed
                    self._device_A = None
                    mark("device Galerkin blocks L0")
                else:
                    blocks = agg_galerkin_blocks(batch, dof_rows, dof_vals,
                                                 R.shape[0], eliminate=False)
                    mark("host Galerkin blocks L0")
                A_coarse = galerkin_product_from_blocks(blocks, R.shape[0])
                self._level0_blocks = blocks
            else:
                A_coarse = (R @ A_per_level[level] @ R.T).tocsr()
            A_per_level.append(A_coarse)
            self._A_shapes.append(A_coarse.shape)
            self._A_nnzs.append(A_coarse.nnz)
            mark(f"galerkin product L{level}")

            # a structured agglomerate grid gives a gather-free transfer and
            # a block-stencil coarse operator; any other level takes R and
            # R^T, and an operator outside the block-stencil window, as ELL
            transfer = None
            if level == 0 and stencil:
                batch, _, evecs = self._level0_eigendata
                transfer = structured_transfer_from_batch(
                    problem.mesh, batch, evecs, problem.diag_raw,
                    dtype=self.dtype)
                agg_grid = transfer.agg_shape if transfer is not None else None
                coarse_grid, n_comp = agg_grid, n_ev0
            elif level > 0 and stencil and agg_grid is not None:
                in_comp = n_ev0 if level == 1 else n_evd
                out_grid = tuple(reversed(self._super_grid_xyz))
                stride = tuple(reversed(cfg.agglomeration.block_dims(
                    problem.mesh.dim)))
                transfer = general_window_transfer_from_csr(
                    R, agg_grid, in_comp, out_grid, n_evd, stride,
                    dtype=self.dtype)
                if transfer is not None:
                    agg_grid = out_grid
                    coarse_grid, n_comp = out_grid, n_evd
            op_coarse = None
            if transfer is not None:
                op_coarse = block_stencil_from_csr(A_coarse, coarse_grid, n_comp,
                                                   dtype=self.dtype)
            else:
                transfer = ell_transfer_from_scipy(R, dtype=self.dtype)
            if op_coarse is None:
                op_coarse = ell_from_scipy(A_coarse, dtype=self.dtype)
            self._append(LevelData(op, smoother=smoother, transfer=transfer))
            op = op_coarse
            mark(f"level L{level} placed on {self.device}")
        self._A_per_level = A_per_level
        self._finalize_cuda_kernels()

    def _mark(self, name):
        """Record the seconds since the previous mark as stage ``name``."""
        now = time.perf_counter()
        self.setup_seconds[name] = now - self._t_mark
        self._t_mark = now

    def _use_device_eig(self) -> bool:
        """The level-0 device route is wanted and can hold the hierarchy: the
        'lapack' eigensolver with backend 'auto' or 'device' in the 'pin'
        constrained mode (an identity-mode hierarchy, the matrix-free
        operators' default, takes the host route, as in the reference), a
        float32 hierarchy (the pipeline is float32 throughout; a float64
        hierarchy keeps float64 eigenpairs and Galerkin blocks, as the
        reference's pipeline refuses x64), and a problem whose cell matrices
        are the Laplace form the pipeline rebuilds from geom and coeff_at_q
        (not a local_matrix_fn's)."""
        e = self.config.eigensolver
        return (e.type == "lapack" and e.backend in ("auto", "device")
                and self._constrained_mode() == "pin"
                and self.dtype == torch.float32
                and getattr(self.problem, "laplace_form", False))

    def _constrained_mode(self) -> str:
        """The eigensolver's constrained mode: "auto" follows the reference's
        per-path convention (mfmg_tpu/amge/hierarchy.py:586-594): identity
        rows for the matrix-free evaluators, shift + pin for the others."""
        mode = self.config.eigensolver.constrained_mode
        if mode != "auto":
            return mode
        return ("identity" if self.config.operator in ("matrix_free", "sumfac")
                else "pin")

    def _append(self, level_data: LevelData):
        """Finalize a level and move it to the device (its one h2d copy)."""
        from mfmg_torch.ops.stencil import StencilOperator, stencil_to_device
        if isinstance(level_data.op, StencilOperator):
            stencil_to_device(level_data.op, self.device)
        self.levels.append(level_data.to(self.device))

    def _finalize_cuda_kernels(self):
        """The port's counterpart of mfmg_tpu _finalize_tpu_kernels: on CUDA,
        the level-0 Chebyshev smoother becomes the K2-backed fused smoother,
        and a float32 V-cycle hierarchy whose levels fit gets the fused
        coarse tail (the kernel takes float32 vectors).  With a bf16
        coeff_dtype over a float32 hierarchy the tail's weights are stored in
        bf16, as in the reference.  A tail already in the slot (one moved
        with the levels) is kept."""
        if self.device.type != "cuda":
            return
        from mfmg_torch.solve.smoothers import fuse_chebyshev
        l0 = self.levels[0]
        fsm = fuse_chebyshev(l0.smoother, l0.op) if l0.smoother is not None else None
        if fsm is not None:
            l0.smoother = fsm
        cfg = self.config
        if (l0.fused is not None or cfg.cycle_type != "v"
                or self.dtype != torch.float32):
            return
        reduced = bool(cfg.coeff_dtype
                       and _torch_dtype(cfg.coeff_dtype) == torch.bfloat16)
        l0.fused = build_fused_tail(self.levels,
                                    cfg.smoother.n_smoothing_steps,
                                    reduced_storage=reduced)

    def _build_restrictor(self, level: int, A_per_level) -> sp.csr_matrix:
        """Analog of HierarchyHelpers::build_restrictor for one level: level
        0 agglomerates mesh cells, level 1 agglomerates the level-0
        agglomerates (amge/multilevel.py)."""
        cfg = self.config
        problem = self.problem
        if level == 0:
            agg_ids = build_agglomerates(problem.mesh, cfg.agglomeration)
            self._mark("agglomerates L0")
            n_ev = cfg.eigensolver.n_eigenvectors
            batch_dtype = _np_dtype(self.dtype)
            self.setup_route = "host"
            if self._use_device_eig():
                from mfmg_torch.eigen import device_eig
                if device_eig.supports(problem.mesh, agg_ids, self.device,
                                       geom=problem.geom):
                    batch = build_agglomerate_batch(
                        problem.mesh, problem.A_loc, agg_ids,
                        batch_dtype=batch_dtype, assemble_operator=False)
                    self._mark("light batch L0")
                    # the dense batch is assembled and solved on the device,
                    # and kept there for the Galerkin blocks when fast_ap
                    # forms them (without fast_ap nothing consumes it); no
                    # host fallback
                    out = device_eig.device_smallest_eigenpairs(
                        problem, agg_ids, batch, n_ev, keep_A=self._fast_ap,
                        device=self.device,
                        mark=lambda stage: self._mark(
                            f"device eigensolve L0: {stage}"))
                    evals, evecs = out[:2]
                    self._device_A = out[2] if self._fast_ap else None
                    self.setup_route = "device"
            if self.setup_route == "host":
                batch = build_agglomerate_batch(problem.mesh, problem.A_loc,
                                                agg_ids, batch_dtype=batch_dtype)
                self._mark("batch L0")
                evals, evecs = batched_smallest_eigenpairs(
                    batch, n_ev, constrained_mode=self._constrained_mode(),
                    host_dtype=batch_dtype,
                    use_device=cfg.eigensolver.backend == "device",
                    device=self.device)
                self._mark("host eigensolve L0")
            check_restriction(batch, problem.diag_raw, problem.n_dofs)
            self._level0_eigendata = (batch, evals, evecs)
            R = build_restriction(batch, evecs, problem.diag_raw, problem.n_dofs)
            self._cell_agg = agg_ids
            self._R_composed = R
            return R
        from mfmg_torch.amge.multilevel import build_recursive_restriction
        n_evd = (cfg.eigensolver.n_eigenvectors_deep
                 or cfg.eigensolver.n_eigenvectors)
        # level 1 sums its patches from the level-0 agglomerates' blocks
        # where the batch is dense or its Galerkin blocks exist; a light
        # batch without blocks (the device route without fast_ap) and every
        # deeper level take the per-cell patch path
        # (mfmg_tpu/amge/hierarchy.py:550-562)
        prev_batch = self._level0_eigendata[0] if level == 1 else None
        prev_blocks = self._level0_blocks if level == 1 else None
        if (prev_batch is not None and prev_batch.A_agg is None
                and prev_blocks is None):
            prev_batch = None
        if prev_batch is None:
            self.per_cell_levels.append(level)
        R_l, cell_super, super_grid = build_recursive_restriction(
            problem.mesh, problem.A_loc, self._cell_agg, self._R_composed,
            A_per_level[level], problem.constrained, n_evd,
            cfg.agglomeration.block_dims(problem.mesh.dim),
            prev_batch=prev_batch, prev_blocks=prev_blocks)
        self._cell_agg = cell_super
        self._R_composed = (R_l @ self._R_composed).tocsr()
        self._super_grid_xyz = super_grid
        return R_l

    # ------------------------------------------------------------- apply --
    def to(self, device):
        """Move every level (and the cached outer-CG operator) to device.  On
        CUDA the kernels are finalized as the constructor does: the K2
        smoother, and the fused tail where the level-0 slot is empty."""
        self.device = checked_device(device)
        self.levels.to(self.device)
        if self._exact_op_cache is not None:
            self._exact_op_cache.to(self.device)
        self._finalize_cuda_kernels()
        return self

    def _vector(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(b), dtype=self.dtype, device=self.device)

    def apply(self, b, x=None):
        """One V-cycle: solves/preconditions A x = b (hierarchy.hpp:246)."""
        b = self._vector(b)
        x = torch.zeros_like(b) if x is None else self._vector(x)
        return vcycle(self.levels, b, x,
                      n_smoothing_steps=self.config.smoother.n_smoothing_steps,
                      is_preconditioner=self.config.is_preconditioner,
                      cycle_type=self.config.cycle_type)

    def vmult(self, b):
        """Preconditioner application x = M^{-1} b (hierarchy.hpp:238-244)."""
        b = self._vector(b)
        return vcycle(self.levels, b, torch.zeros_like(b),
                      n_smoothing_steps=self.config.smoother.n_smoothing_steps,
                      is_preconditioner=True, cycle_type=self.config.cycle_type)

    def solve_cg(self, b, tol=1e-12, maxiter=1000):
        """Hierarchy-preconditioned CG (analog of laplace.hpp:206-219).
        Returns (x tensor, {"iterations": int, "relres": float})."""
        nss = self.config.smoother.n_smoothing_steps

        def precond(r):
            return vcycle(self.levels, r, torch.zeros_like(r),
                          n_smoothing_steps=nss, is_preconditioner=True,
                          cycle_type=self.config.cycle_type)

        return cg_solve(self._exact_fine_op(), self._vector(b),
                        preconditioner=precond, tol=tol, maxiter=maxiter)

    def _exact_fine_op(self):
        """Fine operator at the full hierarchy dtype for the outer Krylov
        residual.  When coeff_dtype reduces the hierarchy's coefficient
        storage (bf16 preconditioner), this builds (once) the exact operator
        so CG solves the unperturbed system."""
        cfg = self.config
        if (cfg.operator != "stencil" or not cfg.coeff_dtype
                or _torch_dtype(cfg.coeff_dtype) == self.dtype):
            return self.levels[0].op
        if self._exact_op_cache is None:
            from mfmg_torch.ops.stencil import (stencil_from_cell_matrices,
                                                stencil_to_device)
            p = self.problem
            self._exact_op_cache = stencil_to_device(
                stencil_from_cell_matrices(p.mesh, p.A_loc, p.constrained,
                                           p.diag_raw, dtype=self.dtype),
                self.device)
        return self._exact_op_cache

    # ------------------------------------------------------------ metrics --
    @staticmethod
    def _op_nnz(op) -> int:
        """Operator nonzero count without assembling anything global: the
        stored planes or ELL values that are not zero; for a matrix-free
        operator the reference's stencil-equivalent estimate, n * 3^dim
        with dim read off a Q1 cell (mfmg_tpu/amge/hierarchy.py:716-720)."""
        from mfmg_torch.ops.sparse import ELLMatrix
        from mfmg_torch.ops.stencil import StencilOperator
        if isinstance(op, StencilOperator):
            return int(torch.count_nonzero(op.coeffs))
        if isinstance(op, ELLMatrix):
            return int(torch.count_nonzero(op.vals))
        n_loc = op.cells.shape[1]
        dim = int(round(np.log2(n_loc))) if n_loc in (2, 4, 8) else 2
        return int(op.shape[0]) * 3 ** dim

    def grid_complexity(self) -> float:
        """Sum of the level sizes over the fine size (operator.hpp:49-51)."""
        sizes = [s[0] for s in self._A_shapes]
        return sum(sizes) / sizes[0]

    def operator_complexity(self) -> float:
        """Sum of the levels' nonzeros over the fine operator's."""
        return sum(self._A_nnzs) / self._A_nnzs[0]


def measure_vcycle_rate(hierarchy: Hierarchy, n_cycles: int = 20, seed: int = 0):
    """Asymptotic V-cycle convergence rate (reference tests/
    test_hierarchy.cc:95-124): random initial error (uniform [0,1) from numpy
    default_rng(seed), zero at Dirichlet dofs), zero RHS, n_cycles
    standalone cycles, rate = res[n]/res[n-1]; the error is renormalized
    every cycle (the iteration is linear)."""
    problem = hierarchy.problem
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=problem.n_dofs)
    x[problem.constrained] = 0.0
    x = hierarchy._vector(x)
    b = torch.zeros_like(x)
    op = hierarchy.levels[0].op
    nss = hierarchy.config.smoother.n_smoothing_steps

    res_prev = None
    rate = None
    for _ in range(n_cycles):
        x = vcycle(hierarchy.levels, b, x, n_smoothing_steps=nss,
                   is_preconditioner=False,
                   cycle_type=hierarchy.config.cycle_type)
        res = float(torch.linalg.norm(apply_op(op, x)))
        if res_prev is not None and res_prev > 0:
            rate = res / res_prev
        nrm = float(torch.linalg.norm(x))
        if nrm > 0:
            x = x / nrm
            res_prev = res / nrm
        else:
            res_prev = res
    return rate


def levels_from_arrays(arrays: dict, meta: dict, device="cuda") -> list[LevelData]:
    """Build the port's levels from a hierarchy flattened to numpy arrays
    plus static metadata, so a hierarchy built elsewhere (mfmg_tpu) can be
    carried across without either package importing the other.

    meta = {"levels": [per-level dict]}; each per-level dict has
      "op": {"type": "stencil", "offsets", "grid_shape", "sym_pos"} or
            {"type": "block_stencil", "offsets", "agg_shape", "n_comp",
             "radius"} or {"type": "ell", "n_cols"},
      "smoother": None | {"type": "chebyshev", "theta", "delta", "degree"}
                  | {"type": "jacobi", "omega"},
      "transfer": None | {"type": "structured", "window_shape", "agg_shape",
                  "grid_shape"} | {"type": "general", "window_shape", "t0",
                  "stride", "in_grid", "out_grid", "n_in", "n_out"}
                  | {"type": "ell", "n_fine", "n_coarse"},
      "coarse": None | {"type": "direct"}.
    arrays holds "L{l}.op.coeffs" (ELL: "L{l}.op.vals", "L{l}.op.cols"),
    "L{l}.smoother.inv_diag", "L{l}.transfer.W", "L{l}.transfer.Rd"
    (general, optional), "L{l}.transfer.R.vals/cols" and
    "L{l}.transfer.RT.vals/cols" (ELL) and "L{l}.coarse.inv"; each array
    keeps its dtype.  The levels go to ``device``, the card unless the
    caller asks for the CPU.
    """
    from mfmg_torch.ops.block_stencil import BlockStencilOperator
    from mfmg_torch.ops.sparse import ELLMatrix, ELLTransfer
    from mfmg_torch.ops.stencil import StencilOperator, stencil_to_device
    from mfmg_torch.ops.structured_transfer import (GeneralWindowTransfer,
                                                    StructuredTransfer)
    from mfmg_torch.solve.coarse import DirectCoarseSolver
    from mfmg_torch.solve.smoothers import ChebyshevSmoother, JacobiSmoother

    def t(key):
        a = np.asarray(arrays[key])
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))      # a writable copy

    def ell(key, n_cols):
        return ELLMatrix(t(key + ".vals"), t(key + ".cols"), n_cols)

    device = checked_device(device)
    levels = []
    for l, m in enumerate(meta["levels"]):
        pre = f"L{l}."
        mo = m["op"]
        if mo["type"] == "stencil":
            op = stencil_to_device(StencilOperator(
                t(pre + "op.coeffs"), mo["offsets"], mo["grid_shape"],
                mo.get("sym_pos")), device)
        elif mo["type"] == "block_stencil":
            op = BlockStencilOperator(t(pre + "op.coeffs"), mo["offsets"],
                                      mo["agg_shape"], mo["n_comp"],
                                      mo.get("radius", 1))
        elif mo["type"] == "ell":
            op = ell(pre + "op", mo["n_cols"])
        else:
            raise ValueError(f"unknown operator type {mo['type']!r}")
        smoother = None
        ms = m.get("smoother")
        if ms is not None and ms["type"] == "chebyshev":
            smoother = ChebyshevSmoother(t(pre + "smoother.inv_diag"),
                                         ms["theta"], ms["delta"], ms["degree"])
        elif ms is not None and ms["type"] == "jacobi":
            smoother = JacobiSmoother(t(pre + "smoother.inv_diag"), ms["omega"])
        elif ms is not None:
            raise ValueError(f"unknown smoother type {ms['type']!r}")
        transfer = None
        mt = m.get("transfer")
        if mt is not None and mt["type"] == "structured":
            transfer = StructuredTransfer(t(pre + "transfer.W"),
                                          mt["window_shape"], mt["agg_shape"],
                                          mt["grid_shape"])
        elif mt is not None and mt["type"] == "general":
            Rd = t(pre + "transfer.Rd") if pre + "transfer.Rd" in arrays else None
            transfer = GeneralWindowTransfer(
                t(pre + "transfer.W"), mt["window_shape"], mt["t0"],
                mt["stride"], mt["in_grid"], mt["out_grid"], mt["n_in"],
                mt["n_out"], Rd=Rd)
        elif mt is not None and mt["type"] == "ell":
            transfer = ELLTransfer(ell(pre + "transfer.R", mt["n_fine"]),
                                   ell(pre + "transfer.RT", mt["n_coarse"]))
        elif mt is not None:
            raise ValueError(f"unknown transfer type {mt['type']!r}")
        coarse = None
        if m.get("coarse") is not None:
            coarse = DirectCoarseSolver(t(pre + "coarse.inv"))
        levels.append(LevelData(op, smoother=smoother, transfer=transfer,
                                coarse=coarse).to(device))
    return levels
