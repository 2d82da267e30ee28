"""Test helper: flatten an mfmg_tpu hierarchy's levels into numpy arrays and
static metadata for mfmg_torch.amge.hierarchy.levels_from_arrays.

It imports mfmg_tpu (and so jax), which the port itself never does; it
lives under tests/ for that reason.
"""

import numpy as np

from mfmg_tpu.ops.block_stencil import BlockStencilOperator
from mfmg_tpu.ops.sparse import ELLMatrix
from mfmg_tpu.ops.stencil import StencilOperator
from mfmg_tpu.ops.structured_transfer import (GeneralWindowTransfer,
                                              StructuredTransfer)
from mfmg_tpu.solve.coarse import DirectCoarseSolver
from mfmg_tpu.solve.smoothers import (ChebyshevSmoother, FusedChebyshevSmoother,
                                      JacobiSmoother)


def _ell(arrays, key, A):
    arrays[key + ".vals"] = np.asarray(A.vals)
    arrays[key + ".cols"] = np.asarray(A.cols)


def flatten_levels(levels):
    """(arrays, meta) for a tuple of mfmg_tpu LevelData."""
    arrays, metas = {}, []
    for l, lvl in enumerate(levels):
        pre = f"L{l}."
        m = {"smoother": None, "transfer": None, "coarse": None}
        op = lvl.op
        if isinstance(op, StencilOperator):
            arrays[pre + "op.coeffs"] = np.asarray(op.coeffs)
            m["op"] = dict(type="stencil", offsets=op.offsets,
                           grid_shape=op.grid_shape, sym_pos=op.sym_pos)
        elif isinstance(op, BlockStencilOperator):
            arrays[pre + "op.coeffs"] = np.asarray(op.coeffs)
            m["op"] = dict(type="block_stencil", offsets=op.offsets,
                           agg_shape=op.agg_shape, n_comp=op.n_comp,
                           radius=op.radius)
        elif isinstance(op, ELLMatrix):
            _ell(arrays, pre + "op", op)
            m["op"] = dict(type="ell", n_cols=op.n_cols)
        else:
            raise TypeError(type(op))
        sm = lvl.smoother
        if isinstance(sm, FusedChebyshevSmoother):
            sm = sm.to_plain()
        if isinstance(sm, ChebyshevSmoother):
            arrays[pre + "smoother.inv_diag"] = np.asarray(sm.inv_diag)
            m["smoother"] = dict(type="chebyshev", theta=float(sm.theta),
                                 delta=float(sm.delta), degree=sm.degree)
        elif isinstance(sm, JacobiSmoother):
            arrays[pre + "smoother.inv_diag"] = np.asarray(sm.inv_diag)
            m["smoother"] = dict(type="jacobi", omega=float(sm.omega))
        elif sm is not None:
            raise TypeError(type(sm))
        tr = lvl.transfer
        if isinstance(tr, StructuredTransfer):
            arrays[pre + "transfer.W"] = np.asarray(tr.W)
            m["transfer"] = dict(type="structured",
                                 window_shape=tr.window_shape,
                                 agg_shape=tr.agg_shape,
                                 grid_shape=tr.grid_shape)
        elif isinstance(tr, GeneralWindowTransfer):
            arrays[pre + "transfer.W"] = np.asarray(tr.W)
            if tr.Rd is not None:
                arrays[pre + "transfer.Rd"] = np.asarray(tr.Rd)
            m["transfer"] = dict(type="general", window_shape=tr.window_shape,
                                 t0=tr.t0, stride=tr.stride,
                                 in_grid=tr.in_grid, out_grid=tr.out_grid,
                                 n_in=tr.n_in, n_out=tr.n_out)
        elif tr is not None:
            raise TypeError(type(tr))
        elif lvl.R is not None:
            # the reference's ELL transfer: R and R^T on the level itself
            _ell(arrays, pre + "transfer.R", lvl.R)
            _ell(arrays, pre + "transfer.RT", lvl.RT)
            m["transfer"] = dict(type="ell", n_fine=lvl.R.n_cols,
                                 n_coarse=lvl.RT.n_cols)
        if isinstance(lvl.coarse, DirectCoarseSolver):
            arrays[pre + "coarse.inv"] = np.asarray(lvl.coarse.inv)
            m["coarse"] = dict(type="direct")
        elif lvl.coarse is not None:
            raise TypeError(type(lvl.coarse))
        metas.append(m)
    return arrays, {"levels": metas}


def main_path_config(cfg_mod, dtype, coeff_dtype=None):
    """The main-path configuration (bench.py:97-103) in either package's
    config module."""
    return cfg_mod.Config(
        max_levels=3, operator="stencil", dtype=dtype, coeff_dtype=coeff_dtype,
        eigensolver=cfg_mod.EigensolverConfig(type="lapack", n_eigenvectors=2,
                                              n_eigenvectors_deep=4),
        smoother=cfg_mod.SmootherConfig(type="chebyshev", degree=2),
        agglomeration=cfg_mod.AgglomerationConfig(nx=4, ny=4, nz=4),
        coarse=cfg_mod.CoarseConfig(type="direct"))


def jax_probe(n_agg, m, n_probe):
    """The reference device eigensolve's start block, as numpy: standard
    normal float32 from jax.random with PRNGKey(0), drawn with x64 off as
    the reference draws it on its accelerator."""
    import jax
    import jax.numpy as jnp
    with jax.enable_x64(False):
        return np.array(jax.random.normal(jax.random.PRNGKey(0),
                                          (n_agg, m, n_probe),
                                          dtype=jnp.float32))
