"""mfmg_torch — the PyTorch / CUDA port of mfmg_tpu's spectral-AMGe multigrid.

A second package beside ``mfmg_tpu`` (the JAX reference).  It imports
``torch`` and never ``jax``.  Setup stays host numpy/scipy, as in the
reference; the apply path is PyTorch, and the reference's Pallas kernels on
the main path (the fine-grid stencil apply and Chebyshev step, the fused
coarse tail) are hand-written CUDA for Hopper (``sm_90a``) in ``csrc/``,
built with ``nvcc`` at first use, bound with ctypes and launched by
``ops/cuda_library.py``.

    from mfmg_torch import Config, LaplaceProblem, Hierarchy
    problem = LaplaceProblem.hyper_cube(dim=3, n_refinements=6,
                                        material_property="linear")
    hier = Hierarchy(problem, Config(operator="stencil", ...))  # on the card
    x, info = hier.solve_cg(b, tol=1e-5)

Precision: importing the package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, so every float32 matrix product
(the transfer chains, the dense coarse solve) runs in full float32.  The TPU
reference ran those matmuls at bf16-pass DEFAULT precision; the port is held
against the reference's exact CPU results instead.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from mfmg_torch.config import (AgglomerationConfig, CoarseConfig, Config,  # noqa: E402
                               EigensolverConfig, SmootherConfig)
from mfmg_torch.fem.laplace import LaplaceProblem  # noqa: E402
from mfmg_torch.amge.hierarchy import Hierarchy  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Config",
    "EigensolverConfig",
    "SmootherConfig",
    "CoarseConfig",
    "AgglomerationConfig",
    "LaplaceProblem",
    "Hierarchy",
]
