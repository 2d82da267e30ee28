"""Agglomerate partitioning of mesh cells (block partitioner).

Port of the block path of mfmg_tpu/amge/agglomeration.py, the analog of
AMGe::build_agglomerates (reference common/amge.templates.hpp:51-85): group
nx x ny x nz neighbouring cells per agglomerate.  On a structured grid this
is a closed-form index computation; the partition equals the reference's
x->y->z block walk (amge.templates.hpp:412-499).  The unstructured walk, the
deal.II-ordered walk and the graph partitioners are not ported yet (ROADMAP
Queue 1, Slice E).
"""

from __future__ import annotations

import numpy as np

from mfmg_torch.fem.mesh import Mesh


def build_agglomerates(mesh: Mesh, agg_cfg) -> np.ndarray:
    """Returns (n_cells,) agglomerate ids in [0, n_agg)."""
    if agg_cfg.partitioner != "block" or not mesh.is_structured:
        raise NotImplementedError(
            f"partitioner {agg_cfg.partitioner!r} on a "
            f"{'structured' if mesh.is_structured else 'unstructured'} mesh "
            f"is not ported yet (ROADMAP Queue 1, Slice E); use "
            f"partitioner='block' on a hyper_cube")
    return build_agglomerates_block(mesh, agg_cfg.block_dims(mesh.dim))


def build_agglomerates_block(mesh: Mesh, block_dims) -> np.ndarray:
    nc = mesh.structured_shape
    mi = mesh.cell_multi_index()                     # (n_cells, dim)
    agg = np.zeros(mesh.n_cells, dtype=np.int64)
    stride = 1
    for d in range(mesh.dim):
        agg += (mi[:, d] // block_dims[d]) * stride
        stride *= -(-nc[d] // block_dims[d])
    return agg
