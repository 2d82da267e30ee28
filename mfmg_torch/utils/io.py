"""Artifact I/O: VTU mesh/solution output and MatrixMarket dumps.

Analog of the reference's visualization and debug outputs:
  * AMGe::output — VTU with per-cell agglomerate ids (amge.templates.hpp:227-269)
  * Laplace::output_results — VTU solution (tests/laplace.hpp:246-278)
  * matrix_market_output_* (dealii/dealii_utils.cc:63-91)

Writes VTK XML unstructured-grid files (ascii) readable by ParaView/VisIt.
The port of mfmg_tpu/utils/io.py over mfmg_torch's own Mesh; the files
are the reference's, byte for byte.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from mfmg_torch.fem.mesh import Mesh

# VTK cell types
_VTK_QUAD = 9
_VTK_HEX = 12
_VTK_LINE = 3


def _vtk_corner_order(dim):
    """VTK vertex order for line/quad/hex from our lexicographic corners."""
    if dim == 1:
        return [0, 1]
    if dim == 2:
        return [0, 1, 3, 2]
    return [0, 1, 3, 2, 4, 5, 7, 6]


def write_vtu(filename: str, mesh: Mesh, point_data: dict | None = None,
              cell_data: dict | None = None) -> None:
    """Write the mesh (corner vertices of each cell) with optional nodal and
    per-cell scalar fields."""
    dim = mesh.dim
    k = mesh.degree
    # cell corner dofs in lexicographic order
    from mfmg_torch.fem.reference import reference_element
    lm = reference_element(dim, k).local_multi_index
    corners = []
    for ci in range(2 ** dim):
        c = [(ci >> d) & 1 for d in range(dim)]
        corners.append(int(np.nonzero((lm == np.array(c) * k).all(axis=1))[0][0]))
    cells = mesh.cells[:, corners]
    order = _vtk_corner_order(dim)
    conn = cells[:, order]
    vtk_type = {1: _VTK_LINE, 2: _VTK_QUAD, 3: _VTK_HEX}[dim]

    pts = np.zeros((mesh.n_nodes, 3))
    pts[:, :dim] = mesh.nodes

    with open(filename, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write(' <UnstructuredGrid>\n')
        f.write(f'  <Piece NumberOfPoints="{mesh.n_nodes}" NumberOfCells="{mesh.n_cells}">\n')
        f.write('   <Points>\n    <DataArray type="Float64" NumberOfComponents="3" format="ascii">\n')
        np.savetxt(f, pts, fmt="%.16g")
        f.write('    </DataArray>\n   </Points>\n')
        f.write('   <Cells>\n    <DataArray type="Int32" Name="connectivity" format="ascii">\n')
        np.savetxt(f, conn, fmt="%d")
        f.write('    </DataArray>\n    <DataArray type="Int32" Name="offsets" format="ascii">\n')
        np.savetxt(f, (np.arange(1, mesh.n_cells + 1) * conn.shape[1])[:, None], fmt="%d")
        f.write('    </DataArray>\n    <DataArray type="UInt8" Name="types" format="ascii">\n')
        np.savetxt(f, np.full((mesh.n_cells, 1), vtk_type), fmt="%d")
        f.write('    </DataArray>\n   </Cells>\n')
        if point_data:
            f.write('   <PointData Scalars="%s">\n' % next(iter(point_data)))
            for name, arr in point_data.items():
                f.write(f'    <DataArray type="Float64" Name="{name}" format="ascii">\n')
                np.savetxt(f, np.asarray(arr)[:, None], fmt="%.16g")
                f.write('    </DataArray>\n')
            f.write('   </PointData>\n')
        if cell_data:
            f.write('   <CellData Scalars="%s">\n' % next(iter(cell_data)))
            for name, arr in cell_data.items():
                f.write(f'    <DataArray type="Float64" Name="{name}" format="ascii">\n')
                np.savetxt(f, np.asarray(arr)[:, None], fmt="%.16g")
                f.write('    </DataArray>\n')
            f.write('   </CellData>\n')
        f.write('  </Piece>\n </UnstructuredGrid>\n</VTKFile>\n')


def output_agglomerates(filename: str, mesh: Mesh, agg_ids: np.ndarray) -> None:
    """AMGe::output analog: VTU with the agglomerate id of every cell."""
    write_vtu(filename, mesh, cell_data={"agglomerates": agg_ids.astype(float)})


def write_matrix_market(filename: str, A) -> None:
    """MatrixMarket dump (matrix_market_output_file analog)."""
    from scipy.io import mmwrite
    mmwrite(filename, sp.coo_matrix(A))


def write_vector_matrix_market(filename: str, v: np.ndarray) -> None:
    with open(filename, "w") as f:
        f.write("%%MatrixMarket matrix array real general\n")
        f.write(f"{len(v)} 1\n")
        for x in np.asarray(v):
            f.write(f"{x:.16g}\n")
