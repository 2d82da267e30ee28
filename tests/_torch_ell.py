"""The ELL kernel's decomposition (mfmg_torch/csrc/ell_spmv.cu) in numpy,
for the CPU tests of ``ell_plan`` and the card's bit-for-bit check.

Block b owns rows b * rows + [0, rows) and streams their entries in passes
of ``chunk``; in each pass every row it holds is summed by ``lanes`` lanes,
lane l the pass's terms l, l + lanes, ... of that row in order, then a
butterfly across the lanes (s_l += s_{l xor o}, o = lanes / 2, ..., 1), and
lane 0's sum is added to the row's total in pass order.  Products and sums
are in the values' type, one rounding each, as on the card.  Also the
random CSR matrices both the CPU and the card tests apply.  No JAX.
"""

import numpy as np
import scipy.sparse as sp


def random_csr(case):
    """(A, pad_to) for one case: a random square or rectangular CSR with
    some empty rows (and columns), an empty matrix, padded rows, or "long"
    rows of ~2,340 entries (longer than one pass of the ELL kernel)."""
    rng = np.random.default_rng({"square": 0, "rect": 1, "empty": 2,
                                 "pad": 3, "long": 5}[case])
    if case == "empty":
        return sp.csr_matrix((7, 5)), None
    if case == "long":
        return sp.random(9, 2600, density=0.9, random_state=rng,
                         format="csr"), None
    n, m = (60, 60) if case != "rect" else (40, 75)
    A = sp.random(n, m, density=0.08, random_state=rng, format="csr")
    A = sp.lil_matrix(A)
    for r in rng.choice(n, 6, replace=False):
        A[r, :] = 0                                 # empty rows
    A.setdiag(rng.uniform(1.0, 2.0, min(n, m)))
    A = sp.csr_matrix(A)
    return A, (int(np.diff(A.indptr).max()) + 5 if case == "pad" else None)


def ell_block_model(prod, L, plan):
    """One block on its rows' products (nr * L, row-major): (the rows'
    totals, the times each entry was read)."""
    dt = prod.dtype
    span = prod.size
    nr = span // L
    g = plan.lanes
    acc = np.zeros(nr, dtype=dt)
    reads = np.zeros(span, dtype=np.int64)
    for c0 in range(0, span, plan.chunk):
        cn = min(plan.chunk, span - c0)
        reads[c0:c0 + cn] += 1
        r = np.arange(c0 // L, (c0 + cn - 1) // L + 1)
        a = np.maximum(r * L, c0)
        n = np.minimum((r + 1) * L, c0 + cn) - a
        lane_sums = np.zeros((r.size, g), dtype=dt)
        for k in range(-(-int(n.max()) // g)):
            t = k * g + np.arange(g)
            inside = t[None, :] < n[:, None]
            term = prod[np.where(inside, a[:, None] + t[None, :], 0)]
            lane_sums = np.where(inside, lane_sums + term, lane_sums)
        o = g // 2
        while o:
            lane_sums = lane_sums + lane_sums[:, np.arange(g) ^ o]
            o //= 2
        acc[r] = acc[r] + lane_sums[:, 0]
    return acc, reads


def ell_block_rows(plan, n_rows, b):
    """The rows block b owns: (first row, count)."""
    r0 = b * plan.rows
    return r0, min(plan.rows, n_rows - r0)


def ell_kernel_model(vals, cols, x, plan):
    """y = A x as the kernel sums it, every block in turn."""
    n_rows, L = vals.shape
    y = np.zeros(n_rows, dtype=vals.dtype)
    if L == 0:
        return y
    for b in range(plan.blocks):
        r0, nr = ell_block_rows(plan, n_rows, b)
        rows = slice(r0, r0 + nr)
        prod = (vals[rows] * x[cols[rows]]).astype(vals.dtype).reshape(-1)
        y[rows] = ell_block_model(prod, L, plan)[0]
    return y
