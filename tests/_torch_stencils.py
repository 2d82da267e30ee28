"""Stencils for the tests and the card scripts (numpy only, no JAX)."""

import itertools

import numpy as np


def cube_offsets(radius, sym=False, sparse=False):
    """The dense radius-r cube of offsets in lexicographic order (as the
    stencil extraction gives them), or its strictly positive half (sym);
    sparse: every third one dropped, as an extracted stencil drops its
    all-zero planes."""
    offs = [o for o in itertools.product(range(-radius, radius + 1), repeat=3)
            if not sym or o > (0, 0, 0)]
    return tuple(o for i, o in enumerate(offs) if not sparse or i % 3 != 1)


def symmetrize(coeffs, offsets, grid_shape):
    """The planes with C_{-o}[i] := C_o[i - o] for every strictly positive
    offset o (first nonzero component > 0), with zero fill where i - o
    leaves the grid: the stencil of a symmetric matrix, bit for bit, so
    that ``detect_symmetry`` finds its positive planes.  coeffs is an
    (n_off,) + grid_shape numpy array; returns a new array."""
    out = np.array(coeffs, copy=True)
    idx = {off: i for i, off in enumerate(offsets)}
    for i, off in enumerate(offsets):
        if not any(off) or next(c for c in off if c != 0) < 0:
            continue
        neg = idx[tuple(-c for c in off)]
        src = tuple(slice(max(0, -o), min(n, n - o)) for o, n in zip(off, grid_shape))
        dst = tuple(slice(max(0, o), min(n, n + o)) for o, n in zip(off, grid_shape))
        out[neg] = 0
        out[neg][dst] = out[i][src]
    return out
