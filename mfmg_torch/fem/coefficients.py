"""Material-property (diffusion coefficient) families.

Vectorized numpy analogs (copied from mfmg_tpu/fem/coefficients.py) of the four coefficient classes used across the
reference test suite (reference tests/test_hierarchy_helpers.hpp:75-188):
constant, linear, linear_x, discontinuous.  Each takes points of shape
(..., dim) and returns (...,).
"""

from __future__ import annotations

import numpy as np


def constant(p):
    return np.ones(p.shape[:-1])


def linear_x(p):
    # 1 + |x| (test_hierarchy_helpers.hpp:113-117)
    return 1.0 + np.abs(p[..., 0])


def linear(p):
    # 1 + sum_d (1+d)|p_d| (test_hierarchy_helpers.hpp:140-148)
    dim = p.shape[-1]
    val = np.ones(p.shape[:-1])
    for d in range(dim):
        val = val + (1.0 + d) * np.abs(p[..., d])
    return val


def discontinuous(p):
    # checkerboard at scale 1/100: 100 where all floor(100 p_d) odd, else 10
    # (test_hierarchy_helpers.hpp:178-187)
    dim = p.shape[-1]
    dim_scale = np.zeros(p.shape[:-1], dtype=np.int64)
    for d in range(dim):
        dim_scale += np.floor(p[..., d] * 100.0).astype(np.int64) % 2
    return np.where(dim_scale == dim, 100.0, 10.0)


FAMILIES = {
    "constant": constant,
    "linear": linear,
    "linear_x": linear_x,
    "discontinuous": discontinuous,
}


def get(name: str):
    try:
        return FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown material property '{name}'; options: {sorted(FAMILIES)}")
