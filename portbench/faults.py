"""Faults planted underneath a request's timed path, for the tests and for
control.py's readings at a cell's own size: each replaces the answer that
the program's method (``Hierarchy.solve_cg`` for a solve,
``Hierarchy.vmult`` for a preconditioner apply) produced.

  state_unchanged  the answer is the state the method starts from (zero);
  half_left_out    the second half of the answer is left out (zero);
  answer_altered   a solve's answer scaled by 1.01; an apply's answer that of
                   the request before it (a stale buffer).
"""

from __future__ import annotations

import contextlib

import torch

METHOD = {"solve": "solve_cg", "vmult": "vmult"}


def _half(x):
    x = x.clone()
    x[x.shape[0] // 2:] = 0
    return x


def _stale():
    last = [None]

    def alter(y):
        out = torch.zeros_like(y) if last[0] is None else last[0]
        last[0] = y
        return out
    return alter


ALTER = {
    "solve": {"state_unchanged": lambda: torch.zeros_like,
              "half_left_out": lambda: _half,
              "answer_altered": lambda: (lambda x: x * (1 + 1e-2))},
    "vmult": {"state_unchanged": lambda: torch.zeros_like,
              "half_left_out": lambda: _half,
              "answer_altered": _stale},
}


@contextlib.contextmanager
def planted(request: str, fault: str):
    """Within the block, the program's method for ``request`` answers with
    ``fault``."""
    from mfmg_torch.amge.hierarchy import Hierarchy
    name = METHOD[request]
    real = getattr(Hierarchy, name)
    alter = ALTER[request][fault]()

    def broken(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if isinstance(out, tuple):
            return (alter(out[0]),) + tuple(out[1:])
        return alter(out)
    setattr(Hierarchy, name, broken)
    try:
        yield
    finally:
        setattr(Hierarchy, name, real)
