"""Host threading helpers.

Setup-time host work (batched LAPACK eigensolves, BLAS-3 block products)
is threaded at the outer loop; BLAS-internal threads must then be pinned
to 1 or OpenBLAS oversubscribes the cores (on a 2-core VM this showed up
as 4x run-to-run variance in the Galerkin product).
"""

from __future__ import annotations

import contextlib


def blas_single_thread():
    """Context manager limiting BLAS/OpenMP pools to 1 thread (no-op when
    threadpoolctl is unavailable)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return contextlib.nullcontext()
    return threadpool_limits(limits=1)
