"""Host threading helpers.

Setup-time host work (batched LAPACK eigensolves, ARPACK per agglomerate,
BLAS-3 block products) is threaded at the outer loop; BLAS-internal threads
must then be pinned to 1 or OpenBLAS oversubscribes the cores (on a 2-core
VM this showed up as 4x run-to-run variance in the Galerkin product; ARPACK
makes hundreds of tiny BLAS calls per agglomerate, each of which would wake
a pool of BLAS threads).
"""

from __future__ import annotations

import ctypes


def blas_single_thread():
    """Context manager limiting BLAS/OpenMP pools to 1 thread: threadpoolctl
    where it is installed, else every loaded OpenBLAS through its own
    set_num_threads (``_OpenBLASThreads``)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return _OpenBLASThreads(1)
    return threadpool_limits(limits=1)


class _OpenBLASThreads:
    """Every OpenBLAS mapped into the process (numpy's and scipy's bundled
    copies, whose symbols carry a prefix) set to n threads for the block,
    then restored; a process without OpenBLAS is left as it is."""

    _PREFIXES = ("", "scipy_")
    _SUFFIXES = ("", "64_")

    def __init__(self, n: int):
        self.n = n
        self._saved = []

    @staticmethod
    def _libraries():
        try:
            with open("/proc/self/maps") as f:
                paths = {line.split()[-1] for line in f
                         if "openblas" in line.lower() and "/" in line}
        except OSError:
            return []
        return sorted(paths)

    def _pair(self, lib):
        for pre in self._PREFIXES:
            for suf in self._SUFFIXES:
                get = getattr(lib, f"{pre}openblas_get_num_threads{suf}", None)
                put = getattr(lib, f"{pre}openblas_set_num_threads{suf}", None)
                if get is not None and put is not None:
                    return get, put
        return None

    def __enter__(self):
        for path in self._libraries():
            try:
                pair = self._pair(ctypes.CDLL(path))
            except OSError:
                continue
            if pair is not None:
                get, put = pair
                self._saved.append((put, int(get())))
                put(self.n)
        return self

    def __exit__(self, *exc):
        for put, n in self._saved:
            put(n)
        self._saved.clear()

