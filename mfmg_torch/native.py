"""ctypes bindings of the port's host library (``csrc/host/mfmg_host.cpp``).

The library is the setup's host hot paths in framework-neutral C++: the
batched agglomerate assembly, the stencil extraction scatter, the
per-agglomerate restriction blocks, the per-super Galerkin/Gram scatter,
the CSR -> ELL packing and the greedy coloring of an ELL adjacency.
It is compiled at first use with

    g++ -O3 -march=native -shared -fPIC -pthread mfmg_host.cpp

into ``mfmg_torch/_build/host-<key>/libmfmg_host.so``, the key hashing the
source, the flags and what ``-march=native`` expands to on this host (a
build directory copied to another host is not reused there).  A failed
build raises: there is no numpy fallback.  The numpy versions of the same
functions stay beside their callers as the plain versions the tests hold
these wrappers against.

Each parallel call starts one thread per core of the process's affinity
mask (``host_threads()``); the callers run them outside the thread pools
of ``utils/threads.py``, so the two never run at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "host" / "mfmg_host.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_lib = None


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the host library "
                           f"{SRC} cannot be built")
    return gxx


def _target_key(gxx: str) -> bytes:
    """What -march=native expands to here (the target options of the
    cc1plus line of ``g++ -###``: -march, -m and --param with the cache
    sizes), so that a library built for another CPU is never loaded."""
    out = subprocess.run([gxx, "-###", "-march=native", "-x", "c++", "-c",
                          os.devnull, "-o", os.devnull],
                         capture_output=True, text=True, timeout=60)
    words = " ".join(ln for ln in out.stderr.splitlines()
                     if "cc1plus" in ln).replace('"', "").split()
    target = [w for i, w in enumerate(words)
              if w.startswith("-m") or words[i - 1] == "--param"]
    return " ".join(target or [out.stderr]).encode()


def build_host_library() -> Path:
    """Compile the host library unless this key's build exists; returns its
    path.  Concurrent builders write private temporaries and rename them
    atomically."""
    gxx = _gxx()
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_target_key(gxx))
    out = BUILD_DIR / f"host-{h.hexdigest()[:16]}" / "libmfmg_host.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{os.getpid()}.tmp.so")
    res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}) building {SRC}:\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    """Build (if needed) and load the host library; bind its C interface."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_host_library()))
        i64 = ctypes.POINTER(ctypes.c_int64)
        f64 = ctypes.POINTER(ctypes.c_double)
        f32 = ctypes.POINTER(ctypes.c_float)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        n = ctypes.c_int64
        lib.mfmg_host_threads.argtypes = []
        lib.mfmg_host_threads.restype = n
        lib.assemble_agglomerate_batch_uniform.argtypes = [i64, i64, f64, f64,
                                                           n, n, n, n]
        lib.assemble_agglomerate_batch_uniform_f32.argtypes = [i64, i64, f64,
                                                               f32, n, n, n, n]
        lib.stencil_scatter.argtypes = [i64, i64, f64, f64, n, n, n, n]
        lib.agg_row_count.argtypes = [i64, u8, i64, n, n, n, i64]
        lib.agg_row_blocks.argtypes = [i64, u8, u8, i64, f64, n, n, n, n, i64,
                                       f64]
        lib.scatter_super_blocks.argtypes = [i64, i64, f32, f64, f64, f64,
                                             n, n, n]
        lib.scatter_super_blocks_f64.argtypes = [i64, i64, f64, f64, f64, f64,
                                                 n, n, n]
        lib.ell_pack.argtypes = [i64, i32, f64, f64, i32, n, n]
        lib.greedy_color.argtypes = [i32, f64, i32, n, n]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def host_threads() -> int:
    """Threads each parallel call of the library starts."""
    return int(_library().mfmg_host_threads())


def assemble_agglomerate_batch_uniform(cells_per_agg, local_cells, A_loc,
                                       n_agg: int, m: int,
                                       dtype=np.float64) -> np.ndarray:
    """(n_agg, m, m) dense batch, float64 or float32:
    A[g, lc[c, i], lc[c, j]] += A_loc[cells_per_agg[g, c], i, j], summed
    over the block's cells in order (in the output's type)."""
    lib = _library()
    cells_per_agg = _c(cells_per_agg, np.int64)
    local_cells = _c(local_cells, np.int64)
    A_loc = _c(A_loc, np.float64)
    n_bc, n_loc = local_cells.shape
    out = np.zeros((n_agg, m, m), dtype=dtype)
    if out.dtype == np.float32:
        fn, ct = lib.assemble_agglomerate_batch_uniform_f32, ctypes.c_float
    elif out.dtype == np.float64:
        fn, ct = lib.assemble_agglomerate_batch_uniform, ctypes.c_double
    else:
        raise ValueError(f"batch dtype {out.dtype} is neither float32 nor "
                         f"float64")
    fn(_ptr(cells_per_agg, ctypes.c_int64), _ptr(local_cells, ctypes.c_int64),
       _ptr(A_loc, ctypes.c_double), _ptr(out, ct), n_agg, n_bc, n_loc, m)
    return out


def stencil_scatter(rows, oid_ab, A_loc, n_planes: int,
                    n_nodes: int) -> np.ndarray:
    """(n_planes, n_nodes) float64: coeffs[oid_ab[a, b], rows[c, a]] +=
    A_loc[c, a, b] over every (c, a, b)."""
    lib = _library()
    rows = _c(rows, np.int64)
    oid_ab = _c(oid_ab, np.int64)
    A_loc = _c(A_loc, np.float64)
    n_cells, n_loc = rows.shape
    out = np.zeros((n_planes, n_nodes))
    lib.stencil_scatter(_ptr(rows, ctypes.c_int64), _ptr(oid_ab, ctypes.c_int64),
                        _ptr(A_loc, ctypes.c_double), _ptr(out, ctypes.c_double),
                        n_cells, n_loc, n_planes, n_nodes)
    return out


def agg_row_count(dm, valid, dof_rows) -> np.ndarray:
    """(n_agg,) int64: the number of distinct R rows (dof_rows entries >= 0)
    over each agglomerate's valid dofs."""
    lib = _library()
    dm = _c(dm, np.int64)
    valid = _c(valid, np.uint8)
    dof_rows = _c(dof_rows, np.int64)
    n_agg, m = dm.shape
    t_s = np.zeros(n_agg, dtype=np.int64)
    lib.agg_row_count(_ptr(dm, ctypes.c_int64), _ptr(valid, ctypes.c_uint8),
                      _ptr(dof_rows, ctypes.c_int64), n_agg, m,
                      dof_rows.shape[1], _ptr(t_s, ctypes.c_int64))
    return t_s


def agg_row_blocks(dm, valid, keep, dof_rows, dof_vals):
    """Per-agglomerate sorted unique R rows and dense R blocks:
    (arows (n_agg, t_max) int64, t_s (n_agg,) int64, Rb (n_agg, t_max, m)
    float64 with Rb[a, t, i] = R[arows[a, t], dm[a, i]] where keep, else 0)."""
    lib = _library()
    dm = _c(dm, np.int64)
    valid = _c(valid, np.uint8)
    keep = _c(keep, np.uint8)
    dof_rows = _c(dof_rows, np.int64)
    dof_vals = _c(dof_vals, np.float64)
    n_agg, m = dm.shape
    q = dof_rows.shape[1]
    t_s = agg_row_count(dm, valid, dof_rows)
    t_max = int(t_s.max()) if n_agg else 0
    arows = np.zeros((n_agg, t_max), dtype=np.int64)
    Rb = np.zeros((n_agg, t_max, m))
    lib.agg_row_blocks(_ptr(dm, ctypes.c_int64), _ptr(valid, ctypes.c_uint8),
                       _ptr(keep, ctypes.c_uint8),
                       _ptr(dof_rows, ctypes.c_int64),
                       _ptr(dof_vals, ctypes.c_double), n_agg, m, q, t_max,
                       _ptr(arows, ctypes.c_int64), _ptr(Rb, ctypes.c_double))
    return arows, t_s, Rb


def scatter_super_blocks(g_of, gpos, K, Mb, n_super: int, m1p: int,
                         out=None):
    """Per-super padded batches (A1, M), each (n_super, m1p, m1p) float64:
    A1[g_of[a], gpos[a, i], gpos[a, j]] += K[a, i, j] and the same for Mb,
    serial over agglomerates in order.  K float32 or float64.  out: a pair
    of C-contiguous float64 arrays of that shape to add into (a scatter in
    chunks), else both start at zero."""
    lib = _library()
    g_of = _c(g_of, np.int64)
    gpos = _c(gpos, np.int64)
    Mb = _c(Mb, np.float64)
    n_agg, t_max = gpos.shape
    if out is None:
        A1 = np.zeros((n_super, m1p, m1p))
        M = np.zeros((n_super, m1p, m1p))
    else:
        A1, M = out
        for a in (A1, M):
            if (a.dtype != np.float64 or a.shape != (n_super, m1p, m1p)
                    or not a.flags.c_contiguous):
                raise ValueError(f"out arrays must be C-contiguous float64 "
                                 f"{(n_super, m1p, m1p)}, not {a.dtype} "
                                 f"{a.shape}")
    if K.dtype == np.float32:
        K = _c(K, np.float32)
        fn, ct = lib.scatter_super_blocks, ctypes.c_float
    else:
        K = _c(K, np.float64)
        fn, ct = lib.scatter_super_blocks_f64, ctypes.c_double
    fn(_ptr(g_of, ctypes.c_int64), _ptr(gpos, ctypes.c_int64), _ptr(K, ct),
       _ptr(Mb, ctypes.c_double), _ptr(A1, ctypes.c_double),
       _ptr(M, ctypes.c_double), n_agg, t_max, m1p)
    return A1, M


def ell_pack(indptr, indices, data, n_rows: int, L: int):
    """CSR -> ELL: (vals (n_rows, L) float64, cols (n_rows, L) int32), each
    row's entries in CSR order, the padding zero (value and column)."""
    lib = _library()
    indptr = _c(indptr, np.int64)
    indices = _c(indices, np.int32)
    data = _c(data, np.float64)
    if indptr.shape != (n_rows + 1,) or indices.shape != data.shape:
        raise ValueError(f"ell_pack: indptr {indptr.shape} for {n_rows} rows, "
                         f"indices {indices.shape}, data {data.shape}")
    if n_rows and int(np.diff(indptr).max()) > L:
        raise ValueError(f"ell_pack: a row holds more than L={L} entries")
    vals = np.zeros((n_rows, L))
    cols = np.zeros((n_rows, L), dtype=np.int32)
    lib.ell_pack(_ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                 _ptr(data, ctypes.c_double), _ptr(vals, ctypes.c_double),
                 _ptr(cols, ctypes.c_int32), n_rows, L)
    return vals, cols


def greedy_color(cols, vals) -> np.ndarray:
    """Sequential first-fit distance-1 coloring of an (n, L) ELL adjacency
    (entries with value 0 and the diagonal skipped), rows in order:
    (n,) int32 colors."""
    lib = _library()
    cols = _c(cols, np.int32)
    vals = _c(vals, np.float64)
    if cols.shape != vals.shape or cols.ndim != 2:
        raise ValueError(f"greedy_color: cols {cols.shape}, vals {vals.shape}")
    n, L = cols.shape
    colors = np.full(n, -1, dtype=np.int32)
    lib.greedy_color(_ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_double),
                     _ptr(colors, ctypes.c_int32), n, L)
    return colors
