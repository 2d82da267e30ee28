"""The port's CUDA kernel library: its build, its loader and the one launch
path of every kernel wrapper.

The kernels (``csrc/*.cu``, hand-written for Hopper) are compiled at first
use into one shared library with a plain C interface, keyed on a hash of the
sources (``mfmg_torch/_build/<hash>/``), and loaded with ctypes.  Every C
entry point takes the stream last and returns a CUDA error code.  A wrapper
module declares its entry points beside its wrapper (``Entry``) and calls
them through ``launch``, which appends the card's raw current stream,
switches device only when that card is not current (on an H100 machine's
host ``torch.cuda.current_stream(d)`` and ``torch.cuda.device(d)`` took ~8
us a call each, more than a small kernel's device time), raises on an error
and counts the launch in ``LAUNCHES``.  There is no fallback around the
build or the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the H100's SM count: the plans' default where no card is asked
H100_SMS = 132

# launches of each CUDA wrapper (one per call that reached its kernel);
# "fused_tail" counts both entries of ops/fused_cycle.py; "cheb_smooth"
# counts K2's calls of either form, "cheb_smooth_blocked"/"_chain" each form's;
# "ell_spmv" the ELL applies of ops/sparse.py on the card; "sumfac" the
# calls of ops/sumfac.py's kernel (its cell and node passes, one call)
LAUNCHES = {"stencil_apply_sym": 0, "cheb_smooth": 0, "cheb_smooth_blocked": 0,
            "cheb_smooth_chain": 0, "fused_tail": 0, "stencil_apply": 0,
            "structured_restrict": 0, "structured_prolong": 0, "ell_spmv": 0,
            "sumfac": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ints(vals):
    """The values as a C int array (one element at least)."""
    vals = [int(v) for v in vals]
    return (ctypes.c_int * max(len(vals), 1))(*vals)


# The tables below are made once per tuple: the fine applies launch every few
# tens of microseconds, and rebuilding a 375-entry table on every call costs
# the host as much.
@functools.lru_cache(maxsize=None)
def int_table(vals: tuple):
    """A tuple of ints (a plan, a geometry) as a C int array."""
    return ints(vals)


@functools.lru_cache(maxsize=None)
def offset_table(offsets):
    """A tuple of offset tuples, flattened into a C int array."""
    return ints(c for off in offsets for c in off)


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class Entry:
    """A C entry point ``int name(argtypes..., cudaStream_t)`` of the
    library, bound at its first launch."""

    __slots__ = ("name", "argtypes", "fn")

    def __init__(self, name: str, *argtypes):
        self.name, self.argtypes, self.fn = name, argtypes, None


def launch(entry: Entry, counter: str, dev: int, *args) -> None:
    """Call ``entry`` with ``args`` and the current stream of card ``dev``
    (a device index), on that card; raise on its error, else count one
    launch under ``counter``."""
    fn = entry.fn
    if fn is None:
        fn = entry.fn = getattr(library(), entry.name)
        fn.argtypes = [*entry.argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if dev == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        msg = library().mfmg_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {entry.name} failed: {msg} ({err})")
    LAUNCHES[counter] += 1


# --------------------------------------------------------------------- build

def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "mfmg_torch are built from csrc/ at first use")


def _run_all(cmds):
    """Run the commands in parallel; (return codes, logs) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], logs


def build_library() -> tuple[Path, str]:
    """Compile csrc/*.cu into the shared library keyed on a hash of the
    sources and flags, unless it exists; returns (path, compiler log).  One
    nvcc per source, all started together, then one link.  Concurrent
    builders write to private temporaries and rename atomically."""
    cu, cuh = sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / h.hexdigest()[:16] / "libmfmg_kernels.so"
    log_path = out.with_name("build.log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out.with_name(f".{pid}.{p.stem}.o") for p in cu]
    tmp = out.with_name(f".{pid}.tmp.so")
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(cu, objs)]
    rcs, logs = _run_all(cmds)
    if all(rc == 0 for rc in rcs):
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        rc, link_log = _run_all(cmds[-1:])
        rcs, logs = rcs + rc, logs + link_log
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(logs)
    for cmd, rc, lg in zip(cmds, rcs, logs):
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{lg}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def library():
    """Build (if needed) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()[0]))
        lib.mfmg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mfmg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
