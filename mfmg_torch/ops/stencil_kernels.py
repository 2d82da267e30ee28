"""Fine-grid stencil kernels K1 and K2: CUDA wrappers, plain versions, build.

Counterpart of mfmg_tpu/ops/pallas_stencil.py for the two kernels on the
main path:

* K1 ``stencil_apply_sym`` replaces ``pallas_stencil_apply_sym``: the
  symmetric-pair stencil apply y = C_0 x + sum_{o>0} [C_o x(i+o) +
  C_o(i-o) x(i-o)] over the gathered center + positive planes.
* K2 ``cheb_smooth`` replaces ``pallas_cheb_smooth``: one whole deal.II
  Chebyshev step x <- x - p(D^-1 A) D^-1 (A x - b), with the V-cycle
  residual A x_s - b on request.

The kernels are hand-written CUDA for Hopper (``csrc/*.cu``), compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library with a
plain C interface at first use (into ``mfmg_torch/_build/<source hash>/``)
and bound with ctypes.  Each wrapper takes its plain PyTorch version for a
tensor on the CPU, launches its kernel for a CUDA tensor, and raises on
anything else; there is no fallback around the build or the launch.  Each
wrapper counts its launches in ``LAUNCHES``.  The same library holds the
fused coarse tail (``csrc/fused_tail.cu``), whose wrappers live in
``ops/fused_cycle.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_POS = 62                      # MFMG_MAX_POS in csrc/stencil_common.cuh

# launches of each CUDA wrapper (one per call that reached its kernel);
# "fused_tail" counts both wrappers of ops/fused_cycle.py
LAUNCHES = {"stencil_apply_sym": 0, "cheb_smooth": 0, "fused_tail": 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------ plain versions

def stencil_apply_sym_plain(planes: torch.Tensor, x: torch.Tensor,
                            pos_offsets, grid_shape) -> torch.Tensor:
    """Plain K1 (mfmg_tpu _stencil_apply_xla_sym): padded slice-sum over the
    center + positive planes; the backward term of each pair is the shifted
    product plane C_o * x.  Accumulates in x's dtype."""
    dim = len(grid_shape)
    xg = x.reshape(grid_shape)
    y = planes[0].to(x.dtype) * xg
    k = max((max(abs(c) for c in off) for off in pos_offsets), default=0)
    if k == 0:
        return y.reshape(x.shape)
    pad = (k,) * (2 * dim)
    xp = F.pad(xg, pad)
    for j, off in enumerate(pos_offsets):
        c = planes[j + 1].to(x.dtype)
        sl_p = tuple(slice(k + o, k + o + n) for o, n in zip(off, grid_shape))
        y = y + c * xp[sl_p]
        sl_m = tuple(slice(k - o, k - o + n) for o, n in zip(off, grid_shape))
        y = y + F.pad(c * xg, pad)[sl_m]
    return y.reshape(x.shape)


def cheb_smooth_plain(planes, x, b, inv_diag, coef, pos_offsets, grid_shape,
                      degree: int, want_res: bool = False):
    """Plain K2: the alpha/beta recurrence of mfmg_tpu pallas_cheb_smooth
    (deal.II PreconditionChebyshev; coef = [alphas..., betas...]).  r stays
    the first residual; p and dx follow the recurrence."""
    def A(v):
        return stencil_apply_sym_plain(planes, v, pos_offsets, grid_shape)

    r = A(x) - b
    p = inv_diag * r
    dx = coef[0] * p
    for i in range(1, degree):
        p = inv_diag * (r - A(dx)) + coef[degree + i] * p
        dx = dx + coef[i] * p
    xs = x - dx
    return (xs, A(xs) - b) if want_res else (xs,)


# ------------------------------------------------------------------ wrappers

def stencil_apply_sym(planes: torch.Tensor, x: torch.Tensor, pos_offsets,
                      grid_shape) -> torch.Tensor:
    """K1: y = A x over the gathered (1 + n_pos, gz, gy, gx) planes."""
    _check_stencil(planes, x, pos_offsets, grid_shape)
    if x.device.type == "cpu":
        return stencil_apply_sym_plain(planes, x, pos_offsets, grid_shape)
    y = torch.empty_like(x)
    gz, gy, gx = grid_shape
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mfmg_stencil_apply_sym(
            planes.data_ptr(), int(planes.dtype == torch.bfloat16),
            x.data_ptr(), None, y.data_ptr(), gz, gy, gx, len(pos_offsets),
            _offset_table(pos_offsets), _stream(x))
    _raise_on(err, "stencil_apply_sym")
    LAUNCHES["stencil_apply_sym"] += 1
    return y


def cheb_smooth(planes: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                inv_diag: torch.Tensor, coef: torch.Tensor, pos_offsets,
                grid_shape, degree: int, want_res: bool = False):
    """K2: (x_s,) or (x_s, A x_s - b) for one Chebyshev step; coef is the
    (2 * degree,) float32 recurrence array [alphas..., betas...]."""
    _check_stencil(planes, x, pos_offsets, grid_shape)
    if degree < 1:
        raise ValueError(f"Chebyshev degree must be >= 1, got {degree}")
    for name, t in (("b", b), ("inv_diag", inv_diag)):
        _check_like(name, t, x)
    if (coef.dtype != torch.float32 or coef.shape != (2 * degree,)
            or coef.device != x.device or not coef.is_contiguous()):
        raise ValueError(f"coef must be a contiguous float32 ({2 * degree},) "
                         f"tensor on {x.device}, got {coef.dtype} "
                         f"{tuple(coef.shape)} on {coef.device}")
    if x.device.type == "cpu":
        return cheb_smooth_plain(planes, x, b, inv_diag, coef, pos_offsets,
                                 grid_shape, degree, want_res)
    r, p, dx0, xs = (torch.empty_like(x) for _ in range(4))
    dx1 = torch.empty_like(x) if degree > 2 else dx0
    res = torch.empty_like(x) if want_res else None
    gz, gy, gx = grid_shape
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.mfmg_cheb_smooth(
            planes.data_ptr(), int(planes.dtype == torch.bfloat16),
            x.data_ptr(), b.data_ptr(), inv_diag.data_ptr(), coef.data_ptr(),
            degree, r.data_ptr(), p.data_ptr(), dx0.data_ptr(), dx1.data_ptr(),
            xs.data_ptr(), None if res is None else res.data_ptr(),
            gz, gy, gx, len(pos_offsets), _offset_table(pos_offsets),
            _stream(x))
    _raise_on(err, "cheb_smooth")
    LAUNCHES["cheb_smooth"] += 1
    return (xs, res) if want_res else (xs,)


def _check_stencil(planes, x, pos_offsets, grid_shape):
    if len(grid_shape) != 3:
        raise ValueError(f"the stencil kernels take 3-D grids, got {grid_shape}")
    n = int(np.prod(grid_shape))
    if x.dtype != torch.float32 or x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 ({n},) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if planes.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"planes must be float32 or bfloat16, got {planes.dtype}")
    want = (1 + len(pos_offsets),) + tuple(grid_shape)
    if tuple(planes.shape) != want or not planes.is_contiguous():
        raise ValueError(f"planes must be contiguous {want}, got "
                         f"{tuple(planes.shape)}")
    if planes.device != x.device:
        raise ValueError(f"planes on {planes.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if len(pos_offsets) > MAX_POS or n >= 2 ** 31:
        raise ValueError(f"{len(pos_offsets)} positive offsets / {n} points "
                         f"exceed the kernel's limits ({MAX_POS} / 2^31)")


def _check_like(name, t, x):
    if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must match x ({x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, contiguous), got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _offset_table(pos_offsets):
    flat = [int(c) for off in pos_offsets for c in off]
    return (ctypes.c_int * max(len(flat), 1))(*flat)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(err: int, name: str):
    if err != 0:
        msg = _library().mfmg_cuda_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({err})")


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


def build_library() -> tuple[Path, str]:
    """Compile csrc/*.cu into the shared library keyed on a hash of the
    sources and flags, unless it exists; returns (path, compiler log).
    Concurrent builders write to private temporaries and rename atomically."""
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
    tmp = out.with_name(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, log


def _library():
    """Build (if needed) and load the kernel library; bind its C interface."""
    global _lib
    if _lib is None:
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.mfmg_stencil_apply_sym.argtypes = [vp, i, vp, vp, vp, i, i, i, i,
                                               ctypes.POINTER(i), vp]
        lib.mfmg_stencil_apply_sym.restype = i
        lib.mfmg_cheb_smooth.argtypes = [vp, i, vp, vp, vp, vp, i, vp, vp, vp,
                                         vp, vp, vp, i, i, i, i,
                                         ctypes.POINTER(i), vp]
        lib.mfmg_cheb_smooth.restype = i
        ip = ctypes.POINTER(i)
        lib.mfmg_fused_tail.argtypes = [i, i, i, vp, vp, vp, vp, vp, vp, vp,
                                        vp, vp, vp, vp, vp, ip, ip, ip, ip, vp]
        lib.mfmg_fused_tail.restype = i
        lib.mfmg_cuda_error_string.argtypes = [i]
        lib.mfmg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
