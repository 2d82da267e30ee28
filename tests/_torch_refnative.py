"""The reference's host library in a build private to the test process.

mfmg_tpu/native.py compiles native/mfmg_host.cpp straight onto
native/libmfmg_host.so at first use and keeps a failed load for the life
of the process.  Test workers that start together on a fresh tree can load
a half-written file; mfmg_tpu then colors ELL matrices by its Luby
fallback and its ``greedy_color`` returns None, while the port always uses
its own host library.  A port test that compares with a reference function
whose result depends on mfmg_tpu.native therefore takes the reference with
its native library (its intended state) from here:

- ``reference_native`` (module-scoped fixture): builds the reference's own
  unchanged source with the reference's flags into a directory of pytest's
  ``tmp_path_factory`` (once per process), points ``mfmg_tpu.native._SO`` at
  it, resets ``_tried``/``_lib`` and loads it; the test fails with the
  loader's reason if that load gives None (never a skip, never the
  fallback).  The previous ``_SO``, ``_tried`` and ``_lib`` come back after
  the module.
- ``load_reference_native(build_dir)``: the same load, for a test that sets
  the loader's state itself; returns a function that restores it.

mfmg_tpu's source is not touched.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess

import pytest

# mfmg_tpu/native.py:35-36
REFERENCE_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_built = {}


def _build(build_dir) -> str:
    from mfmg_tpu import native as jnative
    key = str(build_dir)
    if key not in _built:
        so = os.path.join(key, "libmfmg_host.so")
        tmp = so + ".tmp"
        done = subprocess.run(["g++", *REFERENCE_FLAGS, jnative._SRC, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if done.returncode != 0:
            pytest.fail(f"building the reference's {jnative._SRC} failed: "
                        f"{done.stderr.strip()}")
        os.replace(tmp, so)
        _built[key] = so
    return _built[key]


def load_reference_native(build_dir):
    """Load the reference's host library from a private build under
    build_dir; fail the test with the loader's reason if it gives None.
    Returns a function that restores the loader's previous state."""
    from mfmg_tpu import native as jnative
    saved = (jnative._SO, jnative._tried, jnative._lib)

    def restore():
        jnative._SO, jnative._tried, jnative._lib = saved

    jnative._SO = _build(build_dir)
    jnative._tried, jnative._lib = False, None
    reason = io.StringIO()
    with contextlib.redirect_stderr(reason):
        lib = jnative._load()
    if lib is None:
        restore()
        why = reason.getvalue().strip() or (
            "MFMG_TPU_NO_NATIVE is set" if os.environ.get("MFMG_TPU_NO_NATIVE")
            else "no reason printed")
        pytest.fail(f"mfmg_tpu.native did not load {jnative._SO}: {why}")
    return restore


_dirs = {}


def reference_native_dir(tmp_path_factory):
    """The process's build directory of the reference's host library."""
    if "dir" not in _dirs:
        _dirs["dir"] = tmp_path_factory.mktemp("reference_native")
    return _dirs["dir"]


@pytest.fixture(scope="module")
def reference_native(tmp_path_factory):
    """mfmg_tpu.native loaded from this process's own build for the module."""
    restore = load_reference_native(reference_native_dir(tmp_path_factory))
    from mfmg_tpu import native as jnative
    yield jnative._lib
    restore()
