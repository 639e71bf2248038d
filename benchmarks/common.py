"""Pieces shared by the chain benchmarks in this directory.

Each bench runs from the repo root (``python benchmarks/<name>.py``), calls
:func:`setup` before its first compile, prints its results with
:func:`emit`, and times device loops with :func:`slope_seconds`.

Why a slope and not ``bench.time_runs``: a chain bench chains ``m``
iterations in one jitted loop and reads one scalar back.  A call's launch
and readback cost a fixed amount of host time, which for the smaller
chains (one DMR bank, one trellis block) is of the order of one
iteration; the slope between two loop lengths cancels it.  ``bench.py``
and ``fir_forms.py`` time single large calls, where it is small, with the
``block_until_ready`` median of ``bench.time_runs``.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DEVICE = None


def setup():
    """Make ``grtpu`` importable, exit nonzero unless JAX has a GPU, and
    turn on the persistent compile cache.  Returns the device record that
    :func:`emit` puts in every line."""
    global _DEVICE
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import bench
    from grtpu.utils.compile_cache import enable_compile_cache

    _DEVICE = bench.device_record(bench.require_gpu())
    enable_compile_cache()
    return _DEVICE


def emit(rec):
    """Print one result as a JSON line, with the device it was taken on."""
    if _DEVICE is None:
        raise RuntimeError("call setup() before emit()")
    print(json.dumps({**rec, "device": _DEVICE}), flush=True)


def slope_seconds(run, m_big, m_small=1, rounds=4):
    """Per-iteration time of ``run(m)``: a call that chains ``m`` iterations
    in one jitted loop and returns once its result has reached the host.

    The difference between two loop lengths cancels the fixed dispatch and
    readback cost.  Both lengths are warmed first; the median over
    ``rounds`` paired readings is returned.  Raises if no round gave a
    positive slope: such a reading is noise, not a time."""
    run(m_small)
    run(m_big)
    vals = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        run(m_small)
        t1 = time.perf_counter()
        run(m_big)
        t2 = time.perf_counter()
        s = ((t2 - t1) - (t1 - t0)) / (m_big - m_small)
        if s > 0:
            vals.append(s)
    if not vals:
        raise RuntimeError(
            f"no positive slope in {rounds} rounds (m={m_small},{m_big}): "
            f"lengthen the loop")
    return float(np.median(vals))
