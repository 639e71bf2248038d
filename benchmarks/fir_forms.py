"""What XLA makes of the plain FIR forms on the card, against its roofline.

Times each form of grtpu.ops at two shapes:

  * bench  — the synthetic pipeline's composed filter: 16 rows x 2^20
             samples, 4081 taps (bench.py's composed configs);
  * wbfm   — the WBFM bank's decimating audio filter: 64 rows x 2^18
             samples, 155 taps, decimation 8 (benchmarks/wfm_bench.py).

Forms: the Toeplitz matmul (ops/fir.py) at Precision.HIGHEST and as
split-word bf16x3, and overlap-save on the FFT (ops/fft_filter.py).  For
each: the median of 7 block_until_ready runs after warming, the FLOPs the
form executes and the least bytes it must move (input + output), computed
from the shapes by ``cost`` below; achieved FLOP/s and bytes/s; and the
roofline share, the larger of FLOPs over the peak of the unit the form runs
on and bytes over peak bandwidth, divided by the time (bench.PEAKS, NVIDIA's
published H100 SXM peaks).  The Toeplitz form also materializes its window
matrix; ``window_share`` is the time one write and one read of that window
would take at peak bandwidth, over the measured time.

For calibration the same call times a large bf16 matmul and a large copy.
With ``--trace DIR`` it also writes one jax.profiler trace per form and
prints the device time per kernel name.

Run from the repo root on the GPU:  python benchmarks/fir_forms.py
"""

import argparse
import json
import math
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402

SHAPES = {
    "bench": {"rows": 16, "n": 1 << 20, "taps": "composed", "decim": 1},
    "wbfm": {"rows": 64, "n": 1 << 18, "taps": "wbfm", "decim": 8},
}
FORMS = ("toeplitz-f32", "toeplitz-bf16x3", "fft")
RUNS = 7


def shape_taps(kind):
    from grtpu.ops.fir import compose_taps_power
    from grtpu.utils import firdes

    if kind == "composed":
        taps, _ = bench.taps_and_input(1, 1)
        return compose_taps_power(taps, bench.NSTAGES)
    return firdes.low_pass(1.0, 256e3, 15e3, 4e3).astype(np.float32)


def cost(form, rows, n, k, decim):
    """(executed FLOPs, least bytes, window bytes) of one call on
    ``rows`` inputs of n + k - 1 samples, mirroring ops/fir.py's block
    width B = 128 and ops/fft_filter.py's segment size."""
    nout = n // decim
    least = 4 * rows * (n + k - 1) + 4 * rows * nout
    if form.startswith("toeplitz"):
        b = 128
        m = -(-nout // b)
        kp = -(-k // decim)
        cols = decim * (kp + b - 1)
        flops = 2.0 * rows * m * cols * b
        if form.endswith("bf16x3"):
            flops *= 3
        return flops, least, 4.0 * rows * m * cols
    f = max(2 * (1 << (k - 1).bit_length()), 256)
    seg = -(-n // (f - k + 1))
    flops = rows * seg * (2 * 5.0 * f * math.log2(f) + 6.0 * f)
    return flops, least, 0.0


def form_fn(form, taps, decim):
    import jax
    import jax.numpy as jnp
    from grtpu.ops.fft_filter import fft_filter
    from grtpu.ops.fir import batch_fir_filter

    t = jnp.asarray(taps)
    if form == "fft":
        return jax.vmap(lambda r: fft_filter(r, t, decim))
    return lambda x: batch_fir_filter(x, t, decim)


def timed(fn, x):
    """Warm ``fn`` on ``x``, then the median of RUNS block_until_ready
    calls (bench.time_runs)."""
    import jax

    jax.block_until_ready(fn(x))
    jax.block_until_ready(fn(x))
    return bench.time_runs(fn, x, RUNS)


def calibrate(peaks):
    """What a large plain bf16 matmul and a large copy reach on this card."""
    import jax
    import jax.numpy as jnp

    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda p, q: jnp.dot(p, q, preferred_element_type=jnp.float32))
    sec = timed(lambda p: mm(p, p), a)
    big = jnp.ones((1 << 28,), jnp.float32)               # 1 GiB
    cp = jax.jit(lambda v: v * 1.0000001)
    sec_c = timed(cp, big)
    return {"bf16_matmul_tflops": 2.0 * n ** 3 / sec / 1e12,
            "bf16_matmul_share": 2.0 * n ** 3 / sec / peaks["bf16_flops"],
            "copy_gbytes_per_s": 2 * big.nbytes / sec_c / 1e9,
            "copy_share": 2 * big.nbytes / sec_c / peaks["hbm_bytes_per_s"]}


def device_time_by_name(trace_dir, top=8):
    """Sum of device event durations per name in the newest trace."""
    import glob

    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    prof = jax.profiler.ProfileData.from_file(paths[-1])
    tot = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", help="write one profiler trace per form here")
    ap.add_argument("-o", "--output",
                    default=os.path.join(ROOT, "out", "fir_forms.json"))
    args = ap.parse_args()
    devs = bench.require_gpu()
    from grtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    peaks = bench.peaks_for(devs[0].device_kind)
    dev = bench.device_record(devs)
    print(f"# card: {dev['nvidia_smi']}", file=sys.stderr, flush=True)
    records = [{"calibration": calibrate(peaks), "device": dev}]
    print(json.dumps(records[0]), flush=True)
    unit_peak = {"toeplitz-f32": "f32_flops", "toeplitz-bf16x3": "bf16_flops",
                 "fft": "f32_flops"}
    for sname, sh in SHAPES.items():
        taps = shape_taps(sh["taps"])
        k, d = len(taps), sh["decim"]
        x = jnp.asarray(np.random.RandomState(0).randn(
            sh["rows"], sh["n"] + k - 1).astype(np.float32))
        for form in FORMS:
            mode = "bf16x3" if form.endswith("bf16x3") else "f32"
            t0 = time.perf_counter()
            with bench.fir_precision(mode):
                fn = jax.jit(form_fn(form, taps, d)).lower(x).compile()
            compile_s = time.perf_counter() - t0
            med = timed(fn, x)
            flops, least, window = cost(form, sh["rows"], sh["n"], k, d)
            fbound = flops / peaks[unit_peak[form]]
            bbound = least / peaks["hbm_bytes_per_s"]
            rec = {
                "shape": sname, "form": form, "rows": sh["rows"],
                "n": sh["n"], "taps": k, "decim": d,
                "seconds_median": med,
                "compile_s": compile_s,
                "flops": flops, "tflops_per_s": flops / med / 1e12,
                "least_bytes": least, "gbytes_per_s": least / med / 1e9,
                "flop_peak_share": fbound / med,
                "byte_peak_share": bbound / med,
                "roofline_share": max(fbound, bbound) / med,
                "bound": "flops" if fbound >= bbound else "bytes",
                "window_bytes": window,
                "window_share": 2 * window / peaks["hbm_bytes_per_s"] / med,
                "msamples_per_s": sh["rows"] * sh["n"] / med / 1e6,
                "temp_bytes": fn.memory_analysis().temp_size_in_bytes,
            }
            if args.trace:
                tdir = os.path.join(args.trace, f"{sname}-{form}")
                jax.block_until_ready(fn(x))
                with jax.profiler.trace(tdir):
                    jax.block_until_ready(fn(x))
                rec["device_ms_by_kernel"] = device_time_by_name(tdir)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w") as f:
        json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
