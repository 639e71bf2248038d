"""mp-sched sweep harness — the run_synthetic.py analog.

Analog of gnuradio-examples/python/mp-sched/run_synthetic.py: sweeps the
(npipes, nstages) grid of the synthetic 256-tap FIR pipeline and writes
rows in the reference's exact .dat format:

    npipes nstages nsamples real user sys (user+sys)/real flop flop/s

so the output is directly comparable with the published perf-data files
(BASELINE.md).  Each point runs bench.py's composed-fft form (the fastest
that passes bench.py's SNR gate on the H100, PERF.md) and `real` is the
median of bench.py's block_until_ready runs; user/sys are
host-process times over those runs (the GPU does the work, so load ~ 0 by
design).

Run from the repo root on the GPU:
    python benchmarks/run_synthetic.py [--max-pipes 8] [--max-stages 8] \
        [--samples 1048576] [-o synthetic.dat]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

FORM = "composed-fft"


def measure(npipes, nstages, nsamples, taps):
    """(median seconds per pipeline pass, user s, sys s) for one point."""
    import jax.numpy as jnp

    x = jnp.asarray(
        np.random.RandomState(1).randn(npipes, nsamples).astype(np.float32))
    fn = bench.compile_config(FORM, taps, nstages, x.shape)
    fn(x).block_until_ready()
    u0 = os.times()
    real = bench.time_runs(fn, x)
    u1 = os.times()
    return (real, (u1.user - u0.user) / bench.RUNS,
            (u1.system - u0.system) / bench.RUNS)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-pipes", type=int, default=8)
    ap.add_argument("--max-stages", type=int, default=8)
    ap.add_argument("--samples", type=int, default=1 << 20)
    ap.add_argument("--step", type=int, default=4,
                    help="grid stride (sweep 1, step, 2*step, ...)")
    ap.add_argument("-o", "--output", default="synthetic.dat")
    args = ap.parse_args()

    bench.require_gpu()
    from grtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    taps, _ = bench.taps_and_input(1, 1)
    grid = sorted({1, *range(args.step, args.max_pipes + 1, args.step)})
    sgrid = sorted({1, *range(args.step, args.max_stages + 1, args.step)})

    rows = []
    for npipes in grid:
        for nstages in sgrid:
            real, user, syst = measure(npipes, nstages, args.samples, taps)
            load = (user + syst) / real
            flop = 2.0 * bench.NTAPS * npipes * nstages * args.samples
            row = (f"{npipes} {nstages} {args.samples} {real:.6f} "
                   f"{user:.6f} {syst:.6f} {load:.2f} {flop:.3e} "
                   f"{flop / real:.3e}")
            print(row)
            rows.append(row)
    with open(args.output, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
