"""Headline benchmark: the reference's mp-sched synthetic FIR pipeline.

Reproduces gnuradio-examples/python/mp-sched/synthetic.py (the only workload
with published numbers, BASELINE.md): npipes parallel pipelines of nstages
serial 256-tap real FIR filters; FLOP = 2*ntaps*npipes*nstages*nsamples
(synthetic.py:76).  Baseline to beat: 74.37 GFLOPS peak (2x quad Xeon E5472,
perf-data/dual-quad-core-3.00-penryn.dat:1).

The pipeline runs through the plain XLA forms of grtpu.ops (no hand-written
kernel), each a config below:

  * cascade-toeplitz-f32 — the 16 stages one after another, each a Toeplitz
    matmul (ops/fir.py batch_fir_filter at Precision.HIGHEST).  It is the
    check on composition.
  * composed-toeplitz-f32 / -bf16x3 — the 16 LTI stages composed into one
    4081-tap filter (ops/fir.py compose_taps_power; exact in exact
    arithmetic) applied as one Toeplitz matmul, at HIGHEST or as three
    split-word bf16 passes (ops/fir.py set_precision("bf16x3")).
  * composed-fft — the composed filter by overlap-save on the FFT
    (ops/fft_filter.py).

Every config's chain output is compared with a float64 reference chain on
two rows at full length; a config passes if its SNR is >= 50 dB (well above
the sensitivity floor of every model chain in this repo).  The reported
number is the fastest passing config, with FLOPs counted algorithmically
(2*ntaps per output sample per stage) exactly as the reference counts them,
whatever the config: composition is a graph-level rewrite of the same
function.  If no config passes, the run fails.

Timing: every config is compiled and warmed, then run at least 5 times, each
ending in jax.block_until_ready; the median is reported.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}.  Refuses to run without a GPU.
"""

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

NTAPS = 256
NPIPES = 16
NSTAGES = 16
NSAMPLES = 1 << 20
SNR_GATE_DB = 50.0
SNR_ROWS = 2
RUNS = 5
BASELINE = 74.37  # GFLOPS, BASELINE.md best published

CONFIGS = ("cascade-toeplitz-f32", "composed-toeplitz-f32",
           "composed-toeplitz-bf16x3", "composed-fft")

# Published dense peaks, NVIDIA H100 SXM data sheet (full 700 W limit),
# keyed by jax's device_kind.  A device not in the table is an error.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_kind):
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for {device_kind!r}; add them "
                       f"to bench.PEAKS with their source") from None


def card_info():
    """The card's name and power limit as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return r.stdout.strip()


def require_gpu(n=1):
    """Return jax's device list; exit nonzero unless it holds ``n`` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"no GPU: jax found {devs[0].platform!r} devices only")
    if len(devs) < n:
        sys.exit(f"need {n} GPUs, jax found {len(devs)}")
    return devs


def device_record(devs):
    d = devs[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs), "nvidia_smi": card_info()}


@contextlib.contextmanager
def fir_precision(mode):
    """ops/fir.py's matmul mode while a function is traced."""
    from grtpu.ops import fir

    prev = fir._PRECISION
    fir.set_precision(mode)
    try:
        yield
    finally:
        fir.set_precision(prev)


def pipeline_fn(config, taps, nstages):
    """(P, N) float32 -> (P, N) float32: ``nstages`` cascaded FIRs with zero
    initial history, in the given config's form."""
    import jax.numpy as jnp
    from grtpu.ops.fft_filter import fft_filter
    from grtpu.ops.fir import batch_fir_filter, compose_taps_power
    import jax

    def apply(x, t, form):
        k = len(t)
        xh = jnp.pad(x, ((0, 0), (k - 1, 0)))
        if form == "fft":
            return jax.vmap(lambda r: fft_filter(r, jnp.asarray(t)))(xh)
        return batch_fir_filter(xh, jnp.asarray(t))

    if config == "cascade-toeplitz-f32":
        def fn(x):
            for _ in range(nstages):
                x = apply(x, taps, "toeplitz")
            return x
        return fn
    comp = compose_taps_power(taps, nstages)
    form = "fft" if config == "composed-fft" else "toeplitz"
    return lambda x: apply(x, comp, form)


def compile_config(config, taps, nstages, shape):
    """Trace and compile one config for a (P, N) float32 input."""
    import jax

    mode = "bf16x3" if config.endswith("bf16x3") else "f32"
    spec = jax.ShapeDtypeStruct(shape, np.float32)
    with fir_precision(mode):
        return jax.jit(pipeline_fn(config, taps, nstages)).lower(
            spec).compile()


def reference_chain(x_rows, taps, nstages):
    """float64 chain output for a few rows: the composed filter in float64
    (exact composition) applied by FFT convolution in float64."""
    from scipy.signal import fftconvolve

    comp = np.asarray(taps, np.float64)
    for _ in range(nstages - 1):
        comp = np.convolve(comp, np.asarray(taps, np.float64))
    n = x_rows.shape[1]
    return np.stack([fftconvolve(r.astype(np.float64), comp)[:n]
                     for r in x_rows])


def snr_db(got, ref):
    err = np.asarray(got, np.float64) - ref
    return 10.0 * np.log10(float(np.sum(ref * ref))
                           / max(float(np.sum(err * err)), 1e-300))


def time_runs(fn, x, runs=RUNS):
    """Median seconds of ``runs`` calls, each ending in block_until_ready
    (the caller has already warmed this shape)."""
    import jax

    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def pick(results):
    """Fastest config whose SNR passes the gate; raise if none does."""
    passing = [r for r in results if r["snr_db"] >= SNR_GATE_DB]
    if not passing:
        raise RuntimeError(
            f"no config reached {SNR_GATE_DB} dB: "
            + ", ".join(f"{r['config']} {r['snr_db']:.1f} dB"
                        for r in results))
    return min(passing, key=lambda r: r["seconds"])


def taps_and_input(npipes=NPIPES, nsamples=NSAMPLES):
    taps = (np.random.RandomState(0).randn(NTAPS) * 0.05).astype(np.float32)
    x = np.random.RandomState(1).randn(npipes, nsamples).astype(np.float32)
    return taps, x


def main():
    devs = require_gpu()
    from grtpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    taps, x_host = taps_and_input()
    x = jnp.asarray(x_host)
    ref = reference_chain(x_host[:SNR_ROWS], taps, NSTAGES)
    flops = 2.0 * NTAPS * NPIPES * NSTAGES * NSAMPLES
    results = []
    for config in CONFIGS:
        t0 = time.perf_counter()
        fn = compile_config(config, taps, NSTAGES, x.shape)
        compile_s = time.perf_counter() - t0
        y = np.asarray(fn(x))                       # warm + check
        fn(x).block_until_ready()
        snr = snr_db(y[:SNR_ROWS], ref)
        sec = time_runs(fn, x)
        results.append({"config": config, "seconds": sec, "snr_db": snr,
                        "gflops": flops / sec / 1e9,
                        "compile_s": compile_s})
        print(f"# {config}: {sec * 1e3:.3f} ms, {flops / sec / 1e9:.1f} "
              f"GFLOPS, SNR {snr:.1f} dB, compile {compile_s:.1f} s",
              file=sys.stderr, flush=True)
    best = pick(results)
    print(json.dumps({
        "metric": "synthetic_fir_pipeline_16x16_256taps",
        "value": best["gflops"],
        "unit": "GFLOPS",
        "vs_baseline": best["gflops"] / BASELINE,
        "config": best["config"],
        "snr_db": best["snr_db"],
        "device": device_record(devs),
        "all": {r["config"]: [r["gflops"], r["snr_db"], r["seconds"]]
                for r in results},
    }))


if __name__ == "__main__":
    main()
