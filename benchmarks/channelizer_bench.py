"""Polyphase channelizer throughput (BASELINE.json config #2).

64-channel critically-sampled channelizer: the branch FIRs and the
N-point IDFT fold into kp complex (T,N)@(N,N) matmuls (no
gather, no strided FFT), split-word bf16x3 (~4e-6 rel err).

Run from repo root on the GPU: python benchmarks/channelizer_bench.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup, slope_seconds  # noqa: E402


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu.ops.pfb import channelize, design_channelizer_taps

    N = 64
    proto = design_channelizer_taps(N, 12)
    kp = -(-len(proto) // N)
    n = 1 << 20
    hist = kp * N
    r = np.random.RandomState(0)
    re = jnp.asarray(r.randn(n + hist).astype(np.float32))
    im = jnp.asarray(r.randn(n + hist).astype(np.float32))

    def make(m, prec, oversample=1):
        @jax.jit
        def g(re, im):
            def body(i, carry):
                x = (re + carry * 1e-20 + 1j * im).astype(jnp.complex64)
                y = channelize(x, proto, N, oversample=oversample,
                               precision=prec)
                return jnp.sum(jnp.abs(y[-1]) ** 2)

            return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

        return g

    # single-pass bf16 accuracy vs the exact path (small one-shot program)
    @jax.jit
    def snr_fn(re, im):
        x = (re[: (1 << 16) + hist] + 1j * im[: (1 << 16) + hist]
             ).astype(jnp.complex64)
        ya = channelize(x, proto, N, precision="f32")
        yb = channelize(x, proto, N, precision="bf16")
        err = jnp.abs(ya - yb) ** 2
        return 10.0 * jnp.log10(jnp.sum(jnp.abs(ya) ** 2)
                                / jnp.maximum(jnp.sum(err), 1e-30))
    bf16_snr = float(np.asarray(snr_fn(re, im)))

    def measure(prec, oversample=1):
        g = {1: make(1, prec, oversample), 65: make(65, prec, oversample)}
        return slope_seconds(
            lambda m: float(np.asarray(g[m](re, im))), 65)

    per_b = measure("bf16")
    emit({
        "metric": "pfb_channelizer_64ch_input_rate_bf16",
        "value": round(n / per_b / 1e6, 1),
        "unit": "Msamples/s",
        "snr_db_vs_f32": round(bf16_snr, 1),
    })
    per = measure("bf16x3")
    msps = n / per / 1e6
    emit({
        "metric": "pfb_channelizer_64ch_input_rate",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 145.0, 3),  # ~reference host FIR rate
    })
    # oversampled mode (per-channel rate 2*fs/N — the reference's
    # oversample-by-os commutator twist, gr_pfb_channelizer_ccf.cc:44-200)
    per_os = measure("bf16x3", oversample=2)
    emit({
        "metric": "pfb_channelizer_64ch_os2_input_rate",
        "value": round(n / per_os / 1e6, 1),
        "unit": "Msamples/s",
        "oversample": 2,
    })
    # os=2 produces 2x the output rows, so par is half the critically-
    # sampled rate per precision mode; the single-shift loop recorded 468
    # Msps at (silent) HIGHEST, the concat-folded matmul reaches par
    per_osb = measure("bf16", oversample=2)
    emit({
        "metric": "pfb_channelizer_64ch_os2_input_rate_bf16",
        "value": round(n / per_osb / 1e6, 1),
        "unit": "Msamples/s",
        "oversample": 2,
    })


if __name__ == "__main__":
    main()
