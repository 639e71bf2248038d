"""WBFM-chain throughput benchmark (BASELINE.json north-star metric:
Msamples/s/card through FIR+FFT+demod).

64-channel WBFM bank (quadrature demod -> 155-tap decimating FIR ->
de-emphasis via the parallel linear-recurrence solver) on one card.
Timing: m iterations chained in one jitted fori_loop with carry-fed inputs
(no loop-invariant hoisting); the per-iteration time is the slope between
two loop lengths (benchmarks/common.py).

Run from the repo root on the GPU: python benchmarks/wfm_bench.py
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

    from grtpu.ops.dsp import linear_recurrence_const
    from grtpu.ops.fir import batch_fir_filter
    from grtpu.utils import firdes

    quad_rate, decim = 256e3, 8
    C, N = 64, 1 << 18
    taps = firdes.low_pass(1.0, quad_rate, 15e3, 4e3)
    K = len(taps)
    gain = np.float32(quad_rate / (2 * np.pi * 75e3))
    kk = float(np.tan(1.0 / (75e-6 * 2.0 * (quad_rate / decim))))
    p1, b0 = np.float32((1 - kk) / (1 + kk)), np.float32(kk / (1 + kk))

    def wfm_bank(iq, st):
        prod = iq[:, 1:] * jnp.conj(iq[:, :-1])
        fm = gain * jnp.arctan2(prod.imag, prod.real)
        audio = batch_fir_filter(fm, jnp.asarray(taps), decim)
        u = b0 * (audio + jnp.concatenate([st[:, None], audio[:, :-1]], 1))
        # constant-pole deemph via the truncated-FIR matmul solver
        y, last = linear_recurrence_const(float(p1), u, st)
        return y, last

    # m is a traced argument: ONE compile serves both slope points
    @jax.jit
    def g(re, im, st, m):
        def body(i, s):
            iq = ((re + s[:, None] * 1e-20) + 1j * im).astype(jnp.complex64)
            _, s2 = wfm_bank(iq, s)
            return s2

        return jnp.sum(jax.lax.fori_loop(0, m, body, st))

    r = np.random.RandomState(0)
    re = jnp.asarray(r.randn(C, N + K).astype(np.float32))
    im = jnp.asarray(r.randn(C, N + K).astype(np.float32))
    st = jnp.zeros((C,), jnp.float32)

    per = slope_seconds(
        lambda m: float(np.asarray(g(re, im, st, jnp.int32(m)))), 17,
        rounds=3)
    msps = C * N / per / 1e6
    emit({
        "metric": "wfm_bank_64ch_aggregate",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 1000.0, 3),  # target: 1 Gsample/s
    })


if __name__ == "__main__":
    main()
