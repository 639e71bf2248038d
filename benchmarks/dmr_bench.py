"""DMR demod-chain throughput (BASELINE.md north-star target #1:
WBFM & DMR demod chains > 1 Gsample/s aggregate).

Workload: a bank of C DMR channels' TDMA bursts demodulated open-loop on
one card (Fsk4Modem._burst_bank_fn: quadrature demod -> 110-tap matched
RRC as a matmul -> median CFO removal -> vectorized eye-metric phase pick).
Timing: in-jit fori_loop with carry-fed inputs, slope between two loop
lengths (benchmarks/common.py).

Run from the repo root on the GPU: python benchmarks/dmr_bench.py
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

    from grtpu.digital.modems import Fsk4Modem

    modem = Fsk4Modem(samples_per_symbol=10)
    C, N = 128, 27648 * 4  # ~4 DMR 30ms bursts' worth per channel per step

    r = np.random.RandomState(0)
    re = jnp.asarray(r.randn(C, N).astype(np.float32) * 0.7)
    im = jnp.asarray(r.randn(C, N).astype(np.float32) * 0.7)

    def make(m):
        @jax.jit
        def g(a, b):
            def body(i, carry):
                x = ((a + carry * 1e-20) + 1j * b).astype(jnp.complex64)
                v = modem._burst_bank_fn(x)
                return jnp.sum(v) * 1e-20

            return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

        return g

    g = {1: make(1), 33: make(33)}
    per = slope_seconds(lambda m: float(np.asarray(g[m](re, im))), 33)
    msps = C * N / per / 1e6
    emit({
        "metric": "dmr_burst_bank_128ch_aggregate",
        "value": round(msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(msps / 1000.0, 3),  # target: 1 Gsample/s
    })


if __name__ == "__main__":
    main()
