"""pfb_arb_resampler throughput (BASELINE.json north-star config #2 names
it explicitly).

Measures the gather-free strided-view matmul form (grtpu.ops.pfb
.arb_resample) at two rates: a small-P ratio (3/2) and the audio-grade
large-P ratio 160/147 (44.1k -> 48k) that used to fall into the gather
path, batched over 64 channels.

Timing: in-jit fori_loop + scalar-readback slope, median over rounds
(benchmarks/common.py).  Run from the repo root on the GPU:
python benchmarks/resampler_bench.py
"""

import os
import sys
from fractions import Fraction

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup, slope_seconds  # noqa: E402


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu.ops.pfb import arb_resample, design_arb_resampler_taps

    C = 64
    for label, rate, n in (("3_2", Fraction(3, 2), 1 << 17),
                           ("160_147", Fraction(160, 147), 147 * 900)):
        taps = design_arb_resampler_taps(float(rate), 32)
        kp = -(-len(taps) // 32)
        r = np.random.RandomState(0)
        re = jnp.asarray(r.randn(C, n + kp - 1).astype(np.float32))
        im = jnp.asarray(r.randn(C, n + kp - 1).astype(np.float32))

        def make(m):
            @jax.jit
            def g(a, b, s):
                def body(i, acc):
                    x = ((a + acc * 1e-20) + 1j * b).astype(jnp.complex64)
                    y = jax.vmap(lambda row: arb_resample(
                        row, taps, rate, 32))(x)
                    return acc + jnp.sum(jnp.abs(y[:, :4]) ** 2)

                return jax.lax.fori_loop(0, m, body, 0.0)

            return g

        g = {1: make(1), 33: make(33)}
        per = slope_seconds(
            lambda m: float(np.asarray(g[m](re, im, 0.0))), 33)
        msps = C * n / per / 1e6
        emit({
            "metric": f"pfb_arb_resampler_64ch_rate_{label}",
            "value": round(msps, 1),
            "unit": "Msamples/s input",
            "vs_baseline": round(msps / 1000.0, 3),  # target 1 Gsps
        })


if __name__ == "__main__":
    main()
