"""M&M clock-recovery throughput: mask-and-compact loop vs the windowed
gather-free formulation (digital/loops.py clock_recovery_mm_*_windowed).

The classic loop does one dynamic_slice per symbol — vmapped dynamic
slices lower to gathers.  The windowed form pre-strides the chunk into per-symbol rows (static
slices) and handles the bounded timing drift with an in-row one-hot
select, making the block fixed-rate and gather-free.

Run from the repo root on the GPU: python benchmarks/mm_bench.py
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

    from grtpu.digital import loops

    C, sps, W = 256, 5, 32                    # 256 parallel DMR-ish streams
    T = 4096                                   # symbols per stream per chunk
    L = sps + 2 * W + loops.NTAPS
    n = (T - 1) * sps + L
    r = np.random.RandomState(0)
    x = jnp.asarray(r.randn(C, n).astype(np.float32))
    gm, go = 0.175, 0.25 * 0.175 ** 2

    def bench(fn_builder, ms=(1, 3)):
        # builders take a traced m: one compile serves both slope points
        g = fn_builder(None)
        return slope_seconds(
            lambda m: float(np.asarray(g(x, jnp.int32(m)))), ms[1], ms[0])

    def make_windowed(_):
        st = loops.mm_windowed_init_state(float(sps), 0.5)
        st = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (C,) + a.shape), st)

        @jax.jit
        def g(x, m):
            def body(i, s):
                ys, _ = jax.vmap(lambda xs, stt: loops.
                                 clock_recovery_mm_ff_windowed(
                                     xs + s * 1e-20, stt, sps, go, gm,
                                     W=W))(x, st)
                return jnp.sum(ys)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    def make_loop(_):
        st = loops.mm_init_state(float(sps), 0.5)
        st = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (C,) + a.shape), st)

        @jax.jit
        def g(x, m):
            def body(i, s):
                ys, nv, _ = jax.vmap(lambda xs, stt: loops.
                                     clock_recovery_mm_ff(
                                         xs + s * 1e-20, stt, float(sps),
                                         go, gm))(x, st)
                return jnp.sum(ys) + jnp.sum(nv).astype(jnp.float32)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    def make_windowed_frac(_, fsps=5.3):
        P, Q = loops.rationalize_sps(fsps)
        Lf = -(-P // Q) + 2 * W + loops.NTAPS
        Tf = T - T % Q
        nf = Tf * P // Q + Lf
        st = loops.mm_windowed_init_state(fsps, 0.5)
        st = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (C,) + a.shape), st)
        xf = jnp.asarray(np.random.RandomState(1).randn(C, nf)
                         .astype(np.float32))

        @jax.jit
        def g(x, m):
            def body(i, s):
                ys, _ = jax.vmap(lambda xs, stt: loops.
                                 clock_recovery_mm_ff_windowed(
                                     xs + s * 1e-20, stt, fsps, go, gm,
                                     W=W))(x, st)
                return jnp.sum(ys)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return lambda _x, m: g(xf, m)

    def make_chunked(_, ck=16):
        st = loops.mm_windowed_init_state(float(sps), 0.5)
        st = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (C,) + a.shape), st)

        @jax.jit
        def g(x, m):
            def body(i, s):
                ys, _ = jax.vmap(lambda xs, stt: loops.
                                 clock_recovery_mm_ff_chunked(
                                     xs + s * 1e-20, stt, sps, go, gm,
                                     W=W, chunk=ck))(x, st)
                return jnp.sum(ys)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    per_w = bench(make_windowed, ms=(1, 9))
    win_msps = C * T / per_w / 1e6
    per_l = bench(make_loop)
    loop_msps = C * T / per_l / 1e6
    per_f = bench(make_windowed_frac, ms=(1, 9))
    frac_msps = C * (T - T % 10) / per_f / 1e6
    per_c = bench(make_chunked, ms=(1, 9))
    ck_msps = C * T / per_c / 1e6

    emit({
        "metric": "mm_clock_recovery_windowed",
        "value": round(win_msps, 1),
        "unit": "Msymbols/s",
        "streams": C, "sps": sps,
    })
    emit({
        "metric": "mm_clock_recovery_loop",
        "value": round(loop_msps, 2),
        "unit": "Msymbols/s",
        "streams": C, "sps": sps,
    })
    emit({
        "metric": "mm_clock_recovery_windowed_frac",
        "value": round(frac_msps, 1),
        "unit": "Msymbols/s",
        "streams": C, "sps": 5.3,
    })
    emit({
        "metric": "mm_clock_recovery_chunked",
        "value": round(ck_msps, 1),
        "unit": "Msymbols/s",
        "streams": C, "sps": sps,
        "notes": ("chunk-batched fixed point (16 symbols/step, 2 sweeps;"
                  " loops.clock_recovery_mm_ff_chunked) — decision parity"
                  " with the windowed scan is test-enforced"),
    })


if __name__ == "__main__":
    main()
