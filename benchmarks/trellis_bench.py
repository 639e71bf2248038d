"""Trellis decode throughput benchmark: vmapped Viterbi + SCCC turbo.

The reference decodes one packet per block thread (trellis_viterbi_X work);
here a whole batch of packets decodes as one device program.  Two regimes:

* bulk (large B): the O(K)-depth scan carrying all B x S path metrics
  with the one-hot traceback.
* latency (B=1): the log-depth tropical associative-scan formulation
  (algorithms._viterbi_parallel); the scan wins once a handful of packets
  batch together.

Timing: in-jit fori_loop with carry-fed inputs + scalar readback slope
(benchmarks/common.py).

Run from the repo root on the GPU: python benchmarks/trellis_bench.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup, slope_seconds  # noqa: E402


def slope_time(make, args, ms=(1, 5), reps=3):
    """Median of paired slope rounds over loops built by ``make(m)``."""
    g = {m: make(m) for m in ms}
    return slope_seconds(lambda m: float(np.asarray(g[m](*args))),
                         ms[1], ms[0], rounds=reps)


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu.trellis import FSM, Interleaver, sccc_decoder, viterbi

    FSM4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
    FSM_MSB = FSM(4, 4, 8, NS=[0, 1, 2, 3] * 4,
                  OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])

    # --- batched Viterbi ---------------------------------------------------
    B, K = 4096, 512
    r = np.random.RandomState(0)
    m_vit = jnp.asarray(r.rand(B, K, FSM4.O).astype(np.float32))

    def make_vit(m, par, metrics):
        @jax.jit
        def g(metrics):
            def body(i, s):
                dec = jax.vmap(lambda mm: viterbi(
                    FSM4, mm + s * 1e-20, parallel=par))(metrics)
                return jnp.sum(dec).astype(jnp.float32)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    # 33-iteration span keeps the slope well above host timing noise
    per = slope_time(lambda m: make_vit(m, False, m_vit), (m_vit,),
                     ms=(1, 33))
    vit_msps = B * K / per / 1e6

    m_one = m_vit[:1]
    # single-packet decodes are ~100us — amortize far past dispatch noise
    per_s = slope_time(lambda m: make_vit(m, True, m_one), (m_one,),
                       ms=(1, 257))
    vit_lat_us = per_s * 1e6

    # --- batched SCCC turbo (8 iterations) ----------------------------------
    Bt, Kt, IT = 1024, 512, 8
    il = Interleaver.random(Kt, seed=666)
    m_turbo = jnp.asarray(r.rand(Bt, Kt, FSM_MSB.O).astype(np.float32))

    def make_turbo(m):
        @jax.jit
        def g(metrics):
            def body(i, s):
                dec = jax.vmap(lambda mm: sccc_decoder(
                    FSM4, FSM_MSB, il, mm + s * 1e-20, IT,
                    parallel=False))(metrics)
                return jnp.sum(dec).astype(jnp.float32)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    per_t = slope_time(make_turbo, (m_turbo,), ms=(1, 3))
    turbo_msps = Bt * Kt / per_t / 1e6

    # --- batched PCCC turbo (8 iterations, two 4-state RSC-ish FSMs) ----
    from grtpu.trellis import pccc_decoder
    m_pccc = jnp.asarray(
        r.rand(Bt, Kt, FSM4.O * FSM4.O).astype(np.float32))

    def make_pccc(m):
        @jax.jit
        def g(metrics):
            def body(i, s):
                dec = jax.vmap(lambda mm: pccc_decoder(
                    FSM4, FSM4, il, mm + s * 1e-20, IT,
                    parallel=False))(metrics)
                return jnp.sum(dec).astype(jnp.float32)
            return jax.lax.fori_loop(0, m, body, jnp.float32(0))
        return g

    per_p = slope_time(make_pccc, (m_pccc,), ms=(1, 3))
    pccc_msps = Bt * Kt / per_p / 1e6

    # --- turbo B x unroll sweep: find the knee -----------------------
    sweep = []
    for Bs in (256, 1024, 4096, 16384):
        m_s = jnp.asarray(r.rand(Bs, Kt, FSM_MSB.O).astype(np.float32))
        for un in (4, 8, 16):
            def make_s(m, _ms=m_s, _un=un):
                @jax.jit
                def g(metrics):
                    def body(i, s):
                        dec = jax.vmap(lambda mm: sccc_decoder(
                            FSM4, FSM_MSB, il, mm + s * 1e-20, IT,
                            parallel=False, unroll=_un))(metrics)
                        return jnp.sum(dec).astype(jnp.float32)
                    return jax.lax.fori_loop(0, m, body, jnp.float32(0))
                return g
            ms_pair = (1, 9) if Bs <= 1024 else (1, 3)
            per_s2 = slope_time(make_s, (m_s,), ms=ms_pair)
            sweep.append({"B": Bs, "unroll": un,
                          "msym_s": round(Bs * Kt / per_s2 / 1e6, 2)})
            print(f"# sccc_sweep {sweep[-1]}", file=sys.stderr,
                  flush=True)
    best = max(sweep, key=lambda d: d["msym_s"])
    emit({
        "metric": "sccc_turbo_sweep_best",
        "value": best["msym_s"],
        "unit": "Msymbols/s",
        "batch": best["B"], "unroll": best["unroll"], "K": Kt,
        "sweep": sweep,
        "notes": ("B x unroll sweep; if the curve is flat in B past the "
                  "knee the per-step op-throughput bound is proven"),
    })

    emit({
        "metric": "viterbi_batch_decode",
        "value": round(vit_msps, 1),
        "unit": "Msymbols/s",
        "batch": B, "K": K,
    })
    emit({
        "metric": "viterbi_single_packet_latency_parallel_scan",
        "value": round(vit_lat_us, 1),
        "unit": "us/packet",
        "batch": 1, "K": K,
    })
    emit({
        "metric": "sccc_turbo_decode_8it",
        "value": round(turbo_msps, 2),
        "unit": "Msymbols/s",
        "batch": Bt, "K": Kt,
    })
    emit({
        "metric": "pccc_turbo_decode_8it",
        "value": round(pccc_msps, 2),
        "unit": "Msymbols/s",
        "batch": Bt, "K": Kt,
    })


if __name__ == "__main__":
    main()
