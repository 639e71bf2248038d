"""Vocoder throughput — gr-vocoder parity evidence.

Measures, on real hardware:
  * GSM 06.10 full-rate: vmapped C-channel encode+decode bank on the GPU
    (the codec is a per-frame lax.scan; batch throughput rides vmap);
  * CVSD encode bank (per-sample scan, vmapped);
  * G.721 ADPCM encode bank (per-sample scan, vmapped);
  * codec2 1300 encode+decode on the HOST (frame-level numpy codec —
    grtpu/vocoder/codec2.py is bit-exact but host-side by design);
  * digital_voice end-to-end (GSM over GMSK, models/digital_voice.py)
    wall-clock, stating whether the host stages cap a streaming graph.

Rates are reported as audio Msamples/s and as x-realtime channel counts
(8 kS/s per voice channel).

Timing: device paths use the in-jit fori_loop carry-fed slope
(benchmarks/common.py); host paths use wall clock (they are host numpy).

Run from the repo root on the GPU: python benchmarks/vocoder_bench.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup, slope_seconds  # noqa: E402


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu.vocoder import cvsd, g72x, gsm

    r = np.random.RandomState(0)

    def slope(g, args, mbig, rounds=3):
        return slope_seconds(
            lambda m: float(np.asarray(g(*args, jnp.int32(m)))), mbig,
            rounds=rounds)

    # ---- GSM 06.10 vmapped bank (encode + decode round trip) -----------
    C, NFRAMES = 64, 50                       # 64 ch x 1 s of audio each
    n = NFRAMES * 160
    audio = (r.randn(C, n) * 3000).astype(np.float32)
    enc0 = gsm.gsm_init_encode_state()
    dec0 = gsm.gsm_init_decode_state()
    enc_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (C,) + np.shape(a)), enc0)
    dec_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (C,) + np.shape(a)), dec0)

    @jax.jit
    def g_gsm(a, m):
        def body(i, s):
            pcm = (a + s * 1e-20).astype(jnp.int16)
            _, frames = jax.vmap(gsm.gsm_fr_encode)(enc_b, pcm)
            _, out = jax.vmap(gsm.gsm_fr_decode)(dec_b, frames)
            return jnp.sum(out.astype(jnp.float32)) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    per = slope(g_gsm, (jnp.asarray(audio),), 5)
    gsm_msps = C * n / per / 1e6
    gsm_rt = gsm_msps * 1e6 / 8000.0

    emit({
        "metric": "gsm0610_bank_64ch_encdec",
        "value": round(gsm_msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(gsm_rt / 64.0, 1),
        "realtime_channels": int(gsm_rt),
        "notes": "vmapped per-frame scan bank, full encode+decode",
    })

    # ---- CVSD encode bank ----------------------------------------------
    p = cvsd._CvsdParams()
    st0 = cvsd.cvsd_init_state(p)
    st_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (C,) + np.shape(a)), st0)
    ncv = 1 << 15
    pcm_cv = (r.randn(C, ncv) * 8000).astype(np.float32)

    @jax.jit
    def g_cvsd(a, m):
        def body(i, s):
            x = (a + s * 1e-20).astype(jnp.int16)
            _, bits = jax.vmap(
                lambda st, xx: cvsd.cvsd_encode_bits(p, st, xx))(st_b, x)
            return jnp.sum(bits.astype(jnp.float32)) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    per = slope(g_cvsd, (jnp.asarray(pcm_cv),), 5)
    cvsd_msps = C * ncv / per / 1e6
    emit({
        "metric": "cvsd_encode_bank_64ch",
        "value": round(cvsd_msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(cvsd_msps * 1e6 / 64000.0 / 64.0, 1),
        "realtime_channels": int(cvsd_msps * 1e6 / 64000.0),  # 64 kS/s CVSD
    })

    # ---- G.721 encode bank ---------------------------------------------
    gs0 = g72x.g72x_init_state()
    gs_b = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a), (C,) + np.shape(a)), gs0)
    blk = g72x.G721Encode()

    @jax.jit
    def g_g721(a, m):
        def body(i, s):
            x = (a + s * 1e-20).astype(jnp.int16)
            _, code = jax.vmap(blk.apply)(gs_b, x)
            return jnp.sum(code.astype(jnp.float32)) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    ng = 1 << 14
    pcm_g = (r.randn(C, ng) * 8000).astype(np.float32)
    per = slope(g_g721, (jnp.asarray(pcm_g),), 5)
    g721_msps = C * ng / per / 1e6
    emit({
        "metric": "g721_encode_bank_64ch",
        "value": round(g721_msps, 2),
        "unit": "Msamples/s",
        "vs_baseline": round(g721_msps * 1e6 / 8000.0 / 64.0, 1),
        "realtime_channels": int(g721_msps * 1e6 / 8000.0),
    })

    # ---- codec2 (host) --------------------------------------------------
    from grtpu.vocoder.codec2 import Codec2

    c2 = Codec2()
    nsec = 2.0
    sp = (r.randn(int(8000 * nsec)) * 2000).astype(np.int16)
    t0 = time.perf_counter()
    data = c2.encode(sp)
    c2d = Codec2()
    _ = c2d.decode(data)
    host_s = time.perf_counter() - t0
    c2_x = nsec / host_s
    emit({
        "metric": "codec2_host_encdec",
        "value": round(c2_x, 2),
        "unit": "x_realtime",
        "vs_baseline": round(c2_x, 2),
        "notes": ("frame-level HOST numpy codec (bit-exact vs the"
                  " reference C); single stream"),
    })

    # ---- digital_voice end-to-end (GSM over GMSK) ----------------------
    from grtpu.models.digital_voice import DigitalVoiceRx, DigitalVoiceTx

    tx = DigitalVoiceTx()
    rx = DigitalVoiceRx()
    a_sec = 1.0
    audio1 = (0.3 * np.sin(2 * np.pi * 440 / 8000
                           * np.arange(int(8000 * a_sec)))).astype(
        np.float32)
    iq = tx(audio1)
    out = rx(iq)                              # warm compiles
    t0 = time.perf_counter()
    rounds = 3
    for _ in range(rounds):
        iq = tx(audio1)
        out = rx(iq)
    dv_s = (time.perf_counter() - t0) / rounds
    dv_x = a_sec / dv_s
    # host-vs-device boundary: the GSM codec is a device scan; the
    # bit/frame plumbing + GMSK mod/demod host paths dominate here
    emit({
        "metric": "digital_voice_end_to_end",
        "value": round(dv_x, 2),
        "unit": "x_realtime",
        "vs_baseline": round(dv_x, 2),
        "audio_rms_out": float(np.sqrt((out ** 2).mean())),
        "notes": ("single-stream TX+RX (GSM 06.10 over GMSK); host"
                  " framing + per-call dispatch bound — the vmapped GSM"
                  " bank above is the scaling path"),
    })


if __name__ == "__main__":
    main()
