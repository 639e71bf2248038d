"""ATSC 8-VSB RX throughput — the reference's showcase domain
(gr-atsc/src/lib, ~13k LoC: FPLL -> bit timing -> field sync -> equalizer
-> 12-phase Viterbi -> deinterleave -> RS -> derandomize).

Workload: a real modulated transport stream (packets -> TX coding -> VSB
passband at 2.5 samples/symbol) decoded by the grtpu chain
(models/atsc_rf.AtscRfReceiver + models/atsc.AtscReceiver).  Before any
timing, the full RX is run once and must recover error-free packets — the
recorded rates are for a LOCKING, correctly-decoding receiver.

Stages are timed separately (they run sequentially in the model) and
composed into the end-to-end symbol rate:
  * front_end: passband RRC FIR -> FPLL (per-sample scan) -> LPF ->
    DC removal -> segment-batched bit timing loop -> field sync correlator
  * dfe: per-field NLMS DFE (8 train sweeps + decision-feedback filter)
  * trellis: 12-phase vmapped Viterbi (one call, models/atsc.py)
  * transport: host-side deinterleave + RS(207,187) + derandomize

Timing: in-jit fori_loop carry-fed slope, median over rounds
(benchmarks/common.py); host stage by wall clock (it is host numpy).

Run from the repo root on the GPU: python benchmarks/atsc_bench.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup, slope_seconds  # noqa: E402

RATIO = 2.5
FS = 10.762238e6 * RATIO
IF_NORM = 0.26


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu.models import atsc_rf as rf
    from grtpu.models.atsc import (AtscReceiver, AtscTransmitter,
                                   trellis_decode_device)
    from grtpu.ops.fir import fir_filter, interp_fir_filter
    from grtpu.utils import firdes

    rng = np.random.default_rng(7)

    # ---- build the RF stream: packets -> TX -> VSB passband ------------
    npkt = int(312 * 3.3)
    payload = rng.integers(0, 256, (npkt, 187)).astype(np.uint8)
    pkts = np.concatenate(
        [np.full((npkt, 1), 0x47, np.uint8), payload], axis=1)
    tx = AtscTransmitter()
    levels = tx.process(pkts)
    codes = ((levels + 7) // 2).astype(np.uint8)
    nseg_tx = len(codes) // 828
    mux = rf.AtscFieldSyncMux()
    stream_codes = mux(codes[: nseg_tx * 828].reshape(nseg_tx, 828))
    sym = stream_codes.astype(np.float32) * 2 - 7 + 1.25   # + pilot
    rrc5 = firdes.root_raised_cosine(5.0, 5.0, 1.0, 0.115, 201).astype(
        np.float32)
    up5 = np.asarray(interp_fir_filter(
        jnp.concatenate([jnp.zeros(40, jnp.float32), jnp.asarray(sym)]),
        jnp.asarray(rrc5), 5))
    passband = rf.vsb_modulate(up5[::2].astype(np.float64), IF_NORM,
                               RATIO).astype(np.float32)
    n_samples = len(passband)
    print(f"# stream: {n_samples} samples, {nseg_tx} data segments",
          file=sys.stderr)

    # ---- correctness gate: full RX must decode error-free --------------
    rx = rf.AtscRfReceiver(fs=FS, if_freq=IF_NORM * FS, ratio=RATIO,
                           equalizer="lms2")
    fields = rx.process(passband)
    assert fields.shape[0] >= 2, f"only {fields.shape[0]} fields found"
    dec = AtscReceiver()
    got, bad = dec.process(np.concatenate(
        [f.reshape(-1) for f in fields]))
    match = 0
    gotset = {g.tobytes() for g in got}
    for p in pkts:
        if p.tobytes() in gotset:
            match += 1
    print(f"# decoded {len(got)} pkts, {bad} uncorrectable, "
          f"{match} exact TX matches", file=sys.stderr)
    assert match >= 312, f"too few error-free packets: {match}"

    # ---- shared slope timer --------------------------------------------
    def slope(g, args, mbig):
        return slope_seconds(
            lambda m: float(np.asarray(g(*args, jnp.int32(m)))), mbig)

    # ---- stage 1: front end (FIR -> FPLL -> LPF -> DC -> BTL -> FS) ----
    # timed as four separately-jitted loops (one fully-fused program
    # covering the whole 2.1M-sample front end compiled for >20 min —
    # XLA's whole-graph optimization blows up super-linearly) and
    # composed by per-sample time, exactly like the later stages.
    nseg_rx = int((n_samples - rf.BTL_WINDOW) // (RATIO * rf.SEGMENT_LEN))
    kp, k = len(rx.pb_rrc), len(rx.lpf)
    pb_taps = jnp.asarray(rx.pb_rrc)
    lp_taps = jnp.asarray(rx.lpf)
    xdev = jnp.asarray(passband)
    nsym_fe = nseg_rx * rf.SEGMENT_LEN

    @jax.jit
    def fe_firs(x, m):
        def body(i, s):
            xi = x + s * 1e-20
            pbf = fir_filter(jnp.concatenate(
                [jnp.zeros(kp - 1, jnp.float32), xi]), pb_taps, 1)
            bbf = fir_filter(jnp.concatenate(
                [jnp.zeros(k - 1, jnp.float32), pbf]), lp_taps, 1)
            return jnp.sum(bbf) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    @jax.jit
    def fe_fpll(x, m):
        def body(i, s):
            st = rf.fpll_init_state(IF_NORM * FS, FS)
            _, bb = rf.fpll_chunked(st, x + s * 1e-20, FS)
            return jnp.sum(bb) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    @jax.jit
    def fe_dcbtl(x, m):
        def body(i, s):
            bbd, _ = rf.remove_dc(x + s * 1e-20,
                                  jnp.asarray(0.0, jnp.float32))
            bst = rf.btl_init_state(RATIO)
            _, symo, _, _, _, _ = rf.bit_timing_loop(bst, bbd, nseg_rx)
            return jnp.sum(symo) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    symdev = jnp.asarray(np.asarray(
        rng.standard_normal(nsym_fe) * 4, np.float32))

    @jax.jit
    def fe_fs(x, m):
        def body(i, s):
            tag, _ = rf.fs_correlate(x + s * 1e-20)
            return jnp.sum(tag) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    import sys as _sys
    per_parts = {}
    for nm, fn, arg in (("firs", fe_firs, xdev), ("fpll", fe_fpll, xdev),
                        ("dcbtl", fe_dcbtl, xdev), ("fs", fe_fs, symdev)):
        print(f"# timing fe_{nm}...", file=_sys.stderr, flush=True)
        per_parts[nm] = slope(fn, (arg,), 3)
        print(f"# fe_{nm}: {per_parts[nm]:.3f} s", file=_sys.stderr,
              flush=True)
    per_fe = sum(per_parts.values())
    fe_msps = n_samples / per_fe / 1e6
    fe_msym = nsym_fe / per_fe / 1e6

    # ---- stage 2: DFE equalizer per field ------------------------------
    FL = rf.SYMBOLS_PER_FIELD
    x_field = np.asarray(rng.normal(size=FL + rf.EQ_NTAPS - 1) * 5.0,
                         np.float32)
    xt_np = x_field[rf.EQ_CURSOR:
                    rf.EQ_CURSOR + rf.FS_TRAIN_LEN + rf.DFE_NFF - 1]
    d_np = rf.fs_training_levels(0)
    xf_np = x_field[rf.EQ_CURSOR:
                    rf.EQ_CURSOR + FL + rf.DFE_NFF - 1]
    xt_j, d_j, xf_j = (jnp.asarray(a) for a in (xt_np, d_np, xf_np))

    @jax.jit
    def dfe_field(xt, d, xf, m):
        def body(i, s):
            wff = jnp.zeros(rf.DFE_NFF, jnp.float32).at[0].set(1.0 + s * 1e-20)
            wfb = jnp.zeros(rf.DFE_NFB, jnp.float32)
            for sweep in range(8):
                mu = 0.25 * (0.5 ** max(0, sweep - 4))
                wff, wfb = rf._dfe_train(wff, wfb, xt, d, jnp.float32(mu))
            y = rf._dfe_filter(wff, wfb, xf, jnp.zeros(rf.DFE_NFB,
                                                       jnp.float32))
            return jnp.sum(y) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    per_eq = slope(dfe_field, (xt_j, d_j, xf_j), 3)
    eq_msym = FL / per_eq / 1e6

    # linear NLMS alternative (no decision feedback -> the field filter
    # is ONE dense matmul FIR; the DFE's feedback dot is inherently
    # per-symbol sequential)
    xt_l = jnp.asarray(x_field[: rf.FS_TRAIN_LEN + rf.EQ_NTAPS - 1])
    xf_l = jnp.asarray(x_field)

    @jax.jit
    def nlms_field(xt, d, xf, m):
        def body(i, s):
            taps = jnp.zeros(rf.EQ_NTAPS,
                             jnp.float32).at[rf.EQ_CURSOR].set(1.0
                                                               + s * 1e-20)
            for _ in range(8):
                taps, _ = rf._lms_train(taps, xt, d)
            y = rf._eq_filter(taps, xf)
            return jnp.sum(y) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    per_nlms = slope(nlms_field, (xt_l, d_j, xf_l), 3)
    nlms_msym = FL / per_nlms / 1e6

    # ---- stage 3: 12-phase vmapped Viterbi per field -------------------
    T12 = (rf.DSEGS_PER_FIELD * 828) // 12
    lv = jnp.asarray(rng.choice([-7, -5, -3, -1, 1, 3, 5, 7],
                                size=(12, T12)).astype(np.float32))

    @jax.jit
    def trellis_m(x, m):
        def body(i, s):
            out = trellis_decode_device(x + s * 1e-20)
            return jnp.sum(out.astype(jnp.float32)) * 1e-20
        return jax.lax.fori_loop(0, m, body, jnp.float32(0.0))

    per_tr = slope(trellis_m, (lv,), 3)
    tr_msym = 12 * T12 / per_tr / 1e6

    # ---- stage 4: host transport (deinterleave + RS + derandomize) -----
    one_field = fields[0].reshape(-1)
    t0 = time.perf_counter()
    rounds = 3
    for _ in range(rounds):
        d2 = AtscReceiver()
        d2.process(one_field)
    per_host = (time.perf_counter() - t0) / rounds
    # AtscReceiver.process includes the device trellis decode; subtract it
    per_host_only = max(per_host - len(one_field) / (tr_msym * 1e6), 0.0)
    host_msym = len(one_field) / per_host_only / 1e6

    # ---- compose: sequential stages -> end-to-end symbol rate ----------
    # per-symbol seconds (front end charged at its symbol rate)
    ps = (1.0 / (fe_msym * 1e6) + 1.0 / (eq_msym * 1e6)
          + 1.0 / (tr_msym * 1e6) + 1.0 / (host_msym * 1e6))
    chain_msym = 1.0 / ps / 1e6
    stages = {"front_end": round(fe_msym, 2), "dfe": round(eq_msym, 2),
              "viterbi12": round(tr_msym, 2),
              "transport_host": round(host_msym, 2)}
    bottleneck = min(stages, key=stages.get)
    # alternative chain with the linear NLMS equalizer (one matmul FIR)
    ps_nlms = (1.0 / (fe_msym * 1e6) + 1.0 / (nlms_msym * 1e6)
               + 1.0 / (tr_msym * 1e6) + 1.0 / (host_msym * 1e6))
    chain_nlms = 1.0 / ps_nlms / 1e6

    emit({
        "metric": "atsc_8vsb_rx_full_chain",
        "value": round(chain_msym, 2),
        "unit": "Msym/s",
        "vs_baseline": round(chain_msym / 10.762238, 3),  # ATSC real time
        "packets_verified": int(match),
        "notes": ("stage Msym/s: front_end %.1f (%.1f Msps in,"
                  " chunked FPLL), dfe %.1f (nlms linear eq %.1f ->"
                  " chain %.2f), viterbi12 %.1f, transport(host) %.1f —"
                  " bottleneck: %s; the DFE's per-symbol decision"
                  " feedback is inherently sequential"
                  % (fe_msym, fe_msps, eq_msym, nlms_msym, chain_nlms,
                     tr_msym, host_msym, bottleneck)),
    })
    emit({
        "metric": "atsc_rx_front_end",
        "value": round(fe_msps, 1),
        "unit": "Msamples/s",
        "vs_baseline": round(fe_msym / 10.762238, 3),
    })


if __name__ == "__main__":
    main()
