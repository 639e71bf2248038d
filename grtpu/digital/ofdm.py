"""OFDM stack: mapper, cyclic prefix, sync, frame acquisition, frame sink.

Analogs (the dmr fork's headline modification, SURVEY.md §2.7):
  * digital_ofdm_mapper_bcv — bits -> occupied-subcarrier symbol vectors.
  * digital_ofdm_insert_preamble / digital_ofdm_cyclic_prefixer.
  * ofdm_sync_pn.py — Schmidl&Cox-style autocorrelation timing/CFO sync
    from a repeated-half PN preamble.
  * digital_ofdm_sampler — symbol-aligned FFT-window extraction.
  * digital_ofdm_frame_acquisition (lib/digital_ofdm_frame_acquisition.cc:
    122-223) — coarse carrier alignment + per-subcarrier channel estimate
    from the known preamble + one-tap equalization.
  * digital_ofdm_frame_sink (lib/digital_ofdm_frame_sink.cc:422-423) —
    demap; THE FORK'S FEATURE: exports the per-subcarrier channel
    estimates alongside the demodulated data (apurv++ outputs).

The whole receive chain is batched over OFDM symbols — the
timing metric is one vectorized autocorrelation, FFTs are XLA batched FFTs,
equalization is elementwise over the (nsymbols, ncarriers) grid.  Burst
(packet) processing as pure jitted functions, like grtpu.digital.modems.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block


class OfdmParams(NamedTuple):
    fft_len: int = 64
    cp_len: int = 16
    occupied_carriers: Tuple[int, ...] = ()  # logical indices (+-)
    mod_order: int = 4  # QPSK mapping on carriers


def default_carriers(fft_len: int = 64, occupied: int = 48) -> np.ndarray:
    """Symmetric band of occupied carriers, skipping DC (ofdm.py default
    layout: zeros_on_left + occupied_tones centered)."""
    half = occupied // 2
    neg = np.arange(-half, 0)
    pos = np.arange(1, half + 1)
    return np.concatenate([neg, pos])  # logical carrier indices


def carrier_bins(carriers: np.ndarray, fft_len: int) -> np.ndarray:
    return np.where(carriers < 0, carriers + fft_len, carriers).astype(np.int64)


class OfdmModem:
    """Burst OFDM modem with Schmidl&Cox sync + preamble channel estimation.

    Frame = [sync preamble (repeated-half PN) | known preamble | data syms].
    """

    def __init__(self, fft_len: int = 64, cp_len: int = 16,
                 occupied: int = 48, mod_order: int = 4, seed: int = 17):
        self.fft_len = fft_len
        self.cp_len = cp_len
        self.carriers = default_carriers(fft_len, occupied)
        self.bins = carrier_bins(self.carriers, fft_len)
        self.occupied = occupied
        self.mod_order = mod_order
        self.bits_per_sym = int(np.log2(mod_order))
        rng = np.random.RandomState(seed)
        # sync preamble: PN on even logical carriers -> time-domain signal
        # with two identical halves (Schmidl & Cox)
        pn = (2 * rng.randint(0, 2, occupied) - 1).astype(np.float32)
        sync_freq = np.zeros(fft_len, np.complex64)
        even_mask = self.bins % 2 == 0  # energy on even FFT bins only ->
        # time-domain symbol has two identical halves (Schmidl & Cox)
        sync_freq[self.bins[even_mask]] = (
            pn[even_mask] * np.sqrt(2)).astype(np.complex64)
        self.sync_time = np.fft.ifft(sync_freq).astype(np.complex64)
        # channel-estimation preamble: known QPSK on every occupied carrier
        s = 1 / np.sqrt(2)
        cpts = np.array([s * (1 + 1j), s * (-1 + 1j), s * (-1 - 1j),
                         s * (1 - 1j)], np.complex64)
        self.known_idx = rng.randint(0, 4, occupied)
        self.known = cpts[self.known_idx]
        self.qpsk = cpts

    # ----------------------------------------------------------------- mod
    def _with_cp(self, time_syms: jnp.ndarray) -> jnp.ndarray:
        """(nsym, fft_len) -> flattened stream with cyclic prefixes
        (digital_ofdm_cyclic_prefixer)."""
        cp = time_syms[:, -self.cp_len:]
        return jnp.concatenate([cp, time_syms], axis=1).reshape(-1)

    def modulate(self, bits: np.ndarray) -> jnp.ndarray:
        """bits -> burst samples (preambles + data symbols, all CP'd)."""
        bits = np.asarray(bits, np.uint8)
        k = self.bits_per_sym
        per_sym = self.occupied * k
        nsym = -(-len(bits) // per_sym)
        pad = nsym * per_sym - len(bits)
        b = np.concatenate([bits, np.zeros(pad, np.uint8)])
        pts = b.reshape(nsym, self.occupied, k)
        idx = np.zeros((nsym, self.occupied), np.int64)
        for j in range(k):
            idx = (idx << 1) | pts[:, :, j]
        sym = self.qpsk[idx] if self.mod_order == 4 else \
            np.where(idx == 1, 1.0, -1.0).astype(np.complex64)
        freq = np.zeros((nsym, self.fft_len), np.complex64)
        freq[:, self.bins] = sym
        data_time = np.fft.ifft(freq, axis=1).astype(np.complex64)
        known_freq = np.zeros((1, self.fft_len), np.complex64)
        known_freq[0, self.bins] = self.known
        known_time = np.fft.ifft(known_freq, axis=1).astype(np.complex64)
        frames = np.concatenate(
            [self.sync_time[None, :], known_time, data_time], axis=0)
        # stay on host: the TX burst builder is numpy end-to-end, and jit
        # callers stage host arrays at the trace boundary anyway
        cp = frames[:, -self.cp_len:]
        return np.concatenate([cp, frames], axis=1).reshape(-1)

    # --------------------------------------------------------------- sync
    def sync_metric(self, x: jnp.ndarray) -> jnp.ndarray:
        """Schmidl&Cox timing metric |P(d)|^2 / R(d)^2 (ofdm_sync_pn.py):
        P = autocorrelation at lag L/2 over a window of L/2."""
        L = self.fft_len
        h = L // 2
        n = x.shape[0]
        prod = x[h:] * jnp.conj(x[:-h])
        pw = jnp.abs(x[h:]) ** 2
        cs = jnp.cumsum(prod)
        cs = jnp.concatenate([jnp.zeros(1, cs.dtype), cs])
        P = cs[h:] - cs[:-h]
        ce = jnp.cumsum(pw)
        ce = jnp.concatenate([jnp.zeros(1, ce.dtype), ce])
        R = jnp.real(ce[h:] - ce[:-h])
        # gate low-energy regions: at burst edges R -> 0 faster than |P|,
        # which would send the ratio above 1 (false peaks)
        gate = R > 0.1 * jnp.max(R)
        m = jnp.where(gate, (jnp.abs(P) ** 2) / jnp.maximum(R ** 2, 1e-12),
                      0.0)
        return m, P

    def _acquire(self, x: jnp.ndarray):
        """Timing + fine CFO from the sync preamble (jit-friendly)."""
        metric, P = self.sync_metric(x)
        L, h = self.fft_len, self.fft_len // 2
        search = metric[: x.shape[0] - 3 * L]
        mx = jnp.max(search)
        # S&C metric plateaus over the sync CP; take the plateau START
        # (first index within 90% of the peak) = CP start of the frame
        d = jnp.argmax(search > 0.9 * mx).astype(jnp.int32)
        d_pk = jnp.argmax(search).astype(jnp.int32)
        # fractional CFO in radians/sample from the lag-h autocorrelation
        cfo_rad = jnp.angle(P[d_pk]) / h
        return d, cfo_rad

    # --------------------------------------------------------------- demod
    def demodulate(self, x, nsym_data: int):
        """Burst receive: sync, CFO-correct, FFT, channel-estimate from the
        known preamble, equalize, demap.

        Returns (bits, channel_estimate, cfo_rad, start_index) — channel
        estimate exported per the fork's frame-sink extension
        (digital_ofdm_frame_sink.cc:422-423).
        """
        x = jnp.asarray(x)
        d, cfo = self._acquire(x)
        n = x.shape[0]
        # derotate
        xr = x * jnp.exp(-1j * cfo * jnp.arange(n))
        # d = frame CP start; symbol i's FFT window nominally begins at
        # d + cp + i*sym_len; back off half a CP so timing error stays
        # ISI-free (the residual circular shift is a per-bin phase ramp
        # common to all symbols, absorbed by the channel estimate)
        sym_len = self.fft_len + self.cp_len
        start = d + self.cp_len - self.cp_len // 2
        nsym_total = nsym_data + 2

        def window(i):
            return jax.lax.dynamic_slice_in_dim(
                xr, start + i * sym_len, self.fft_len)

        wins = jnp.stack([window(i) for i in range(nsym_total)])
        F = jnp.fft.fft(wins, axis=1)
        # mid-CP anchor introduces a known per-bin phase ramp; fold it into
        # the channel estimate (flat across the frame)
        occ = F[:, jnp.asarray(self.bins)]
        chan = occ[1] / jnp.asarray(self.known)  # per-carrier complex gain
        data = occ[2:] / jnp.maximum(jnp.abs(chan), 1e-9) / jnp.exp(
            1j * jnp.angle(chan))
        # residual-CFO tracking: per-symbol decision-directed common-phase
        # loop (the frame sink's phase tracking; without it the CFO
        # estimation noise integrates across the burst)
        pts = jnp.asarray(self.qpsk)

        def track(phase, row):
            r = row * jnp.exp(-1j * phase)
            dec = jnp.argmin(jnp.abs(r[:, None] - pts[None, :]) ** 2, axis=1)
            ref = pts[dec]
            err = jnp.angle(jnp.sum(r * jnp.conj(ref)))
            return phase + err, r * jnp.exp(-1j * err)

        _, data = jax.lax.scan(track, jnp.zeros((), jnp.float32), data)
        # demap QPSK (gray-free direct 2-bit mapping as in modulate)
        d2 = jnp.abs(data[..., None] - pts[None, None, :]) ** 2
        idx = jnp.argmin(d2, axis=-1)
        b1 = (idx >> 1) & 1
        b0 = idx & 1
        bits = jnp.stack([b1, b0], axis=-1).reshape(nsym_data, -1)
        return bits.reshape(-1).astype(jnp.uint8), chan, cfo, d


def ofdm_frame_acquisition(symbols: jnp.ndarray, known: jnp.ndarray,
                           bins: np.ndarray):
    """Standalone analog of digital_ofdm_frame_acquisition: given FFT'd
    symbol vectors (first = known preamble), estimate per-carrier channel
    and equalize the rest.  Returns (equalized, channel_estimate)."""
    occ = symbols[:, jnp.asarray(bins)]
    chan = occ[0] / known
    eq = occ[1:] * jnp.conj(chan) / jnp.maximum(jnp.abs(chan) ** 2, 1e-12)
    return eq, chan


# ---------------------------------------------------------------------------
# Sync variants (gr-digital/python/ofdm_sync_{pn,ml,pnac,fixed}.py,
# selected by ofdm_receiver.py:107-121).  Each returns per-sample timing
# metric + CFO information, fully vectorized (moving sums are cumsum
# differences; cross-correlation is one FIR).
# ---------------------------------------------------------------------------
def ofdm_sync_pn(x: jnp.ndarray, fft_len: int):
    """Schmidl & Cox (ofdm_sync_pn.py): lag-L/2 autocorrelation metric.

    Returns (metric, P) with metric[d] = |P(d)|^2 / R(d)^2; CFO in
    radians/sample = angle(P[peak]) / (L/2)."""
    h = fft_len // 2
    prod = x[h:] * jnp.conj(x[:-h])
    pw = jnp.abs(x) ** 2
    cs = jnp.concatenate([jnp.zeros(1, prod.dtype), jnp.cumsum(prod)])
    P = cs[h:] - cs[:-h]
    ce = jnp.concatenate([jnp.zeros(1, pw.dtype), jnp.cumsum(pw)])
    R2 = jnp.real(ce[2 * h:] - ce[h:-h])          # second-half energy
    R1 = jnp.real(ce[h:-h] - ce[:-2 * h])         # first-half energy
    n = min(P.shape[0], R2.shape[0])
    P, R1, R2 = P[:n], R1[:n], R2[:n]
    # SYMMETRIC normalization: |P| <= sqrt(R1*R2) <= (R1+R2)/2, so the
    # metric is bounded by 1 everywhere.  The reference's |P|^2/R2^2
    # (second-half energy only) blows up at a signal->silence trailing
    # edge (R2 -> 0 while R1 stays large: bound R1/R2 unbounded), firing
    # false frame syncs on burst tails in streaming use.
    Rs = 0.5 * (R1 + R2)
    gate = Rs > 0.1 * jnp.max(Rs)
    m = jnp.where(gate, (jnp.abs(P) ** 2) / jnp.maximum(Rs ** 2, 1e-12),
                  0.0)
    return m, P


def ofdm_sync_ml(x: jnp.ndarray, fft_len: int, cp_len: int,
                 snr_db: float = 10.0):
    """van de Beek ML estimator (ofdm_sync_ml.py): cyclic-prefix
    correlation gamma(d) = sum_{m<cp} x[d+m] conj(x[d+m+L]), energy term
    Phi(d) = rho/2 * sum(|x[d+m]|^2 + |x[d+m+L]|^2); metric =
    |gamma| - Phi.  The metric peaks at each symbol's CP start; CFO in
    radians/sample = -angle(gamma[peak]) / L.

    Returns (metric, gamma): metric[d] for window starting at d."""
    L = fft_len
    snr = 10.0 ** (snr_db / 10.0)
    rho = snr / (snr + 1.0)
    prod = jnp.conj(x[L:]) * x[:-L]          # x[d] conj(x[d+L]) per d
    pw = jnp.abs(x[:-L]) ** 2 + jnp.abs(x[L:]) ** 2

    def msum(v, w):
        c = jnp.concatenate([jnp.zeros(1, v.dtype), jnp.cumsum(v)])
        return c[w:] - c[:-w]

    gamma = msum(prod, cp_len)
    phi = (rho / 2.0) * jnp.real(msum(pw, cp_len))
    return jnp.abs(gamma) - phi, gamma


def ofdm_sync_pnac(x: jnp.ndarray, fft_len: int, kstime: np.ndarray):
    """Tufvesson PN-correlation sync (ofdm_sync_pnac.py): cross-correlate
    with the known first preamble half, then delay-L/2 self-correlation of
    the correlator output — the repeated halves give two cross-correlation
    peaks L/2 apart, so their product peaks sharply at the preamble end
    (no S&C plateau ambiguity).

    The metric peaks at d = preamble CP end + L/2 - 1 (the first half's
    correlation peak; d + L/2 is the second half's).  The reference's raw
    |corr|^2 - movsum comparison assumes normalized input power (its own
    docstring says so); here the sharp product metric is energy-gated
    instead, which is scale-free.  Returns (metric, corr);
    CFO = angle(corr[peak]) / (L/2)."""
    from grtpu.ops.fir import fir_filter

    h = fft_len // 2
    ks = np.conj(np.asarray(kstime)[:h])     # first half, conjugated
    taps = ks[::-1].copy()                   # matched filter
    # correlation ending at sample d: fir with K-1 leading history
    xh = jnp.concatenate([jnp.zeros(h - 1, x.dtype), x])
    cc = fir_filter(xh, jnp.asarray(taps.astype(np.complex64)))
    corr = cc[h:] * jnp.conj(cc[:-h])
    mag2 = jnp.abs(cc) ** 2
    c = jnp.concatenate([jnp.zeros(1, mag2.dtype), jnp.cumsum(mag2)])
    L = fft_len
    power = (c[L:] - c[:-L])[: corr.shape[0]]
    a = jnp.abs(corr)[: power.shape[0]]
    m = jnp.where(power > 0.1 * jnp.max(power), a, 0.0)
    return m, corr


def ofdm_sync_fixed(n: int, fft_len: int, cp_len: int, nsymbols: int,
                    freq_offset: float = 0.0):
    """ofdm_sync_fixed.py: no estimation — a fixed trigger at the end of
    the first symbol of each packet and a constant frequency offset.
    Returns (peaks uint8 (n,), freq float32 (n,))."""
    sym_len = fft_len + cp_len
    pkt = nsymbols * sym_len
    idx = jnp.arange(n)
    peaks = ((idx % pkt) == (sym_len - 1)).astype(jnp.uint8)
    freq = jnp.full((n,), np.pi * freq_offset, jnp.float32)
    return peaks, freq


class OfdmReceiver(Block):
    """Streaming OFDM receiver with the fork's 3-output shape
    (ofdm_receiver.py:44-46: data symbols, timing flag, channel estimates).

    A variable-rate graph block (first-class via the executor's FIFO
    machinery): consumes the sample stream, acquires frames with the
    selected sync variant ("pn" or "ml"), and emits one equalized
    occupied-carrier vector per OFDM symbol on port 0, a frame-start flag
    per symbol on port 1, and the per-subcarrier channel estimate (the
    apurv++ export, digital_ofdm_frame_sink.cc:422-423) per symbol on
    port 2 — all in lockstep.

    Frames are ``nsym_data`` data symbols after the 2 preamble symbols;
    after a full frame the receiver re-acquires (burst/TDMA semantics,
    matching the benchmark_ofdm framing).

    Acquisition runs inside the per-symbol scan, so any number of frames
    can start (and complete) within one chunk at any chunk size — a frame
    completing mid-chunk hands straight to the next preamble.  The one
    remaining boundary case: a preamble must be fully readable in some
    chunk's window; the history (3 symbols + fft) covers preambles up to
    ~3 symbols behind the fresh region, which a frame with more deferred
    symbols than that could outrun.
    """

    variable_rate = True

    def __init__(self, modem: "OfdmModem", nsym_data: int,
                 sync_type: str = "pn", snr_db: float = 10.0,
                 thresh: float = 0.6, name=None):
        from grtpu.runtime.block import Port

        occ = modem.occupied
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64, occ), Port(jnp.uint8),
                          Port(jnp.complex64, occ))
        sym_len = modem.fft_len + modem.cp_len
        # history: a sync detected near the chunk start needs the whole
        # sync+known preamble readable, plus the deferred-window span
        self.history = 3 * sym_len + modem.fft_len
        super().__init__(name)
        self.modem = modem
        self.nsym_data = int(nsym_data)
        self.sym_len = sym_len
        self.sync_type = sync_type
        self.snr_db = float(snr_db)
        self.thresh = float(thresh)

    @property
    def nominal_rate(self):
        return 1.0 / self.sym_len

    def _frame_iters(self, n_delivered: int) -> int:
        """Frame-scan iterations per chunk: at most n//span complete
        frames fit in n delivered samples (each consumes a full frame
        span of anchor travel), plus a resumed partial frame, a newly
        started partial frame, and one slack iteration."""
        span = (self.nsym_data + 2) * self.sym_len
        return n_delivered // span + 3

    def max_out_for(self, n_delivered: int) -> int:
        return self._frame_iters(n_delivered) * self.nsym_data

    def init_state(self):
        occ = self.modem.occupied
        return {
            "have": jnp.zeros((), jnp.bool_),
            "anchor": jnp.zeros((), jnp.int32),     # next data window start
            "cfo": jnp.zeros((), jnp.float32),
            "base": jnp.zeros((), jnp.int32),       # absolute sample index
            "chan": jnp.ones((occ,), jnp.complex64),
            "phase": jnp.zeros((), jnp.float32),
            "sym_left": jnp.zeros((), jnp.int32),   # data symbols remaining
            # accumulated CFO ramp phase at delivered index 0: keeps the
            # derotation CONTINUOUS across chunk boundaries (a chunk-local
            # ramp would jump by cfo*chunk_len at every boundary)
            "cfo_phase": jnp.zeros((), jnp.float32),
        }

    def _metric(self, x):
        m = self.modem
        if self.sync_type == "ml":
            # ML's CP correlation fires at EVERY symbol boundary (that is
            # its job in the reference, where frame identification happens
            # later in ofdm_frame_acquisition); gate it with the S&C
            # half-symmetry indicator so only the PN sync symbol's CP
            # start survives — ML supplies the sharp timing + unbiased CFO,
            # PN supplies frame identity.
            met_ml, g = ofdm_sync_ml(x, m.fft_len, m.cp_len, self.snr_db)
            snr = 10.0 ** (self.snr_db / 10.0)
            rho = snr / (snr + 1.0)
            # normalize so the true peak sits at ~1.0 regardless of power
            norm = met_ml / jnp.maximum(jnp.max(jnp.abs(g)), 1e-9) + rho
            met_pn, _ = ofdm_sync_pn(x, m.fft_len)
            nmin = min(norm.shape[0], met_pn.shape[0])
            met = jnp.where(met_pn[:nmin] > 0.5, norm[:nmin], 0.0)
            cfo_of = lambda d: -jnp.angle(g[d]) / m.fft_len
        else:
            met, P = ofdm_sync_pn(x, m.fft_len)
            cfo_of = lambda d: jnp.angle(P[d]) / (m.fft_len // 2)
        return met, cfo_of, 0

    def apply(self, state, x):
        m = self.modem
        n = x.shape[0]
        sym_len = self.sym_len
        occ = m.occupied
        bins = jnp.asarray(m.bins)
        known = jnp.asarray(m.known)
        max_out = self.max_out_for(n)

        st = dict(state)

        # metric once per chunk; acquisition happens INSIDE the per-symbol
        # scan so a frame completing mid-chunk can hand straight to the
        # next preamble (any number of frames per chunk — the round-2
        # chunk-sizing rule is gone)
        met_all, cfo_of, _off = self._metric(x)
        lim = n - (2 * sym_len + m.fft_len)
        met_idx = jnp.arange(met_all.shape[0])
        met_all = jnp.where(met_idx < lim, met_all, 0.0)
        pts = jnp.asarray(m.qpsk)
        nm = met_all.shape[0]
        # Suffix max + first-index-of-max, ONCE per chunk (log-depth
        # associative scan).  The per-symbol acquire used to reduce the
        # whole metric array three times per scan iteration — O(n) work
        # and several dispatch-latency-bound ops inside the hot scan; now
        # acquisition reads two gathers + one fused comparison pass.
        def _comb(a, b):
            # a = left segment, b = right; leftmost max wins ties (the
            # argmax-first convention the plateau search relies on)
            take_a = a[0] >= b[0]
            return (jnp.where(take_a, a[0], b[0]),
                    jnp.where(take_a, a[1], b[1]))

        suffmax, suffarg = jax.lax.associative_scan(
            _comb, (met_all, jnp.arange(nm, dtype=jnp.int32)), reverse=True)

        def acquire(c):
            def do(c):
                # plateau search restricted to ground not yet consumed:
                # met_all[i] for i > anchor - sym_len, i.e. the suffix
                # starting at s (met is nonnegative, so masked-max ==
                # suffix-max; s clamps safely because met_all is zeroed
                # beyond lim)
                s = jnp.clip(c["anchor"] - sym_len + 1, 0, nm - 1)
                mx = suffmax[s]
                d_pk = suffarg[s]
                d = jnp.argmax((met_idx >= s)
                               & (met_all > 0.9 * mx)).astype(jnp.int32)
                found = mx > self.thresh
                cfo = cfo_of(d_pk)
                xr_known = jax.lax.dynamic_slice_in_dim(
                    x, jnp.clip(d + sym_len + m.cp_len - m.cp_len // 2,
                                0, n - m.fft_len), m.fft_len)
                ramp = jnp.exp(-1j * cfo * (
                    d + sym_len + jnp.arange(m.fft_len, dtype=jnp.float32)))
                F = jnp.fft.fft(xr_known * ramp)
                chan = F[bins] / known
                return {
                    "have": c["have"] | found,
                    "anchor": jnp.where(
                        found, d + 2 * sym_len + m.cp_len - m.cp_len // 2,
                        c["anchor"]),
                    "cfo": jnp.where(found, cfo, c["cfo"]),
                    "base": c["base"],
                    "chan": jnp.where(found, chan, c["chan"]),
                    "phase": jnp.where(found, 0.0, c["phase"]),
                    "sym_left": jnp.where(found, self.nsym_data,
                                          c["sym_left"]),
                    "cfo_phase": jnp.where(found, 0.0, c["cfo_phase"]),
                }

            # locked symbols skip the search entirely (most iterations)
            return jax.lax.cond(c["have"], lambda c: dict(c), do, c)

        # Frame-batched emission (the per-symbol scan was latency-bound:
        # ~25 tiny sequential VPU ops per symbol, invariant to unroll).
        # One scan iteration per FRAME: acquisition once, all nsym_data
        # candidate symbol windows sliced in one dynamic_slice + reshape
        # (window stride == sym_len > fft_len), ONE batched FFT, batched
        # equalization — only the decision-directed phase tracking stays
        # sequential (an unrolled nsym-step loop of (occ,)-vector ops).
        nsym = self.nsym_data
        n_frames = self._frame_iters(n)
        krow = jnp.arange(nsym, dtype=jnp.int32)
        fidx = jnp.arange(m.fft_len, dtype=jnp.float32)
        xp = jnp.concatenate(
            [x, jnp.zeros(nsym * sym_len, x.dtype)])

        def frame_step(carry, i):
            c = acquire(carry)
            active = (c["have"] & (krow < c["sym_left"])
                      & (c["anchor"] + krow * sym_len + m.fft_len <= n))
            a0 = jnp.clip(c["anchor"], 0, n)
            wins = jax.lax.dynamic_slice_in_dim(
                xp, a0, nsym * sym_len).reshape(nsym, sym_len)[:, :m.fft_len]
            pos = (a0.astype(jnp.float32)
                   + (krow * sym_len)[:, None].astype(jnp.float32)
                   + fidx[None, :])
            ramp = jnp.exp(-1j * (c["cfo_phase"] + c["cfo"] * pos))
            Fv = jnp.fft.fft(wins * ramp, axis=-1)
            eq = Fv[:, bins] / jnp.where(jnp.abs(c["chan"]) > 1e-9,
                                         c["chan"], 1.0)[None, :]
            # decision-directed common-phase tracking solved as a batched
            # 2-sweep fixed point (round-5): the per-row update
            # phase_k = phase_0 + sum_{j<k} err_j is a prefix sum once the
            # errs are known, and errs barely move between sweeps (they
            # are residual-CFO-sized), so 2 sweeps of whole-frame batched
            # decide+measure reproduce the sequential loop's trajectory —
            # ~nsym x fewer sequential ops in the only sequential section
            phase0 = c["phase"]
            # decision-free init: the 4th-power (QPSK) per-row common
            # phase, expressed as per-row increments wrapped to the
            # nearest pi/2 sector — large rotations that would defeat a
            # zero-init DD sweep are captured before any decision is made
            # (diagonal QPSK: on-constellation r^4 = -4s^4, so negate the
            # sum to cancel the pi offset before dividing the angle by 4)
            p4 = jnp.angle(-jnp.sum((eq * jnp.exp(-1j * phase0)) ** 4,
                                    axis=-1)) / 4.0
            d4 = p4 - jnp.concatenate([jnp.zeros(1, jnp.float32), p4[:-1]])
            d4 = d4 - (np.pi / 2) * jnp.round(d4 / (np.pi / 2))
            errs = jnp.where(active, d4, 0.0)
            for _ in range(2):
                ph_traj = phase0 + jnp.concatenate(
                    [jnp.zeros(1, jnp.float32), jnp.cumsum(errs)[:-1]])
                r = eq * jnp.exp(-1j * ph_traj)[:, None]
                dec = jnp.argmin(jnp.abs(r[..., None]
                                         - pts[None, None, :]) ** 2,
                                 axis=-1)
                e_new = jnp.angle(jnp.sum(r * jnp.conj(pts[dec]), axis=-1))
                errs = jnp.where(active, e_new, 0.0)
            r_all = r * jnp.exp(-1j * errs)[:, None]    # (nsym, occ)
            phase = phase0 + jnp.sum(errs)
            e = jnp.sum(active).astype(jnp.int32)
            first = c["sym_left"] == nsym
            upd = {
                **c,
                "anchor": c["anchor"] + e * sym_len,
                "phase": phase,
                "sym_left": c["sym_left"] - e,
            }
            upd["have"] = jnp.where(c["have"] & (upd["sym_left"] == 0),
                                    jnp.zeros((), jnp.bool_), c["have"])
            out = (jnp.where(active[:, None], r_all, 0)
                   .astype(jnp.complex64),
                   (active & (krow == 0) & first).astype(jnp.uint8),
                   jnp.where(active[:, None], c["chan"][None, :], 0)
                   .astype(jnp.complex64))
            return upd, (out, active)

        st2, (outs, actives) = jax.lax.scan(frame_step, st,
                                            jnp.arange(n_frames))
        # flatten frame tiles and compact the valid rows to a contiguous
        # prefix (a resumed partial frame fills only part of its tile, so
        # tile-local prefixes are not a global prefix): stable argsort on
        # the inactive flag is an order-preserving permutation, gathered
        # once per chunk over ~max_out rows — not inside any scan
        actives = actives.reshape(-1)
        order = jnp.argsort(~actives, stable=True)
        outs = tuple(
            o.reshape((max_out,) + o.shape[2:])[order] for o in outs)
        n_valid = actives.sum().astype(jnp.int32)
        # rebase anchor against consumed fresh samples; roll the CFO ramp
        # phase forward so derotation stays continuous across the boundary
        chunk_len = n - (self.history - 1)
        st2["anchor"] = st2["anchor"] - chunk_len
        st2["base"] = st2["base"] + chunk_len
        ph = st2["cfo_phase"] + st2["cfo"] * chunk_len
        st2["cfo_phase"] = ph - 2 * np.pi * jnp.floor(
            ph / (2 * np.pi) + 0.5)
        return st2, (outs, n_valid)


class OfdmPacketModem:
    """Packet layer over the OFDM burst PHY — the ofdm_mod/ofdm_demod
    contract (gr-digital/python/ofdm.py:35-305 send_pkt/callback shape,
    ofdm_packet_utils.py:84-177 framing): each frame carries
    ``header(2x(whitener_offset<<12 | body_len)) + whiten(payload+crc32)``
    padded with 0x55 to the frame's bit capacity; the receive side parses
    the header off the demapped bit stream, dewhitens, and CRC-checks
    (digital_ofdm_frame_sink.cc:1024-1051 dewhiten + crc path).

    Host-side framing glue (bytes <-> bits): the PHY work — modulate,
    acquisition, equalization, demapping — runs in the jitted
    OfdmModem/OfdmReceiver/OfdmFrameSink path this class composes.
    """

    HDR_BYTES = 4

    def __init__(self, modem: "OfdmModem", nsym_data: int):
        self.modem = modem
        self.nsym_data = int(nsym_data)
        self.frame_bits = self.nsym_data * modem.occupied * modem.bits_per_sym
        cap = self.frame_bits // 8 - self.HDR_BYTES
        self.max_payload = cap - 4          # minus crc32

    def make_burst(self, payload: bytes,
                   whitener_offset: int = 0) -> np.ndarray:
        """payload -> one OFDM burst (host complex64 samples, preambles
        included).  Raises if the payload overflows the frame."""
        from grtpu.digital import packet as pu

        if len(payload) > self.max_payload:
            raise ValueError(
                f"payload {len(payload)} B > frame capacity "
                f"{self.max_payload} B ({self.nsym_data} data symbols)")
        body = pu.whiten(pu.gen_and_append_crc32(payload), whitener_offset)
        hdr = pu.make_header(len(body), whitener_offset)
        pad = self.frame_bits // 8 - self.HDR_BYTES - len(body)
        bits = pu.bytes_to_bits(hdr + body + b"\x55" * pad)
        return np.asarray(self.modem.modulate(bits))

    def parse_frames(self, bits: np.ndarray, flags: np.ndarray):
        """(bits, frame-start flags) from OfdmFrameSink + OfdmReceiver
        port 1 -> list of (crc_ok, payload_bytes), one per detected frame
        (the callback argument pair of ofdm_demod)."""
        from grtpu.digital import packet as pu

        bits = np.asarray(bits).astype(np.uint8)
        spb = self.modem.occupied * self.modem.bits_per_sym
        out = []
        for sym_idx in np.flatnonzero(np.asarray(flags).astype(np.uint8)):
            start = int(sym_idx) * spb
            fb = bits[start: start + self.frame_bits]
            if len(fb) < self.frame_bits:
                break                        # partial frame at stream end
            hdr = pu.bits_to_bytes(fb[: 8 * self.HDR_BYTES])
            parsed = pu.parse_header(hdr)
            if parsed is None:
                out.append((False, b""))
                continue
            body_len, off = parsed
            body_bits = fb[8 * self.HDR_BYTES:
                           8 * (self.HDR_BYTES + body_len)]
            if len(body_bits) < 8 * body_len:
                out.append((False, b""))
                continue
            body = pu.dewhiten(pu.bits_to_bytes(body_bits), off)
            ok, msg = pu.check_crc32(body)
            out.append((ok, msg))
        return out


class OfdmFrameSink(Block):
    """digital_ofdm_frame_sink's demapping half as a fixed-rate block:
    equalized occupied-carrier vectors -> hard bits (QPSK, MSB first, the
    OfdmModem.modulate mapping).  Pairs with OfdmReceiver's port 0."""

    def __init__(self, modem: "OfdmModem", name=None):
        from grtpu.runtime.block import Port

        k = modem.bits_per_sym
        self.in_ports = (Port(jnp.complex64, modem.occupied),)
        self.out_ports = (Port(jnp.uint8),)
        self.interp = modem.occupied * k
        super().__init__(name)
        self.modem = modem

    def apply(self, state, v):
        pts = jnp.asarray(self.modem.qpsk)
        idx = jnp.argmin(jnp.abs(v[..., None] - pts[None, None, :]) ** 2,
                         axis=-1)
        b1 = ((idx >> 1) & 1).astype(jnp.uint8)
        b0 = (idx & 1).astype(jnp.uint8)
        return state, jnp.stack([b1, b0], axis=-1).reshape(-1)
