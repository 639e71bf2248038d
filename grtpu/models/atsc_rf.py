"""ATSC 8-VSB RF front end: FPLL, bit timing, field sync, LMS equalizer.

Reference behavior (gr-atsc, re-designed for vectorized execution — not
ported):
  * GrAtscFPLL.cc — AGC + NCO mix + single-pole I/Q filters + atan2 phase
    detector (clamped to +-pi/2), 2nd-order loop alpha=1e-3, beta=alpha^2/4.
    Inherently per-sample feedback -> lax.scan.
  * atsci_sssr.cc — segment sync & symbol recovery: MMSE fractional-delay
    interpolator (ratio rx_clock/symbol ~2), 4-bit 1001 correlator feeding a
    saturating 832-bin integrator, quad filter (-1,-1,+1,+1) timing-error
    sampler; timing adjust/seg-lock update once per 832-symbol wrap.
    Re-design: because the timing adjustment only changes at wrap
    boundaries, the per-symbol (mu, w, loop) recurrence is linear *within a
    segment* and has a closed form -> one lax.scan step per SEGMENT: compute
    all 832 interpolation positions vectorized, batch-gather 8-tap windows,
    and evaluate the whole segment's symbols as one matmul (832x longer scan
    steps than the reference's per-symbol loop).
  * atsci_fs_correlator_naive.cc — field sync detection: [1001 + PN511]
    match with <=20 bit errors, field 1/2 classified by the middle PN63
    (inverted on field 2, <=5 errors).  Re-designed as one vectorized +-1
    correlation (matmul against the 515-long pattern) over the whole stream.
  * atsci_equalizer_lms.cc — 256-tap LMS trained only on the known 693
    field-sync symbols (BETA 5e-5, npretaps 204 -> data window x[k-51..k+204]
    for output k).  Re-design: LMS training is a 693-step scan once per
    field; the field's remaining 259k symbols are filtered with the frozen
    taps as a single FIR matmul.
  * GrAtscFieldSyncMux/Demux — field assembly on TX (832-symbol field sync
    segment: 1001, PN511, 3xPN63 with middle inverted on field 2, 24 VSB
    mode symbols, 92 reserved, 12 precode symbols) and field disassembly on
    RX.

PN sequences are generated from their A/53 LFSRs (PN511: 9-bit register,
feedback s1^s2^s4^s5^s7^s8, seed 0b10; PN63: 6-bit, feedback s4^s5, seed
0b111001) and verified against the reference tables' prefixes in tests.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from grtpu.ops import mmse_interp
from grtpu.utils import firdes

# f32 equalizer products stay in full f32 (no TF32 rounding)
_HI = lax.Precision.HIGHEST

SEGMENT_LEN = 832                    # symbols, incl. 4 seg-sync symbols
DSEGS_PER_FIELD = 312
SYMBOLS_PER_FIELD = SEGMENT_LEN * (DSEGS_PER_FIELD + 1)


def _lfsr(nbits: int, taps, seed: int, n: int) -> np.ndarray:
    reg = [(seed >> i) & 1 for i in range(nbits)]
    out = np.empty(n, np.uint8)
    for k in range(n):
        out[k] = reg[nbits - 1]
        fb = 0
        for t in taps:
            fb ^= reg[t]
        reg = [fb] + reg[:-1]
    return out


ATSC_PN511 = _lfsr(9, (1, 2, 4, 5, 7, 8), 0b10, 511)
ATSC_PN63 = _lfsr(6, (4, 5), 0b111001, 63)

# 24 VSB-mode bits for 8-VSB (GrAtscFieldSyncMux.cc init_field_sync_common).
_VSB8_MODE = np.array([0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0, 1,
                       1, 1, 1, 1, 1, 0, 1, 0, 1, 1, 0, 1], np.uint8)
SEG_SYNC_BITS = np.array([1, 0, 0, 1], np.uint8)


def field_sync_bits(field: int) -> np.ndarray:
    """The deterministic bit portion of a field sync segment (820 bits)."""
    mid = ATSC_PN63 ^ (1 if field else 0)
    return np.concatenate([SEG_SYNC_BITS, ATSC_PN511, ATSC_PN63, mid,
                           ATSC_PN63, _VSB8_MODE,
                           np.resize(ATSC_PN63, 92)])


def field_sync_codes(field: int, saved12: np.ndarray) -> np.ndarray:
    """Full 832-symbol field sync segment as 3-bit symbol codes (levels via
    2*code-7; binary symbols map to codes {1, 6} = levels -5/+5)."""
    bits = field_sync_bits(field)
    codes = np.where(bits, 6, 1).astype(np.uint8)
    return np.concatenate([codes, np.asarray(saved12, np.uint8)])


# The known +-5 training portion (equalizer): 4 + 511 + 189 symbols.
FS_TRAIN_LEN = 4 + 511 + 3 * 63


def fs_training_levels(field: int) -> np.ndarray:
    bits = field_sync_bits(field)[:FS_TRAIN_LEN]
    return (bits.astype(np.float32) * 10.0 - 5.0)


class AtscFieldSyncMux:
    """TX: (n, 828) data-segment symbol codes -> symbol code stream with
    segment syncs and field sync segments (GrAtscFieldSyncMux analog)."""

    def __init__(self):
        self.saved12 = np.zeros(12, np.uint8)
        self.segno = 0      # 0..311 within field
        self.field = 0

    def __call__(self, data_segments: np.ndarray) -> np.ndarray:
        out = []
        for seg in np.asarray(data_segments, np.uint8):
            if self.segno == 0:
                out.append(field_sync_codes(self.field, self.saved12))
            full = np.concatenate([np.where(SEG_SYNC_BITS, 6, 1
                                            ).astype(np.uint8), seg])
            out.append(full)
            self.saved12 = full[-12:]
            self.segno += 1
            if self.segno == DSEGS_PER_FIELD:
                self.segno = 0
                self.field ^= 1
        return np.concatenate(out) if out else np.zeros(0, np.uint8)


def vsb_modulate(baseband: np.ndarray, if_freq_norm: float,
                 samples_per_symbol: float,
                 vestige_frac: float = 0.0575) -> np.ndarray:
    """Real RRC-shaped baseband (pilot = DC offset) -> 8-VSB real passband.

    Applies the A/53 vestigial weighting in the frequency domain: full upper
    sideband, root-raised-cosine edge ramp through DC (the pilot) spanning
    +-vestige_frac * symbol_rate (0.0575 = alpha/2 for alpha=.115, i.e. the
    0.31 MHz vestige).  The ramp W(d) = sin(pi/4 (1 + d/v)) satisfies
    W^2(d) + W^2(-d) = 1, so after the receiver's matched RRC band edge the
    folded response is flat — this is what keeps both the FPLL pilot phase
    detector clean and the near-DC data undistorted.  The reference has no
    TX RF path (hardware does it); this utility exists for loopback testing
    of the RX chain.
    """
    x = np.asarray(baseband, np.float64)
    n = len(x)
    X = np.fft.fft(x)
    f = np.fft.fftfreq(n)                      # cycles/sample
    v = vestige_frac / samples_per_symbol      # vestige half-width
    u = np.clip(f / v, -1.0, 1.0)
    W = np.sin(np.pi / 4 * (1 + u))            # RRC edge: W(0)=sqrt(.5)
    a = np.fft.ifft(X * W * 2.0)               # analytic-ish VSB baseband
    return np.real(a * np.exp(2j * np.pi * if_freq_norm * np.arange(n))
                   ).astype(np.float32)


# ---------------------------------------------------------------------------
# FPLL (GrAtscFPLL.cc)
# ---------------------------------------------------------------------------
FPLL_AGC_REFERENCE = 2.5 * 3.125     # fpll_btloop_coupling.h
FPLL_AGC_RATE = 0.25e-6


class FpllState(NamedTuple):
    gain: jnp.ndarray
    phase: jnp.ndarray
    freq: jnp.ndarray
    fi: jnp.ndarray    # filtered I
    fq: jnp.ndarray    # filtered Q


def fpll_init_state(initial_freq: float, fs: float) -> FpllState:
    f = lambda v: jnp.asarray(v, jnp.float32)
    return FpllState(gain=f(1e-3), phase=f(0.0),
                     freq=f(2 * np.pi * initial_freq / fs),
                     fi=f(0.0), fq=f(0.0))


def fpll(state: FpllState, x, fs: float):
    """Real passband -> baseband I (pilot at DC).  Per-sample scan."""
    iir_alpha = np.float32(1 - np.exp(-1.0 / fs / 5e-6))
    alpha, beta = np.float32(1e-3), np.float32(1e-3 ** 2 / 4)
    limit = np.float32(np.pi / 2)

    two_pi = np.float32(2 * np.pi)

    def step(st: FpllState, xk):
        inp = xk * st.gain
        gain = st.gain + (FPLL_AGC_REFERENCE - jnp.abs(inp)) * FPLL_AGC_RATE
        # wrap each step: unbounded phase loses float32 precision
        phase = jnp.mod(st.phase + st.freq, two_pi)
        a_sin, a_cos = jnp.sin(phase), jnp.cos(phase)
        I, Q = inp * a_sin, inp * a_cos
        fi = st.fi + iir_alpha * (I - st.fi)
        fq = st.fq + iir_alpha * (Q - st.fq)
        pd = jnp.clip(jnp.arctan2(fq, fi), -limit, limit)
        return (FpllState(gain=gain, phase=phase + alpha * pd,
                          freq=st.freq + beta * pd, fi=fi, fq=fq), I)

    return lax.scan(step, state, x)


def fpll_chunked(state: FpllState, x, fs: float, chunk: int = 256,
                 sweeps: int = 2):
    """Chunk-batched FPLL with fpll()'s loop semantics (round-5: the
    per-sample scan is op-latency bound at ~0.8 Msamples/s single
    stream; this runs the same loop at chunk granularity).

    Per chunk: the AGC gain recurrence g' = g(1 - RATE|x|) + RATE*REF is
    linear with KNOWN coefficients -> exact cumprod/cumsum closed form;
    the PLL trajectory is solved by fixed point — predict the phase ramp
    with frozen freq, batch-compute the filtered I/Q phase detector, and
    re-solve freq/phase from the error batch in cumsum form (``sweeps``
    passes; the loop gains alpha=1e-3, beta=2.5e-7 are tiny, so the
    frozen-ramp error is far inside the detector's pull range).
    """
    iir_alpha = np.float32(1 - np.exp(-1.0 / fs / 5e-6))
    alpha, beta = np.float32(1e-3), np.float32(1e-3 ** 2 / 4)
    limit = np.float32(np.pi / 2)
    two_pi = np.float32(2 * np.pi)
    from grtpu.ops.dsp import linear_recurrence_const

    n = x.shape[0]
    pad = (-n) % chunk
    xp = jnp.pad(x, (0, pad))

    def step(st, seg):
        # --- AGC closed form (gain BEFORE update scales each sample) ---
        a_in = jnp.abs(seg)
        A = 1.0 - FPLL_AGC_RATE * a_in
        B = jnp.full_like(seg, FPLL_AGC_RATE * FPLL_AGC_REFERENCE)
        P = jnp.cumprod(A)
        S = jnp.cumsum(B / jnp.maximum(P, 1e-30))
        g_after = P * (st.gain + S)
        g_before = jnp.concatenate([st.gain[None], g_after[:-1]])
        inp = seg * g_before
        # --- PLL fixed point ---
        pd = jnp.zeros(seg.shape[0], jnp.float32)
        for _ in range(sweeps):
            freq_traj = st.freq + beta * jnp.cumsum(pd)
            # phase used at step t: prev phase + prev freq (+ alpha*pd)
            dphi = freq_traj + alpha * pd
            ph = st.phase + st.freq + jnp.concatenate(
                [jnp.zeros(1, jnp.float32), jnp.cumsum(dphi)[:-1]])
            ph = jnp.mod(ph, two_pi)
            I = inp * jnp.sin(ph)
            Q = inp * jnp.cos(ph)
            fi, _ = linear_recurrence_const(
                float(1.0 - iir_alpha), iir_alpha * I, st.fi)
            fq, _ = linear_recurrence_const(
                float(1.0 - iir_alpha), iir_alpha * Q, st.fq)
            pd = jnp.clip(jnp.arctan2(fq, fi), -limit, limit)
        new = FpllState(gain=g_after[-1],
                        phase=jnp.mod(ph[-1] + alpha * pd[-1], two_pi),
                        freq=freq_traj[-1], fi=fi[-1], fq=fq[-1])
        return new, I

    st2, ys = lax.scan(step, state, xp.reshape(-1, chunk))
    return st2, ys.reshape(-1)[:n]


def remove_dc(x, dc0, alpha: float = 1e-5):
    """Pilot removal: y = x - single_pole_iir(x) (fpll.py chain)."""
    from grtpu.ops.dsp import single_pole_iir
    y, dc = single_pole_iir(x, dc0, np.float32(alpha))
    return x - y, dc


# ---------------------------------------------------------------------------
# Bit timing loop (atsci_sssr.cc + atsci_interpolator), segment-batched.
# ---------------------------------------------------------------------------
LOOP_FILTER_TAP = 0.00025
ADJUSTMENT_GAIN = 1.0e-5 / (10 * SEGMENT_LEN) * 10e3
SSI_MIN, SSI_MAX = -16, 15
MIN_SEG_LOCK_CORRELATION_VALUE = 5
SYMBOL_INDEX_OFFSET = 3
_MMSE_TABLE = mmse_interp.mmse_taps().astype(np.float32)   # (129, 8)
_NTAPS_INTERP = _MMSE_TABLE.shape[1]


class BtlState(NamedTuple):
    mu: jnp.ndarray          # fractional interpolator phase
    w: jnp.ndarray           # samples per symbol estimate
    loop: jnp.ndarray        # single-pole loop filter state
    timing_adjust: jnp.ndarray
    integrator: jnp.ndarray  # (832,) saturating seg-sync integrator
    seg_locked: jnp.ndarray
    symbol_index: jnp.ndarray
    corr_sr: jnp.ndarray     # 4-bit 1001 correlator shift register
    quad_delay: jnp.ndarray  # (4,) quad filter delay line


def btl_init_state(ratio: float) -> BtlState:
    f = lambda v: jnp.asarray(v, jnp.float32)
    return BtlState(mu=f(0.5), w=f(ratio), loop=f(0.0), timing_adjust=f(0.0),
                    integrator=jnp.full(SEGMENT_LEN, SSI_MIN, jnp.int32),
                    seg_locked=jnp.asarray(False),
                    symbol_index=jnp.asarray(0, jnp.int32),
                    corr_sr=jnp.asarray(0, jnp.int32),
                    quad_delay=jnp.zeros(4, jnp.float32))


def _btl_segment(st: BtlState, window):
    """Process one 832-symbol segment from `window` (samples starting at the
    current interpolator base).  Returns new state, symbols (832,), info.

    The reference updates (mu, w, loop) per symbol, but timing_adjust is
    constant between 832-symbol wraps, so the recurrence is closed-form:
      loop_j = ta + (loop_0 - ta) * (1-tap)^j          (j updates applied)
      pos_j  = pos_0 + j*w + GAIN * sum_{i<=j} loop_i
    """
    n = SEGMENT_LEN
    ta = st.timing_adjust
    decay = np.float32(1.0 - LOOP_FILTER_TAP)
    j = jnp.arange(1, n, dtype=jnp.float32)
    pw = decay ** j                                     # (1-tap)^j
    loop_traj = ta + (st.loop - ta) * pw                # loop after j updates
    # positions: symbol 0 interpolates at mu (before any update); symbol k
    # at mu + k*w + GAIN * (loop_1 + .. + loop_k)
    csum = jnp.cumsum(loop_traj)
    pos = jnp.concatenate([jnp.zeros(1, jnp.float32),
                           j * st.w + np.float32(ADJUSTMENT_GAIN) * csum])
    pos = pos + st.mu
    base = jnp.floor(pos)
    mu_frac = pos - base
    idx = base.astype(jnp.int32)

    # batched 8-tap MMSE interpolation: windows (832, 8) x phase taps
    phase = jnp.round(mu_frac * mmse_interp.NSTEPS).astype(jnp.int32)
    taps = jnp.asarray(_MMSE_TABLE)[phase]              # (832, 8)
    wins = window[idx[:, None] + np.arange(_NTAPS_INTERP)]
    symbols = jnp.sum(taps * wins, axis=1)

    # --- sssr segment update, vectorized over the 832 symbols ---
    # quad filter y[k] = x[k-3] + x[k-2] - x[k-1] - x[k]; delay line holds
    # [d0..d3] = [x[-1], x[-2], x[-3], x[-4]]
    xq = jnp.concatenate([st.quad_delay[::-1], symbols])  # chronological
    quad = xq[1:n + 1] + xq[2:n + 2] - xq[3:n + 3] - xq[4:n + 4]
    # digital correlator: 1001 on sign bits; shift register carries the
    # previous segment's last bits (sr bit3 = b[-1], bit2 = b[-2], ...)
    bits = (symbols >= 0).astype(jnp.int32)
    sr_bits = jnp.concatenate(
        [jnp.stack([(st.corr_sr >> 1) & 1, (st.corr_sr >> 2) & 1,
                    (st.corr_sr >> 3) & 1]), bits])
    corr = ((sr_bits[3:] == 1) & (sr_bits[2:-1] == 0)
            & (sr_bits[1:-2] == 0) & (sr_bits[:-3] == 1))
    weight = jnp.where(corr, 2, -1)
    integ = jnp.clip(st.integrator + weight, SSI_MIN, SSI_MAX)

    best = jnp.argmax(integ).astype(jnp.int32)
    locked = integ[best] >= MIN_SEG_LOCK_CORRELATION_VALUE
    new_ta = quad[best]
    symbol_index = (SYMBOL_INDEX_OFFSET - 1 - best) % SEGMENT_LEN

    # state after 832 (mu, w, loop) updates
    new_loop = ta + (st.loop - ta) * decay ** n
    end_pos = pos[-1] + st.w + np.float32(ADJUSTMENT_GAIN) * (
        ta + (st.loop - ta) * decay ** n)
    consumed = jnp.floor(end_pos).astype(jnp.int32)
    new_mu = end_pos - consumed

    new_st = BtlState(
        mu=new_mu, w=st.w, loop=new_loop, timing_adjust=new_ta,
        integrator=integ, seg_locked=locked, symbol_index=symbol_index,
        corr_sr=(bits[-1] << 3) | (bits[-2] << 2) | (bits[-3] << 1)
        | bits[-4],
        quad_delay=symbols[-4:][::-1])
    # indices of emitted symbols relative to segment grid: the symbol_index
    # of the FIRST symbol of the *next* segment equals symbol_index computed
    # at wrap; symbols in this segment are at st.symbol_index + k (mod 832).
    return new_st, symbols, consumed, locked, symbol_index


# window large enough for one segment at ratio <= 2.75 plus interp taps
BTL_WINDOW = 2336


def bit_timing_loop(state: BtlState, samples, nsegments: int):
    """Recover `nsegments` x 832 symbols from `samples`.

    Returns (state', symbols (nsegments*832,), first_symbol_offset, info).
    `first_symbol_offset[s]` is the stream position (mod 832) of segment
    s's first output symbol relative to true segment-sync boundaries, valid
    once `locked[s]` is True.  Caller must supply len(samples) >=
    nsegments * ratio * 832 + BTL_WINDOW.
    """

    def step(carry, _):
        st, base = carry
        window = lax.dynamic_slice(samples, (base,), (BTL_WINDOW,))
        pre_index = st.symbol_index
        st2, symbols, consumed, locked, sync_index = _btl_segment(st, window)
        # position of this segment's first symbol within the 832 grid:
        # after the wrap, symbol_index was set so that the NEXT symbol has
        # index sync_index; the segment we just emitted started at
        # pre_index + 1 (the reference increments before the wrap check).
        first_idx = (pre_index + 1) % SEGMENT_LEN
        st3 = st2._replace(symbol_index=sync_index)
        return (st3, base + consumed), (symbols, first_idx, locked,
                                        sync_index)

    (state, consumed_total), (sym, first_idx, locked, sync_index) = lax.scan(
        step, (state, jnp.asarray(0, jnp.int32)), None, length=nsegments)
    return (state, sym.reshape(-1), first_idx, locked, sync_index,
            consumed_total)


# ---------------------------------------------------------------------------
# Field sync correlator (atsci_fs_correlator_naive.cc), vectorized.
# ---------------------------------------------------------------------------
PN511_ERROR_LIMIT = 20
PN63_ERROR_LIMIT = 5
_FS_PATTERN = np.concatenate([SEG_SYNC_BITS, ATSC_PN511]).astype(np.float32)
_PN63_OFFSET = 4 + 511 + 63          # start of the middle PN63


def fs_correlate(symbols) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Find field sync starts in a symbol stream.

    Returns (tag, field) arrays of len(symbols): tag[p] True when a field
    sync segment starts at p; field[p] in {0,1} classifies it.
    """
    from grtpu.ops.fir import fir_filter
    n = symbols.shape[0]
    bits_pm = jnp.where(symbols >= 0, 1.0, -1.0).astype(jnp.float32)
    # matched correlation m[p] = sum_k pattern[k]*bits[p+k] via the matmul
    # FIR (convolution convention: reverse the pattern; pad the tail so
    # every start position is evaluated).
    pat = (_FS_PATTERN * 2 - 1).astype(np.float32)
    L = len(pat)
    xp = jnp.concatenate([bits_pm, jnp.zeros(L - 1, jnp.float32)])
    m = fir_filter(xp, jnp.asarray(pat[::-1].copy()), 1)[:n]
    errors_511 = (L - m) / 2
    hit = errors_511 < PN511_ERROR_LIMIT

    pat63 = (ATSC_PN63.astype(np.float32) * 2 - 1)
    xp63 = jnp.concatenate([bits_pm, jnp.zeros(62, jnp.float32)])
    m63 = fir_filter(xp63, jnp.asarray(pat63[::-1].copy()), 1)[:n]
    err63 = (63 - m63) / 2
    # err63 at position p+_PN63_OFFSET classifies field at start p
    err63_at = jnp.concatenate(
        [err63[_PN63_OFFSET:], jnp.full(_PN63_OFFSET, 31.0)])[:n]
    field1 = err63_at <= PN63_ERROR_LIMIT
    field2 = err63_at >= 63 - PN63_ERROR_LIMIT
    tag = hit & (field1 | field2)
    return tag, jnp.where(field2, 1, 0)


# ---------------------------------------------------------------------------
# LMS equalizer (atsci_equalizer_lms.cc), train-per-field + matmul filter.
# ---------------------------------------------------------------------------
EQ_NTAPS = 256
EQ_NPRETAPS = int(EQ_NTAPS * 0.8)
EQ_CURSOR = EQ_NTAPS - EQ_NPRETAPS - 1      # 51: y[k] uses x[k-51 .. k+204]
EQ_BETA = 0.00005


@jax.jit
def _lms_train(taps, x_train, d_train):
    """NLMS adaptation over the field sync training window.

    x_train: (FS_TRAIN_LEN + EQ_NTAPS - 1,) input samples such that training
    symbol k sees window x_train[k : k + EQ_NTAPS]; d_train: known levels.
    The reference uses raw LMS (BETA 5e-5) and relies on a converged AGC
    plus many fields; normalizing the step by ||x||^2 makes convergence
    scale-free and fast enough to be useful from the first field."""
    wins = x_train[jnp.arange(FS_TRAIN_LEN)[:, None] + np.arange(EQ_NTAPS)]
    mu = np.float32(0.25)

    def step(t, wd):
        w, d = wd
        y = jnp.dot(w, t, precision=_HI)
        e = y - d
        return t - mu * e * w / (jnp.dot(w, w, precision=_HI) + 1e-3), y

    return lax.scan(step, taps, (wins, d_train))


@jax.jit
def _eq_filter(taps, x):
    """Filter with frozen taps: y[k] = sum_i taps[i] x[k + i] over windows of
    x (caller supplies EQ_NTAPS-1 context)."""
    n = x.shape[0] - EQ_NTAPS + 1
    # correlation via conv: flip taps
    return jnp.convolve(x, taps[::-1], mode="valid")[:n]


class AtscEqualizerLms:
    """Per-field: adapt on the known field-sync symbols, then equalize the
    field's data with the frozen taps (one matmul FIR).

    Differences from the reference (which leans on a converged AGC and many
    fields of adaptation): on the first field the taps are initialized to a
    scale-matched delta at the cursor (the LS-optimal single tap), and each
    field runs `sweeps` LMS passes over the 704 known symbols instead of
    one — so the equalizer is useful from the very first field."""

    def __init__(self, sweeps: int = 8):
        self.taps = None
        self.sweeps = sweeps

    def process_field(self, x_field):
        """x_field: symbols of one field starting at its field sync, with
        EQ_CURSOR samples of extra left context and EQ_NTAPS-EQ_CURSOR-1 of
        right context: len = SYMBOLS_PER_FIELD + EQ_NTAPS - 1."""
        x_field = np.asarray(x_field, np.float32)
        # field type from the middle PN63 polarity (sign vote)
        mid = x_field[EQ_CURSOR + _PN63_OFFSET:
                      EQ_CURSOR + _PN63_OFFSET + 63]
        votes = np.sum(np.sign(mid) == (ATSC_PN63.astype(np.float32) * 2 - 1))
        which_field = 0 if votes >= 32 else 1
        d_np = fs_training_levels(which_field)
        if self.taps is None:
            x_cur = x_field[EQ_CURSOR: EQ_CURSOR + FS_TRAIN_LEN]
            scale = float(np.dot(x_cur, d_np) / (np.dot(x_cur, x_cur) + 1e-9))
            taps = np.zeros(EQ_NTAPS, np.float32)
            taps[EQ_CURSOR] = scale
            self.taps = jnp.asarray(taps)
        # training window for symbol k starts at x_field[k]
        xt = jnp.asarray(x_field[: FS_TRAIN_LEN + EQ_NTAPS - 1])
        d = jnp.asarray(d_np)
        for _ in range(self.sweeps):
            self.taps, _ = _lms_train(self.taps, xt, d)
        return np.asarray(_eq_filter(self.taps, jnp.asarray(x_field)))


class AtscEqualizerNop:
    """Pass-through equalizer (atsci_equalizer_nop.cc:47-118: output =
    input, cursor-aligned) — the family's null member, useful as the
    baseline that *shows* when an adaptive equalizer earns its keep."""

    def process_field(self, x_field):
        x_field = np.asarray(x_field, np.float32)
        return x_field[EQ_CURSOR: EQ_CURSOR + SYMBOLS_PER_FIELD]


# --- decision-feedback equalizer (atsci_equalizer_lms2.cc:36-37,268-287:
# NFFTAPS=64 feedforward + NFBTAPS=192 feedback over sliced past outputs,
# trained on the 704 known field-sync symbols.  The reference ships with
# the feedback adaptation stubbed out ("kludge()" returns 0 at :283 — the
# fb taps never move); this is the design completed: both tap sets adapt,
# NLMS-normalized, and during training the feedback ring holds the KNOWN
# training levels (correct-decision assumption, standard DFE training). ---
DFE_NFF = 64
DFE_NFB = 192


def _slice8(y):
    """Nearest 8-VSB level in {-7,-5,...,+7} (atsci_equalizer_lms2.cc
    slice(), :56-74)."""
    m = jnp.clip(jnp.round((y + 7.0) / 2.0), 0.0, 7.0)
    return 2.0 * m - 7.0


@jax.jit
def _dfe_train(wff, wfb, x_train, d_train, mu):
    """One NLMS sweep over the training window at step size ``mu``.

    x_train: (FS_TRAIN_LEN + DFE_NFF - 1,) such that training symbol k sees
    the forward window x_train[k : k + DFE_NFF]; d_train: known levels.
    wfb[i] multiplies decision d[k-1-i] (past decisions, newest first).
    Callers gear-shift mu downward across sweeps — the reference's own
    "FIXME add gear-shifting" (atsci_equalizer_lms2.cc:271): a large step
    acquires, a small step cuts the steady-state misadjustment below the
    8-VSB decision margin."""
    wins_x = x_train[jnp.arange(FS_TRAIN_LEN)[:, None] + np.arange(DFE_NFF)]
    dpad = jnp.concatenate([jnp.zeros(DFE_NFB, jnp.float32), d_train])
    wins_d = dpad[jnp.arange(FS_TRAIN_LEN)[:, None]
                  + (DFE_NFB - 1) - np.arange(DFE_NFB)]
    # the first NFB training symbols' "past decisions" are really the
    # previous field's unknown data, not the zeros in dpad — adapting on
    # that mismatch biases every tap; train only once the known-decision
    # ring is full (512 clean equations for 256 taps remain)
    adapt = (jnp.arange(FS_TRAIN_LEN) >= DFE_NFB).astype(jnp.float32)

    def step(carry, inp):
        wf, wb = carry
        xw, dw, d, a = inp
        y = jnp.dot(wf, xw, precision=_HI) - jnp.dot(wb, dw, precision=_HI)
        e = a * (y - d)
        nrm = (jnp.dot(xw, xw, precision=_HI)
               + jnp.dot(dw, dw, precision=_HI) + 1e-3)
        return (wf - mu * e * xw / nrm, wb + mu * e * dw / nrm), y

    (wff, wfb), _ = lax.scan(step, (wff, wfb),
                             (wins_x, wins_d, d_train, adapt))
    return wff, wfb


@jax.jit
def _dfe_filter(wff, wfb, x_ff, d_init):
    """Decision-feedback filtering: the feedforward part is ONE dense FIR
    over the whole field (one matmul); only the inherently sequential
    feedback — a 192-tap dot against the carried ring of sliced past
    decisions — runs in the scan (unroll amortizes iteration overhead)."""
    ff = jnp.convolve(x_ff, wff[::-1], mode="valid")

    def step(ring, ffk):
        y = ffk - jnp.dot(wfb, ring, precision=_HI)
        d = _slice8(y)
        return jnp.concatenate([d[None], ring[:-1]]), y

    _, y = lax.scan(step, d_init, ff, unroll=8)
    return y


class AtscEqualizerDfe:
    """Per-field decision-feedback equalizer (the lms2 family member):
    adapt FF+FB taps on the known field-sync symbols (``sweeps`` NLMS
    passes), then equalize the field's data with frozen taps and live
    decision feedback.  Consumes the same (SYMBOLS_PER_FIELD +
    EQ_NTAPS - 1)-sample window as AtscEqualizerLms: the forward window of
    symbol k is x_field[k + EQ_CURSOR : k + EQ_CURSOR + DFE_NFF] (cursor at
    the first FF tap; post-cursor ISI is the feedback taps' job)."""

    def __init__(self, sweeps: int = 8):
        self.wff = None
        self.wfb = None
        self.sweeps = sweeps

    def process_field(self, x_field):
        x_field = np.asarray(x_field, np.float32)
        mid = x_field[EQ_CURSOR + _PN63_OFFSET:
                      EQ_CURSOR + _PN63_OFFSET + 63]
        votes = np.sum(np.sign(mid) == (ATSC_PN63.astype(np.float32) * 2 - 1))
        which_field = 0 if votes >= 32 else 1
        d_np = fs_training_levels(which_field)
        if self.wff is None:
            x_cur = x_field[EQ_CURSOR: EQ_CURSOR + FS_TRAIN_LEN]
            scale = float(np.dot(x_cur, d_np) / (np.dot(x_cur, x_cur) + 1e-9))
            wff = np.zeros(DFE_NFF, np.float32)
            wff[0] = scale                       # cursor = first FF tap
            self.wff = jnp.asarray(wff)
            self.wfb = jnp.zeros(DFE_NFB, jnp.float32)
        xt = jnp.asarray(x_field[EQ_CURSOR:
                                 EQ_CURSOR + FS_TRAIN_LEN + DFE_NFF - 1])
        d = jnp.asarray(d_np)
        for s in range(self.sweeps):
            # gear shift: halve mu each sweep after the first half
            mu = 0.25 * (0.5 ** max(0, s - self.sweeps // 2))
            self.wff, self.wfb = _dfe_train(self.wff, self.wfb, xt, d,
                                            jnp.float32(mu))
        # field data: the scan starts at the field sync itself, so the
        # decision ring warms up over the full 832-symbol sync segment
        # before the first data segment — the zero init only touches
        # equalized output nobody demuxes
        ring = jnp.zeros(DFE_NFB, jnp.float32)
        x_ff = jnp.asarray(
            x_field[EQ_CURSOR: EQ_CURSOR + SYMBOLS_PER_FIELD + DFE_NFF - 1])
        return np.asarray(_dfe_filter(self.wff, self.wfb, x_ff, ring))


EQUALIZERS = {"nlms": AtscEqualizerLms, "lms2": AtscEqualizerDfe,
              "dfe": AtscEqualizerDfe, "nop": AtscEqualizerNop}


# ---------------------------------------------------------------------------
# Field sync demux (GrAtscFieldSyncDemux analog) + full RF receiver.
# ---------------------------------------------------------------------------
def fs_demux(symbols: np.ndarray, fs_positions: np.ndarray) -> np.ndarray:
    """Extract data-segment symbols for each complete field whose field sync
    starts at p: 312 segments of 828 (segment syncs stripped)."""
    fields = []
    for p in fs_positions:
        start = p + SEGMENT_LEN
        end = p + SYMBOLS_PER_FIELD
        if end > len(symbols):
            break
        segs = symbols[start:end].reshape(DSEGS_PER_FIELD, SEGMENT_LEN)
        fields.append(segs[:, 4:])
    return (np.stack(fields) if fields
            else np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4)))


class AtscRfReceiver:
    """Full RF chain: FPLL -> LPF -> DC removal -> bit timing -> field sync
    -> LMS equalizer -> demux.  Produces per-field (312, 828) soft symbols
    ready for the transport decoder (grtpu.models.atsc.AtscReceiver)."""

    def __init__(self, fs: float, if_freq: float,
                 ratio: float | None = None, equalizer: str = "nlms",
                 chunked_fpll: bool = True):
        self.fs = fs
        self.if_freq = if_freq
        # chunk-batched FPLL by default (fpll_chunked: same loop in
        # closed form per 256-sample chunk); chunked_fpll=False keeps
        # the per-sample reference scan
        self.chunked_fpll = bool(chunked_fpll)
        self.ratio = ratio if ratio is not None else fs / 10.76e6
        self.fpll_state = fpll_init_state(if_freq, fs)
        self.btl_state = btl_init_state(self.ratio)
        # selectable family, as the reference's -e flag chooses among
        # atsci_equalizer_{nop,lms,lms2} (atsc_rx.py / GrAtscEqualizer)
        self.eq = EQUALIZERS[equalizer]()
        # Matched RRC as a passband filter BEFORE the FPLL (fpll.py: a half
        # symbol-rate lowpass RRC heterodyned up to the band center).  This
        # is load-bearing: the band-edge shaping suppresses the data power
        # around the pilot so the FPLL's atan2 detector sees a clean pilot.
        sym_rate = fs / self.ratio
        ntaps = 279
        lp = firdes.root_raised_cosine(1.0, fs, sym_rate / 2, 0.115, ntaps)
        i = np.arange(ntaps)
        # band center = pilot + symbol_rate/4 (atsc_fpll.cc:59: the pilot is
        # 0.31 MHz above the lower edge; the RRC is centered on the band)
        arg = 2 * np.pi * (if_freq + sym_rate / 4) / fs
        self.pb_rrc = (lp * 2 * np.cos(arg * i)).astype(np.float32)
        # post-FPLL low pass (fpll.py chain): pass the VSB baseband
        # (1.115/(2*ratio) of fs single-sided), stop the 2*IF mixing image
        bw = 0.5 * 1.115 / self.ratio
        self.lpf = firdes.low_pass(1.0, fs, (bw + 0.04) * fs, 0.05 * fs)
        self.dc = jnp.asarray(0.0, jnp.float32)

    def process(self, samples: np.ndarray) -> np.ndarray:
        from grtpu.ops.fir import fir_filter
        kp = len(self.pb_rrc)
        pbf = fir_filter(jnp.concatenate(
            [jnp.zeros(kp - 1, jnp.float32),
             jnp.asarray(samples, jnp.float32)]),
            jnp.asarray(self.pb_rrc), 1)
        if self.chunked_fpll:
            self.fpll_state, bb = fpll_chunked(self.fpll_state, pbf,
                                               self.fs)
        else:
            self.fpll_state, bb = fpll(self.fpll_state, pbf, self.fs)
        k = len(self.lpf)
        bbf = fir_filter(jnp.concatenate(
            [jnp.zeros(k - 1, jnp.float32), bb]), jnp.asarray(self.lpf), 1)
        bbd, self.dc = remove_dc(bbf, self.dc)
        nseg = int((len(samples) - BTL_WINDOW) // (self.ratio * SEGMENT_LEN))
        (self.btl_state, sym, _, locked, _, _) = bit_timing_loop(
            self.btl_state, bbd, nseg)
        sym = np.asarray(sym)
        locked = np.asarray(locked)
        tag, field = (np.asarray(a) for a in fs_correlate(jnp.asarray(sym)))
        fs_pos = np.nonzero(tag)[0]
        # Skip field syncs detected during acquisition: the FPLL/AGC pull-in
        # garbles early symbols even though the (sign-based) sync pattern can
        # still match, and an equalizer trained there diverges.  Require the
        # bit timing loop to have been seg-locked for a few segments.
        if not locked.any():
            return np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4))
        min_pos = max((int(np.argmax(locked)) + 4) * SEGMENT_LEN,
                      int(self.fs * 0.004 / self.ratio))  # ~4ms FPLL settle
        out_fields = []
        for p in fs_pos:
            if p < max(min_pos, EQ_CURSOR):
                continue
            if p + SYMBOLS_PER_FIELD + EQ_NTAPS > len(sym):
                break
            xf = sym[p - EQ_CURSOR:
                     p - EQ_CURSOR + SYMBOLS_PER_FIELD + EQ_NTAPS - 1]
            eq_out = self.eq.process_field(xf)
            out_fields.append(fs_demux(eq_out, np.array([0]))[0])
        return (np.stack(out_fields) if out_fields
                else np.zeros((0, DSEGS_PER_FIELD, SEGMENT_LEN - 4)))
