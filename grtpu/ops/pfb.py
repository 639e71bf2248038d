"""Polyphase filterbank ops: channelizer, synthesizer, arbitrary resampler.

Analogs (SURVEY.md §2.3):
  * gr_pfb_channelizer_ccf (gnuradio-core/src/lib/filter/
    gr_pfb_channelizer_ccf.cc:44-200): N-way commutated polyphase FIR +
    N-point transform splitting one wideband stream into N channels.
  * gr_pfb_synthesis_filterbank_ccf: the inverse.
  * gr_pfb_arb_resampler_ccf (gr_pfb_arb_resampler_ccf.cc:42-209):
    filter-size-phase bank + derivative bank, accumulator-stepped arbitrary
    rate with linear interpolation between adjacent phases.
  * gr_pfb_decimator_ccf / gr_pfb_interpolator_ccf.

Design: no commutator loop — the polyphase decomposition is a
reshape/stride pattern, the per-branch FIRs are one batched contraction, and
the transform across branches is XLA's batched FFT.  The arbitrary resampler
has *no feedback*: every output's (input index, phase, fraction) is a
closed-form function of the rational rate, so the whole resample is gather +
two contractions — fully parallel, unlike the reference's sequential
accumulator loop.

Channel convention: channel c of ``channelize`` is centered at +c*fs/N
(wrapping: c > N/2 are negative frequencies), output rate fs/N:

    y_c[t] = sum_m h[m] x[tN - m] e^{-2i pi c m / N}
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.ops.fir import split_bf16

_HI = jax.lax.Precision.HIGHEST


def polyphase_taps(proto: np.ndarray, nphases: int) -> np.ndarray:
    """(nphases, kp) bank: phase p = proto[p::nphases], zero-padded."""
    k = len(proto)
    kp = -(-k // nphases)
    tp = np.zeros(nphases * kp, proto.dtype)
    tp[:k] = proto
    return tp.reshape(kp, nphases).T.copy()


def channelize(x: jnp.ndarray, proto_taps: np.ndarray, nchan: int,
               oversample: int = 1, precision: str = "f32") -> jnp.ndarray:
    """Polyphase channelizer; see module docstring.

    ``precision`` (honored by both the critically-sampled and the
    oversampled path):
      * "f32"    — Precision.HIGHEST matmuls, exact;
      * "bf16x3" — split-word 3-pass, ~4e-6 rel err (~107 dB);
      * "bf16"   — single-pass (~48-53 dB), ~2.7x the f32 rate — for
        chains whose demods lock far below that floor.

    Args:
      x: input with ``kp * nchan`` history samples (kp = ceil(K/N) taps per
         branch): length n + kp*nchan, n % nchan == 0.
      proto_taps: prototype lowpass at input rate, cutoff ~fs/(2N).
      oversample: per-channel output rate multiplier (the reference's
        filter-index-rotation oversampling, gr_pfb_channelizer_ccf.cc:44-200,
        realized here as a stride-N/os commutator + per-step phase twist);
        must divide nchan.

    Returns (oversample * n // nchan, nchan) complex64, time-major; channel
    c at +c*fs/N, output rate oversample*fs/N.
    """
    N = nchan
    os_ = oversample
    if N % os_:
        raise ValueError("oversample must divide nchan")
    if precision not in ("f32", "bf16", "bf16x3"):
        raise ValueError(
            f"precision must be 'f32', 'bf16' or 'bf16x3', got {precision!r}")
    step = N // os_
    bank = polyphase_taps(np.asarray(proto_taps), N)  # (N, kp)
    kp = bank.shape[1]
    hist = kp * N
    n = x.shape[0] - hist
    T = (n // N) * os_

    def cmm(a, m):
        # precision-aware complex matmul built from real contractions
        if precision in ("bf16x3", "bf16"):
            def rmm(p, q):
                ph = p.astype(jnp.bfloat16)
                qh = q.astype(jnp.bfloat16)

                def mm(u, v):
                    return jax.lax.dot_general(
                        u, v, (((1,), (0,)), ((), ())),
                        preferred_element_type=jnp.float32)

                if precision == "bf16":
                    # single pass (~48-50 dB): for chains whose demods
                    # lock far below that, at ~1.5x the 3-pass rate
                    return mm(ph, qh)
                ph, pl = split_bf16(p)
                qh, ql = split_bf16(q)
                return mm(ph, qh) + mm(ph, ql) + mm(pl, qh)
        else:
            def rmm(p, q):
                return jnp.dot(p, q, preferred_element_type=jnp.float32,
                               precision=_HI)
        if jnp.iscomplexobj(a):
            rr = rmm(a.real, m.real) - rmm(a.imag, m.imag)
            ii = rmm(a.real, m.imag) + rmm(a.imag, m.real)
            return rr + 1j * ii
        return rmm(a, m.real) + 1j * rmm(a, m.imag)

    # v[b,t] = sum_j bank[b,j] x[hist + t*step - j*N - b]
    # (the commutator advances `step` inputs per output row; the branch FIR
    # strides N regardless of oversampling)
    if os_ == 1:
        # gather-free matmul path: reshape x into rows of N, so
        # x[hist + (t-j)N - b] = X2[t - j + kp - 1 + (b==0), (N-b) % N];
        # stage tap j is a ROW-SHIFTED slice of the column-permuted matrix,
        # and the branch-FIR + N-point IDFT FOLD into one (T,N)@(N,N)
        # complex matmul per tap:  y += blk_j @ M_j,
        # M_j[b, c] = h[jN + b_bank] * e^{2i pi b c / N}.
        rows = T + kp
        X2 = jax.lax.dynamic_slice_in_dim(x, 0, rows * N).reshape(rows, N)
        perm = np.array([(N - b) % N for b in range(N)])
        P = X2[:, jnp.asarray(perm)]  # (rows, N): P[m, b] = x[mN + (N-b)%N]
        mask0 = jnp.asarray(np.arange(N) == 0)
        bvec = np.arange(N)
        cvec = np.arange(N)
        dft = np.exp(2j * np.pi * np.outer(bvec, cvec) / N)  # IDFT * N
        Ms = [jnp.asarray((bank[:, j][:, None] * dft).astype(np.complex64))
              for j in range(kp)]

        acc = None
        for j in range(kp):
            a = jax.lax.dynamic_slice_in_dim(P, kp - 1 - j, T)
            a0 = jax.lax.dynamic_slice_in_dim(P, kp - j, T)
            blk = jnp.where(mask0[None, :], a0, a)
            term = cmm(blk, Ms[j])
            acc = term if acc is None else acc + term
        return acc.astype(jnp.complex64)  # (T, N), channel c at +c*fs/N

    # oversampled: same gather-free row-shift trick generalized to the
    # step = N/os commutator.  Write branch b = q*step + s; then
    # v[b, t] needs x[hist + (t - j*os - q)*step - s], i.e. a row-shifted
    # slice (shift g = j*os + q in [0, kp*os)) of the column-permuted
    # step-wide reshape.  Each shift contributes a (T,step)@(step,N)
    # product; `step` is narrow, so instead of kp*os starved matmuls we
    # CONCATENATE the shifted windows along the
    # contraction axis and the stacked per-shift weight matrices along
    # rows: ONE (T, G*step)@(G*step, N) matmul carries the whole branch
    # FIR + IDFT + per-branch weighting (same fold as the critically-
    # sampled path).
    G = kp * os_
    rows = T + G
    X3 = jax.lax.dynamic_slice_in_dim(x, 0, rows * step).reshape(rows, step)
    perm = np.array([(step - s) % step for s in range(step)])
    P = X3[:, jnp.asarray(perm)]  # P[m, s] = x[m*step + (step-s)%step]
    mask0 = jnp.asarray(np.arange(step) == 0)
    dft = np.exp(2j * np.pi * np.outer(np.arange(N), np.arange(N)) / N)

    blocks, mats = [], []
    for j in range(kp):
        for q in range(os_):
            g = j * os_ + q
            b_rows = q * step + np.arange(step)          # branches in slice
            mats.append((bank[b_rows, j][:, None]
                         * dft[b_rows, :]).astype(np.complex64))  # (step, N)
            a = jax.lax.dynamic_slice_in_dim(P, G - 1 - g, T)
            a0 = jax.lax.dynamic_slice_in_dim(P, G - g, T)
            blocks.append(jnp.where(mask0[None, :], a0, a))
    W = jnp.concatenate(blocks, axis=1)                  # (T, G*step)
    M_all = jnp.asarray(np.concatenate(mats, axis=0))    # (G*step, N)
    acc = cmm(W, M_all)
    # channel c's downconversion phase at output t is -2pi c (t*step)/N =
    # -2pi (t c)/os — periodic in (t c) mod os, so reduce BEFORE the float
    # multiply (t*c overflows f32 integer range past 2^24 samples)
    tc = (jnp.arange(T)[:, None] % os_) * (jnp.arange(N)[None, :] % os_) % os_
    tw = jnp.exp(-2j * np.pi * tc.astype(jnp.float32) / os_).astype(
        jnp.complex64)
    return (acc * tw).astype(jnp.complex64)


def synthesize(chans: jnp.ndarray, proto_taps: np.ndarray) -> jnp.ndarray:
    """Polyphase synthesis filterbank: (T + kp - 1, N) channel matrix (with
    kp-1 history rows) -> (T*N,) stream.

    x_rec[tN + p] = sum_j bank[p, j] * (N * IFFT_N(chans[t - j]))[p]
    — the inverse of :func:`channelize` up to the prototype response and
    kp*N/2-ish group delay.
    """
    T_in, N = chans.shape
    bank = polyphase_taps(np.asarray(proto_taps), N)
    kp = bank.shape[1]
    T = T_in - (kp - 1)
    v = jnp.fft.ifft(chans, axis=1).T * N  # (N, T_in) branch streams
    idx_t = jnp.arange(T)[:, None] + jnp.arange(kp)[None, :]
    w = v[:, idx_t]  # (N, T, kp): w[p,t,j] = v_p[t - (kp-1) + j]
    bk = jnp.asarray(bank[:, ::-1].copy())
    s = (jnp.einsum("ptk,pk->pt", w.real, bk, precision=_HI)
         + 1j * jnp.einsum("ptk,pk->pt", w.imag, bk, precision=_HI))
    # interpolation-by-N needs prototype gain N (each branch sees 1/N of
    # the unity-DC prototype)
    return (N * s.T.reshape(-1)).astype(jnp.complex64)  # out[t*N+p] = s[p,t]


def design_channelizer_taps(nchan: int, taps_per_branch: int = 12) -> np.ndarray:
    """Prototype lowpass for an N-channel bank (pfb_channelizer helper:
    cutoff at half the channel width, designed at the input rate)."""
    from grtpu.utils import firdes

    ntaps = nchan * taps_per_branch
    return firdes.low_pass_2(1.0, nchan, 0.5, ntaps,
                             firdes.Window.BLACKMAN_HARRIS)


# ------------------------------------------------------------ arb resampler
def arb_resampler_plan(rate: Fraction, n_in: int,
                       filter_size: int) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, int]:
    """Static (input index, phase, frac) tables for one chunk.

    Output k samples continuous input position p_k = k / rate;
    phase = frac(p_k) * filter_size, linear interpolation between adjacent
    phases — the reference's accumulator recurrence in closed form."""
    n_out = int(n_in * rate)
    k = np.arange(n_out, dtype=np.float64)
    p = k / float(rate)
    i = np.floor(p).astype(np.int64)
    mu = p - i
    phf = mu * filter_size
    ph = np.floor(phf).astype(np.int64)
    frac = (phf - ph).astype(np.float32)
    return i, ph, frac, n_out


def arb_resample(x: jnp.ndarray, proto_taps: np.ndarray, rate: Fraction,
                 filter_size: int = 32) -> jnp.ndarray:
    """Arbitrary-rate polyphase resampler (gr_pfb_arb_resampler semantics).

    x carries kp-1 history samples (kp = taps per phase).  Output length
    = n * rate (n * rate must be integral).
    """
    proto = np.asarray(proto_taps)
    bank = polyphase_taps(proto, filter_size)           # (M, kp)
    dproto = np.empty_like(proto)
    dproto[:-1] = proto[1:] - proto[:-1]
    dproto[-1] = 0.0
    dbank = polyphase_taps(dproto, filter_size)
    kp = bank.shape[1]
    n = x.shape[0] - (kp - 1)
    i, ph, frac, n_out = arb_resampler_plan(rate, n, filter_size)
    bank_r = bank[:, ::-1].copy()
    dbank_r = dbank[:, ::-1].copy()
    # Gather-free for ANY rational rate: outputs k = r (mod P) share the
    # same (phase, frac) and advance Q input samples per period.  G periods
    # are grouped per matmul row so the output axis is >= 128 columns wide
    # even at tiny P (a 3/2 resample with per-period columns would run
    # 3-column matmuls).  W is a strided window matrix built from reshape
    # slices (never an index gather);
    # T is block-Toeplitz: column g*P + r holds residue r's interpolated
    # taps shifted down g*Q rows.  Useful-flop efficiency is
    # kp/((G-1)*Q + span), the same K/(K+B-1) trade the plain Toeplitz FIR
    # makes — dense matmul shapes beat minimal FLOPs here.
    P, Q = rate.numerator, rate.denominator
    span = int(i[P - 1]) + kp if n_out >= P else int(i[-1]) + kp
    G = max(1, -(-128 // P)) if n_out >= P else 1
    while G > 1 and (G - 1) * Q + span > 2048:   # cap row width
        G -= 1
    S = G * Q                                    # input stride per row
    span_g = (G - 1) * Q + span                  # window columns per row
    M = -(-n_out // (G * P))
    need = (M - 1) * S + span_g
    if x.shape[0] < need:
        x = jnp.concatenate(
            [x, jnp.zeros(need - x.shape[0], x.dtype)])
    from grtpu.ops.fir import _matmul, _window_matrix

    if span_g > S:
        W = _window_matrix(x[:need], span_g - S + 1, S)   # (M, span_g)
    else:  # rows don't overlap (decimating rates with short taps)
        xp = jnp.pad(x[:need], (0, M * S - need))
        W = xp.reshape(M, S)[:, :span_g]
    T = np.zeros((span_g, G * P), np.float32)
    for r in range(P):
        ir, phr, fr = int(i[r]), int(ph[r]), float(frac[r])
        col = bank_r[phr] + fr * dbank_r[phr]
        for g in range(G):
            T[ir + g * Q: ir + g * Q + kp, g * P + r] = col
    y = _matmul(W, jnp.asarray(T)).reshape(-1)[:n_out]
    return y.astype(x.dtype)


def design_arb_resampler_taps(rate: float, filter_size: int = 32) -> np.ndarray:
    """Prototype for the arb resampler (blks2impl/pfb_arb_resampler design):
    lowpass at the narrower of input/output Nyquist, designed at
    filter_size x the input rate."""
    from grtpu.utils import firdes

    cutoff = 0.45 * min(1.0, float(rate))  # cycles/input-sample
    transition = 0.1 * min(1.0, float(rate))
    return firdes.low_pass(filter_size, filter_size, cutoff, transition,
                           firdes.Window.BLACKMAN_HARRIS)
