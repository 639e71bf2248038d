"""Scalar DSP primitives: rotator, NCO, quadrature discriminator, IIR.

Analogs of:
  * gr_rotator.h / gri_fxpt NCO (gnuradio-core/src/lib/general/gr_fxpt.{h,cc},
    gr_rotator.h) — complex phase rotation and waveform synthesis.  The
    reference uses an incremental complex recurrence with periodic
    renormalization to stay O(1)/sample on a CPU; here we synthesize the
    whole time-block's phase ramp vectorized (exact, no drift) with a carried
    phase scalar.
  * gr_quadrature_demod_cf (general/gr_quadrature_demod_cf.cc:47-62) — FM
    discriminator via conjugate product + atan2 (history = 2).
  * gr_single_pole_iir / gr_iir_filter_ffd — recursive filters as lax.scan
    (or closed-form parallel scan for single poles).
  * gri_control_loop (general/gri_control_loop.cc:34-80) — 2nd-order PI
    loop gains (used by Costas/PLL/FLL blocks in grtpu.digital).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


# -------------------------------------------------------------------- rotator
def rotate(x: jnp.ndarray, phase: jnp.ndarray, phase_inc) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Multiply x by exp(j*(phase + i*phase_inc)); returns (y, new_phase).

    Vectorized phase ramp — exact to f32 over a chunk, with the carried
    phase wrapped each chunk (replaces gr_rotator's every-512-samples
    renormalization)."""
    n = x.shape[0]
    ph = phase + phase_inc * jnp.arange(n, dtype=jnp.float32)
    y = x * jnp.exp(1j * ph).astype(jnp.complex64)
    new_phase = jnp.mod(phase + phase_inc * n, 2 * np.pi).astype(jnp.float32)
    return y.astype(jnp.complex64), new_phase


def nco_sin(phase, phase_inc, n: int):
    ph = phase + phase_inc * jnp.arange(n, dtype=jnp.float32)
    return jnp.sin(ph), jnp.mod(phase + phase_inc * n, 2 * np.pi)


def nco_cos(phase, phase_inc, n: int):
    ph = phase + phase_inc * jnp.arange(n, dtype=jnp.float32)
    return jnp.cos(ph), jnp.mod(phase + phase_inc * n, 2 * np.pi)


def nco_exp(phase, phase_inc, n: int):
    ph = phase + phase_inc * jnp.arange(n, dtype=jnp.float32)
    return (jnp.exp(1j * ph).astype(jnp.complex64),
            jnp.mod(phase + phase_inc * n, 2 * np.pi))


def vco(freq: jnp.ndarray, phase, sensitivity: float):
    """Voltage-controlled oscillator (gr_vco_f): phase integrates the input.

    Returns (cos(phi), new_phase)."""
    dphi = sensitivity * freq
    phi = phase + jnp.cumsum(dphi)
    new_phase = jnp.mod(phi[-1], 2 * np.pi)
    return jnp.cos(phi), new_phase


# -------------------------------------------------------- quadrature demod
# Minimax odd polynomial for atan(z) on [-1, 1] (degree 9).  Max abs error
# ~1.0e-5 rad — better than the reference's 256-entry interpolated LUT
# (gr_fast_atan2f, general/gr_fast_atan2f.cc), and branchless/gather-free
# so it stays on the VPU vector path.
_ATAN_C = (0.999866, -0.3302995, 0.180141, -0.085133, 0.0208351)


def fast_atan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Branchless polynomial atan2 (gr_fast_atan2f analog), ~1e-5 rad.

    The reference trades accuracy for speed with a LUT
    (general/gr_fast_atan2f.cc); a LUT is a gather, so the same trade is
    an octant-reduced odd polynomial: one divide + 5 FMAs + selects, all
    vectorizable.  Returns 0 at (0, 0) like the reference.  The chains use
    the exact ``jnp.arctan2``; this op exists for API parity.
    """
    ax, ay = jnp.abs(x), jnp.abs(y)
    mx = jnp.maximum(ax, ay)
    mn = jnp.minimum(ax, ay)
    z = mn / jnp.where(mx == 0, jnp.float32(1), mx)
    z2 = z * z
    c = _ATAN_C
    p = c[4]
    for k in (3, 2, 1, 0):
        p = p * z2 + c[k]
    a = p * z
    a = jnp.where(ay > ax, jnp.float32(np.pi / 2) - a, a)
    a = jnp.where(x < 0, jnp.float32(np.pi) - a, a)
    return jnp.where(y < 0, -a, a).astype(jnp.float32)


def quadrature_demod(x: jnp.ndarray, gain: float,
                     fast: bool = False) -> jnp.ndarray:
    """FM discriminator (gr_quadrature_demod_cf.cc:47-62):
    out[i] = gain * arg(x[i+1] * conj(x[i])).

    Input carries 1 history sample (block history=2): length n+1 -> n outputs.
    ``fast=True`` uses the polynomial :func:`fast_atan2` (the reference's
    gr_fast_atan2f trade-off, ~1e-5 rad).
    """
    prod = x[1:] * jnp.conj(x[:-1])
    at2 = fast_atan2 if fast else jnp.arctan2
    return (gain * at2(jnp.imag(prod), jnp.real(prod))).astype(jnp.float32)


def frequency_modulator(x: jnp.ndarray, phase, sensitivity: float):
    """gr_frequency_modulator_fc: out = exp(j * cumsum(sensitivity*x)).

    Returns (y, new_phase)."""
    dphi = sensitivity * x
    phi = phase + jnp.cumsum(dphi)
    y = jnp.exp(1j * phi).astype(jnp.complex64)
    return y, jnp.mod(phi[-1], 2 * np.pi).astype(jnp.float32)


def phase_modulator(x: jnp.ndarray, sensitivity: float):
    """gr_phase_modulator_fc: out = exp(j * sensitivity * x)."""
    return jnp.exp(1j * sensitivity * x).astype(jnp.complex64)


# ------------------------------------------------------------------- IIR
def linear_recurrence(a: jnp.ndarray, b: jnp.ndarray, y0):
    """Solve y[i] = a[i]*y[i-1] + b[i] with y[-1] = y0, fully parallel.

    The affine maps (a_i, b_i) compose associatively:
        (a2, b2) o (a1, b1) = (a2*a1, a2*b1 + b2)
    so the whole chunk solves in log-depth via ``associative_scan`` —
    the vectorized form of every first-order IIR (the reference's
    per-sample loops in gri_single_pole_iir / gri_iir).
    Returns (y, y_last)."""

    def comb(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    aa, bb = jax.lax.associative_scan(comb, (a, b))
    y = aa * y0 + bb
    return y, y[-1]


def _slow_pole_chunked(aa: float, b: jnp.ndarray, y0, L: int):
    """y[i] = aa*y[i-1] + b[i] via per-chunk closed form (see
    linear_recurrence_const's slow-pole branch).  1-D ``b`` only."""
    n = b.shape[0]
    pad = (-n) % L
    bp = jnp.pad(b, (0, pad))
    k = np.arange(L)
    apow = jnp.asarray((aa ** k).astype(np.float32))
    ainv = jnp.asarray(((1.0 / aa) ** k).astype(np.float32))

    sub = max(1, min(128, L))
    nsub = -(-L // sub)
    Lp = nsub * sub

    def f(carry, seg):
        # two-level prefix sum: f32 cumsum error grows O(n * eps); the
        # blocked form keeps it O(sub * eps + nsub * eps)
        t = jnp.pad(seg * ainv, (0, Lp - L)).reshape(nsub, sub)
        local = jnp.cumsum(t, axis=-1)
        blocks = jnp.cumsum(local[:, -1])
        blocks = jnp.concatenate([jnp.zeros(1, blocks.dtype), blocks[:-1]])
        s = (local + blocks[:, None]).reshape(-1)[:L] * apow
        y = (aa * apow) * carry + s
        return y[-1], y

    last, ys = jax.lax.scan(f, jnp.asarray(y0, b.dtype),
                            bp.reshape(-1, L))
    y = ys.reshape(-1)[:n]
    return y, y[n - 1]


def linear_recurrence_const(a: float, b: jnp.ndarray, y0,
                            tol: float = 1e-9, max_taps: int = 128):
    """Solve y[i] = a*y[i-1] + b[i] for CONSTANT |a| < 1, exact to ``tol``.

    The impulse response a^k decays geometrically, so past
    n = ceil(log(tol)/log|a|) taps the recurrence IS a short FIR:
    y = conv(b, [1, a, a^2, ...]) + a^(i+1)*y0 — one matmul instead of
    the associative scan's log-depth passes (the FIR form has no log-depth
    intermediate materialization).  Falls back to :func:`linear_recurrence` when a decays too
    slowly.  b may be (..., n) batched on leading axes (y0 broadcasting
    along them).  Returns (y, y_last)."""
    from grtpu.ops.fir import batch_fir_filter, fir_filter

    aa = float(a)
    if not (0.0 <= abs(aa) < 1.0):
        raise ValueError("linear_recurrence_const needs |a| < 1")
    ntaps = int(np.ceil(np.log(tol) / np.log(max(abs(aa), 1e-12)))) \
        if aa != 0.0 else 1
    if ntaps > max_taps:
        # slow pole: the truncated FIR would need >max_taps taps.
        # n <= 128k: associative scan (log-depth, ~1e-5 relative).
        # Larger n: the scan's XLA compile goes pathological (round-5:
        # remove_dc over 2.1M samples hung the ATSC bench for minutes),
        # so solve in chunked closed form instead — within a chunk of L,
        #   y[t] = a^{t+1} y0 + a^t * cumsum(b[k] a^{-k})
        # (a^{-k} growth bounded by picking L so a^{-L} <= ~8; only the
        # chunk boundary is sequential; <= ~1e-3 relative at megasample n
        # — f32 pole rounding drift, fine for DC trackers / averagers,
        # the only consumers of megasample slow-pole recurrences).
        n_last = b.shape[-1]
        if n_last <= (1 << 17):
            if b.ndim > 1:
                lead = b.shape[:-1]
                flat = b.reshape(-1, n_last)
                y0f = jnp.broadcast_to(jnp.asarray(y0), lead).reshape(-1)
                y, last = jax.vmap(lambda bb, s: linear_recurrence(
                    jnp.full(bb.shape, aa, bb.dtype), bb, s))(flat, y0f)
                return y.reshape(b.shape), last.reshape(lead)
            af = jnp.full(b.shape, aa, b.dtype)
            return linear_recurrence(af, b, y0)
        L = int(np.clip(np.log(8.0) / max(-np.log(abs(aa)), 1e-12),
                        8, 4096))
        if b.ndim > 1:
            lead = b.shape[:-1]
            flat = b.reshape(-1, n_last)
            y0f = jnp.broadcast_to(jnp.asarray(y0), lead).reshape(-1)
            y, last = jax.vmap(lambda bb, s: _slow_pole_chunked(
                aa, bb, s, L))(flat, y0f)
            return y.reshape(b.shape), last.reshape(lead)
        return _slow_pole_chunked(aa, b, y0, L)
    # convolution taps: y[i] = sum_k taps[k] b[i-k] with taps[k] = a^k
    # (fir convention y[i] = sum_k t[k] x[i+K-1-k] over the zero-preloaded
    # input already gives x[i-k] indexing)
    taps = (aa ** np.arange(ntaps)).astype(np.float32)
    n = b.shape[-1]
    pad = [(0, 0)] * (b.ndim - 1) + [(ntaps - 1, 0)]
    bh = jnp.pad(b, pad)
    if b.ndim == 1:
        y = fir_filter(bh, jnp.asarray(taps), 1)
    else:
        lead = bh.shape[:-1]
        y = batch_fir_filter(bh.reshape(-1, bh.shape[-1]),
                             jnp.asarray(taps), 1).reshape(lead + (n,))
    # incoming-state correction: + a^(i+1) * y0 (negligible past ntaps)
    apow = (aa ** (1.0 + np.arange(min(n, ntaps)))).astype(np.float32)
    corr = jnp.zeros(n, jnp.float32).at[: len(apow)].set(jnp.asarray(apow))
    y = y + jnp.asarray(y0)[..., None] * corr
    return y, y[..., -1]


def single_pole_iir(x: jnp.ndarray, state, alpha: float):
    """y[i] = alpha*x[i] + (1-alpha)*y[i-1] (gri_single_pole_iir).

    Constant stable pole -> the truncated-FIR matmul solver (exact to 1e-9;
    falls back to the associative scan automatically for very slow decay,
    where the FIR would need >128 taps).  Returns (y, new_state)."""
    y, last = linear_recurrence_const(1.0 - float(alpha), alpha * x, state)
    return y, last


def iir_filter(x: jnp.ndarray, state, fftaps, fbtaps):
    """Direct-form-I IIR (gr_iir_filter_ffd semantics):
    y[n] = sum_k ff[k] x[n-k] + sum_{k>=1} fb[k] y[n-k]
    (note the reference stores feedback taps with implied positive sign).

    state: (x_hist[len(ff)-1], y_hist[len(fb)-1]) most-recent-last.
    Returns (y, new_state).  The feedforward half is computed with the
    matmul FIR; only the feedback recurrence runs as a scan.
    """
    ff = jnp.asarray(fftaps, jnp.float32)
    fb = jnp.asarray(fbtaps, jnp.float32)
    nff, nfb = ff.shape[0], fb.shape[0]
    x_hist, y_hist = state
    xs = jnp.concatenate([x_hist, x]) if nff > 1 else x
    # feedforward: correlation with reversed ff taps
    from grtpu.ops.fir import fir_filter

    v = fir_filter(xs, ff, 1) if nff > 1 else x * ff[0]

    if nfb <= 1:
        y = v
        new_y_hist = y_hist
    elif nfb == 2:
        # first-order feedback (deemphasis & friends).  With a constant
        # stable pole the truncated-FIR solver is one matmul pass instead
        # of the associative scan's log-depth passes over memory.
        try:
            a1 = float(np.asarray(fbtaps)[1])
        except (TypeError, jax.errors.TracerArrayConversionError):
            a1 = None
        if a1 is not None and 0.0 <= abs(a1) < 1.0:
            y, _ = linear_recurrence_const(a1, v, y_hist[-1])
        else:
            a = jnp.full(v.shape, fb[1], v.dtype)
            y, _ = linear_recurrence(a, v, y_hist[-1])
        new_y_hist = y[-1:][: nfb - 1]
    else:
        fb_r = fb[1:]  # feedback coefficients on y[n-1..]

        def f(carry, vi):
            # carry: last nfb-1 outputs, most recent last
            y = vi + jnp.dot(jnp.flip(carry), fb_r,
                             precision=jax.lax.Precision.HIGHEST)
            carry = jnp.concatenate([carry[1:], y[None]])
            return carry, y

        new_y_hist, y = jax.lax.scan(f, y_hist, v)
    new_x_hist = xs[xs.shape[0] - (nff - 1):] if nff > 1 else x_hist
    return y, (new_x_hist, new_y_hist)


def iir_init_state(nff: int, nfb: int):
    return (jnp.zeros((max(nff - 1, 0),), jnp.float32),
            jnp.zeros((max(nfb - 1, 0),), jnp.float32))


# ------------------------------------------------------------- control loop
def control_loop_gains(loop_bw: float, damping: float = math.sqrt(2.0) / 2.0):
    """2nd-order PI loop alpha/beta from bandwidth & damping
    (gri_control_loop.cc:34-46)."""
    denom = 1.0 + 2.0 * damping * loop_bw + loop_bw * loop_bw
    alpha = (4 * damping * loop_bw) / denom
    beta = (4 * loop_bw * loop_bw) / denom
    return alpha, beta


def phase_wrap(phase):
    """Wrap to [-pi, pi] (gri_control_loop::phase_wrap)."""
    return jnp.mod(phase + np.pi, 2 * np.pi) - np.pi


# ----------------------------------------------------------------- dc block
def dc_blocker(x: jnp.ndarray, state, length: int):
    """gr_dc_blocker_ff (default long-form): cascade of two length-D moving
    averages subtracted with matching delay.  Simplified single-MA form:
    y[i] = x[i - (D-1)] - MA_D(x)[i]; state carries the needed history."""
    d = length
    hist = state
    xs = jnp.concatenate([hist, x])
    c = jnp.cumsum(xs.astype(jnp.float32))
    c = jnp.concatenate([jnp.zeros((1,), jnp.float32), c])
    ma = (c[d:] - c[:-d]) / d  # MA over trailing window, len(xs)-d+1 values
    n = x.shape[0]
    delayed = xs[xs.shape[0] - n - (d - 1) // 2: xs.shape[0] - (d - 1) // 2]
    y = delayed - ma[ma.shape[0] - n:]
    new_hist = xs[xs.shape[0] - (d - 1) - (d - 1) // 2:]
    return y.astype(x.dtype), new_hist
