"""FIR filtering kernels — the performance core of the framework.

Reference being re-designed (not ported): the gr_fir_XXX engine hierarchy +
hand-written SIMD dot products (gnuradio-core/src/lib/filter/*dotprod*_sse.S,
gr_fir_ccf_x86.cc, ...; SURVEY.md §2.3) and the volk kernels
(volk/include/volk/volk_32fc_x2_dot_prod_32fc_a.h).

Design — FIR as a matmul via a Toeplitz *tap matrix*:

For a block of B consecutive outputs starting at m*B,

    y[m*B + b] = sum_k h[k] * x[m*B + b + k]          (correlation form)

let ``ncols = K + B - 1`` and define the constant tap matrix

    T[j, b] = h[j - b]   (0 <= j - b < K, else 0),    shape (ncols, B)

and the window matrix  ``W[m, j] = x[m*B + j]``, shape (M, ncols).  Then

    Y = W @ T,   Y[m, b] = y[m*B + b]

one large matmul that XLA hands to the card's matmul library.  W is built
from pure reshapes of shifted slices (no gather); the useful fraction of
the matmul's FLOPs is K/(K+B-1) (66% at K=256, B=128), and W itself is
K+B-1 times the input, materialized in device memory.
Decimation and interpolation use polyphase decompositions that fold into the
same single matmul (contraction-axis / output-axis concatenation).

Sample-exact semantics: inputs carry their own history (halo) — an input of
length ``n + K - 1`` yields exactly ``n // decim`` outputs, in CONVOLUTION
orientation: ``y[i] = sum_k taps[k] * x[i*decim + K - 1 - k]`` (the standard
FIR difference equation, and the user-facing semantic of gr_fir_filter_XXX —
the reference reverses taps internally at set_taps time; here the reversal
happens once at the op entry before the Toeplitz build).

Complex support is by explicit real decomposition (2 matmuls for complex
input x real taps, 3-4 for complex x complex), keeping every product in
real f32/bf16.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# Output-block width along the matmul N dimension; the M dimension (number
# of window rows) is left to XLA to tile.
_B = 128


def _tap_matrix(taps: jnp.ndarray, block: int) -> jnp.ndarray:
    """Build T[j, b] = taps[j - b], shape (K + block - 1, block)."""
    k = taps.shape[0]
    ncols = k + block - 1
    j = jnp.arange(ncols)[:, None]
    b = jnp.arange(block)[None, :]
    idx = j - b
    valid = (idx >= 0) & (idx < k)
    return jnp.where(valid, taps[jnp.clip(idx, 0, k - 1)], 0)


def _window_matrix(x: jnp.ndarray, k: int, block: int) -> jnp.ndarray:
    """W[m, j] = x[m*block + j] for j < k + block - 1, from shifted reshapes.

    x must have length M*block + k - 1; returns (M, k + block - 1).
    Built as ceil((k-1)/block) + 1 shifted reshape slices concatenated on the
    column axis — no gather, so XLA emits pure data movement.
    """
    m = (x.shape[0] - (k - 1)) // block
    ncols = k + block - 1
    nslices = -(-ncols // block)
    pad = nslices * block - ncols
    xp = jnp.pad(x, (0, pad))
    cols = [
        jax.lax.dynamic_slice_in_dim(xp, c * block, m * block).reshape(m, block)
        for c in range(nslices)
    ]
    w = jnp.concatenate(cols, axis=1)
    return w[:, :ncols]


# f32 matmul precision.  An f32 dot with no precision may run in a reduced
# format (TF32 on an NVIDIA GPU: 10 mantissa bits), too coarse for
# SNR-bound DSP.  Modes:
#   "f32"    — Precision.HIGHEST, full f32 products (the default)
#   "bf16x3" — explicit split-word 3-pass on the bf16 matmul units
#              (~3e-5..1e-4 rel err, ~90 dB SNR): w = wh + wl in bf16,
#              y = wh@th + wh@tl + wl@th
_PRECISION = "f32"


def set_precision(p: str):
    """Set matmul mode for all FIR kernels: 'f32' (default) or 'bf16x3'."""
    global _PRECISION
    assert p in ("f32", "bf16x3")
    _PRECISION = p


def split_bf16(x):
    """Split f32 ``x`` into bf16 words with x ~= hi + lo (16 of f32's 24
    mantissa bits).  ``hi`` is rounded with lax.reduce_precision: XLA may
    drop an f32->bf16->f32 convert pair as excess precision (the GPU
    backend does), which would leave ``lo`` zero and the product single
    pass."""
    hi = jax.lax.reduce_precision(x, exponent_bits=8, mantissa_bits=7)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _real_matmul(w, t, preferred=jnp.float32):
    if _PRECISION == "bf16x3":
        wh, wl = split_bf16(w)
        th, tl = split_bf16(t)

        def mm(a, b):
            return jnp.dot(a, b, preferred_element_type=jnp.float32)

        return mm(wh, th) + mm(wh, tl) + mm(wl, th)
    return jnp.dot(w, t, preferred_element_type=preferred,
                   precision=jax.lax.Precision.HIGHEST)


def _matmul(w, t):
    """Matmul with explicit complex decomposition into real products."""
    wc = jnp.iscomplexobj(w)
    tc = jnp.iscomplexobj(t)
    if not wc and not tc:
        return _real_matmul(w, t)
    if wc and not tc:
        return _real_matmul(w.real, t) + 1j * _real_matmul(w.imag, t)
    if not wc and tc:
        return _real_matmul(w, t.real) + 1j * _real_matmul(w, t.imag)
    rr = _real_matmul(w.real, t.real)
    ii = _real_matmul(w.imag, t.imag)
    ri = _real_matmul(w.real, t.imag)
    ir = _real_matmul(w.imag, t.real)
    return (rr - ii) + 1j * (ri + ir)


def _out_dtype(x_dtype, taps_dtype):
    if jnp.issubdtype(x_dtype, jnp.complexfloating) or jnp.issubdtype(
        taps_dtype, jnp.complexfloating
    ):
        return jnp.complex64
    return jnp.float32


# --------------------------------------------------------------------- direct
def fir_filter(x: jnp.ndarray, taps: jnp.ndarray, decim: int = 1) -> jnp.ndarray:
    """Decimating FIR (convolution form — standard FIR difference equation).

    Args:
      x: input of length ``n + ntaps - 1`` (history included; n % decim == 0).
      taps: filter taps, length K.
        ``y[i] = sum_k taps[k] x[i*decim + K - 1 - k]``.
      decim: keep one output per ``decim`` inputs.

    Returns: y of length n // decim.
    """
    taps = jnp.flip(jnp.asarray(taps))
    k = taps.shape[0]
    n = x.shape[0] - (k - 1)
    if n < 0:
        raise ValueError(f"input too short for {k} taps")
    nout = n // decim
    if decim == 1:
        return _fir_block_matmul(x, taps, nout)
    return _fir_polyphase_decim(x, taps, decim, nout)


def _fir_block_matmul(x, taps, nout):
    k = taps.shape[0]
    block = _B if nout >= _B else max(8, 1 << max(0, (nout - 1).bit_length()))
    m = -(-nout // block)  # ceil
    need = m * block + k - 1
    xp = jnp.pad(x, (0, need - x.shape[0])) if need > x.shape[0] else x
    w = _window_matrix(xp, k, block)
    t = _tap_matrix(taps, block)
    y = _matmul(w, t).reshape(-1)
    return y[:nout].astype(_out_dtype(x.dtype, taps.dtype))


def _fir_polyphase_decim(x, taps, d, nout):
    """y[i] = sum_d' fir(x[d'::d], taps[d'::d])[i] — folded into one matmul
    by concatenating the per-phase windows/taps on the contraction axis."""
    k = taps.shape[0]
    kp = -(-k // d)  # taps per phase
    # pad taps to kp*d
    tp = jnp.pad(taps, (0, kp * d - k))
    # x has length n + k - 1 with n = nout*d. Phase streams:
    # x_p[t] = x[t*d + p], need length nout + kp - 1 each.
    need_per_phase = nout + kp - 1
    need_flat = (need_per_phase - 1) * d + d  # enough to slice all phases
    total_need = need_flat
    xp_ = jnp.pad(x, (0, max(0, total_need - x.shape[0])))
    phases = xp_[: need_per_phase * d].reshape(need_per_phase, d)  # [t, p]
    block = _B if nout >= _B else max(8, 1 << max(0, (nout - 1).bit_length()))
    m = -(-nout // block)
    ws, ts = [], []
    for p in range(d):
        xph = phases[:, p]
        need = m * block + kp - 1
        xph = jnp.pad(xph, (0, max(0, need - xph.shape[0])))
        ws.append(_window_matrix(xph, kp, block))
        ts.append(_tap_matrix(tp[p::d], block))
    w = jnp.concatenate(ws, axis=1)
    t = jnp.concatenate(ts, axis=0)
    y = _matmul(w, t).reshape(-1)
    return y[:nout].astype(_out_dtype(x.dtype, taps.dtype))


def interp_fir_filter(x: jnp.ndarray, taps: jnp.ndarray, interp: int) -> jnp.ndarray:
    """Polyphase interpolating FIR (gr_interp_fir_filter_XXX semantics).

    Args:
      x: input of length ``n + ceil(K/L) - 1`` (history = taps-per-phase).
      taps: prototype taps, length K (will be zero-padded to multiple of L).
      interp: L outputs per input.

    Returns y of length n * L, exactly matching upsample-by-L followed by
    convolution with ``taps``:
        ``y[i*L + p] = sum_c taps[p + c*L] x[i - c]``
    (phase p of the polyphase bank = taps[p::L], applied in convolution
    orientation over the kp-sample history window).
    """
    l = interp
    taps = jnp.asarray(taps)
    k = taps.shape[0]
    kp = -(-k // l)
    n = x.shape[0] - (kp - 1)
    tp = jnp.pad(taps, (0, kp * l - k))
    block = _B if n >= _B else max(8, 1 << max(0, (n - 1).bit_length()))
    m = -(-n // block)
    need = m * block + kp - 1
    xp = jnp.pad(x, (0, max(0, need - x.shape[0])))
    w = _window_matrix(xp, kp, block)  # (m, kp + block - 1)
    # One tap matrix per phase (reversed: convolution orientation),
    # concatenated on the output axis.
    t = jnp.concatenate(
        [_tap_matrix(jnp.flip(tp[p::l]), block) for p in range(l)], axis=1)
    y = _matmul(w, t)  # (m, l * block)
    # y[:, p*block + b] = phase p, output index m*block + b -> interleave
    y = y.reshape(m, l, block).transpose(0, 2, 1).reshape(-1)
    return y[: n * l].astype(_out_dtype(x.dtype, taps.dtype))


# ----------------------------------------------------------------- multi-filt
def fir_filterbank(x: jnp.ndarray, tapbank: jnp.ndarray) -> jnp.ndarray:
    """Apply F different filters of equal length to the same input.

    tapbank: (F, K), convolution orientation.  Returns (F, n) with
    n = len(x) - K + 1.  Used by band-edge FLL, MMSE interpolator banks and
    pfb clock sync — folds into one matmul with F*B output columns.
    """
    tapbank = jnp.flip(jnp.asarray(tapbank), axis=1)
    f, k = tapbank.shape
    n = x.shape[0] - (k - 1)
    block = _B if n >= _B else max(8, 1 << max(0, (n - 1).bit_length()))
    m = -(-n // block)
    need = m * block + k - 1
    xp = jnp.pad(x, (0, max(0, need - x.shape[0])))
    w = _window_matrix(xp, k, block)
    t = jnp.concatenate([_tap_matrix(tapbank[i], block) for i in range(f)], axis=1)
    y = _matmul(w, t).reshape(m, f, block)
    y = y.transpose(1, 0, 2).reshape(f, m * block)
    return y[:, :n].astype(_out_dtype(x.dtype, tapbank.dtype))


def batch_fir_filter(x: jnp.ndarray, taps: jnp.ndarray, decim: int = 1) -> jnp.ndarray:
    """Same filter over a batch of channels: x (C, n + K - 1) -> (C, n//decim).

    The window matrices of all channels stack on the matmul M axis, so the
    matmul grows with channel count (the multi-pipe analog of the
    reference's mp-sched benchmark)."""
    return jax.vmap(lambda xi: fir_filter(xi, taps, decim))(x)


# -------------------------------------------------------------------- rotator
def freq_xlating_fir_filter(
    x: jnp.ndarray,
    taps: jnp.ndarray,
    phase: jnp.ndarray,
    phase_inc: float,
    decim: int = 1,
):
    """Frequency-translating decimating FIR
    (gr_freq_xlating_fir_filter_XXX.cc.t:72-123 semantics).

    The reference pre-rotates the taps by the center frequency and spins the
    *output* by a rotator advancing ``decim * phase_inc`` per output sample.
    Here: ``taps`` must already be the rotated (complex) taps; ``phase`` is
    the carried rotator phase (radians); ``phase_inc`` is radians per *input*
    sample (= -2*pi*center_freq/fs as in the reference).

    Returns (y, new_phase).
    """
    y = fir_filter(x, taps, decim)
    nout = y.shape[0]
    ph = phase + phase_inc * decim * jnp.arange(nout)
    rot = jnp.exp(1j * ph).astype(jnp.complex64)
    new_phase = jnp.mod(phase + phase_inc * decim * nout, 2 * jnp.pi)
    return (y * rot).astype(jnp.complex64), new_phase


def rotate_taps(taps: np.ndarray, center_freq: float, fs: float) -> np.ndarray:
    """Pre-rotate real prototype taps to a center frequency
    (gr_freq_xlating_fir_filter ctor behavior)."""
    k = np.arange(len(taps))
    shift = np.exp(2j * np.pi * center_freq / fs * k)
    return (np.asarray(taps) * shift).astype(np.complex64)


def compose_taps(*tap_sets) -> np.ndarray:
    """Compose cascaded LTI FIR filters into one equivalent filter.

    Chaining FIRs is convolution of their impulse responses:
    ``fir(fir(x, a), b) == fir(x, compose_taps(a, b))`` exactly (in exact
    arithmetic).  Composition is the graph-level optimization the reference
    never performs (its scheduler runs each gr_fir_filter block separately,
    gr_flat_flowgraph.cc buffers between them); it cuts the Toeplitz
    matmul's work: a chain of S K-tap stages costs S windows of (K+B-1)
    columns per B outputs, the composed (S*(K-1)+1)-tap filter costs one
    ~(S*K+B) window — e.g. 16 x 256 taps drops from 6128 to 4208 columns
    per B outputs, at equal (better, single-rounding) accuracy.

    Accumulates in float64, returns float32.
    """
    out = np.asarray(tap_sets[0], np.float64)
    if np.iscomplexobj(tap_sets[0]):
        out = np.asarray(tap_sets[0], np.complex128)
    for t in tap_sets[1:]:
        out = np.convolve(out, np.asarray(t))
    if np.iscomplexobj(out):
        return out.astype(np.complex64)
    return out.astype(np.float32)


def compose_taps_power(taps, nstages: int) -> np.ndarray:
    """compose_taps of the same filter ``nstages`` times (log-depth)."""
    return compose_taps(*([taps] * nstages))
