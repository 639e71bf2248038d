"""FFT-domain FIR: overlap-save fast convolution.

Analog of gri_fft_filter_{ccc,fff}_generic (gnuradio-core/src/lib/filter/
gri_fft_filter_ccc_generic.cc:98-167): the reference uses overlap-ADD with a
carried tail (fftsize = 2*next_pow2(ntaps), nsamples = fftsize - ntaps + 1).
Here we use overlap-SAVE, which produces identical results but is stateless
given the executor-managed history halo — the carried "tail" becomes the same
K-1-sample halo every FIR block already receives, so fir_filter and
fft_filter are drop-in interchangeable per chunk.

Contract matches grtpu.ops.fir.fir_filter exactly (convolution form):
input length n + K - 1 -> output length n // decim,
y[i] = sum_k taps[k] * x[i*decim + K - 1 - k].

The batched FFTs map to XLA's FFT (cuFFT on the GPU); for K >= ~64 this
path does ~(10 log2 F)/K of the matmul path's FLOPs — the auto heuristic in
grtpu.blocks.filter picks per tap count.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_filter(x: jnp.ndarray, taps: jnp.ndarray, decim: int = 1,
               fftsize: int | None = None) -> jnp.ndarray:
    """Overlap-save fast convolution; see module docstring for the contract."""
    taps = jnp.asarray(taps)
    k = taps.shape[0]
    n = x.shape[0] - (k - 1)
    if n <= 0:
        raise ValueError("input shorter than taps")
    nout = n // decim
    if fftsize is None:
        fftsize = max(2 * _next_pow2(k), 256)
    L = fftsize - k + 1  # valid outputs per segment

    nseg = -(-n // L)
    need = (nseg - 1) * L + fftsize
    xp = jnp.pad(x, (0, max(0, need - x.shape[0])))

    # segments of length fftsize with stride L: segment s covers outputs
    # [s*L, s*L + L) and needs inputs [s*L, s*L + fftsize).  Built from
    # shifted reshapes (the window-matrix trick) — no gather.
    from grtpu.ops.fir import _window_matrix

    segs = _window_matrix(xp[: (nseg) * L + fftsize - L], fftsize - L + 1, L)

    complex_in = jnp.iscomplexobj(x) or jnp.iscomplexobj(taps)
    hp = jnp.pad(taps, (0, fftsize - k)).astype(jnp.complex64)
    H = jnp.fft.fft(hp)
    X = jnp.fft.fft(segs.astype(jnp.complex64), axis=1)
    Y = jnp.fft.ifft(X * H[None, :], axis=1)
    # valid (fully-overlapped) outputs of each segment: positions k-1 .. fftsize-1
    valid = Y[:, k - 1:]  # (nseg, L)
    y = valid.reshape(-1)[:n]
    if decim != 1:
        y = y[::decim][:nout]
    if complex_in:
        return y.astype(jnp.complex64)
    return jnp.real(y).astype(jnp.float32)
