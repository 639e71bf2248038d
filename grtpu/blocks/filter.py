"""Filter blocks: the gr filter-library analog over the matmul/FFT kernels.

Analogs (SURVEY.md §2.3): gr_fir_filter_XXX, gr_interp_fir_filter_XXX,
gr_rational_resampler_base_XXX, gr_freq_xlating_fir_filter_XXX,
gr_fft_filter_{ccc,fff}, gr_iir_filter_ffd, gr_single_pole_iir_filter_*,
gr_dc_blocker_*, gr_hilbert_fc, gr_filter_delay_fc, gr_fractional_interpolator,
gr_goertzel_fc.

Each block is a thin stateful wrapper binding a grtpu.ops kernel into the
Block protocol: history = ntaps so the executor supplies the halo; taps are
baked into the traced program as constants (retuning re-jits, matching the
reference's set_taps rebuild cost).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port
from grtpu.ops.fir import (
    fir_filter as _fir, interp_fir_filter as _ifir, rotate_taps,
    freq_xlating_fir_filter as _fx,
)
from grtpu.ops.fft_filter import fft_filter as _fftfir
from grtpu.ops import dsp


def _dt(tag):
    return {"f": jnp.float32, "c": jnp.complex64, "s": jnp.int16}[tag]


class FirFilter(Block):
    """Decimating FIR (gr_fir_filter_XXX).  sig: 'fff', 'ccf', 'ccc', 'fcc',
    'scc', 'fsf' type triplets (in, out, taps)."""

    def __init__(self, decimation: int, taps, sig: str = "fff", name=None,
                 impl: str = "auto"):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        taps = np.asarray(taps)
        self.decim = decimation
        self.history = len(taps)
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)
        # FFT path for long filters (fewer flops than the Toeplitz matmul)
        if impl == "auto":
            impl = "fft" if len(taps) >= 128 and decimation == 1 else "matmul"
        if impl not in ("fft", "matmul"):
            raise ValueError(
                f"impl must be 'auto', 'fft' or 'matmul', got {impl!r}")
        self.impl = impl
        self._out_cast = _dt(out_t)

    def apply(self, state, x):
        f = _fftfir if self.impl == "fft" else _fir
        y = f(x, self.taps, self.decim)
        if self._out_cast == jnp.int16:
            y = jnp.clip(jnp.round(y), -32768, 32767)
        return state, y.astype(self._out_cast)

    def set_taps(self, taps):
        if len(taps) != self.history:
            raise ValueError("set_taps must preserve tap count (history)")
        self.taps = np.asarray(taps, self.taps.dtype)
        self.touch()  # invalidate any built executor (stale-taps guard)


class FftFilter(FirFilter):
    """gr_fft_filter_{ccc,fff}: same contract, FFT path forced."""

    def __init__(self, decimation: int, taps, sig: str = "ccc", name=None):
        super().__init__(decimation, taps, sig, name, impl="fft")


class InterpFirFilter(Block):
    """Polyphase interpolating FIR (gr_interp_fir_filter_XXX)."""

    def __init__(self, interpolation: int, taps, sig: str = "fff", name=None):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        taps = np.asarray(taps)
        self.interp = interpolation
        self.history = -(-len(taps) // interpolation)  # taps per phase
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)

    def apply(self, state, x):
        return state, _ifir(x, self.taps, self.interp).astype(
            self.out_ports[0].dtype)


class RationalResampler(Block):
    """L/M resampler with anti-alias filter
    (gr_rational_resampler_base_XXX).  If taps is None a low-pass is
    designed automatically like blks2impl/rational_resampler.py."""

    def __init__(self, interpolation: int, decimation: int, taps=None,
                 sig: str = "fff", fractional_bw: float = 0.4, name=None):
        from math import gcd

        g = gcd(interpolation, decimation)
        interpolation //= g
        decimation //= g
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(_dt(out_t)),)
        self.interp = interpolation
        self.decim = decimation
        if taps is None:
            taps = self._design(interpolation, decimation, fractional_bw)
        taps = np.asarray(taps)
        self.history = -(-len(taps) // interpolation)
        super().__init__(name)
        self.taps = np.asarray(
            taps, np.complex64 if tap_t == "c" else np.float32)

    @staticmethod
    def _design(L, M, fractional_bw):
        """Auto tap design (blks2impl/rational_resampler.py design_filter)."""
        from grtpu.utils import firdes

        if fractional_bw >= 0.5 or fractional_bw <= 0:
            raise ValueError("fractional_bw must be in (0, 0.5)")
        beta = 7.0
        halfband = 0.5
        rate = L / M
        if rate >= 1.0:
            bw = halfband - fractional_bw
            tb = rate * (halfband - bw)
        else:
            bw = rate * halfband - rate * fractional_bw
            tb = rate * halfband - bw
        return firdes.low_pass(L, L, bw, tb, firdes.Window.KAISER, beta)

    def apply(self, state, x):
        up = _ifir(x, self.taps, self.interp)
        # x carries kp-1 history -> up has n*L aligned outputs; decimate.
        y = up[::self.decim]
        return state, y.astype(self.out_ports[0].dtype)


class FreqXlatingFirFilter(Block):
    """gr_freq_xlating_fir_filter_XXX: band-select + translate + decimate.

    taps: real (or complex) prototype lowpass; center_freq/fs set the
    translation.  Carried state = rotator phase."""

    def __init__(self, decimation: int, taps, center_freq: float,
                 sampling_freq: float, sig: str = "ccf", name=None):
        in_t, out_t, tap_t = sig
        self.in_ports = (Port(_dt(in_t)),)
        self.out_ports = (Port(jnp.complex64),)
        taps = np.asarray(taps)
        self.decim = decimation
        self.history = len(taps)
        super().__init__(name)
        self.center_freq = center_freq
        self.fs = sampling_freq
        self.rtaps = rotate_taps(taps, center_freq, sampling_freq)
        self.phase_inc = -2 * np.pi * center_freq / sampling_freq

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        y, ph = _fx(x, self.rtaps, state, self.phase_inc, self.decim)
        return ph, y


class IirFilter(Block):
    """gr_iir_filter_ffd."""

    def __init__(self, fftaps, fbtaps, name=None):
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.float32),)
        super().__init__(name)
        self.ff = np.asarray(fftaps, np.float32)
        self.fb = np.asarray(fbtaps, np.float32)

    def init_state(self):
        return dsp.iir_init_state(len(self.ff), len(self.fb))

    def apply(self, state, x):
        y, st = dsp.iir_filter(x, state, self.ff, self.fb)
        return st, y


class SinglePoleIir(Block):
    """gr_single_pole_iir_filter_ff."""

    def __init__(self, alpha: float, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.alpha = alpha
        self._dtype = dtype

    def init_state(self):
        return jnp.zeros((), self._dtype)

    def apply(self, state, x):
        y, st = dsp.single_pole_iir(x, state, self.alpha)
        return st, y


class Hilbert(Block):
    """gr_hilbert_fc: float in -> analytic signal out (delayed real +
    j*hilbert)."""

    def __init__(self, ntaps: int = 65, name=None):
        from grtpu.utils import firdes

        ntaps |= 1
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = ntaps
        super().__init__(name)
        self.taps = firdes.hilbert(ntaps, firdes.Window.HAMMING)
        self.delay = (ntaps - 1) // 2

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        q = _fir(x, self.taps, 1)
        i = jax.lax.dynamic_slice_in_dim(x, self.delay, n)
        return state, (i + 1j * q).astype(jnp.complex64)


class FilterDelay(Block):
    """gr_filter_delay_fc: (in, filtered(in)) as a complex pair with
    matched delay."""

    def __init__(self, taps, name=None):
        taps = np.asarray(taps, np.float32)
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = len(taps)
        super().__init__(name)
        self.taps = taps
        self.delay = (len(taps) - 1) // 2

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        q = _fir(x, self.taps, 1)
        i = jax.lax.dynamic_slice_in_dim(x, self.delay, n)
        return state, (i + 1j * q).astype(jnp.complex64)


class DcBlocker(Block):
    """gr_dc_blocker_{ff,cc}: moving-average DC removal with matched delay.

    long_form mirrors the reference's default (two cascaded length-D MAs)."""

    def __init__(self, d: int = 32, long_form: bool = True, dtype=jnp.float32,
                 name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.d = d
        self.long_form = long_form
        # enough history for MA cascade + center delay
        self.history = (2 * d - 1 if long_form else d) + (d - 1)
        super().__init__(name)

    def _ma(self, x, d):
        c = jnp.cumsum(x, axis=0)
        z = jnp.zeros((1,) + x.shape[1:], x.dtype)
        c = jnp.concatenate([z, c], axis=0)
        return (c[d:] - c[:-d]) / d

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        d = self.d
        acc = x.astype(jnp.complex64 if jnp.iscomplexobj(x) else jnp.float32)
        if self.long_form:
            ma = self._ma(self._ma(acc, d), d)  # len: n + d - 1
            delay = d - 1
        else:
            ma = self._ma(acc, d)
            delay = (d - 1) // 2
        # align input with the MA's group delay
        center = jax.lax.dynamic_slice_in_dim(
            x, self.history - 1 - delay, n)
        y = center - ma[ma.shape[0] - n:].astype(x.dtype)
        return state, y


class Goertzel(Block):
    """gr_goertzel_fc: single-bin DFT per length-N batch."""

    def __init__(self, rate: int, batch_len: int, freq: float, name=None):
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.complex64),)
        self.decim = batch_len
        super().__init__(name)
        self.k = freq * batch_len / rate
        self.n = batch_len

    def apply(self, state, x):
        xb = x.reshape(-1, self.n)
        w = jnp.exp(-2j * np.pi * self.k / self.n
                    * jnp.arange(self.n)).astype(jnp.complex64)
        return state, (xb.astype(jnp.complex64) * w[None, :]).sum(axis=1)


class FractionalInterpolator(Block):
    """gr_fractional_interpolator_{ff,cc}: fixed fractional resampling via
    the 8-tap MMSE interpolator bank (gri_mmse_fir_interpolator).

    Static approximation: per-chunk output count is fixed at n/ratio, with
    the residual phase carried (matches the reference's steady-state rate)."""

    def __init__(self, phase_shift: float, interp_ratio: float,
                 dtype=jnp.float32, name=None):
        from fractions import Fraction

        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        fr = Fraction(interp_ratio).limit_denominator(512)
        self.decim = fr.numerator
        self.interp = fr.denominator
        self.history = 9
        super().__init__(name)
        self.ratio = interp_ratio
        self.phase0 = phase_shift
        from grtpu.ops.mmse_interp import mmse_taps

        self.bank = mmse_taps()  # (129, 8)

    def apply(self, state, x):
        from grtpu.ops.mmse_interp import mmse_interpolate

        n_in = x.shape[0] - (self.history - 1)
        nout = n_in // self.decim * self.interp
        pos = self.phase0 + self.ratio * jnp.arange(nout)
        y = mmse_interpolate(x, pos, self.bank)
        return state, y.astype(self.out_ports[0].dtype)


import jax  # noqa: E402  (used by Hilbert/FilterDelay dynamic slices)
