"""Analog / sync-loop blocks.

Analogs (SURVEY.md §2.4): gr_quadrature_demod_cf, gr_frequency_modulator_fc,
gr_phase_modulator_fc, gr_sig_source_X, gr_agc{,2}_{cc,ff}, gr_rms_{cf,ff},
gr_simple_squelch_cc, gr_pwr_squelch, gr_pll_{refout_cc,freqdet_cf,
carriertracking_cc}, gr_fmdet_cf, gr_probe_avg_mag_sqrd_*.

Feedback loops (AGC, PLL) are lax.scan recurrences over the time-block with
explicit carried state — the vectorized form of the reference's per-sample
member-variable updates (gri_agc2_cc.h, gri_control_loop.cc:34-80).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port
from grtpu.ops import dsp


class QuadratureDemod(Block):
    """gr_quadrature_demod_cf (general/gr_quadrature_demod_cf.cc:47-62)."""

    def __init__(self, gain: float, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.float32),)
        self.history = 2
        super().__init__(name)
        self.gain = gain

    def apply(self, state, x):
        return state, dsp.quadrature_demod(x, self.gain)


class FrequencyModulator(Block):
    """gr_frequency_modulator_fc."""

    def __init__(self, sensitivity: float, name=None):
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.complex64),)
        super().__init__(name)
        self.sensitivity = sensitivity

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        y, ph = dsp.frequency_modulator(x, state, self.sensitivity)
        return ph, y


class PhaseModulator(Block):
    """gr_phase_modulator_fc."""

    def __init__(self, sensitivity: float, name=None):
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = (Port(jnp.complex64),)
        super().__init__(name)
        self.sensitivity = sensitivity

    def apply(self, state, x):
        return state, dsp.phase_modulator(x, self.sensitivity)


class SigSource(Block):
    """gr_sig_source_X: waveform generator with carried NCO phase.

    waveform: 'cos', 'sin', 'square', 'triangle', 'sawtooth', 'const',
    'complex' (complex exponential, for dtype=complex64)."""

    def __init__(self, sampling_freq: float, waveform: str, frequency: float,
                 amplitude: float = 1.0, offset: float = 0.0,
                 dtype=jnp.float32, name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.fs = sampling_freq
        self.waveform = waveform
        self.freq = frequency
        self.amp = amplitude
        self.offset = offset
        self._dtype = jnp.dtype(dtype)

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, n: int):
        inc = 2 * np.pi * self.freq / self.fs
        ph = state + inc * jnp.arange(n, dtype=jnp.float32)
        wf = self.waveform
        if jnp.issubdtype(self._dtype, jnp.complexfloating) or wf == "complex":
            y = self.amp * jnp.exp(1j * ph) + self.offset
            y = y.astype(jnp.complex64)
        elif wf == "cos":
            y = (self.amp * jnp.cos(ph) + self.offset).astype(self._dtype)
        elif wf == "sin":
            y = (self.amp * jnp.sin(ph) + self.offset).astype(self._dtype)
        elif wf == "square":
            y = (self.amp * jnp.where(jnp.mod(ph, 2 * np.pi) < np.pi, 1.0, 0.0)
                 + self.offset).astype(self._dtype)
        elif wf == "triangle":
            frac = jnp.mod(ph, 2 * np.pi) / (2 * np.pi)
            tri = 2 * jnp.abs(2 * frac - 1) - 1
            y = (self.amp * tri + self.offset).astype(self._dtype)
        elif wf == "sawtooth":
            frac = jnp.mod(ph, 2 * np.pi) / (2 * np.pi)
            y = (self.amp * (2 * frac - 1) + self.offset).astype(self._dtype)
        elif wf == "const":
            y = jnp.full((n,), self.amp + self.offset, self._dtype)
        else:
            raise ValueError(f"unknown waveform {wf}")
        new_phase = jnp.mod(state + inc * n, 2 * np.pi)
        return new_phase, y


class Agc(Block):
    """gr_agc_{cc,ff} (gri_agc_xx): g += rate * (reference - |out|)."""

    def __init__(self, rate: float = 1e-4, reference: float = 1.0,
                 gain: float = 1.0, max_gain: float = 0.0,
                 dtype=jnp.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.rate, self.reference = rate, reference
        self.gain0, self.max_gain = gain, max_gain

    def init_state(self):
        return jnp.asarray(self.gain0, jnp.float32)

    def apply(self, state, x):
        rate, ref, maxg = self.rate, self.reference, self.max_gain

        def f(g, xi):
            y = xi * g
            g = g + rate * (ref - jnp.abs(y))
            if maxg > 0:
                g = jnp.minimum(g, maxg)
            return g, y

        g, y = jax.lax.scan(f, state, x)
        return g, y


class Agc2(Block):
    """gr_agc2_{cc,ff} (gri_agc2_xx): separate attack/decay rates."""

    def __init__(self, attack_rate: float = 1e-1, decay_rate: float = 1e-2,
                 reference: float = 1.0, gain: float = 1.0,
                 max_gain: float = 0.0, dtype=jnp.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.attack, self.decay = attack_rate, decay_rate
        self.reference, self.gain0, self.max_gain = reference, gain, max_gain

    def init_state(self):
        return jnp.asarray(self.gain0, jnp.float32)

    def apply(self, state, x):
        att, dec, ref, maxg = self.attack, self.decay, self.reference, self.max_gain

        def f(g, xi):
            y = xi * g
            err = ref - jnp.abs(y)
            rate = jnp.where(err < 0, att, dec)
            g = g + rate * err
            if maxg > 0:
                g = jnp.minimum(g, maxg)
            return g, y

        g, y = jax.lax.scan(f, state, x)
        return g, y


class FeedForwardAgc(Block):
    """gr_feedforward_agc_cc: normalize by the max magnitude over the next N
    samples (non-causal window; history supplies the lookahead)."""

    def __init__(self, nsamples: int = 128, reference: float = 1.0, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = nsamples
        super().__init__(name)
        self.nsamples = nsamples
        self.reference = reference

    def apply(self, state, x):
        n = x.shape[0] - (self.history - 1)
        mag = jnp.abs(x)
        idx = jnp.arange(n)[:, None] + jnp.arange(self.nsamples)[None, :]
        wmax = mag[idx].max(axis=1)
        gain = self.reference / jnp.maximum(wmax, 1e-12)
        return state, (x[: n] * gain).astype(jnp.complex64)


class Rms(Block):
    """gr_rms_{cf,ff}: single-pole-averaged RMS."""

    def __init__(self, alpha: float = 1e-4, dtype=jnp.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(jnp.float32),)
        super().__init__(name)
        self.alpha = alpha

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        avg, st = dsp.single_pole_iir(p, state, self.alpha)
        return st, jnp.sqrt(avg)


class ProbeAvgMagSqrd(Block):
    """gr_probe_avg_mag_sqrd_c: IIR-averaged |x|^2 with threshold flag,
    readable from the host after a run."""

    def __init__(self, threshold_db: float = 0.0, alpha: float = 1e-4, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = ()
        super().__init__(name)
        self.alpha = alpha
        self.threshold = 10 ** (threshold_db / 10)
        self.captured = None
        self._ex = None

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        _, st = dsp.single_pole_iir(p, state, self.alpha)
        return st, ()

    def unmuted(self):
        return self.level() >= self.threshold

    def level(self):
        if self.captured is None:
            return 0.0
        x = np.asarray(self.captured[0])
        # re-derive the final average on host
        p = np.abs(x) ** 2
        acc = 0.0
        for v in p[-4096:]:
            acc = self.alpha * v + (1 - self.alpha) * acc
        return float(acc)


class SimpleSquelch(Block):
    """gr_simple_squelch_cc: zero output while IIR-averaged power is below
    threshold."""

    def __init__(self, threshold_db: float = -40.0, alpha: float = 1e-4, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        super().__init__(name)
        self.alpha = alpha
        self.threshold = 10 ** (threshold_db / 10)

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        avg, st = dsp.single_pole_iir(p, state, self.alpha)
        return st, jnp.where(avg >= self.threshold, x, 0.0).astype(jnp.complex64)


class PwrSquelch(Block):
    """gr_pwr_squelch_{cc,ff} (no ramp: gate on averaged power)."""

    def __init__(self, threshold_db: float = -40.0, alpha: float = 1e-4,
                 dtype=jnp.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.alpha = alpha
        self.threshold = 10 ** (threshold_db / 10)

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        p = (jnp.abs(x) ** 2).astype(jnp.float32)
        avg, st = dsp.single_pole_iir(p, state, self.alpha)
        return st, jnp.where(avg >= self.threshold, x, 0.0).astype(x.dtype)


class _PllBase(Block):
    """Shared 2nd-order PLL recurrence (gri_control_loop semantics)."""

    def __init__(self, loop_bw: float, max_freq: float, min_freq: float,
                 in_dtype=jnp.complex64, out_dtype=jnp.complex64, name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        super().__init__(name)
        self.alpha, self.beta = dsp.control_loop_gains(loop_bw)
        self.max_freq, self.min_freq = max_freq, min_freq

    def init_state(self):
        return (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))

    def _scan(self, state, x, emit):
        alpha, beta = self.alpha, self.beta
        fmax, fmin = self.max_freq, self.min_freq

        def f(carry, xi):
            phase, freq = carry
            ref = jnp.exp(1j * phase).astype(jnp.complex64)
            err = jnp.arctan2(
                jnp.imag(xi * jnp.conj(ref)), jnp.real(xi * jnp.conj(ref)))
            freq = jnp.clip(freq + beta * err, fmin, fmax)
            phase = dsp.phase_wrap(phase + freq + alpha * err)
            return (phase, freq), emit(xi, ref, phase, freq)

        return jax.lax.scan(f, state, x)


class PllRefout(_PllBase):
    """gr_pll_refout_cc: outputs the locked reference carrier."""

    def apply(self, state, x):
        st, y = self._scan(state, x,
                           lambda xi, ref, ph, fr: jnp.exp(1j * ph).astype(jnp.complex64))
        return st, y


class PllFreqdet(_PllBase):
    """gr_pll_freqdet_cf: outputs instantaneous loop frequency (rad/sample)."""

    def __init__(self, loop_bw, max_freq, min_freq, name=None):
        super().__init__(loop_bw, max_freq, min_freq,
                         out_dtype=jnp.float32, name=name)

    def apply(self, state, x):
        st, y = self._scan(state, x, lambda xi, ref, ph, fr: fr)
        return st, y


class PllCarrierTracking(_PllBase):
    """gr_pll_carriertracking_cc: derotates input by the locked carrier."""

    def apply(self, state, x):
        st, y = self._scan(
            state, x,
            lambda xi, ref, ph, fr: (xi * jnp.conj(ref)).astype(jnp.complex64))
        return st, y


class FmDet(Block):
    """gr_fmdet_cf: balanced-discriminator FM detector (simplified to exact
    quadrature discriminator scaled to [fl, fh])."""

    def __init__(self, samplerate: float, freq_low: float, freq_high: float,
                 scl: float = 1.0, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.float32),)
        self.history = 2
        super().__init__(name)
        bw = (freq_high - freq_low) / 2 or 1.0
        self.gain = scl * samplerate / (2 * np.pi * bw)

    def apply(self, state, x):
        return state, dsp.quadrature_demod(x, self.gain)


class Vco(Block):
    """gr_vco_f: out = amplitude * cos(phase), phase integrating
    sensitivity * input (gr_vco_f.cc / gr_fxpt_vco) — exact float phase
    accumulation instead of the fixed-point table."""

    in_ports = (Port(jnp.float32),)
    out_ports = (Port(jnp.float32),)

    def __init__(self, sampling_rate: float, sensitivity: float,
                 amplitude: float = 1.0, name=None):
        super().__init__(name)
        self.k = float(sensitivity) / float(sampling_rate)
        self.amplitude = float(amplitude)

    def init_state(self):
        return jnp.zeros((), jnp.float32)

    def apply(self, state, x):
        y, ph = dsp.vco(x, state, self.k)
        return ph, self.amplitude * y
