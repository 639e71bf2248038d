"""FM broadcast / narrowband models (the blks2impl analogs).

Analogs: blks2impl/wfm_rcv.py:69 (quad demod -> FIR decim -> deemph),
wfm_tx.py, nbfm_rx.py, nbfm_tx.py, fm_emph.py (single-pole IIR pre/de-
emphasis), am_demod.py, standard_squelch.py.

North-star config #1 (BASELINE.json): the WBFM receive chain from an IQ
capture — freq_xlating_fir_filter -> quadrature_demod -> decimating FIR ->
deemphasis.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port
from grtpu.runtime.graph import Graph, HierBlock
from grtpu.blocks.analog import QuadratureDemod, FrequencyModulator
from grtpu.blocks.filter import FirFilter, IirFilter, InterpFirFilter
from grtpu.utils import firdes


class FmDeemph(HierBlock):
    """Single-pole IIR de-emphasis (blks2impl/fm_emph.py fm_deemph).

    Bilinear-transformed RC lowpass H(s) = 1/(1 + s*tau), prewarped:
        w_c = 1/tau;  w_ca = 2 fs tan(w_c / (2 fs));  k = w_ca/(2 fs)
        H(z) = b0 (1 + z^-1) / (1 - p1 z^-1),  p1 = (1-k)/(1+k),
        b0 = k/(1+k)  (unity DC gain).

    NOTE: deliberately diverges from the reference's fm_emph.py taps, whose
    feedback-sign convention is inverted for gri_iir (a known GNU Radio 3.5
    defect, corrected upstream in 3.8); this is the correct response the
    reference *intended* (see its own H(s) derivation comment).
    """

    def __init__(self, fs: float, tau: float = 75e-6, name=None):
        super().__init__(name)
        k = math.tan(1.0 / (tau * 2.0 * fs))
        p1 = (1.0 - k) / (1.0 + k)
        b0 = k / (1.0 + k)
        btaps = [b0, b0]
        fbtaps = [1.0, p1]  # our iir convention: y += fbtaps[1]*y[n-1]
        i = self.graph.add_input(Port(jnp.float32))
        o = self.graph.add_output(Port(jnp.float32))
        self.graph.connect(i, IirFilter(btaps, fbtaps), o)


class FmPreemph(HierBlock):
    """Single-pole IIR pre-emphasis (blks2impl/fm_emph.py fm_preemph).

    H(s) = (1 + s/w1) / (1 + s/w2) with w1 = 1/tau (prewarped) and a
    high-corner w2 (default 0.925*Nyquist) bounding the HF boost — the
    stable shelf the reference's (placeholder) preemph intends.
    """

    def __init__(self, fs: float, tau: float = 75e-6, fh: float = -1.0,
                 name=None):
        super().__init__(name)
        if fh <= 0 or fh >= fs / 2:
            fh = 0.925 * fs / 2.0
        # prewarped corner frequencies
        ka = 2.0 * fs * math.tan(1.0 / (tau * 2.0 * fs))  # w1 analog
        kb = 2.0 * fs * math.tan(math.pi * fh / fs)        # w2 analog
        K = 2.0 * fs
        b0 = (1 + K / ka) / (1 + K / kb)
        b1 = (1 - K / ka) / (1 + K / kb)
        a1 = (1 - K / kb) / (1 + K / kb)
        # normalize to unity DC gain: H(1) = (b0+b1)/(1+a1)
        g = (1 + a1) / (b0 + b1)
        i = self.graph.add_input(Port(jnp.float32))
        o = self.graph.add_output(Port(jnp.float32))
        self.graph.connect(i, IirFilter([g * b0, g * b1], [1.0, -a1]), o)


class WfmRcv(HierBlock):
    """Broadcast WBFM receiver (blks2impl/wfm_rcv.py:69).

    quad_rate IQ in -> quadrature_demod -> decimating audio FIR -> deemph
    -> audio_rate float out.
    """

    def __init__(self, quad_rate: float, audio_decimation: int, name=None):
        super().__init__(name)
        max_dev = 75e3
        fm_demod_gain = quad_rate / (2 * math.pi * max_dev)
        audio_rate = quad_rate / audio_decimation

        audio_taps = firdes.low_pass(
            1.0, quad_rate, audio_rate / 2 - 1e3, audio_rate / 10,
            firdes.Window.HAMMING)

        i = self.graph.add_input(Port(jnp.complex64))
        o = self.graph.add_output(Port(jnp.float32))
        self.fm_demod = QuadratureDemod(fm_demod_gain)
        self.audio_filter = FirFilter(audio_decimation, audio_taps, "fff")
        self.deemph = FmDeemph(audio_rate, 75e-6)
        self.graph.connect(i, self.fm_demod, self.audio_filter, self.deemph, o)


class NbfmRx(HierBlock):
    """Narrowband FM receiver (blks2impl/nbfm_rx.py): channel LPF ->
    quadrature demod (5 kHz deviation) -> audio LPF -> deemph."""

    def __init__(self, audio_rate: float, quad_rate: float,
                 tau: float = 75e-6, max_dev: float = 5e3, name=None):
        super().__init__(name)
        if quad_rate % audio_rate != 0:
            raise ValueError("quad_rate must be a multiple of audio_rate")
        audio_decim = int(quad_rate // audio_rate)
        demod_gain = quad_rate / (2 * math.pi * max_dev)
        audio_taps = firdes.low_pass(1.0, quad_rate, 2.7e3, 0.5e3,
                                     firdes.Window.HAMMING)
        i = self.graph.add_input(Port(jnp.complex64))
        o = self.graph.add_output(Port(jnp.float32))
        self.graph.connect(
            i, QuadratureDemod(demod_gain),
            FirFilter(audio_decim, audio_taps, "fff"),
            FmDeemph(audio_rate, tau), o)


class NbfmTx(HierBlock):
    """Narrowband FM transmitter (blks2impl/nbfm_tx.py): interpolate audio
    to quad rate -> frequency modulate."""

    def __init__(self, audio_rate: float, quad_rate: float,
                 max_dev: float = 5e3, name=None):
        super().__init__(name)
        if quad_rate % audio_rate != 0:
            raise ValueError("quad_rate must be a multiple of audio_rate")
        interp = int(quad_rate // audio_rate)
        taps = firdes.low_pass(interp, quad_rate, 4500, 2500,
                               firdes.Window.HAMMING)
        k = 2 * math.pi * max_dev / quad_rate
        i = self.graph.add_input(Port(jnp.float32))
        o = self.graph.add_output(Port(jnp.complex64))
        if interp > 1:
            self.graph.connect(i, InterpFirFilter(interp, taps, "fff"),
                               FrequencyModulator(k), o)
        else:
            self.graph.connect(i, FrequencyModulator(k), o)


class WfmTx(HierBlock):
    """Broadcast WBFM transmitter (blks2impl/wfm_tx.py, mono, no preemph)."""

    def __init__(self, audio_rate: float, quad_rate: float,
                 max_dev: float = 75e3, name=None):
        super().__init__(name)
        if quad_rate % audio_rate != 0:
            raise ValueError("quad_rate must be a multiple of audio_rate")
        interp = int(quad_rate // audio_rate)
        k = 2 * math.pi * max_dev / quad_rate
        i = self.graph.add_input(Port(jnp.float32))
        o = self.graph.add_output(Port(jnp.complex64))
        if interp > 1:
            taps = firdes.low_pass(interp, quad_rate, audio_rate / 2 - 500,
                                   audio_rate / 10, firdes.Window.HAMMING)
            self.graph.connect(i, InterpFirFilter(interp, taps, "fff"),
                               FrequencyModulator(k), o)
        else:
            self.graph.connect(i, FrequencyModulator(k), o)


class AmDemod(HierBlock):
    """AM envelope demodulator (blks2impl/am_demod.py am_demod_cf):
    magnitude -> DC block (long MA subtract) -> audio LPF decimator."""

    def __init__(self, channel_rate: float, audio_decim: int,
                 audio_pass: float = 5000, audio_stop: float = 5500, name=None):
        super().__init__(name)
        from grtpu.blocks.convert import ComplexToMag
        from grtpu.blocks.filter import DcBlocker

        audio_taps = firdes.low_pass(
            1.0, channel_rate, audio_pass, audio_stop - audio_pass,
            firdes.Window.HAMMING)
        i = self.graph.add_input(Port(jnp.complex64))
        o = self.graph.add_output(Port(jnp.float32))
        self.graph.connect(i, ComplexToMag(), DcBlocker(1024, False),
                           FirFilter(audio_decim, audio_taps, "fff"), o)


class _StereoCarrier(Block):
    """Recover the 38 kHz stereo subcarrier by squaring the normalized
    19 kHz pilot's analytic signal (the PLL-doubled carrier of
    wfm_rcv_pll.py, done as a vectorized phase doubler)."""

    def __init__(self, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        super().__init__(name)

    def apply(self, state, x):
        n = x / jnp.maximum(jnp.abs(x), 1e-9)
        return state, (n * n).astype(jnp.complex64)


class _MixReal(Block):
    """out = composite * sin(2*w_pilot*t) * 2 — the DSB-SC stereo mixer.

    The analytic pilot sin(wt) squares to -e^{2jwt}, so the in-phase 38 kHz
    reference sin(2wt) is -imag of the squared carrier."""

    def __init__(self, name=None):
        self.in_ports = (Port(jnp.float32), Port(jnp.complex64))
        self.out_ports = (Port(jnp.float32),)
        super().__init__(name)

    def apply(self, state, comp, carrier):
        return state, comp * (-jnp.imag(carrier)) * 2.0


class WfmRcvPll(HierBlock):
    """Stereo broadcast FM receiver (blks2impl/wfm_rcv_pll.py).

    quad demod -> composite; pilot band-pass -> analytic -> squared ->
    38 kHz carrier; (L+R) lowpass and (L-R) = composite x carrier lowpass;
    outputs (left, right) after deemphasis.
    """

    def __init__(self, quad_rate: float, audio_decimation: int, name=None):
        super().__init__(name)
        from grtpu.blocks.filter import FilterDelay
        from grtpu.blocks.gengen import Add, Sub
        import numpy as _np

        max_dev = 75e3
        gain = quad_rate / (2 * math.pi * max_dev)
        audio_rate = quad_rate / audio_decimation

        i = self.graph.add_input(Port(jnp.complex64))
        o_l = self.graph.add_output(Port(jnp.float32))
        o_r = self.graph.add_output(Port(jnp.float32))

        demod = QuadratureDemod(gain)
        # pilot: band-pass 18.8-19.2k as analytic signal (filter + Hilbert
        # pair in one complex filter)
        pilot_taps = firdes.complex_band_pass(
            1.0, quad_rate, 18.6e3, 19.4e3, 0.6e3)
        from grtpu.blocks.filter import FirFilter
        pilot = FirFilter(1, pilot_taps, "ccc", name=None, impl="matmul")
        # complex input expected: route composite through float->complex
        from grtpu.blocks.convert import FloatToComplex
        f2c = FloatToComplex(1)
        carrier = _StereoCarrier()
        mix = _MixReal()

        audio_taps = firdes.low_pass(1.0, quad_rate, 15e3, 4e3)
        sum_filter = FirFilter(audio_decimation, audio_taps, "fff")
        diff_filter = FirFilter(audio_decimation, audio_taps, "fff")
        add = Add(dtype=jnp.float32, nin=2)
        sub = Sub(dtype=jnp.float32, nin=2)
        deemph_l = FmDeemph(audio_rate)
        deemph_r = FmDeemph(audio_rate)

        self.graph.connect(i, demod)
        self.graph.connect(demod, f2c, pilot, carrier, (mix, 1))
        self.graph.connect(demod, (mix, 0))
        self.graph.connect(demod, sum_filter)
        self.graph.connect(mix, diff_filter)
        self.graph.connect(sum_filter, (add, 0))
        self.graph.connect(diff_filter, (add, 1))
        self.graph.connect(sum_filter, (sub, 0))
        self.graph.connect(diff_filter, (sub, 1))
        self.graph.connect(add, deemph_l, o_l)
        self.graph.connect(sub, deemph_r, o_r)


class WfmRcvFmdet(HierBlock):
    """blks2impl/wfm_rcv_fmdet.py: WBFM receive using the balanced
    discriminator (FmDet) front end instead of quadrature_demod."""

    def __init__(self, quad_rate: float, audio_decimation: int, name=None):
        super().__init__(name)
        from grtpu.blocks.analog import FmDet

        audio_rate = quad_rate / audio_decimation
        audio_taps = firdes.low_pass(
            1.0, quad_rate, audio_rate / 2 - 1e3, audio_rate / 10,
            firdes.Window.HAMMING)
        i = self.graph.add_input(Port(jnp.complex64))
        o = self.graph.add_output(Port(jnp.float32))
        self.graph.connect(
            i, FmDet(quad_rate, -75e3, 75e3),
            FirFilter(audio_decimation, audio_taps, "fff"),
            FmDeemph(audio_rate), o)


class FmDemod(HierBlock):
    """blks2.fm_demod_cf (blks2impl/fm_demod.py:25-71): generalized FM
    demodulation — quadrature demod at k = rate/(2*pi*deviation), optional
    deemphasis, then an optfir-designed decimating audio LPF."""

    def __init__(self, channel_rate: float, audio_decim: int,
                 deviation: float, audio_pass: float, audio_stop: float,
                 gain: float = 1.0, tau: float = 75e-6, name=None):
        super().__init__(name)
        from grtpu.utils import optfir
        k = channel_rate / (2 * math.pi * deviation)
        audio_taps = optfir.low_pass(gain, channel_rate, audio_pass,
                                     audio_stop, 0.1, 60)
        i = self.graph.add_input(Port(jnp.complex64))
        o = self.graph.add_output(Port(jnp.float32))
        quad = QuadratureDemod(k)
        lpf = FirFilter(audio_decim, audio_taps, "fff")
        if tau is not None and tau > 0:
            self.graph.connect(i, quad, FmDeemph(channel_rate, tau), lpf, o)
        else:
            self.graph.connect(i, quad, lpf, o)


class Demod20k0f3e(FmDemod):
    """blks2.demod_20k0f3e_cf: NBFM, 20 kHz channels."""

    def __init__(self, channel_rate: float, audio_decim: int, name=None):
        super().__init__(channel_rate, audio_decim, 5000, 3000, 4500,
                         name=name)


class Demod200kf3e(FmDemod):
    """blks2.demod_200kf3e_cf: broadcast WFM."""

    def __init__(self, channel_rate: float, audio_decim: int, name=None):
        super().__init__(channel_rate, audio_decim, 75000, 15000, 16000,
                         name=name)
