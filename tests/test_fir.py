"""Kernel-substrate golden tests: FIR / FFT-filter vs numpy/scipy references.

Tier-1 analog of the reference's filter QA
(gnuradio-core/src/lib/filter/qa_gr_fir_{ccc,ccf,fff}.cc — every kernel
variant checked against a reference dot product; gr/qa_fft_filter.py —
fft_filter vs fir_filter as golden on random data).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from grtpu.ops.fir import (
    fir_filter, interp_fir_filter, fir_filterbank, batch_fir_filter,
    freq_xlating_fir_filter, rotate_taps,
)
from grtpu.ops.fft_filter import fft_filter
from grtpu.ops import dsp
from grtpu.utils import firdes


def ref_fir(x, taps, decim=1):
    """Convolution form: y[i] = sum_k taps[k] x[i*decim + K-1-k]."""
    k = len(taps)
    n = len(x) - (k - 1)
    nout = n // decim
    tr = np.asarray(taps)[::-1]
    return np.array([np.dot(tr, x[i * decim:i * decim + k]) for i in range(nout)])


RNG = np.random.RandomState(42)


class TestFirFilter:
    @pytest.mark.parametrize("k", [1, 5, 16, 63, 256])
    @pytest.mark.parametrize("n", [4, 100, 1000])
    def test_fff(self, k, n):
        if n < 1:
            return
        x = RNG.randn(n + k - 1).astype(np.float32)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        ref = ref_fir(x, taps)
        np.testing.assert_allclose(y, ref, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("k", [7, 64])
    def test_ccf(self, k):
        n = 300
        x = (RNG.randn(n + k - 1) + 1j * RNG.randn(n + k - 1)).astype(np.complex64)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        np.testing.assert_allclose(y, ref_fir(x, taps), rtol=3e-4, atol=3e-4)

    @pytest.mark.parametrize("k", [7, 64])
    def test_ccc(self, k):
        n = 300
        x = (RNG.randn(n + k - 1) + 1j * RNG.randn(n + k - 1)).astype(np.complex64)
        taps = (RNG.randn(k) + 1j * RNG.randn(k)).astype(np.complex64)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        np.testing.assert_allclose(y, ref_fir(x, taps), rtol=3e-4, atol=4e-4)

    def test_fcc(self):
        k, n = 31, 200
        x = RNG.randn(n + k - 1).astype(np.float32)
        taps = (RNG.randn(k) + 1j * RNG.randn(k)).astype(np.complex64)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        np.testing.assert_allclose(y, ref_fir(x, taps), rtol=3e-4, atol=3e-4)

    @pytest.mark.parametrize("decim", [2, 3, 4, 8])
    @pytest.mark.parametrize("k", [16, 57, 128])
    def test_decimating(self, decim, k):
        n = 240 * decim
        x = RNG.randn(n + k - 1).astype(np.float32)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps), decim))
        np.testing.assert_allclose(y, ref_fir(x, taps, decim), rtol=3e-4, atol=3e-4)

    def test_decimating_complex(self):
        decim, k, n = 5, 45, 100 * 5
        x = (RNG.randn(n + k - 1) + 1j * RNG.randn(n + k - 1)).astype(np.complex64)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps), decim))
        np.testing.assert_allclose(y, ref_fir(x, taps, decim), rtol=3e-4, atol=3e-4)


class TestInterpFir:
    @pytest.mark.parametrize("interp", [2, 4, 7])
    def test_interp(self, interp):
        k = 4 * interp + 3
        n = 100
        kp = -(-k // interp)
        x = RNG.randn(n + kp - 1).astype(np.float32)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(interp_fir_filter(jnp.asarray(x), jnp.asarray(taps), interp))
        # direct polyphase convolution reference (x carries kp-1 history)
        tp = np.pad(taps, (0, kp * interp - k))
        ref = np.zeros(n * interp, np.float32)
        for p in range(interp):
            hp = tp[p::interp]
            for i in range(n):
                # y[i*L+p] = sum_c hp[c] x_current[i - c]; x index shifted by history
                acc = 0.0
                for c in range(kp):
                    acc += hp[c] * x[i + kp - 1 - c]
                ref[i * interp + p] = acc
        np.testing.assert_allclose(y, ref, rtol=3e-4, atol=3e-4)


class TestFilterbank:
    def test_bank(self):
        f, k, n = 8, 33, 200
        x = RNG.randn(n + k - 1).astype(np.float32)
        bank = RNG.randn(f, k).astype(np.float32)
        y = np.asarray(fir_filterbank(jnp.asarray(x), jnp.asarray(bank)))
        assert y.shape == (f, n)
        for i in range(f):
            np.testing.assert_allclose(y[i], ref_fir(x, bank[i]), rtol=3e-4, atol=3e-4)

    def test_batch(self):
        c, k, n = 4, 21, 150
        x = RNG.randn(c, n + k - 1).astype(np.float32)
        taps = RNG.randn(k).astype(np.float32)
        y = np.asarray(batch_fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        for i in range(c):
            np.testing.assert_allclose(y[i], ref_fir(x[i], taps), rtol=3e-4, atol=3e-4)


class TestFftFilter:
    """fft_filter must match fir_filter exactly (gr/qa_fft_filter.py idiom)."""

    @pytest.mark.parametrize("k", [9, 64, 200, 301])
    def test_vs_fir_fff(self, k):
        n = 1000
        x = RNG.randn(n + k - 1).astype(np.float32)
        taps = RNG.randn(k).astype(np.float32)
        a = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        b = np.asarray(fft_filter(jnp.asarray(x), jnp.asarray(taps)))
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-3)

    def test_vs_fir_ccc_decim(self):
        k, d, n = 55, 4, 600 * 4
        x = (RNG.randn(n + k - 1) + 1j * RNG.randn(n + k - 1)).astype(np.complex64)
        taps = (RNG.randn(k) + 1j * RNG.randn(k)).astype(np.complex64)
        a = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps), d))
        b = np.asarray(fft_filter(jnp.asarray(x), jnp.asarray(taps), d))
        np.testing.assert_allclose(a, b, rtol=3e-3, atol=3e-3)


class TestFreqXlating:
    def test_rotated_output(self):
        """Translated filter == rotate input to baseband, then filter.

        Matches gr_freq_xlating_fir_filter semantics: taps pre-rotated,
        output spun by the rotator at decim*phase_inc per output."""
        fs, fc = 8000.0, 1000.0
        k, d, n = 64, 4, 512
        proto = firdes.low_pass(1.0, fs, 500, 500, firdes.Window.HAMMING)
        proto = proto[:k] if len(proto) > k else proto
        kk = len(proto)
        x = (RNG.randn(n + kk - 1) + 1j * RNG.randn(n + kk - 1)).astype(np.complex64)
        rtaps = rotate_taps(proto, fc, fs)
        phase_inc = -2 * np.pi * fc / fs
        y, _ = freq_xlating_fir_filter(
            jnp.asarray(x), jnp.asarray(rtaps), jnp.float32(0.0), phase_inc, d)
        # reference: y[i] = exp(j*phase_inc*d*i) * sum_k rtaps[k] x[i*d+k]
        base = ref_fir(x, rtaps, d)
        rot = np.exp(1j * phase_inc * d * np.arange(len(base)))
        np.testing.assert_allclose(np.asarray(y), base * rot, rtol=2e-3, atol=2e-3)


class TestFirdes:
    def test_low_pass_response(self):
        import scipy.signal as sig
        taps = firdes.low_pass(1.0, 48000, 5000, 1000)
        w, h = sig.freqz(taps, fs=48000)
        mag = np.abs(h)
        assert abs(mag[0] - 1.0) < 0.01          # unity DC gain
        assert mag[w < 4000].min() > 0.95         # passband flat
        assert mag[w > 6500].max() < 0.02         # stopband down
        assert len(taps) % 2 == 1

    def test_high_pass_response(self):
        import scipy.signal as sig
        taps = firdes.high_pass(1.0, 48000, 10000, 2000)
        w, h = sig.freqz(taps, fs=48000)
        mag = np.abs(h)
        assert mag[w < 8000].max() < 0.05
        assert mag[w > 12000].min() > 0.95

    def test_band_pass_response(self):
        import scipy.signal as sig
        taps = firdes.band_pass(1.0, 48000, 5000, 10000, 1000)
        w, h = sig.freqz(taps, fs=48000)
        mag = np.abs(h)
        inband = (w > 6000) & (w < 9000)
        assert mag[inband].min() > 0.9
        assert mag[w < 3500].max() < 0.05
        assert mag[w > 11500].max() < 0.05

    def test_complex_band_pass(self):
        import scipy.signal as sig
        taps = firdes.complex_band_pass(1.0, 48000, 2000, 6000, 1000)
        w, h = sig.freqz(taps, fs=48000, whole=True)
        w = np.where(w > 24000, w - 48000, w)
        mag = np.abs(h)
        assert mag[(w > 3000) & (w < 5000)].min() > 0.9
        assert mag[(w < 0)].max() < 0.05  # negative freqs rejected

    def test_rrc_matched_pair(self):
        """RRC * RRC == raised cosine: zero ISI at symbol spacing."""
        spb = 4
        taps = firdes.root_raised_cosine(1.0, spb, 1.0, 0.35, 11 * spb)
        rc = np.convolve(taps, taps)
        center = len(rc) // 2
        sym = rc[center::spb][1:6] / rc[center]
        assert np.all(np.abs(sym) < 0.02)

    def test_gaussian_unit_sum(self):
        taps = firdes.gaussian(1.0, 4, 0.35, 16)
        assert abs(taps.sum() - 1.0) < 1e-5

    def test_hilbert(self):
        import scipy.signal as sig
        taps = firdes.hilbert(63, firdes.Window.HAMMING)
        w, h = sig.freqz(taps, fs=2.0)
        mag = np.abs(h)
        band = (w > 0.15) & (w < 0.85)
        np.testing.assert_allclose(mag[band], 1.0, atol=0.05)

    def test_kaiser_window(self):
        w = firdes.window(firdes.Window.KAISER, 65, beta=8.0)
        ref = np.kaiser(65, 8.0)
        np.testing.assert_allclose(w, ref, atol=1e-6)


class TestDsp:
    def test_quadrature_demod(self):
        """Pure tone -> constant frequency output (reference contract:
        out = gain * angle diff)."""
        fs, f = 8000.0, 440.0
        n = 256
        t = np.arange(n + 1)
        x = np.exp(2j * np.pi * f / fs * t).astype(np.complex64)
        gain = 1.0
        y = np.asarray(dsp.quadrature_demod(jnp.asarray(x), gain))
        np.testing.assert_allclose(y, 2 * np.pi * f / fs, rtol=1e-3)

    def test_fast_atan2(self):
        """Polynomial atan2 (gr_fast_atan2f analog): <2e-5 rad everywhere,
        exact on the axes, 0 at the origin like the reference."""
        r = np.random.RandomState(5)
        y = np.concatenate([r.randn(5000).astype(np.float32) * 10,
                            [0, 0, 1, -1, 0]]).astype(np.float32)
        x = np.concatenate([r.randn(5000).astype(np.float32) * 10,
                            [1, -1, 0, 0, 0]]).astype(np.float32)
        a = np.asarray(dsp.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
        np.testing.assert_allclose(a, np.arctan2(y, x), atol=2e-5)
        assert float(dsp.fast_atan2(jnp.float32(0), jnp.float32(0))) == 0.0

    def test_quadrature_demod_fast(self):
        fs, f, n = 8000.0, 440.0, 256
        t = np.arange(n + 1)
        x = np.exp(2j * np.pi * f / fs * t).astype(np.complex64)
        y = np.asarray(dsp.quadrature_demod(jnp.asarray(x), 1.0, fast=True))
        np.testing.assert_allclose(y, 2 * np.pi * f / fs, rtol=1e-3)

    def test_rotate_continuity(self):
        """Rotator phase must be continuous across chunks."""
        inc = 0.123
        x = np.ones(100, np.complex64)
        y1, ph = dsp.rotate(jnp.asarray(x[:50]), jnp.float32(0.0), inc)
        y2, _ = dsp.rotate(jnp.asarray(x[50:]), ph, inc)
        y = np.concatenate([np.asarray(y1), np.asarray(y2)])
        ref = np.exp(1j * inc * np.arange(100))
        np.testing.assert_allclose(y, ref, atol=1e-4)

    def test_frequency_modulator_roundtrip(self):
        """FM mod -> quadrature demod recovers the message."""
        n = 512
        msg = np.sin(2 * np.pi * 5 * np.arange(n + 1) / n).astype(np.float32)
        sens = 0.5
        y, _ = dsp.frequency_modulator(jnp.asarray(msg), jnp.float32(0.0), sens)
        rec = np.asarray(dsp.quadrature_demod(y, 1.0 / sens))
        np.testing.assert_allclose(rec, msg[1:], atol=1e-3)

    def test_single_pole_iir(self):
        alpha = 0.1
        x = RNG.randn(200).astype(np.float32)
        y, st = dsp.single_pole_iir(jnp.asarray(x), jnp.float32(0.0), alpha)
        ref = np.zeros(200)
        acc = 0.0
        for i, v in enumerate(x):
            acc = alpha * v + (1 - alpha) * acc
            ref[i] = acc
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-4, atol=1e-5)
        assert abs(float(st) - ref[-1]) < 1e-5

    def test_iir_filter_vs_scipy(self):
        import scipy.signal as sig
        # de-emphasis-style single pole written as general IIR
        b = np.array([0.2, 0.1], np.float32)
        a_fb = np.array([1.0, 0.6], np.float32)  # reference sign: y += 0.6*y[n-1]
        x = RNG.randn(300).astype(np.float32)
        state = dsp.iir_init_state(len(b), len(a_fb))
        y, _ = dsp.iir_filter(jnp.asarray(x), state, b, a_fb)
        # scipy uses y[n] = sum b x - sum a y  => a = [1, -0.6]
        ref = sig.lfilter(b, [1.0, -0.6], x)
        np.testing.assert_allclose(np.asarray(y), ref, rtol=1e-3, atol=1e-4)

    def test_control_loop_gains(self):
        a, b = dsp.control_loop_gains(0.1)
        assert 0 < b < a < 1


class TestLinearRecurrenceConst:
    def test_matches_scan_solver(self):
        import jax

        r = np.random.RandomState(1)
        for a in (0.728, 0.2, 0.0, 0.95, 0.995):  # last two: scan fallback
            b = jnp.asarray(r.randn(3, 400).astype(np.float32))
            y0 = jnp.asarray(r.randn(3).astype(np.float32))
            y1, l1 = jax.vmap(lambda bb, s: dsp.linear_recurrence(
                jnp.full(bb.shape, a, jnp.float32), bb, s))(b, y0)
            y2, l2 = dsp.linear_recurrence_const(a, b, y0)
            np.testing.assert_allclose(np.asarray(y1), np.asarray(y2),
                                       atol=1e-5, err_msg=f"a={a}")
            np.testing.assert_allclose(np.asarray(l1), np.asarray(l2),
                                       atol=1e-5)

    def test_state_continuity(self):
        r = np.random.RandomState(2)
        b = jnp.asarray(r.randn(600).astype(np.float32))
        y_all, _ = dsp.linear_recurrence_const(0.7, b, jnp.float32(0.0))
        y1, s = dsp.linear_recurrence_const(0.7, b[:300], jnp.float32(0.0))
        y2, _ = dsp.linear_recurrence_const(0.7, b[300:], s)
        np.testing.assert_allclose(
            np.concatenate([np.asarray(y1), np.asarray(y2)]),
            np.asarray(y_all), atol=1e-5)


def ref_fir64(x, taps, decim=1):
    """float64 reference in the FIR convolution form: x carries K-1 samples
    of history, y[i] = sum_k taps[k] x[i*decim + K-1-k]."""
    cplx = np.iscomplexobj(x) or np.iscomplexobj(taps)
    dt = np.complex128 if cplx else np.float64
    k = len(taps)
    n = len(x) - (k - 1)
    full = np.convolve(np.asarray(x, dt), np.asarray(taps, dt), "valid")
    return full[::decim][: n // decim]


def _form(name):
    """The two XLA FIR forms behind one signature (x, taps, decim)."""
    if name == "toeplitz":
        return lambda x, t, d=1: fir_filter(jnp.asarray(x), jnp.asarray(t), d)
    return lambda x, t, d=1: fft_filter(jnp.asarray(x), jnp.asarray(t), d)


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got) - ref).max()
                 / max(np.abs(ref).max(), 1e-12))


# f32 against float64: the Toeplitz form rounds each product sum once
# (~sqrt(K) * 6e-8 relative); the FFT form adds O(log2 fftsize) rounding.
# Bounds sit ~10x above what those estimates give at these sizes.
TOL = {"toeplitz": 2e-5, "fft": 1e-4}
FORMS = ["toeplitz", "fft"]


class TestXlaFirForms:
    """The plain XLA FIR forms (Toeplitz matmul, overlap-save FFT) against
    float64 np.convolve, over the tap/stage and tap/decimation grids the
    synthetic pipeline and the WBFM/DMR chains use."""

    @pytest.mark.parametrize("form", FORMS)
    @pytest.mark.parametrize("k,nst", [(256, 16), (256, 2), (64, 5),
                                       (17, 1)])
    def test_cascade_vs_float64(self, form, k, nst):
        rng = np.random.RandomState(100 + k + nst)
        x = rng.randn(2, 1024).astype(np.float32)
        taps = (rng.randn(k) * 0.1).astype(np.float32)
        f = _form(form)
        y, ref = x, x.astype(np.float64)
        for _ in range(nst):
            y = np.stack([np.asarray(f(np.concatenate(
                [np.zeros(k - 1, np.float32), row]), taps)) for row in y])
            ref = np.stack([ref_fir64(np.concatenate(
                [np.zeros(k - 1), row]), taps) for row in ref])
        assert y.shape == ref.shape
        assert _rel_err(y, ref) < TOL[form] * nst

    @pytest.mark.parametrize("form", FORMS)
    @pytest.mark.parametrize("k,d", [(31, 2), (155, 8), (256, 4), (129, 1)])
    def test_decim_vs_float64(self, form, k, d):
        rng = np.random.RandomState(200 + k + d)
        n = 512 * d
        x = rng.randn(n + k - 1).astype(np.float32)
        taps = (rng.randn(k) / k).astype(np.float32)
        got = _form(form)(x, taps, d)
        assert got.shape == (n // d,)
        assert _rel_err(got, ref_fir64(x, taps, d)) < TOL[form]

    @pytest.mark.parametrize("form", FORMS)
    def test_ccf_decim(self, form):
        rng = np.random.RandomState(301)
        k, d, n = 200, 4, 1024
        x = (rng.randn(n + k - 1) + 1j * rng.randn(n + k - 1)).astype(
            np.complex64)
        taps = (rng.randn(k) / k).astype(np.float32)
        got = _form(form)(x, taps, d)
        assert np.asarray(got).dtype == np.complex64
        assert _rel_err(got, ref_fir64(x, taps, d)) < TOL[form]

    @pytest.mark.parametrize("form", FORMS)
    def test_ccc_decim(self, form):
        rng = np.random.RandomState(302)
        k, d, n = 96, 2, 512
        x = (rng.randn(n + k - 1) + 1j * rng.randn(n + k - 1)).astype(
            np.complex64)
        taps = ((rng.randn(k) + 1j * rng.randn(k)) / k).astype(np.complex64)
        got = _form(form)(x, taps, d)
        assert _rel_err(got, ref_fir64(x, taps, d)) < TOL[form]

    @pytest.mark.parametrize("form", FORMS)
    def test_batch_channels(self, form):
        import jax

        rng = np.random.RandomState(303)
        k, d, c, n = 64, 8, 3, 2048
        x = rng.randn(c, n + k - 1).astype(np.float32)
        taps = (rng.randn(k) / k).astype(np.float32)
        if form == "toeplitz":
            got = batch_fir_filter(jnp.asarray(x), jnp.asarray(taps), d)
        else:
            got = jax.vmap(lambda r: fft_filter(r, jnp.asarray(taps), d))(
                jnp.asarray(x))
        ref = np.stack([ref_fir64(r, taps, d) for r in x])
        assert got.shape == ref.shape
        assert _rel_err(got, ref) < TOL[form]

    @pytest.mark.parametrize("form", FORMS)
    def test_long_filter_vs_float64(self, form):
        rng = np.random.RandomState(304)
        taps = (rng.randn(1000) * 0.03).astype(np.float32)
        x = rng.randn(1536 + 999).astype(np.float32)
        got = _form(form)(x, taps)
        assert _rel_err(got, ref_fir64(x, taps)) < TOL[form]

    @pytest.mark.parametrize("form", FORMS)
    def test_composed_equals_cascade(self, form):
        """compose_taps_power(taps, S) through one filter == S cascaded
        filters, both on the XLA path (bench.py's composed configs)."""
        from grtpu.ops.fir import compose_taps_power

        rng = np.random.RandomState(305)
        taps = (rng.randn(64) * 0.1).astype(np.float32)
        comp = compose_taps_power(taps, 4)
        x = rng.randn(1024).astype(np.float32)
        f = _form(form)
        y = x
        for _ in range(4):
            y = np.asarray(f(np.concatenate([np.zeros(63, np.float32), y]),
                             taps))
        y_cmp = np.asarray(f(np.concatenate(
            [np.zeros(len(comp) - 1, np.float32), x]), comp))
        assert _rel_err(y_cmp, y.astype(np.float64)) < 4 * TOL[form]

    def test_bf16x3_within_bound(self):
        """Split-word bf16x3 (three bf16 passes) stays within 1e-4 relative
        of float64: each split word keeps 16 of f32's 24 mantissa bits, and
        the dropped low x low term is ~2^-16 of the product."""
        from grtpu.ops import fir

        rng = np.random.RandomState(306)
        taps = (rng.randn(300) * 0.05).astype(np.float32)
        x = rng.randn(1024 + 299).astype(np.float32)
        prev = fir._PRECISION
        fir.set_precision("bf16x3")
        try:
            got = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(taps)))
        finally:
            fir.set_precision(prev)
        err = _rel_err(got, ref_fir64(x, taps))
        assert 0 < err < 1e-4

    def test_firfilter_pallas_impl_rejected(self):
        from grtpu.blocks.filter import FirFilter

        with pytest.raises(ValueError, match="impl"):
            FirFilter(1, np.ones(8, np.float32), "fff", impl="pallas")

    def test_firfilter_impls_agree_in_graph(self):
        """FirFilter's two forms inside a flowgraph give the same stream."""
        from grtpu.runtime.graph import Graph
        from grtpu.runtime.executor import StreamExecutor
        from grtpu.runtime.block import Port
        from grtpu.blocks.filter import FirFilter

        rng = np.random.RandomState(307)
        taps = (rng.randn(300) * 0.05).astype(np.float32)
        x = rng.randn(2048).astype(np.float32)

        def run(impl):
            g = Graph()
            pin = g.add_input(Port(jnp.float32))
            pout = g.add_output(Port(jnp.float32))
            g.connect(pin, FirFilter(1, taps, "fff", impl=impl), pout)
            return np.asarray(StreamExecutor(g, chunk_size=1024).run(x))

        mm, ff = run("matmul"), run("fft")
        assert _rel_err(ff, mm.astype(np.float64)) < 1e-4


class TestCompositionAndFusion:
    def test_compose_taps_exactness(self):
        from grtpu.ops.fir import compose_taps, fir_filter

        rng = np.random.RandomState(6)
        a = (rng.randn(31) * 0.2).astype(np.float32)
        b = (rng.randn(17) * 0.2).astype(np.float32)
        x = rng.randn(400).astype(np.float32)

        def run(t, xin):
            k = len(t)
            xh = jnp.concatenate([jnp.zeros(k - 1, jnp.float32),
                                  jnp.asarray(xin)])
            return np.asarray(fir_filter(xh, jnp.asarray(t)))

        chained = run(b, run(a, x))
        composed = run(compose_taps(a, b), x)
        assert np.abs(chained - composed).max() / np.abs(chained).max() < 1e-5

    def test_fuse_fir_chains_pass(self):
        """Graph-level LTI fusion: a 3-stage FIR chain collapses to one
        composed filter with identical output (within reassociation)."""
        from grtpu.runtime.graph import Graph
        from grtpu.runtime.executor import StreamExecutor
        from grtpu.runtime.block import Port
        from grtpu.blocks.filter import FirFilter

        rng = np.random.RandomState(10)
        t1 = (rng.randn(63) * 0.1).astype(np.float32)
        t2 = (rng.randn(33) * 0.1).astype(np.float32)
        t3 = (rng.randn(17) * 0.1).astype(np.float32)
        x = rng.randn(4096).astype(np.float32)

        def build():
            g = Graph()
            pin = g.add_input(Port(jnp.float32))
            pout = g.add_output(Port(jnp.float32))
            g.connect(pin, FirFilter(1, t1, "fff"), FirFilter(1, t2, "fff"),
                      FirFilter(2, t3, "fff"), pout)
            return g

        plain = StreamExecutor(build(), chunk_size=1024)
        fused = StreamExecutor(build(), chunk_size=1024, fuse_firs=True)
        assert len(fused.flat.blocks) == 1  # one composed FirFilter
        assert fused.flat.blocks[0].decim == 2
        assert fused.flat.blocks[0].history == 63 + 33 + 17 - 2
        y0 = np.asarray(plain.run(x))
        y1 = np.asarray(fused.run(x))
        assert y0.shape == y1.shape
        scale = max(np.abs(y0).max(), 1e-9)
        assert np.abs(y0 - y1).max() / scale < 1e-5
