"""Numerics on the card (run there: python -m pytest -m gpu tests/).

A float32 matrix product with no precision may run in TF32 on an NVIDIA GPU,
which keeps 10 mantissa bits.  Every such product on a feedback or decoding
path is pinned to Precision.HIGHEST; these tests run those paths on the GPU
at the widths the chains use and compare them with a float64 reference or
with the same function on the CPU backend, where float32 products are exact.
The two deliberate bf16 one-hot products (the chunked M&M and the chunked
pfb clock sync) are compared with the exact loop forms.

Tolerances, and why:
  * GPU vs CPU through a feedback loop: 1e-3 of full scale.  The backends'
    float32 transcendentals differ by a few ulps and the loop integrates
    them; 1e-3 is far below every decision distance (>= 0.3 here), and a
    TF32 product (relative error ~5e-4 per product) drifts past it.  The
    M&M loop instead: median 1e-5 and every decision equal, since a ulp can
    move its interpolator to the neighbouring phase (a ~1e-2 step).
  * Integer and one-hot paths (Viterbi traceback, GSM unpack): exact.
  * FIR forms vs float64: the CPU suite's bounds (tests/test_fir.py TOL).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu

LOOP_TOL = 1e-3


def on_cpu(fn, *args):
    """``fn(*args)`` on the CPU backend, as host arrays."""
    with jax.default_device(jax.devices("cpu")[0]):
        out = fn(*[jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def on_gpu(gpu, fn, *args):
    with jax.default_device(gpu):
        out = fn(*[jnp.asarray(a) for a in args])
    assert all(a.devices() == {gpu} for a in jax.tree_util.tree_leaves(out))
    return jax.tree_util.tree_map(np.asarray, out)


def _qpsk(nsym, sps, seed, timing=1.0001):
    from grtpu.utils import firdes

    rng = np.random.default_rng(seed)
    syms = ((rng.integers(0, 2, nsym) * 2 - 1)
            + 1j * (rng.integers(0, 2, nsym) * 2 - 1)) / np.sqrt(2)
    up = np.zeros(nsym * sps, np.complex128)
    up[::sps] = syms
    x = np.convolve(up, firdes.root_raised_cosine(1.0, sps, 1.0, 0.35,
                                                  11 * sps), "same")
    t = np.arange(0, len(x) - 2, timing)
    fr = t % 1
    return ((1 - fr) * x[t.astype(int)] + fr * x[t.astype(int) + 1]
            ).astype(np.complex64)


def test_fll_chunked_matches_cpu(gpu):
    """loops.fll_band_edge_chunked: (chunk, K) @ (K,) band-edge products."""
    from grtpu.digital import loops

    sps, K = 2, 2 * 2 * 4 + 1
    x = _qpsk(1 << 14, sps, seed=1)
    x = x * np.exp(1j * 0.01 * np.arange(len(x))).astype(np.complex64)
    n = (len(x) - (K - 1)) // 64 * 64
    x = x[: n + K - 1]

    def f(xx):
        return loops.fll_band_edge_chunked(xx, loops.fll_init_state(), sps,
                                           0.35, K, 0.035)[0]

    got, ref = on_gpu(gpu, f, x), on_cpu(f, x)
    assert np.abs(got - ref).max() < LOOP_TOL


def test_mm_windowed_matches_cpu(gpu):
    """loops._mm_windowed: one-hot phase @ MMSE bank, per symbol."""
    from grtpu.digital import loops

    rng = np.random.RandomState(2)
    sps, W, T = 5, 32, 4096
    L = sps + 2 * W + loops.NTAPS
    syms = rng.choice([-1.0, 1.0], T + 8)
    x = np.repeat(syms, sps).astype(np.float32)[: (T - 1) * sps + L]
    x = (x + 0.1 * rng.randn(len(x))).astype(np.float32)
    st = loops.mm_windowed_init_state(float(sps), 0.5)

    def f(xx):
        return loops.clock_recovery_mm_ff_windowed(
            xx, st, sps, 0.25 * 0.175 ** 2, 0.175, W=W)[0]

    got, ref = on_gpu(gpu, f, x), on_cpu(f, x)
    d = np.abs(got - ref)
    # a ulp difference can move the loop to the neighbouring one of the
    # 128 interpolator phases (a step of ~1e-2 here), after which the two
    # trajectories differ by a fraction of a phase step until the loop
    # re-converges; TF32 in the bank product would instead offset the
    # typical symbol by ~1e-3
    assert np.median(d) < 1e-5, np.median(d)
    assert d.max() < 0.1, d.max()
    assert (np.sign(got) == np.sign(ref)).all()


def test_pfb_clock_sync_windowed_matches_cpu(gpu):
    """blocks.pfb.pfb_clock_sync_windowed: one-hot @ filter bank."""
    from grtpu.blocks.pfb import (pfb_clock_sync_windowed,
                                  pfb_clock_sync_windowed_init)
    from grtpu.utils import firdes

    sps, nfilts, W = 4, 32, 32
    taps = firdes.root_raised_cosine(nfilts, nfilts * sps, 1.0, 0.35,
                                     11 * sps * nfilts)
    x = np.concatenate([np.zeros(W, np.complex64), _qpsk(1024, sps, 3)])

    def f(xx):
        return pfb_clock_sync_windowed(xx, pfb_clock_sync_windowed_init(
            nfilts), sps, taps, nfilts, 0.06, W=W)[0]

    got, ref = on_gpu(gpu, f, x), on_cpu(f, x)
    assert np.abs(got - ref).max() < LOOP_TOL


def test_atsc_equalizer_training_matches_cpu(gpu):
    """atsc_rf LMS and DFE training sweeps and the DFE feedback filter."""
    from grtpu.models import atsc_rf as rf

    rng = np.random.RandomState(4)
    lv = np.arange(-7.0, 8.0, 2.0)
    d = lv[rng.randint(0, 8, rf.FS_TRAIN_LEN)].astype(np.float32)
    chan = np.array([1.0, 0.3, -0.1], np.float32)
    pad = np.concatenate([np.zeros(rf.EQ_NTAPS, np.float32), d])
    x_lms = (np.convolve(pad, chan)[: len(pad)]
             + 0.05 * rng.randn(len(pad))).astype(np.float32)
    x_lms = x_lms[: rf.FS_TRAIN_LEN + rf.EQ_NTAPS - 1]
    t0 = np.zeros(rf.EQ_NTAPS, np.float32)
    t0[rf.EQ_NTAPS // 2] = 1.0

    def lms(t, xx, dd):
        return rf._lms_train(t, xx, dd)

    got, ref = on_gpu(gpu, lms, t0, x_lms, d), on_cpu(lms, t0, x_lms, d)
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        assert np.abs(g - r).max() < LOOP_TOL * max(np.abs(r).max(), 1.0)

    x_ff = x_lms[: rf.FS_TRAIN_LEN + rf.DFE_NFF - 1]
    wff = np.zeros(rf.DFE_NFF, np.float32)
    wff[0] = 1.0
    wfb = np.zeros(rf.DFE_NFB, np.float32)

    def dfe(a, b, xx, dd):
        wf, wb = rf._dfe_train(a, b, xx, dd, np.float32(0.05))
        y = rf._dfe_filter(wf, wb, xx, jnp.zeros(rf.DFE_NFB, jnp.float32))
        return wf, wb, y

    got = on_gpu(gpu, dfe, wff, wfb, x_ff, d)
    ref = on_cpu(dfe, wff, wfb, x_ff, d)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() < LOOP_TOL * max(np.abs(r).max(), 1.0)


def test_iir_feedback_vs_float64(gpu):
    """ops.dsp.iir_filter's general feedback recursion (nfb > 2)."""
    from scipy.signal import lfilter

    from grtpu.ops import dsp

    b = np.array([0.2, 0.1, 0.05], np.float32)
    fb = np.array([1.0, 0.5, -0.2], np.float32)   # y += 0.5 y1 - 0.2 y2
    x = np.random.RandomState(5).randn(1 << 14).astype(np.float32)

    def f(xx):
        return dsp.iir_filter(xx, dsp.iir_init_state(3, 3), b, fb)[0]

    got = on_gpu(gpu, f, x)
    ref = lfilter(b.astype(np.float64), [1.0, -0.5, 0.2], x)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


def test_viterbi_traceback_exact(gpu):
    """fec.conv traceback: one-hot state @ predecessor matrix."""
    from grtpu.fec.conv import conv_encode_27, viterbi_decode_27

    rng = np.random.RandomState(6)
    bits = rng.randint(0, 2, 8192).astype(np.uint8)
    bits[-6:] = 0
    enc = np.asarray(conv_encode_27(jnp.asarray(bits))).astype(np.float32)
    soft = (enc * 2 - 1) + 0.4 * rng.randn(len(enc)).astype(np.float32)
    got = on_gpu(gpu, viterbi_decode_27, soft)
    np.testing.assert_array_equal(got, on_cpu(viterbi_decode_27, soft))
    assert (got != bits).mean() < 1e-3


def test_gsm_unpack_exact(gpu):
    """vocoder.gsm unpack: integer weights up to 2^7 per bit field."""
    from grtpu.vocoder import gsm

    rng = np.random.RandomState(7)
    frames = rng.randint(0, 256, (64, 50, 33)).astype(np.uint8)
    frames[..., 0] = (frames[..., 0] & 0x0F) | 0xD0       # GSM magic
    got = on_gpu(gpu, gsm.gsm_unpack, frames)
    bits = np.unpackbits(frames, axis=-1).astype(np.int64)
    ref = bits @ gsm._UNPACK_W.astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        on_gpu(gpu, gsm.gsm_pack, got), frames)


@pytest.mark.parametrize("form", ["toeplitz", "fft"])
def test_fir_forms_vs_float64(gpu, form):
    """ops.fir / ops.fft_filter at the WBFM decimating shape."""
    from grtpu.ops.fft_filter import fft_filter
    from grtpu.ops.fir import batch_fir_filter
    from grtpu.utils import firdes

    taps = firdes.low_pass(1.0, 256e3, 15e3, 4e3).astype(np.float32)
    k, d = len(taps), 8
    x = np.random.RandomState(8).randn(8, (1 << 16) + k - 1).astype(
        np.float32)
    if form == "toeplitz":
        f = lambda xx: batch_fir_filter(xx, jnp.asarray(taps), d)  # noqa
        tol = 2e-5
    else:
        f = jax.vmap(lambda r: fft_filter(r, jnp.asarray(taps), d))
        tol = 1e-4
    got = on_gpu(gpu, f, x)
    ref = np.stack([np.convolve(r.astype(np.float64), taps, "valid")[::d]
                    for r in x])
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol


def test_bf16x3_split_word_vs_float64(gpu):
    """ops.fir's split-word bf16x3 keeps ~16 mantissa bits on the card
    (the CPU suite's 1e-4 bound); a single bf16 pass would read ~3e-3."""
    from grtpu.ops import fir

    rng = np.random.RandomState(10)
    taps = (rng.randn(300) * 0.05).astype(np.float32)
    x = rng.randn(8, (1 << 14) + 299).astype(np.float32)
    prev = fir._PRECISION
    fir.set_precision("bf16x3")
    try:
        got = on_gpu(gpu, jax.jit(
            lambda xx: fir.batch_fir_filter(xx, jnp.asarray(taps))), x)
    finally:
        fir.set_precision(prev)
    ref = np.stack([np.convolve(r.astype(np.float64), taps, "valid")
                    for r in x])
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_channelizer_bf16x3_vs_f32(gpu):
    """ops.pfb.channelize's split-word mode against its HIGHEST mode."""
    from grtpu.ops.pfb import channelize, design_channelizer_taps

    N = 64
    proto = design_channelizer_taps(N, 12)
    kp = -(-len(proto) // N)
    rng = np.random.RandomState(11)
    x = (rng.randn((1 << 16) + kp * N)
         + 1j * rng.randn((1 << 16) + kp * N)).astype(np.complex64)
    hi = on_gpu(gpu, lambda a: channelize(a, proto, N, precision="f32"), x)
    b3 = on_gpu(gpu, lambda a: channelize(a, proto, N, precision="bf16x3"),
                x)
    err = np.sum(np.abs(b3 - hi) ** 2) / np.sum(np.abs(hi) ** 2)
    assert 10 * np.log10(1 / err) > 80.0


def test_mm_chunked_bf16_matches_exact_loop(gpu):
    """Chunked M&M (bf16 one-hot window products) vs the windowed loop:
    symbol decisions agree (the CPU suite's parity bound)."""
    from grtpu.digital import loops

    rng = np.random.RandomState(0)
    sps, gm, W = 4, 0.175, 32
    syms = rng.choice([-1.0, 1.0], 6000)
    x = np.repeat(syms, sps).astype(np.float32)[3:]
    L = sps + 2 * W + loops.NTAPS
    xp = np.concatenate([np.zeros(W, np.float32), x,
                         np.zeros(L + sps, np.float32)])
    st = loops.mm_windowed_init_state(float(sps), 0.5)
    go = 0.25 * gm * gm
    y_ref = on_gpu(gpu, lambda a: loops.clock_recovery_mm_ff_windowed(
        a, st, sps, go, gm, W=W)[0], xp)
    y_ck = on_gpu(gpu, lambda a: loops.clock_recovery_mm_ff_chunked(
        a, st, sps, go, gm, W=W, chunk=16)[0], xp)
    n = min(len(y_ref), len(y_ck)) - 8
    best = 0.0
    for lag in range(-3, 4):
        a = np.sign(y_ref[300:n])
        b = np.sign(y_ck[300 + lag: 300 + lag + len(a)])
        if len(b) == len(a):
            best = max(best, float((a == b).mean()))
    assert best > 0.999, best


def test_generic_qpsk_chunked_bf16_parity(gpu):
    """Chunked generic QPSK receiver (bf16 one-hot pfb clock sync) vs the
    exact chain on the card: BER at parity with the exact loops."""
    from grtpu.digital.generic_mod_demod import GenericModem
    from grtpu.digital.modems import awgn

    bits = np.random.RandomState(9).randint(0, 2, 8000).astype(np.uint8)
    gm_ex = GenericModem(m=4, samples_per_symbol=2)
    gm_ck = GenericModem(m=4, samples_per_symbol=2, chunked=True)

    def ber(got, settle=600):
        """BER minimized over the receiver's integer symbol delay."""
        got = np.asarray(got)
        best = 1.0
        for s in range(64):
            n = min(len(got) - s, len(bits)) - 32
            if n > settle:
                best = min(best, float(
                    (got[s + settle: s + n] != bits[settle:n]).mean()))
        return best

    with jax.default_device(gpu):
        tx = np.asarray(gm_ex.modulate(bits))
        clean = ber(gm_ck.demodulate(tx))
        noisy = awgn(tx * np.exp(1j * 0.004 * np.arange(len(tx))), 12.0,
                     seed=5)
        b_ex = ber(gm_ex.demodulate(noisy))
        b_ck = ber(gm_ck.demodulate(noisy))
    # the CPU backend reads 9.6e-4 clean and (2.7e-4, 3.0e-3) noisy on
    # this input: the chunked form's own error floor, not a precision one
    assert clean < 2e-3, clean
    assert b_ck < 0.02 and b_ck < max(b_ex * 8, 0.008), (b_ex, b_ck)
