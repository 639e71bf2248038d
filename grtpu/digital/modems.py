"""Modem models: burst-mode modulate/demodulate pipelines.

Analogs of the gr-digital python modem layer:
  * gmsk.py:108-120 (mod: NRZ syms -> gaussian interp FIR -> FM) and
    :227-245 (demod: quadrature_demod -> clock_recovery_mm_ff ->
    binary_slicer),
  * generic_mod_demod.py:76-150 / :268-313 (PSK: pack -> gray map ->
    diff-enc -> chunks2symbols -> RRC; demod: agc -> fll -> clock sync ->
    constellation receiver -> diff-dec -> unmap -> unpack),
  * the DMR 4FSK use case (BASELINE.json config #4): dibits -> 4FSK
    frequency pulse -> FM; demod: quadrature_demod -> matched filter ->
    M&M timing -> 4-level slicer.

Design: burst/packet processing as pure jitted functions (bits in, samples
out and back).  Variable-rate clock recovery returns (symbols, count) and the
host compacts — the mask-and-compact idiom (SURVEY.md §7).  These are the
BER-harness entry points (analog of benchmark_tx/rx).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.digital import loops
from grtpu.digital.constellation import (
    Constellation, constellation_bpsk, fsk4_symbols, psk_constellation,
)
from grtpu.ops import dsp
from grtpu.ops.fir import batch_fir_filter, fir_filter, interp_fir_filter
from grtpu.utils import firdes


def _bits_msb(data: np.ndarray, k: int = 1) -> np.ndarray:
    """bytes -> k-bit chunks, MSB first."""
    bits = np.unpackbits(np.asarray(data, np.uint8))
    if k == 1:
        return bits
    return bits.reshape(-1, k) @ (1 << np.arange(k - 1, -1, -1))


class GmskModem:
    """GMSK mod/demod (gmsk.py semantics)."""

    def __init__(self, samples_per_symbol: int = 2, bt: float = 0.35,
                 gain_mu: float = 0.175, mu: float = 0.5,
                 omega_relative_limit: float = 0.005,
                 chunked: bool = False):
        # chunked=True: chunk-batched M&M (clock_recovery_mm_ff_chunked,
        # ~2.5x in vmapped banks; decision-parity tested)
        self.chunked = bool(chunked)
        sps = samples_per_symbol
        self.sps = sps
        self.bt = bt
        ntaps = 4 * sps
        gauss = firdes.gaussian(1.0, sps, bt, ntaps)
        sqwave = np.ones(sps, np.float32) / 1.0
        self.taps = np.convolve(gauss, sqwave).astype(np.float32)
        self.sensitivity = (np.pi / 2.0) / sps
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu
        self.mu0 = mu
        self.omega_limit = omega_relative_limit
        # receive channel filter: pass the GMSK main lobe (~(1+bt)/2T),
        # reject out-of-band noise before the discriminator
        self.rx_lpf = firdes.low_pass(1.0, 1.0, 0.5 * (1 + bt) / sps,
                                      0.25 / sps)
        self._mod = jax.jit(self._mod_fn)
        self._demod = jax.jit(self._demod_fn)

    def _mod_fn(self, nrz):
        # interp FIR with gaussian*rect taps, then FM at pi/2 per symbol
        kp = -(-len(self.taps) // self.sps)
        xh = jnp.concatenate([jnp.zeros(kp - 1, jnp.float32), nrz])
        shaped = interp_fir_filter(xh, jnp.asarray(self.taps), self.sps)
        y, _ = dsp.frequency_modulator(shaped, jnp.float32(0.0),
                                       self.sensitivity)
        return y

    def modulate(self, data_bits: np.ndarray) -> jnp.ndarray:
        """bits (0/1) -> complex baseband at sps samples/bit."""
        nrz = jnp.asarray(np.asarray(data_bits, np.float32) * 2 - 1)
        return self._mod(nrz)

    def _demod_fn(self, x, mm_state):
        K = len(self.rx_lpf)
        xh = jnp.concatenate([jnp.zeros(K - 1, jnp.complex64), x])
        xf = fir_filter(xh, jnp.asarray(self.rx_lpf), 1)
        fm = dsp.quadrature_demod(
            jnp.concatenate([jnp.zeros(1, jnp.complex64), xf]), 1.0)
        # windowed gather-free M&M (loops.clock_recovery_mm_ff_windowed):
        # bit-exact recursion without per-symbol dynamic slices
        W = 32
        L = self.sps + 2 * W + loops.NTAPS
        n = fm.shape[0]
        t_eff = max((n - loops.NTAPS) // self.sps, 1)
        xw = jnp.concatenate([jnp.zeros(W, fm.dtype), fm,
                              jnp.zeros(L, fm.dtype)])
        mm_fn = (loops.clock_recovery_mm_ff_chunked if self.chunked
                 else loops.clock_recovery_mm_ff_windowed)
        ys, _ = mm_fn(xw, mm_state, self.sps, self.gain_omega,
                      self.gain_mu, self.omega_limit, W=W)
        t_eff = min(t_eff, int(ys.shape[0])) if self.chunked else t_eff
        return ys[:t_eff], jnp.asarray(t_eff, jnp.int32)

    def demodulate(self, x) -> np.ndarray:
        """complex baseband -> recovered bits."""
        st = loops.mm_windowed_init_state(float(self.sps), self.mu0)
        ys, n_valid = self._demod(jnp.asarray(x), st)
        ys = np.asarray(ys)[: int(n_valid)]
        return (ys > 0).astype(np.uint8)


class PskModem:
    """Differential M-PSK burst modem (generic_mod_demod.py semantics,
    costas+M&M receiver)."""

    def __init__(self, m: int = 2, samples_per_symbol: int = 4,
                 excess_bw: float = 0.35, costas_bw: float = 0.062,
                 gain_mu: float = 0.175, differential: bool = True,
                 chunked: bool = False):
        self.chunked = bool(chunked)
        self.m = m
        self.k = int(np.log2(m))
        self.sps = samples_per_symbol
        self.constellation = psk_constellation(m)
        if m > 2:
            # rotate to the order-M costas lock grid: the loop's phase
            # detector nulls with points at odd multiples of pi/M (e.g.
            # QPSK on the +-45 deg diagonals); axis-aligned points would sit
            # exactly between decision regions after lock
            rot = np.exp(1j * np.pi / m).astype(np.complex64)
            self.constellation.points = (
                self.constellation.points * rot).astype(np.complex64)
        ntaps = 11 * samples_per_symbol
        self.rrc = firdes.root_raised_cosine(
            samples_per_symbol, samples_per_symbol, 1.0, excess_bw, ntaps)
        self.rrc_rx = firdes.root_raised_cosine(
            1.0, samples_per_symbol, 1.0, excess_bw, ntaps)
        self.costas_bw = costas_bw
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu
        self.differential = differential
        gray = [i ^ (i >> 1) for i in range(m)]
        self.gray_map = np.asarray(gray, np.int32)          # symbol -> gray pt
        inv = np.zeros(m, np.int32)
        for i, g in enumerate(gray):
            inv[g] = i
        self.ungray_map = inv
        self._mod = jax.jit(self._mod_fn)
        self._demod = jax.jit(self._demod_fn)

    def _mod_fn(self, syms):
        pts = jnp.asarray(self.constellation.points)
        gm = jnp.asarray(self.gray_map)
        if self.differential:
            # phase-accumulate the GRAY-CODED symbol in point-index space:
            # p_k = p_{k-1} + gray(sym_k); the receiver's constant
            # rotational ambiguity then cancels in the index differences
            g = gm[syms.astype(jnp.int32)].astype(jnp.uint8)
            d, _ = loops.diff_encode(g, jnp.zeros((), jnp.uint8), self.m)
            cpx = pts[d.astype(jnp.int32)]
        else:
            cpx = pts[gm[syms.astype(jnp.int32)]]
        kp = -(-len(self.rrc) // self.sps)
        xh = jnp.concatenate([jnp.zeros(kp - 1, jnp.complex64), cpx])
        return interp_fir_filter(xh, jnp.asarray(self.rrc), self.sps)

    def modulate(self, bits: np.ndarray) -> jnp.ndarray:
        bits = np.asarray(bits, np.uint8)
        syms = bits if self.k == 1 else _bits_msb(
            np.packbits(bits), self.k)
        return self._mod(jnp.asarray(syms.astype(np.uint8)))

    def _demod_fn(self, x, mm_state, costas_state):
        # matched filter
        K = len(self.rrc_rx)
        xh = jnp.concatenate([jnp.zeros(K - 1, jnp.complex64), x])
        # normalize the tx(gain=sps) x rx(unit) cascade to unit symbols so
        # the loop gains see their nominal signal scale
        mf = fir_filter(xh, jnp.asarray(self.rrc_rx), 1) / self.sps
        # costas carrier recovery at sample rate (order m)
        derot, cst = loops.costas_loop(mf, costas_state, self.costas_bw,
                                       min(self.m, 8) if self.m in (2, 4, 8) else 4)
        # M&M timing recovery (complex), windowed gather-free form
        W = 32
        L = self.sps + 2 * W + loops.NTAPS
        n = derot.shape[0]
        t_eff = max((n - loops.NTAPS) // self.sps, 1)
        xw = jnp.concatenate([jnp.zeros(W, derot.dtype), derot,
                              jnp.zeros(L, derot.dtype)])
        if self.chunked:
            # complex path: RRC ISI + costas interplay needs the tighter
            # chunk (prediction drift must stay under half a symbol)
            ys, _ = loops.clock_recovery_mm_cc_chunked(
                xw, mm_state, self.sps, self.gain_omega, self.gain_mu,
                0.005, W=W, chunk=8)
        else:
            ys, _ = loops.clock_recovery_mm_cc_windowed(
                xw, mm_state, self.sps, self.gain_omega, self.gain_mu,
                0.005, W=W)
        t_eff = min(t_eff, int(ys.shape[0])) if self.chunked else t_eff
        return ys[:t_eff], jnp.asarray(t_eff, jnp.int32)

    def demodulate(self, x) -> np.ndarray:
        mm = loops.mm_windowed_init_state(float(self.sps), 0.5,
                                          complex_mode=True)
        cs = loops.costas_init_state()
        ys, n_valid = self._demod(jnp.asarray(x), mm, cs)
        sym_pts = np.asarray(ys)[: int(n_valid)]
        # hard decisions; differential decode in POINT-INDEX space (the
        # costas lock's constant rotation cancels in the differences),
        # then ungray the differences
        dec = np.asarray(self.constellation.decision_maker(jnp.asarray(sym_pts)))
        if self.differential:
            d = (dec - np.concatenate([[0], dec[:-1]])) % self.m
            syms = self.ungray_map[d]
        else:
            syms = self.ungray_map[dec]
        if self.k == 1:
            return syms.astype(np.uint8)
        bits = ((syms[:, None] >> np.arange(self.k - 1, -1, -1)) & 1)
        return bits.reshape(-1).astype(np.uint8)


class Fsk4Modem:
    """DMR-style 4FSK modem (BASELINE.json config #4).

    Dibits -> frequency levels (+-1, +-3) * h/3 -> RRC pulse shaping ->
    FM.  Demod: quadrature demod -> matched RRC -> M&M timing -> 4-level
    slicer.  DMR parameters: 4800 symbols/s, 1944 Hz max deviation.
    """

    def __init__(self, samples_per_symbol: int = 10,
                 symbol_rate: float = 4800.0, deviation: float = 1944.0,
                 gain_mu: float = 0.05, chunked: bool = False):
        self.chunked = bool(chunked)
        self.sps = samples_per_symbol
        self.fs = samples_per_symbol * symbol_rate
        self.deviation = deviation
        self.levels = fsk4_symbols(1.0)  # unit max level
        ntaps = 11 * samples_per_symbol
        self.shape_taps = firdes.root_raised_cosine(
            samples_per_symbol, samples_per_symbol, 1.0, 0.2, ntaps)
        self.rx_taps = firdes.root_raised_cosine(
            1.0, samples_per_symbol, 1.0, 0.2, ntaps)
        self.sensitivity = 2 * np.pi * deviation / self.fs
        self.gain_mu = gain_mu
        self.gain_omega = 0.25 * gain_mu * gain_mu
        self._mod = jax.jit(self._mod_fn)
        self._demod = jax.jit(self._demod_fn)

    def _mod_fn(self, levels):
        kp = -(-len(self.shape_taps) // self.sps)
        xh = jnp.concatenate([jnp.zeros(kp - 1, jnp.float32), levels])
        shaped = interp_fir_filter(xh, jnp.asarray(self.shape_taps), self.sps)
        y, _ = dsp.frequency_modulator(shaped, jnp.float32(0.0),
                                       self.sensitivity)
        return y

    def modulate(self, dibits: np.ndarray) -> jnp.ndarray:
        lv = jnp.asarray(self.levels)[jnp.asarray(dibits, jnp.int32)]
        return self._mod(lv)

    def _demod_fn(self, x, mm_state):
        fm = dsp.quadrature_demod(
            jnp.concatenate([jnp.zeros(1, jnp.complex64), x]),
            1.0 / self.sensitivity)  # recover frequency levels
        K = len(self.rx_taps)
        fmh = jnp.concatenate([jnp.zeros(K - 1, jnp.float32), fm])
        # tx pulse carries gain=sps (interp energy); normalize the cascade so
        # recovered symbol levels sit at the nominal +-1/3, +-1
        mf = fir_filter(fmh, jnp.asarray(self.rx_taps), 1) / self.sps
        W = 32
        L = self.sps + 2 * W + loops.NTAPS
        n = mf.shape[0]
        t_eff = max((n - loops.NTAPS) // self.sps, 1)
        xw = jnp.concatenate([jnp.zeros(W, mf.dtype), mf,
                              jnp.zeros(L, mf.dtype)])
        mm_fn = (loops.clock_recovery_mm_ff_chunked if self.chunked
                 else loops.clock_recovery_mm_ff_windowed)
        ys, _ = mm_fn(xw, mm_state, self.sps, self.gain_omega,
                      self.gain_mu, 0.005, W=W)
        t_eff = min(t_eff, int(ys.shape[0])) if self.chunked else t_eff
        return ys[:t_eff], jnp.asarray(t_eff, jnp.int32)

    def demodulate(self, x) -> np.ndarray:
        st = loops.mm_windowed_init_state(float(self.sps), 0.5)
        ys, n_valid = self._demod(jnp.asarray(x), st)
        v = np.asarray(ys)[: int(n_valid)]
        return self._slice(v)

    @staticmethod
    def _slice(v: np.ndarray) -> np.ndarray:
        # levels nominally +-1/3, +-1 (unit max): slice at 0 and +-2/3
        sym = np.where(v > 2 / 3, 0b01,
                       np.where(v > 0, 0b00,
                                np.where(v > -2 / 3, 0b10, 0b11)))
        return sym.astype(np.uint8)

    def demodulate_burst_bank(self, x) -> np.ndarray:
        """Demodulate a BANK of bursts on device: x (C, N) complex64 ->
        (C, n_sym) dibits.  The TDMA base-station path: every channel /
        slot demodulates in one jitted program (quad demod -> matched
        filter as a matmul -> vectorized eye-metric phase pick with a
        one-hot select — no gathers, no per-channel python).  Same
        open-loop algorithm as :meth:`demodulate_burst`."""
        if not hasattr(self, "_burst_bank"):
            self._burst_bank = jax.jit(self._burst_bank_fn)
        v = np.asarray(self._burst_bank(jnp.asarray(x)))
        return self._slice(v)

    def _burst_bank_fn(self, x):
        C, N = x.shape
        xh = jnp.concatenate([jnp.zeros((C, 1), jnp.complex64), x], axis=1)
        prod = xh[:, 1:] * jnp.conj(xh[:, :-1])
        fm = (1.0 / self.sensitivity) * jnp.arctan2(prod.imag, prod.real)
        K = len(self.rx_taps)
        fmh = jnp.concatenate([jnp.zeros((C, K - 1), jnp.float32), fm],
                              axis=1)
        mf = batch_fir_filter(fmh, jnp.asarray(self.rx_taps), 1) / self.sps
        # CFO appears as a DC shift of the levels; the median is a robust
        # estimator, so a <=8k-sample subsample suffices (a full-length
        # sort dominated the chain's runtime at long burst sizes)
        stride = max(1, N // 8192)
        med = jnp.median(mf[:, ::stride], axis=1, keepdims=True)
        mf = mf - med
        sps = self.sps
        n_sym = N // sps
        s = mf[:, : n_sym * sps].reshape(C, n_sym, sps)
        levels = jnp.asarray(np.array([-1.0, -1 / 3, 1 / 3, 1.0],
                                      np.float32))
        # sampling phase is constant over a burst: the eye metric over the
        # first <=1k symbols picks it as reliably as the whole burst
        # (>=1 so a single-symbol burst still yields a defined metric)
        n_eye = max(1, min(n_sym - 1, 1024))
        err = jnp.abs(s[:, :n_eye, :, None] - levels).min(-1).mean(1)
        best = jnp.argmin(err, axis=-1)                      # (C,)
        onehot = (jnp.arange(sps) == best[:, None]).astype(jnp.float32)
        return (s * onehot[:, None, :]).sum(-1)              # (C, n_sym)

    def demodulate_burst(self, x) -> np.ndarray:
        """Open-loop burst demod: matched filter, CFO (DC) removal, then
        pick the sampling phase minimizing the 4-level eye metric over the
        WHOLE burst — fully vectorized, no acquisition transient (the burst
        receiver a short TDMA slot needs; loop-based demodulate() suits
        continuous streams)."""
        x = jnp.asarray(x)
        fm = dsp.quadrature_demod(
            jnp.concatenate([jnp.zeros(1, jnp.complex64), x]),
            1.0 / self.sensitivity)
        K = len(self.rx_taps)
        fmh = jnp.concatenate([jnp.zeros(K - 1, jnp.float32), fm])
        mf = np.asarray(fir_filter(fmh, jnp.asarray(self.rx_taps), 1)) / self.sps
        mf = mf - np.median(mf)  # CFO appears as a DC shift of the levels
        sps = self.sps
        n_sym = len(mf) // sps
        levels = np.array([-1.0, -1 / 3, 1 / 3, 1.0])
        best = (np.inf, 0)
        for ph in range(sps):
            s = mf[ph: ph + n_sym * sps: sps][: n_sym - 1]
            err = np.abs(s[:, None] - levels[None, :]).min(axis=1).mean()
            if err < best[0]:
                best = (err, ph)
        v = mf[best[1]:: sps]
        return self._slice(v)


def awgn(x, snr_db: float, seed: int = 0, measure=None):
    """Complex AWGN at the given per-sample SNR (channel_model.py's noise)."""
    x = np.asarray(x)
    p = (np.abs(x) ** 2).mean() if measure is None else measure
    n0 = p / (10 ** (snr_db / 10))
    r = np.random.RandomState(seed)
    noise = (r.randn(len(x)) + 1j * r.randn(len(x))) * np.sqrt(n0 / 2)
    return (x + noise).astype(np.complex64)
