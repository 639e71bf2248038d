"""Generic modulator / demodulator — the generic_mod_demod.py parity path.

Analogs (gr-digital/python/generic_mod_demod.py):
  * generic_mod (:76-150): bits -> gray-mapped constellation symbols ->
    (differential encode) -> RRC pulse shaping.
  * generic_demod (:268-313): agc2 -> fll_band_edge -> pfb_clock_sync ->
    constellation receiver -> (differential decode) -> unmap -> bits.

This is the reference's exact receive composition (the PskModem in
grtpu.digital.modems is the lighter costas+M&M variant).  Burst-mode
functions like the other modems.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.blocks.pfb import (pfb_clock_sync_windowed,
                              pfb_clock_sync_windowed_init)
from grtpu.digital import loops
from grtpu.digital.constellation import Constellation, psk_constellation
from grtpu.ops.fir import interp_fir_filter
from grtpu.utils import firdes


class GenericModem:
    """generic_mod + generic_demod with the reference's block chain."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: int = 4, excess_bw: float = 0.35,
                 freq_bw: float = 0.035, timing_bw: float = 0.045,
                 phase_bw: float = 0.06, nfilts: int = 32,
                 differential: bool = True, chunked: bool = False,
                 chunk: int = 64):
        """``chunked=True`` selects the chunk-batched AGC/FLL/clock-sync
        formulations (loops.agc2_chunked / fll_band_edge_chunked /
        pfb.pfb_clock_sync_chunked): same loop semantics recovered in
        closed form per chunk, for vmapped banks (the per-sample scans
        are op-latency bound).  BER-parity with the
        exact scans is test-enforced."""
        self.chunked = bool(chunked)
        self.chunk = int(chunk)
        self.m = m
        self.k = int(np.log2(m))
        self.sps = samples_per_symbol
        if constellation is None:
            constellation = psk_constellation(m)
            if m > 2:
                rot = np.exp(1j * np.pi / m).astype(np.complex64)
                constellation.points = (constellation.points * rot).astype(
                    np.complex64)
        self.constellation = constellation
        self.differential = differential
        self.excess_bw = excess_bw
        self.freq_bw, self.timing_bw, self.phase_bw = (freq_bw, timing_bw,
                                                       phase_bw)
        self.nfilts = nfilts
        # fractional sps is the reference contract (generic_mod_demod.py:94
        # "samples per baud >= 2", float): the modulator's RRC shaping runs
        # as a pfb_arb_resampler at rate sps (reference :140), the receiver
        # clock sync on the fractional floor grid (pfb_clock_sync_windowed)
        from grtpu.digital.loops import rationalize_sps
        self._spsP, self._spsQ = rationalize_sps(samples_per_symbol)
        if self._spsQ == 1:
            ntaps = 11 * int(samples_per_symbol)
            self.rrc = firdes.root_raised_cosine(
                int(samples_per_symbol), int(samples_per_symbol), 1.0,
                excess_bw, ntaps)
        else:
            # arb-resampler prototype at the bank's internal rate
            # (reference generic_mod :133-140)
            self.rrc = firdes.root_raised_cosine(
                nfilts, nfilts, 1.0, excess_bw, 11 * nfilts)
        # matched-filter bank for pfb_clock_sync at nfilts phases
        self.mf_bank = firdes.root_raised_cosine(
            nfilts, nfilts * samples_per_symbol, 1.0, excess_bw,
            int(round(11 * samples_per_symbol)) * nfilts)
        gray = [i ^ (i >> 1) for i in range(m)]
        self.gray_map = np.asarray(gray, np.int32)
        inv = np.zeros(m, np.int32)
        for i, g in enumerate(gray):
            inv[g] = i
        self.ungray_map = inv
        # device compute is jitted (per input shape): one fused XLA program
        # per direction
        self._mod_jit = jax.jit(self._mod_dev)
        self._demod_jit = jax.jit(self._demod_dev)

    # ----------------------------------------------------------------- mod
    def modulate(self, bits: np.ndarray) -> jnp.ndarray:
        bits = np.asarray(bits, np.uint8)
        grp = bits[: len(bits) - len(bits) % self.k].reshape(-1, self.k)
        syms = (grp @ (1 << np.arange(self.k - 1, -1, -1))).astype(np.int32)
        g = self.gray_map[syms]
        if self.differential:
            p = np.cumsum(g) % self.m
        else:
            p = g
        cpx = np.asarray(self.constellation.points)[p]
        return self._mod_jit(jnp.asarray(cpx, jnp.complex64))

    def _mod_dev(self, cpx):
        if self._spsQ == 1:
            kp = -(-len(self.rrc) // int(self.sps))
            xh = jnp.pad(cpx, (kp - 1, 0))
            return interp_fir_filter(xh, jnp.asarray(self.rrc),
                                     int(self.sps))
        # fractional sps: RRC pulse shaping as an arbitrary resampler at
        # rate sps (gr.pfb_arb_resampler_ccf, reference generic_mod :140)
        from fractions import Fraction
        from grtpu.ops import pfb as pfb_ops
        rate = Fraction(self._spsP, self._spsQ)
        kp = -(-len(self.rrc) // self.nfilts)
        pad_syms = (-cpx.shape[0]) % self._spsQ  # n*rate must be integral
        xh = jnp.pad(cpx, (kp - 1, pad_syms))
        # self.rrc already carries gain nfilts — the bank normalization
        # the polyphase split divides back out (reference design)
        y = pfb_ops.arb_resample(xh, self.rrc, rate, self.nfilts)
        # emit exactly floor(n*sps) samples, like the reference resampler's
        # accumulator — the Q-alignment pad symbols are an internal detail
        return y[: (cpx.shape[0] * self._spsP) // self._spsQ]

    # --------------------------------------------------------------- demod
    def demodulate(self, x) -> np.ndarray:
        """agc2 -> fll_band_edge -> pfb_clock_sync -> constellation
        receiver -> diff decode -> ungray -> bits."""
        return self._demodulate(x)[0]

    def demodulate_diag(self, x):
        """demodulate + receiver diagnostics (the bert_rx probe points:
        recovered symbol samples for the SNR probe, FLL frequency for
        frequency_offset(), clock-sync rate for timing_offset(); see
        gr-digital/examples/narrowband/digital_bert_rx.py:75-97)."""
        return self._demodulate(x)

    def _demod_dev(self, x, upto: str = "all"):
        """Device half of the receive chain.  Returns f32-typed outputs
        only (symbol indices, re/im symbol samples, loop scalars) so host
        readback never touches non-f32 transfer paths.

        ``upto`` (static; bench ablation knob): "agc", "fll", "clock" stop
        the chain after that stage and return the stage output split into
        f32 re/im; "all" (default) runs the full receiver."""
        # agc2
        Lc = self.chunk
        if self.chunked:
            pad = (-x.shape[0]) % Lc
            xp = jnp.pad(x, (0, pad))
            xa, _ = loops.agc2_chunked(xp, 1.0 / self.sps, 1e-1, 1e-2,
                                       1.0, chunk=Lc)
            xa = xa[: x.shape[0]]
        else:
            def agc_scan(g, xi):
                y = xi * g
                err = 1.0 - jnp.abs(y)
                rate = jnp.where(err < 0, 1e-1, 1e-2)
                return g + rate * err, y

            _, xa = jax.lax.scan(agc_scan, jnp.float32(1.0 / self.sps), x)
        if upto == "agc":
            return jnp.real(xa), jnp.imag(xa)
        # fll band edge
        fsz = int(self.sps * 4)
        xh = jnp.concatenate([jnp.zeros(fsz - 1, jnp.complex64), xa])
        if self.chunked:
            pad = (-xa.shape[0]) % Lc
            xf, fll_state = loops.fll_band_edge_chunked(
                jnp.pad(xh, (0, pad)), loops.fll_init_state(),
                float(self.sps), self.excess_bw, fsz, self.freq_bw,
                chunk=Lc)
            xf = xf[: xa.shape[0]]
        else:
            xf, fll_state = loops.fll_band_edge(
                xh, loops.fll_init_state(), float(self.sps),
                self.excess_bw, fsz, self.freq_bw)
        if upto == "fll":
            return jnp.real(xf), jnp.imag(xf)
        # pfb clock sync on the matched-filter bank — windowed gather-free
        # form (fixed rate; see pfb_clock_sync_windowed)
        W = 32
        st = pfb_clock_sync_windowed_init(self.nfilts)
        kp = -(-len(self.mf_bank) // self.nfilts)
        L = -(-self._spsP // self._spsQ) + 2 * W + kp
        t_eff = max(int((xf.shape[0] - kp) // self.sps), 1)   # static
        n_valid = jnp.asarray(t_eff, jnp.int32)
        xw = jnp.concatenate([jnp.zeros(W, xf.dtype), xf,
                              jnp.zeros(L + self._spsP, xf.dtype)])
        if self.chunked:
            from grtpu.blocks.pfb import pfb_clock_sync_chunked
            # chunk 64 is the stability boundary: the err-free rate
            # prediction drifts ~beta*Lc^2/2 bank steps within a chunk
            # (acquisition errs ~ +-1), which must stay well under one
            # symbol position (nfilts=32) — Lc=256 measured no-lock
            ys, clk_state = pfb_clock_sync_chunked(
                xw, st, self.sps, self.mf_bank, self.nfilts,
                self.timing_bw, W=W, chunk=Lc)
            t_eff = min(t_eff, ys.shape[0])
            n_valid = jnp.asarray(t_eff, jnp.int32)
        else:
            ys, clk_state = pfb_clock_sync_windowed(
                xw, st, self.sps, self.mf_bank, self.nfilts,
                self.timing_bw, W=W)
        sym_samps = ys[:t_eff]
        if upto == "clock":
            return jnp.real(sym_samps), jnp.imag(sym_samps)
        # constellation receiver (phase loop + decisions)
        if self.chunked:
            # small chunk + 2 sweeps: the DD phase loop's alpha corrections
            # are large (alpha ~ 0.2), so intra-chunk prediction drift must
            # stay well under a decision sector (slips measured at rc>=16)
            rc = 8
            padn = (-t_eff) % rc
            syms, _, _ = loops.constellation_receiver_chunked(
                jnp.pad(sym_samps, (0, padn)), loops.costas_init_state(),
                self.constellation, self.phase_bw, chunk=rc, refine=2)
            syms = syms[:t_eff]
        else:
            syms, _, _ = loops.constellation_receiver(
                sym_samps, loops.costas_init_state(), self.constellation,
                self.phase_bw)
        return (syms.astype(jnp.float32), n_valid.astype(jnp.float32),
                jnp.real(sym_samps).astype(jnp.float32),
                jnp.imag(sym_samps).astype(jnp.float32),
                fll_state[1].astype(jnp.float32),
                clk_state[1].astype(jnp.float32))

    def _demodulate(self, x):
        x = jnp.asarray(x, jnp.complex64)
        syms_f, nv_f, sre, sim, freq, rate = self._demod_jit(x)
        nv = int(np.asarray(nv_f))
        dec = np.asarray(syms_f).astype(np.int32)[:nv]
        if self.differential:
            d = (dec - np.concatenate([[0], dec[:-1]])) % self.m
        else:
            d = dec
        out = self.ungray_map[d]
        bits = ((out[:, None] >> np.arange(self.k - 1, -1, -1)) & 1)
        diag = {
            # derotated symbol-rate samples (bert SNR probe tap point)
            "symbols": (np.asarray(sre)[:nv]
                        + 1j * np.asarray(sim)[:nv]).astype(np.complex64),
            # FLL loop frequency, radians/sample (freq_recov.get_frequency)
            "freq": float(np.asarray(freq)),
            # clock-sync rate deviation, filter-bank steps/symbol
            # (time_recov.get_clock_rate)
            "clock_rate": float(np.asarray(rate)),
        }
        return bits.reshape(-1).astype(np.uint8), diag


# ---------------------------------------------------------------------------
# Stream hier blocks: the reference's generic_mod/generic_demod are
# gr.hier_block2 chains (generic_mod_demod.py:76-150, :268-313).  With
# variable-rate blocks first-class in the executor, the full demod chain now
# composes from ordinary graph blocks too.
# ---------------------------------------------------------------------------
from grtpu.runtime.graph import HierBlock  # noqa: E402
from grtpu.runtime.block import Port  # noqa: E402


def _gray_maps(m):
    gray = np.asarray([i ^ (i >> 1) for i in range(m)], np.int32)
    inv = np.zeros(m, np.int32)
    for i, g in enumerate(gray):
        inv[g] = i
    return gray, inv


class GenericModBlock(HierBlock):
    """generic_mod as a stream hier block (generic_mod_demod.py:76-150):
    packed bytes -> unpack k bits/chunk -> gray map -> differential encode
    -> chunks_to_symbols -> RRC pulse shaping at sps."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: int = 4, excess_bw: float = 0.35,
                 differential: bool = True, gray_code: bool = True,
                 name=None):
        super().__init__(name)
        from grtpu.blocks.gengen import (ChunksToSymbols, MapBB,
                                         PackedToUnpacked)
        from grtpu.blocks.filter import InterpFirFilter
        from grtpu.digital.blocks import DiffEncoder

        k = int(np.log2(m))
        sps = int(samples_per_symbol)
        if constellation is None:
            constellation = psk_constellation(m)
            if m > 2:
                rot = np.exp(1j * np.pi / m).astype(np.complex64)
                constellation.points = (constellation.points * rot).astype(
                    np.complex64)
        pts = np.asarray(constellation.points)
        rrc = firdes.root_raised_cosine(sps, sps, 1.0, excess_bw, 11 * sps)
        g = self.graph
        pin = g.add_input(Port(jnp.uint8))
        pout = g.add_output(Port(jnp.complex64))
        chain = [PackedToUnpacked(k)]
        if gray_code:
            gray, _ = _gray_maps(m)
            chain.append(MapBB(gray))
        if differential:
            chain.append(DiffEncoder(m))
        chain.append(ChunksToSymbols(pts, in_dtype=jnp.uint8,
                                     out_dtype=jnp.complex64))
        chain.append(InterpFirFilter(sps, rrc, "ccf"))
        g.connect(pin, *chain, pout)
        self.constellation = constellation


class GenericDemodBlock(HierBlock):
    """generic_demod as a stream hier block (generic_mod_demod.py:268-313):
    agc2 -> fll_band_edge -> pfb_clock_sync (variable-rate, first-class) ->
    constellation_receiver -> differential decode -> ungray -> unpack to
    bits.  The executor's FIFO emission machinery handles the clock-sync
    rate boundary."""

    def __init__(self, constellation: Constellation | None = None, m: int = 4,
                 samples_per_symbol: int = 4, excess_bw: float = 0.35,
                 freq_bw: float = 0.035, timing_bw: float = 0.045,
                 phase_bw: float = 0.06, nfilts: int = 32,
                 differential: bool = True, gray_code: bool = True,
                 name=None):
        super().__init__(name)
        from grtpu.blocks.analog import Agc2
        from grtpu.blocks.gengen import MapBB, UnpackKBits
        from grtpu.blocks.pfb import PfbClockSync
        from grtpu.digital.blocks import (ConstellationReceiver, DiffDecoder,
                                          FllBandEdge)

        k = int(np.log2(m))
        sps = int(samples_per_symbol)
        if constellation is None:
            constellation = psk_constellation(m)
            if m > 2:
                rot = np.exp(1j * np.pi / m).astype(np.complex64)
                constellation.points = (constellation.points * rot).astype(
                    np.complex64)
        mf_bank = firdes.root_raised_cosine(
            nfilts, nfilts * sps, 1.0, excess_bw, 11 * sps * nfilts)
        g = self.graph
        pin = g.add_input(Port(jnp.complex64))
        pout = g.add_output(Port(jnp.uint8))
        chain = [
            Agc2(attack_rate=1e-1, decay_rate=1e-2, reference=1.0,
                 gain=1.0 / sps),
            FllBandEdge(sps, excess_bw, sps * 4, freq_bw),
            PfbClockSync(sps, timing_bw, mf_bank, nfilts=nfilts),
            ConstellationReceiver(constellation, phase_bw),
        ]
        if differential:
            chain.append(DiffDecoder(m))
        if gray_code:
            _, ungray = _gray_maps(m)
            chain.append(MapBB(ungray))
        chain.append(UnpackKBits(k))
        g.connect(pin, *chain, pout)
        self.constellation = constellation


class GmskModBlock(HierBlock):
    """gmsk.py gmsk_mod (:108-120) as a stream hier block: packed bytes ->
    NRZ symbols -> Gaussian-filtered interpolation -> frequency modulator
    at h=0.5 (sensitivity pi/2 per symbol)."""

    def __init__(self, samples_per_symbol: int = 2, bt: float = 0.35,
                 name=None):
        super().__init__(name)
        from grtpu.blocks.analog import FrequencyModulator
        from grtpu.blocks.filter import InterpFirFilter
        from grtpu.digital.blocks import BytesToSyms

        sps = int(samples_per_symbol)
        ntaps = 4 * sps
        gauss = firdes.gaussian(1.0, sps, bt, ntaps)
        g = self.graph
        pin = g.add_input(Port(jnp.uint8))
        pout = g.add_output(Port(jnp.complex64))
        g.connect(pin, BytesToSyms(),
                  InterpFirFilter(sps, gauss, "fff"),
                  _F32ToC64FreqMod(sps), pout)
        self.sps = sps


class _F32ToC64FreqMod(HierBlock):
    """frequency_modulator_fc at GMSK sensitivity (pi/2)/sps."""

    def __init__(self, sps: int, name=None):
        super().__init__(name)
        from grtpu.blocks.analog import FrequencyModulator

        g = self.graph
        pin = g.add_input(Port(jnp.float32))
        pout = g.add_output(Port(jnp.complex64))
        g.connect(pin, FrequencyModulator((np.pi / 2.0) / sps), pout)


class GmskDemodBlock(HierBlock):
    """gmsk.py gmsk_demod (:227-245) as a stream hier block:
    quadrature_demod -> clock_recovery_mm_ff (first-class variable rate)
    -> binary_slicer.  Emits one bit byte per recovered symbol."""

    def __init__(self, samples_per_symbol: int = 2, gain_mu: float = 0.175,
                 mu: float = 0.5, omega_relative_limit: float = 0.005,
                 freq_error: float = 0.0, name=None):
        super().__init__(name)
        from grtpu.blocks.analog import QuadratureDemod
        from grtpu.digital.blocks import BinarySlicer, ClockRecoveryMMFF

        sps = int(samples_per_symbol)
        omega = sps * (1 + freq_error)
        gain_omega = 0.25 * gain_mu * gain_mu
        g = self.graph
        pin = g.add_input(Port(jnp.complex64))
        pout = g.add_output(Port(jnp.uint8))
        g.connect(pin, QuadratureDemod(1.0),
                  ClockRecoveryMMFF(omega, gain_omega, mu, gain_mu,
                                    omega_relative_limit),
                  BinarySlicer(), pout)
        self.sps = sps
