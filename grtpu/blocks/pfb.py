"""Polyphase filterbank blocks + PFB clock sync.

Analogs: gr_pfb_channelizer_ccf, gr_pfb_synthesis_filterbank_ccf,
gr_pfb_arb_resampler_{ccf,fff}, gr_pfb_decimator_ccf, gr_pfb_interpolator_ccf,
gr_pfb_clock_sync_{ccf,fff} (SURVEY.md §2.3), and the blks2impl wrappers
(pfb_channelizer.py, pfb_arb_resampler.py, ...).
"""

from __future__ import annotations

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port
from grtpu.ops import pfb as pfb_ops
from grtpu.ops.fir import fir_filter, interp_fir_filter
from grtpu.ops import dsp

_HI = jax.lax.Precision.HIGHEST


class PfbChannelizer(Block):
    """gr_pfb_channelizer_ccf: stream in -> (nchan,)-vector stream out at
    rate oversample*fs/nchan.  Channel c centered at +c*fs/nchan."""

    def __init__(self, nchan: int, taps=None, oversample: int = 1,
                 taps_per_branch: int = 12, precision: str = "f32",
                 name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64, nchan),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.decim = nchan // oversample
        self.history = kp * nchan + 1
        super().__init__(name)
        self.nchan = nchan
        self.oversample = oversample
        self.precision = precision  # "f32" exact / "bf16x3" ~107dB / "bf16"

    def apply(self, state, x):
        # history = kp*nchan + 1 => executor delivers exactly kp*nchan
        # context samples, the channelizer's required history
        return state, pfb_ops.channelize(x, self.taps, self.nchan,
                                         self.oversample,
                                         precision=self.precision)


class PfbSynthesizer(Block):
    """gr_pfb_synthesis_filterbank_ccf: (nchan,)-vector stream -> stream."""

    def __init__(self, nchan: int, taps=None, taps_per_branch: int = 12,
                 name=None):
        self.in_ports = (Port(jnp.complex64, nchan),)
        self.out_ports = (Port(jnp.complex64),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.interp = nchan
        self.history = kp
        super().__init__(name)
        self.nchan = nchan

    def apply(self, state, x):
        return state, pfb_ops.synthesize(x, self.taps)


class PfbArbResampler(Block):
    """gr_pfb_arb_resampler_{ccf,fff}: rational-approximated arbitrary rate.

    rate is snapped to a Fraction (denominator <= 4096); the executor's
    chunking stays static and sample-exact at that rational rate.
    """

    def __init__(self, rate: float, taps=None, filter_size: int = 32,
                 dtype=jnp.complex64, name=None):
        fr = Fraction(rate).limit_denominator(4096)
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.interp = fr.numerator
        self.decim = fr.denominator
        if taps is None:
            taps = pfb_ops.design_arb_resampler_taps(float(fr), filter_size)
        self.taps = np.asarray(taps, np.float32)
        self.filter_size = filter_size
        kp = -(-len(self.taps) // filter_size)
        self.history = kp
        super().__init__(name)
        self.rate = fr

    def apply(self, state, x):
        return state, pfb_ops.arb_resample(x, self.taps, self.rate,
                                           self.filter_size)


class PfbDecimator(Block):
    """gr_pfb_decimator_ccf: channelizer collapsed to one selected channel
    (band-select decimation by nchan)."""

    def __init__(self, nchan: int, channel: int = 0, taps=None,
                 taps_per_branch: int = 12, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        if taps is None:
            taps = pfb_ops.design_channelizer_taps(nchan, taps_per_branch)
        self.taps = np.asarray(taps, np.float32)
        kp = -(-len(self.taps) // nchan)
        self.decim = nchan
        self.history = kp * nchan + 1
        super().__init__(name)
        self.nchan = nchan
        self.channel = channel

    def apply(self, state, x):
        y = pfb_ops.channelize(x, self.taps, self.nchan, 1)
        return state, y[:, self.channel]


class PfbInterpolator(Block):
    """gr_pfb_interpolator_ccf: polyphase interpolation by L."""

    def __init__(self, interp: int, taps=None, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        self.interp = interp
        if taps is None:
            from grtpu.utils import firdes

            taps = firdes.low_pass(interp, interp, 0.45, 0.1)
        self.taps = np.asarray(taps, np.float32)
        self.history = -(-len(self.taps) // interp)
        super().__init__(name)

    def apply(self, state, x):
        return state, interp_fir_filter(x, self.taps, self.interp)


# --------------------------------------------------------------- clock sync
def pfb_clock_sync(x: jnp.ndarray, state, sps: float, taps: np.ndarray,
                   nfilts: int, loop_bw: float, max_dev: float = 1.5,
                   gains=None, with_diag: bool = False):
    """gr_pfb_clock_sync_ccf: timing recovery selecting among nfilts
    phase-shifted matched filters, 2nd-order loop on (d_k, d_rate).

    The matched-filter bank is the prototype split into nfilts phases; the
    timing error is Re(out_deriv * conj(out)) (the reference's error), fed
    to a proportional-plus-integrator loop on the filter index.

    x: samples with kp-1+ceil(sps) lookahead/history slack.
    state: (k, rate_f, base) — filter phase, rate deviation, sample pointer.
    Returns (y_padded, n_valid, state').
    """
    proto = np.asarray(taps)
    bank = pfb_ops.polyphase_taps(proto, nfilts)[:, ::-1].copy()  # conv orient
    dproto = np.empty_like(proto)
    dproto[:-1] = proto[1:] - proto[:-1]
    dproto[-1] = 0
    dbank = pfb_ops.polyphase_taps(dproto, nfilts)[:, ::-1].copy()
    kp = bank.shape[1]
    bj, dj = jnp.asarray(bank), jnp.asarray(dbank)
    n_in = x.shape[0]
    # the reference's 3.5 API takes (alpha, beta) directly; later versions
    # derive them from a loop bandwidth (gri_control_loop) -- accept both
    alpha, beta = gains if gains is not None else \
        dsp.control_loop_gains(loop_bw)
    max_out = int(np.ceil(n_in / (sps * 0.95)))

    def f(carry, _):
        k, rate_f, base = carry
        ip = jnp.floor(base).astype(jnp.int32)
        win = jax.lax.dynamic_slice_in_dim(
            x, jnp.clip(ip, 0, n_in - kp), kp)
        ki = jnp.clip(jnp.round(k).astype(jnp.int32), 0, nfilts - 1)
        out = (win * bj[ki]).sum()
        dout = (win * dj[ki]).sum()
        err = jnp.clip((dout * jnp.conj(out)).real, -1.0, 1.0)
        rate_f2 = jnp.clip(rate_f + beta * err, -max_dev, max_dev)
        k2 = k + rate_f2 + alpha * err
        # wrap filter index into [0, nfilts), carrying overflow into base
        shift = jnp.floor(k2 / nfilts)
        k3 = k2 - shift * nfilts
        base2 = base + sps + shift
        valid = base2 + kp <= n_in
        newc = (k3, rate_f2, base2)
        outc = jax.tree_util.tree_map(
            lambda a, b: jnp.where(valid, a, b), newc, carry)
        return outc, (out.astype(x.dtype), valid,
                      err.astype(jnp.float32), rate_f2.astype(jnp.float32),
                      k3.astype(jnp.float32))

    carry, (ys, valids, errs, rates, ks) = jax.lax.scan(
        f, state, None, length=max_out)
    n_valid = valids.sum().astype(jnp.int32)
    if with_diag:
        # the reference block's optional outputs 1..3 (err, rate, phase)
        return (ys, errs, rates, ks), n_valid, carry
    return ys, n_valid, carry


def pfb_clock_sync_init(nfilts: int):
    return (jnp.asarray(nfilts / 2.0, jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32))


class PfbClockSync(Block):
    """gr_pfb_clock_sync_ccf as a first-class variable-rate graph block.

    Returns ``(y_padded, n_valid)`` with the valid symbols a contiguous
    prefix; the executor compacts them through a carried device FIFO
    (StreamExecutor variable-rate machinery).  Chunk-boundary exactness:
    the carried sample pointer freezes at the last *emitted* symbol's next
    position, which can trail the chunk boundary by up to kp + sps + 1
    samples — ``history`` covers that span so the deferred window stays
    readable after rebasing, and the scan's freeze-at-invalid semantics
    recompute the deferred symbol from identical state on the next chunk.
    Chunked graph execution is therefore sample-identical to one
    full-stream run (tested in tests/test_vr_graph.py).  Matches
    gr_pfb_clock_sync_ccf general_work's variable consume (SURVEY.md §2.3)."""

    variable_rate = True

    def __init__(self, sps: float, loop_bw: float, taps, nfilts: int = 32,
                 max_dev: float = 1.5, gains=None, init_phase=None,
                 diag: bool = False, name=None):
        self.in_ports = (Port(jnp.complex64),)
        # diag adds the reference's optional err/rate/phase symbol-rate
        # outputs (gr_pfb_clock_sync_ccf ports 1..3)
        self.out_ports = ((Port(jnp.complex64),)
                          + ((Port(jnp.float32),) * 3 if diag else ()))
        self.diag = diag
        self.taps = np.asarray(taps)
        kp = -(-len(self.taps) // nfilts)
        self.history = kp + int(np.ceil(sps)) + 2
        super().__init__(name)
        self.sps, self.loop_bw = float(sps), float(loop_bw)
        self.nfilts, self.max_dev = int(nfilts), float(max_dev)
        self.gains = gains
        self.init_phase = nfilts / 2.0 if init_phase is None else init_phase

    @property
    def nominal_rate(self):
        return 1.0 / self.sps

    def max_out_for(self, n_delivered: int) -> int:
        return int(np.ceil(n_delivered / (self.sps * 0.95)))

    def init_state(self):
        return (jnp.asarray(self.init_phase, jnp.float32),
                jnp.zeros((), jnp.float32),
                jnp.zeros((), jnp.float32))

    def apply(self, state, x):
        ys, n_valid, st = pfb_clock_sync(
            x, state, self.sps, self.taps, self.nfilts, self.loop_bw,
            self.max_dev, self.gains, with_diag=self.diag)
        # rebase the sample pointer against the fresh items consumed; the
        # history halo keeps the deferred window readable next chunk
        k, rate_f, base = st
        st = (k, rate_f, base - (x.shape[0] - (self.history - 1)))
        return st, (ys, n_valid)


def pfb_clock_sync_windowed(x: jnp.ndarray, state, sps: float,
                            taps: np.ndarray, nfilts: int, loop_bw: float,
                            max_dev: float = 1.5, W: int = 32):
    """Fixed-rate, gather-free pfb_clock_sync at integer OR fractional sps
    (float sps is the reference contract, gr_pfb_clock_sync_ccf.cc).

    Same recursion as pfb_clock_sync, but the per-symbol dynamic_slice into
    the chunk and the bank[ki] row gather (gathers inside a scan) are
    replaced by static-stride
    per-symbol rows plus in-row / in-bank one-hot selects.  Rows follow the
    floor grid I_t = floor(t*sps) (loops._window_rows); since the exact
    loop's pointer is base_t = t*sps + R_t with R_t the integer sum of
    filter-phase wrap slips, floor(base_t) - I_t == R_t exactly, so the
    integer drift rides the state unchanged (clipped at +-W).

    x: ~(T-1)*sps + L samples with L = ceil(sps) + 2W + kp (W leading
    history).  state: (k, rate_f, rel).  Returns ((T,) symbols, new state).
    """
    from grtpu.digital.loops import _window_rows

    proto = np.asarray(taps)
    bank = pfb_ops.polyphase_taps(proto, nfilts)[:, ::-1].copy()
    dproto = np.empty_like(proto)
    dproto[:-1] = proto[1:] - proto[:-1]
    dproto[-1] = 0
    dbank = pfb_ops.polyphase_taps(dproto, nfilts)[:, ::-1].copy()
    kp = bank.shape[1]
    bj, dj = jnp.asarray(bank), jnp.asarray(dbank)
    rows, _, T, L = _window_rows(x, sps, W, kp)
    alpha, beta = dsp.control_loop_gains(loop_bw)
    npos = L - kp + 1
    pos_iota = jnp.arange(npos)
    nf_iota = jnp.arange(nfilts)

    def f(carry, row):
        k, rate_f, rel = carry
        p = jnp.round(rel).astype(jnp.int32) + W
        oh = (pos_iota == p).astype(row.dtype)
        win = jnp.stack([(oh * jax.lax.dynamic_slice_in_dim(row, j, npos)
                          ).sum() for j in range(kp)])
        ki = jnp.clip(jnp.round(k).astype(jnp.int32), 0, nfilts - 1)
        koh = (nf_iota == ki).astype(jnp.float32)
        out = (win * jnp.dot(koh, bj, precision=_HI)).sum()
        dout = (win * jnp.dot(koh, dj, precision=_HI)).sum()
        err = jnp.clip((dout * jnp.conj(out)).real, -1.0, 1.0)
        rate_f2 = jnp.clip(rate_f + beta * err, -max_dev, max_dev)
        k2 = k + rate_f2 + alpha * err
        shift = jnp.floor(k2 / nfilts)
        k3 = k2 - shift * nfilts
        rel2 = jnp.clip(rel + shift, float(-W + 1), float(W - 1))
        return (k3, rate_f2, rel2), out.astype(x.dtype)

    # unroll=16: per-symbol steps are tiny, iteration overhead dominates
    # (same trick as the windowed M&M in digital/loops.py)
    new_state, ys = jax.lax.scan(f, state, rows, unroll=16)
    return ys, new_state


def pfb_clock_sync_windowed_init(nfilts: int):
    return (jnp.asarray(nfilts / 2.0, jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32))


def pfb_clock_sync_chunked(x: jnp.ndarray, state, sps: float,
                           taps: np.ndarray, nfilts: int, loop_bw: float,
                           max_dev: float = 1.5, W: int = 32,
                           chunk: int = 64):
    """Chunk-batched pfb_clock_sync with pfb_clock_sync_windowed's loop
    semantics (same state, same floor-grid rows).

    Reformulation of the per-symbol scan, which is op-latency bound in
    vmapped banks.  Per chunk of Lc symbols:

      1. predict the filter-phase trajectory from the carry with the
         errors zeroed — k_t = k0 + t*rate is exact up to the intra-chunk
         alpha*err corrections, which the loop itself absorbs next chunk;
      2. batch-extract the Lc windows (one-hot position selects over the
         row matrix) and batch the matched + derivative filter dots as
         (Lc, nfilts) @ (nfilts, kp) one-hot bank matmuls;
      3. compute all Lc timing errors at once and close the loop
         trajectory in cumsum form (rate_t = clip(rate0 + beta cumsum e),
         k unwrapped by cumsum, bank wraps by floor) for the carry.

    Validated against the exact windowed scan at BER level (the two track
    the same timing trajectory within the loop's noise; see
    tests/test_digital.py chunked-parity tests).

    x layout identical to pfb_clock_sync_windowed.  Returns ((T,)
    symbols, state') with T truncated to a multiple of ``chunk``.

    Unlike the windowed scan this does NOT materialize the (T, L) row
    matrix (at sps=2 that is ~44x data duplication in HBM — the first
    chunked cut was row-bound at 39 Msps aggregate); each chunk slices
    its span of x directly and the one-hot select covers the combined
    floor-grid + loop offset.
    """
    from grtpu.digital.loops import rationalize_sps

    proto = np.asarray(taps)
    bank = pfb_ops.polyphase_taps(proto, nfilts)[:, ::-1].copy()
    dproto = np.empty_like(proto)
    dproto[:-1] = proto[1:] - proto[:-1]
    dproto[-1] = 0
    dbank = pfb_ops.polyphase_taps(dproto, nfilts)[:, ::-1].copy()
    kp = bank.shape[1]
    bj, dj = jnp.asarray(bank), jnp.asarray(dbank)
    P, Q = rationalize_sps(sps)
    dmax = -(-P // Q)
    L = dmax + 2 * W + kp
    T = ((x.shape[0] - L) * Q) // P + 1
    Tc = (T // chunk) * chunk
    nspan = (chunk * P) // Q + L                   # chunk's input span
    npos = nspan - kp + 1
    alpha, beta = dsp.control_loop_gains(loop_bw)
    pos_iota = jnp.arange(npos)
    nf_iota = jnp.arange(nfilts)
    t_iota = jnp.arange(chunk, dtype=jnp.float32)
    t_iota_i = jnp.arange(chunk)

    def f(carry, t0):
        k, rate_f, rel = carry
        # 1. err-free trajectory predictions from the carry
        ku = k + t_iota * rate_f                       # unwrapped
        shift = jnp.floor(ku / nfilts)
        ki = jnp.clip(jnp.round(ku - shift * nfilts).astype(jnp.int32),
                      0, nfilts - 1)
        rel_t = jnp.clip(rel + shift, float(-W + 1), float(W - 1))
        p = jnp.round(rel_t).astype(jnp.int32) + W     # (Lc,)
        # 2. batched window extraction straight from x: symbol t's window
        # starts at I_t + p_t with I_t = floor(t*P/Q) on the floor grid
        I = ((t0 + t_iota_i) * P) // Q
        region = jax.lax.dynamic_slice_in_dim(x, I[0], nspan)
        o = (I - I[0]).astype(jnp.int32) + p
        oh = (pos_iota[None, :] == o[:, None]).astype(jnp.bfloat16)
        # window extraction as ONE (Lc, npos) @ (npos, kp) one-hot matmul
        # per real plane — one matmul instead of kp masked reductions
        # (the masked form was VPU-FLOP bound at ~195 Msps aggregate).
        # bf16: the 0/1 selection is exact; value rounding is ~48 dB,
        # far below the timing loop's own noise and the chain SNR.
        R = jnp.stack([region[j: j + npos] for j in range(kp)], axis=1)

        def mm(a, b):
            return jax.lax.dot_general(
                a, b.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)

        win = mm(oh, jnp.real(R)) + 1j * mm(oh, jnp.imag(R))  # (Lc, kp)
        koh = (nf_iota[None, :] == ki[:, None]).astype(jnp.bfloat16)
        outs = (win * mm(koh, bj)).sum(-1)
        douts = (win * mm(koh, dj)).sum(-1)
        errs = jnp.clip((douts * jnp.conj(outs)).real, -1.0, 1.0)
        # 3. closed-form loop trajectory for the carry
        rate_traj = jnp.clip(rate_f + beta * jnp.cumsum(errs),
                             -max_dev, max_dev)
        ku2 = k + jnp.cumsum(rate_traj + alpha * errs)
        shift2 = jnp.floor(ku2 / nfilts)
        k_new = ku2[-1] - shift2[-1] * nfilts
        rel_new = jnp.clip(rel + shift2[-1], float(-W + 1), float(W - 1))
        return (k_new, rate_traj[-1], rel_new), outs.astype(x.dtype)

    new_state, ys = jax.lax.scan(
        f, state, jnp.arange(Tc // chunk, dtype=jnp.int32) * chunk)
    return ys.reshape(-1), new_state
