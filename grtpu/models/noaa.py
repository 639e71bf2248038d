"""NOAA HRPT receive components.

Analogs (gr-noaa, SURVEY.md §2.8): noaa_hrpt_pll_cf (carrier recovery for
the split-phase PM downlink), noaa_hrpt_deframer (frame sync on the 60-bit
sync word + minor-frame extraction), noaa_hrpt_decoder (10-bit word
unpacking).

HRPT: 665.4 kbit/s biphase; frames of 11090 10-bit words starting with the
fixed 6-word sync pattern.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port
from grtpu.ops import dsp

# The 60-bit HRPT minor-frame sync: 6 x 10-bit words (A/B standard pattern)
HRPT_SYNC_WORDS = (0x0284, 0x016F, 0x035C, 0x019D, 0x020F, 0x0095)
HRPT_MINOR_FRAME_WORDS = 11090
HRPT_BITS_PER_WORD = 10


def sync_bits() -> np.ndarray:
    bits = []
    for w in HRPT_SYNC_WORDS:
        bits.extend((w >> (9 - i)) & 1 for i in range(10))
    return np.array(bits, np.uint8)


class HrptPll(Block):
    """noaa_hrpt_pll_cf: PM carrier recovery emitting the baseband data
    that rides the phase.

    Exact loop semantics of noaa_hrpt_pll_cf.cc:60-83 — per sample the NCO
    is mixed out and the *imaginary* part emitted, the phase error is
    ``wrap(angle(x) - phase)``, the frequency integrator is clipped to
    ``±max_offset`` and the phase advanced by ``alpha*err + freq``."""

    def __init__(self, alpha: float = 0.01, beta: Optional[float] = None,
                 max_offset: float = 0.1, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.float32),)
        super().__init__(name)
        self.alpha = float(alpha)
        self.beta = float(beta) if beta is not None else self.alpha ** 2 / 4
        self.max_offset = float(max_offset)

    def init_state(self):
        return (jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))

    def apply(self, state, x):
        alpha, beta, moff = self.alpha, self.beta, self.max_offset

        def f(carry, xi):
            phase, freq = carry
            ref = jnp.exp(-1j * phase).astype(jnp.complex64)
            out = jnp.imag(xi * ref)
            err = dsp.phase_wrap(
                jnp.arctan2(jnp.imag(xi), jnp.real(xi)) - phase)
            freq = jnp.clip(freq + beta * err, -moff, moff)
            phase = dsp.phase_wrap(phase + alpha * err + freq)
            return (phase, freq), out

        return jax.lax.scan(f, state, x)


def deframe(bits: np.ndarray, max_errors: int = 4
            ) -> List[np.ndarray]:
    """noaa_hrpt_deframer: locate sync patterns, slice minor frames of
    11090 10-bit words.  Returns the list of complete frames (as word
    arrays)."""
    pat = sync_bits()
    b = np.asarray(bits, np.int8)
    if len(b) < len(pat):
        return []
    s = 2 * b.astype(np.int32) - 1
    c = 2 * pat.astype(np.int32) - 1
    corr = np.correlate(s, c, mode="valid")
    errs = (len(pat) - corr) // 2
    starts = np.nonzero(errs <= max_errors)[0]
    frames = []
    frame_bits = HRPT_MINOR_FRAME_WORDS * HRPT_BITS_PER_WORD
    last = -frame_bits
    for st in starts:
        if st < last + frame_bits:
            continue
        if st + frame_bits <= len(b):
            frames.append(decode_words(b[st: st + frame_bits]))
            last = st
    return frames


def decode_words(bits: np.ndarray) -> np.ndarray:
    """noaa_hrpt_decoder: MSB-first 10-bit word unpack."""
    b = np.asarray(bits, np.int64).reshape(-1, HRPT_BITS_PER_WORD)
    shifts = np.arange(9, -1, -1)
    return (b << shifts[None, :]).sum(axis=1).astype(np.int32)


def encode_words(words: np.ndarray) -> np.ndarray:
    w = np.asarray(words, np.int64)
    shifts = np.arange(9, -1, -1)
    return ((w[:, None] >> shifts[None, :]) & 1).reshape(-1).astype(np.uint8)


# The 60-bit minor-frame sync as a split 28/32-bit shifter compare
# (noaa_hrpt.h:33 HRPT_MINOR_FRAME_SYNC = 0x0A116FD719D83C95, low 60 bits).
_SYNC60 = 0x0A116FD719D83C95
_SYNC_HI = np.uint32(_SYNC60 >> 32)          # 28 bits
_SYNC_LO = np.uint32(_SYNC60 & 0xFFFFFFFF)
_HI_MASK = np.uint32(0x0FFFFFFF)


class HrptDeframer(Block):
    """noaa_hrpt_deframer as a first-class variable-rate graph block.

    Input: hard bits (uint8) at 2 samples/bit; output: 10-bit minor-frame
    words (int16, sync words included), exactly the state machine of
    noaa_hrpt_deframer.cc:69-131 — mid-bit alternation (wait for a
    transition while idle, take every other processed sample once synced),
    a 60-bit shifter matched against HRPT_MINOR_FRAME_SYNC, then
    11084 data words of 10 MSB-first bits each.

    Form: one lax.scan step per input sample carrying the packed
    machine registers (the 60-bit shifter split across two uint32 lanes);
    each step emits a (6,) word slot + count (6 on sync detect, else 0/1)
    and the chunk is compacted to a contiguous prefix with a stable
    argsort over the flattened slot mask."""

    variable_rate = True

    def __init__(self, name=None):
        self.in_ports = (Port(jnp.uint8),)
        self.out_ports = (Port(jnp.int16),)
        super().__init__(name)
        self._sync_words = np.asarray(HRPT_SYNC_WORDS, np.int32)

    @property
    def nominal_rate(self):
        # once synced: one 10-bit word per 20 input samples
        return 1.0 / (2 * HRPT_BITS_PER_WORD)

    def max_out_for(self, n_delivered: int) -> int:
        return 6 * n_delivered

    def init_state(self):
        z32 = jnp.zeros((), jnp.uint32)
        zi = jnp.zeros((), jnp.int32)
        return dict(mid=jnp.ones((), jnp.bool_), last=z32,
                    synced=jnp.zeros((), jnp.bool_), hi=z32, lo=z32,
                    word=zi, bitc=zi, wordc=zi)

    def apply(self, state, x):
        sync_words = jnp.asarray(self._sync_words)
        n_data = HRPT_MINOR_FRAME_WORDS - len(HRPT_SYNC_WORDS)

        def step(c, bit_u8):
            bit = bit_u8.astype(jnp.uint32) & jnp.uint32(1)
            diff = bit ^ c["last"]
            proc = c["mid"] & ((diff != 0) | c["synced"])

            # ---- idle arm: advance the 60-bit shifter, look for sync
            hi2 = ((c["hi"] << 1) | (c["lo"] >> 31)) & _HI_MASK
            lo2 = (c["lo"] << 1) | bit
            hit = proc & ~c["synced"] & (hi2 == _SYNC_HI) & (lo2 == _SYNC_LO)

            # ---- synced arm: shift the word, maybe complete it
            word2 = (c["word"] << 1) | bit.astype(jnp.int32)
            done = c["bitc"] == 1        # this bit completes a word
            emit1 = proc & c["synced"] & done
            frame_end = emit1 & (c["wordc"] == 1)

            upd_idle = proc & ~c["synced"]
            upd_sync = proc & c["synced"]
            nc = dict(
                mid=~proc,
                last=bit,
                synced=jnp.where(hit, True,
                                 jnp.where(frame_end, False, c["synced"])),
                hi=jnp.where(upd_idle, hi2, c["hi"]),
                lo=jnp.where(upd_idle, lo2, c["lo"]),
                word=jnp.where(hit | (upd_sync & done), 0,
                               jnp.where(upd_sync, word2, c["word"])),
                bitc=jnp.where(hit | (upd_sync & done),
                               HRPT_BITS_PER_WORD,
                               jnp.where(upd_sync, c["bitc"] - 1,
                                         c["bitc"])),
                wordc=jnp.where(hit, n_data,
                                jnp.where(emit1, c["wordc"] - 1,
                                          c["wordc"])),
            )
            slot = jnp.where(hit, sync_words,
                             jnp.where(emit1,
                                       jnp.concatenate(
                                           [word2[None],
                                            jnp.zeros(5, jnp.int32)]),
                                       jnp.zeros(6, jnp.int32)))
            count = jnp.where(hit, 6, jnp.where(emit1, 1, 0))
            return nc, (slot, count)

        # tiny per-step body: iteration overhead dominates without unroll
        # (same lesson as the M&M/Viterbi scans, CLAUDE.md perf notes)
        st, (slots, counts) = jax.lax.scan(step, state, x, unroll=16)
        mask = (jnp.arange(6)[None, :] < counts[:, None]).reshape(-1)
        order = jnp.argsort(~mask, stable=True)
        y = slots.reshape(-1)[order].astype(jnp.int16)
        return st, (y, mask.sum().astype(jnp.int32))


class HrptDecoder(Block):
    """noaa_hrpt_decoder: minor-frame word sink with host-side telemetry
    parsing (noaa_hrpt_decoder.cc work/process_* — spacecraft address,
    minor-frame number + sequence errors, day-of-year, milliseconds).
    The device side is a pure capture; stats come from report()."""

    def __init__(self, verbose: bool = False, output_files: bool = False,
                 name=None):
        self.in_ports = (Port(jnp.int16),)
        self.out_ports = ()
        super().__init__(name)
        self.verbose = bool(verbose)
        self.output_files = bool(output_files)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    # Spacecraft-address table (noaa_hrpt_decoder.cc:32-49 hrpt_ids)
    HRPT_IDS = ("000000", "NOAA11", "000002", "NOAA16", "000004", "000005",
                "000006", "NOAA15", "000008", "NOAA12", "000010", "NOAA17",
                "000012", "NOAA18", "000014", "NOAA19")

    def report(self) -> dict:
        out = dict(frames_seen=0, seq_errs=0, address=None, spacecraft=None,
                   day_of_year=None, milliseconds=None, mfnums=[])
        if self.captured is None:
            return out
        words = np.asarray(self.captured[0]).astype(np.int64) & 0x3FF
        nframes = len(words) // HRPT_MINOR_FRAME_WORDS
        expected = None
        for f in range(nframes):
            fr = words[f * HRPT_MINOR_FRAME_WORDS:
                       (f + 1) * HRPT_MINOR_FRAME_WORDS]
            mfnum = (fr[6] & 0x180) >> 7
            out["mfnums"].append(int(mfnum))
            if expected is not None and mfnum != expected:
                out["seq_errs"] += 1
            expected = mfnum % 3 + 1
            out["address"] = int((fr[6] & 0x078) >> 3)
            out["spacecraft"] = self.HRPT_IDS[out["address"]]
            out["day_of_year"] = int(fr[8] >> 1)
            out["milliseconds"] = int(((fr[9] & 0x7F) << 20)
                                      | (fr[10] << 10) | fr[11])
            out["frames_seen"] += 1
            if self.verbose:
                print(f"HRPT frame {f}: MF{mfnum} addr={out['address']} "
                      f"day={out['day_of_year']} ms={out['milliseconds']}")
        return out
