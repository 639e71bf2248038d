"""Self-checking test pattern source/sinks.

Analogs (SURVEY.md §2.4 coding/framing):
  * gri_lfsr_15_1_0 / gri_lfsr_32k (general/gri_lfsr_15_1_0.h,
    gri_lfsr_32k.h) — x^15+x+1 maximal LFSR, one zero bit appended per
    32768-bit period, packed LSB-first into 16-bit words;
  * gr_lfsr_32k_source_s (general/gr_lfsr_32k_source_s.cc) — streams a
    2047-word buffer of that sequence cyclically (2047, not 2048, so the
    pattern never aligns with packet boundaries);
  * gr_check_lfsr_32k_s (general/gr_check_lfsr_32k_s.cc) — sink locking
    onto the sequence (match 3 consecutive words), counting right/wrong,
    re-searching after 3 consecutive errors;
  * gr_check_counting_s (general/gr_check_counting_s.cc) — sink checking
    an incrementing-counter stream (16- or 32-bit counts).

The checkers run their exact state machines host-side over the captured
stream (they are diagnostic fixtures, not signal path); the source is a
normal stream block.  Stream item type is int32 (the container for the
reference's shorts; values stay in uint16 range).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port

BUFSIZE = 2048 - 1  # ensure pattern isn't packet aligned (reference :61)


def lfsr_32k_words(n_words: int = BUFSIZE) -> np.ndarray:
    """First n_words 16-bit words of the gri_lfsr_32k sequence."""
    nbits = n_words * 16
    sr = 0x7FFF
    count = 0
    bits = np.empty(nbits, np.uint16)
    for i in range(nbits):
        if count == 32767:
            count = 0
            bits[i] = 0
            continue
        count += 1
        sr = ((((sr >> 1) ^ sr) & 0x1) << 14) | (sr >> 1)
        bits[i] = sr & 0x1
    # LSB-first packing (next_short shifts right, sets 0x8000)
    w = bits.reshape(n_words, 16)
    weights = (1 << np.arange(16)).astype(np.uint32)
    return (w.astype(np.uint32) @ weights).astype(np.uint16)


class Lfsr32kSource(Block):
    """gr_lfsr_32k_source_s: cyclic 2047-word LFSR pattern source.

    Gather-free: the table is tiled host-side so one dynamic_slice at the
    carried phase yields the chunk (indexing with a traced index array is
    a gather)."""

    def __init__(self, name=None):
        self.out_ports = (Port(jnp.int32),)
        super().__init__(name)
        self.data = lfsr_32k_words().astype(np.int32)

    def init_state(self):
        return jnp.zeros((), jnp.int32)

    def apply(self, state, n: int):
        reps = -(-(n + BUFSIZE) // BUFSIZE)
        tiled = np.tile(self.data, reps)  # host constant, per static n
        import jax

        y = jax.lax.dynamic_slice_in_dim(jnp.asarray(tiled), state, n)
        return (state + n) % BUFSIZE, y


class _CheckBase(Block):
    def __init__(self, name=None):
        self.in_ports = (Port(jnp.int32),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def _stream(self) -> np.ndarray:
        if self.captured is None:
            return np.zeros(0, np.int64)
        return (np.asarray(self.captured[0]).astype(np.int64)) & 0xFFFF


class CheckLfsr32k(_CheckBase):
    """gr_check_lfsr_32k_s: lock onto the LFSR pattern, count errors.

    report() returns dict(ntotal, nright, runlength) — the reference's
    accessors — after running its exact MATCH0/1/2 -> LOCKED state
    machine (3 consecutive wrong words re-enter the search)."""

    def report(self) -> dict:
        buf = lfsr_32k_words().astype(np.int64)
        x = self._stream()
        state = 0  # 0,1,2 = MATCH0..2; 3 = LOCKED
        hist = 0   # bitmask of last 3 right(1)/wrong(0)
        ntotal = nright = runlength = 0
        idx = 0

        def right():
            nonlocal hist, nright, runlength
            hist = ((hist << 1) | 1) & 0x7
            nright += 1
            runlength += 1

        def wrong():
            nonlocal hist, runlength
            hist = (hist << 1) & 0x7
            runlength = 0

        wrong(), wrong(), wrong()
        for v in x:
            if state == 0:
                if v == buf[0]:
                    state = 1
            elif state == 1:
                state = 2 if v == buf[1] else 0
            elif state == 2:
                if v == buf[2]:
                    state = 3
                    right(), right(), right()
                    idx = 3
                else:
                    state = 0
            else:  # LOCKED
                expected = buf[idx]
                idx = (idx + 1) % BUFSIZE
                if v == expected:
                    right()
                else:
                    wrong()
                    if hist & 0x7 == 0:
                        state = 0
                        wrong(), wrong(), wrong()
                        runlength = 0
                        idx = 0
            ntotal += 1
        return {"ntotal": ntotal, "nright": nright, "runlength": runlength}


class CheckCounting(_CheckBase):
    """gr_check_counting_s: verify an incrementing counter stream
    (do_32bit packs the count into consecutive high/low 16-bit words)."""

    def __init__(self, do_32bit: bool = False, name=None):
        super().__init__(name)
        self.do_32bit = do_32bit

    def report(self) -> dict:
        x = self._stream()
        state = 0  # 0 = SEARCHING, 1 = LOCKED
        hist = 0
        total_errors = 0
        runlength = 0
        count = 0
        mask = 0xFFFFFFFF if self.do_32bit else 0xFFFF
        if self.do_32bit:
            # consecutive (high, low) word pairs carry a 32-bit count
            x = (x[0::2] << 16) | x[1::2] if len(x) % 2 == 0 else \
                (x[:-1][0::2] << 16) | x[:-1][1::2]

        def right():
            nonlocal hist, runlength
            hist = ((hist << 1) | 1) & 0x7
            runlength += 1

        def wrong():
            nonlocal hist, runlength, total_errors
            hist = (hist << 1) & 0x7
            runlength = 0
            total_errors += 1

        for v in x:
            if state == 0:
                if v == count:
                    right()
                    count = (count + 1) & mask
                    if hist == 0x7:
                        state = 1
                else:
                    wrong()
                    count = (v + 1) & mask
            else:
                if v == count:
                    right()
                else:
                    wrong()
                    if hist & 0x7 == 0:
                        state = 0
                count = (count + 1) & mask
        return {"ntotal": len(x), "total_errors": total_errors,
                "runlength": runlength, "locked": state == 1}
