"""Convolutional code (CCSDS k=7, r=1/2) + Viterbi decoder.

Analogs: gnuradio-core/src/lib/viterbi/viterbi.c (encode + k=7 r=1/2
Viterbi with the CCSDS polynomials) and the gr_encode/decode_ccsds_27_bb
blocks (SURVEY.md §2.4).

Design: the encoder is a fully-vectorized windowed parity; the
decoder is a ``lax.scan`` over time carrying all 64 path metrics as one
vector — the classic accelerator-friendly Viterbi (per-step work is a
(64,2) gather + max-reduce, all on the VPU), followed by a reverse scan
traceback over stored survivor decisions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port

# CCSDS / NASA-DSN polynomials (octal 171, 133), 7 taps each.
POLYA = 0o171
POLYB = 0o133
K = 7
NSTATES = 64


def _parity_table():
    t = np.zeros(128, np.uint8)
    for v in range(128):
        t[v] = bin(v).count("1") & 1
    return t


_PAR = _parity_table()


def _transition_outputs():
    """out[s, b] = (o0, o1) for transition from state s with input bit b.

    State s = last 6 input bits (newest at LSB)."""
    o0 = np.zeros((NSTATES, 2), np.float32)
    o1 = np.zeros((NSTATES, 2), np.float32)
    for s in range(NSTATES):
        for b in range(2):
            full = ((s << 1) | b) & 0x7F
            o0[s, b] = _PAR[full & POLYA]
            o1[s, b] = _PAR[full & POLYB]
    return o0, o1


_O0, _O1 = _transition_outputs()


def conv_encode_27(bits: np.ndarray | jnp.ndarray,
                   state_bits: int = 0) -> jnp.ndarray:
    """Encode bits -> interleaved symbol pairs (2 output bits per input).

    Vectorized: 7-bit sliding windows dotted with the polynomials mod 2.
    ``state_bits``: the 6 bits preceding the block (0 for a flushed start).
    """
    b = jnp.asarray(bits, jnp.uint8)
    n = b.shape[0]
    if isinstance(state_bits, int):
        hist = jnp.array([(state_bits >> i) & 1 for i in range(5, -1, -1)],
                         jnp.uint8)
    else:   # traced (6,) bit vector, oldest first (Block state carry)
        hist = jnp.asarray(state_bits, jnp.uint8)
    xb = jnp.concatenate([hist, b])
    idx = jnp.arange(n)[:, None] + jnp.arange(K)[None, :]
    win = xb[idx]  # (n, 7): win[t] = bits t-6 .. t (oldest first)
    pa = jnp.array([(POLYA >> i) & 1 for i in range(K - 1, -1, -1)], jnp.uint8)
    pb = jnp.array([(POLYB >> i) & 1 for i in range(K - 1, -1, -1)], jnp.uint8)
    o0 = (win * pa[None, :]).sum(axis=1) & 1
    o1 = (win * pb[None, :]).sum(axis=1) & 1
    return jnp.stack([o0, o1], axis=1).reshape(-1).astype(jnp.uint8)


def viterbi_decode_27(symbols: jnp.ndarray) -> jnp.ndarray:
    """Soft-decision Viterbi decode.

    symbols: (2*n,) float soft symbols in +-1 (or hard 0/1 scaled), pairs
    (o0, o1) per input bit.  Returns (n,) uint8 decoded bits.
    """
    r = jnp.asarray(symbols, jnp.float32).reshape(-1, 2)
    n = r.shape[0]
    # branch metric: correlation with expected +-1 outputs
    e0 = jnp.asarray(_O0 * 2 - 1)  # (64, 2)
    e1 = jnp.asarray(_O1 * 2 - 1)
    pred = np.zeros((NSTATES, 2), np.int32)  # pred[s', i] for i in {0,1}
    for sp in range(NSTATES):
        pred[sp, 0] = sp >> 1
        pred[sp, 1] = (sp >> 1) | 32
    predj = jnp.asarray(pred)
    bcur = jnp.asarray(np.arange(NSTATES) & 1)  # input bit causing state s'

    neg = jnp.full((NSTATES,), -1e9, jnp.float32)
    pm0 = neg.at[0].set(0.0)  # assume flushed (zero) start state

    def step(pm, rt):
        # metric of transition (s, b): rt[0]*e0[s,b] + rt[1]*e1[s,b]
        bm = rt[0] * e0 + rt[1] * e1  # (64, 2)
        # candidate metrics into s': from pred[s',i] with bit b = s'&1
        b = bcur  # (64,)
        cand0 = pm[predj[:, 0]] + bm[predj[:, 0], b]
        cand1 = pm[predj[:, 1]] + bm[predj[:, 1], b]
        take1 = cand1 > cand0
        pm_new = jnp.where(take1, cand1, cand0)
        # normalize to avoid drift
        pm_new = pm_new - pm_new.max()
        return pm_new, take1

    pm_final, decisions = jax.lax.scan(step, pm0, r)  # decisions: (n, 64)

    # traceback: start from best final state, walk backwards.  The state is
    # carried as a one-hot vector so each step is a static 64x64 select +
    # matvec instead of dynamic gathers inside the scan (as in
    # grtpu.trellis.algorithms.viterbi).
    s_end = jnp.argmax(pm_final).astype(jnp.int32)
    p0_oh = np.zeros((NSTATES, NSTATES), np.float32)
    p1_oh = np.zeros((NSTATES, NSTATES), np.float32)
    p0_oh[np.arange(NSTATES), pred[:, 0]] = 1.0
    p1_oh[np.arange(NSTATES), pred[:, 1]] = 1.0
    p0j, p1j = jnp.asarray(p0_oh), jnp.asarray(p1_oh)
    parity = jnp.asarray((np.arange(NSTATES) & 1).astype(np.float32))
    s0_oh = (jnp.arange(NSTATES) == s_end).astype(jnp.float32)

    def back(s_oh, dec_t):
        bit = (s_oh * parity).sum()
        M = jnp.where(dec_t[:, None], p1j, p0j)
        return jnp.dot(s_oh, M, precision=jax.lax.Precision.HIGHEST), bit

    _, bits_rev = jax.lax.scan(back, s0_oh, decisions, reverse=True)
    return jnp.round(bits_rev).astype(jnp.uint8)


def conv_encode_27_packed(data: bytes) -> jnp.ndarray:
    """Byte helper: encode with 6 zero flush bits appended."""
    bits = np.unpackbits(np.frombuffer(bytes(data), np.uint8))
    bits = np.concatenate([bits, np.zeros(6, np.uint8)])
    return conv_encode_27(bits)


_BYTE_WEIGHTS = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.int32)


class EncodeCcsds27(Block):
    """gr_encode_ccsds_27_bb: one packed byte in -> 16 unpacked encoded
    bits out (MSB first), encoder register carried across chunks
    (gr_encode_ccsds_27_bb.cc work)."""

    in_ports = (Port(jnp.uint8),)
    out_ports = (Port(jnp.uint8),)
    interp = 16

    def init_state(self):
        return jnp.zeros((6,), jnp.uint8)   # last 6 input bits, oldest first

    def apply(self, state, x):
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        bits = ((x[:, None] >> shifts[None, :]) & 1).reshape(-1)
        out = conv_encode_27(bits, state_bits=state)
        full = jnp.concatenate([state, bits])
        return full[-6:], out


class DecodeCcsds27(Block):
    """gr_decode_ccsds_27_fb: soft float symbols in (2 per bit, +-1),
    packed bytes out.  Divergence: the reference decodes with a
    continuous 32-bit-delay traceback; this decodes each chunk as one
    trellis assumed flushed at its edges (use chunk sizes >> constraint
    length — only boundary bits see a shortened traceback)."""

    in_ports = (Port(jnp.float32),)
    out_ports = (Port(jnp.uint8),)
    decim = 16

    def apply(self, state, x):
        bits = viterbi_decode_27(x).reshape(-1, 8).astype(jnp.int32)
        packed = (bits * jnp.asarray(_BYTE_WEIGHTS)[None, :]).sum(axis=1)
        return state, packed.astype(jnp.uint8)
