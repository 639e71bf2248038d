"""Streaming packet encoder/decoder graph blocks.

Analogs: grc_gnuradio/blks2/packet.py packet_mod_X / packet_demod_X (the
blks2_packet_encoder / blks2_packet_decoder GRC blocks): the encoder slices
the raw item bytes of a stream into fixed-size payloads and wraps each in
the packet_utils framing (preamble + access code + 2x16-bit header +
whitened payload+CRC32 + trailer); the decoder hunts access codes in the
demodulated bit stream, checks the CRC, and re-emits the recovered payload
bytes as the original item stream.

Here the reference routes packets through message queues and python
watcher threads (packet.py _packet_decoder_thread); here both directions
are in-graph.  Encoding is fixed-rate (payload_length in -> one packet's
bytes out) and fully traced (CRC32 as a byte scan over the table,
whitening as a static XOR mask).  Decoding is a first-class variable-rate
block: per chunk it locates up to max_pkts access codes (one FIR
correlation, no gathers), validates CRCs, and compacts the good payloads
into a valid-prefix emission through the executor's FIFO machinery.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port
from grtpu.digital import packet as pu

_DT = {"complex": jnp.complex64, "float": jnp.float32, "int": jnp.int32,
       "short": jnp.int16, "byte": jnp.uint8}
_ITEMSIZE = {"complex": 8, "float": 4, "int": 4, "short": 2, "byte": 1}


def _crc32_scan(by: jnp.ndarray) -> jnp.ndarray:
    """digital_crc32 over a (L,) uint8 byte vector, traced (table lookup
    per byte, like the reference's update_crc32 loop)."""
    table = jnp.asarray(pu._TABLE.astype(np.uint32))

    def f(crc, b):
        idx = ((crc >> 24) ^ b.astype(jnp.uint32)) & 0xFF
        crc = ((crc << 8) & jnp.uint32(0xFFFFFFFF)) ^ table[idx]
        return crc, None

    crc, _ = jax.lax.scan(f, jnp.uint32(0xFFFFFFFF), by)
    return crc ^ jnp.uint32(0xFFFFFFFF)


def _bytes_to_bits_j(by: jnp.ndarray) -> jnp.ndarray:
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
    return ((by[:, None] >> shifts[None, :]) & 1).reshape(-1).astype(jnp.uint8)


def _bits_to_bytes_j(bits: jnp.ndarray) -> jnp.ndarray:
    b = bits.reshape(-1, 8).astype(jnp.uint8)
    w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    return (b * w[None, :]).sum(axis=1).astype(jnp.uint8)


def _items_to_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Raw little-endian item bytes (the reference payload is
    msg.to_string() of the stream slice)."""
    if x.dtype == jnp.uint8:
        return x
    if x.dtype == jnp.complex64:
        parts = jnp.stack([jnp.real(x), jnp.imag(x)], axis=-1)
        return jax.lax.bitcast_convert_type(
            parts.astype(jnp.float32), jnp.uint8).reshape(-1)
    return jax.lax.bitcast_convert_type(x, jnp.uint8).reshape(-1)


def _bytes_to_items(by: jnp.ndarray, dtype) -> jnp.ndarray:
    if dtype == jnp.uint8:
        return by
    if dtype == jnp.complex64:
        f = jax.lax.bitcast_convert_type(by.reshape(-1, 4), jnp.float32)
        f = f.reshape(-1, 2)
        return (f[:, 0] + 1j * f[:, 1]).astype(jnp.complex64)
    nbytes = jnp.dtype(dtype).itemsize
    return jax.lax.bitcast_convert_type(
        by.reshape(-1, nbytes), dtype).reshape(-1)


class PacketEncoder(Block):
    """blks2_packet_encoder: item stream -> framed packet bytes.

    Fixed rate: every ``payload_length`` input bytes becomes one packet of
    bytes(preamble+access+header+whitened(payload+crc)+trailer).  The
    output feeds a byte-consuming modulator (GenericModBlock, GmskModBlock
    — the dpsk_loopback.grc chain)."""

    def __init__(self, type: str = "float", payload_length: int = 256,
                 access_code=None, samples_per_symbol: int = 2,
                 bits_per_symbol: int = 1, pad_for_usrp: bool = False,
                 name=None):
        dt = _DT[type]
        if payload_length in (0, None):
            payload_length = 256
        itemsize = _ITEMSIZE[type]
        if payload_length % itemsize:
            raise ValueError("payload_length must be a multiple of the "
                             "stream itemsize")
        self.in_ports = (Port(dt),)
        self.out_ports = (Port(jnp.uint8),)
        ref_bits = pu.make_packet(b"\x00" * payload_length,
                                  access_code if access_code else None)
        assert len(ref_bits) % 8 == 0
        self.decim = payload_length // itemsize
        self.interp = len(ref_bits) // 8
        super().__init__(name)
        self.payload_length = payload_length
        code = (np.asarray(access_code, np.uint8) if access_code is not None
                and len(np.atleast_1d(access_code))
                else pu.DEFAULT_ACCESS_CODE_BITS)
        hdr = pu.make_header(payload_length + 4)
        self._head_bits = np.concatenate(
            [pu.DEFAULT_PREAMBLE_BITS, code,
             np.unpackbits(np.frombuffer(hdr, np.uint8))]).astype(np.uint8)
        self._trailer_bits = np.unpackbits(
            np.frombuffer(b"\x55", np.uint8)).astype(np.uint8)
        self._wh = pu._WHITENER[: payload_length + 4].copy()
        self._dtype = dt

    def apply(self, state, x):
        L = self.payload_length
        by = _items_to_bytes(x).reshape(-1, L)

        def one(payload):
            crc = _crc32_scan(payload)
            crcb = jnp.stack([(crc >> s) & 0xFF
                              for s in (24, 16, 8, 0)]).astype(jnp.uint8)
            body = jnp.concatenate([payload, crcb]) ^ jnp.asarray(self._wh)
            bits = jnp.concatenate([
                jnp.asarray(self._head_bits), _bytes_to_bits_j(body),
                jnp.asarray(self._trailer_bits)])
            return _bits_to_bytes_j(bits)

        return state, jax.vmap(one)(by).reshape(-1)


class PacketDecoder(Block):
    """blks2_packet_decoder: demodulated BIT stream (one bit per byte, the
    GenericDemodBlock/GmskDemodBlock output) -> recovered item stream.

    First-class variable rate: locates access codes with one correlation,
    validates header + CRC32 per candidate, and emits only the good
    payloads (compacted in-chunk to a valid prefix).  The reference's
    message-queue + watcher-thread plumbing (packet.py
    _packet_decoder_thread) collapses into the jitted step."""

    variable_rate = True

    def __init__(self, type: str = "float", payload_length: int = 256,
                 access_code=None, threshold: int = -1, name=None):
        dt = _DT[type]
        if payload_length in (0, None):
            payload_length = 256
        self.in_ports = (Port(jnp.uint8),)
        self.out_ports = (Port(dt),)
        code = (np.asarray(access_code, np.uint8) if access_code is not None
                and len(np.atleast_1d(access_code))
                else pu.DEFAULT_ACCESS_CODE_BITS)
        self.code = code
        self.threshold = 0 if threshold in (None, -1) else int(threshold)
        self.payload_length = payload_length
        self.body_bits = (payload_length + 4) * 8
        # header(32) + body + trailer slack after the access code
        self.tail_bits = 32 + self.body_bits
        self.history = len(code) + self.tail_bits + 1
        super().__init__(name)
        self._wh = pu._WHITENER[: payload_length + 4].copy()
        self._dtype = dt
        self._itemsize = _ITEMSIZE[type]

    @property
    def nominal_rate(self):
        # payload items out per input bit: L/itemsize per packet of
        # ~(128 + tail) bits
        per_pkt = self.payload_length // self._itemsize
        return per_pkt / float(len(self.code) + 32 + self.tail_bits)

    def max_out_for(self, n_delivered: int) -> int:
        per_pkt = self.payload_length // self._itemsize
        maxp = n_delivered // self.tail_bits + 1
        return maxp * per_pkt

    def init_state(self):
        return jnp.zeros((), jnp.int32)  # absolute bit index of chunk start

    def apply(self, state, x):
        from grtpu.digital.correlate import access_code_detect

        n = x.shape[0]
        chunk_len = n - (self.history - 1)
        L = len(self.code)
        per_pkt = self.payload_length // self._itemsize
        maxp = n // self.tail_bits + 1
        # flags[i] == 1 iff the code ends at delivered index i + L - 1
        flags = access_code_detect(x & 1, self.code, self.threshold)
        ends = jnp.arange(flags.shape[0]) + (L - 1)
        # a packet is usable only if fully inside the delivered chunk; a
        # hit already consumed in the previous chunk (its whole tail fit
        # before the history boundary) is skipped, while a hit that was
        # DEFERRED there (tail ran past the chunk) re-appears via the
        # history and is taken now
        ok_pos = (flags > 0) & (ends + 1 + self.tail_bits <= n) & \
            (ends + 1 + self.tail_bits > self.history - 1)
        hits = jnp.flatnonzero(ok_pos, size=maxp, fill_value=n) + (L - 1)

        out_buf = jnp.zeros((maxp * per_pkt,), self._dtype)
        wh = jnp.asarray(self._wh)

        def body(carry, h):
            buf, count, last_end = carry
            in_range = h < n
            start = jnp.clip(h + 1, 0, n - self.tail_bits)
            pkt = jax.lax.dynamic_slice_in_dim(x, start, self.tail_bits) & 1
            hdr_bytes = _bits_to_bytes_j(pkt[:32])
            v1 = (hdr_bytes[0].astype(jnp.int32) << 8) | hdr_bytes[1]
            v2 = (hdr_bytes[2].astype(jnp.int32) << 8) | hdr_bytes[3]
            hdr_ok = (v1 == v2) & ((v1 & 0x0FFF) == self.payload_length + 4)
            body_by = _bits_to_bytes_j(pkt[32:32 + self.body_bits]) ^ wh
            crc = _crc32_scan(body_by[:-4])
            want = (body_by[-4].astype(jnp.uint32) << 24) | \
                   (body_by[-3].astype(jnp.uint32) << 16) | \
                   (body_by[-2].astype(jnp.uint32) << 8) | \
                   body_by[-1].astype(jnp.uint32)
            fresh = start > last_end  # skip hits inside a consumed packet
            good = in_range & hdr_ok & (crc == want) & fresh
            items = _bytes_to_items(body_by[:-4], self._dtype)
            buf = jax.lax.cond(
                good,
                lambda b: jax.lax.dynamic_update_slice_in_dim(
                    b, items, count * per_pkt, 0),
                lambda b: b, buf)
            count = count + good.astype(jnp.int32)
            last_end = jnp.where(good, start + self.tail_bits - 1, last_end)
            return (buf, count, last_end), None

        (out_buf, count, _), _ = jax.lax.scan(
            body, (out_buf, jnp.zeros((), jnp.int32),
                   jnp.zeros((), jnp.int32) - 1), hits)
        return state + chunk_len, (out_buf, count * per_pkt)
