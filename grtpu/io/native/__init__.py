"""ctypes bindings for the native host I/O runtime.

C++ pieces (compiled into a shared library on first use):
  * ringbuf.cc — double-VM-mapped ring buffer (gr_vmcircbuf analog) +
    threaded file-reader pump;
  * loader.cc — UDP ingest/egress pumps (gr_udp_source/sink data plane),
    write-behind file sink, and fused ring-read format converters
    (i16/u8/interleaved-sc16 -> float32, the gri_* conversion loops).

The library is compiled with ``-march=native``, so it belongs to the machine
that built it: its file name carries a hash of the sources, the compile
flags and this host (name and CPU), and a checkout copied to another
machine compiles its own.  Falls back gracefully if no compiler is
available, so the package stays importable everywhere (available() reports
the native path's presence).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "build")
_SRCS = [os.path.join(_DIR, "ringbuf.cc"), os.path.join(_DIR, "loader.cc")]
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor()


def library_path() -> str:
    """Path of the shared library for these sources on this host."""
    h = hashlib.sha256()
    for s in _SRCS:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(platform.node().encode())
    h.update(platform.machine().encode())
    h.update(_cpu_model().encode())
    return os.path.join(_BUILD_DIR, f"libgrtpu_io-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> bool:
    """Compile the sources into ``so`` (atomically: concurrent builds
    each write their own temporary file and rename it into place)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        for cc in ("c++", "g++", "clang++"):
            try:
                subprocess.run([cc, *_FLAGS, "-o", tmp, *_SRCS, "-lpthread"],
                               check=True, capture_output=True, timeout=120)
            except (subprocess.CalledProcessError, FileNotFoundError,
                    subprocess.TimeoutExpired):
                continue
            os.replace(tmp, so)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _build() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so) and not _compile(so):
        return None
    lib = ctypes.CDLL(so)
    lib.grtpu_ring_create.restype = ctypes.c_void_p
    lib.grtpu_ring_create.argtypes = [ctypes.c_size_t]
    lib.grtpu_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_capacity.restype = ctypes.c_size_t
    lib.grtpu_ring_capacity.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_readable.restype = ctypes.c_size_t
    lib.grtpu_ring_readable.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_writable.restype = ctypes.c_size_t
    lib.grtpu_ring_writable.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_eof.restype = ctypes.c_int
    lib.grtpu_ring_eof.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_set_eof.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_write.restype = ctypes.c_size_t
    lib.grtpu_ring_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t]
    lib.grtpu_ring_read.restype = ctypes.c_size_t
    lib.grtpu_ring_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t]
    lib.grtpu_ring_peek.restype = ctypes.c_void_p
    lib.grtpu_ring_peek.argtypes = [ctypes.c_void_p]
    lib.grtpu_ring_advance.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.grtpu_pump_file.restype = ctypes.c_void_p
    lib.grtpu_pump_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.grtpu_pump_stop.argtypes = [ctypes.c_void_p]
    lib.grtpu_udp_pump.restype = ctypes.c_void_p
    lib.grtpu_udp_pump.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_size_t]
    lib.grtpu_udp_pump_stop.argtypes = [ctypes.c_void_p]
    for fn in ("grtpu_udp_pump_rx_dgrams", "grtpu_udp_pump_rx_bytes",
               "grtpu_udp_pump_drops"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.grtpu_udp_sender.restype = ctypes.c_void_p
    lib.grtpu_udp_sender.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_size_t]
    lib.grtpu_udp_send.restype = ctypes.c_size_t
    lib.grtpu_udp_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_size_t]
    lib.grtpu_udp_send_eof.argtypes = [ctypes.c_void_p]
    lib.grtpu_udp_sender_close.argtypes = [ctypes.c_void_p]
    lib.grtpu_write_pump.restype = ctypes.c_void_p
    lib.grtpu_write_pump.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.grtpu_write_pump_stop.argtypes = [ctypes.c_void_p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.grtpu_ring_read_i16_to_f32.restype = ctypes.c_size_t
    lib.grtpu_ring_read_i16_to_f32.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_size_t, ctypes.c_float]
    lib.grtpu_ring_read_u8_to_f32.restype = ctypes.c_size_t
    lib.grtpu_ring_read_u8_to_f32.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_size_t, ctypes.c_float,
        ctypes.c_float]
    lib.grtpu_ring_read_sc16_to_f32_planar.restype = ctypes.c_size_t
    lib.grtpu_ring_read_sc16_to_f32_planar.argtypes = [
        ctypes.c_void_p, f32p, f32p, ctypes.c_size_t, ctypes.c_float]
    lib.grtpu_f32_to_i16.argtypes = [
        f32p, ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t,
        ctypes.c_float]
    _lib = lib
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def available() -> bool:
    return _build() is not None


class RingBuffer:
    """Single-writer/single-reader byte ring over the native double-mapped
    region (gr_vmcircbuf semantics: wraparound is linear-addressable)."""

    def __init__(self, min_bytes: int = 1 << 22):
        lib = _build()
        if lib is None:
            raise RuntimeError("native ring buffer unavailable (no compiler)")
        self._lib = lib
        self._h = lib.grtpu_ring_create(min_bytes)
        if not self._h:
            raise RuntimeError("ring creation failed")

    @property
    def capacity(self) -> int:
        return self._lib.grtpu_ring_capacity(self._h)

    @property
    def readable(self) -> int:
        return self._lib.grtpu_ring_readable(self._h)

    @property
    def writable(self) -> int:
        return self._lib.grtpu_ring_writable(self._h)

    @property
    def eof(self) -> bool:
        return bool(self._lib.grtpu_ring_eof(self._h))

    def set_eof(self):
        self._lib.grtpu_ring_set_eof(self._h)

    def write(self, data: bytes) -> int:
        return self._lib.grtpu_ring_write(self._h, data, len(data))

    def read(self, n: int) -> bytes:
        buf = ctypes.create_string_buffer(n)
        got = self._lib.grtpu_ring_read(self._h, buf, n)
        return buf.raw[:got]

    def read_items(self, n_items: int, dtype=np.complex64) -> Optional[np.ndarray]:
        """Read exactly n_items (or None if not yet available)."""
        dt = np.dtype(dtype)
        need = n_items * dt.itemsize
        if self.readable < need:
            return None
        raw = self.read(need)
        return np.frombuffer(raw, dt)

    def close(self):
        if self._h:
            self._lib.grtpu_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FilePump:
    """Background native thread streaming a file into a RingBuffer
    (the high-rate ingest path for gr_file_source-style capture replay)."""

    def __init__(self, ring: RingBuffer, path: str):
        self._lib = ring._lib
        self._h = self._lib.grtpu_pump_file(ring._h, path.encode())
        if not self._h:
            raise RuntimeError(f"cannot pump {path}")

    def stop(self):
        if self._h:
            self._lib.grtpu_pump_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class UdpPump:
    """Background native UDP receiver filling a RingBuffer
    (gr_udp_source data plane: datagrams in, zero-length datagram = EOF)."""

    def __init__(self, ring: RingBuffer, host: str = "", port: int = 0,
                 payload_size: int = 1472):
        self._lib = ring._lib
        self._h = self._lib.grtpu_udp_pump(
            ring._h, host.encode(), port, payload_size)
        if not self._h:
            raise RuntimeError(f"cannot bind udp {host}:{port}")

    @property
    def rx_dgrams(self) -> int:
        """Datagrams landed in the ring so far."""
        return int(self._lib.grtpu_udp_pump_rx_dgrams(self._h))

    @property
    def rx_bytes(self) -> int:
        return int(self._lib.grtpu_udp_pump_rx_bytes(self._h))

    @property
    def drops(self) -> int:
        """Kernel-level socket drops (SO_RXQ_OVFL cumulative counter) —
        datagrams the service failed to drain in time."""
        return int(self._lib.grtpu_udp_pump_drops(self._h))

    def stop(self):
        if self._h:
            self._lib.grtpu_udp_pump_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class UdpSender:
    """Native UDP sender (gr_udp_sink data plane: payload-size datagrams,
    zero-length datagram on close signals EOF)."""

    def __init__(self, host: str, port: int, payload_size: int = 1472):
        lib = _build()
        if lib is None:
            raise RuntimeError("native loader unavailable (no compiler)")
        self._lib = lib
        self._h = lib.grtpu_udp_sender(host.encode(), port, payload_size)
        if not self._h:
            raise RuntimeError(f"cannot connect udp {host}:{port}")

    def send(self, data) -> int:
        buf = np.ascontiguousarray(data).tobytes() \
            if isinstance(data, np.ndarray) else bytes(data)
        return self._lib.grtpu_udp_send(self._h, buf, len(buf))

    def send_eof(self):
        self._lib.grtpu_udp_send_eof(self._h)

    def close(self, eof: bool = True):
        if self._h:
            if eof:
                self.send_eof()
            self._lib.grtpu_udp_sender_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close(eof=False)
        except Exception:
            pass


class WritePump:
    """Write-behind file sink: producer writes into the ring, a native
    thread drains it to disk (gr_file_sink that never blocks the chunk
    loop)."""

    def __init__(self, ring: RingBuffer, path: str, append: bool = False):
        self._ring = ring
        self._lib = ring._lib
        self._h = self._lib.grtpu_write_pump(
            ring._h, path.encode(), 1 if append else 0)
        if not self._h:
            raise RuntimeError(f"cannot open {path}")

    def write(self, data, timeout: float = 10.0) -> int:
        import time as _time

        buf = np.ascontiguousarray(data).tobytes() \
            if isinstance(data, np.ndarray) else bytes(data)
        off = 0
        deadline = _time.monotonic() + timeout
        while off < len(buf):
            n = self._ring.write(buf[off:])
            off += n
            if n == 0:
                # ring full: writer thread busy — or dead (disk error)
                if _time.monotonic() > deadline:
                    raise RuntimeError(
                        "write pump stalled (disk full / I/O error?)")
                _time.sleep(0.0002)
        return off

    def close(self):
        """Flush the remaining ring contents and join the writer."""
        if self._h:
            self._lib.grtpu_write_pump_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ------------------------------------------------- fused converting reads
def read_i16_as_f32(ring: RingBuffer, n_items: int,
                    scale: float = 1.0) -> Optional[np.ndarray]:
    """Read n int16 items from the ring converted to float32 in one native
    pass (gr_short_to_float).  None if not enough buffered."""
    out = np.empty(n_items, np.float32)
    got = ring._lib.grtpu_ring_read_i16_to_f32(ring._h, _f32p(out),
                                               n_items, scale)
    return out if got == n_items else None


def read_u8_as_f32(ring: RingBuffer, n_items: int, scale: float = 1.0,
                   offset: float = 0.0) -> Optional[np.ndarray]:
    """Read n uint8 items converted to float32: (x + offset) * scale
    (gr_uchar_to_float; offset=-127, scale=1/128 for RTL-style captures)."""
    out = np.empty(n_items, np.float32)
    got = ring._lib.grtpu_ring_read_u8_to_f32(ring._h, _f32p(out),
                                              n_items, scale, offset)
    return out if got == n_items else None


def read_sc16_as_f32_planar(ring: RingBuffer, n_cplx: int,
                            scale: float = 1.0):
    """Read n interleaved-int16 I/Q pairs (UHD sc16 wire format /
    gr_interleaved_short_to_complex) as planar (re, im) float32 arrays."""
    re = np.empty(n_cplx, np.float32)
    im = np.empty(n_cplx, np.float32)
    got = ring._lib.grtpu_ring_read_sc16_to_f32_planar(
        ring._h, _f32p(re), _f32p(im), n_cplx, scale)
    return (re, im) if got == n_cplx else None


def f32_to_i16(data: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """float32 -> int16 with round-half-away + clip (gr_float_to_short)."""
    src = np.ascontiguousarray(data, np.float32)
    out = np.empty(src.shape, np.int16)
    lib = _build()
    if lib is None:
        return np.clip(np.round(src * scale), -32768, 32767).astype(np.int16)
    lib.grtpu_f32_to_i16(_f32p(src),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                         src.size, scale)
    return out


class NativeFileSource:
    """High-rate capture replay: native reader thread -> ring -> fixed
    chunks, with optional on-the-fly wire-format conversion.

    ``wire``: 'raw' (items of ``dtype`` passed through), 'i16' (int16 ->
    f32), 'u8' (uint8 -> f32), or 'sc16' (interleaved int16 I/Q ->
    planar (re, im) f32)."""

    def __init__(self, path: str, dtype=np.complex64, wire: str = "raw",
                 scale: float = 1.0, offset: float = 0.0,
                 ring_bytes: int = 1 << 22):
        self.dtype = np.dtype(dtype)
        self.wire = wire
        self.scale, self.offset = scale, offset
        self.ring = RingBuffer(ring_bytes)
        self.pump = FilePump(self.ring, path)

    def _item_bytes(self) -> int:
        return {"raw": self.dtype.itemsize, "i16": 2, "u8": 1,
                "sc16": 4}[self.wire]

    def read_chunk(self, n_items: int, timeout: float = 5.0):
        """Blocking read of one chunk (None at EOF).  The final partial
        chunk is zero-padded to n_items (executor chunks are fixed-size)."""
        import time as _time
        deadline = _time.monotonic() + timeout
        need = n_items * self._item_bytes()
        while (self.ring.readable < need and not self.ring.eof
               and _time.monotonic() < deadline):
            _time.sleep(0.0002)
        avail = self.ring.readable // self._item_bytes()
        if avail == 0 and self.ring.eof:
            return None
        if avail < n_items and not self.ring.eof:
            raise TimeoutError(
                f"ingest stalled: {avail}/{n_items} items after {timeout}s")
        n = min(n_items, avail)
        if self.wire == "raw":
            out = self.ring.read_items(n, self.dtype)
            if out is None:
                return None
            if n < n_items:
                out = np.concatenate(
                    [out, np.zeros(n_items - n, self.dtype)])
            return out
        if self.wire == "i16":
            out = read_i16_as_f32(self.ring, n, self.scale)
        elif self.wire == "u8":
            out = read_u8_as_f32(self.ring, n, self.scale, self.offset)
        elif self.wire == "sc16":
            pair = read_sc16_as_f32_planar(self.ring, n, self.scale)
            if pair is None:
                return None
            re, im = pair
            if n < n_items:
                pad = np.zeros(n_items - n, np.float32)
                re, im = np.concatenate([re, pad]), np.concatenate([im, pad])
            return re, im
        else:
            raise ValueError(f"unknown wire format {self.wire!r}")
        if out is None:
            return None
        if n < n_items:
            out = np.concatenate([out, np.zeros(n_items - n, np.float32)])
        return out

    def chunks(self, n_items: int):
        """Iterate fixed-size chunks until EOF."""
        while True:
            c = self.read_chunk(n_items)
            if c is None:
                return
            yield c

    def close(self):
        self.pump.stop()
        self.ring.close()
