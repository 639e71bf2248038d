"""tunnel — carrier-sense MAC over the packet PHY (IP over the air).

Analog of gr-digital/examples/narrowband/tunnel.py:

* ``open_tun_interface`` (:72-86): open /dev/net/tun, returns (fd, ifname).
* ``PacketPhy``: transmit_path + receive_path — ModPkts/DemodPkts plus the
  receive path's carrier-sense probe (probe_avg_mag_sqrd_c with a dB
  threshold; gr-digital/examples/narrowband/receive_path.py).
* ``CsMac`` (:140-200): reads payloads from the interface, defers while
  the channel is sensed busy (1 ms initial, exponential back-off capped at
  50 ms), transmits via the PHY; received CRC-good payloads are written
  back to the interface.

Adaptation: the PHY is burst-mode — a transmit produces one sample
burst onto a ``Medium``; receivers demodulate bursts as they arrive.
``Medium`` models shared air: every endpoint hears every burst, the
channel reports busy for the burst's real air time, and an optional
impairment hook (awgn/cfo) runs per delivery.  A real TUN/TAP device is
used when available (root + /dev/net/tun); tests use ``LoopIface``.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from grtpu.digital.pkt import DemodPkts, ModPkts
from grtpu.ops import dsp

# ---------------------------------------------------------------- TUN/TAP

IFF_TUN, IFF_TAP, IFF_NO_PI = 0x0001, 0x0002, 0x1000
TUNSETIFF = 0x400454CA


def open_tun_interface(tun_device_filename: str = "/dev/net/tun",
                       mode: int = IFF_TAP):
    """tunnel.py:72-86 — open a TUN/TAP device; returns (fd, ifname)."""
    import fcntl
    fd = os.open(tun_device_filename, os.O_RDWR)
    ifs = fcntl.ioctl(fd, TUNSETIFF,
                      struct.pack(b"16sH", b"gr%d", mode | IFF_NO_PI))
    ifname = ifs[:16].split(b"\0", 1)[0].decode()
    return fd, ifname


class FdIface:
    """File-descriptor interface (a real TUN/TAP fd)."""

    def __init__(self, fd: int):
        self.fd = fd

    def read(self, n: int = 10 * 1024) -> bytes:
        return os.read(self.fd, n)

    def write(self, payload: bytes):
        os.write(self.fd, payload)


class LoopIface:
    """In-memory stand-in for a TUN device: the 'kernel' side queues
    outgoing payloads with ``inject``; delivered packets are collected in
    ``received``.  ``read`` blocks like os.read on a TUN fd; an empty
    bytes injection signals EOF (tunnel.py:183-185)."""

    def __init__(self):
        self._q: List[bytes] = []
        self._cv = threading.Condition()
        self.received: List[bytes] = []

    def inject(self, payload: bytes):
        with self._cv:
            self._q.append(bytes(payload))
            self._cv.notify()

    def read(self, n: int = 10 * 1024) -> bytes:
        with self._cv:
            while not self._q:
                self._cv.wait()
            return self._q.pop(0)[:n]

    def write(self, payload: bytes):
        with self._cv:
            self.received.append(bytes(payload))
            self._cv.notify()

    def wait_received(self, count: int, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self.received) < count:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True


# ------------------------------------------------------------------ medium

class Medium:
    """Shared broadcast air: bursts are delivered to every other endpoint
    and occupy the channel for ``len(samples)/sample_rate`` seconds."""

    def __init__(self, sample_rate: float = 1e6,
                 impair: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.sample_rate = sample_rate
        self.impair = impair
        self._phys: List["PacketPhy"] = []
        self._busy_until = 0.0
        self._lock = threading.Lock()

    def attach(self, phy: "PacketPhy"):
        self._phys.append(phy)

    def busy(self) -> bool:
        with self._lock:
            return time.monotonic() < self._busy_until

    def occupy(self, seconds: float):
        """Mark the channel busy (a foreign transmitter / test hook)."""
        with self._lock:
            self._busy_until = max(self._busy_until,
                                   time.monotonic() + seconds)

    def transmit(self, src: "PacketPhy", samples: np.ndarray):
        air = len(samples) / self.sample_rate
        with self._lock:
            self._busy_until = max(self._busy_until,
                                   time.monotonic()) + air
        x = self.impair(samples) if self.impair else samples
        for phy in self._phys:
            if phy is not src:
                phy.receive_samples(x)


# --------------------------------------------------------------------- PHY

class PacketPhy:
    """transmit_path + receive_path: packet modem with carrier sense."""

    def __init__(self, modem, medium: Medium,
                 callback: Callable[[bool, bytes], None],
                 carrier_threshold_db: float = 30.0,
                 probe_alpha: float = 1e-3, access_code=None):
        self.medium = medium
        self.mod = ModPkts(modem, access_code=access_code)
        self.demod = DemodPkts(modem, callback, access_code=access_code)
        # receive_path's gr.probe_avg_mag_sqrd_c(threshold, alpha)
        self.threshold = 10 ** (carrier_threshold_db / 10)
        self.alpha = probe_alpha
        self._level = np.zeros((), np.float32)
        medium.attach(self)

    def send_pkt(self, payload: bytes = b"", eof: bool = False):
        self.mod.send_pkt(payload, eof)
        for burst in self.mod.drain():
            self.medium.transmit(self, np.asarray(burst))

    def receive_samples(self, samples: np.ndarray):
        p = (np.abs(samples) ** 2).astype(np.float32)
        _, self._level = dsp.single_pole_iir(p, self._level, self.alpha)
        self.demod.process_samples(samples)

    def carrier_sensed(self) -> bool:
        """receive_path.carrier_sensed: probe level over threshold — plus
        the medium's live air-time occupancy (the probe's real-time analog
        in burst mode)."""
        return self.medium.busy() or \
            float(np.asarray(self._level)) >= self.threshold

    def set_carrier_threshold(self, threshold_db: float):
        self.threshold = 10 ** (threshold_db / 10)

    def stop(self):
        self.demod.stop()


# --------------------------------------------------------------------- MAC

class CsMac:
    """tunnel.py:140-200 — prototype carrier-sense MAC."""

    MIN_DELAY = 0.001  # seconds (tunnel.py:179)
    MAX_DELAY = 0.050  # back-off cap (tunnel.py:194-195)

    def __init__(self, iface, verbose: bool = False):
        self.iface = iface
        self.verbose = verbose
        self.phy: Optional[PacketPhy] = None
        self.backoffs = 0  # instrumentation: busy-channel deferrals

    def set_phy(self, phy: PacketPhy):
        self.phy = phy

    # reference name: set_top_block
    set_top_block = set_phy

    def phy_rx_callback(self, ok: bool, payload: bytes):
        """CRC-good payloads go up into the interface (tunnel.py:160-170)."""
        if self.verbose:
            print(f"Rx: ok = {ok!r}  len(payload) = {len(payload):4d}")
        if ok:
            self.iface.write(payload)

    def main_loop(self):
        """Read iface -> carrier sense w/ exponential back-off -> send.
        Returns on EOF (empty read).  tunnel.py:172-200."""
        while True:
            payload = self.iface.read(10 * 1024)
            if not payload:
                self.phy.send_pkt(eof=True)
                break
            if self.verbose:
                print(f"Tx: len(payload) = {len(payload):4d}")
            delay = self.MIN_DELAY
            while self.phy.carrier_sensed():
                self.backoffs += 1
                time.sleep(delay)
                if delay < self.MAX_DELAY:
                    delay *= 2  # exponential back-off
            self.phy.send_pkt(payload)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.main_loop, daemon=True)
        t.start()
        return t
