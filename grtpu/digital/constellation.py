"""Constellation objects: symbol maps + decision rules.

Analog of the digital_constellation hierarchy
(gr-digital/include/digital_constellation.h:57-442,
gr-digital/lib/digital_constellation.cc): points, rotational symmetry,
dimensionality, generic nearest-point decision maker, and the hard-coded
fast deciders for BPSK/QPSK/DQPSK/8PSK.

Decisions are vectorized over whole symbol blocks — the
nearest-point rule is a (n_sym, n_points) distance matrix reduce (matmul
friendly) instead of a per-symbol loop.
"""

from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp
import numpy as np


class Constellation:
    """Base constellation: complex points + per-point symbol values.

    rotational_symmetry: order of phase ambiguity (4 for QPSK...),
    dimensionality: samples per symbol (1 for memoryless maps).
    """

    def __init__(self, points: Sequence[complex],
                 pre_diff_code: Sequence[int] | None = None,
                 rotational_symmetry: int = 0, dimensionality: int = 1):
        self.points = np.asarray(points, np.complex64)
        self.pre_diff_code = (np.asarray(pre_diff_code, np.int32)
                              if pre_diff_code is not None and len(pre_diff_code)
                              else None)
        self.rotational_symmetry = rotational_symmetry
        self.dimensionality = dimensionality

    # -- queries (digital_constellation.h API) ------------------------------
    def arity(self) -> int:
        return len(self.points)

    def bits_per_symbol(self) -> int:
        return int(np.log2(self.arity()))

    def map_to_points(self, value):
        """symbol index -> complex point (vectorized)."""
        return jnp.asarray(self.points)[jnp.asarray(value, jnp.int32)]

    def decision_maker(self, samples):
        """Nearest-point hard decision, vectorized over a block.

        (generic decision_maker of digital_constellation.cc — here one
        |x - p|^2 argmin over the point table per block)."""
        x = jnp.asarray(samples)
        p = jnp.asarray(self.points)
        d2 = jnp.abs(x[:, None] - p[None, :]) ** 2
        return jnp.argmin(d2, axis=1).astype(jnp.int32)

    def soft_decision_maker(self, samples, npwr: float = 1.0):
        """Per-bit LLRs via max-log over the point table."""
        x = jnp.asarray(samples)
        p = jnp.asarray(self.points)
        d2 = -jnp.abs(x[:, None] - p[None, :]) ** 2 / npwr
        k = self.bits_per_symbol()
        idx = np.arange(self.arity())
        llrs = []
        for b in range(k - 1, -1, -1):
            one = jnp.asarray((idx >> b) & 1, jnp.bool_)
            l1 = jnp.max(jnp.where(one[None, :], d2, -jnp.inf), axis=1)
            l0 = jnp.max(jnp.where(~one[None, :], d2, -jnp.inf), axis=1)
            llrs.append(l1 - l0)
        return jnp.stack(llrs, axis=1)  # (n, bits) MSB-first

    def phase_error(self, samples, decisions=None):
        """Decision-directed phase error for carrier loops
        (constellation_receiver's decision_maker_pe)."""
        x = jnp.asarray(samples)
        if decisions is None:
            decisions = self.decision_maker(x)
        ref = self.map_to_points(decisions)
        err = x * jnp.conj(ref)
        return jnp.arctan2(jnp.imag(err), jnp.real(err))


def constellation_bpsk() -> Constellation:
    """digital_constellation_bpsk: points -1, +1."""
    return Constellation([-1 + 0j, 1 + 0j], rotational_symmetry=2)


def constellation_qpsk() -> Constellation:
    """digital_constellation_qpsk (gray-coded, pi/4 offset grid)."""
    s = 1 / np.sqrt(2)
    pts = [s * (-1 - 1j), s * (1 - 1j), s * (-1 + 1j), s * (1 + 1j)]
    return Constellation(pts, [0, 1, 2, 3], rotational_symmetry=4)


def constellation_dqpsk() -> Constellation:
    """digital_constellation_dqpsk."""
    s = 1 / np.sqrt(2)
    pts = [s * (1 + 1j), s * (-1 + 1j), s * (-1 - 1j), s * (1 - 1j)]
    return Constellation(pts, [0, 1, 3, 2], rotational_symmetry=4)


def constellation_8psk() -> Constellation:
    """digital_constellation_8psk (gray-coded)."""
    angles = 2 * np.pi * np.arange(8) / 8
    pts = np.exp(1j * angles)
    gray = [0, 1, 3, 2, 7, 6, 4, 5]
    order = np.argsort(gray)
    return Constellation(pts, gray, rotational_symmetry=8)


def psk_constellation(m: int) -> Constellation:
    """psk.py constellation factory: gray-coded M-PSK."""
    angles = 2 * np.pi * np.arange(m) / m
    pts = np.exp(1j * angles).astype(np.complex64)
    gray = [i ^ (i >> 1) for i in range(m)]
    return Constellation(pts, gray, rotational_symmetry=m)


def qam_constellation(m: int) -> Constellation:
    """qam.py factory: square gray-coded M-QAM, unit average energy."""
    side = int(np.sqrt(m))
    if side * side != m:
        raise ValueError("QAM arity must be a perfect square")
    lv = np.arange(side) * 2 - (side - 1)
    re, im = np.meshgrid(lv, lv)
    pts = (re + 1j * im).reshape(-1)
    pts = pts / np.sqrt((np.abs(pts) ** 2).mean())

    def gray(x):
        return x ^ (x >> 1)

    codes = np.array([
        (gray(i // side) << int(np.log2(side))) | gray(i % side)
        for i in range(m)
    ])
    return Constellation(pts.astype(np.complex64), codes,
                         rotational_symmetry=4)


def fsk4_symbols(deviation: float = 1.0) -> np.ndarray:
    """DMR-style 4FSK frequency symbols (dibit -> frequency level):
    standard mapping 01,00,10,11 -> +3,+1,-1,-3 (x deviation/3)."""
    lut = {0b01: 3.0, 0b00: 1.0, 0b10: -1.0, 0b11: -3.0}
    return np.array([lut[i] for i in range(4)], np.float32) * (deviation / 3.0)
