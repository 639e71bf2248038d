"""Adaptive equalizers: CMA, LMS decision-directed, kurtotic.

Analogs (gr-digital, SURVEY.md §2.7): digital_cma_equalizer_cc,
digital_lms_dd_equalizer_cc, digital_kurtotic_equalizer_cc — all built on
gr_adaptive_fir_ccc (per-output tap update).

The tap-update recurrence is a lax.scan carrying the tap
vector; each step is one K-tap dot + rank-1 update (VPU).  Sample-rate
operation (sps=1 after matched filtering / decimation), like the reference
blocks' typical use.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port
from grtpu.digital.constellation import Constellation


def _window_scan(x, ntaps):
    """Windows w[t] = x[t : t + ntaps] reversed (newest first), built once
    vectorized (the scan then just indexes rows)."""
    n = x.shape[0] - (ntaps - 1)
    idx = jnp.arange(n)[:, None] + jnp.arange(ntaps - 1, -1, -1)[None, :]
    return x[idx]  # (n, ntaps), newest sample first


def cma_equalize(x: jnp.ndarray, taps: jnp.ndarray, modulus: float,
                 mu: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Constant-modulus algorithm (digital_cma_equalizer_cc):
    error = y (|y|^2 - modulus); taps -= mu * err * conj(window)
    (the Wirtinger steepest-descent direction for y = taps . window).

    x carries ntaps-1 history samples.  Returns (y, taps')."""
    ntaps = taps.shape[0]
    wins = _window_scan(x, ntaps)

    def f(tp, w):
        y = (tp * w).sum()
        err = y * (jnp.abs(y) ** 2 - modulus)
        tp2 = tp - mu * err * jnp.conj(w)
        return tp2, y

    taps2, y = jax.lax.scan(f, taps, wins)
    return y.astype(jnp.complex64), taps2


def lms_dd_equalize(x: jnp.ndarray, taps: jnp.ndarray,
                    points: jnp.ndarray, mu: float):
    """Decision-directed LMS (digital_lms_dd_equalizer_cc):
    error = decision(y) - y; taps += mu * err * conj(window)."""
    ntaps = taps.shape[0]
    wins = _window_scan(x, ntaps)

    def f(tp, w):
        y = (tp * w).sum()
        d = points[jnp.argmin(jnp.abs(y - points) ** 2)]
        err = d - y
        tp2 = tp + mu * err * jnp.conj(w)
        return tp2, y

    taps2, y = jax.lax.scan(f, taps, wins)
    return y.astype(jnp.complex64), taps2


def kurtotic_equalize(x: jnp.ndarray, taps: jnp.ndarray, mu: float,
                      stats: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]):
    """Sign-kurtosis-maximizing blind equalizer
    (digital_kurtotic_equalizer_cc, after Guo/Zhao/Sun 2004).

    Running moments p = E|y|^2, q = E y^2, m4 = E|y|^4 (EWMA, alpha=0.01)
    form the kurtosis u = m4 - 2p^2 - q^2; the tap-update direction is the
    reference's error term — sign(u) (componentwise 0/1 indicator on
    re/im), scaled by 1/p^3, minus |u| conj(y), with each component
    clipped to +-1 (digital_kurtotic_equalizer_cc.h:67-102) — which is
    what keeps the blind loop stable.  taps += mu * window * error.
    """
    ntaps = taps.shape[0]
    wins = _window_scan(x, ntaps)
    alpha = 0.01
    eps = 1e-12

    def f(carry, w):
        tp, p, q, m4 = carry
        y = (tp * w).sum()
        nrm = jnp.abs(y) ** 2
        cnj = jnp.conj(y)
        p = (1 - alpha) * p + alpha * nrm + eps
        q = (1 - alpha) * q + alpha * y * y + (eps + 1j * eps)
        m4 = (1 - alpha) * m4 + alpha * nrm * nrm + eps
        u = m4 - 2.0 * p * p - q * q
        sgn = ((u.real >= 0).astype(jnp.float32)
               + 1j * (u.imag >= 0).astype(jnp.float32))
        F = (1.0 / (p * p * p)) * (
            sgn * (nrm * cnj - 2.0 * p * cnj - jnp.conj(q) * y)
            - jnp.abs(u) * cnj)
        err = (jnp.clip(F.real, -1.0, 1.0)
               + 1j * jnp.clip(F.imag, -1.0, 1.0))
        tp2 = tp + mu * w * err
        return (tp2, p, q, m4), y

    (taps2, p, q, m4), y = jax.lax.scan(f, (taps, *stats), wins)
    return y.astype(jnp.complex64), taps2, (p, q, m4)


def center_spike_taps(ntaps: int) -> np.ndarray:
    t = np.zeros(ntaps, np.complex64)
    t[ntaps // 2] = 1.0
    return t


class CmaEqualizer(Block):
    """digital_cma_equalizer_cc block wrapper (sps=1)."""

    def __init__(self, num_taps: int = 11, modulus: float = 1.0,
                 mu: float = 0.01, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.num_taps, self.modulus, self.mu = num_taps, modulus, mu

    def init_state(self):
        return jnp.asarray(center_spike_taps(self.num_taps))

    def apply(self, state, x):
        y, taps = cma_equalize(x, state, self.modulus, self.mu)
        return taps, y


class KurtoticEqualizer(Block):
    """digital_kurtotic_equalizer_cc block wrapper (sps=1).

    Connectable graph surface over kurtotic_equalize(): state carries the
    tap vector plus the running moments (p = E|y|^2, q = E y^2,
    m4 = E|y|^4) that drive the kurtosis-sign error term.
    """

    def __init__(self, num_taps: int = 15, mu: float = 0.01, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.num_taps, self.mu = num_taps, mu

    def init_state(self):
        # reference inits taps[0] = 1 (digital_kurtotic_equalizer_cc.cc:39)
        t0 = np.zeros(self.num_taps, np.complex64)
        t0[0] = 1.0
        return (jnp.asarray(t0),
                (jnp.zeros((), jnp.float32),
                 jnp.zeros((), jnp.complex64),
                 jnp.zeros((), jnp.float32)))

    def apply(self, state, x):
        taps, stats = state
        y, taps2, stats2 = kurtotic_equalize(x, taps, self.mu, stats)
        return (taps2, stats2), y


class LmsDdEqualizer(Block):
    """digital_lms_dd_equalizer_cc block wrapper."""

    def __init__(self, constellation: Constellation, num_taps: int = 11,
                 mu: float = 0.01, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = (Port(jnp.complex64),)
        self.history = num_taps
        super().__init__(name)
        self.points = np.asarray(constellation.points, np.complex64)
        self.num_taps, self.mu = num_taps, mu

    def init_state(self):
        return jnp.asarray(center_spike_taps(self.num_taps))

    def apply(self, state, x):
        y, taps = lms_dd_equalize(x, state, jnp.asarray(self.points), self.mu)
        return taps, y
