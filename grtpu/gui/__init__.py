"""Headless GUI-sink analogs: spectrum/waterfall/scope/constellation/
number/histogram displays rendered to PNG.

Analogs of gr-qtgui (qtgui_sink_{c,f}, qtgui_time_sink — FFT + waterfall +
time + constellation tabs over SpectrumGUIClass) and gr-wxgui
(fftsink2.py, waterfall_window.py, scopesink2.py, constsink_gl.py,
numbersink2.py, histosink.py).  The windowing/averaging/trigger MATH of
those sinks is kept exactly; the interactive toolkit is replaced with
offline matplotlib rendering (SURVEY.md §7 declares live GUIs a non-goal —
on a headless accelerator host the artifact of record is a file).

Each sink is a normal grtpu Block: connect it in a Graph, run the
executor, then call ``render(path)`` (and/or the numeric accessors, which
are what the tests pin down).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import jax.numpy as jnp

from grtpu.runtime.block import Block, Port
from grtpu.blocks.oscope import OscopeSink


def _mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _win(name: str, n: int) -> np.ndarray:
    from grtpu.utils import firdes

    table = {
        "blackmanharris": firdes.Window.BLACKMAN_HARRIS,
        "hamming": firdes.Window.HAMMING,
        "hann": firdes.Window.HANN,
        "blackman": firdes.Window.BLACKMAN,
        "rectangular": firdes.Window.RECTANGULAR,
    }
    return np.asarray(firdes.window(table[name], n), np.float32)


class FftSink(Block):
    """qtgui_sink FFT tab / wxgui fftsink2: averaged log-power spectrum.

    Math matches blks2impl/logpwrfft.py: windowed FFT frames,
    10*log10(|X|^2) with the window's power gain normalized out, running
    single-pole average over frames (avg_alpha), fftshift for complex
    input.
    """

    def __init__(self, fft_size: int = 1024, sample_rate: float = 1.0,
                 window: str = "blackmanharris", avg_alpha: float = 1.0,
                 ref_scale: float = 2.0, dtype=jnp.complex64, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.fft_size = fft_size
        self.sample_rate = sample_rate
        self.avg_alpha = avg_alpha
        self.ref_scale = ref_scale
        self.window_name = window
        self.captured = None
        self._complex = jnp.dtype(dtype) == jnp.complex64

    def apply(self, state, x):
        return state, ()

    def spectra(self) -> np.ndarray:
        """All per-frame log-power spectra, (n_frames, fft_size) dB."""
        if self.captured is None:
            return np.zeros((0, self.fft_size), np.float32)
        x = np.asarray(self.captured[0])
        n = self.fft_size
        nf = len(x) // n
        if nf == 0:
            return np.zeros((0, n), np.float32)
        w = _win(self.window_name, n)
        fr = x[: nf * n].reshape(nf, n) * w
        X = np.fft.fft(fr, axis=1)
        if self._complex:
            X = np.fft.fftshift(X, axes=1)
        # the reference's exact scaling (blks2impl/logpwrfft.py nlog10_ff
        # constant): 20log10|X| - 20log10 N - 10log10(sum(w^2)/N)
        # - 20log10(ref_scale/2); a full-scale (ref_scale/2-amplitude)
        # tone reads 0 dB regardless of window/size.
        k = (-20.0 * np.log10(n)
             - 10.0 * np.log10(np.sum(w ** 2) / n)
             - 20.0 * np.log10(self.ref_scale / 2.0))
        mag2 = np.maximum(np.abs(X) ** 2, 1e-40)
        return (10.0 * np.log10(mag2) + k).astype(np.float32)

    def spectrum(self) -> np.ndarray:
        """Averaged spectrum (dB): single-pole IIR over frames with
        avg_alpha (avg_alpha=1 -> last frame), like set_avg_alpha."""
        s = self.spectra()
        if len(s) == 0:
            return np.full(self.fft_size, -200.0, np.float32)
        lin = 10.0 ** (s / 10.0)
        acc = lin[0]
        for fr in lin[1:]:
            acc = acc + self.avg_alpha * (fr - acc)
        return (10.0 * np.log10(np.maximum(acc, 1e-20))).astype(np.float32)

    def freqs(self) -> np.ndarray:
        """Display frequency axis: full shifted axis for complex input,
        the one-sided 0..fs/2 half for real input (the other half is the
        mirror image — wxgui fftsink2 shows the same half)."""
        n, fs = self.fft_size, self.sample_rate
        if self._complex:
            return np.fft.fftshift(np.fft.fftfreq(n, 1.0 / fs))
        return np.fft.rfftfreq(n, 1.0 / fs)

    def _display(self, s: np.ndarray) -> np.ndarray:
        """Slice spectra rows to match freqs() for real input."""
        if self._complex or s.shape[-1] == 0:
            return s
        return s[..., : self.fft_size // 2 + 1]

    def render(self, path: str, title: str = "spectrum") -> str:
        plt = _mpl()
        fig, ax = plt.subplots(figsize=(9, 4.5))
        ax.plot(self.freqs(), self._display(self.spectrum()), lw=0.8)
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel("power [dB]")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


class WaterfallSink(FftSink):
    """qtgui waterfall tab / wxgui waterfall_window: time-frequency raster
    of the per-frame spectra."""

    def render(self, path: str, title: str = "waterfall") -> str:
        plt = _mpl()
        s = self._display(self.spectra())
        fig, ax = plt.subplots(figsize=(9, 5))
        if len(s):
            t_span = len(s) * self.fft_size / self.sample_rate
            f = self.freqs()
            ax.imshow(s, aspect="auto", origin="lower",
                      extent=[f[0], f[-1], 0, t_span], cmap="viridis")
        ax.set_xlabel("frequency [Hz]")
        ax.set_ylabel("time [s]")
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


class ScopeSink(OscopeSink):
    """wxgui scopesink2 / qtgui time tab: triggered traces (the
    gr_oscope_guts trigger engine) rendered as an oscillogram."""

    def __init__(self, frame_size: int = 1024, sample_rate: float = 1.0,
                 dtype=jnp.float32, name=None):
        super().__init__(frame_size, dtype, name)
        self.sample_rate = sample_rate

    def render(self, path: str, level: float = 0.0, slope: str = "pos",
               mode: str = "auto", max_frames: int = 4,
               title: str = "scope") -> str:
        plt = _mpl()
        frames = self.frames(level, slope, mode, max_frames)
        fig, ax = plt.subplots(figsize=(9, 4.5))
        t = np.arange(self.frame_size) / self.sample_rate
        for fr in frames:
            if np.iscomplexobj(fr):
                ax.plot(t, fr.real, lw=0.8, color="C0", alpha=0.7)
                ax.plot(t, fr.imag, lw=0.8, color="C1", alpha=0.7)
            else:
                ax.plot(t, fr, lw=0.8, alpha=0.8)
        ax.set_xlabel("time [s]")
        ax.set_ylabel("amplitude")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


class ConstSink(Block):
    """qtgui constellation tab / wxgui constsink_gl: I/Q scatter."""

    def __init__(self, max_points: int = 4096, name=None):
        self.in_ports = (Port(jnp.complex64),)
        self.out_ports = ()
        super().__init__(name)
        self.max_points = max_points
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def points(self) -> np.ndarray:
        if self.captured is None:
            return np.zeros(0, np.complex64)
        return np.asarray(self.captured[0])[-self.max_points:]

    def render(self, path: str, title: str = "constellation") -> str:
        plt = _mpl()
        p = self.points()
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(p.real, p.imag, s=2, alpha=0.4)
        ax.set_xlabel("I")
        ax.set_ylabel("Q")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        ax.set_aspect("equal")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


class NumberSink(Block):
    """wxgui numbersink2: a scalar meter over the stream (running
    single-pole average, like the wxgui sink's avg option)."""

    def __init__(self, avg_alpha: float = 0.05, dtype=jnp.float32,
                 name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.avg_alpha = avg_alpha
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def trajectory(self) -> np.ndarray:
        """The running-average trajectory over the captured stream."""
        if self.captured is None:
            return np.zeros(0, np.float32)
        x = np.asarray(self.captured[0])
        if np.iscomplexobj(x):
            x = np.abs(x)  # complex meter reads magnitude
        x = x.astype(np.float64)
        a = self.avg_alpha
        from scipy.signal import lfilter
        y = lfilter([a], [1.0, -(1.0 - a)], x, zi=[0.0])[0]
        return y.astype(np.float32)

    def value(self) -> float:
        h = self.trajectory()
        return float(h[-1]) if len(h) else 0.0

    def render(self, path: str, title: str = "number",
               unit: str = "") -> str:
        plt = _mpl()
        h = self.trajectory()
        fig, ax = plt.subplots(figsize=(6, 3))
        ax.plot(h, lw=0.9)
        val = f"{self.value():.4g}{unit}"
        ax.set_title(f"{title}: {val}")
        ax.grid(True, alpha=0.3)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


class HistoSinkDisplay(Block):
    """gr_histo_sink_f / wxgui histosink: amplitude histogram."""

    def __init__(self, nbins: int = 64, name=None):
        self.in_ports = (Port(jnp.float32),)
        self.out_ports = ()
        super().__init__(name)
        self.nbins = nbins
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def histogram(self):
        if self.captured is None:
            return np.zeros(self.nbins), np.linspace(0, 1, self.nbins + 1)
        x = np.asarray(self.captured[0])
        return np.histogram(x, bins=self.nbins)

    def render(self, path: str, title: str = "histogram") -> str:
        plt = _mpl()
        counts, edges = self.histogram()
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.bar(edges[:-1], counts, width=np.diff(edges), align="edge")
        ax.set_title(title)
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return path


__all__ = ["FftSink", "WaterfallSink", "ScopeSink", "ConstSink",
           "NumberSink", "HistoSinkDisplay"]
