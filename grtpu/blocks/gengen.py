"""Elementwise / generated ops: the gengen layer.

Analog of gnuradio-core/src/lib/gengen (SURVEY.md §2.5): add, add_const,
sub, multiply, multiply_const, divide, and/or/xor/not, integrate,
moving_average, argmax, max, mute, sample_and_hold, peak_detector,
sig_source_X, noise_source_X, vector_source_X / vector_sink_X,
chunks_to_symbols_XX, packed_to_unpacked_XX / unpacked_to_packed_XX.

The reference instantiates one C++ class per (op, type-suffix) via Cheetah
codegen; here each op is a single dtype-parameterized Block class (XLA
specializes per dtype at trace time), with gr-style suffix factories
(``add_ff``, ``multiply_const_cc``, ...) provided for API parity.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port


# --------------------------------------------------------------------- n-ary
class _NaryElementwise(Block):
    """N inputs -> one output, elementwise, stateless."""

    _op = None

    def __init__(self, dtype=jnp.float32, nin: int = 2, vlen: int = 1, name=None):
        self.in_ports = tuple(Port(dtype, vlen) for _ in range(nin))
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, *xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = self._combine(acc, x)
        return state, acc

    def _combine(self, a, b):
        raise NotImplementedError


class Add(_NaryElementwise):
    def _combine(self, a, b):
        return a + b


class Sub(_NaryElementwise):
    def _combine(self, a, b):
        return a - b


class Multiply(_NaryElementwise):
    def _combine(self, a, b):
        return a * b


class Divide(_NaryElementwise):
    def _combine(self, a, b):
        return a / b


class And(_NaryElementwise):
    def _combine(self, a, b):
        return a & b


class Or(_NaryElementwise):
    def _combine(self, a, b):
        return a | b


class Xor(_NaryElementwise):
    def _combine(self, a, b):
        return a ^ b


class Not(Block):
    def __init__(self, dtype=jnp.int32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, x):
        return state, ~x


# ------------------------------------------------------------------- x_const
class AddConst(Block):
    def __init__(self, k, dtype=jnp.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = np.dtype(dtype).type(k)

    def apply(self, state, x):
        return state, x + self.k

    def set_k(self, k):
        self.k = np.dtype(self.in_ports[0].dtype).type(k)
        self.touch()


class MultiplyConst(Block):
    def __init__(self, k, dtype=jnp.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)
        self.k = np.dtype(dtype).type(k)

    def apply(self, state, x):
        return state, x * self.k

    def set_k(self, k):
        self.k = np.dtype(self.in_ports[0].dtype).type(k)
        self.touch()


class AndConst(Block):
    def __init__(self, k, dtype=jnp.uint8, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.k = int(k)

    def apply(self, state, x):
        return state, x & np.dtype(x.dtype).type(self.k)


# ----------------------------------------------------------------- stateful
class Integrate(Block):
    """Decimating integrator: sum groups of ``decim`` samples
    (gengen gr_integrate_XX)."""

    def __init__(self, decim: int, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.decim = decim
        super().__init__(name)

    def apply(self, state, x):
        n = x.shape[0]
        return state, x.reshape(n // self.decim, self.decim).sum(axis=1)


class MovingAverage(Block):
    """Sliding-window sum scaled by ``scale`` (gr_moving_average_XX).

    Uses executor-managed history for exact cross-chunk windows; computed as
    a cumulative-sum difference (O(n), bandwidth-bound — fused by XLA).
    """

    def __init__(self, length: int, scale=1, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.length = length
        self.scale = scale
        self.history = length
        super().__init__(name)

    def apply(self, state, x):
        # x has length n + length - 1; output n sliding sums.
        acc_dtype = jnp.float32 if x.dtype == jnp.float32 else (
            jnp.complex64 if jnp.issubdtype(x.dtype, jnp.complexfloating) else jnp.int64
        )
        c = jnp.cumsum(x.astype(acc_dtype))
        c = jnp.concatenate([jnp.zeros((1,), acc_dtype), c])
        win = c[self.length:] - c[:-self.length]
        return state, (win * self.scale).astype(x.dtype)


class SampleAndHold(Block):
    """Output held input value gated by a control stream
    (gr_sample_and_hold_XX): out[i] = in[i] if ctrl[i] else previous held."""

    def __init__(self, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype), Port(jnp.uint8))
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self._dtype = dtype

    def init_state(self):
        return jnp.zeros((), self._dtype)

    def apply(self, state, x, ctrl):
        def f(held, inp):
            v, c = inp
            held = jnp.where(c != 0, v, held)
            return held, held

        held, y = jax.lax.scan(f, state, (x, ctrl))
        return held, y


class PeakDetector(Block):
    """Flag the peak of each burst above a threshold envelope
    (gr_peak_detector_XX semantics: tracks a running peak between
    threshold crossings; emits 1 at the peak sample)."""

    def __init__(self, threshold_factor_rise=0.25, threshold_factor_fall=0.40,
                 look_ahead=10, alpha=0.001, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(jnp.uint8),)
        super().__init__(name)
        self.tfr, self.tff = threshold_factor_rise, threshold_factor_fall
        self.alpha = alpha

    def init_state(self):
        # (avg, peak_val, peak_ind_rel, in_burst)
        return (jnp.zeros(()), jnp.zeros(()), jnp.zeros((), jnp.int32),
                jnp.zeros((), jnp.bool_))

    def apply(self, state, x):
        alpha, tfr, tff = self.alpha, self.tfr, self.tff
        n = x.shape[0]

        def f(carry, inp):
            avg, peak, peak_i, burst = carry
            v, i = inp
            avg = (1 - alpha) * avg + alpha * v
            start = (~burst) & (v > avg * (1 + tfr))
            burst2 = burst | start
            better = burst2 & (v > peak)
            peak2 = jnp.where(better, v, jnp.where(start, v, peak))
            peak_i2 = jnp.where(better | start, i, peak_i)
            end = burst2 & (v < avg * (1 - tff))
            emit = jnp.where(end, peak_i2, -1)
            burst3 = burst2 & (~end)
            return (avg, jnp.where(end, 0.0, peak2), peak_i2, burst3), emit

        idx = jnp.arange(n, dtype=jnp.int32)
        carry, emits = jax.lax.scan(f, state, (x.astype(jnp.float32), idx))
        out = jnp.zeros((n,), jnp.uint8)
        valid = emits >= 0
        out = out.at[jnp.where(valid, emits, 0)].set(
            jnp.where(valid, 1, out[jnp.where(valid, emits, 0)]).astype(jnp.uint8))
        return carry, out


class Argmax(Block):
    """Per-vector argmax (gr_argmax_XX): vlen-vector in, index out."""

    def __init__(self, vlen: int, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(jnp.int16),)
        super().__init__(name)

    def apply(self, state, x):
        return state, jnp.argmax(x, axis=-1).astype(jnp.int16)


class Max(Block):
    """Per-vector max (gr_max_XX)."""

    def __init__(self, vlen: int, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)

    def apply(self, state, x):
        return state, jnp.max(x, axis=-1)


class Mute(Block):
    def __init__(self, mute: bool = False, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.muted = mute

    def set_mute(self, m: bool):
        self.muted = m
        self.touch()

    def apply(self, state, x):
        return state, jnp.where(self.muted, jnp.zeros_like(x), x)


# ----------------------------------------------------------------- sources
class VectorSource(Block):
    """Repeat (or play once) a fixed vector (gengen gr_vector_source_X)."""

    def __init__(self, data, repeat: bool = False, dtype=None, vlen: int = 1, name=None):
        arr = np.asarray(data)
        if dtype is not None:
            arr = arr.astype(np.dtype(dtype))
        self.out_ports = (Port(arr.dtype, vlen),)
        super().__init__(name)
        if vlen > 1:
            arr = arr.reshape(-1, vlen)
        self.data = arr
        self.repeat = repeat

    def init_state(self):
        return jnp.zeros((), jnp.int32)  # read position

    def apply(self, state, n: int):
        m = self.data.shape[0]
        idx = (state + jnp.arange(n)) % m
        y = jnp.asarray(self.data)[idx]
        if not self.repeat:
            # past-the-end samples are zeroed (finite runs use gr_head/run())
            mask = (state + jnp.arange(n)) < m
            shape = (n,) + (1,) * (y.ndim - 1)
            y = y * mask.reshape(shape).astype(y.dtype)
        return (state + n) % np.int32(m) if self.repeat else state + n, y


class NullSource(Block):
    def __init__(self, dtype=jnp.float32, vlen: int = 1, name=None):
        self.out_ports = (Port(dtype, vlen),)
        super().__init__(name)

    def apply(self, state, n: int):
        return state, jnp.zeros(self.out_ports[0].chunk_shape(n),
                                self.out_ports[0].dtype)


class NoiseSource(Block):
    """Gaussian/uniform noise source (gr_noise_source_X + gr_random).

    Carried state is a JAX PRNG key — reproducible, checkpointable, and
    splittable across shards (unlike the reference's global C++ RNG).
    """

    def __init__(self, kind: str = "gaussian", amplitude: float = 1.0,
                 seed: int = 0, dtype=jnp.float32, name=None):
        self.out_ports = (Port(dtype),)
        super().__init__(name)
        self.kind = kind
        self.amplitude = amplitude
        self.seed = seed
        self._dtype = jnp.dtype(dtype)

    def init_state(self):
        return jax.random.PRNGKey(self.seed)

    def apply(self, state, n: int):
        key, sub = jax.random.split(state)
        complex_out = jnp.issubdtype(self._dtype, jnp.complexfloating)
        if self.kind == "gaussian":
            if complex_out:
                r = jax.random.normal(sub, (n, 2), jnp.float32)
                y = (r[:, 0] + 1j * r[:, 1]) * (self.amplitude / np.sqrt(2))
                y = y.astype(self._dtype)
            else:
                y = (jax.random.normal(sub, (n,), jnp.float32)
                     * self.amplitude).astype(self._dtype)
        elif self.kind == "uniform":
            if complex_out:
                r = jax.random.uniform(sub, (n, 2), jnp.float32, -1.0, 1.0)
                y = ((r[:, 0] + 1j * r[:, 1]) * self.amplitude).astype(self._dtype)
            else:
                y = (jax.random.uniform(sub, (n,), jnp.float32, -1.0, 1.0)
                     * self.amplitude).astype(self._dtype)
        else:
            raise ValueError(f"unknown noise kind {self.kind}")
        return key, y


# ------------------------------------------------------------------- sinks
class VectorSink(Block):
    """Collect everything into a host array (gr_vector_sink_X).

    After ``executor.run(...)`` the samples are in ``self.captured[0]``
    (also exposed as :meth:`data`).
    """

    def __init__(self, dtype=jnp.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def data(self):
        return None if self.captured is None else np.asarray(self.captured[0])


class NullSink(Block):
    def __init__(self, dtype=jnp.float32, vlen: int = 1, name=None):
        self.in_ports = (Port(dtype, vlen),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()


class ProbeSignal(Block):
    """Expose the most recent sample to the host (gr_probe_signal_f)."""

    def __init__(self, dtype=jnp.float32, name=None):
        self.in_ports = (Port(dtype),)
        self.out_ports = ()
        super().__init__(name)
        self.captured = None

    def apply(self, state, x):
        return state, ()

    def level(self):
        return None if self.captured is None else np.asarray(self.captured[0])[-1]


# ------------------------------------------------------- symbol/bit packing
class ChunksToSymbols(Block):
    """Map integer chunks to symbol-table entries
    (gengen gr_chunks_to_symbols_XX: out[i] = table[in[i]])."""

    def __init__(self, symbol_table, in_dtype=jnp.uint8, out_dtype=jnp.complex64,
                 dimension: int = 1, name=None):
        self.in_ports = (Port(in_dtype),)
        self.out_ports = (Port(out_dtype),)
        self.interp = dimension
        super().__init__(name)
        self.table = np.asarray(np.asarray(symbol_table), out_dtype)
        self.dimension = dimension

    def apply(self, state, x):
        idx = x.astype(jnp.int32)
        table = jnp.asarray(self.table)
        if self.dimension == 1:
            return state, table[idx]
        t = table.reshape(-1, self.dimension)
        return state, t[idx].reshape(-1)


class PackedToUnpacked(Block):
    """Explode packed bytes into k-bit chunks, MSB first
    (gr_packed_to_unpacked_XX with GR_MSB_FIRST)."""

    def __init__(self, bits_per_chunk: int = 1, dtype=jnp.uint8, name=None):
        assert 8 % bits_per_chunk == 0, "bits_per_chunk must divide 8"
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.interp = 8 // bits_per_chunk
        super().__init__(name)
        self.k = bits_per_chunk

    def apply(self, state, x):
        k, m = self.k, self.interp
        shifts = jnp.arange(m - 1, -1, -1, dtype=jnp.int32) * k
        mask = (1 << k) - 1
        out = (x[:, None].astype(jnp.int32) >> shifts[None, :]) & mask
        return state, out.reshape(-1).astype(x.dtype)


class UnpackedToPacked(Block):
    """Pack k-bit chunks into bytes, MSB first (gr_unpacked_to_packed_XX)."""

    def __init__(self, bits_per_chunk: int = 1, dtype=jnp.uint8, name=None):
        assert 8 % bits_per_chunk == 0
        self.in_ports = (Port(dtype),)
        self.out_ports = (Port(dtype),)
        self.decim = 8 // bits_per_chunk
        super().__init__(name)
        self.k = bits_per_chunk

    def apply(self, state, x):
        k, m = self.k, self.decim
        g = x.reshape(-1, m).astype(jnp.int32)
        shifts = jnp.arange(m - 1, -1, -1, dtype=jnp.int32) * k
        mask = (1 << k) - 1
        packed = ((g & mask) << shifts[None, :]).sum(axis=1)
        return state, packed.astype(x.dtype)


class PackKBits(Block):
    """gr_pack_k_bits_bb: pack k input bits (LSB of each byte) per output."""

    def __init__(self, k: int, name=None):
        self.in_ports = (Port(jnp.uint8),)
        self.out_ports = (Port(jnp.uint8),)
        self.decim = k
        super().__init__(name)
        self.k = k

    def apply(self, state, x):
        g = x.reshape(-1, self.k).astype(jnp.int32) & 1
        shifts = jnp.arange(self.k - 1, -1, -1, dtype=jnp.int32)
        return state, (g << shifts[None, :]).sum(axis=1).astype(jnp.uint8)


class UnpackKBits(Block):
    """gr_unpack_k_bits_bb: one bit per output byte, MSB first within k."""

    def __init__(self, k: int, name=None):
        self.in_ports = (Port(jnp.uint8),)
        self.out_ports = (Port(jnp.uint8),)
        self.interp = k
        super().__init__(name)
        self.k = k

    def apply(self, state, x):
        shifts = jnp.arange(self.k - 1, -1, -1, dtype=jnp.int32)
        out = (x[:, None].astype(jnp.int32) >> shifts[None, :]) & 1
        return state, out.reshape(-1).astype(jnp.uint8)


class MapBB(Block):
    """gr_map_bb: out = table[in]."""

    def __init__(self, table: Sequence[int], name=None):
        self.in_ports = (Port(jnp.uint8),)
        self.out_ports = (Port(jnp.uint8),)
        super().__init__(name)
        self.table = np.asarray(table, np.uint8)

    def apply(self, state, x):
        return state, jnp.asarray(self.table)[x.astype(jnp.int32)]


# ---------------------------------------------------------- suffix aliases
def _suffix_factories():
    """gr-style typed factories: add_ff, multiply_cc, ... (API parity)."""
    suffix_dtype = {
        "b": jnp.uint8, "s": jnp.int16, "i": jnp.int32,
        "f": jnp.float32, "c": jnp.complex64,
    }
    out = {}
    for opname, cls in [("add", Add), ("sub", Sub), ("multiply", Multiply),
                        ("divide", Divide)]:
        for sfx, dt in suffix_dtype.items():
            out[f"{opname}_{sfx}{sfx}"] = functools.partial(cls, dtype=dt)
    for opname, cls in [("add_const", AddConst), ("multiply_const", MultiplyConst)]:
        for sfx, dt in suffix_dtype.items():
            out[f"{opname}_{sfx}{sfx}"] = functools.partial(cls, dtype=dt)
    for sfx, dt in suffix_dtype.items():
        out[f"vector_source_{sfx}"] = functools.partial(VectorSource, dtype=dt)
        out[f"vector_sink_{sfx}"] = functools.partial(VectorSink, dtype=dt)
        out[f"null_source_{sfx}"] = functools.partial(NullSource, dtype=dt)
        out[f"null_sink_{sfx}"] = functools.partial(NullSink, dtype=dt)
        out[f"noise_source_{sfx}"] = functools.partial(NoiseSource, dtype=dt)
    return out


globals().update(_suffix_factories())
