"""Runtime core tests: graph construction, flatten, rates, halo, state.

Models the reference's tier-2 QA pattern (SURVEY.md §4): tiny graph
vector_source -> block -> vector_sink, run, compare.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from grtpu import Graph, HierBlock, StreamExecutor
from grtpu.runtime.block import Block, Port
from grtpu.blocks.gengen import (
    Add, AddConst, Multiply, MultiplyConst, MovingAverage, Integrate,
    VectorSink, PackedToUnpacked, UnpackedToPacked, ChunksToSymbols,
    UnpackKBits, PackKBits,
)
from grtpu.blocks.stream import (
    Copy, Delay, Deinterleave, Interleave, KeepOneInN, Repeat,
    StreamToVector, VectorToStream,
)
from grtpu.blocks.convert import ComplexToMag, FloatToComplex


def run_chain(blocks, x, chunk=64, dtype=jnp.float32):
    """Helper: pad-in -> chain -> pad-out executor run."""
    g = Graph()
    pin = g.add_input(blocks[0].in_ports[0])
    pout = g.add_output(blocks[-1].out_ports[0])
    g.connect(pin, *blocks, pout)
    ex = StreamExecutor(g, chunk_size=chunk)
    return np.asarray(ex.run(jnp.asarray(x)))


class TestBasicGraph:
    def test_identity_chain(self):
        x = np.arange(128, dtype=np.float32)
        y = run_chain([Copy(), Copy()], x)
        np.testing.assert_array_equal(x, y)

    def test_add_const_multiply(self):
        x = np.arange(100, dtype=np.float32)
        y = run_chain([AddConst(2.0), MultiplyConst(3.0)], x, chunk=32)
        np.testing.assert_allclose(y, (x + 2) * 3, rtol=1e-6)

    def test_two_port_add(self):
        g = Graph()
        p0 = g.add_input(Port(jnp.float32))
        p1 = g.add_input(Port(jnp.float32))
        add = Add(nin=2)
        out = g.add_output(Port(jnp.float32))
        g.connect(p0, (add, 0))
        g.connect(p1, (add, 1))
        g.connect(add, out)
        ex = StreamExecutor(g, chunk_size=16)
        a = np.arange(48, dtype=np.float32)
        b = np.ones(48, dtype=np.float32)
        y = ex.run(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(y), a + b)

    def test_fanout(self):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        c = Copy()
        m = Multiply(nin=2)
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, c)
        g.connect(c, (m, 0))
        g.connect(c, (m, 1))
        g.connect(m, out)
        ex = StreamExecutor(g, chunk_size=32)
        x = np.arange(64, dtype=np.float32)
        y = ex.run(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), x * x)

    def test_sink_capture(self):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        sink = VectorSink()
        g.connect(pin, AddConst(1.0), sink)
        ex = StreamExecutor(g, chunk_size=16)
        x = np.arange(32, dtype=np.float32)
        ex.run(jnp.asarray(x))
        np.testing.assert_allclose(sink.data(), x + 1)

    def test_type_mismatch_raises(self):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        with pytest.raises(ValueError, match="type mismatch"):
            g.connect(pin, ComplexToMag())


class TestRates:
    def test_decimation(self):
        x = np.arange(64, dtype=np.float32)
        y = run_chain([KeepOneInN(4)], x, chunk=16)
        np.testing.assert_array_equal(y, x[3::4])

    def test_interpolation(self):
        x = np.arange(16, dtype=np.float32)
        y = run_chain([Repeat(3)], x, chunk=8)
        np.testing.assert_array_equal(y, np.repeat(x, 3))

    def test_integrate(self):
        x = np.arange(32, dtype=np.float32)
        y = run_chain([Integrate(4)], x, chunk=16)
        np.testing.assert_allclose(y, x.reshape(-1, 4).sum(1))

    def test_vector_roundtrip(self):
        x = np.arange(64, dtype=np.float32)
        y = run_chain([StreamToVector(jnp.float32, 8),
                       VectorToStream(jnp.float32, 8)], x, chunk=32)
        np.testing.assert_array_equal(x, y)

    def test_bad_chunk_divisibility(self):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, KeepOneInN(7), out)
        with pytest.raises(ValueError, match="not divisible"):
            StreamExecutor(g, chunk_size=16)


class TestHistory:
    def test_moving_average_cross_chunk(self):
        """History halo must be exact across chunk boundaries."""
        x = np.random.RandomState(0).randn(256).astype(np.float32)
        y = run_chain([MovingAverage(10)], x, chunk=32)
        ref = np.convolve(np.concatenate([np.zeros(9, np.float32), x]),
                          np.ones(10, np.float32), mode="valid")
        np.testing.assert_allclose(y, ref, atol=1e-4)

    def test_delay(self):
        x = np.arange(40, dtype=np.float32)
        y = run_chain([Delay(5)], x, chunk=8)
        np.testing.assert_array_equal(y[5:], x[:-5])
        np.testing.assert_array_equal(y[:5], np.zeros(5))


class TestHier:
    def test_hier_flatten(self):
        class PlusTimes(HierBlock):
            def __init__(self):
                super().__init__()
                i = self.graph.add_input(Port(jnp.float32))
                o = self.graph.add_output(Port(jnp.float32))
                self.graph.connect(i, AddConst(1.0), MultiplyConst(2.0), o)

        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, PlusTimes(), out)
        ex = StreamExecutor(g, chunk_size=16)
        x = np.arange(32, dtype=np.float32)
        y = ex.run(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), (x + 1) * 2)

    def test_nested_hier(self):
        class Inner(HierBlock):
            def __init__(self):
                super().__init__()
                i = self.graph.add_input(Port(jnp.float32))
                o = self.graph.add_output(Port(jnp.float32))
                self.graph.connect(i, AddConst(1.0), o)

        class Outer(HierBlock):
            def __init__(self):
                super().__init__()
                i = self.graph.add_input(Port(jnp.float32))
                o = self.graph.add_output(Port(jnp.float32))
                self.graph.connect(i, Inner(), Inner(), o)

        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, Outer(), out)
        ex = StreamExecutor(g, chunk_size=16)
        x = np.zeros(16, dtype=np.float32)
        y = ex.run(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), np.full(16, 2.0))


class TestPacking:
    def test_packed_unpacked_roundtrip(self):
        x = np.random.RandomState(1).randint(0, 256, 64).astype(np.uint8)
        y = run_chain([PackedToUnpacked(1), UnpackedToPacked(1)], x, chunk=32)
        np.testing.assert_array_equal(x, y)

    def test_unpack_k_bits(self):
        x = np.array([0b1011, 0b0001], dtype=np.uint8)
        y = run_chain([UnpackKBits(4)], x, chunk=2)
        np.testing.assert_array_equal(y, [1, 0, 1, 1, 0, 0, 0, 1])

    def test_pack_k_bits(self):
        x = np.array([1, 0, 1, 1, 0, 0, 0, 1], dtype=np.uint8)
        y = run_chain([PackKBits(4)], x, chunk=8)
        np.testing.assert_array_equal(y, [0b1011, 0b0001])

    def test_chunks_to_symbols(self):
        table = np.array([1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j], np.complex64)
        x = np.array([0, 1, 2, 3, 0], dtype=np.uint8)
        g = Graph()
        pin = g.add_input(Port(jnp.uint8))
        out = g.add_output(Port(jnp.complex64))
        g.connect(pin, ChunksToSymbols(table), out)
        ex = StreamExecutor(g, chunk_size=5)
        y = ex.run(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), table[x])


class TestInterleave:
    def test_roundtrip(self):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        d = Deinterleave(2)
        i = Interleave(2)
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, d)
        g.connect((d, 0), (i, 0))
        g.connect((d, 1), (i, 1))
        g.connect(i, out)
        ex = StreamExecutor(g, chunk_size=16)
        x = np.arange(32, dtype=np.float32)
        y = ex.run(jnp.asarray(x))
        np.testing.assert_array_equal(np.asarray(y), x)


class TestState:
    def test_checkpoint_roundtrip(self, tmp_path):
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        out = g.add_output(Port(jnp.float32))
        g.connect(pin, Delay(3), MovingAverage(5), out)
        ex = StreamExecutor(g, chunk_size=16)
        x = np.random.RandomState(2).randn(64).astype(np.float32)
        ex.run(jnp.asarray(x[:32]))
        path = str(tmp_path / "ckpt.npz")
        ex.save_checkpoint(path)

        # Continue from checkpoint in a fresh executor — outputs must match
        # continuing the original.
        y1 = np.asarray(ex.run(jnp.asarray(x[32:])))
        ex2 = StreamExecutor(g, chunk_size=16)
        ex2.load_checkpoint(path)
        y2 = np.asarray(ex2.run(jnp.asarray(x[32:])))
        np.testing.assert_allclose(y1, y2)


class TestHeadSkipHead:
    def test_skiphead_masks_cross_chunk(self):
        from grtpu.blocks.stream import SkipHead
        x = np.arange(24, dtype=np.float32)
        y = run_chain([SkipHead(5)], x, chunk=8)
        np.testing.assert_array_equal(y[:5], np.zeros(5))
        np.testing.assert_array_equal(y[5:], x[5:])

    def test_head_masks_cross_chunk(self):
        from grtpu.blocks.stream import Head
        x = np.arange(24, dtype=np.float32) + 1
        y = run_chain([Head(10)], x, chunk=8)
        np.testing.assert_array_equal(y[:10], x[:10])
        np.testing.assert_array_equal(y[10:], np.zeros(14))



class TestRetuning:
    def test_set_taps_via_lock_unlock(self):
        """Runtime retuning (the reference's set_taps + lock/unlock
        reconfiguration): rebuild re-traces with the new taps while state
        survives."""
        from grtpu.runtime.top_block import TopBlock
        from grtpu.blocks.filter import FirFilter

        taps_a = np.array([1.0, 0, 0, 0], np.float32)
        taps_b = np.array([0, 0, 0, 2.0], np.float32)
        tb = TopBlock(chunk_size=16)
        pin = tb.add_input(Port(jnp.float32))
        f = FirFilter(1, taps_a, "fff", impl="matmul")
        sink = VectorSink()
        tb.connect(pin, f, sink)
        x = np.arange(1, 17, dtype=np.float32)
        tb.run(jnp.asarray(x))
        np.testing.assert_allclose(sink.data()[-8:], x[-8:], atol=1e-5)
        f.set_taps(taps_b)
        tb.lock()
        tb.unlock()
        tb.run(jnp.asarray(x))
        out2 = np.asarray(sink.captured[0])
        # taps [0,0,0,2]: y[i] = 2*x[i-3]
        np.testing.assert_allclose(out2[8:], 2 * x[5:13], atol=1e-5)

    def test_fir_block_sigs(self):
        from grtpu.blocks.filter import FirFilter
        from grtpu.utils.testing import run_block

        rng = np.random.RandomState(9)
        x = rng.randn(64).astype(np.float32)
        taps_c = (rng.randn(5) + 1j * rng.randn(5)).astype(np.complex64)
        # fcc: float in, complex taps, complex out
        y = run_block(FirFilter(1, taps_c, "fcc"), x)
        assert y.dtype == np.complex64
        # fsf: float in/taps, int16 out (clipped/rounded)
        y2 = run_block(FirFilter(1, np.array([1000.0], np.float32), "fsf"), x)
        assert y2.dtype == np.int16
        np.testing.assert_array_equal(
            y2, np.clip(np.round(x * 1000), -32768, 32767))
        # scc: short in, complex taps
        xs = (x * 100).astype(np.int16)
        y3 = run_block(FirFilter(1, taps_c, "scc"), xs)
        assert y3.dtype == np.complex64


class TestGraphPartition:
    def test_partition_components(self):
        from grtpu.runtime.graph import Graph
        from grtpu.blocks.gengen import NullSink, NoiseSource

        g = Graph()
        s1, k1 = NoiseSource(seed=1), NullSink()
        s2, k2 = NoiseSource(seed=2), NullSink()
        g.connect(s1, k1)
        g.connect(s2, k2)
        flat = g.flatten()
        parts = flat.partition()
        assert len(parts) == 2
        assert {len(p) for p in parts} == {2}


class TestMisbehavingBlock:
    def test_nan_fixture_propagates_observably(self):
        from grtpu.blocks.misc import GrTest

        x = np.ones(16, np.float32)
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        sink = VectorSink()
        g.connect(pin, GrTest(inject_nan=True), sink)
        StreamExecutor(g, chunk_size=16).run(jnp.asarray(x))
        out = sink.data()
        assert np.isnan(out[0]) and np.isfinite(out[1:]).all()



class TestDebugTaps:
    def test_every_edge_logged(self, tmp_path):
        """The log-every-stage idiom (SURVEY §5.1): debug_taps captures all
        intermediate streams and dumps raw files."""
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        sink = VectorSink()
        g.connect(pin, AddConst(1.0), MultiplyConst(2.0), sink)
        ex = StreamExecutor(g, chunk_size=16, debug_taps=True)
        x = np.arange(32, dtype=np.float32)
        ex.run(jnp.asarray(x))
        assert len(ex.edge_data) >= 2
        paths = ex.dump_debug_taps(str(tmp_path))
        import os
        for k, p in paths.items():
            assert os.path.getsize(p) > 0
        # an intermediate edge holds the post-AddConst stream
        mid = [np.concatenate([np.asarray(v) for v in parts])
               for k, parts in ex.edge_data.items() if "AddConst" in k.split("->")[0]]
        assert any(np.allclose(m, x + 1) for m in mid)


class TestNewPlumbingBlocks:
    def test_streams_to_vector_roundtrip(self):
        import jax.numpy as jnp
        from grtpu.blocks.stream import StreamsToVector, VectorToStreams
        xs = [np.arange(8, dtype=np.float32) + 10 * i for i in range(3)]
        s2v = StreamsToVector(jnp.float32, 3)
        _, v = s2v.apply(s2v.init_state(), *[jnp.asarray(x) for x in xs])
        assert np.asarray(v).shape == (8, 3)
        v2s = VectorToStreams(jnp.float32, 3)
        _, outs = v2s.apply(v2s.init_state(), v)
        for i in range(3):
            assert (np.asarray(outs[i]) == xs[i]).all()

    def test_selector_and_valve(self):
        import jax.numpy as jnp
        from grtpu.blocks.misc import Selector, Valve
        a = jnp.asarray(np.ones(4, np.float32))
        b = jnp.asarray(np.full(4, 2.0, np.float32))
        sel = Selector(jnp.float32, 2, 2, input_index=1, output_index=0)
        _, (o0, o1) = sel.apply(sel.init_state(), a, b)
        assert (np.asarray(o0) == 2).all() and (np.asarray(o1) == 0).all()
        sel.set_input_index(0)
        _, (o0, _) = sel.apply(sel.init_state(), a, b)
        assert (np.asarray(o0) == 1).all()
        v = Valve(jnp.float32, open=True)
        _, y = v.apply(v.init_state(), a)
        assert (np.asarray(y) == 0).all()
        v.set_open(False)
        _, y = v.apply(v.init_state(), a)
        assert (np.asarray(y) == 1).all()

    def test_error_rate_windowed(self):
        import jax.numpy as jnp
        from grtpu.blocks.misc import ErrorRate
        er = ErrorRate("SER", win_size=8, bits_per_symbol=1)
        a = np.zeros(16, np.uint8)
        b = np.zeros(16, np.uint8)
        b[4] = 1   # one symbol error
        st = er.init_state()
        st, y = er.apply(st, jnp.asarray(a), jnp.asarray(b))
        y = np.asarray(y)
        assert abs(y[4] - 1 / 5) < 1e-6       # 1 err over 5 samples seen
        assert abs(y[7] - 1 / 8) < 1e-6
        assert y[12] == 0.0                    # error left the window
        # BER mode counts bit flips per byte
        er2 = ErrorRate("BER", win_size=8, bits_per_symbol=8)
        b2 = a.copy(); b2[0] = 0xFF
        _, y2 = er2.apply(er2.init_state(), jnp.asarray(a), jnp.asarray(b2))
        assert abs(np.asarray(y2)[0] - 1.0) < 1e-6   # 8/ (1*8)

    def test_vco_integrates_frequency(self):
        import jax.numpy as jnp
        from grtpu.blocks.analog import Vco
        fs, f0 = 8000.0, 440.0
        vco = Vco(fs, sensitivity=2 * np.pi, amplitude=1.0)
        ctrl = np.full(8000, f0, np.float32)
        st = vco.init_state()
        st, y = vco.apply(st, jnp.asarray(ctrl[:4000]))
        st, y2 = vco.apply(st, jnp.asarray(ctrl[4000:]))
        y = np.concatenate([np.asarray(y), np.asarray(y2)])
        spec = np.abs(np.fft.rfft(y * np.hanning(8000)))
        peak = np.argmax(spec) * fs / 8000
        assert abs(peak - f0) < 2.0


class TestDeviceLoop:
    """run(device_loop=True): all chunks in one lax.scan dispatch
    (the device-side replacement for per-chunk python dispatch)."""

    def test_fixed_rate_matches_stepwise(self):
        import jax.numpy as jnp
        from grtpu.runtime.graph import Graph
        from grtpu.runtime.block import Port
        from grtpu.runtime.executor import StreamExecutor
        from grtpu.blocks.filter import FirFilter
        from grtpu.utils import firdes

        taps = firdes.low_pass(1.0, 32e3, 4e3, 2e3)

        def build():
            g = Graph()
            pin = g.add_input(Port(jnp.float32))
            pout = g.add_output(Port(jnp.float32))
            g.connect(pin, FirFilter(2, taps, "fff"), pout)
            return g

        r = np.random.RandomState(0)
        x = r.randn(4 * 512 + 100).astype(np.float32)
        ex1 = StreamExecutor(build(), chunk_size=512, donate=False)
        ref = np.asarray(ex1.run(jnp.asarray(x)))
        ex2 = StreamExecutor(build(), chunk_size=512, donate=False)
        got = np.asarray(ex2.run(jnp.asarray(x), device_loop=True))
        np.testing.assert_array_equal(got, ref)
        # state continuity: a second device-loop run continues the stream
        ref2 = np.asarray(ex1.run(jnp.asarray(x)))
        got2 = np.asarray(ex2.run(jnp.asarray(x), device_loop=True))
        np.testing.assert_array_equal(got2, ref2)

    def test_vr_graph_matches_stepwise(self):
        import jax.numpy as jnp
        from grtpu.runtime.graph import Graph
        from grtpu.runtime.block import Port
        from grtpu.runtime.executor import StreamExecutor
        from grtpu.digital.blocks import ClockRecoveryMMFF

        def build():
            g = Graph()
            pin = g.add_input(Port(jnp.float32))
            pout = g.add_output(Port(jnp.float32))
            g.connect(pin, ClockRecoveryMMFF(4, 0.25e-4, 0.5, 0.01), pout)
            return g

        r = np.random.RandomState(1)
        syms = r.choice([-1.0, 1.0], size=600)
        x = np.repeat(syms, 4)[:2048].astype(np.float32)
        ex1 = StreamExecutor(build(), chunk_size=512, donate=False)
        ref = np.asarray(ex1.run(jnp.asarray(x)))
        ex2 = StreamExecutor(build(), chunk_size=512, donate=False)
        got = np.asarray(ex2.run(jnp.asarray(x), device_loop=True))
        np.testing.assert_array_equal(got, ref)

    def test_input_tags_ride_device_loop(self):
        """Stream tags survive device_loop=True (VERDICT r3 item #3): the
        host replays the propagation plan per chunk after the single
        dispatch, so pad_tags match the stepwise path exactly — including
        offset scaling through a decimating block."""
        import jax.numpy as jnp
        from grtpu.runtime.graph import Graph
        from grtpu.runtime.block import Port
        from grtpu.runtime.executor import StreamExecutor
        from grtpu.runtime.tags import Tag
        from grtpu.blocks.stream import KeepOneInN

        def build():
            g = Graph()
            pin = g.add_input(Port(jnp.float32))
            pout = g.add_output(Port(jnp.float32))
            g.connect(pin, KeepOneInN(4, dtype=jnp.float32), pout)
            return StreamExecutor(g, chunk_size=256, donate=False)

        tags = [Tag(5, "k", 1), Tag(300, "k", 2), Tag(700, "k", 3)]
        x = np.arange(1024, dtype=np.float32)
        ex1 = build()
        ex1.add_tags(0, tags)
        ref = np.asarray(ex1.run(x))
        ex2 = build()
        ex2.add_tags(0, tags)
        got = np.asarray(ex2.run(x, device_loop=True))
        np.testing.assert_array_equal(got, ref)
        assert ex2.pad_tags == ex1.pad_tags
        assert sorted(t.offset for t in ex2.pad_tags[0]) == [1, 75, 175]


class TestDeviceLoopDonate:
    def test_donate_false_preserves_held_state(self):
        """A donate=False executor may have handed out ex.state (the
        step_fn embedding surface); run(device_loop=True) must not donate
        those buffers to the scan jit."""
        import jax.numpy as jnp
        import numpy as np
        from grtpu import Graph, StreamExecutor
        from grtpu.runtime.block import Port
        from grtpu.blocks.gengen import AddConst, VectorSink

        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        sink = VectorSink()
        g.connect(pin, AddConst(1.0), sink)
        ex = StreamExecutor(g, chunk_size=64, donate=False)
        held = ex.state                      # caller holds a reference
        x = jnp.arange(256, dtype=jnp.float32)
        ex.run(x, device_loop=True)
        # held buffers must still be alive and readable
        import jax
        leaves = jax.tree_util.tree_leaves(held)
        for leaf in leaves:
            np.asarray(leaf)                 # raises if deleted
        np.testing.assert_allclose(sink.data()[:4], [1, 2, 3, 4])
