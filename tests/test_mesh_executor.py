"""MeshExecutor: ANY flowgraph sharded over a ('time','chan') device mesh.

Validates the framework-level parallelism demanded by the reference's
scheduler model (gr_scheduler_tpb.cc:53-78 — every graph parallel by
construction; mp-sched/synthetic.py:28-45 — N identical pipelines scale
with zero user code): Graph-built chains run channel- and time-sharded on
the virtual 8-device CPU mesh and match the single-device StreamExecutor
sample-exactly, including carried-state continuity across steps.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from grtpu import Graph, StreamExecutor
from grtpu.runtime.block import Port
from grtpu.runtime.mesh_executor import MeshExecutor, make_mesh


def _devices(n):
    d = jax.devices()
    if len(d) < n:
        pytest.skip(f"needs {n} virtual devices, have {len(d)}")
    return d[:n]


def _wfm_graph():
    from grtpu.models.fm import WfmRcv

    g = Graph()
    pin = g.add_input(Port(jnp.complex64))
    pout = g.add_output(Port(jnp.float32))
    g.connect(pin, WfmRcv(256e3, 8), pout)
    return g


def test_wfm_graph_time_chan_sharded_matches_single_device():
    """The flagship equivalence: the WBFM chain built as a *Graph* (not a
    hand-written bank) runs on a 4x2 ('time','chan') mesh sample-exact vs
    per-channel single-device execution — FIR halo via ppermute overlap-
    save, deemph IIR state chained shard-serially, state continuity across
    3 chunks."""
    devs = _devices(8)
    mesh = make_mesh(8, devs)
    assert dict(mesh.shape) == {"time": 4, "chan": 2}
    nchan, chunk = 4, 2048
    mex = MeshExecutor(_wfm_graph(), mesh, nchan, chunk_size=chunk,
                       donate=False)

    r = np.random.RandomState(0)
    n = 3 * chunk  # multiple chunks => carried tails + IIR state continuity
    iq = (r.randn(nchan, n) + 1j * r.randn(nchan, n)).astype(np.complex64)
    y = np.asarray(mex.run(jnp.asarray(iq)))
    assert y.shape == (nchan, n // 8)

    for c in range(nchan):
        ex = StreamExecutor(_wfm_graph(), chunk_size=chunk, donate=False)
        ref = np.asarray(ex.run(jnp.asarray(iq[c])))
        np.testing.assert_allclose(y[c], ref, atol=2e-6, rtol=1e-5)


def test_clock_recovery_vr_chan_sharded():
    """A chain containing a variable-rate block (ClockRecoveryMMCC) runs
    channel-sharded: the in-step FIFO drain vmaps/shards untouched, and
    each channel's recovered symbol stream equals its single-device run."""
    from grtpu.digital.blocks import ClockRecoveryMMCC

    devs = _devices(8)
    mesh = Mesh(np.array(devs), ("chan",))
    nchan, chunk, sps = 8, 1024, 4

    def build():
        g = Graph()
        pin = g.add_input(Port(jnp.complex64))
        pout = g.add_output(Port(jnp.complex64))
        g.connect(pin, ClockRecoveryMMCC(sps, 0.25 * 0.01 * 0.01, 0.5, 0.01),
                  pout)
        return g

    r = np.random.RandomState(1)
    n = 4 * chunk
    sig = np.zeros((nchan, n), np.complex64)
    for c in range(nchan):
        syms = r.choice([-1.0, 1.0], size=n // sps + 8)
        sig[c] = (np.repeat(syms, sps)[:n]
                  + 0.01 * r.randn(n)).astype(np.complex64)

    mex = MeshExecutor(build(), mesh, nchan, chunk_size=chunk, donate=False)
    y = mex.run(jnp.asarray(sig))
    assert isinstance(y, list) and len(y) == nchan

    for c in range(nchan):
        ex = StreamExecutor(build(), chunk_size=chunk, donate=False)
        ref = np.asarray(ex.run(jnp.asarray(sig[c])))
        got = np.asarray(y[c])
        assert got.shape == ref.shape, (c, got.shape, ref.shape)
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_stateful_source_time_sharded():
    """Source-driven graph: SigSource's carried NCO phase chains across
    time shards (shard-serial), so the generated waveform is the single
    continuous stream, not S restarted copies."""
    from grtpu.blocks.analog import SigSource
    from grtpu.blocks.filter import FirFilter
    from grtpu.utils import firdes

    devs = _devices(4)
    mesh = Mesh(np.array(devs).reshape(4, 1), ("time", "chan"))
    chunk = 1024
    taps = firdes.low_pass(1.0, 32e3, 4e3, 2e3)

    def build():
        g = Graph()
        pout = g.add_output(Port(jnp.float32))
        src = SigSource(32e3, "cos", 997.0)
        g.connect(src, FirFilter(2, taps, "fff"), pout)
        return g

    mex = MeshExecutor(build(), mesh, 1, chunk_size=chunk, donate=False)
    y = np.asarray(mex.run(steps=3))[0]
    ex = StreamExecutor(build(), chunk_size=chunk, donate=False)
    ref = np.asarray(ex.run(steps=3))
    # phase wraps mod 2*pi once per shard vs once per chunk -> last-ulp
    # phase differences; amplitude-level agreement is the contract
    np.testing.assert_allclose(y, ref, atol=1e-4)


def test_multi_branch_graph_time_sharded():
    """Fan-out + join (add of two filtered branches) across time shards:
    per-edge halos stay independent and the join stays aligned."""
    from grtpu.blocks.filter import FirFilter
    from grtpu.blocks.gengen import Add
    from grtpu.utils import firdes

    devs = _devices(8)
    mesh = Mesh(np.array(devs).reshape(2, 4), ("time", "chan"))
    nchan, chunk = 4, 512
    t1 = firdes.low_pass(1.0, 32e3, 4e3, 2e3)
    t2 = firdes.high_pass(1.0, 32e3, 6e3, 2e3)

    def build():
        g = Graph()
        pin = g.add_input(Port(jnp.float32))
        pout = g.add_output(Port(jnp.float32))
        f1 = FirFilter(1, t1, "fff", impl="matmul")
        f2 = FirFilter(1, t2, "fff", impl="matmul")
        add = Add(dtype=jnp.float32, nin=2)
        g.connect(pin, f1, (add, 0))
        g.connect(pin, f2, (add, 1))
        g.connect(add, pout)
        return g

    r = np.random.RandomState(3)
    x = r.randn(nchan, 2 * chunk).astype(np.float32)
    mex = MeshExecutor(build(), mesh, nchan, chunk_size=chunk, donate=False)
    y = np.asarray(mex.run(jnp.asarray(x)))
    for c in range(nchan):
        ex = StreamExecutor(build(), chunk_size=chunk, donate=False)
        ref = np.asarray(ex.run(jnp.asarray(x[c])))
        np.testing.assert_allclose(y[c], ref, atol=1e-5)


def test_vr_time_sharding_rejected():
    """Variable-rate consumption is data-dependent; a static time split
    cannot be rate-aligned — the executor says so instead of misbehaving."""
    from grtpu.digital.blocks import ClockRecoveryMMFF

    devs = _devices(2)
    mesh = Mesh(np.array(devs).reshape(2, 1), ("time", "chan"))
    g = Graph()
    pin = g.add_input(Port(jnp.float32))
    pout = g.add_output(Port(jnp.float32))
    g.connect(pin, ClockRecoveryMMFF(4, 1e-4, 0.5, 0.01), pout)
    with pytest.raises(NotImplementedError):
        MeshExecutor(g, mesh, 2, chunk_size=512)


def test_stale_taps_guard():
    """set_taps on a built executor must raise, not silently produce
    old-tap output (the baked-constant trap)."""
    from grtpu.blocks.filter import FirFilter

    g = Graph()
    pin = g.add_input(Port(jnp.float32))
    pout = g.add_output(Port(jnp.float32))
    f = FirFilter(1, np.ones(4, np.float32) / 4, "fff", impl="matmul")
    g.connect(pin, f, pout)
    ex = StreamExecutor(g, chunk_size=256, donate=False)
    x = np.zeros(256, np.float32)
    ex.step(x)  # fine
    f.set_taps(np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="parameters changed"):
        ex.step(x)


def test_device_loop_matches_stepwise_fixed_rate():
    """run(device_loop=True): one lax.scan dispatch over the sharded step,
    bit-identical to the per-chunk stepwise path (fixed-rate WBFM chain,
    4x2 ('time','chan') mesh)."""
    devs = _devices(8)
    mesh = make_mesh(8, devs)
    nchan, chunk = 4, 2048
    r = np.random.RandomState(5)
    n = 3 * chunk
    iq = (r.randn(nchan, n) + 1j * r.randn(nchan, n)).astype(np.complex64)

    mex1 = MeshExecutor(_wfm_graph(), mesh, nchan, chunk_size=chunk,
                        donate=False)
    ref = np.asarray(mex1.run(jnp.asarray(iq)))
    mex2 = MeshExecutor(_wfm_graph(), mesh, nchan, chunk_size=chunk,
                        donate=False)
    got = np.asarray(mex2.run(jnp.asarray(iq), device_loop=True))
    np.testing.assert_array_equal(got, ref)


def test_device_loop_matches_stepwise_vr():
    """device_loop with a variable-rate block (channel-sharded clock
    recovery): per-chunk per-channel emission counts survive the scan and
    the compacted streams match the stepwise run exactly."""
    from grtpu.digital.blocks import ClockRecoveryMMCC

    devs = _devices(8)
    mesh = Mesh(np.array(devs[:4]).reshape(4), ("chan",))
    nchan, chunk, sps = 4, 1024, 4

    def graph():
        g = Graph()
        pin = g.add_input(Port(jnp.complex64))
        pout = g.add_output(Port(jnp.complex64))
        g.connect(pin, ClockRecoveryMMCC(sps, 0.25 * 0.175 ** 2, 0.5,
                                         0.175, 0.005), pout)
        return g

    r = np.random.RandomState(6)
    n = 3 * chunk
    sym = (np.sign(r.randn(nchan, n // sps))
           + 1j * np.sign(r.randn(nchan, n // sps)))
    iq = np.repeat(sym, sps, axis=1).astype(np.complex64)

    m1 = MeshExecutor(graph(), mesh, nchan, chunk_size=chunk, donate=False)
    ref = m1.run(jnp.asarray(iq))
    m2 = MeshExecutor(graph(), mesh, nchan, chunk_size=chunk, donate=False)
    got = m2.run(jnp.asarray(iq), device_loop=True)
    for c in range(nchan):
        assert got[c].shape == ref[c].shape
        np.testing.assert_array_equal(got[c], ref[c])


def test_mesh_checkpoint_roundtrip(tmp_path):
    """save_checkpoint/load_checkpoint compose with MeshExecutor: the
    per-channel state pytree (leading nchannels axis) restores exactly and
    the resumed stream continues sample-identically."""
    devs = _devices(2)
    mesh = Mesh(np.array(devs[:2]).reshape(1, 2), ("time", "chan"))
    nchan, chunk = 2, 1024
    r = np.random.RandomState(3)
    iq = (r.randn(nchan, 4 * chunk)
          + 1j * r.randn(nchan, 4 * chunk)).astype(np.complex64)

    a = MeshExecutor(_wfm_graph(), mesh, nchan, chunk_size=chunk,
                     donate=False)
    a.run(jnp.asarray(iq[:, : 2 * chunk]))
    path = str(tmp_path / "mesh_ckpt.npz")
    a.save_checkpoint(path)
    y_ref = np.asarray(a.run(jnp.asarray(iq[:, 2 * chunk:])))

    b = MeshExecutor(_wfm_graph(), mesh, nchan, chunk_size=chunk,
                     donate=False)
    b.load_checkpoint(path)
    y_res = np.asarray(b.run(jnp.asarray(iq[:, 2 * chunk:])))
    np.testing.assert_array_equal(y_res, y_ref)
