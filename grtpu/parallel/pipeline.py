"""Stage-pipelined streaming over the device mesh (pipeline parallelism).

The analog of the reference's thread-per-block scheduler
(gr_scheduler_tpb.cc:53-78): there, every block of a chain runs on its own
OS thread and chunks flow downstream through 32KiB double buffers so
producer and consumer overlap (gr_flat_flowgraph.cc:96-100).  Here, every
stage of a chain runs on its own device along a ``stage`` mesh axis and
chunks flow downstream through a ``ppermute`` — a systolic pipeline.
After S-1 fill steps all S devices compute concurrently, so a chain too
long (or too stateful) for one device streams at full per-device
rate.

This is exactly the workload of the reference's published mp-sched
benchmark (gnuradio-examples/python/mp-sched/synthetic.py:28-45 — npipes
parallel pipelines of nstages 256-tap FIR blocks, one thread per block):
map npipes onto a ``chan``/batch axis and nstages onto the ``stage`` axis.

Semantics are identical to running the stages back-to-back on one chip:
each stage carries its own history tail across chunk boundaries (the
buffer-reader ``nzero_preload`` analog), so the pipelined output is
bit-identical to the sequential cascade.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


class PipelinedChain:
    """A chain of S structurally-identical 1:1 stages, one per device.

    ``stage_fn(params, state, x) -> (state', y)`` with ``y.shape ==
    x.shape`` (rate-1 stages; rate changes belong inside a stage).
    ``params``/``state`` are pytrees whose leaves carry a leading
    stage axis of size S, sharded over the mesh's ``stage`` axis so each
    device holds exactly its own stage's parameters and carried state.

    :meth:`run` scans M + S - 1 pipeline steps inside ONE jitted XLA
    program; chunk j enters stage 0 at step j and leaves stage S-1 at
    step j + S - 1.  Per step, every device executes one ``stage_fn``
    concurrently — S-way pipeline parallelism on ICI.
    """

    def __init__(self, mesh: Mesh, stage_fn, params, state,
                 axis_name: str = "stage"):
        self.mesh = mesh
        self.axis_name = axis_name
        self.S = mesh.shape[axis_name]
        self.stage_fn = stage_fn
        leading = jax.tree.leaves(params)[0].shape[0]
        if leading != self.S:
            raise ValueError(
                f"params leading axis {leading} != mesh '{axis_name}' size "
                f"{self.S}")
        spec = P(axis_name)
        self.params = jax.device_put(
            params, jax.sharding.NamedSharding(mesh, spec))
        self.state = jax.device_put(
            state, jax.sharding.NamedSharding(mesh, spec))
        self._run = None
        self._run_M = None

    def _local_run(self, params, state, feed, M: int):
        """One device's whole run: scan the pipeline steps locally.

        params/state leaves: (1, ...) — this device's stage.  feed:
        (M + S - 1, chunk) — the input schedule (M real chunks + S - 1
        zero drain chunks), replicated (only stage 0 reads it).

        Schedule: stage s processes chunk j at step j + s, so during fill
        (t < s) and drain (t >= M + s) a stage sees zero filler; its state
        update is masked off then, so carried state after the run equals
        the sequential cascade's state after chunk M - 1 exactly.
        """
        ax = self.axis_name
        idx = jax.lax.axis_index(ax)
        S = jax.lax.axis_size(ax)
        fwd = [(i, i + 1) for i in range(S - 1)]
        p_local = jax.tree.map(lambda l: l[0], params)

        def step(carry, tf):
            st, slot = carry
            t, feed_chunk = tf
            x = jnp.where(idx == 0, feed_chunk, slot)
            st2, y = self.stage_fn(p_local, st, x)
            valid = (t >= idx) & (t < M + idx)
            st = jax.tree.map(
                lambda new, old: jnp.where(valid, new, old), st2, st)
            recv = jax.lax.ppermute(y, ax, fwd) if fwd else y
            return (st, recv), y

        slot0 = jnp.zeros_like(feed[0])
        st0 = jax.tree.map(lambda l: l[0], state)
        ts = jnp.arange(feed.shape[0], dtype=jnp.int32)
        (st, _), ys = jax.lax.scan(step, (st0, slot0), (ts, feed))
        st = jax.tree.map(lambda l: l[None], st)
        return st, ys[None]  # leading stage axis of 1 for out_specs

    def run_fn(self, M: int):
        if self._run is None or self._run_M != M:
            spec = P(self.axis_name)
            self._run = jax.jit(functools.partial(
                jax.shard_map,
                mesh=self.mesh,
                in_specs=(spec, spec, P()),
                out_specs=(spec, spec),
                check_vma=False,
            )(functools.partial(self._local_run, M=M)))
            self._run_M = M
        return self._run

    def run(self, chunks: jnp.ndarray) -> jnp.ndarray:
        """Stream (M, chunk_size) chunks through the pipeline.

        Returns the (M, chunk_size) output of the final stage (the fill
        and drain steps already sliced off); the chain's carried state is
        updated in place, so consecutive runs stream seamlessly.
        """
        M = chunks.shape[0]
        S = self.S
        pad = jnp.zeros((S - 1,) + chunks.shape[1:], chunks.dtype)
        feed = jnp.concatenate([chunks, pad], axis=0)
        run = self.run_fn(M)
        self.state, ys = run(self.params, self.state, feed)
        # ys: (S, M + S - 1, chunk); chunk j leaves stage S-1 at step
        # j + S - 1.
        return ys[-1, S - 1: S - 1 + M]


def fir_chain_pipeline(mesh: Mesh, taps: np.ndarray,
                       axis_name: str = "stage") -> PipelinedChain:
    """A pipeline of S decim-1 FIR stages (taps: (S, K) float32), each
    carrying its K-1 history tail across chunks — the mp-sched synthetic
    workload with one chip per stage instead of one thread per block."""
    from grtpu.ops.fir import fir_filter

    S, K = taps.shape

    def stage(params, state, x):
        if K == 1:  # memoryless stage: no history to carry
            return state, fir_filter(x, params, 1).astype(x.dtype)
        xh = jnp.concatenate([state, x])
        y = fir_filter(xh, params, 1)
        return xh[-(K - 1):], y.astype(x.dtype)

    params = jnp.asarray(taps, jnp.float32)
    state = jnp.zeros((S, max(K - 1, 1)), jnp.float32)
    return PipelinedChain(mesh, stage, params, state, axis_name)


def tap_parallel_fir(x: jnp.ndarray, taps_local: jnp.ndarray,
                     axis_name: str, decim: int = 1) -> jnp.ndarray:
    """Tensor-parallel FIR: the tap axis sharded across devices.

    Each of the n shards holds a contiguous slice of the K taps and the
    full (replicated) input window; it computes its partial dot-products
    and a ``psum`` over ``axis_name`` reduces them — the analog of
    splitting one volk dot-product across cores.  Useful when one filter
    is so long (channel-emulation FIRs, acoustics) that its window matrix
    exceeds a single device's memory.

    ``x``: (N + K - 1,) with full K-1 leading history, replicated.
    ``taps_local``: (K / n,) this shard's tap slice (shard i holds
    ``taps[i*Kl:(i+1)*Kl]``).  Returns the full (N // decim,) output,
    replicated (post-psum) on every shard.

    Convention matches grtpu.ops.fir.fir_filter: y[i] = sum_k taps[k] *
    x[i*decim + K - 1 - k]; shard i's ``k`` lives in [i*Kl, (i+1)*Kl), so
    its window of x starts at K - (i+1)*Kl.
    """
    from grtpu.ops.fir import fir_filter

    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    Kl = taps_local.shape[0]
    K = n * Kl
    N = x.shape[0] - (K - 1)
    start = K - Kl - idx * Kl
    xw = jax.lax.dynamic_slice_in_dim(x, start, N + Kl - 1)
    y = fir_filter(xw, taps_local, decim)
    return jax.lax.psum(y, axis_name)
