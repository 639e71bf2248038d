"""Mesh-aware stream executor: run ANY flowgraph sharded over a device mesh.

The reference's defining property is that every flowgraph is parallel by
construction — one thread per block, N identical sub-pipelines scale across
cores with zero user code (gr_scheduler_tpb.cc:53-78,
gnuradio-examples/python/mp-sched/synthetic.py:28-45).  This module makes
parallelism a *framework* property of grtpu: the same
:class:`~grtpu.runtime.executor.StreamExecutor` step, compiled once and laid
out over a ``jax.sharding.Mesh`` with two data axes:

* ``chan`` — data parallelism over independent channel instances of the
  flowgraph (the mp-sched N-pipeline fan-out, SURVEY.md §2.10.3).  The whole
  jitted step is ``jax.vmap``-ed over a leading channel axis and sharded
  with ``shard_map``; every block is already a pure function and every state
  a pytree, so *any* graph — including variable-rate blocks with their
  in-step FIFO drains — channel-shards with zero block changes.

* ``time`` — sequence parallelism over the stream inside one chunk
  (SURVEY.md §5.7): each shard processes a contiguous time slice, with each
  block's declared ``history`` delivered as an overlap-save halo from the
  left neighbor via ``ppermute`` (replacing the reference's
  buffer-reader preload, gr_flat_flowgraph.cc:124-152).  Blocks whose only
  cross-chunk state is the halo run fully parallel across time shards.
  Blocks with carried recurrent state (IIR, rotators, AGC loops) are
  *shard-serial*: their per-shard states chain left-to-right through
  ``ppermute`` within the step, which is exact — the FLOP-heavy FIR/demod
  stages around them still scale.  Variable-rate segments replicate over
  ``time`` by design (their consumption is data-dependent, so a static time
  split cannot be rate-aligned; shard them over ``chan`` instead) — the
  executor enforces this rather than silently misbehaving.

State layout: every state leaf gains a leading ``nchannels`` axis, sharded
over ``chan`` and replicated over ``time``.  Checkpointing, state
continuity across steps, and the (pads, captures) output contract all match
the single-device executor; results are sample-exact against it per
channel.

Stream tags: every channel is its own linear stream, so the mesh holds one
host-side tag plane per channel (``chan_planes``).  Tag-emitting blocks must
implement the in-jit ``device_tags`` contract (detection on device, a small
fixed-size record per chunk — gaining leading channel/chunk axes here);
propagation replays the shared host plan per channel.  Works under step()
and ``run(device_loop=True)`` on chan-sharded meshes (a time-sharded mesh
would need per-shard offset rebasing and is rejected).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from grtpu.runtime.block import Block
from grtpu.runtime.executor import (StreamExecutor, _TagPlane, _edge_key,
                                    _ingest)
from grtpu.runtime.graph import FlatGraph, Graph, Pad


def make_mesh(n_devices: int, devices=None, time: Optional[int] = None) -> Mesh:
    """2-D ('time', 'chan') mesh; degenerate axes allowed.

    ``time`` fixes the time-axis size; default prefers a modest time axis
    (4 or 2) with at least 2 channel shards, else pure channel sharding.
    """
    if devices is None:
        devices = jax.devices()[:n_devices]
    if time is None:
        time = 1
        for cand in (4, 2):
            if n_devices % cand == 0 and n_devices // cand >= 2:
                time = cand
                break
    if n_devices % time:
        raise ValueError(f"time={time} does not divide {n_devices} devices")
    dev = np.array(devices[:n_devices]).reshape(time, n_devices // time)
    return Mesh(dev, ("time", "chan"))


class MeshExecutor(StreamExecutor):
    """Compile + run a flowgraph over ``nchannels`` independent channel
    instances, sharded over a device mesh.

    Args:
      graph: any :class:`Graph`/:class:`FlatGraph` (variable-rate blocks
        included — those require the mesh's time axis to be 1).
      mesh: a ``jax.sharding.Mesh``; axes named ``chan_axis``/``time_axis``
        are used if present, others are ignored (size-1 axes are fine).
      nchannels: leading channel-instance count (must divide by the chan
        axis size).  Inputs/outputs gain a leading ``nchannels`` dim.
      chunk_size: per-channel items per step, as in StreamExecutor.  With
        time sharding, each shard handles ``chunk_size / time`` items and
        every block's per-shard input must still satisfy its decimation
        multiple and cover its history.
    """

    def __init__(
        self,
        graph: Graph | FlatGraph,
        mesh: Mesh,
        nchannels: int,
        *,
        chan_axis: str = "chan",
        time_axis: str = "time",
        chunk_size: Optional[int] = 4096,
        root_chunks: Optional[Dict[Any, int]] = None,
        vr_chunks: Optional[Dict[Any, int]] = None,
        donate: bool = True,
    ):
        self.mesh = mesh
        self.nchannels = int(nchannels)
        self._chan = chan_axis if chan_axis in mesh.shape else None
        self._time = time_axis if time_axis in mesh.shape else None
        self.s_chan = mesh.shape.get(chan_axis, 1)
        self.s_time = mesh.shape.get(time_axis, 1)
        if self.nchannels % self.s_chan:
            raise ValueError(
                f"nchannels={nchannels} not divisible by chan axis size "
                f"{self.s_chan}")
        super().__init__(graph, chunk_size=chunk_size,
                         root_chunks=root_chunks, vr_chunks=vr_chunks,
                         donate=donate, debug_taps=False)

    # ------------------------------------------------------------------ state
    def _init_state(self):
        C = self.nchannels

        def make():
            # vmap broadcasts the per-channel initial state to (C, ...)
            return jax.vmap(lambda _: self._make_state())(
                jnp.zeros((C,), jnp.float32))

        self.state = jax.jit(make)()
        if self._chan is not None or self._time is not None:
            self.state = jax.device_put(
                self.state, NamedSharding(self.mesh, P(self._chan)))

    # ------------------------------------------------------------------ build
    def _build_step(self, donate: bool):
        super()._build_step(False)  # defines self._step_fn (per-channel)
        for b in self.order:
            if b.emits_tags and not b.device_tags:
                raise NotImplementedError(
                    f"{b.name}: legacy make_tags emitters capture full "
                    f"chunks on the host and may keep host state per "
                    f"stream; under MeshExecutor implement the in-jit "
                    f"device_tags contract (apply_tagged/tags_from_device) "
                    f"instead")
            if b.emits_tags and self.s_time > 1:
                raise NotImplementedError(
                    f"{b.name}: tag emission under a time-sharded mesh "
                    f"would need per-shard offset rebasing; use a mesh "
                    f"with a size-1 time axis (shard over 'chan')")
        if self.vr_blocks and self.s_time > 1:
            raise NotImplementedError(
                "variable-rate blocks consume at a data-dependent rate; a "
                "static time split cannot be rate-aligned across shards. "
                "Use a mesh with a size-1 time axis and shard over 'chan'.")

        if self.s_time > 1:
            self._validate_time_sharding()
            local_fn = self._build_time_local()
            state_specs = jax.tree_util.tree_map(
                lambda _: P(self._chan), self.state)
            in_specs = (state_specs,
                        tuple(P(self._chan, self._time)
                              for _ in self.flat.in_pads))
            pad_specs = tuple(P(self._chan, self._time)
                              for _ in self.flat.out_pads)
            cap_specs = {
                b.name: tuple(P(self._chan, self._time)
                              for _ in b.in_ports)
                for b in self.order if not b.out_ports and b.in_ports
            }
            out_specs = (state_specs, (pad_specs, cap_specs))
        else:
            local_fn = jax.vmap(self._step_fn)
            state_specs = jax.tree_util.tree_map(
                lambda _: P(self._chan), self.state)
            in_specs = (state_specs,
                        tuple(P(self._chan) for _ in self.flat.in_pads))
            ext_structs = tuple(
                jax.ShapeDtypeStruct(
                    (self.nchannels,)
                    + pad.port.chunk_shape(self._pad_chunk[id(pad)]),
                    pad.port.dtype)
                for pad in self.flat.in_pads)
            out_struct = jax.eval_shape(local_fn, self.state, ext_structs)
            out_specs = jax.tree_util.tree_map(
                lambda _: P(self._chan), out_struct)

        sharded = jax.shard_map(local_fn, mesh=self.mesh,
                                in_specs=in_specs, out_specs=out_specs,
                                check_vma=False)
        self._sharded_local = sharded        # device_loop scans this
        self._jit_step = jax.jit(
            sharded, donate_argnums=(0,) if donate else ())

    def _validate_time_sharding(self):
        S = self.s_time
        for b in self.order:
            n_in = self.block_nin[b.uid]
            if n_in % S:
                raise ValueError(
                    f"{b.name}: per-step input {n_in} not divisible by "
                    f"time axis size {S}; raise chunk_size")
            n_loc = n_in // S
            if n_loc % b.decim:
                raise ValueError(
                    f"{b.name}: per-shard input {n_loc} not a multiple of "
                    f"decim={b.decim}; raise chunk_size")
            if b.in_ports and n_loc < b.history - 1:
                raise ValueError(
                    f"{b.name}: per-shard input {n_loc} smaller than "
                    f"history-1={b.history - 1}; raise chunk_size")
            if not b.in_ports:
                n_out = n_in // b.decim * b.interp
                if n_out % S:
                    raise ValueError(
                        f"{b.name}: source production {n_out} not "
                        f"divisible by time axis size {S}")

    # -------------------------------------------------- time-sharded builder
    def _build_time_local(self):
        """Per-block local step over one ('chan','time') shard: halo
        exchange for history (overlap-save via ppermute), shard-serial
        chaining for recurrent state, channel-vmapped block applies."""
        flat, order = self.flat, self.order
        taxis = self._time
        S = self.s_time
        perm = [(i, (i + 1) % S) for i in range(S)]

        def bcast_last(x):
            """Broadcast the LAST time shard's value to all shards (the
            new carried tail/state lives logically at the stream's end)."""
            if S == 1:
                return x
            idx = jax.lax.axis_index(taxis)
            if jnp.issubdtype(x.dtype, jnp.bool_):
                return jax.lax.psum(
                    jnp.where(idx == S - 1, x.astype(jnp.int32), 0),
                    taxis).astype(jnp.bool_)
            return jax.lax.psum(
                jnp.where(idx == S - 1, x, jnp.zeros_like(x)), taxis)

        def serial_apply(vap, st, ins):
            """Chain per-shard recurrent state left-to-right: shard j+1
            starts from shard j's final state (one ppermute per link).
            Exact for any state; costs S redundant local applies — use for
            the cheap recurrent blocks, not the FLOP carriers."""
            idx = jax.lax.axis_index(taxis)
            out_struct = jax.eval_shape(vap, st, *ins)
            acc = jax.tree_util.tree_map(
                lambda a: jnp.zeros(a.shape, a.dtype), out_struct)
            st_in = st
            for j in range(S):
                res = vap(st_in, *ins)
                mine = idx == j
                acc = jax.tree_util.tree_map(
                    lambda a, r: jnp.where(mine, r, a), acc, res)
                if j < S - 1:
                    sent = jax.tree_util.tree_map(
                        lambda a: jax.lax.ppermute(a, taxis, perm), res[0])
                    st_in = jax.tree_util.tree_map(
                        lambda cur, rcv: jnp.where(idx == j + 1, rcv, cur),
                        st_in, sent)
            new_s, outs = acc
            return jax.tree_util.tree_map(bcast_last, new_s), outs

        def step(state, ext_inputs):
            idx = jax.lax.axis_index(taxis)
            blocks = dict(state["blocks"])
            tails = dict(state["tails"])
            edge_vals: Dict[str, Any] = {}
            caps: Dict[str, Any] = {}
            for b in order:
                ups = flat.upstream_of(b)
                ins = []
                fresh = []
                for i in range(len(b.in_ports)):
                    e = ups[i]
                    src = e.src.block
                    v = (ext_inputs[src.index] if isinstance(src, Pad)
                         else edge_vals[_edge_key(e)])
                    fresh.append(v)
                    if b.history > 1:
                        h = b.history - 1
                        k = _edge_key(e)
                        local_tail = v[:, v.shape[1] - h:]
                        if S > 1:
                            recv = jax.lax.ppermute(local_tail, taxis, perm)
                            recv = jnp.where(idx == 0, tails[k], recv)
                        else:
                            recv = tails[k]
                        tails[k] = bcast_last(local_tail)
                        v = jnp.concatenate([recv, v], axis=1)
                    ins.append(v)
                st = blocks[str(b.uid)]
                stateless = not jax.tree_util.tree_leaves(st)
                if not b.in_ports:
                    n_loc = (self.block_nin[b.uid] // b.decim * b.interp) // S
                    if stateless:
                        # stateless source == time-invariant output
                        # (null/constant); replicate per shard+channel
                        _, outs = self._apply_source(b, st, n_loc)
                        outs = tuple(
                            jnp.broadcast_to(
                                y[None],
                                (ins_channels(ext_inputs),) + y.shape)
                            for y in outs)
                        new_s = st
                    else:
                        vap = jax.vmap(
                            lambda s: self._apply_source(b, s, n_loc))
                        new_s, outs = serial_apply(vap, st, ())
                else:
                    vap = jax.vmap(
                        lambda s, *xs: self._apply_block(b, s, xs))
                    if stateless:
                        new_s, outs = vap(st, *ins)
                    else:
                        new_s, outs = serial_apply(vap, st, ins)
                blocks[str(b.uid)] = new_s
                if not b.out_ports and ins:
                    caps[b.name] = tuple(fresh)
                for e in flat.downstream_of(b):
                    edge_vals[_edge_key(e)] = outs[e.src.port]

            pad_outs = []
            for e in self.out_pad_edges:
                src = e.src.block
                pad_outs.append(ext_inputs[src.index]
                                if isinstance(src, Pad)
                                else edge_vals[_edge_key(e)])
            new_state = {"blocks": blocks, "tails": tails,
                         "fifo": dict(state["fifo"])}
            return new_state, (tuple(pad_outs), caps)

        def ins_channels(ext_inputs):
            if ext_inputs:
                return ext_inputs[0].shape[0]
            return self.nchannels // self.s_chan

        return step

    # ------------------------------------------------------------------ run
    # -------------------------------------------------------------- tags
    # Every channel is its own linear stream, so the mesh holds one
    # _TagPlane per channel; the propagation plan and the absolute item
    # counters are rate-static and therefore shared across channels.
    @property
    def chan_planes(self):
        if not hasattr(self, "_chan_planes"):
            self._chan_planes = [_TagPlane(self._edge_keys)
                                 for _ in range(self.nchannels)]
        return self._chan_planes

    def add_tags(self, pad_index, tags, channel: Optional[int] = None):
        """Attach stream tags to an input pad; ``channel=None`` applies
        them to every channel's stream."""
        chans = range(self.nchannels) if channel is None else [channel]
        for e in self.flat.edges:
            if isinstance(e.src.block, Pad) and e.src.block.index == pad_index:
                k = _edge_key(e)
                for c in chans:
                    plane = self.chan_planes[c]
                    plane.tags[k].extend(tags)
                    plane.tagged.add(k)

    def sink_tags_chan(self, name: str, channel: int):
        """Tags retained at sink block ``name`` on one channel's stream."""
        return self.chan_planes[channel].sink_tags.get(name, [])

    def pad_tags_chan(self, pad_index: int, channel: int):
        """Tags that crossed output pad ``pad_index`` on one channel."""
        return self.chan_planes[channel].pad_tags.get(pad_index, [])

    def _advance_mesh_tags(self, tagsrc, tagdev):
        """Per-channel tag pass: slice the (nchannels, ...) device-tag
        records per channel and advance that channel's plane.  One host
        readback per record array (not per channel); counters bump once."""
        planes = self._chan_planes if hasattr(self, "_chan_planes") else None
        if not tagsrc and not tagdev and (
                planes is None or not any(p.tagged for p in planes)):
            self._bump_counters()
            return
        planes = self.chan_planes
        tagdev_h = {name: {k: np.asarray(v) for k, v in rec.items()}
                    for name, rec in tagdev.items()}
        tagsrc_h = jax.tree_util.tree_map(np.asarray, tagsrc)
        for c in range(self.nchannels):
            src_c = {name: (tuple(a[c] for a in ins),
                            tuple(a[c] for a in outs))
                     for name, (ins, outs) in tagsrc_h.items()}
            dev_c = {name: {k: v[c] for k, v in rec.items()}
                     for name, rec in tagdev_h.items()}
            emitted = self._emitted_from_caps(src_c, dev_c)
            if emitted or planes[c].tagged:
                self._advance_plane(planes[c], emitted or {})
        self._bump_counters()

    def step(self, *ext_inputs):
        """One time-block over all channels.  Inputs/outputs carry a
        leading ``nchannels`` dim; VR emission buffers carry per-channel
        valid counts in caps['__vr_counts__'] (shape (nchannels,))."""
        self._check_versions()
        ext_inputs = tuple(_ingest(x) for x in ext_inputs)
        for pad, x in zip(self.flat.in_pads, ext_inputs):
            want = (self.nchannels, self._pad_chunk[id(pad)])
            if tuple(x.shape[:2]) != want:
                raise ValueError(
                    f"input pad {pad.index}: expected leading shape {want} "
                    f"(nchannels, chunk), got {tuple(x.shape[:2])}")
        self.state, out = self._jit_step(self.state, ext_inputs)
        pads, caps = out
        tagsrc, tagdev = self._pop_tag_caps(caps)
        self._advance_mesh_tags(tagsrc, tagdev)
        return pads, caps

    def run(self, *ext_inputs, steps: Optional[int] = None,
            device_loop: bool = False):
        """Stream (nchannels, n) inputs through in chunks; returns each
        fixed-rate output pad as a (nchannels, n_out) array and each
        VR-segment pad as a per-channel list of arrays (channels consume
        at independent recovered rates).  Sink captures land in
        ``self.sink_data`` with the same convention.

        ``device_loop=True`` runs every chunk of a finite input as ONE
        jitted lax.scan over the sharded step (the mesh analog of
        StreamExecutor.run(device_loop=True)): zero host work per chunk,
        bit-identical to the stepwise path including VR FIFO state."""
        n_pads = len(self.flat.in_pads)
        if len(ext_inputs) != n_pads:
            raise ValueError(
                f"graph has {n_pads} input pads, got {len(ext_inputs)}")
        outs_accum: List[List] = [[] for _ in self.flat.out_pads]
        sink_accum: Dict[str, List] = {}
        counts_accum: List[Dict[str, np.ndarray]] = []

        def collect(pads, caps):
            for i, v in enumerate(pads):
                outs_accum[i].append(v)
            for name, vals in caps.items():
                if name == "__vr_counts__":
                    counts_accum.append(
                        {k: np.asarray(v).astype(np.int64)
                         for k, v in vals.items()})
                    continue
                sink_accum.setdefault(name, []).append(vals)

        if n_pads == 0:
            assert steps is not None, "source-driven graph needs steps="
            for _ in range(steps):
                pads, caps = self.step()
                collect(pads, caps)
            return self._mesh_finalize(outs_accum, sink_accum, None,
                                       counts_accum)

        ext_inputs = [x if isinstance(x, jax.Array) else np.asarray(x)
                      for x in ext_inputs]
        n = ext_inputs[0].shape[1]
        cs = self.chunk_size
        nchunks = -(-n // cs)
        pad_to = nchunks * cs

        def padded(x):
            xp = np if isinstance(x, np.ndarray) else jnp
            if pad_to == n:
                return x
            return xp.pad(x, [(0, 0), (0, pad_to - n)]
                          + [(0, 0)] * (x.ndim - 2))

        if device_loop:
            chan_split = NamedSharding(self.mesh, P(self._chan))
            xs = [jax.device_put(padded(x), chan_split) for x in ext_inputs]
            return self._run_device_mesh(xs, n, nchunks)
        # Whole inputs land as (C, nchunks, cs, ...) in the step's own
        # layout (channels over 'chan', each chunk over 'time'), so taking
        # chunk c moves no data between devices.
        chunked = NamedSharding(self.mesh, P(self._chan, None, self._time))
        xs = [jax.device_put(
                  padded(x).reshape((x.shape[0], nchunks, cs) + x.shape[2:]),
                  chunked)
              for x in ext_inputs]
        for c in range(nchunks):
            pads, caps = self.step(*(
                jax.lax.dynamic_index_in_dim(x, c, 1, keepdims=False)
                for x in xs))
            collect(pads, caps)
        return self._mesh_finalize(outs_accum, sink_accum, n, counts_accum)

    def _run_device_mesh(self, xs, n_in, nchunks):
        """All chunks in one dispatch: lax.scan over the shard_map'd step
        (shard_map is traceable, so the whole sharded stream runs as one
        XLA program; chunking/unchunking live inside the jit)."""
        self._check_versions()
        cs = self.chunk_size
        key = ("mesh", nchunks)
        scan_jit = self._scan_cache.get(key)
        if scan_jit is None:
            sharded = self._sharded_local

            def scan_all(state, flat_xs):
                stk = tuple(
                    jnp.swapaxes(
                        x.reshape((x.shape[0], nchunks, cs) + x.shape[2:]),
                        0, 1)
                    for x in flat_xs)
                return jax.lax.scan(lambda s, ch: sharded(s, ch), state,
                                    stk, length=nchunks)

            scan_jit = jax.jit(
                scan_all, donate_argnums=(0,) if self._donate else ())
            self._scan_cache[key] = scan_jit
        self.state, (pads_stk, caps_stk) = scan_jit(self.state, tuple(xs))
        tagsrc_stk, tagdev_stk = self._pop_tag_caps(caps_stk)
        planes = self._chan_planes if hasattr(self, "_chan_planes") else None
        if tagsrc_stk or tagdev_stk or (
                planes is not None and any(p.tagged for p in planes)):
            # host replay per chunk x channel (see StreamExecutor
            #._run_device): records are (nchunks, nchannels, ...).
            # Read each stacked record back in ONE transfer, then slice on
            # the host.
            tagsrc_stk = jax.tree_util.tree_map(np.asarray, tagsrc_stk)
            tagdev_stk = {name: {k: np.asarray(v) for k, v in rec.items()}
                          for name, rec in tagdev_stk.items()}
            for c in range(nchunks):
                self._advance_mesh_tags(
                    jax.tree_util.tree_map(lambda a: a[c], tagsrc_stk),
                    {name: {k: v[c] for k, v in rec.items()}
                     for name, rec in tagdev_stk.items()})
        else:
            self._bump_counters(nchunks)
        outs_accum: List[List] = [[] for _ in self.flat.out_pads]
        sink_accum: Dict[str, List] = {}
        counts_accum: List[Dict[str, np.ndarray]] = []
        for c in range(nchunks):
            pads_c, caps_c = jax.tree_util.tree_map(
                lambda a: a[c], (pads_stk, caps_stk))
            for i, v in enumerate(pads_c):
                outs_accum[i].append(v)
            for name, vals in caps_c.items():
                if name == "__vr_counts__":
                    counts_accum.append(
                        {k: np.asarray(v).astype(np.int64)
                         for k, v in vals.items()})
                    continue
                sink_accum.setdefault(name, []).append(vals)
        return self._mesh_finalize(outs_accum, sink_accum, n_in,
                                   counts_accum)

    def _compact_chan(self, owner: Block, parts, counts_accum):
        """Per-channel emission compaction: each step's buffer is
        (nchannels, rows, items, ...) with that step's per-channel valid
        row counts; returns a list of per-channel streams.  Delegates to
        StreamExecutor._compact_emissions per channel (one compaction
        contract — and one dtype-safe readback path — for both
        executors)."""
        out = []
        for c in range(self.nchannels):
            parts_c = [p[c] for p in parts]
            counts_c = [{owner.name: int(cc[owner.name][c])}
                        for cc in counts_accum]
            out.append(self._compact_emissions(owner, parts_c, counts_c))
        return out

    def _mesh_finalize(self, outs_accum, sink_accum, n_in, counts_accum):
        pad_outs = []
        for i, parts in enumerate(outs_accum):
            if i in self._pad_emit_key:
                owner = self._emit_specs[self._pad_emit_key[i]][3]
                pad_outs.append(
                    self._compact_chan(owner, parts, counts_accum))
                continue
            full = jnp.concatenate(parts, axis=1) if parts else None
            if n_in is not None and full is not None:
                r = self._cumulative_rate(self.out_pad_edges[i])
                full = full[:, :int(n_in * r)]
            pad_outs.append(full)
        self.sink_data = {}
        byname = {b.name: b for b in self.order}
        for name, vals in sink_accum.items():
            b = byname[name]
            if self.block_owner[b.uid] is not None:
                owner = self.block_owner[b.uid]
                self.sink_data[name] = tuple(
                    self._compact_chan(owner, [v[j] for v in vals],
                                       counts_accum)
                    for j in range(len(vals[0]))
                )
            else:
                exact = None
                if n_in is not None:
                    ups = self.flat.upstream_of(b)
                    exact = int(n_in * self._cumulative_rate(ups[0]))
                self.sink_data[name] = tuple(
                    jnp.concatenate([v[j] for v in vals], axis=1)[:, :exact]
                    for j in range(len(vals[0]))
                )
        for name, vals in self.sink_data.items():
            byname[name].captured = vals
        if len(pad_outs) == 1:
            return pad_outs[0]
        return tuple(pad_outs)
