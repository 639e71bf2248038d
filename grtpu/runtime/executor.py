"""Time-block stream executor: the replacement for the reference scheduler.

Reference machinery being replaced (not ported):
  * gr_scheduler_tpb / gr_tpb_thread_body — one OS thread per block blocking
    on buffer condvars (gr_scheduler_tpb.cc:53-78, gr_tpb_thread_body.cc:41-106).
  * gr_block_executor::run_one_iteration — per-block demand computation,
    forecast, general_work dispatch (gr_block_executor.cc:181-409), including
    the variable-consumption demand negotiation for blocks like clock
    recovery (gr_block_executor.cc:302-350,
    digital_clock_recovery_mm_cc.cc:160-217).
  * gr_buffer / gr_vmcircbuf — double-mapped circular buffers with reader
    history preload (gr_buffer.cc:110-213, gr_flat_flowgraph.cc:124-152).

Design: the whole flattened DAG is traced once into a single
jitted ``step(state, ext_inputs) -> (state, outputs)`` over a fixed-size
*time-block* (chunk).  Pipeline parallelism between blocks becomes instruction
-level and fusion parallelism inside one XLA program; buffer handoff becomes
SSA values in device memory; history preload becomes explicit carried tail state
(the halo).  Rates are propagated statically at compile time, replacing
``forecast()``: every edge's per-step item count is known before tracing.

Variable-rate blocks (clock recovery, pfb clock sync, arbitrary resamplers)
are first-class graph citizens: a block with ``variable_rate=True`` returns
``(y_padded, n_valid)`` with the valid items a contiguous prefix.  The
executor compacts those into a carried device FIFO (capacity
``n_emit - 1 + max_out``) and drains fixed-size ``n_emit`` *emissions*
through the entire downstream sub-graph inside a ``lax.while_loop`` — all
within the same jitted step.  Downstream blocks are unmodified: they always
see exactly ``n_emit`` real items.  This replaces the reference scheduler's
runtime demand negotiation with a static-shape producer/consumer queue whose
occupancy is the only dynamic quantity.  Outputs downstream of a
variable-rate boundary surface as (max_emissions, n, ...) emission buffers
plus a per-step emission count; ``run()``/``stream()`` compact them on the
host.

The executor state — all block states, edge tails and VR FIFOs — is one
pytree: checkpointable (SURVEY.md §5.4 notes the reference has no
checkpointing) and shardable with jax.sharding for multi-chip execution
(grtpu.parallel).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Dict, Iterable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, Port
from grtpu.runtime.graph import Edge, FlatGraph, Graph, Pad
from grtpu.runtime.tags import Tag, propagate_tags


def _edge_key(e: Edge) -> str:
    s = e.src.block
    sname = s.name if isinstance(s, (Block,)) else s.name
    return f"{sname}.{e.src.port}->{e.dst.block.name}.{e.dst.port}"


class _RateMismatch(ValueError):
    """A join's inputs disagree; carries (source_root, have, need)
    rescale candidates for the demand-balancing retry loop."""

    def __init__(self, msg, candidates):
        super().__init__(msg)
        self.candidates = candidates


def _ingest(x):
    """Host input -> device (device arrays pass through untouched)."""
    return jnp.asarray(x)


class _TagPlane:
    """Host-side tag state for ONE linear stream: per-edge tag queues, the
    set of edges with tags in flight, and terminal stores (sink/pad tags).
    StreamExecutor owns one; MeshExecutor owns one per channel — the
    propagation *plan* (topology, counters) is shared across planes."""

    __slots__ = ("tags", "tagged", "sink_tags", "pad_tags")

    def __init__(self, edge_keys):
        self.tags: Dict[str, List[Tag]] = {k: [] for k in edge_keys}
        self.tagged: set = set()
        self.sink_tags: Dict[str, List[Tag]] = {}
        self.pad_tags: Dict[int, List[Tag]] = {}


class StreamExecutor:
    """Compile + run a flowgraph over fixed-size time-blocks.

    Args:
      graph: a :class:`Graph` (flattened automatically) or :class:`FlatGraph`.
      chunk_size: items produced per step by each root (input pad or source
        block).  Must be a multiple of every decimation chain; use
        :meth:`required_multiple` to query.
      root_chunks: optional per-root overrides ``{pad_or_block: n}``.
      vr_chunks: optional per-variable-rate-block emission size overrides
        ``{block: n_emit}`` (default: the expected per-step production,
        snapped to the downstream segment's decimation multiple).
      donate: donate the state buffers to the jitted step (in-place update).
    """

    def __init__(
        self,
        graph: Graph | FlatGraph,
        chunk_size: Optional[int] = 4096,
        root_chunks: Optional[Dict[Any, int]] = None,
        vr_chunks: Optional[Dict[Any, int]] = None,
        donate: bool = True,
        debug_taps: bool = False,
        fuse_firs: bool = False,
    ):
        self.flat = graph.flatten() if isinstance(graph, Graph) else graph
        if fuse_firs:
            # algebraic LTI fusion (grtpu.runtime.optimize): adjacent
            # FirFilter chains collapse into composed filters before tracing
            from grtpu.runtime.optimize import fuse_fir_chains

            self.flat = fuse_fir_chains(self.flat)
        self.order = self.flat.topological_order()
        self.debug_taps = debug_taps
        self.edge_data: Dict[str, Any] = {}
        self._compute_topology()
        if chunk_size is None:
            # auto: smallest multiple of the decimation requirement >= 4096
            m = self.required_multiple()
            chunk_size = -(-4096 // m) * m
        self.chunk_size = int(chunk_size)
        root_chunks = dict(root_chunks or {})
        # demand balancing: the reference scheduler produces from each
        # source exactly as fast as its consumers drain it
        # (gr_block_executor demand negotiation); statically, a join whose
        # branches come from different SOURCE roots determines each root's
        # per-step production.  Retry rate propagation, scaling source
        # roots until all joins agree.
        for _ in range(32):
            try:
                self._compute_rates(root_chunks, vr_chunks or {})
                break
            except _RateMismatch as e:
                fixed = False
                for src_block, have, need in e.candidates:
                    if need % have == 0:
                        cur = root_chunks.get(src_block, self.chunk_size)
                        root_chunks[src_block] = cur * (need // have)
                        fixed = True
                        break
                if not fixed:
                    raise ValueError(str(e)) from None
        else:
            raise ValueError("could not balance source rates")
        self._init_state()
        self._donate = donate and not debug_taps
        self._build_step(self._donate)
        # host-side stream-tag store per edge key, and absolute item
        # counters.  One _TagPlane per linear stream: StreamExecutor has
        # exactly one; MeshExecutor holds one per channel.  The legacy
        # attribute names alias the plane's containers (same objects).
        self._plane = _TagPlane(self._edge_keys)
        self._tags: Dict[str, List[Tag]] = self._plane.tags
        self.sink_tags: Dict[str, List[Tag]] = self._plane.sink_tags
        self.pad_tags: Dict[int, List[Tag]] = self._plane.pad_tags
        self.nitems = {b.name: 0 for b in self.order}  # items consumed so far
        self.nitems_out = {b.name: 0 for b in self.order}  # items produced
        self._vr_counts_accum: Dict[str, List[int]] = {
            v.name: [] for v in self.vr_blocks
        }
        self._build_tag_plan()
        self._scan_cache: Dict[int, Any] = {}
        # Stale-parameter guard: block params (taps, constants, ...) are
        # baked into the traced program; a post-build setter would silently
        # produce stale output.  Snapshot versions; step() raises on drift.
        self._global_version_snap = Block._global_version[0]
        self._block_versions = {b.uid: b._version for b in self.order}

    def _check_versions(self):
        """Raise if any block parameter changed after this executor was
        built (the set_taps-on-a-built-executor silent-no-op trap).  O(1)
        in the common case via the class-wide version counter."""
        if Block._global_version[0] == self._global_version_snap:
            return
        stale = [b.name for b in self.order
                 if b._version != self._block_versions[b.uid]]
        if stale:
            raise RuntimeError(
                f"block parameters changed after the executor was built "
                f"({', '.join(stale)}); rebuild the executor (or use "
                f"TopBlock.lock()/unlock(), which preserves state) — "
                f"baked-in constants cannot be updated in a compiled step")
        # someone touched a block outside this graph; resnapshot so the
        # fast path stays O(1)
        self._global_version_snap = Block._global_version[0]

    # ------------------------------------------------------------------ rates
    def _compute_topology(self):
        """Ownership/depth topology: which variable-rate block's drain loop
        each block runs in (None = top level), analogous to which scheduler
        "domain" it belongs to."""
        self.block_owner: Dict[int, Optional[Block]] = {}
        self.block_depth: Dict[int, int] = {}
        self.vr_blocks: List[Block] = []
        for b in self.order:
            ups = self.flat.upstream_of(b)
            if not ups:
                owner, depth = None, 0
            else:
                owners, depths = set(), set()
                for e in ups.values():
                    src = e.src.block
                    if isinstance(src, Pad):
                        owners.add(None)
                        depths.add(0)
                    elif src.variable_rate:
                        owners.add(src)
                        depths.add(self.block_depth[src.uid] + 1)
                    else:
                        owners.add(self.block_owner[src.uid])
                        depths.add(self.block_depth[src.uid])
                if len(owners) != 1 or len(depths) != 1:
                    raise ValueError(
                        f"{b.name}: inputs join streams from different "
                        f"variable-rate domains; such joins cannot be "
                        f"rate-aligned (reference has the same restriction "
                        f"implicitly via scheduler deadlock)"
                    )
                owner, depth = owners.pop(), depths.pop()
            self.block_owner[b.uid] = owner
            self.block_depth[b.uid] = depth
            if b.variable_rate:
                # multi-output VR blocks (e.g. pfb_clock_sync's data/err/
                # rate/phase) produce all ports in lockstep: one shared
                # valid count, one FIFO buffer per port.
                self.vr_blocks.append(b)

    def _compute_rates(self, root_chunks, vr_chunks):
        """Static rate propagation, replacing gr_block::forecast().

        Every edge gets a per-step item count; every block gets its per-step
        input count n_in.  Mirrors the arithmetic of
        gr_flat_flowgraph.cc:89-122 (buffer sizing vs decimation) but exactly,
        at compile time.  Blocks downstream of a variable-rate block get
        per-*emission* counts instead, derived from that block's chosen
        emission size.
        """
        self.edge_items: Dict[str, int] = {}
        self.block_nin: Dict[int, int] = {}
        pad_chunk = {}
        for pad in self.flat.in_pads:
            pad_chunk[id(pad)] = int(root_chunks.get(pad, self.chunk_size))
        self._pad_chunk = pad_chunk

        # per-block input counts, choosing each VR block's
        # emission size from its sub-segment's decimation multiple.
        self.vr_emit: Dict[int, int] = {}     # vr uid -> items per emission
        self.vr_maxout: Dict[int, int] = {}   # vr uid -> padded apply output
        self.vr_cap: Dict[int, int] = {}      # vr uid -> fifo capacity
        self.vr_emax: Dict[int, int] = {}     # vr uid -> per-step emission bound

        def _owner_chunk(owner: Optional[Block]) -> int:
            """Items entering the segment per execution of that segment."""
            if owner is None:
                return self.chunk_size
            return self.vr_emit[owner.uid]

        for b in self.order:
            ups = self.flat.upstream_of(b)
            owner = self.block_owner[b.uid]
            if not ups:  # source block
                n_in = int(root_chunks.get(b, self.chunk_size)) * b.decim // b.interp
            else:
                counts = {}
                for i, e in ups.items():
                    src = e.src.block
                    if isinstance(src, Pad):
                        counts[i] = pad_chunk[id(src)]
                    else:
                        counts[i] = self.edge_items[_edge_key(e)]
                if len(set(counts.values())) != 1:
                    need = math.lcm(*counts.values())
                    cands = []
                    for i, c in counts.items():
                        if c == need:
                            continue
                        root = self._source_root_of(ups[i])
                        if root is not None:
                            cands.append((root, c, need))
                    raise _RateMismatch(
                        f"{b.name}: input ports receive unequal chunk sizes "
                        f"{sorted(set(counts.values()))}; insert "
                        f"rate-matching blocks or rescale the sources",
                        cands)
                n_in = next(iter(counts.values()))
            if n_in % b.decim:
                raise ValueError(
                    f"{b.name}: per-step input {n_in} not divisible by "
                    f"decim={b.decim}; pick chunk_size a multiple of "
                    f"{self.required_multiple()}"
                )
            self.block_nin[b.uid] = n_in
            if b.variable_rate:
                delivered = n_in + b.history - 1
                max_out = int(b.max_out_for(delivered))
                sub_mult = self._segment_multiple(b)
                if b in (vr_chunks or {}):
                    n_emit = int(vr_chunks[b])
                    if n_emit % sub_mult:
                        raise ValueError(
                            f"{b.name}: vr_chunks emission size {n_emit} not "
                            f"a multiple of downstream requirement {sub_mult}"
                        )
                else:
                    expected = n_in * float(b.nominal_rate)
                    n_emit = max(sub_mult,
                                 int(expected // sub_mult) * sub_mult)
                cap = n_emit - 1 + max_out
                self.vr_emit[b.uid] = n_emit
                self.vr_maxout[b.uid] = max_out
                self.vr_cap[b.uid] = cap
                self.vr_emax[b.uid] = cap // n_emit
                n_out = n_emit
            else:
                n_out = n_in // b.decim * b.interp
            for e in self.flat.downstream_of(b):
                self.edge_items[_edge_key(e)] = n_out

        # total emission-buffer rows for a segment = product of emission
        # bounds down the owner chain (nested VR drains multiply).
        self.vr_total_rows: Dict[int, int] = {}
        for v in self.vr_blocks:
            rows = self.vr_emax[v.uid]
            o = self.block_owner[v.uid]
            while o is not None:
                rows *= self.vr_emax[o.uid]
                o = self.block_owner[o.uid]
            self.vr_total_rows[v.uid] = rows

        # output pads
        self.out_pad_edges: List[Edge] = []
        for pad in self.flat.out_pads:
            feed = [e for e in self.flat.edges if e.dst.block is pad]
            if len(feed) != 1:
                raise ValueError(f"output pad {pad.name} must have exactly one driver")
            self.out_pad_edges.append(feed[0])

        self._edge_keys = [
            _edge_key(e) for e in self.flat.edges if isinstance(e.dst.block, Block)
        ]

    def _source_root_of(self, e: Edge) -> Optional[Block]:
        """The unique SOURCE block feeding this edge's path, if any —
        the block whose per-step production the demand balancer may
        rescale.  None if the path starts at an input pad or mixes
        several distinct roots."""
        src = e.src.block
        if isinstance(src, Pad):
            return None
        ups = self.flat.upstream_of(src)
        if not ups:
            return src
        roots = {self._source_root_of(up) for up in ups.values()}
        return roots.pop() if len(roots) == 1 else None

    def _edge_owner(self, e: Edge) -> Optional[Block]:
        src = e.src.block
        if isinstance(src, Pad):
            return None
        if src.variable_rate:
            return src
        return self.block_owner[src.uid]

    def _segment_multiple(self, owner: Optional[Block]) -> int:
        """Chunk-size divisibility requirement for the blocks directly owned
        by ``owner`` (None = the top-level segment): exact denominator-based
        derivation.  For input count C*r (r the cumulative rate fraction)
        to be a positive multiple of decim, C must be a multiple of
        decim*den(r)/gcd(num(r), decim*den(r))."""
        mult = 1
        rate_to: Dict[int, Fraction] = {}
        for b in self.order:
            if self.block_owner[b.uid] is not owner:
                continue
            ups = self.flat.upstream_of(b)
            srcs = [e.src.block for e in ups.values()]
            rs = set()
            for s in srcs:
                if isinstance(s, Pad) or (isinstance(s, Block) and s.variable_rate):
                    rs.add(Fraction(1))
                elif s.uid in rate_to:
                    rs.add(rate_to[s.uid])
            r = rs.pop() if rs else Fraction(1)
            need = (b.decim * r.denominator) // math.gcd(
                r.numerator, b.decim * r.denominator
            )
            mult = math.lcm(mult, need)
            rate_to[b.uid] = r * Fraction(b.interp, b.decim)
        return mult

    def required_multiple(self) -> int:
        """Exact chunk-size divisibility requirement of the top-level
        segment (decimation chains up to the first variable-rate boundary;
        segments behind a boundary constrain the executor-chosen emission
        size instead)."""
        return self._segment_multiple(None)

    # ------------------------------------------------------------------ state
    def _make_state(self):
        """Build the initial state pytree (called under jit)."""
        block_states = {str(b.uid): b.init_state() for b in self.order}
        tails = {}
        for b in self.order:
            if b.history > 1:
                for i, e in self.flat.upstream_of(b).items():
                    port = b.in_ports[i]
                    tails[_edge_key(e)] = jnp.zeros(
                        port.chunk_shape(b.history - 1), port.dtype
                    )
        fifos = {}
        for v in self.vr_blocks:
            bufs = tuple(
                jnp.zeros(port.chunk_shape(self.vr_cap[v.uid]),
                          port.dtype)
                for port in v.out_ports
            )
            fifos[v.name] = (bufs, jnp.zeros((), jnp.int32))
        return {"blocks": block_states, "tails": tails, "fifo": fifos}

    def _init_state(self):
        # one jitted program builds every state leaf in one dispatch
        self.state = jax.jit(self._make_state)()

    # ------------------------------------------------------------------ step
    def _build_step(self, donate: bool):
        flat = self.flat
        order = self.order
        out_pad_edges = self.out_pad_edges
        has_vr = bool(self.vr_blocks)
        # emission-buffer specs: pads and sink inputs fed from inside a VR
        # segment surface as (rows, items, ...) buffers + a per-VR counter.
        emit_specs: Dict[str, tuple] = {}  # key -> (rows, items, port, owner)
        self._pad_emit_key: Dict[int, str] = {}
        self._sink_emit_key: Dict[tuple, str] = {}
        for i, e in enumerate(out_pad_edges):
            o = self._edge_owner(e)
            if o is not None:
                key = f"pad{i}"
                port = self.flat.out_pads[i].port
                emit_specs[key] = (self.vr_total_rows[o.uid],
                                   self.edge_items[_edge_key(e)], port, o)
                self._pad_emit_key[i] = key
        for b in order:
            if b.out_ports or not b.in_ports:
                continue
            if self.block_owner[b.uid] is not None:
                o = self.block_owner[b.uid]
                for j, e in self.flat.upstream_of(b).items():
                    key = f"sink:{b.name}:{j}"
                    emit_specs[key] = (self.vr_total_rows[o.uid],
                                       self.edge_items[_edge_key(e)],
                                       b.in_ports[j], o)
                    self._sink_emit_key[(b.name, j)] = key
        self._emit_specs = emit_specs

        def upd(d, k, v):
            d2 = dict(d)
            d2[k] = v
            return d2

        def run_segment(owner: Optional[Block], ctx, edge_vals, ext_inputs,
                        caps):
            """Run all blocks owned by ``owner`` in topo order, threading
            the mutable context (block states, tails, fifos, emission
            buffers, emission counters) functionally.  ``edge_vals`` holds
            this segment's local SSA edge values."""
            for b in order:
                if self.block_owner[b.uid] is not owner:
                    continue
                ups = flat.upstream_of(b)
                ins = []
                for i in range(len(b.in_ports)):
                    e = ups[i]
                    src = e.src.block
                    if isinstance(src, Pad):
                        v = ext_inputs[src.index]
                    else:
                        v = edge_vals[_edge_key(e)]
                    if b.history > 1:
                        k = _edge_key(e)
                        full = jnp.concatenate([ctx["tails"][k], v], axis=0)
                        ctx = upd(ctx, "tails", upd(
                            ctx["tails"], k,
                            full[full.shape[0] - (b.history - 1):]))
                        v = full
                    ins.append(v)
                if not b.in_ports:
                    n_out = self.block_nin[b.uid] // b.decim * b.interp
                    new_s, outs = self._apply_source(
                        b, ctx["blocks"][str(b.uid)], n_out)
                elif b.variable_rate:
                    res = b.apply(ctx["blocks"][str(b.uid)], *ins)
                    new_s, vr_out = res
                    if not (isinstance(vr_out, (tuple, list)) and len(vr_out) == 2):
                        raise ValueError(
                            f"{b.name}: variable-rate apply must return "
                            f"(state, (y_padded, n_valid))")
                    outs = None
                elif b.emits_tags and b.device_tags and owner is None:
                    # in-jit tag detection (device_tags): the block returns
                    # a small statically-shaped record alongside its
                    # outputs; only that record crosses to the host
                    res = b.apply_tagged(ctx["blocks"][str(b.uid)], *ins)
                    new_s, outs, tagrec = res
                    if not isinstance(outs, (tuple, list)):
                        outs = (outs,)
                    outs = tuple(outs)
                    caps["__tagdev__" + b.name] = dict(tagrec)
                else:
                    new_s, outs = self._apply_block(
                        b, ctx["blocks"][str(b.uid)], ins)
                ctx = upd(ctx, "blocks", upd(ctx["blocks"], str(b.uid), new_s))
                if (b.emits_tags and not b.device_tags and owner is None
                        and outs is not None):
                    # legacy host-side tag synthesis taps (make_tags):
                    # capture this block's full in/out chunks
                    caps["__tagsrc__" + b.name] = (tuple(ins), tuple(outs))
                if not b.out_ports and ins:
                    if owner is None:
                        caps[b.name] = tuple(ins)
                    else:
                        # write each captured input as one emission row
                        row = ctx["ecnt"][owner.name]
                        em = dict(ctx["emit"])
                        for j, v in enumerate(ins):
                            key = self._sink_emit_key[(b.name, j)]
                            em[key] = jax.lax.dynamic_update_index_in_dim(
                                em[key], v, row, 0)
                        ctx = upd(ctx, "emit", em)
                if b.variable_rate:
                    ctx = push_and_drain(b, ctx, vr_out, ext_inputs, caps)
                else:
                    for e in [e for e in flat.edges if e.src.block is b]:
                        edge_vals[_edge_key(e)] = outs[e.src.port]
            return ctx, edge_vals

        def write_pad_rows(owner: Block, ctx, edge_vals):
            """Emit rows for out pads fed from inside this segment."""
            em = dict(ctx["emit"])
            wrote = False
            for i, e in enumerate(out_pad_edges):
                if self._edge_owner(e) is None:
                    continue
                key = self._pad_emit_key[i]
                if emit_specs[key][3] is not owner:
                    continue
                k = _edge_key(e)
                if k in edge_vals:
                    row = ctx["ecnt"][owner.name]
                    em[key] = jax.lax.dynamic_update_index_in_dim(
                        em[key], edge_vals[k], row, 0)
                    wrote = True
            return upd(ctx, "emit", em) if wrote else ctx

        def push_and_drain(v: Block, ctx, vr_out, ext_inputs, caps):
            """Compact (y_padded, n_valid) into v's FIFO, then drain full
            n_emit emissions through v's downstream segment in a
            lax.while_loop.  Valid items are a contiguous prefix, so writing
            the whole padded array at the fill pointer and advancing by
            n_valid leaves the garbage suffix to be overwritten by the next
            push — no per-item masking needed.  Multi-output VR blocks keep
            one buffer per port advancing in lockstep on a shared count."""
            n_emit = self.vr_emit[v.uid]
            ys, n_valid = vr_out
            if not isinstance(ys, (tuple, list)):
                ys = (ys,)
            if len(ys) != len(v.out_ports):
                raise ValueError(
                    f"{v.name}: variable-rate apply returned {len(ys)} "
                    f"padded outputs, declared {len(v.out_ports)} ports")
            bufs, fill = ctx["fifo"][v.name]
            bufs = tuple(
                jax.lax.dynamic_update_slice_in_dim(
                    buf, y.astype(buf.dtype), fill, 0)
                for buf, y in zip(bufs, ys))
            fill = fill + n_valid.astype(jnp.int32)
            ctx = upd(ctx, "fifo", upd(ctx["fifo"], v.name, (bufs, fill)))

            down_edges = flat.downstream_of(v)

            def cond_fn(c):
                return c["fifo"][v.name][1] >= n_emit

            def body_fn(c):
                b2, f2 = c["fifo"][v.name]
                xs = tuple(b[:n_emit] for b in b2)
                shifted = tuple(
                    jnp.concatenate(
                        [b[n_emit:],
                         jnp.zeros((n_emit,) + b.shape[1:], b.dtype)],
                        axis=0)
                    for b in b2)
                c = upd(c, "fifo", upd(c["fifo"], v.name,
                                       (shifted, f2 - n_emit)))
                ev = {_edge_key(e): xs[e.src.port] for e in down_edges}
                c, ev = run_segment(v, c, ev, ext_inputs, caps)
                c = write_pad_rows(v, c, ev)
                c = upd(c, "ecnt", upd(c["ecnt"], v.name,
                                       c["ecnt"][v.name] + 1))
                return c

            return jax.lax.while_loop(cond_fn, body_fn, ctx)

        def step(state, ext_inputs):
            ctx = {
                "blocks": dict(state["blocks"]),
                "tails": dict(state["tails"]),
                "fifo": dict(state["fifo"]),
            }
            if has_vr:
                ctx["emit"] = {
                    key: jnp.zeros((rows,) + port.chunk_shape(items),
                                   port.dtype)
                    for key, (rows, items, port, _o) in emit_specs.items()
                }
                ctx["ecnt"] = {v.name: jnp.zeros((), jnp.int32)
                               for v in self.vr_blocks}
            caps: Dict[str, Any] = {}
            edge_vals: Dict[str, Any] = {}
            ctx, edge_vals = run_segment(None, ctx, edge_vals, ext_inputs,
                                         caps)

            pad_outs = []
            for i, e in enumerate(out_pad_edges):
                if self._edge_owner(e) is None:
                    src = e.src.block
                    if isinstance(src, Pad):
                        pad_outs.append(ext_inputs[src.index])
                    else:
                        pad_outs.append(edge_vals[_edge_key(e)])
                else:
                    pad_outs.append(ctx["emit"][self._pad_emit_key[i]])
            pad_outs = tuple(pad_outs)

            if has_vr:
                for b in order:
                    if (not b.out_ports and b.in_ports
                            and self.block_owner[b.uid] is not None):
                        caps[b.name] = tuple(
                            ctx["emit"][self._sink_emit_key[(b.name, j)]]
                            for j in range(len(b.in_ports)))
                # emission counts, f32 for transport-safe host readback
                caps["__vr_counts__"] = {
                    v.name: ctx["ecnt"][v.name].astype(jnp.float32)
                    for v in self.vr_blocks
                }
            new_state = {"blocks": ctx["blocks"], "tails": ctx["tails"],
                         "fifo": ctx["fifo"]}
            if self.debug_taps:
                # §5.1 debug-tap idiom (generic_mod_demod.py:155-169 log=True
                # wires a file sink at every stage): expose every top-level
                # edge value (VR-segment edges live inside the drain loop)
                caps = dict(caps)
                caps["__edges__"] = dict(edge_vals)
            return new_state, (pad_outs, caps)

        self._step_fn = step
        self._jit_step = jax.jit(step, donate_argnums=(0,) if donate else ())
        self._sinks = [b for b in order if not b.out_ports]

    def step_fn(self):
        """The raw jittable step: ``(state, ext_inputs) -> (state', (pads,
        caps))`` over one time-block.  Public surface for embedding the
        compiled flowgraph in a larger jitted program (drivers, sharded
        wrappers, device-side loops); pair with :attr:`state` for the
        initial carry."""
        return self._step_fn

    @staticmethod
    def _apply_source(b: Block, state, n: int):
        res = b.apply(state, n)
        new_s, outs = res
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        return new_s, tuple(outs)

    @staticmethod
    def _apply_block(b: Block, state, ins):
        res = b.apply(state, *ins)
        new_s, outs = res
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        if len(outs) != len(b.out_ports):
            raise ValueError(
                f"{b.name}: apply returned {len(outs)} outputs, "
                f"declared {len(b.out_ports)} ports"
            )
        return new_s, tuple(outs)

    # ------------------------------------------------------------------ run
    def step(self, *ext_inputs):
        """Run one time-block; returns (pad_outputs, sink_captures).

        Outputs behind a variable-rate boundary are raw emission buffers
        shaped (max_emissions, items, ...); the count of valid rows for
        this step is in sink_captures["__vr_counts__"].  ``run``/``stream``
        compact them automatically.
        """
        self._check_versions()
        ext_inputs = tuple(_ingest(x) for x in ext_inputs)
        for pad, x in zip(self.flat.in_pads, ext_inputs):
            want = self.chunk_size
            if x.shape[0] != want:
                raise ValueError(
                    f"input pad {pad.index}: expected {want} items, got {x.shape[0]}"
                )
        self.state, out = self._jit_step(self.state, ext_inputs)
        pads, caps = out
        tagsrc, tagdev = self._pop_tag_caps(caps)
        self._advance_tags(self._emitted_from_caps(tagsrc, tagdev))
        return pads, caps

    def run(self, *ext_inputs, steps: Optional[int] = None,
            device_loop: bool = False):
        """Feed full arrays, stream them through in chunks, return full outputs.

        The analog of ``tb.run()``: finite-input execution.  Trailing items
        that do not fill a whole chunk are zero-padded and the outputs
        truncated to the exact rational length (fixed-rate pads) or to the
        exact emission count (variable-rate pads; items still queued in a
        VR FIFO at the end — less than one emission — remain in the carried
        state, like items left in reference buffers at stop()).

        ``device_loop=True`` runs ALL chunks in one dispatch as a
        ``lax.scan`` over the stacked input — the whole host control plane
        (one python dispatch per chunk) collapses to a single call, making
        small-chunk finite runs device-bound.  Tags are a host-plane
        feature and cannot ride the device loop."""
        n_pads = len(self.flat.in_pads)
        if len(ext_inputs) != n_pads:
            raise ValueError(f"graph has {n_pads} input pads, got {len(ext_inputs)}")

        if n_pads == 0:
            assert steps is not None, "source-driven graph needs steps="
            if device_loop:
                return self._run_device((), None, steps)
            outs_accum = [[] for _ in self.flat.out_pads]
            sink_accum: Dict[str, List] = {}
            counts_accum: List[Dict[str, int]] = []
            for _ in range(steps):
                pads, sinks = self.step()
                self._collect(pads, sinks, outs_accum, sink_accum, counts_accum)
            return self._finalize(outs_accum, sink_accum, None, counts_accum)

        xs = [_ingest(x) for x in ext_inputs]  # step() re-checks; cheap no-op
        n = xs[0].shape[0]
        cs = self.chunk_size
        nchunks = -(-n // cs)
        pad_to = nchunks * cs
        xs = [
            jnp.pad(x, [(0, pad_to - n)] + [(0, 0)] * (x.ndim - 1)) if pad_to != n else x
            for x in xs
        ]
        if device_loop:
            return self._run_device(tuple(xs), n, nchunks)
        outs_accum = [[] for _ in self.flat.out_pads]
        sink_accum: Dict[str, List] = {}
        counts_accum: List[Dict[str, int]] = []
        for c in range(nchunks):
            chunk = tuple(x[c * cs:(c + 1) * cs] for x in xs)
            pads, sinks = self.step(*chunk)
            self._collect(pads, sinks, outs_accum, sink_accum, counts_accum)
        return self._finalize(outs_accum, sink_accum, n, counts_accum)

    def _run_device(self, xs, n_in, nchunks):
        """All chunks in ONE jitted dispatch: lax.scan over the chunk axis.

        The device-side replacement for the reference's free-running
        scheduler on a finite input: zero host work per chunk.  The scan
        carries the full executor state, so the result is bit-identical to
        nchunks step() calls."""
        self._check_versions()
        if self.debug_taps:
            raise ValueError("device_loop does not support debug_taps")
        cs = self.chunk_size
        scan_jit = self._scan_cache.get(nchunks)
        if scan_jit is None:
            step_fn = self._step_fn
            flatten_pads = not self.vr_blocks

            def scan_all(state, flat_xs):
                # chunking + un-chunking live INSIDE the jit so the host
                # never dispatches eager reshapes of the full stream
                stk = tuple(x.reshape((nchunks, cs) + x.shape[1:])
                            for x in flat_xs)
                state, (pads_stk, caps_stk) = jax.lax.scan(
                    step_fn, state, stk, length=nchunks)
                if flatten_pads:
                    pads_stk = tuple(
                        p.reshape((-1,) + p.shape[2:]) for p in pads_stk)
                    caps_stk = {
                        # tag records keep their per-chunk leading axis:
                        # the host replays the tag plan chunk by chunk
                        name: vals if name.startswith("__tag") else
                        tuple(v.reshape((-1,) + v.shape[2:]) for v in vals)
                        for name, vals in caps_stk.items()
                    }
                return state, (pads_stk, caps_stk)

            # honor the executor's donate setting: a donate=False executor
            # may have handed out self.state (step_fn embedding surface) —
            # donating it here would delete buffers the caller still holds
            scan_jit = jax.jit(
                scan_all, donate_argnums=(0,) if self._donate else ())
            self._scan_cache[nchunks] = scan_jit
        self.state, (pads_stk, caps_stk) = scan_jit(self.state, tuple(xs))
        tagsrc_stk, tagdev_stk = self._pop_tag_caps(caps_stk)
        if self._tagged_edges or tagsrc_stk or tagdev_stk:
            # stream tags under device_loop: replay the host tag plan chunk
            # by chunk after the single dispatch.  Exact — propagation
            # depends only on the static chunk sizes plus the per-chunk
            # emission records the scan captured; results are identical to
            # nchunks step() calls.  _advance_tags bumps the counters.
            tagsrc_h = jax.tree_util.tree_map(np.asarray, tagsrc_stk)
            tagdev_h = {name: {k: np.asarray(v) for k, v in rec.items()}
                        for name, rec in tagdev_stk.items()}
            for c in range(nchunks):
                tagsrc_c = {
                    name: (tuple(a[c] for a in ins),
                           tuple(a[c] for a in outs))
                    for name, (ins, outs) in tagsrc_h.items()}
                tagdev_c = {name: {k: v[c] for k, v in rec.items()}
                            for name, rec in tagdev_h.items()}
                self._advance_tags(
                    self._emitted_from_caps(tagsrc_c, tagdev_c))
        else:
            self._bump_counters(nchunks)

        if self.vr_blocks:
            # per-chunk host compaction (emission counts differ per chunk).
            # Read the stacked buffers back in ONE transfer per array first,
            # not one device slice per chunk.
            pads_stk, caps_stk = jax.tree_util.tree_map(
                np.asarray, (pads_stk, caps_stk))
            outs_accum = [[] for _ in self.flat.out_pads]
            sink_accum: Dict[str, List] = {}
            counts_accum: List[Dict[str, int]] = []
            for c in range(nchunks):
                pads_c, caps_c = jax.tree_util.tree_map(
                    lambda a: a[c], (pads_stk, caps_stk))
                self._collect(pads_c, caps_c, outs_accum, sink_accum,
                              counts_accum)
            return self._finalize(outs_accum, sink_accum, n_in, counts_accum)

        # fixed-rate fast path: already flattened inside the jit
        pad_outs = []
        for i in range(len(self.flat.out_pads)):
            full = pads_stk[i]
            if n_in is not None:
                r = self._cumulative_rate(self.out_pad_edges[i])
                exact = int(n_in * r)
                if exact != full.shape[0]:
                    full = full[:exact]
            pad_outs.append(full)
        self.sink_data = {}
        byname = {b.name: b for b in self.order}
        for name, vals in caps_stk.items():
            b = byname[name]
            exact = None
            if n_in is not None:
                ups = self.flat.upstream_of(b)
                exact = int(n_in * self._cumulative_rate(ups[0]))
            self.sink_data[name] = tuple(
                v if exact is None or exact == v.shape[0] else v[:exact]
                for v in vals)
            b.captured = self.sink_data[name]
        if len(pad_outs) == 1:
            return pad_outs[0]
        return tuple(pad_outs)

    def stream(self, chunk_iter):
        """Generator-driven streaming: pull fixed-size chunks from an
        iterator (native ring buffer, UDP source, ...) and yield each
        step's pad outputs.  The analog of the reference's free-running
        scheduler fed by a hardware source, with backpressure implicit in
        the generator.  Variable-rate pads yield host-compacted arrays."""
        for chunk in chunk_iter:
            if not isinstance(chunk, (tuple, list)):
                chunk = (chunk,)
            pads, sinks = self.step(*[_ingest(c) for c in chunk])
            if self.vr_blocks:
                counts = {k: int(np.asarray(v))
                          for k, v in sinks["__vr_counts__"].items()}
                pads = tuple(
                    self._compact_emissions(
                        self._emit_specs[self._pad_emit_key[i]][3],
                        [p], [counts])
                    if i in self._pad_emit_key else p
                    for i, p in enumerate(pads))
            yield pads if len(pads) != 1 else pads[0]

    def _collect(self, pads, sinks, outs_accum, sink_accum, counts_accum=None):
        for i, v in enumerate(pads):
            outs_accum[i].append(v)
        for name, vals in sinks.items():
            if name == "__edges__":
                for k, ev in vals.items():
                    self.edge_data.setdefault(k, []).append(ev)
                continue
            if name == "__vr_counts__":
                counts = {k: int(np.asarray(v)) for k, v in vals.items()}
                if counts_accum is not None:
                    counts_accum.append(counts)
                for vname, cnt in counts.items():
                    self._vr_counts_accum[vname].append(cnt)
                continue
            sink_accum.setdefault(name, []).append(vals)

    def _compact_emissions(self, owner: Block, parts, counts_accum):
        """parts: per-chunk (rows, items, ...) emission buffers; keep each
        chunk's valid rows (that chunk's emission count for the owning VR
        block's segment) and flatten emissions into a contiguous stream."""
        out = []
        for p, counts in zip(parts, counts_accum):
            arr = np.asarray(p)[: int(counts[owner.name])]
            out.append(arr.reshape((-1,) + arr.shape[2:]))
        return np.concatenate(out, axis=0) if out else None

    def _finalize(self, outs_accum, sink_accum, n_in, counts_accum=None):
        counts_accum = counts_accum or []
        pad_outs = []
        for i, parts in enumerate(outs_accum):
            if i in self._pad_emit_key:
                owner = self._emit_specs[self._pad_emit_key[i]][3]
                pad_outs.append(
                    self._compact_emissions(owner, parts, counts_accum))
                continue
            full = jnp.concatenate(parts, axis=0) if parts else None
            if n_in is not None and full is not None:
                # truncate to exact rational output length for this pad
                e = self.out_pad_edges[i]
                r = self._cumulative_rate(e)
                exact = int(n_in * r)
                full = full[:exact]
            pad_outs.append(full)
        byname_rate = {}
        if n_in is not None:
            for b in self.order:
                if (not b.out_ports and b.in_ports
                        and self.block_owner[b.uid] is None):
                    ups = self.flat.upstream_of(b)
                    byname_rate[b.name] = self._cumulative_rate(ups[0])
        self.sink_data = {}
        byname = {b.name: b for b in self.order}
        for name, vals in sink_accum.items():
            b = byname[name]
            if self.block_owner[b.uid] is not None:
                owner = self.block_owner[b.uid]
                self.sink_data[name] = tuple(
                    self._compact_emissions(
                        owner, [v[j] for v in vals], counts_accum)
                    for j in range(len(vals[0]))
                )
            else:
                self.sink_data[name] = tuple(
                    jnp.concatenate([v[j] for v in vals], axis=0)[
                        : (int(n_in * byname_rate[name])
                           if n_in is not None and name in byname_rate else None)
                    ]
                    for j in range(len(vals[0]))
                )
        # Write captures back onto sink blocks for convenient access
        # (the analog of vector_sink_X::data()).
        for name, vals in self.sink_data.items():
            byname[name].captured = vals
        if len(pad_outs) == 1:
            return pad_outs[0]
        return tuple(pad_outs)

    def _cumulative_rate(self, edge: Edge) -> Fraction:
        """Total interp/decim product from roots to this edge's source."""
        rate: Dict[int, Fraction] = {}
        for b in self.order:
            ups = self.flat.upstream_of(b)
            if not ups:
                r = Fraction(1)
            else:
                anc = []
                for e in ups.values():
                    if isinstance(e.src.block, Block):
                        anc.append(rate[e.src.block.uid])
                    else:
                        anc.append(Fraction(1))
                r = anc[0]
            rate[b.uid] = r * Fraction(b.interp, b.decim)
        src = edge.src.block
        if isinstance(src, Pad):
            return Fraction(1)
        return rate[src.uid]

    # ------------------------------------------------------------------ tags
    def _build_tag_plan(self):
        """Precompute the per-block tag-propagation topology once, so the
        per-step host control plane does no graph traversal, no edge-key
        string formatting, and — via the tagged-edge set — no work at all
        for blocks with no tags in flight on their inputs.  This is the
        incremental analog of the reference's per-iteration tag pass
        (gr_block_executor.cc:91-156), which only ever looks at the one
        block's own buffers."""
        self._tagged_edges: set = self._plane.tagged
        self._count_inc: List[tuple] = []
        self._tag_plan: List[tuple] = []
        for b in self.order:
            n_in = self.block_nin[b.uid]
            n_out = (n_in // b.decim * b.interp if not b.variable_rate
                     else int(n_in * b.nominal_rate))
            self._count_inc.append((b.name, n_in, n_out))
            ups = self.flat.upstream_of(b)
            in_list = [(i, _edge_key(e)) for i, e in sorted(ups.items())]
            down_list = []
            for e in self.flat.downstream_of(b):
                dst_pad = (e.dst.block.index
                           if isinstance(e.dst.block, Pad) else None)
                down_list.append((e.src.port, _edge_key(e), dst_pad))
            self._tag_plan.append((b, in_list, down_list, n_in))

    def _bump_counters(self, steps: int = 1):
        for name, n_in, n_out in self._count_inc:
            self.nitems[name] += n_in * steps
            self.nitems_out[name] += n_out * steps

    def add_tags(self, pad_index: int, tags: Sequence[Tag]):
        """Attach stream tags to an input pad's stream (absolute offsets)."""
        for e in self.flat.edges:
            if isinstance(e.src.block, Pad) and e.src.block.index == pad_index:
                k = _edge_key(e)
                self._tags[k].extend(tags)
                self._tagged_edges.add(k)

    @staticmethod
    def _pop_tag_caps(caps):
        """Split the emitting-block records out of a caps dict: returns
        ({name: (ins, outs)}, {name: tagrec}) for the legacy make_tags
        captures and the device_tags records respectively."""
        tagsrc = {k[len("__tagsrc__"):]: caps.pop(k)
                  for k in list(caps) if k.startswith("__tagsrc__")}
        tagdev = {k[len("__tagdev__"):]: caps.pop(k)
                  for k in list(caps) if k.startswith("__tagdev__")}
        return tagsrc, tagdev

    def _emitted_from_caps(self, tagsrc, tagdev, nitems=None, nitems_out=None):
        """Materialize one chunk's emitted Tags from the two cap kinds."""
        if not tagsrc and not tagdev:
            return None
        nitems = self.nitems if nitems is None else nitems
        nitems_out = self.nitems_out if nitems_out is None else nitems_out
        byname = {b.name: b for b in self.order}
        emitted: Dict[str, List[Tag]] = {}
        for name, (ins, outs) in tagsrc.items():
            b = byname[name]
            emitted[name] = b.make_tags(
                tuple(np.asarray(a) for a in ins),
                tuple(np.asarray(a) for a in outs),
                nitems[name], nitems_out[name])
        for name, rec in tagdev.items():
            b = byname[name]
            rec_h = {k: np.asarray(v) for k, v in rec.items()}
            emitted[name] = b.tags_from_device(
                rec_h, nitems[name], nitems_out[name])
        return emitted

    def _advance_tags(self, emitted: Optional[Dict[str, List[Tag]]] = None):
        """Host-side per-chunk tag propagation (gr_block_executor.cc:91-156).

        Policies follow the reference: TPP_DONT consumes input tags without
        forwarding; TPP_ALL_TO_ALL scales every input tag by relative_rate
        onto every output edge; TPP_ONE_TO_ONE maps input port i's tags to
        output port i's edges only.  ``emitted`` maps emitting-block names
        to this chunk's freshly synthesized Tags (from make_tags or
        tags_from_device — see _emitted_from_caps), injected onto their
        output edges (the add_item_tag analog).

        Across a variable-rate boundary, offsets are scaled by the block's
        *nominal* rate — the same approximation the reference makes when a
        block updates tags with set_relative_rate but consumes variably.

        Incremental: blocks whose input edges carry no tags this step are
        skipped entirely (O(1) set checks); with no tags anywhere the whole
        pass is two dict-increment loops — the host control plane must stay
        negligible next to a >1 Gsps data plane
        (benchmarks/executor_overhead_bench.py measures this).
        """
        if not emitted and not self._tagged_edges:
            self._bump_counters()
            return
        self._advance_plane(self._plane, emitted)
        self._bump_counters()

    def _advance_plane(self, plane: _TagPlane,
                       emitted: Optional[Dict[str, List[Tag]]]):
        """One stream-plane's tag pass for the current chunk (does NOT bump
        the shared counters — the caller advances them once per chunk, even
        when several channel planes advance)."""
        tagged = plane.tagged
        if emitted:
            byname = {b.name: b for b in self.order}
            for name, new in emitted.items():
                if not new:
                    continue
                b = byname[name]
                for e in self.flat.downstream_of(b):
                    k = _edge_key(e)
                    if k in plane.tags:
                        plane.tags[k].extend(new)
                        tagged.add(k)
                    elif isinstance(e.dst.block, Pad):
                        plane.pad_tags.setdefault(
                            e.dst.block.index, []).extend(new)

        for b, in_list, down_list, n_in in self._tag_plan:
            hit = [ik for ik in in_list if ik[1] in tagged]
            if not hit:
                continue
            start = self.nitems[b.name]
            limit = start + n_in
            in_by_port: Dict[int, List[Tag]] = {}
            for i, k in hit:
                lst = plane.tags[k]
                take = [t for t in lst if t.offset < limit]
                if take:
                    keep = [t for t in lst if t.offset >= limit]
                    plane.tags[k] = keep
                    if not keep:
                        tagged.discard(k)
                    in_by_port[i] = take
            if not in_by_port:
                continue
            all_in = [t for ts in in_by_port.values() for t in ts]
            if not b.out_ports:
                # terminal blocks retain their received tags for the host
                # (the analog of reading gr_buffer tags at a sink)
                plane.sink_tags.setdefault(b.name, []).extend(all_in)
                continue
            if b.tag_propagation == "dont":
                continue  # consumed, not forwarded (TPP_DONT)
            for src_port, k, dst_pad in down_list:
                if b.tag_propagation == "one_to_one":
                    src_tags = in_by_port.get(src_port, [])
                else:  # all_to_all
                    src_tags = all_in
                if not src_tags:
                    continue
                out_tags = propagate_tags(src_tags, b.relative_rate)
                if dst_pad is not None:
                    plane.pad_tags.setdefault(dst_pad, []).extend(out_tags)
                elif k in plane.tags:
                    plane.tags[k].extend(out_tags)
                    tagged.add(k)

    def dump_debug_taps(self, directory: str):
        """Write every edge's captured stream to <dir>/<edge>.dat (raw
        native items) — the log-every-stage debugging workflow."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths = {}
        for k, parts in self.edge_data.items():
            arr = np.concatenate([np.asarray(p) for p in parts], axis=0)
            safe = k.replace("/", "_").replace(">", "").replace(".", "_")
            path = os.path.join(directory, safe + ".dat")
            arr.tofile(path)
            paths[k] = path
        return paths

    # ------------------------------------------------------------------ ckpt
    def _canonical_leaf_paths(self):
        """(canonical_path, leaf) per state leaf, in tree_flatten order.

        Block identity in a checkpoint is the TOPOLOGICAL position plus
        the declared rate signature — never the process-global uid baked
        into auto-generated block names — so a checkpoint restores into
        any identically-built flowgraph (fresh process, fresh Graph), not
        just the executor instance that wrote it.  A structurally
        different graph (changed block type, decim/interp/history, or
        wiring) canonicalizes differently and is rejected."""
        uid2tok, name2tok = {}, {}
        for i, b in enumerate(self.order):
            tok = (f"{i}:{type(b).__name__}:"
                   f"d{b.decim}i{b.interp}h{b.history}")
            uid2tok[str(b.uid)] = tok
            name2tok[b.name] = tok

        def canon_edge(k):
            src, dst = k.split("->")
            sn, sp = src.rsplit(".", 1)
            dn, dp = dst.rsplit(".", 1)
            return (f"{name2tok.get(sn, sn)}.{sp}->"
                    f"{name2tok.get(dn, dn)}.{dp}")

        out = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                self.state)[0]:
            parts = []
            for j, k in enumerate(path):
                key = getattr(k, "key", None)
                if key is None:
                    key = getattr(k, "idx", None)
                key = str(key)
                if j == 1 and getattr(path[0], "key", None) == "blocks":
                    key = uid2tok.get(key, key)
                elif j == 1 and getattr(path[0], "key", None) == "tails":
                    key = canon_edge(key)
                elif j == 1 and getattr(path[0], "key", None) == "fifo":
                    key = name2tok.get(key, key)
                parts.append(key)
            out.append(("/".join(parts), leaf))
        return out

    def save_checkpoint(self, path: str):
        """Persist full flowgraph state (all block states + halo tails +
        VR FIFOs) under canonical topology-relative paths."""
        entries = self._canonical_leaf_paths()
        order = sorted(range(len(entries)), key=lambda i: entries[i][0])
        np.savez(
            path,
            *[np.asarray(entries[i][1]) for i in order],
            __paths__=np.array([entries[i][0] for i in order]),
        )

    def load_checkpoint(self, path: str):
        data = np.load(path, allow_pickle=False)
        entries = self._canonical_leaf_paths()
        order = sorted(range(len(entries)), key=lambda i: entries[i][0])
        if "__paths__" not in data:
            raise ValueError(
                "not a grtpu checkpoint (no __paths__ record)")
        saved_paths = [str(s) for s in data["__paths__"]]
        mine = [entries[i][0] for i in order]
        if saved_paths != mine:
            extra = sorted(set(saved_paths) - set(mine))
            missing = sorted(set(mine) - set(saved_paths))
            raise ValueError(
                "checkpoint structure does not match this flowgraph: "
                f"checkpoint-only leaves {extra[:4]}, "
                f"flowgraph-only leaves {missing[:4]}")
        for j, i in enumerate(order):
            saved = data[f"arr_{j}"]
            want = tuple(np.shape(entries[i][1]))
            if tuple(saved.shape) != want:
                raise ValueError(
                    f"checkpoint leaf {mine[j]!r} shape {saved.shape} != "
                    f"flowgraph state shape {want}")
        leaves, treedef = jax.tree_util.tree_flatten(self.state)
        for j, i in enumerate(order):
            leaves[i] = jnp.asarray(data[f"arr_{j}"])
        self.state = jax.tree_util.tree_unflatten(treedef, leaves)
