"""Block protocol: the JAX analog of ``gr_block``.

Reference semantics being re-designed (not ported):
  * gnuradio-core/src/lib/runtime/gr_block.h:58-217 — stream block contract:
    ``general_work`` consumes input items and produces output items, with
    ``history()`` lookback, ``decimation``/``interpolation`` fixed rates and
    ``forecast()`` input/output coupling.
  * gnuradio-core/src/lib/runtime/gr_sync_block.h — 1:1 convenience, plus
    sync_decimator (N:1) and sync_interpolator (1:N).

Re-design: a Block is a *pure function over a time-block*:

    state' , (y0, y1, ...) = block.apply(state, x0, x1, ...)

where each input ``xi`` carries ``n + history - 1`` items — the executor
prepends the last ``history - 1`` items of the previous time-block (the halo),
exactly replacing the reference's circular-buffer reader preload
(gr_flat_flowgraph.cc:124-152, nzero_preload).  Each output must hold exactly
``n // decim * interp`` items.  ``n`` is static under ``jax.jit``: all shapes
are known at trace time, and per-sample feedback loops live inside ``apply``
as ``lax.scan`` recurrences over the time-block.

State is an arbitrary pytree (the analog of a gr_block's member variables:
PLL phase, FIR tail, AGC gain, ...).  Because it is explicit, checkpointing a
whole flowgraph is just saving the executor's state pytree — a capability the
reference lacks (SURVEY.md §5.4).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Port:
    """Typed stream endpoint: dtype + per-item vector length.

    The analog of one entry of a ``gr_io_signature``
    (gnuradio-core/src/lib/runtime/gr_io_signature.h): itemsize becomes
    (dtype, vlen).  A stream with vlen == 1 is a rank-1 array of shape (n,);
    vlen > 1 is rank-2 of shape (n, vlen) (e.g. FFT vectors).
    """

    dtype: Any
    vlen: int = 1

    def __post_init__(self):
        object.__setattr__(self, "dtype", jnp.dtype(self.dtype))
        if self.vlen < 1:
            raise ValueError(f"vlen must be >= 1, got {self.vlen}")

    def item_shape(self) -> Tuple[int, ...]:
        return () if self.vlen == 1 else (self.vlen,)

    def chunk_shape(self, n: int) -> Tuple[int, ...]:
        return (n,) + self.item_shape()

    def compatible(self, other: "Port") -> bool:
        return self.dtype == other.dtype and self.vlen == other.vlen

    def __repr__(self):
        return f"Port({np.dtype(self.dtype).name}, vlen={self.vlen})"


# Common port shorthands (reference: gr item-size suffixes b/s/i/f/c).
def port_b(vlen: int = 1) -> Port:
    return Port(jnp.uint8, vlen)


def port_s(vlen: int = 1) -> Port:
    return Port(jnp.int16, vlen)


def port_i(vlen: int = 1) -> Port:
    return Port(jnp.int32, vlen)


def port_f(vlen: int = 1) -> Port:
    return Port(jnp.float32, vlen)


def port_c(vlen: int = 1) -> Port:
    return Port(jnp.complex64, vlen)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Full signature of a block side: a tuple of Ports.

    Analog of gr_io_signature (min/max stream counts collapse to an exact
    tuple; variable-arity blocks expose factory parameters instead).
    """

    ports: Tuple[Port, ...]

    def __len__(self):
        return len(self.ports)

    def __getitem__(self, i):
        return self.ports[i]


class Block:
    """Base class for stream blocks.

    Subclasses set:
      * ``in_ports`` / ``out_ports``: sequences of :class:`Port`.
      * ``history``: input lookback in items (>= 1; 1 means none), the analog
        of gr_block::history() (gr_block.h:76-84).  The executor delivers each
        input with ``history - 1`` leading context items.
      * ``decim`` / ``interp``: fixed rate change — consume ``n`` (a multiple
        of ``decim``), produce ``n // decim * interp``.  Analogs of
        gr_sync_decimator / gr_sync_interpolator.
      * ``variable_rate``: True for data-dependent production (clock recovery,
        arbitrary resampler).  Such blocks return ``(y_padded, n_valid)``
        where the valid items are a contiguous prefix of ``y_padded`` (length
        ``max_out_for(n_delivered)``) and ``n_valid`` is a traced int32 count.
        The executor makes these first-class graph citizens: the padded
        output is compacted into a carried device FIFO and downstream blocks
        run on fixed-size emissions drained from it inside the jitted step
        (see StreamExecutor docs) — the replacement for the
        reference scheduler's variable ``consume()`` demand negotiation
        (gr_block_executor.cc:302-350).  They may also still be composed
        by hand with the mask-and-compact idiom in ``grtpu.models``
        (SURVEY.md §7 "hard parts" #2).

    and implement ``init_state()`` and ``apply(state, *inputs)``.
    ``apply`` must be traceable by ``jax.jit`` (no data-dependent Python
    control flow).
    """

    in_ports: Sequence[Port] = ()
    out_ports: Sequence[Port] = ()
    history: int = 1
    decim: int = 1
    interp: int = 1
    variable_rate: bool = False
    # Tag propagation policy, analog of gr_block.h:68-72 TPP_*.
    tag_propagation: str = "all_to_all"  # "dont" | "all_to_all" | "one_to_one"
    # True for blocks that *emit* tags during work (gr_burst_tagger,
    # correlate_access_code_tag).  Two mechanisms, in preference order:
    #   1. device_tags = True: the block implements apply_tagged(); tag
    #      DETECTION runs in-jit and only a small fixed-size record (chunk-
    #      relative offsets + aux values) crosses to the host, where
    #      tags_from_device() turns it into Tag objects.  Works under
    #      step(), device_loop=True, and MeshExecutor (the record just
    #      gains leading chunk/channel axes).
    #   2. legacy make_tags(): the executor captures the block's full
    #      in/out chunks each step and synthesizes tags on the host.
    # Propagation is host-plane either way (grtpu.runtime.tags); offsets
    # stay exact because chunk sizes are static.
    emits_tags: bool = False
    device_tags: bool = False
    # Fixed per-chunk tag-record capacity for device_tags blocks (tags
    # beyond this in ONE chunk are dropped; the in-jit record must be
    # statically shaped).  The reference has no such cap, but a chunk with
    # hundreds of burst edges is pathological; raise per-block if needed.
    max_tags_per_chunk: int = 128

    _instance_counter = [0]
    # Bumped whenever ANY block's compile-relevant parameters change
    # (see touch()); executors snapshot it to detect stale-parameter use.
    _global_version = [0]

    def __init__(self, name: str | None = None):
        Block._instance_counter[0] += 1
        self.uid = Block._instance_counter[0]
        self.name = name or f"{type(self).__name__}_{self.uid}"
        self.in_ports = tuple(self.in_ports)
        self.out_ports = tuple(self.out_ports)
        self._version = 0

    def touch(self):
        """Mark this block's compile-relevant parameters as changed.

        Parameter setters (set_taps, ...) call this.  A built
        StreamExecutor bakes such parameters into the traced program as
        constants; its ``step()`` raises if any block was touched after the
        build, replacing the reference's implicit rebuild-on-set_taps
        (gr_top_block lock/unlock) with an explicit error instead of
        silently stale output."""
        self._version += 1
        Block._global_version[0] += 1

    # -- contract -----------------------------------------------------------
    def init_state(self) -> Any:
        """Initial carried state pytree (default: stateless)."""
        return ()

    def apply(self, state, *inputs):
        """Process one time-block.

        Args:
          state: carried pytree from the previous call.
          *inputs: one array per input port, shaped ``(n + history - 1, [vlen])``.

        Returns:
          ``(new_state, outputs)`` with ``outputs`` a tuple of arrays, one per
          output port, each shaped ``(n // decim * interp, [vlen])``.  Blocks
          with a single output may return the bare array.
        """
        raise NotImplementedError

    # -- introspection ------------------------------------------------------
    @property
    def relative_rate(self):
        """Output items per input item (gr_block.h:182-187).  For
        variable-rate blocks this is the *nominal* estimate, the analog of
        the reference's set_relative_rate hint."""
        if self.variable_rate:
            return self.nominal_rate
        return self.interp / self.decim

    @property
    def nominal_rate(self) -> float:
        """Expected output items per fresh input item.  Variable-rate blocks
        override (e.g. 1/sps for clock recovery); used by the executor to
        size FIFO emissions and by host-side tag scaling."""
        return self.interp / self.decim

    def max_out_for(self, n_delivered: int) -> int:
        """Static bound on items produced from one delivered chunk of
        ``n_delivered`` items (including the ``history - 1`` halo).
        Variable-rate blocks MUST override this with the exact padded length
        their ``apply`` returns; it is a throughput bound, not a correctness
        bound — production beyond it is deferred to the next chunk via the
        carried sample pointer."""
        return (n_delivered - (self.history - 1)) // self.decim * self.interp

    def make_tags(self, ins, outs, start_in: int, start_out: int):
        """Host-side tag synthesis for ``emits_tags`` blocks: called once
        per time-block with this block's input chunks (including the
        history halo) and output chunks as host arrays, plus the absolute
        stream offsets of the first fresh input/output item.  Returns a
        list of :class:`grtpu.runtime.tags.Tag` with *output-stream*
        absolute offsets; the executor injects them onto the downstream
        edges.  The analog of calling add_item_tag inside general_work
        (gr_burst_tagger.cc work)."""
        return []

    def apply_tagged(self, state, *inputs):
        """In-jit work + tag detection for ``device_tags`` blocks.

        Returns ``(new_state, outputs, tagrec)`` where ``tagrec`` is a dict
        of statically-shaped arrays — by convention ``{"offset": int32
        (max_tags_per_chunk,), chunk-relative OUTPUT-stream offsets with -1
        marking unused rows, ...aux value arrays aligned with offset...}``.
        The executor ships the record to the host (leading chunk/channel
        axes under device_loop / MeshExecutor) and calls
        :meth:`tags_from_device` to materialize Tag objects."""
        raise NotImplementedError

    def tags_from_device(self, rec, start_in: int, start_out: int):
        """Turn one chunk's host-side tag record (numpy arrays, as returned
        by apply_tagged) into a list of Tags with absolute offsets."""
        raise NotImplementedError

    def _tag_topk(self, hits, n):
        """In-jit helper: chunk-relative indices of up to
        ``max_tags_per_chunk`` True values of ``hits`` (length-n bool),
        ascending, padded with -1.  top_k on a recency score — never a
        dynamic-shape nonzero, never a big gather (CLAUDE.md)."""
        import jax

        k = min(self.max_tags_per_chunk, n)
        score = jnp.where(hits, n - jnp.arange(n), 0)
        vals, idx = jax.lax.top_k(score, k)
        offs = jnp.where(vals > 0, n - vals, -1).astype(jnp.int32)
        return offs, jnp.where(vals > 0, idx, 0)

    def noutput_for(self, n_in: int) -> int:
        if n_in % self.decim:
            raise ValueError(
                f"{self.name}: input chunk {n_in} not a multiple of decim={self.decim}"
            )
        return n_in // self.decim * self.interp

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"
