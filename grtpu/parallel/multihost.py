"""Multi-host deployment: distributed init + per-host stream ingest.

The reference's only inter-host transport is raw UDP datagrams carrying
samples (gr_udp_source/sink, SURVEY.md §5.8) — no flow control, no clock
sync, silent loss.  The replacement here (SURVEY.md §5.8): every host ingests ITS OWN slice of the stream (its antenna
feed, its capture file, its UDP socket) into host RAM, assembles a global
sharded array with ``jax.make_array_from_process_local_data``, and one
pjit-ed program spanning the hosts processes it — cross-host traffic rides
XLA's collectives instead of hand-rolled sockets.

Pieces:
  * :func:`init_distributed` — `jax.distributed.initialize` with env-var
    defaults (one call per host before any jax use);
  * :func:`host_shard_spec` — which slice of the global (chan, time)
    stream this host must ingest;
  * :func:`feed_from_host` — per-host numpy chunk -> global sharded array;
  * :func:`udp_ingest_step` — the drop-in gr_udp_source replacement: each
    host's native UDP pump fills its local shard between steps.

Single-host (tests, 1 process with N devices) everything degenerates to
`jax.device_put` with the same sharding, so CI exercises the identical
code path the pod runs.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize multi-process JAX (no-op when single-process).

    Defaults come from the standard env vars (JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); without them it is a no-op.
    Where no cluster environment tells JAX of its peers, pass all three.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=(process_id if process_id is not None
                    else int(os.environ.get("JAX_PROCESS_ID", "0"))),
    )


@functools.lru_cache(maxsize=64)
def host_shard_spec(mesh: Mesh, spec: P,
                    global_shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    """The slice of the global array this host's local devices own.

    Use it to know which channels / which time segment to ingest locally
    (each host reads only its own antenna feed / capture slice).
    Cached per (mesh, spec, shape) — it sits in the per-chunk ingest loop."""
    sharding = NamedSharding(mesh, spec)
    imap = sharding.addressable_devices_indices_map(global_shape)
    local_devs = [d for d in mesh.devices.flat
                  if d.process_index == jax.process_index()]
    lo = [g for g in global_shape]
    hi = [0 for _ in global_shape]
    for d in local_devs:
        for a, s in enumerate(imap[d]):
            start = 0 if s.start is None else s.start
            stop = global_shape[a] if s.stop is None else s.stop
            lo[a] = min(lo[a], start)
            hi[a] = max(hi[a], stop)
    return tuple(slice(l, h) for l, h in zip(lo, hi))


def feed_from_host(mesh: Mesh, spec: P, local_np: np.ndarray,
                   global_shape: Tuple[int, ...]) -> jax.Array:
    """Assemble the global sharded stream array from this host's slice.

    ``local_np`` must be exactly the :func:`host_shard_spec` slice of the
    global array.  Cross-host layout is handled by
    ``jax.make_array_from_process_local_data``; no samples ever traverse
    the hosts — each shard goes straight to its local devices."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_np), global_shape)


def udp_ingest_step(mesh: Mesh, spec: P, source, n_items: int,
                    global_shape: Tuple[int, ...]) -> Optional[jax.Array]:
    """One gr_udp_source-replacement ingest step: pull this host's chunk
    from ``source`` (any object with ``read_items(n)`` returning a flat
    array — grtpu.io.udp.UdpSource or native_udp_source; for file replay
    wrap NativeFileSource: ``lambda n: src.read_chunk(n)`` with a raw/
    single-plane wire format) and return the global sharded array (None
    at EOF)."""
    local = source.read_items(n_items)
    if local is None:
        return None
    if isinstance(local, tuple):
        raise TypeError(
            "udp_ingest_step needs a single-plane source; sc16 planar "
            "sources return (re, im) — feed the planes separately")
    local = np.asarray(local).reshape(
        [s.stop - s.start for s in host_shard_spec(mesh, spec, global_shape)])
    return feed_from_host(mesh, spec, local, global_shape)
