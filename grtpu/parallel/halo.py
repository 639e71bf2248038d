"""Halo exchange: shard-boundary state transfer over the device mesh.

The replacement for the reference's buffer-reader history preload
(gr_buffer nzero_preload, gr_flat_flowgraph.cc:124-152) when a stream's time
axis is sharded across devices: each shard needs the last ``halo`` samples of
its left neighbor before filtering — the overlap-save boundary of SURVEY.md
§5.7 — delivered by an ICI collective permute instead of a circular buffer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ring_halo_left(x: jnp.ndarray, axis_name: str, halo: int,
                   axis: int = 0, wrap: bool = False) -> jnp.ndarray:
    """Prepend each shard with the trailing ``halo`` samples of its left
    neighbor along mesh axis ``axis_name``.

    The first shard receives zeros unless ``wrap`` (zero preload ==
    the reference's history initialization).  Output grows by ``halo`` on
    ``axis``.  Must be called inside shard_map over the given axis.
    """
    n = jax.lax.axis_size(axis_name)
    if halo == 0:
        return x
    tail = jax.lax.slice_in_dim(x, x.shape[axis] - halo, x.shape[axis], axis=axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    recv = jax.lax.ppermute(tail, axis_name, perm)
    if not wrap:
        idx = jax.lax.axis_index(axis_name)
        recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
    return jnp.concatenate([recv, x], axis=axis)


def shard_fir_filter(x_local: jnp.ndarray, taps: jnp.ndarray,
                     axis_name: str, decim: int = 1,
                     time_axis: int = -1) -> jnp.ndarray:
    """Time-sharded FIR: halo-exchange K-1 samples, then local matmul FIR.

    x_local: this shard's samples, time on ``time_axis``.  Output shard
    length = local_len // decim (local_len must be a multiple of decim;
    shard boundaries must land on decimation boundaries, mirroring the
    executor's chunk-divisibility rule).
    """
    from grtpu.ops.fir import fir_filter, batch_fir_filter

    k = taps.shape[0]
    ta = time_axis % x_local.ndim
    xh = ring_halo_left(x_local, axis_name, k - 1, axis=ta)
    if x_local.ndim == 1:
        return fir_filter(xh, taps, decim)
    if ta != x_local.ndim - 1:
        raise NotImplementedError("time axis must be the last axis")
    lead = xh.shape[:-1]
    flat = xh.reshape(-1, xh.shape[-1])
    y = batch_fir_filter(flat, taps, decim)
    return y.reshape(lead + (y.shape[-1],))
