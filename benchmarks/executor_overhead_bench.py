"""StreamExecutor host control-plane overhead per step.

The python dispatch around the jitted step (tag advance, bookkeeping) is
the host-side control plane for a >1 Gsps data plane.  This times the HOST work alone by
calling the executor's dispatch machinery with the jitted step replaced by
an identity (so device time and transfer time are excluded), for a
20-block chain at chunk 4096, with and without tags in flight.

Prints JSON lines: host overhead per step, and the implied ceiling in
Msamples/s at chunk 4096 (ceiling = chunk / overhead).

Run from the repo root on the GPU: python benchmarks/executor_overhead_bench.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup  # noqa: E402


def main():
    setup()
    import jax.numpy as jnp

    from grtpu.runtime.block import Port
    from grtpu.runtime.executor import StreamExecutor
    from grtpu.runtime.graph import Graph
    from grtpu.runtime.tags import Tag
    from grtpu.blocks.stream import Copy

    nblocks, chunk = 20, 4096
    g = Graph()
    pin = g.add_input(Port(jnp.float32))
    pout = g.add_output(Port(jnp.float32))
    chain = [Copy(dtype=jnp.float32) for _ in range(nblocks)]
    g.connect(pin, *chain, pout)
    ex = StreamExecutor(g, chunk_size=chunk)
    x = jnp.zeros(chunk, jnp.float32)
    ex.step(x)  # compile

    # measure the host dispatch alone: identity in place of the jitted step
    real = ex._jit_step
    ex._jit_step = lambda state, inputs: (state, ((inputs[0],), {}))
    for label, with_tags in (("no_tags", False), ("tags_in_flight", True)):
        if with_tags:
            ex.add_tags(0, [Tag(10 ** 9, "far", i) for i in range(64)])
        n = 2000
        t0 = time.perf_counter()
        for _ in range(n):
            ex.step(x)
        dt = (time.perf_counter() - t0) / n
        emit({
            "metric": f"executor_host_overhead_{label}",
            "value": round(dt * 1e6, 1),
            "unit": "us/step",
            "ceiling_msps_at_4096": round(chunk / dt / 1e6, 1),
            "nblocks": nblocks,
        })
    ex._jit_step = real

    # device-side multi-step loop: ALL chunks in one lax.scan dispatch —
    # host overhead per chunk is the single python dispatch amortized over
    # nchunks (run(device_loop=True)); measured end-to-end on the Copy
    # chain whose device work is ~free, so per-chunk time ~= host share.
    ex2 = StreamExecutor(g, chunk_size=chunk)
    nchunks = 256
    big = jnp.zeros(nchunks * chunk, jnp.float32)
    ex2.run(big, device_loop=True)  # build + compile the real scan
    # host share only (same methodology as the per-step numbers): swap the
    # cached scan for an identity, so the measured time is the python
    # dispatch + reshape/finalize work amortized over nchunks
    ex2._scan_cache[nchunks] = lambda state, stk: (state, ((stk[0],), {}))
    ex2.run(big, device_loop=True)  # warm
    n = 50
    t0 = time.perf_counter()
    for _ in range(n):
        ex2.run(big, device_loop=True)
    dt = (time.perf_counter() - t0) / n / nchunks
    emit({
        "metric": "executor_host_overhead_device_loop",
        "value": round(dt * 1e6, 2),
        "unit": "us/chunk",
        "ceiling_msps_at_4096": round(chunk / dt / 1e6, 1),
        "nblocks": nblocks,
        "nchunks": nchunks,
    })


if __name__ == "__main__":
    main()
