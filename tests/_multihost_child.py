"""Child process for the two-process multihost CPU test (test_parallel.py).

Each process owns 4 virtual CPU devices (half of a global 8-device 'chan'
mesh), ingests ITS slice of the global stream with feed_from_host (the
multi-host ingest path, SURVEY.md §5.8), and runs one
sharded step whose normalization term forces a cross-process collective.
Local output shards are written for the parent to check against the
single-process reference.
"""

import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
outdir = sys.argv[4]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.distributed.initialize(f"127.0.0.1:{port}", nproc, pid)

import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from grtpu.parallel.multihost import feed_from_host, host_shard_spec  # noqa: E402
from grtpu.ops.fir import fir_filter  # noqa: E402

NCHAN, NSAMP, K = 8, 512, 16
taps = (np.arange(1, K + 1) / (K * K)).astype(np.float32)
full = np.sin(np.arange(NCHAN * (NSAMP + K - 1), dtype=np.float32)
              .reshape(NCHAN, NSAMP + K - 1) * 0.01)

mesh = Mesh(np.array(jax.devices()).reshape(NCHAN), ("chan",))
spec = P("chan")
gshape = full.shape

sl = host_shard_spec(mesh, spec, gshape)
assert sl[0].stop - sl[0].start == NCHAN // nproc, sl
garr = feed_from_host(mesh, spec, full[sl], gshape)

sh = NamedSharding(mesh, spec)


@jax.jit
def step(a):
    # per-channel FIR (halo included in the input), then normalize by the
    # global mean power — the mean reduces ACROSS the chan axis, i.e.
    # across processes: a real DCN/gloo collective.
    y = jax.vmap(lambda r: fir_filter(r, jnp.asarray(taps)))(a)
    p = jnp.mean(y * y)
    return y / jnp.sqrt(p + 1e-9)


y = jax.jit(step, in_shardings=sh, out_shardings=sh)(garr)
local = np.concatenate([np.asarray(s.data) for s in y.addressable_shards])
np.save(os.path.join(outdir, f"mh_{pid}.npy"), local)
print(f"pid{pid} OK", flush=True)
