"""Streaming-service benchmark: UDP IQ in -> jitted WBFM on the GPU -> UDP out.

The host-ingest <-> device data plane (examples/stream_server.py's shape —
native C++ UDP pump -> double-mapped ring -> StreamExecutor chunks -> UDP
audio out), measured end to end.  This bench runs the full service seam for >= 60 s against a
paced loopback feeder and records the SUSTAINED input rate plus the
dropped-datagram count (kernel SO_RXQ_OVFL counter via the native pump —
drops mean the service failed to drain the socket in time).

The executor compiles BEFORE the feeder starts (a compile mid-stream
would eat the socket buffer and charge warmup to the service).  The feeder
is a separate process that imports no JAX.

Run from the repo root on the GPU:  python benchmarks/stream_service_bench.py
"""

import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks.common import emit, setup  # noqa: E402

IN_PORT = 19867
OUT_PORT = 19868
DURATION = float(os.environ.get("STREAM_BENCH_DURATION", 60.0))
# offered rate of the sustained phase (the capacity phase offers 4x)
OFFERED_MSPS = float(os.environ.get("STREAM_BENCH_MSPS", 2.0))
CHUNK = 1 << 18           # 256k complex samples = 2 MiB per step

_FEEDER = r"""
import socket, sys, time
import numpy as np
port, rate, duration = int(sys.argv[1]), float(sys.argv[2]), float(sys.argv[3])
payload_items = 184                      # 1472 B of complex64
rng = np.random.RandomState(0)
buf = (rng.randn(payload_items) + 1j * rng.randn(payload_items)) \
    .astype(np.complex64).tobytes()
sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
addr = ("127.0.0.1", port)
sent = 0
t0 = time.perf_counter()
slice_s = 0.005
per_slice = max(1, int(rate * slice_s / payload_items))
while True:
    now = time.perf_counter()
    if now - t0 >= duration:
        break
    # catch-up pacing: send what the clock says we owe
    owed = int((now - t0) * rate / payload_items) - sent
    for _ in range(min(max(owed, 0), 4 * per_slice)):
        sock.sendto(buf, addr)
        sent += 1
    time.sleep(slice_s)
sock.sendto(b"", addr)                  # EOF
print(sent, flush=True)
"""


def main():
    setup()
    import jax
    import jax.numpy as jnp

    from grtpu import Graph, StreamExecutor
    from grtpu.io import udp
    from grtpu.models.fm import WfmRcv
    from grtpu.runtime.block import Port

    g = Graph("wfm_service")
    pin = g.add_input(Port(jnp.complex64))
    pout = g.add_output(Port(jnp.float32))
    g.connect(pin, WfmRcv(256e3, 8), pout)
    ex = StreamExecutor(g, chunk_size=CHUNK)

    print("# compiling/warming", file=sys.stderr, flush=True)
    z = np.zeros(CHUNK, np.complex64)
    for _ in range(3):
        pads, _ = ex.step(z)
        jax.block_until_ready(pads[0])

    def run_phase(metric, offered_msps, duration, in_port, out_port):
        src = udp.native_udp_source("127.0.0.1", in_port, np.complex64,
                                    ring_bytes=1 << 26)
        # audio drain: count bytes received out the back of the service
        drained = [0]
        drain_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        drain_sock.bind(("127.0.0.1", out_port))
        drain_sock.settimeout(0.5)
        stop = threading.Event()

        def drain():
            while not stop.is_set():
                try:
                    d = drain_sock.recv(4096)
                    drained[0] += len(d)
                except socket.timeout:
                    pass

        th = threading.Thread(target=drain, daemon=True)
        th.start()
        snk = udp.UdpSink("127.0.0.1", out_port, np.float32)

        feeder = subprocess.Popen(
            [sys.executable, "-c", _FEEDER, str(in_port),
             str(offered_msps * 1e6), str(duration)],
            stdout=subprocess.PIPE, text=True,
            env={k: v for k, v in os.environ.items()
                 if not k.startswith(("JAX", "PYTHONPATH"))})

        n_in = 0
        t0 = time.perf_counter()
        for audio in ex.stream(src.chunks(CHUNK)):
            snk.write_items(np.asarray(audio))
            n_in += CHUNK
        elapsed = time.perf_counter() - t0
        sent = int(feeder.communicate(timeout=30)[0].strip())
        dg, _nbytes, drops = src.stats()
        stop.set()
        th.join()
        drain_sock.close()
        snk.close()
        src.close()

        emit({
            "metric": metric,
            "value": round(n_in / elapsed / 1e6, 2),
            "unit": "Msamples/s",
            "offered_msps": offered_msps,
            "duration_s": round(elapsed, 1),
            "datagrams_sent": sent,
            "datagrams_landed": dg,
            "datagrams_dropped": drops,
            "audio_bytes_out": drained[0],
            "chunk": CHUNK,
        })

    # phase 1: sustained service at the offered rate for >= 60 s (the
    # deployment-shape record; drops are counted)
    run_phase("udp_stream_service", OFFERED_MSPS, DURATION,
              IN_PORT, OUT_PORT)
    # phase 2: capacity probe — overdrive the feeder and record the
    # achieved ceiling plus the (expected, counted) drops
    run_phase("udp_stream_service_capacity", 4 * OFFERED_MSPS,
              min(DURATION, 15.0), IN_PORT + 2, OUT_PORT + 2)


if __name__ == "__main__":
    main()
