"""Smoke run of grtpu's main paths on one GPU, at deployment size.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # four cards: the mesh path only

Phases, in order, in this one process (a JAX process reserves most of the
card's memory, so nothing here starts a second one):

1. device   — refuse to run unless jax's first device is a GPU.
2. wbfm     — north-star config #1: WfmRcv(256e3, 8) as a Graph through
              MeshExecutor(make_mesh(1), 64 channels, chunk 65536), state
              donated; 64 x 2^20 complex samples (4 s at 256 kS/s each).
              Two channels recomputed in float64 must agree to >= 50 dB
              audio SNR; a checkpoint saved after the run and restored into
              a fresh executor must continue bit-identically.
3. dmr      — config #4: 128 channels x 4 DMR bursts from DmrTransmitter,
              AWGN at 20 dB, Fsk4Modem.demodulate_burst_bank, then
              find_bursts/extract_payload: every payload bit-exact.
4. fir      — the synthetic 16 x 16 x 256-tap FIR pipeline at bench width
              (16 pipes x 2^20) in every bench.py form: >= 50 dB SNR against
              a float64 chain on two rows at full length.
5. ingest   — live WBFM over UDP at an offered 1 MS/s through the native
              UDP source (compiled on this machine) into a StreamExecutor:
              every item sent is received, none dropped, and audio items
              == ceil(IQ items received / decimation), the tail at EOF
              flushed as one zero-padded chunk.
6. tests    — the GPU-marked tests (pytest -m gpu), in this process.

Each phase prints one line with its size, compile and run seconds and its
check, beside the card's name and power limit; any failure exits nonzero.
The last line of stdout is the JSON record
{"ok": true, "device": {"platform", "kind", "count"}}.

``--four-gpus`` runs only the multi-device path and what it is compared
with: __graft_entry__.dryrun_multichip(4) and the wbfm phase on
make_mesh(4) (time 2 x chan 2, halo exchange between cards) checked against
the same input on one card.
"""

import argparse
import json
import math
import os
import socket
import tempfile
import threading
import time

import numpy as np

import bench

HERE = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(AssertionError):
    pass


def report(res, card):
    print(f"phase={res['phase']} size={res['size']} "
          f"compile_s={res['compile_s']:.2f} run_s={res['run_s']:.3f} "
          f"check={'PASS' if res['ok'] else 'FAIL'} ({res['check']}) "
          f"card=[{card}]", flush=True)
    if not res["ok"]:
        raise SmokeFailure(f"phase {res['phase']} failed: {res['check']}")


# ----------------------------------------------------------------- signals
def fm_iq(nchan, nsamp, seed, quad_rate=256e3, max_dev=75e3, snr_db=30.0):
    """(nchan, nsamp) complex64 broadcast-FM test signal: three audio tones
    per channel at full deviation plus AWGN."""
    rng = np.random.default_rng(seed)
    out = np.empty((nchan, nsamp), np.complex64)
    t = np.arange(nsamp) / quad_rate
    for c in range(nchan):
        f = rng.uniform(100.0, 15e3, 3)
        a = rng.uniform(0.2, 1.0, 3)
        ph = rng.uniform(0, 2 * np.pi, 3)
        msg = (a[:, None] * np.sin(2 * np.pi * f[:, None] * t
                                   + ph[:, None])).sum(0) / a.sum()
        phase = 2 * np.pi * max_dev / quad_rate * np.cumsum(msg)
        noise = (rng.standard_normal(nsamp)
                 + 1j * rng.standard_normal(nsamp))
        out[c] = np.exp(1j * phase) + noise * math.sqrt(
            0.5 * 10 ** (-snr_db / 10))
    return out


def wfm_graph(quad_rate=256e3, decim=8):
    import jax.numpy as jnp
    from grtpu import Graph
    from grtpu.models.fm import WfmRcv
    from grtpu.runtime.block import Port

    g = Graph("wbfm")
    pin = g.add_input(Port(jnp.complex64))
    pout = g.add_output(Port(jnp.float32))
    rcv = WfmRcv(quad_rate, decim)
    g.connect(pin, rcv, pout)
    return g, rcv


def wbfm_reference(iq_row, rcv, quad_rate=256e3, decim=8):
    """float64 WfmRcv: quadrature demod, the block's own decimating taps
    (zero history), then the bilinear de-emphasis of FmDeemph."""
    from scipy.signal import lfilter

    x = np.concatenate([[0], iq_row.astype(np.complex128)])
    prod = x[1:] * np.conj(x[:-1])
    gain = quad_rate / (2 * np.pi * 75e3)
    fm = gain * np.arctan2(prod.imag, prod.real)
    taps = np.asarray(rcv.audio_filter.taps, np.float64)
    audio = np.convolve(fm, taps)[: len(fm)][::decim]
    fs = quad_rate / decim
    k = math.tan(1.0 / (75e-6 * 2.0 * fs))
    p1, b0 = (1 - k) / (1 + k), k / (1 + k)
    return lfilter([b0, b0], [1.0, -p1], audio)


# ------------------------------------------------------------------ phases
def phase_wbfm(nchan=64, nsamp=1 << 20, chunk=65536, mesh=None, seed=0,
               check_rows=(0, -1), iq=None):
    """WBFM bank through MeshExecutor with donated state.  Returns the
    phase result; result['audio'] holds the (nchan, nsamp/8) output."""
    import jax
    from grtpu.runtime.mesh_executor import MeshExecutor, make_mesh

    mesh = make_mesh(1) if mesh is None else mesh
    if iq is None:
        iq = fm_iq(nchan, nsamp, seed)
    g, rcv = wfm_graph()
    mex = MeshExecutor(g, mesh, nchan, chunk_size=chunk, donate=True)
    t0 = time.perf_counter()
    first = jax.block_until_ready(mex.run(iq[:, :chunk]))
    t1 = time.perf_counter()
    rest = jax.block_until_ready(mex.run(iq[:, chunk:]))
    t2 = time.perf_counter()
    audio = np.concatenate([np.asarray(first), np.asarray(rest)], axis=1)
    snrs = [bench.snr_db(audio[r], wbfm_reference(iq[r], rcv))
            for r in check_rows]
    ok = bool(np.isfinite(audio).all()) and audio.shape == (
        nchan, nsamp // 8) and min(snrs) >= 50.0

    # donation check: the state after donated steps checkpoints, restores
    # into a fresh executor, and both continue identically
    extra = fm_iq(nchan, chunk, seed + 1)
    g2, _ = wfm_graph()
    fresh = MeshExecutor(g2, mesh, nchan, chunk_size=chunk, donate=True)
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "wbfm.npz")
        mex.save_checkpoint(ck)
        fresh.load_checkpoint(ck)
    same = np.array_equal(np.asarray(mex.run(extra)),
                          np.asarray(fresh.run(extra)))
    ok = ok and same
    return {"phase": "wbfm", "size": f"{nchan}x{nsamp}",
            "compile_s": t1 - t0, "run_s": t2 - t1,
            "check": (f"audio SNR vs float64 {min(snrs):.1f} dB >= 50 on "
                      f"rows {list(check_rows)}; checkpoint after donated "
                      f"steps restores identically: {same}; "
                      f"{nchan * (nsamp - chunk) / (t2 - t1) / 1e6:.1f} "
                      f"MS/s after the first chunk"),
            "ok": ok, "audio": audio, "iq": iq}


def phase_dmr(nchan=128, nbursts=4, snr_db_=20.0, seed=1):
    """DMR burst bank: every payload must come back bit-exact."""
    from grtpu.digital.modems import awgn
    from grtpu.models.dmr import DmrTransmitter, extract_payload, find_bursts

    tx = DmrTransmitter(samples_per_symbol=10)
    rng = np.random.RandomState(seed)
    sent = rng.randint(0, 2, (nchan, nbursts, 216)).astype(np.uint8)
    rows = []
    for c in range(nchan):
        sig = np.concatenate([np.asarray(tx.transmit(sent[c, b], "bs_data"))
                              for b in range(nbursts)])
        rows.append(awgn(sig, snr_db_, seed=seed * 100003 + c))
    x = np.stack(rows)
    modem = tx.modem
    t0 = time.perf_counter()
    modem.demodulate_burst_bank(x)
    t1 = time.perf_counter()
    dibits = modem.demodulate_burst_bank(x)
    t2 = time.perf_counter()
    bad = 0
    for c in range(nchan):
        got = [extract_payload(dibits[c], s)
               for s in find_bursts(dibits[c], "bs_data")]
        got = [p for p in got if p is not None]
        if len(got) != nbursts or any(
                not np.array_equal(p, sent[c, b]) for b, p in enumerate(got)):
            bad += 1
    return {"phase": "dmr", "size": f"{nchan}x{nbursts}bursts "
                                    f"({x.shape[1]} samples/ch)",
            "compile_s": t1 - t0, "run_s": t2 - t1,
            "check": f"{nchan * nbursts} payloads, channels with any "
                     f"missing or wrong payload: {bad}",
            "ok": bad == 0}


def phase_fir(npipes=16, nsamples=1 << 20, nstages=16, rows=2):
    """The synthetic FIR pipeline in every bench.py form."""
    import jax
    import jax.numpy as jnp

    taps, x_host = bench.taps_and_input(npipes, nsamples)
    ref = bench.reference_chain(x_host[:rows], taps, nstages)
    x = jnp.asarray(x_host)
    parts, ok, compile_s, run_s = [], True, 0.0, 0.0
    for config in bench.CONFIGS:
        t0 = time.perf_counter()
        fn = bench.compile_config(config, taps, nstages, x.shape)
        t1 = time.perf_counter()
        y = jax.block_until_ready(fn(x))
        t2 = time.perf_counter()
        s = bench.snr_db(np.asarray(y[:rows]), ref)
        ok = ok and s >= bench.SNR_GATE_DB and bool(
            jnp.isfinite(y).all())
        compile_s += t1 - t0
        run_s += t2 - t1
        parts.append(f"{config} {s:.1f} dB in {(t2 - t1) * 1e3:.2f} ms")
    return {"phase": "fir", "size": f"{npipes}x{nsamples}, {nstages} "
                                    f"stages x {bench.NTAPS} taps",
            "compile_s": compile_s, "run_s": run_s,
            "check": "; ".join(parts) + f" (gate {bench.SNR_GATE_DB} dB)",
            "ok": ok}


def _free_udp_port():
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _feed(iq, port, rate, sent):
    """Send ``iq`` as 1472-byte datagrams paced at ``rate`` items/s, then
    the zero-length EOF datagram."""
    per = 184                                    # complex64 items / datagram
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        t0 = time.perf_counter()
        n = 0
        while n < len(iq):
            owed = int((time.perf_counter() - t0) * rate)
            while n < min(owed, len(iq)):
                piece = iq[n: n + per]
                sock.sendto(piece.tobytes(), ("127.0.0.1", port))
                n += len(piece)
            time.sleep(0.002)
        sock.sendto(b"", ("127.0.0.1", port))
        sent.append(n)
    finally:
        sock.close()


def phase_ingest(seconds=3.0, rate=1e6, chunk=65536, decim=8, seed=2):
    """Live WBFM: UDP -> native ring -> StreamExecutor.stream -> audio.

    The native source yields whole chunks only, so the items left in the
    ring at EOF (fewer than a chunk) are flushed here as one zero-padded
    step, keeping the audio of the real items.  Every item sent must be
    received, none dropped, and the audio must hold ceil(received / decim)
    items."""
    import jax
    from grtpu import StreamExecutor
    from grtpu.io import native, udp

    if not native.available():
        return {"phase": "ingest", "size": "-", "compile_s": 0.0,
                "run_s": 0.0, "ok": False,
                "check": "native I/O library did not compile"}
    g, _ = wfm_graph(decim=decim)
    ex = StreamExecutor(g, chunk_size=chunk)
    t0 = time.perf_counter()
    pads, _ = ex.step(np.zeros(chunk, np.complex64))
    jax.block_until_ready(pads)
    compile_s = time.perf_counter() - t0

    port = _free_udp_port()
    src = udp.native_udp_source("127.0.0.1", port, np.complex64,
                                ring_bytes=1 << 24)
    iq = fm_iq(1, int(seconds * rate), seed)[0]
    sent = []
    feeder = threading.Thread(target=_feed, args=(iq, port, rate, sent),
                              daemon=True)
    n_in = n_out = 0
    finite = True
    try:
        feeder.start()
        t1 = time.perf_counter()
        for audio in ex.stream(src.chunks(chunk)):
            a = np.asarray(audio)
            finite = finite and bool(np.isfinite(a).all())
            n_in += chunk
            n_out += len(a)
        tail = src.ring.readable // 8
        if tail:
            last = np.zeros(chunk, np.complex64)
            last[:tail] = src.ring.read_items(tail, np.complex64)
            pads, _ = ex.step(last)
            a = np.asarray(pads[0])[: -(-tail // decim)]
            finite = finite and bool(np.isfinite(a).all())
            n_in += tail
            n_out += len(a)
        run_s = time.perf_counter() - t1
        feeder.join(timeout=60)
        dgrams, nbytes, drops = src.stats()
    finally:
        src.close()
    received = nbytes // 8
    ok = (finite and n_in >= chunk and not feeder.is_alive()
          and drops == 0 and received == sent[0] == len(iq)
          and n_in == received and n_out == -(-received // decim))
    return {"phase": "ingest",
            "size": f"{len(iq)} IQ items offered at {rate / 1e6:g} MS/s",
            "compile_s": compile_s, "run_s": run_s,
            "check": (f"sent {sent[0] if sent else 0}, received {received} "
                      f"items in {dgrams} datagrams ({drops} dropped by the "
                      f"kernel), consumed {n_in} ({n_in - tail} in chunks of "
                      f"{chunk}, tail {tail} flushed at EOF), audio {n_out} "
                      f"== ceil({received} / {decim}); native lib "
                      f"{os.path.basename(native.library_path())}"),
            "ok": ok}


class _Outcomes:
    """pytest plugin that counts test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] += 1


def phase_tests():
    import pytest

    outcomes = _Outcomes()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")], plugins=[outcomes])
    c = outcomes.counts
    return {"phase": "tests", "size": "pytest -m gpu", "compile_s": 0.0,
            "run_s": time.perf_counter() - t0,
            "check": f"rc {int(rc)}, {c['passed']} passed, {c['failed']} "
                     f"failed, {c['skipped']} skipped",
            "ok": int(rc) == 0 and c["passed"] > 0 and c["skipped"] == 0
            and c["failed"] == 0}


def four_gpus(devs, card, **wbfm_size):
    """Multi-device path on four cards vs one card."""
    import __graft_entry__ as ge
    from grtpu.runtime.mesh_executor import make_mesh

    t0 = time.perf_counter()
    ge.dryrun_multichip(4)
    report({"phase": "dryrun_multichip", "size": "4 devices",
            "compile_s": 0.0, "run_s": time.perf_counter() - t0,
            "check": "every sharded flowgraph matches its single-device run",
            "ok": True}, card)
    mesh4 = make_mesh(4, devs[:4])
    four = phase_wbfm(mesh=mesh4, **wbfm_size)
    four["phase"] = f"wbfm mesh {dict(mesh4.shape)}"
    report(four, card)
    one = phase_wbfm(mesh=make_mesh(1, devs[:1]), iq=four["iq"],
                     **wbfm_size)
    one["phase"] = "wbfm one card, same input"
    report(one, card)
    diff = float(np.max(np.abs(four["audio"] - one["audio"])))
    report({"phase": "wbfm 4 cards vs 1", "size": str(four["audio"].shape),
            "compile_s": 0.0, "run_s": 0.0,
            "check": f"max|diff| {diff:.3e} <= 1e-4",
            "ok": diff <= 1e-4}, card)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the multi-device path on four cards")
    args = ap.parse_args(argv)
    devs = bench.require_gpu(4 if args.four_gpus else 1)
    card = bench.card_info().replace("\n", " | ")
    print(f"card: {card}", flush=True)
    print(f"jax.devices(): {devs}", flush=True)
    from grtpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    report({"phase": "device", "size": f"{len(devs)} x {devs[0].device_kind}",
            "compile_s": 0.0, "run_s": 0.0,
            "check": f"platform {devs[0].platform}", "ok": True}, card)
    if args.four_gpus:
        four_gpus(devs, card)
    else:
        for fn in (phase_wbfm, phase_dmr, phase_fir, phase_ingest,
                   phase_tests):
            res = fn()
            res.pop("audio", None)
            res.pop("iq", None)
            report(res, card)
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
