"""Trellis-coding BER simulations (gr-trellis examples analog).

Covers the reference's gr-trellis/src/examples suite:
  * tcm    — trellis-coded modulation + Viterbi (test_tcm.py)
  * eq     — Viterbi equalization of an ISI channel
             (test_viterbi_equalization.py)
  * sccc     — serial turbo over 8PSK (test_sccc_turbo.py)
  * pccc     — parallel turbo (test_pccc_turbo1.py)
  * turbo-eq — turbo equalization of Proakis channel C
               (test_turbo_equalization.py: the ISI trellis is the SCCC
               inner code)

One jitted simulate() runs `rep` packets as a vmapped batch —
the whole Monte-Carlo sweep is a single device program instead of the
reference's one-packet-per-top_block loop.

Run: python examples/trellis_ber.py tcm -e 8.0 -r 64
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from grtpu.trellis import (  # noqa: E402
    FSM, Interleaver, calc_metric_cost, fsm_encode, fsm_utils,
    pccc_decoder, sccc_decoder, viterbi,
)

# awgn1o2_4.fsm analog: rate-1/2 (5,7) code
FSM4 = FSM.from_convolutional(1, 2, [[0b101, 0b111]])
# awgn2o3_4_msb.fsm analog (see tests/test_trellis_turbo.py)
FSM_MSB = FSM(4, 4, 8,
              NS=[0, 1, 2, 3] * 4,
              OS=[0, 5, 3, 6, 4, 1, 7, 2, 7, 2, 4, 1, 3, 6, 0, 5])
PSK8 = np.exp(2j * np.pi * np.arange(8) / 8).astype(np.complex64)
PAM4 = np.asarray(fsm_utils.pam4[1], np.float32)


def _packets(rng, rep, K, I):
    return jnp.asarray(rng.integers(0, I, (rep, K)), jnp.int32)


def sim_tcm(esn0_db, K, rep, seed):
    """QPSK-ish TCM: FSM4 -> 4-PAM -> AWGN -> metrics -> Viterbi."""
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I)
    es = float(np.mean(PAM4 ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = jnp.asarray(
        np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), jnp.float32)

    @jax.jit
    def one_batch(data, noise):
        data = data.astype(jnp.int32)
        def one(d, n):
            _, syms = fsm_encode(FSM4, d)
            rx = jnp.asarray(PAM4)[syms] + n
            m = calc_metric_cost(rx, jnp.asarray(PAM4), 1)
            return viterbi(FSM4, -m, 0, -1)
        dec = jax.vmap(one)(data, noise)
        return (dec != data).sum().astype(jnp.float32)

    errs = int(one_batch(data, noise))
    return errs, rep * K


def sim_eq(esn0_db, K, rep, seed):
    """Viterbi equalization: 4-PAM through an ISI channel."""
    channel = [0.9, 0.3, -0.2]
    fsm = FSM.from_isi(4, len(channel))
    dim, lookup = fsm_utils.make_isi_lookup(fsm_utils.pam4, channel, True)
    lut = np.asarray(lookup, np.float32)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, 4)
    es = float(np.mean(lut ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = jnp.asarray(
        np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), jnp.float32)

    @jax.jit
    def one_batch(data, noise):
        data = data.astype(jnp.int32)
        def one(d, n):
            _, out = fsm_encode(fsm, d)
            rx = jnp.asarray(lut)[out] + n
            m = calc_metric_cost(rx, jnp.asarray(lut), dim)
            return viterbi(fsm, -m, 0, -1)
        dec = jax.vmap(one)(data, noise)
        return (dec != data).sum().astype(jnp.float32)

    return int(one_batch(data, noise)), rep * K


def sim_sccc(esn0_db, K, rep, seed, iterations):
    """SCCC turbo: (5,7) outer -> interleave -> msb inner -> 8PSK."""
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I)
    sigma = float(np.sqrt(1.0 / 10 ** (esn0_db / 10) / 2))
    # complex noise drawn as re/im pairs
    noise = jnp.asarray(
        sigma * rng.standard_normal((rep, K, 2)), jnp.float32)
    INTER = jnp.asarray(il.INTER)

    @jax.jit
    def one_batch(data, noise):
        data = data.astype(jnp.int32)
        def one(d, n):
            _, mid = fsm_encode(FSM4, d)
            _, syms = fsm_encode(FSM_MSB, mid[INTER])
            rx = (jnp.asarray(PSK8)[syms]
                  + jax.lax.complex(n[:, 0], n[:, 1]))
            m = calc_metric_cost(rx, jnp.asarray(PSK8), 1) / (2 * sigma ** 2)
            return sccc_decoder(FSM4, FSM_MSB, il, m, iterations)
        dec = jax.vmap(one)(data, noise)
        return (dec != data).sum().astype(jnp.float32)

    return int(one_batch(data, noise)), rep * K


def sim_pccc(esn0_db, K, rep, seed, iterations):
    """PCCC turbo: two (5,7) codes in parallel, 2x4-PAM."""
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I)
    table = np.zeros((FSM4.O * FSM4.O, 2), np.float32)
    for o1 in range(FSM4.O):
        for o2 in range(FSM4.O):
            table[o1 * FSM4.O + o2] = (PAM4[o1], PAM4[o2])
    es = 2 * float(np.mean(PAM4 ** 2))
    sigma = float(np.sqrt(es / 2 / 10 ** (esn0_db / 10)))
    noise = jnp.asarray(
        sigma * rng.standard_normal((rep, K, 2)), jnp.float32)
    INTER = jnp.asarray(il.INTER)

    @jax.jit
    def one_batch(data, noise):
        data = data.astype(jnp.int32)
        def one(d, n):
            _, o1 = fsm_encode(FSM4, d)
            _, o2 = fsm_encode(FSM4, d[INTER])
            rx = jnp.stack([jnp.asarray(PAM4)[o1],
                            jnp.asarray(PAM4)[o2]], 1) + n
            m = calc_metric_cost(rx.reshape(-1), jnp.asarray(table),
                                 2) / sigma ** 2
            return pccc_decoder(FSM4, FSM4, il, m, iterations)
        dec = jax.vmap(one)(data, noise)
        return (dec != data).sum().astype(jnp.float32)

    return int(one_batch(data, noise)), rep * K


def sim_turbo_eq(esn0_db, K, rep, seed, iterations):
    """Turbo equalization (test_turbo_equalization.py): outer (5,7) code ->
    interleave -> 4-PAM through Proakis channel C; the ISI trellis acts as
    the SCCC inner 'code', so the receiver IS the SCCC turbo loop."""
    channel = list(fsm_utils.c_channel)
    fsm_i = FSM.from_isi(4, len(channel))
    dim, lookup = fsm_utils.make_isi_lookup(fsm_utils.pam4, channel, True)
    lut = np.asarray(lookup, np.float32)
    il = Interleaver.random(K, seed=666)
    rng = np.random.default_rng(seed)
    data = _packets(rng, rep, K, FSM4.I)
    es = float(np.mean(lut ** 2))
    n0 = es / 10 ** (esn0_db / 10)
    noise = jnp.asarray(
        np.sqrt(n0 / 2) * rng.standard_normal((rep, K)), jnp.float32)
    INTER = jnp.asarray(il.INTER)

    @jax.jit
    def one_batch(data, noise):
        data = data.astype(jnp.int32)
        def one(d, n):
            _, mid = fsm_encode(FSM4, d)
            _, out = fsm_encode(fsm_i, mid[INTER])
            rx = jnp.asarray(lut)[out] + n
            m = calc_metric_cost(rx, jnp.asarray(lut), dim)
            return sccc_decoder(FSM4, fsm_i, il, m, iterations)
        dec = jax.vmap(one)(data, noise)
        return (dec != data).sum().astype(jnp.float32)

    return int(one_batch(data, noise)), rep * K


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scheme",
                    choices=["tcm", "eq", "sccc", "pccc", "turbo-eq"])
    ap.add_argument("-e", "--esn0", type=float, default=10.0,
                    help="Es/N0 in dB")
    ap.add_argument("-K", type=int, default=1024,
                    help="packet size in trellis steps")
    ap.add_argument("-r", "--repetitions", type=int, default=32)
    ap.add_argument("-i", "--iterations", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.scheme == "tcm":
        errs, total = sim_tcm(args.esn0, args.K, args.repetitions, args.seed)
    elif args.scheme == "eq":
        errs, total = sim_eq(args.esn0, args.K, args.repetitions, args.seed)
    elif args.scheme == "sccc":
        errs, total = sim_sccc(args.esn0, args.K, args.repetitions,
                               args.seed, args.iterations)
    elif args.scheme == "pccc":
        errs, total = sim_pccc(args.esn0, args.K, args.repetitions,
                               args.seed, args.iterations)
    else:
        errs, total = sim_turbo_eq(args.esn0, args.K, args.repetitions,
                                   args.seed, args.iterations)
    print(f"{args.scheme}: Es/N0={args.esn0:.1f} dB  {total} symbols  "
          f"{errs} errors  SER={errs / total:.3e}")


if __name__ == "__main__":
    main()
