"""Generic trellis algorithms: Viterbi and SISO (max-log BCJR).

Analog of gr-trellis core_algorithms (gr-trellis/src/lib/core_algorithms.
{h,cc}:37-126): table-driven Viterbi over any FSM, metric types
(euclidean on constellation points / hard symbol hamming), and the SISO
max* forward-backward used by PCCC/SCCC turbo schemes.

Design: time recursions are lax.scans carrying all S path metrics as a
vector; per-step work is gathers over the predecessor tables + max-reduce.
Branch metrics for the whole block are computed up front as one batched
distance matrix, not per step.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.trellis.fsm import FSM

NEG = -1e9


def calc_metric_euclidean(obs: jnp.ndarray, table: jnp.ndarray,
                          dim: int = 1) -> jnp.ndarray:
    """(T*dim,) observations vs O constellation points of dimension dim ->
    (T, O) NEGATIVE squared distances (higher = better), matching
    calc_metric's TRELLIS_EUCLIDEAN (up to sign; we maximize)."""
    o = obs.reshape(-1, dim)
    t = table.reshape(-1, dim)
    if jnp.iscomplexobj(o) or jnp.iscomplexobj(t):
        d = jnp.abs(o[:, None, :] - t[None, :, :]) ** 2
    else:
        d = (o[:, None, :] - t[None, :, :]) ** 2
    return -d.sum(-1)


def calc_metric_hard(obs_symbols: jnp.ndarray, O: int) -> jnp.ndarray:
    """(T,) hard symbols -> (T, O) 0/-1 match metric (TRELLIS_HARD_SYMBOL)."""
    eye = jnp.where(
        jnp.arange(O)[None, :] == obs_symbols[:, None].astype(jnp.int32),
        0.0, -1.0)
    return eye


def viterbi(fsm: FSM, metrics: jnp.ndarray, start_state: int = 0,
            end_state: int = -1,
            parallel: Optional[bool] = None) -> jnp.ndarray:
    """Table-driven Viterbi (core_algorithms viterbi_algorithm).

    metrics: (T, O) per-step per-output-symbol metrics (higher better).
    Returns (T,) decoded input symbols.

    parallel=True opts into the log-depth formulation (_viterbi_parallel):
    prefix max-plus products give every alpha at once and the traceback
    becomes an associative composition of best-predecessor maps (pointer
    doubling) — no O(T) sequential scan.  Worth it only for single-packet
    latency; the default sequential scan with the one-hot traceback wins
    once packets are batched."""
    if _use_parallel(fsm.S, parallel):
        return _viterbi_parallel(fsm, metrics, start_state, end_state)
    S, I = fsm.S, fsm.I
    PS = jnp.asarray(fsm.PS)  # (S, deg)
    PI = jnp.asarray(fsm.PI)
    OS = jnp.asarray(fsm.OS)  # (S, I)
    valid = jnp.asarray(fsm.PS >= 0)
    PSc = jnp.maximum(PS, 0)
    PIc = jnp.maximum(PI, 0)
    # output symbol on edge (PS[s,j] --PI[s,j]--> s)
    edge_out = OS[PSc, PIc]  # (S, deg)

    pm0 = jnp.full((S,), NEG, jnp.float32)
    if start_state >= 0:
        pm0 = pm0.at[start_state].set(0.0)
    else:
        pm0 = jnp.zeros((S,), jnp.float32)

    def step(pm, m_t):
        cand = jnp.where(valid, pm[PSc] + m_t[edge_out], NEG)  # (S, deg)
        best = jnp.argmax(cand, axis=1)
        pm_new = cand.max(axis=1)
        pm_new = pm_new - pm_new.max()
        return pm_new, best.astype(jnp.int8)

    pm_final, choices = jax.lax.scan(step, pm0, metrics)

    s_end = (jnp.argmax(pm_final).astype(jnp.int32)
             if end_state < 0 else jnp.asarray(end_state, jnp.int32))

    # Traceback with the state as a one-hot vector: per-step work is tiny
    # static einsums instead of dynamic gathers inside the K-deep scan.
    deg = PSc.shape[1]
    pred_oh = np.zeros((S, deg, S), np.float32)
    ps_host = np.maximum(np.asarray(fsm.PS), 0)
    pred_oh[np.arange(S)[:, None], np.arange(deg)[None, :], ps_host] = 1.0
    pred_oh_j = jnp.asarray(pred_oh)
    pi_f = jnp.asarray(np.maximum(np.asarray(fsm.PI), 0), jnp.float32)
    s0_oh = (jnp.arange(S) == s_end).astype(jnp.float32)

    def back(s_oh, ch_t):
        ch_oh = (ch_t[:, None] ==
                 jnp.arange(deg, dtype=ch_t.dtype)).astype(jnp.float32)
        sel = s_oh[:, None] * ch_oh                       # (S, deg)
        prev_oh = (sel[:, :, None] * pred_oh_j).sum((0, 1))
        inp = (sel * pi_f).sum()
        return prev_oh, inp

    _, inputs_rev = jax.lax.scan(back, s0_oh, choices, reverse=True)
    return jnp.round(inputs_rev).astype(jnp.int32)


def _viterbi_parallel(fsm: FSM, metrics: jnp.ndarray, start_state: int,
                      end_state: int) -> jnp.ndarray:
    """Log-depth Viterbi: max-plus prefix products for the path metrics +
    pointer-doubling composition of best-predecessor maps for traceback.
    Exact same optimum as the sequential scan (tie-breaking may differ)."""
    S, I = fsm.S, fsm.I
    T = metrics.shape[0]
    NS = np.asarray(fsm.NS)
    onehot = np.full((S, I, S), False)
    onehot[np.arange(S)[:, None], np.arange(I)[None, :], NS] = True
    oh = jnp.asarray(onehot)
    vals = metrics[:, jnp.asarray(fsm.OS)]                 # (T, S, I)
    masked = jnp.where(oh[None], vals[..., None], NEG)     # (T, S, I, S)
    R = masked.max(axis=2)                                 # edge rewards
    edge_in = masked.argmax(axis=2).astype(jnp.int32)      # (T, S, S)

    def mm(a, b):
        return jnp.maximum((a[..., :, :, None]
                            + b[..., None, :, :]).max(-2), NEG)

    P = jax.lax.associative_scan(mm, R)                    # prefix products
    a0 = (jnp.zeros((S,), jnp.float32) if start_state < 0
          else jnp.full((S,), NEG, jnp.float32).at[start_state].set(0.0))
    av = (a0[None, :, None] + P[:-1]).max(1)               # (T-1, S)
    alphas = jnp.concatenate([a0[None], av], axis=0)       # alpha BEFORE t
    bp = (alphas[:, :, None] + R).argmax(1).astype(jnp.int32)  # (T, S)

    alpha_T = (a0[:, None] + P[-1]).max(0)
    s_end = (jnp.argmax(alpha_T).astype(jnp.int32)
             if end_state < 0 else jnp.asarray(end_state, jnp.int32))

    # C[t] = F_t o F_{t+1} o ... o F_{T-1}; s_t = C[t][s_end]
    # (reverse=True passes (later, earlier) to the combine — compose as
    # earlier[later] via the swapped take)
    C = jax.lax.associative_scan(
        lambda a, b: jnp.take_along_axis(b, a, axis=-1), bp, reverse=True)
    s_all = C[:, s_end]                                    # s_0 .. s_{T-1}
    s_next = jnp.concatenate([s_all[1:], s_end[None]])
    return edge_in[jnp.arange(T), s_all, s_next].astype(jnp.int32)


def viterbi_combined(fsm: FSM, observations: jnp.ndarray,
                     constellation: jnp.ndarray, dim: int = 1,
                     start_state: int = 0, end_state: int = -1,
                     parallel: Optional[bool] = None) -> jnp.ndarray:
    """viterbi_combined_XX: metric calculation fused with decoding."""
    m = calc_metric_euclidean(observations, constellation, dim)
    return viterbi(fsm, m, start_state, end_state, parallel=parallel)


def siso(fsm: FSM, metrics: jnp.ndarray, start_state: int = 0,
         end_state: int = -1,
         prior_in: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Max-log SISO (core_algorithms siso_algorithm with max* ~ max):
    forward/backward recursions -> per-step input-symbol APPs (log domain,
    normalized so max = 0).  Returns (T, I)."""
    S, I = fsm.S, fsm.I
    T = metrics.shape[0]
    NS = jnp.asarray(fsm.NS)  # (S, I)
    OS = jnp.asarray(fsm.OS)
    PS = jnp.maximum(jnp.asarray(fsm.PS), 0)
    PI = jnp.maximum(jnp.asarray(fsm.PI), 0)
    pvalid = jnp.asarray(fsm.PS >= 0)
    edge_out_pred = OS[PS, PI]

    if prior_in is None:
        prior_in = jnp.zeros((T, I), jnp.float32)

    # Pre-normalize each metric/prior row by its max (one batched op, not
    # in the scan): per-row constants cancel in the row-normalized APPs —
    # same algebra as the dropped per-step norm — but bound the f32 carry
    # growth to K * (within-row spread) instead of K * max|metric|, so
    # posterior resolution (~|alpha| * 2^-24) stays well below the APP
    # differences that matter even for long blocks / unnormalized
    # Euclidean metrics.
    def _rowmax_norm(p):
        pmax = p.max(axis=1, keepdims=True)
        return p - jnp.where(pmax < NEG * 0.5, 0.0, pmax)

    metrics = _rowmax_norm(metrics)
    prior_in = _rowmax_norm(prior_in)

    a0 = jnp.full((S,), NEG, jnp.float32).at[max(start_state, 0)].set(0.0) \
        if start_state >= 0 else jnp.zeros((S,), jnp.float32)
    bT = (jnp.full((S,), NEG, jnp.float32).at[end_state].set(0.0)
          if end_state >= 0 else jnp.zeros((S,), jnp.float32))

    # one scan advances the independent forward (at t) and backward (at
    # T-1-t) recursions together — half the sequential depth of two scans;
    # per-step metric/prior gathers hoisted out as batched edge tensors,
    # per-step norm dropped (common constant, cancels in the row-normalized
    # APPs; see siso_cost)
    Ef = jnp.where(pvalid[None],
                   metrics[:, edge_out_pred] + prior_in[:, PI], NEG)
    # b_prev[s] = max_i b[NS[s,i]] + m_t[OS[s,i]] + pr[i]
    Eb = metrics[:, OS] + prior_in[:, None, :]

    def both(carry, inp):
        a, b = carry
        ef, eb = inp
        a_new = (a[PS] + ef).max(axis=1)
        b_new = (b[NS] + eb).max(axis=1)
        return (a_new, b_new), (a, b)

    _, (alphas, betas_r) = jax.lax.scan(both, (a0, bT), (Ef, Eb[::-1]),
                                        unroll=8)
    betas = betas_r[::-1]

    # APP(t, i) = max_s alpha_t[s] + m_t[OS[s,i]] + beta_{t+1}[NS[s,i]]
    # — no time recursion, so ONE batched (T, S, I) reduction (a scan here
    # would serialize T trivially-parallel steps)
    val = alphas[:, :, None] + betas[:, NS] + Eb   # (T, S, I)
    o = val.max(axis=1)
    return o - o.max(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Cost-domain SISO + turbo decoders (reference-faithful semantics)
# ---------------------------------------------------------------------------
#
# The reference works in the negative-log (cost) domain: metrics are
# distances (smaller = better) and combining is min (max-log / TRELLIS_MIN_SUM)
# or min* = -log(e^-a + e^-b) (log-MAP / TRELLIS_SUM_PRODUCT)
# (core_algorithms.cc:34-44).  The turbo decoders below mirror
# sccc_decoder / pccc_decoder (core_algorithms.cc:973-1067, 1105-1207)
# including their extrinsic-information bookkeeping:
#   * POSTI excludes the step-k input prior from the input posterior
#     (core_algorithms.cc:488-501);
#   * POSTO excludes the step-k output prior from the output posterior
#     (core_algorithms.cc:504-519).

INF = 1e9


def _reduce(x: jnp.ndarray, axis: int, sum_product: bool) -> jnp.ndarray:
    """min (TRELLIS_MIN_SUM) or min* (TRELLIS_SUM_PRODUCT) reduction over
    cost-domain values (core_algorithms.cc min/min_star)."""
    if sum_product:
        return -jax.scipy.special.logsumexp(-x, axis=axis)
    return jnp.min(x, axis=axis)


# ---------------------------------------------------------------------------
# Log-depth trellis recursions (tropical-semiring associative scans)
# ---------------------------------------------------------------------------
#
# The forward/backward recursions are matrix-vector products in the
# (min, +) semiring (or the log semiring for sum-product): alpha_{t+1} =
# alpha_t (x) E_t with E_t[s, s'] = cost of the step-t edge s -> s'.
# Semiring matrix products are associative, so the whole K-step recursion
# runs in ceil(log2 K) parallel rounds via lax.associative_scan — the same
# trick grtpu.ops.dsp.linear_recurrence plays for IIR, lifted to S states.
# Work is O(K S^3) instead of O(K S deg).
#
# The log-depth mode suits single-packet latency; once a few packets are
# vmapped together the O(K) scan with the one-hot traceback does less work
# (O(K S deg) against O(K S^3)).  Default is therefore sequential; pass parallel=True for latency-critical
# one-packet-at-a-time decodes with S <= _PARALLEL_MAX_S.

_PARALLEL_MAX_S = 16


def _use_parallel(S: int, parallel: Optional[bool]) -> bool:
    if parallel is None:
        return False
    if parallel and S > _PARALLEL_MAX_S:
        raise ValueError(
            f"parallel trellis mode needs S <= {_PARALLEL_MAX_S} (got {S})")
    return bool(parallel)


def _semiring_mm(A: jnp.ndarray, B: jnp.ndarray,
                 sum_product: bool) -> jnp.ndarray:
    """(..., S, S) (x) (..., S, S) in the (min,+) or log semiring."""
    X = A[..., :, :, None] + B[..., None, :, :]
    return jnp.minimum(_reduce(X, -2, sum_product), INF)


def _edge_costs(fsm: FSM, priori: jnp.ndarray,
                prioro: jnp.ndarray) -> jnp.ndarray:
    """Per-step edge-cost matrices E[t, s, s'] = min over parallel edges
    (s --i--> s') of priori[t, i] + prioro[t, OS[s, i]]  (INF if no edge)."""
    S, I = fsm.S, fsm.I
    NS = np.asarray(fsm.NS)
    onehot = np.full((S, I, S), False)
    onehot[np.arange(S)[:, None], np.arange(I)[None, :], NS] = True
    vals = priori[:, None, :] + prioro[:, jnp.asarray(fsm.OS)]   # (K, S, I)
    masked = jnp.where(jnp.asarray(onehot)[None], vals[..., None], INF)
    return masked.min(axis=2)                                    # (K, S, S)


def _alphas_parallel(E: jnp.ndarray, a0: jnp.ndarray,
                     sum_product: bool) -> jnp.ndarray:
    """alpha BEFORE each step: alphas[t] = a0 (x) E_0 (x) ... (x) E_{t-1}."""
    P = jax.lax.associative_scan(
        lambda a, b: _semiring_mm(a, b, sum_product), E)         # inclusive
    # alphas[t] for t >= 1 = a0 (x) P[t-1]; alphas[0] = a0
    av = _reduce(a0[None, :, None] + P[:-1], 1, sum_product)     # (K-1, S)
    return jnp.concatenate([a0[None], av], axis=0)


def _betas_parallel(E: jnp.ndarray, bK: jnp.ndarray,
                    sum_product: bool) -> jnp.ndarray:
    """beta AFTER each step: betas[t] = E_{t+1} (x) ... (x) E_{K-1} (x) bK."""
    # NB: with reverse=True the combine receives (later, earlier) — swap to
    # keep left-to-right products E_t (x) ... (x) E_{K-1}
    R = jax.lax.associative_scan(
        lambda a, b: _semiring_mm(b, a, sum_product), E, reverse=True)
    bv = _reduce(R[1:] + bK[None, None, :], 2, sum_product)      # (K-1, S)
    return jnp.concatenate([bv, bK[None]], axis=0)


def calc_metric_cost(obs: jnp.ndarray, table: jnp.ndarray, dim: int = 1,
                     metric_type: str = "euclidean") -> jnp.ndarray:
    """calc_metric (calc_metric.cc:30-70): (T*dim,) observations vs O
    table rows of dimension dim -> (T, O) POSITIVE costs.

    "euclidean": squared distance.  "hard_symbol": 0 for the nearest table
    row, 1 elsewhere.  ("hard_bit" is unimplemented in the reference too.)
    """
    o = obs.reshape(-1, dim)
    t = jnp.asarray(table).reshape(-1, dim)
    if jnp.iscomplexobj(o) or jnp.iscomplexobj(t):
        d = (jnp.abs(o[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    else:
        d = ((o[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    if metric_type == "euclidean":
        return d
    if metric_type == "hard_symbol":
        best = jnp.argmin(d, axis=1)
        return jnp.where(jnp.arange(d.shape[1])[None, :] == best[:, None],
                         0.0, 1.0)
    raise ValueError(f"unknown metric type {metric_type!r}")


def siso_cost(fsm: FSM, priori: jnp.ndarray, prioro: jnp.ndarray,
              start_state: int = 0, end_state: int = -1,
              posti: bool = True, posto: bool = False,
              sum_product: bool = False,
              parallel: Optional[bool] = None, unroll: int = 8):
    """siso_algorithm (core_algorithms.cc:418-563) in the cost domain.

    Args:
      priori: (K, I) input-symbol prior costs.
      prioro: (K, O) output-symbol prior costs (channel metrics).
      posti/posto: which posteriors to return (POSTI/POSTO flags).
      parallel: opt into the log-depth recursion (single-packet latency
        mode; requires S <= _PARALLEL_MAX_S).  Default: sequential scans.

    Returns (K, I), (K, O), or ((K, I), (K, O)) per the flags; each row is
    normalized so its min is 0 (the reference's per-step norm subtraction).
    Design: forward/backward are O(K) lax.scans over the S-vector of
    state costs (or opt-in log-depth tropical-semiring associative scans,
    see _alphas_parallel); the combine steps are one batched (K, S, I)
    tensor reduction either way.
    """
    S, I = fsm.S, fsm.I
    NS = jnp.asarray(fsm.NS)                    # (S, I)
    OS = jnp.asarray(fsm.OS)
    priori = jnp.asarray(priori, jnp.float32)
    prioro = jnp.asarray(prioro, jnp.float32)
    # Pre-normalize each prior row by its finite min (batched, outside the
    # scan): row constants cancel in the row-min-normalized posteriors —
    # the same algebra that justified dropping the reference's per-step
    # norm — while bounding f32 alpha/beta carry growth to
    # K * (within-row cost spread) instead of K * max|cost|.  Posterior
    # resolution is ~|carry| * 2^-24, so without this, long blocks with
    # large unnormalized Euclidean metrics could silently lose APP bits.
    # (Masked INF entries stay ~INF; a degenerate all-INF row is left
    # untouched rather than turned into NaNs.)

    def _rownorm(p):
        pmin = jnp.min(p, axis=1, keepdims=True)
        return p - jnp.where(pmin > INF * 0.5, 0.0, pmin)

    priori = _rownorm(priori)
    prioro = _rownorm(prioro)

    a0 = (jnp.zeros((S,), jnp.float32) if start_state < 0
          else jnp.full((S,), INF, jnp.float32).at[start_state].set(0.0))
    bK = (jnp.zeros((S,), jnp.float32) if end_state < 0
          else jnp.full((S,), INF, jnp.float32).at[end_state].set(0.0))

    if _use_parallel(S, parallel):
        E = _edge_costs(fsm, priori, prioro)
        alphas = _alphas_parallel(E, a0, sum_product)        # (K, S)
        betas = _betas_parallel(E, bK, sum_product)          # (K, S)
    else:
        PS = jnp.maximum(jnp.asarray(fsm.PS), 0)    # (S, deg)
        PI = jnp.maximum(jnp.asarray(fsm.PI), 0)
        pvalid = jnp.asarray(fsm.PS >= 0)
        edge_out_pred = OS[PS, PI]                  # (S, deg)

        # forward and backward recursions are independent, so ONE scan
        # advances alpha at step t and beta at step K-1-t — half the
        # sequential depth of two separate scans.  The per-step prior
        # gathers are HOISTED out as batched edge-cost tensors (the scan
        # body at large vmapped B is op-throughput-bound, not
        # latency-bound), and the reference's per-step norm subtraction
        # is dropped: it adds a COMMON constant per step, which cancels
        # in the row-normalized posteriors (the log-depth parallel path
        # already skips it); f32 carries ~K*max_cost exactly.
        Ef = (jnp.where(pvalid[None], priori[:, PI] + prioro[:, edge_out_pred],
                        INF))                       # (K, S, deg)
        Eb = priori[:, None, :] + prioro[:, OS]     # (K, S, I)

        def both(carry, inp):
            a, b = carry
            ef, eb = inp
            a_new = _reduce(a[PS] + ef, 1, sum_product)
            b_new = _reduce(b[NS] + eb, 1, sum_product)
            # emit alpha BEFORE t / beta_{t+1} (carries before update)
            return (a_new, b_new), (a, b)

        # unroll amortizes the while-loop per-iteration overhead
        _, (alphas, betas_r) = jax.lax.scan(
            both, (a0, bK), (Ef, Eb[::-1]), unroll=unroll)
        betas = betas_r[::-1]                       # (K, S): beta AFTER t

    out = []
    if posti:
        # post_in[t,i] = reduce_j alpha[t,j] + prioro[t, OS[j,i]] + beta[t+1, NS[j,i]]
        val = alphas[:, :, None] + prioro[:, OS] + betas[:, NS]   # (K, S, I)
        pi_ = _reduce(val, 1, sum_product)
        out.append(pi_ - pi_.min(axis=1, keepdims=True))
    if posto:
        # post_out[t,n] = reduce over edges (j,i) with OS[j,i] == n of
        #                 alpha[t,j] + priori[t,i] + beta[t+1, NS[j,i]].
        # Group the S*I edges by output symbol with a STATIC permutation
        # (padded to the max group size with a dummy INF column) instead
        # of masking a (K, S*I, O) tensor — O-fold less HBM traffic, the
        # dominant cost of the B-vmapped turbo decoders.
        OS_flat = np.asarray(fsm.OS).reshape(-1)               # (S*I,)
        counts = np.bincount(OS_flat, minlength=fsm.O)
        cmax = int(counts.max())
        perm = np.full((fsm.O, cmax), S * I, np.int64)
        for n2 in range(fsm.O):
            idx = np.nonzero(OS_flat == n2)[0]
            perm[n2, : len(idx)] = idx
        val = (alphas[:, :, None] + priori[:, None, :] + betas[:, NS])
        val = val.reshape(val.shape[0], S * I)                 # (K, S*I)
        val = jnp.concatenate(
            [val, jnp.full((val.shape[0], 1), INF, val.dtype)], axis=1)
        grouped = val[:, jnp.asarray(perm.reshape(-1))].reshape(
            val.shape[0], fsm.O, cmax)                         # (K, O, cmax)
        po_ = _reduce(grouped, 2, sum_product)
        out.append(po_ - po_.min(axis=1, keepdims=True))
    return tuple(out) if len(out) == 2 else out[0]


def sccc_decoder(fsm_o: FSM, fsm_i: FSM, interleaver, iprioro: jnp.ndarray,
                 iterations: int = 10, sto0: int = 0, stok: int = -1,
                 sti0: int = 0, stik: int = -1,
                 sum_product: bool = False,
                 parallel: Optional[bool] = None,
                 unroll: int = 8) -> jnp.ndarray:
    """Serially-concatenated-code turbo decoder
    (core_algorithms.cc sccc_decoder :973-1067).

    iprioro: (K, FSMi.O) inner channel metric costs.  Requires
    FSMo.O == FSMi.I (the SCCC wiring contract,
    trellis_sccc_encoder_XX.cc.t:60).  Returns (K,) hard outer inputs.
    """
    if fsm_o.O != fsm_i.I:
        raise ValueError("SCCC requires outer.O == inner.I")
    K = iprioro.shape[0]
    INTER = jnp.asarray(interleaver.INTER)
    DEINTER = jnp.asarray(interleaver.DEINTER)
    ipriori = jnp.zeros((K, fsm_i.I), jnp.float32)
    opriori = jnp.zeros((K, fsm_o.I), jnp.float32)
    oposti = None
    for rep in range(iterations):
        iposti = siso_cost(fsm_i, ipriori, iprioro, sti0, stik,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        oprioro = iposti[DEINTER]          # deinterleave inner -> outer
        if rep < iterations - 1:
            oposto = siso_cost(fsm_o, opriori, oprioro, sto0, stok,
                               posti=False, posto=True,
                               sum_product=sum_product, parallel=parallel,
                               unroll=unroll)
            ipriori = oposto[INTER]        # re-interleave outer -> inner
        else:
            oposti = siso_cost(fsm_o, opriori, oprioro, sto0, stok,
                               posti=True, sum_product=sum_product,
                               parallel=parallel, unroll=unroll)
    return jnp.argmin(oposti, axis=1).astype(jnp.int32)


def sccc_decoder_combined(fsm_o: FSM, fsm_i: FSM, interleaver,
                          observations: jnp.ndarray, table: jnp.ndarray,
                          dim: int = 1, metric_type: str = "euclidean",
                          scaling: float = 1.0, iterations: int = 10,
                          sum_product: bool = False, **kw) -> jnp.ndarray:
    """sccc_decoder_combined (core_algorithms.cc:780-...): metric
    calculation fused with decoding.  Divergence: the reference's scaling
    loop touches only metric element 0 of each step
    (core_algorithms.cc:810, an indexing slip); we scale the whole metric
    vector, which is the evident intent."""
    m = calc_metric_cost(observations, table, dim, metric_type) * scaling
    return sccc_decoder(fsm_o, fsm_i, interleaver, m, iterations,
                        sum_product=sum_product, **kw)


def pccc_decoder(fsm1: FSM, fsm2: FSM, interleaver, cprioro: jnp.ndarray,
                 iterations: int = 10, st10: int = 0, st1k: int = -1,
                 st20: int = 0, st2k: int = -1,
                 sum_product: bool = False,
                 parallel: Optional[bool] = None,
                 unroll: int = 8) -> jnp.ndarray:
    """Parallel-concatenated (turbo) decoder
    (core_algorithms.cc pccc_decoder :1105-1207).

    cprioro: (K, O1*O2) combined-output metric costs, combined symbol
    c = o1 * FSM2.O + o2.  Divergence: the reference strides the combined
    index by FSM1.O for both marginals (core_algorithms.cc:1128-1139 and
    trellis_pccc_encoder_XX.cc.t out = o1*FSM1.O()+o2) — consistent only
    when O1 == O2 (true of every in-tree example); we use the collision-free
    o1*O2+o2 on both sides.  Returns (K,) hard decisions for the common input.
    """
    if fsm1.I != fsm2.I:
        raise ValueError("PCCC requires FSM1.I == FSM2.I")
    K = cprioro.shape[0]
    INTER = jnp.asarray(interleaver.INTER)
    DEINTER = jnp.asarray(interleaver.DEINTER)
    comb = jnp.asarray(cprioro, jnp.float32).reshape(K, fsm1.O, fsm2.O)
    # Marginal metrics, computed once (the reference notes they are not
    # refined per iteration either, core_algorithms.cc:1124).
    prioro1 = _reduce(comb, 2, sum_product)    # (K, O1)
    prioro2 = _reduce(comb, 1, sum_product)    # (K, O2)
    priori1 = jnp.zeros((K, fsm1.I), jnp.float32)
    posti1 = None
    for _ in range(iterations):
        posti1 = siso_cost(fsm1, priori1, prioro1, st10, st1k,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        priori2 = posti1[INTER]
        posti2 = siso_cost(fsm2, priori2, prioro2, st20, st2k,
                           posti=True, sum_product=sum_product,
                           parallel=parallel, unroll=unroll)
        priori1 = posti2[DEINTER]
    # Hard decisions combine the final extrinsic pair (cc:1191-1204).
    total = _reduce(jnp.stack([priori1, posti1], 0), 0, sum_product)
    return jnp.argmin(total, axis=1).astype(jnp.int32)


def pccc_decoder_combined(fsm1: FSM, fsm2: FSM, interleaver,
                          observations: jnp.ndarray, table: jnp.ndarray,
                          dim: int = 1, metric_type: str = "euclidean",
                          scaling: float = 1.0, iterations: int = 10,
                          sum_product: bool = False, **kw) -> jnp.ndarray:
    """pccc_decoder_combined (core_algorithms.cc:1243-...); same whole-vector
    scaling divergence as sccc_decoder_combined."""
    m = calc_metric_cost(observations, table, dim, metric_type) * scaling
    return pccc_decoder(fsm1, fsm2, interleaver, m, iterations,
                        sum_product=sum_product, **kw)


def fsm_encode(fsm: FSM, inputs: jnp.ndarray, start_state=0):
    """Jit-friendly FSM run (trellis_encoder_XX work): returns
    (final_state, (T,) output symbols)."""
    NS = jnp.asarray(fsm.NS)
    OS = jnp.asarray(fsm.OS)

    def step(s, i):
        return NS[s, i], OS[s, i]

    s0 = jnp.asarray(start_state, jnp.int32)
    return jax.lax.scan(step, s0, jnp.asarray(inputs, jnp.int32))
