"""Tracing / profiling / invariant checks (SURVEY.md §5.1-5.2).

The reference's pieces, re-imagined for one-program XLA execution:

* scheduler iteration logs (``ENABLE_LOGGING`` sst-NNN.log,
  gr_block_executor.cc:38-45) -> :class:`TracedExecutor` writing one line
  per time-block step: step index, per-edge item counts, wall time.
* per-implementation micro benchmarks (benchmark_dotprod_*.cc:36-38,
  benchmark_filters.py) -> :func:`block_timings` timing each block's
  ``apply`` as its own jitted program, timed as the slope between two
  loop lengths inside one jitted loop.
* gruel::high_res_timer -> :func:`high_res_timer_now` (monotonic ns).
* the profiler the reference never had -> :func:`profile` wrapping
  jax.profiler.trace (XLA op-level timelines viewable in TensorBoard /
  Perfetto).
* race-detector stand-in (§5.2: the functional model removes data races;
  keep invariant checks instead) -> :func:`validate_state` asserting the
  state pytree keeps its structure/shape/dtype across steps and contains
  no NaN/Inf.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterable, List, Optional, TextIO

import jax
import jax.numpy as jnp
import numpy as np


def high_res_timer_now() -> int:
    """Monotonic nanosecond tick (gruel/high_res_timer.h:25-111)."""
    return time.monotonic_ns()


@contextlib.contextmanager
def profile(logdir: str):
    """XLA op-level profiling: ``with profile('/tmp/tb'): ex.run(...)``.

    Produces a TensorBoard/Perfetto trace of every compiled program
    executed inside the context."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# ------------------------------------------------------------ step tracing

class TracedExecutor:
    """Wrap a StreamExecutor; log one line per step (sst-NNN.log analog).

    Line format:
      step=N wall_ms=X items={edge: count, ...} [state_norm=Y]
    """

    def __init__(self, executor, file: Optional[TextIO] = None,
                 state_norms: bool = False):
        self.ex = executor
        self.file = file
        self.state_norms = state_norms
        self.lines: List[str] = []
        self._n = 0

    def step(self, *ext_inputs):
        t0 = time.perf_counter()
        out = self.ex.step(*ext_inputs)
        jax.block_until_ready(out[0])   # wall time includes the device
        ms = (time.perf_counter() - t0) * 1e3
        line = (f"step={self._n} wall_ms={ms:.3f} "
                f"items={dict(self.ex.edge_items)}")
        if self.state_norms:
            norms = {
                k: float(np.asarray(
                    jnp.real(v).astype(jnp.float32).sum()))
                for k, v in self.ex.state["tails"].items()
            }
            line += f" tail_sums={norms}"
        self._n += 1
        self.lines.append(line)
        if self.file:
            self.file.write(line + "\n")
            self.file.flush()
        return out

    def __getattr__(self, name):
        return getattr(self.ex, name)


# ------------------------------------------------------- per-block timing

def _example_input(port, n: int):
    shape = port.chunk_shape(n)
    if jnp.issubdtype(port.dtype, jnp.complexfloating):
        r = np.random.RandomState(0)
        return jnp.asarray((r.randn(*shape) + 1j * r.randn(*shape)
                            ).astype(np.complex64))
    if jnp.issubdtype(port.dtype, jnp.floating):
        return jnp.asarray(np.random.RandomState(0)
                           .randn(*shape).astype(np.float32))
    return jnp.zeros(shape, port.dtype)


def block_timings(executor, iters: int = 4) -> Dict[str, float]:
    """Per-block wall time (ms per chunk), each block as its own jitted
    program — identifies which stage bounds a fused flowgraph (the
    benchmark_dotprod / benchmark_filters analog).

    Timing: chain ``iters`` applies inside one jitted fori_loop with the
    state carried (defeats loop-invariant hoisting for stateful blocks)
    and take the (m=iters − m=1) slope; forces a scalar readback.
    """
    res: Dict[str, float] = {}
    for b in executor.order:
        n_in = executor.block_nin[b.uid]
        if b.in_ports:
            ins = [_example_input(p, n_in + max(0, b.history - 1))
                   for p in b.in_ports]
        else:
            ins = None

        def make(m):
            def run():
                def body(_, carry):
                    st, acc = carry
                    if ins is None:
                        n_out = n_in // b.decim * b.interp
                        st2, outs = b.apply(st, n_out)
                    else:
                        # tiny state-dependent perturbation defeats
                        # hoisting for stateless blocks too
                        eps = (acc * 1e-30).astype(jnp.float32)
                        pins = [x + eps.astype(x.dtype) if jnp.issubdtype(
                            x.dtype, jnp.inexact) else x for x in ins]
                        st2, outs = b.apply(st, *pins)
                    if not isinstance(outs, (tuple, list)):
                        outs = (outs,)
                    upd = [jnp.real(o).astype(jnp.float32).sum()
                           for o in outs if hasattr(o, "dtype")
                           and jnp.issubdtype(o.dtype, jnp.inexact)]
                    acc2 = acc + (sum(upd) if upd else 0.0)
                    return st2, acc2

                st0 = b.init_state()
                _, acc = jax.lax.fori_loop(
                    0, m, body, (st0, jnp.float32(0.0)))
                return acc

            return jax.jit(run)

        try:
            f1, fm = make(1), make(iters)
            float(np.asarray(f1()))  # warm both
            float(np.asarray(fm()))
            t0 = time.perf_counter()
            float(np.asarray(f1()))
            t1 = time.perf_counter()
            float(np.asarray(fm()))
            t2 = time.perf_counter()
            ms = ((t2 - t1) - (t1 - t0)) / (iters - 1) * 1e3
            res[b.name] = max(ms, 0.0)
        except Exception as e:  # blocks with host-only apply
            res[b.name] = float("nan")
    return res


# --------------------------------------------------------- invariant check

def validate_state(executor, reference_state=None) -> List[str]:
    """State-invariant checks (the §5.2 guard-rail replacement): the
    state pytree must keep its treedef/shapes/dtypes (vs reference_state
    or the executor's initial structure) and hold no NaN/Inf.  Returns a
    list of violation strings (empty = clean)."""
    problems: List[str] = []
    state = executor.state
    if reference_state is not None:
        t1 = jax.tree_util.tree_structure(state)
        t2 = jax.tree_util.tree_structure(reference_state)
        if t1 != t2:
            problems.append(f"treedef changed: {t2} -> {t1}")
        else:
            for (p1, a), (_, b) in zip(
                    jax.tree_util.tree_leaves_with_path(state),
                    jax.tree_util.tree_leaves_with_path(reference_state)):
                if hasattr(a, "shape") and hasattr(b, "shape"):
                    if a.shape != b.shape or a.dtype != b.dtype:
                        problems.append(
                            f"{jax.tree_util.keystr(p1)}: "
                            f"{b.shape}/{b.dtype} -> {a.shape}/{a.dtype}")
    for path, leaf in jax.tree_util.tree_leaves_with_path(state):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.inexact):
            # f32-safe readback of a single finite-ness scalar
            bad = float(np.asarray(
                (~jnp.isfinite(jnp.real(leaf))).sum().astype(jnp.float32)
                + (~jnp.isfinite(jnp.imag(leaf))).sum().astype(jnp.float32)
                if jnp.issubdtype(leaf.dtype, jnp.complexfloating)
                else (~jnp.isfinite(leaf)).sum().astype(jnp.float32)))
            if bad:
                problems.append(
                    f"{jax.tree_util.keystr(path)}: {int(bad)} non-finite")
    return problems
