"""grtpu — a software-defined-radio framework in JAX.

A from-scratch re-design of the capabilities of GNU Radio 3.5.0
(reference: gnychis/gnuradio-3.5.0-dmr) for accelerators through XLA:

* Signal chains are pure JAX functions over batched *time-blocks*
  rather than a thread-per-block C++ scheduler over circular buffers
  (reference: gnuradio-core/src/lib/runtime/gr_scheduler_tpb.cc).
* Filter history / overlap-save tails are explicit carried state managed
  by the executor (reference: gr_buffer nzero_preload,
  gr_flat_flowgraph.cc:124-152) — on multi-device meshes they become halo
  exchanges over collectives.
* Hot kernels (FIR / polyphase / FFT convolution) are matrix products and
  FFTs that XLA hands to the card's libraries (reference: volk/ +
  gr_fir_* SIMD engines).
* Feedback loops (PLL / Costas / AGC / clock recovery) are `lax.scan`
  recurrences with explicit state pytrees (reference: gri_control_loop,
  digital_clock_recovery_mm_cc).

Layout:
    grtpu.runtime   -- Block protocol, graph builder, time-block executor
    grtpu.ops       -- kernel substrate (FIR, FFT conv, rotator, NCO, ...)
    grtpu.blocks    -- the block library (filter/general/gengen/io analogs)
    grtpu.digital   -- digital modem stack (constellations, mod/demod, sync)
    grtpu.models    -- assembled receiver/transmitter chains (blks2impl analog)
    grtpu.parallel  -- mesh sharding, halo exchange, multi-chip execution
    grtpu.utils     -- tap design (firdes/optfir), windows, eng notation
    grtpu.fec       -- Reed-Solomon / convolutional-Viterbi codecs
    grtpu.trellis   -- generic FSM trellis coding (Viterbi / SISO)
"""

__version__ = "0.1.0"

from grtpu.runtime.block import Block, Port, StreamSpec  # noqa: F401
from grtpu.runtime.graph import Graph, HierBlock  # noqa: F401
from grtpu.runtime.executor import StreamExecutor  # noqa: F401
from grtpu.runtime.top_block import TopBlock  # noqa: F401
