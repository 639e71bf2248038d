"""CCITT G.721 / G.723 ADPCM codecs as lax.scan recurrences.

Reference behavior: gr-vocoder/lib/g7xx/{g72x.c,g721.c,g723_24.c,g723_40.c}
(the Sun Microsystems implementation of CCITT G.721/G.723) wrapped by
vocoder_g7*_encode_sb / _decode_bs blocks (one code byte per PCM sample).

ADPCM has per-sample feedback through an adaptive quantizer and an adaptive
2-pole/6-zero predictor — inherently sequential, so the formulation here is a
``lax.scan`` over the time-block with the full coder state as carry.  Every
arithmetic step reproduces the reference's 16-bit truncation semantics
(explicit ``_s16`` where the C stores through ``short``), giving bit-exact
codes/output — verified against golden vectors generated from the compiled
reference C (tests/test_vocoder.py).  Throughput comes from ``jax.vmap`` over
independent voice channels, not from accelerating a single 8 kHz stream.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from grtpu.runtime.block import Block, port_b, port_s

_POWER2 = np.array([1 << k for k in range(15)], np.int32)

# Per-variant constants (g721.c:53-70, g723_24.c:46-58, g723_40.c:54-76).
_TABLES = {
    "g721": dict(
        bits=4, sign=8, mag_mask=0x3FFF, b_shift=8,
        qtab=np.array([-124, 80, 178, 246, 300, 349, 400], np.int32),
        dqln=np.array([-2048, 4, 135, 213, 273, 323, 373, 425,
                       425, 373, 323, 273, 213, 135, 4, -2048], np.int32),
        # g721 passes witab[i] << 5 to update(); pre-shift here.
        wi=np.array([-12, 18, 41, 64, 112, 198, 355, 1122,
                     1122, 355, 198, 112, 64, 41, 18, -12], np.int32) << 5,
        fi=np.array([0, 0, 0, 0x200, 0x200, 0x200, 0x600, 0xE00,
                     0xE00, 0x600, 0x200, 0x200, 0x200, 0, 0, 0], np.int32),
    ),
    "g723_24": dict(
        bits=3, sign=4, mag_mask=0x3FFF, b_shift=8,
        qtab=np.array([8, 218, 331], np.int32),
        dqln=np.array([-2048, 135, 273, 373, 373, 273, 135, -2048], np.int32),
        wi=np.array([-128, 960, 4384, 18624, 18624, 4384, 960, -128], np.int32),
        fi=np.array([0, 0x200, 0x400, 0xE00, 0xE00, 0x400, 0x200, 0], np.int32),
    ),
    "g723_40": dict(
        bits=5, sign=0x10, mag_mask=0x7FFF, b_shift=9,
        qtab=np.array([-122, -16, 68, 139, 198, 250, 298, 339,
                       378, 413, 445, 475, 502, 528, 553], np.int32),
        dqln=np.array([-2048, -66, 28, 104, 169, 224, 274, 318,
                       358, 395, 429, 459, 488, 514, 539, 566,
                       566, 539, 514, 488, 459, 429, 395, 358,
                       318, 274, 224, 169, 104, 28, -66, -2048], np.int32),
        wi=np.array([448, 448, 768, 1248, 1280, 1312, 1856, 3200,
                     4512, 5728, 7008, 8960, 11456, 14080, 16928, 22272,
                     22272, 16928, 14080, 11456, 8960, 7008, 5728, 4512,
                     3200, 1856, 1312, 1280, 1248, 768, 448, 448], np.int32),
        fi=np.array([0, 0, 0, 0, 0, 0x200, 0x200, 0x200,
                     0x200, 0x200, 0x400, 0x600, 0x800, 0xA00, 0xC00, 0xC00,
                     0xC00, 0xC00, 0xA00, 0x800, 0x600, 0x400, 0x200, 0x200,
                     0x200, 0x200, 0x200, 0, 0, 0, 0, 0], np.int32),
    ),
}


def _s16(x):
    """Reproduce C assignment-through-short truncation (sign-extended)."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _quan_pow2(val):
    """quan(val, power2, 15): number of powers of two <= val."""
    return jnp.sum(val[..., None] >= _POWER2, axis=-1).astype(jnp.int32)


def _rshift(x, n):
    return jax.lax.shift_right_arithmetic(x, jnp.maximum(n, 0))


def _lshift(x, n):
    return jax.lax.shift_left(x, jnp.maximum(n, 0))


class G72xState(NamedTuple):
    """Coder state (g72x.h struct g72x_state; init per g72x_init_state)."""
    yl: jnp.ndarray    # locked step-size multiplier (32-bit)
    yu: jnp.ndarray    # unlocked step-size multiplier
    dms: jnp.ndarray   # short-term energy estimate
    dml: jnp.ndarray   # long-term energy estimate
    ap: jnp.ndarray    # yl/yu mixing speed
    a: jnp.ndarray     # (2,) pole predictor coefficients
    b: jnp.ndarray     # (6,) zero predictor coefficients
    pk: jnp.ndarray    # (2,) signs of previous reconstructed samples
    dq: jnp.ndarray    # (6,) past quantized differences (float format)
    sr: jnp.ndarray    # (2,) past reconstructed samples (float format)
    td: jnp.ndarray    # tone/transition detect flag


def g72x_init_state() -> G72xState:
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    return G72xState(
        yl=i32(34816), yu=i32(544), dms=i32(0), dml=i32(0), ap=i32(0),
        a=jnp.zeros(2, jnp.int32), b=jnp.zeros(6, jnp.int32),
        pk=jnp.zeros(2, jnp.int32), dq=jnp.full(6, 32, jnp.int32),
        sr=jnp.full(2, 32, jnp.int32), td=i32(0))


def _fmult(an, srn):
    """14-bit int x (4-bit exp, 6-bit mantissa) float product (g72x.c:65-85)."""
    anmag = jnp.where(an > 0, an, (-an) & 0x1FFF)
    anexp = _quan_pow2(anmag) - 6
    anmant = jnp.where(anmag == 0, 32,
                       jnp.where(anexp >= 0, _rshift(anmag, anexp),
                                 _lshift(anmag, -anexp)))
    wanexp = anexp + ((srn >> 6) & 0xF) - 13
    wanmant = (anmant * (srn & 0x3F) + 0x30) >> 4
    retval = _s16(jnp.where(wanexp >= 0,
                            _lshift(wanmant, wanexp) & 0x7FFF,
                            _rshift(wanmant, -wanexp)))
    return jnp.where((an ^ srn) < 0, -retval, retval)


def _predictors(st: G72xState):
    """sezi (6-zero) and sei (zero+pole) partial estimates, short-truncated."""
    sezi = _s16(jnp.sum(jax.vmap(_fmult)(st.b >> 2, st.dq)))
    pole = _fmult(st.a[1] >> 2, st.sr[1]) + _fmult(st.a[0] >> 2, st.sr[0])
    sez = sezi >> 1
    se = _s16((sezi + pole) >> 1)
    return sez, se


def _step_size(st: G72xState):
    """Adaptive quantizer step (g72x.c:155-177)."""
    y = st.yl >> 6
    dif = st.yu - y
    al = st.ap >> 2
    adj = jnp.where(dif > 0, (dif * al) >> 6,
                    jnp.where(dif < 0, (dif * al + 0x3F) >> 6, 0))
    return jnp.where(st.ap >= 256, st.yu, y + adj).astype(jnp.int32)


def _quantize(d, y, qtab):
    """Log-domain quantization of difference d (g72x.c:186-226)."""
    size = len(qtab)
    dqm = _s16(jnp.abs(d))
    exp = _quan_pow2(dqm >> 1)
    mant = _rshift(dqm << 7, exp) & 0x7F
    dln = (exp << 7) + mant - (y >> 2)
    i = jnp.sum(dln[..., None] >= qtab, axis=-1).astype(jnp.int32)
    return jnp.where(d < 0, (size << 1) + 1 - i,
                     jnp.where(i == 0, (size << 1) + 1, i))


def _reconstruct(sign, dqln, y):
    """Inverse log-domain quantizer (g72x.c:234-258)."""
    dql = dqln + (y >> 2)
    dex = (dql >> 7) & 15
    dqt = 128 + (dql & 127)
    dq = _rshift(dqt << 7, 14 - dex)
    return jnp.where(sign != 0,
                     jnp.where(dql < 0, -0x8000, dq - 0x8000),
                     jnp.where(dql < 0, 0, dq))


def _float_ab(val, neg):
    """FLOAT A/B: 4-bit exponent, 6-bit mantissa encode (g72x.c:401-423)."""
    mag = jnp.abs(val)
    exp = _quan_pow2(mag)
    enc = (exp << 6) + _rshift(mag << 6, exp)
    enc = jnp.where(neg, enc - 0x400, enc)
    return jnp.where(mag == 0, jnp.where(neg, _s16(0xFC20), 0x20), enc)


def _update(st: G72xState, b_shift, y, wi, fi, dq, sr, dqsez) -> G72xState:
    """State update common to encode/decode (g72x.c:266-455)."""
    pk0 = jnp.where(dqsez < 0, 1, 0)
    mag = dq & 0x7FFF

    # TRANS: tone/transition detection threshold from locked scale factor.
    ylint = st.yl >> 15
    ylfrac = (st.yl >> 10) & 0x1F
    thr1 = _lshift(32 + ylfrac, ylint)
    thr2 = jnp.where(ylint > 9, 31 << 10, thr1)
    dqthr = (thr2 + (thr2 >> 1)) >> 1
    tr = jnp.where(st.td == 0, 0, jnp.where(mag <= dqthr, 0, 1))

    # FUNCTW & FILTD & LIMB & FILTE: scale-factor adaptation.
    yu = jnp.clip(_s16(y + ((wi - y) >> 5)), 544, 5120)
    yl = st.yl + yu + ((-st.yl) >> 6)

    # Adaptive predictor update (UPA2/LIMC for a2, UPA1/LIMD for a1, UPB).
    pks1 = pk0 ^ st.pk[0]
    a2p = st.a[1] - (st.a[1] >> 7)
    fa1 = jnp.where(pks1 != 0, st.a[0], -st.a[0])
    a2p_adj = a2p + jnp.where(fa1 < -8191, -0x100,
                              jnp.where(fa1 > 8191, 0xFF, fa1 >> 5))
    a2p_lim = jnp.where(
        (pk0 ^ st.pk[1]) != 0,
        jnp.where(a2p_adj <= -12160, -12288,
                  jnp.where(a2p_adj >= 12416, 12288, a2p_adj - 0x80)),
        jnp.where(a2p_adj <= -12416, -12288,
                  jnp.where(a2p_adj >= 12160, 12288, a2p_adj + 0x80)))
    a2p = jnp.where(dqsez != 0, a2p_lim, a2p)

    a1 = st.a[0] - (st.a[0] >> 8)
    a1 = a1 + jnp.where(dqsez != 0, jnp.where(pks1 == 0, 192, -192), 0)
    a1ul = 15360 - a2p
    a1 = jnp.clip(a1, -a1ul, a1ul)

    b = st.b - _rshift(st.b, b_shift)
    b_step = jnp.where((dq ^ st.dq) >= 0, 128, -128)
    b = b + jnp.where((dq & 0x7FFF) != 0, b_step, 0)

    # TRIGB: modem (data) signal resets the whole predictor.
    is_tr = tr == 1
    a = jnp.where(is_tr, 0, jnp.stack([a1, a2p]))
    b = jnp.where(is_tr, 0, b)

    # DELAY A / FLOAT A / FLOAT B.
    dq_hist = jnp.concatenate([_float_ab(mag, dq < 0)[None], st.dq[:5]])
    sr_hist = jnp.stack([
        jnp.where(sr == -32768, _s16(0xFC20), _float_ab(sr, sr < 0)),
        st.sr[0]])
    pk = jnp.stack([pk0, st.pk[0]])

    # TONE + adaptation speed control (FILTA/FILTB/SUBTC).
    td = jnp.where(is_tr, 0, jnp.where(a2p < -11776, 1, 0))
    dms = st.dms + ((fi - st.dms) >> 5)
    dml = st.dml + (((fi << 2) - st.dml) >> 7)
    fast = (y < 1536) | (td == 1) | \
        (jnp.abs((dms << 2) - dml) >= (dml >> 3))
    ap = jnp.where(is_tr, 256,
                   jnp.where(fast, st.ap + ((0x200 - st.ap) >> 4),
                             st.ap + ((-st.ap) >> 4)))

    return G72xState(yl=yl, yu=yu, dms=dms, dml=dml, ap=ap, a=a, b=b,
                     pk=pk, dq=dq_hist, sr=sr_hist, td=td)


def _encode_step(tables, st: G72xState, x):
    sez, se = _predictors(st)
    d = _s16((x.astype(jnp.int32) >> 2) - se)   # 14-bit input, SUBTA
    y = _step_size(st)
    i = _quantize(d, y, tables["qtab"])
    dq = _reconstruct(i & tables["sign"], jnp.take(tables["dqln"], i), y)
    sr = _s16(jnp.where(dq < 0, se - (dq & tables["mag_mask"]), se + dq))
    dqsez = _s16(sr + sez - se)
    st = _update(st, tables["b_shift"], y, jnp.take(tables["wi"], i),
                 jnp.take(tables["fi"], i), dq, sr, dqsez)
    return st, i.astype(jnp.uint8)


def _decode_step(tables, st: G72xState, code):
    i = code.astype(jnp.int32) & ((1 << tables["bits"]) - 1)
    sez, se = _predictors(st)
    y = _step_size(st)
    dq = _reconstruct(i & tables["sign"], jnp.take(tables["dqln"], i), y)
    sr = _s16(jnp.where(dq < 0, se - (dq & tables["mag_mask"]), se + dq))
    dqsez = _s16(sr - se + sez)
    st = _update(st, tables["b_shift"], y, jnp.take(tables["wi"], i),
                 jnp.take(tables["fi"], i), dq, sr, dqsez)
    return st, _s16(sr << 2).astype(jnp.int16)


@functools.partial(jax.jit, static_argnums=0)
def g72x_encode(variant: str, state: G72xState, pcm):
    """Encode int16 PCM -> one ADPCM code byte per sample (bit-exact)."""
    tables = _TABLES[variant]
    return jax.lax.scan(functools.partial(_encode_step, tables), state, pcm)


@functools.partial(jax.jit, static_argnums=0)
def g72x_decode(variant: str, state: G72xState, codes):
    """Decode ADPCM code bytes -> int16 PCM (bit-exact)."""
    tables = _TABLES[variant]
    return jax.lax.scan(functools.partial(_decode_step, tables), state, codes)


class _G72xBlock(Block):
    _variant = None
    _encode = True
    in_ports = (port_s(),)
    out_ports = (port_b(),)

    def init_state(self):
        return g72x_init_state()

    def apply(self, state, x):
        fn = g72x_encode if type(self)._encode else g72x_decode
        return fn(type(self)._variant, state, x)


class G721Encode(_G72xBlock):
    """vocoder_g721_encode_sb: 32 kbit/s ADPCM (4-bit codes)."""
    _variant = "g721"


class G721Decode(_G72xBlock):
    """vocoder_g721_decode_bs."""
    _variant, _encode = "g721", False
    in_ports, out_ports = (port_b(),), (port_s(),)


class G723_24Encode(_G72xBlock):
    """vocoder_g723_24_encode_sb: 24 kbit/s ADPCM (3-bit codes)."""
    _variant = "g723_24"


class G723_24Decode(_G72xBlock):
    """vocoder_g723_24_decode_bs."""
    _variant, _encode = "g723_24", False
    in_ports, out_ports = (port_b(),), (port_s(),)


class G723_40Encode(_G72xBlock):
    """vocoder_g723_40_encode_sb: 40 kbit/s ADPCM (5-bit codes)."""
    _variant = "g723_40"


class G723_40Decode(_G72xBlock):
    """vocoder_g723_40_decode_bs."""
    _variant, _encode = "g723_40", False
    in_ports, out_ports = (port_b(),), (port_s(),)
