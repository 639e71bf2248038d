"""GSM 06.10 full-rate (RPE-LTP) codec: 160 int16 samples <-> 33-byte frames.

Reference behavior: gr-vocoder/lib/gsm/ (libgsm 1.0, Degener/Bormann) wrapped
by vocoder_gsm_fr_encode_sp / _decode_ps (sync decimator/interpolator by 160,
regular non-WAV49 packing, gsm.h:44 GSM_MAGIC 0xD).

Formulation: the codec is a per-frame recurrence (lax.scan over frames);
within a frame the per-sample feedback paths (preprocessing, the 8th-order
short-term lattice, deemphasis) are per-sample scans, while the heavy parts
(autocorrelation, the 81-lag LTP search, the RPE weighting filter) are
vectorized int32 tensor ops.  Batch throughput comes from vmapping channels.

Bit-exactness: every 16-bit store in the reference is reproduced with an
explicit ``_s16`` truncation, saturating adds with clips, and two quirks of
the golden build are kept deliberately:
  * preprocess.c:96-100 calls GSM_L_ADD with ``(ulongword)`` casts, which on
    the build used for the golden vectors returns MAX_LONGWORD for any
    negative sum (with nonzero second operand) — reproduced by
    ``_l_add_cast``;
  * long_term.c scaling: when dmax == 0 the second `if` overwrites scal to 6
    (not 0) — reproduced in ``_ltp_parameters``.
Verified bit-exact against frames/PCM from the compiled reference C
(tests/test_vocoder_gsm.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from grtpu.runtime.block import Block, Port, port_s

_MAXW, _MINW = 32767, -32768
_MAXL = 2147483647

# --- tables (gsm/table.c) ---------------------------------------------------
_DLB = np.array([6554, 16384, 26214, 32767], np.int32)        # 4.3a
_QLB = np.array([3277, 11469, 21299, 32767], np.int32)        # 4.3b
_H = np.array([-134, -374, 0, 2054, 5741, 8192,
               5741, 2054, 0, -374, -134], np.int32)          # 4.4
_NRFAC = np.array([29128, 26215, 23832, 21846,
                   20165, 18725, 17476, 16384], np.int32)     # 4.5
_FAC = np.array([18431, 20479, 22527, 24575,
                 26623, 28671, 30719, 32767], np.int32)       # 4.6
# LAR quantizer constants (lpc.c Quantization_and_coding STEPs).
_LAR_A = np.array([20480, 20480, 20480, 20480,
                   13964, 15360, 8534, 9036], np.int32)
_LAR_B = np.array([0, 0, 2048, -2560, 94, -1792, -341, -1144], np.int32)
_LAR_MAC = np.array([31, 31, 15, 15, 7, 7, 3, 3], np.int32)
_LAR_MIC = np.array([-32, -32, -16, -16, -8, -8, -4, -4], np.int32)
_LAR_INVA = np.array([13107, 13107, 13107, 13107,
                      19223, 17476, 31454, 29708], np.int32)


# --- 16/32-bit arithmetic primitives (gsm/add.c, private.h) ------------------
def _s16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _add16(a, b):
    return jnp.clip(a + b, _MINW, _MAXW)


def _sub16(a, b):
    return jnp.clip(a - b, _MINW, _MAXW)


def _mult(a, b):
    return jnp.where((a == _MINW) & (b == _MINW), _MAXW, (a * b) >> 15)


def _mult_r(a, b):
    return jnp.where((a == _MINW) & (b == _MINW), _MAXW,
                     _s16((a * b + 16384) >> 15))


def _abs16(a):
    return jnp.where(a < 0, jnp.where(a == _MINW, _MAXW, -a), a)


def _sasr(x, n):
    # jnp >> on signed ints is an arithmetic shift and broadcasts; all call
    # sites guarantee 0 <= n < 32.
    return x >> n


def _lsl(x, n):
    return x << n


def _norm32(a):
    """gsm_norm: shifts to normalize a (!=0) to bit 30 (add.c:139-152)."""
    x = jnp.where(a < 0, ~a, a)
    return jnp.where(a <= -1073741824, 0, lax.clz(x) - 1).astype(jnp.int32)


def _l_add_cast(a, b):
    """GSM_L_ADD((ulongword)a, (ulongword)b) as the golden build computes it:
    b == 0 -> a; negative sum (b != 0) -> MAX_LONGWORD; else saturated sum."""
    s = a + b  # int32 wraps; wrap implies true sum >= 2**31 when a,b > 0
    neg_ovf = (a < 0) & (b < 0) & (s >= 0)
    return jnp.where(b == 0, a, jnp.where(neg_ovf | (s < 0), _MAXL, s))


def _div16(num, denum):
    """gsm_div: 15-step restoring division, num >= 0 (add.c:206-235)."""
    div = jnp.zeros_like(num)
    for _ in range(15):
        div = div << 1
        num = num << 1
        ge = num >= denum
        num = jnp.where(ge, num - denum, num)
        div = jnp.where(ge, div + 1, div)
    return div


# --- 4.2.1/4.2.2 preprocessing (offset compensation + preemphasis) ----------
def _preprocess(carry, s):
    def step(c, sk):
        z1, L_z2, mp = c
        so_in = _sasr(sk, 3) << 2
        s1 = so_in - z1
        msp_z = _s16(_sasr(L_z2, 15))
        lsp = _s16(L_z2 - (msp_z << 15))
        L_s2 = (s1 << 15) + ((lsp * 32735 + 16384) >> 15)
        L_z2n = _l_add_cast(msp_z * 32735, L_s2)
        L_t = _l_add_cast(L_z2n, 16384)
        msp = _mult_r(mp, -28180)
        mpn = _s16(_sasr(L_t, 15))
        return (so_in, L_z2n, mpn), _add16(mpn, msp)

    return lax.scan(step, carry, s)


# --- 4.2.4/4.2.5 LPC analysis ------------------------------------------------
def _lpc_analysis(so):
    """Autocorrelation + Schur + LAR transform + quantization (gsm/lpc.c).

    Returns (LARc (8,), rescaled so)."""
    smax = jnp.max(_abs16(so))
    scalauto = jnp.where(smax == 0, 0, 4 - _norm32(smax << 16))
    factor = _sasr(jnp.asarray(16384, jnp.int32),
                   jnp.clip(scalauto - 1, 0, 3))
    s = jnp.where(scalauto > 0, _mult_r(so, factor), so)

    acf = [jnp.sum(s[k:] * s[:160 - k] if k else s * s) << 1
           for k in range(9)]
    L_ACF = jnp.stack(acf)
    s_out = jnp.where(scalauto > 0, _s16(_lsl(s, scalauto)), s)

    # Schur recursion (Reflection_coefficients, lpc.c).
    zero_acf = L_ACF[0] == 0
    tnorm = _norm32(jnp.where(zero_acf, 1, L_ACF[0]))
    ACF = _sasr(_lsl(L_ACF, tnorm), 16)
    P = [ACF[i] for i in range(9)]
    K = [jnp.zeros((), jnp.int32)] + [ACF[i] for i in range(1, 8)]
    r_out = []
    dead = zero_acf
    for n in range(1, 9):
        temp = _abs16(P[1])
        dead = dead | (P[0] < temp)
        rn = _div16(jnp.where(temp == 0, 0, temp),
                    jnp.where(P[0] == 0, 1, P[0]))
        rn = jnp.where(P[1] > 0, -rn, rn)
        r_out.append(jnp.where(dead, 0, rn))
        if n == 8:
            break
        P[0] = _add16(P[0], _mult_r(P[1], rn))
        for m in range(1, 9 - n):
            t2 = _mult_r(K[m], rn)
            newP = _add16(P[m + 1], t2)
            t3 = _mult_r(P[m + 1], rn)
            K[m] = _add16(K[m], t3)
            P[m] = newP
    r = jnp.stack(r_out)

    # Transformation to LAR.
    t = _abs16(r)
    lar = jnp.where(t < 22118, t >> 1,
                    jnp.where(t < 31130, t - 11059, (t - 26112) << 2))
    lar = jnp.where(r < 0, -lar, lar)

    # Quantization and coding.
    q = _sasr(_add16(_add16(_mult(_LAR_A, lar), _LAR_B), 256), 9)
    larc = jnp.where(q > _LAR_MAC, _LAR_MAC - _LAR_MIC,
                     jnp.where(q < _LAR_MIC, 0, q - _LAR_MIC))
    return larc.astype(jnp.int32), s_out


# --- 4.2.8/4.2.9 LAR decode + interpolation + rp ------------------------------
def _decode_lar(larc):
    t1 = _add16(larc, _LAR_MIC) << 10
    t1 = _sub16(t1, _LAR_B << 1)
    t1 = _mult_r(_LAR_INVA, t1)
    return _add16(t1, t1)


def _larp_to_rp(larp):
    t = jnp.where(larp < 0,
                  jnp.where(larp == _MINW, _MAXW, -larp), larp)
    v = jnp.where(t < 11059, t << 1,
                  jnp.where(t < 20070, t + 11059, _add16(t >> 2, 26112)))
    return jnp.where(larp < 0, -v, v)


def _zone_rps(prev, cur):
    """The four interpolation zones (k=0..12, 13..26, 27..39, 40..159)."""
    z0 = _add16(_add16(_sasr(prev, 2), _sasr(cur, 2)), _sasr(prev, 1))
    z1 = _add16(_sasr(prev, 1), _sasr(cur, 1))
    z2 = _add16(_add16(_sasr(prev, 2), _sasr(cur, 2)), _sasr(cur, 1))
    return [_larp_to_rp(z) for z in (z0, z1, z2, cur)]


_ZONES = ((0, 13), (13, 14), (27, 13), (40, 120))


def _short_term_analysis(u, larpp_prev, larc, so):
    """8th-order lattice analysis filter over the 4 zones (short_term.c)."""
    larpp = _decode_lar(larc)
    rps = _zone_rps(larpp_prev, larpp)
    outs = []
    for (start, length), rp in zip(_ZONES, rps):
        def step(uc, sk, rp=rp):
            di = sav = sk
            for i in range(8):
                ui = uc[i]
                uc = uc.at[i].set(sav)
                zzz = _mult_r(rp[i], di)
                sav = _add16(ui, zzz)
                zzz = _mult_r(rp[i], ui)
                di = _add16(di, zzz)
            return uc, di

        u, d = lax.scan(step, u, lax.dynamic_slice(so, (start,), (length,)))
        outs.append(d)
    return u, larpp, jnp.concatenate(outs)


def _short_term_synthesis(v, larpp_prev, larc, wt):
    """8th-order lattice synthesis filter over the 4 zones."""
    larpp = _decode_lar(larc)
    rps = _zone_rps(larpp_prev, larpp)
    outs = []
    for (start, length), rrp in zip(_ZONES, rps):
        def step(vc, wtk, rrp=rrp):
            sri = wtk
            for i in reversed(range(8)):
                sri = _sub16(sri, _mult_r(rrp[i], vc[i]))
                vc = vc.at[i + 1].set(_add16(vc[i], _mult_r(rrp[i], sri)))
            vc = vc.at[0].set(sri)
            return vc, sri

        v, s = lax.scan(step, v, lax.dynamic_slice(wt, (start,), (length,)))
        outs.append(s)
    return v, larpp, jnp.concatenate(outs)


# --- 4.2.11 LTP ---------------------------------------------------------------
# W[l, k] = hist[120 + k - (40 + l)]: all 81 candidate lag windows.
_LTP_IDX = (80 - np.arange(81))[:, None] + np.arange(40)[None, :]


def _ltp_parameters(d, hist):
    """LTP lag + coded gain (long_term.c Calculation_of_the_LTP_parameters)."""
    dmax = jnp.max(_abs16(d))
    temp = jnp.where(dmax == 0, 0, _norm32(dmax << 16))
    scal = jnp.where(temp > 6, 0, 6 - temp)  # note: dmax==0 -> scal 6
    wt = _sasr(d, scal)

    L_res = jnp.sum(wt[None, :] * hist[_LTP_IDX], axis=1)
    maxv = jnp.max(L_res)
    Nc = jnp.where(maxv > 0, 40 + jnp.argmax(L_res).astype(jnp.int32), 40)
    L_max = jnp.maximum(maxv, 0)
    # (L_max << 1) >> (6 - scal), 64-bit-exact: == L_max >> (5-scal) for
    # scal<6; for scal==6 saturate the doubling (downstream only compares).
    L_max = jnp.where(scal == 6,
                      jnp.where(L_max >= (1 << 30), _MAXL, L_max << 1),
                      _sasr(L_max, 5 - scal))

    dp_nc = lax.dynamic_slice(hist, (120 - Nc,), (40,))
    lt = _sasr(dp_nc, 3)
    L_power = jnp.sum(lt * lt) << 1

    tn = _norm32(jnp.where(L_power == 0, 1, L_power))
    R = _sasr(_lsl(L_max, tn), 16)
    S = _sasr(_lsl(L_power, tn), 16)
    cnt = sum((R > _mult(S, jnp.asarray(_DLB[i]))).astype(jnp.int32)
              for i in range(3))
    bc = jnp.where(L_max <= 0, 0, jnp.where(L_max >= L_power, 3, cnt))
    return Nc, bc, dp_nc


# --- 4.2.13-4.2.17 RPE --------------------------------------------------------
def _xmaxc_to_exp_mant(xmaxc):
    exp = jnp.where(xmaxc > 15, _sasr(xmaxc, 3) - 1, 0)
    mant = xmaxc - (exp << 3)
    zero = mant == 0
    for _ in range(3):
        c = (~zero) & (mant <= 7)
        mant = jnp.where(c, (mant << 1) | 1, mant)
        exp = jnp.where(c, exp - 1, exp)
    return (jnp.where(zero, -4, exp), jnp.where(zero, 7, mant - 8))


def _apcm_inverse(xmc, mant, exp):
    temp1 = jnp.take(jnp.asarray(_FAC), mant)
    temp2 = _sub16(6, exp)
    temp3 = jnp.where(temp2 >= 1, _lsl(jnp.asarray(1, jnp.int32), temp2 - 1), 0)
    t = ((xmc << 1) - 7) << 12
    t = _mult_r(temp1, t)
    t = _add16(t, temp3)
    return _sasr(t, temp2)


def _rpe_encode(e40):
    # Weighting filter (rpe.c Weighting_filter): 11-tap, bias 4096, >>13.
    e50 = jnp.concatenate([jnp.zeros(5, jnp.int32), e40,
                           jnp.zeros(5, jnp.int32)])
    L = 4096 + sum(int(_H[i]) * e50[i:i + 40] for i in range(11)
                   if int(_H[i]) != 0)
    x = jnp.clip(_sasr(L, 13), _MINW, _MAXW)

    # Grid selection: energies of the 4 candidate grids, first strict max.
    def energy(m):
        t = _sasr(x[m::3][:13], 2)
        return jnp.sum(t * t) << 1

    Mc = jnp.zeros((), jnp.int32)
    EM = energy(0)
    for m in range(1, 4):
        em = energy(m)
        upd = em > EM
        Mc = jnp.where(upd, m, Mc)
        EM = jnp.where(upd, em, EM)
    xM = jnp.take(x, Mc + 3 * np.arange(13, dtype=np.int32))

    # APCM quantization of the block maximum.
    xmax = jnp.max(_abs16(xM))
    exp = jnp.zeros((), jnp.int32)
    temp = _sasr(xmax, 9)
    itest = jnp.zeros((), jnp.bool_)
    for _ in range(6):
        itest = itest | (temp <= 0)
        temp = _sasr(temp, 1)
        exp = exp + jnp.where(itest, 0, 1)
    xmaxc = _add16(_sasr(xmax, exp + 5), exp << 3)

    exp2, mant = _xmaxc_to_exp_mant(xmaxc)
    temp1 = 6 - exp2
    temp2 = jnp.take(jnp.asarray(_NRFAC), mant)
    t = _s16(_lsl(xM, temp1))
    xmc = _sasr(_mult(t, temp2), 12) + 4

    xmp = _apcm_inverse(xmc, mant, exp2)
    ep = jnp.zeros(40, jnp.int32).at[Mc + 3 * np.arange(13)].set(xmp)
    return xmaxc, Mc, xmc, ep


def _rpe_decode(xmaxcr, mcr, xmcr):
    exp, mant = _xmaxc_to_exp_mant(xmaxcr)
    xmp = _apcm_inverse(xmcr, mant, exp)
    return jnp.zeros(40, jnp.int32).at[mcr + 3 * np.arange(13)].set(xmp)


# --- frame coder / decoder (gsm/code.c, decode.c) ----------------------------
def gsm_init_encode_state():
    z = lambda *s: jnp.zeros(s, jnp.int32)
    return dict(z1=z(), L_z2=z(), mp=z(), larpp_prev=z(8), u=z(8), dp0=z(120))


def gsm_init_decode_state():
    z = lambda *s: jnp.zeros(s, jnp.int32)
    return dict(larpp_prev=z(8), v=z(9), msr=z(),
                nrp=jnp.asarray(40, jnp.int32), drp=z(120))


def _encode_frame(state, s):
    pre_carry, so = _preprocess(
        (state["z1"], state["L_z2"], state["mp"]), s)
    larc, so = _lpc_analysis(so)
    u, larpp, d = _short_term_analysis(
        state["u"], state["larpp_prev"], larc, so)

    hist = state["dp0"]
    subs = []
    for k in range(4):
        dk = lax.dynamic_slice(d, (40 * k,), (40,))
        Nc, bc, dp_nc = _ltp_parameters(dk, hist)
        bp = jnp.take(jnp.asarray(_QLB), bc)
        dpp = _mult_r(bp, dp_nc)
        e = _sub16(dk, dpp)
        xmaxc, Mc, xmc, ep = _rpe_encode(e)
        hist = jnp.concatenate([hist[40:], _add16(ep, dpp)])
        subs.append(jnp.concatenate(
            [jnp.stack([Nc, bc, Mc, xmaxc]), xmc]))

    new_state = dict(z1=pre_carry[0], L_z2=pre_carry[1], mp=pre_carry[2],
                     larpp_prev=larpp, u=u, dp0=hist)
    return new_state, jnp.concatenate([larc] + subs)


def _decode_frame(state, params):
    larcr = params[:8]
    drp, nrp = state["drp"], state["nrp"]
    wt = []
    for k in range(4):
        sub = params[8 + 17 * k: 8 + 17 * (k + 1)]
        ncr, bcr, mcr, xmaxcr, xmcr = sub[0], sub[1], sub[2], sub[3], sub[4:]
        erp = _rpe_decode(xmaxcr, mcr, xmcr)
        nr = jnp.where((ncr < 40) | (ncr > 120), nrp, ncr)
        nrp = nr
        brp = jnp.take(jnp.asarray(_QLB), bcr)
        drp40 = _add16(erp, _mult_r(brp, lax.dynamic_slice(
            drp, (120 - nr,), (40,))))
        drp = jnp.concatenate([drp[40:], drp40])
        wt.append(drp40)

    v, larpp, s = _short_term_synthesis(
        state["v"], state["larpp_prev"], larcr, jnp.concatenate(wt))

    def post(msr, sk):
        tmp = _mult_r(msr, 28180)
        msr2 = _add16(sk, tmp)
        return msr2, _s16(_add16(msr2, msr2) & 0xFFF8)

    msr, out = lax.scan(post, state["msr"], s)
    return dict(larpp_prev=larpp, v=v, msr=msr, nrp=nrp, drp=drp), out


# --- 33-byte frame packing (gsm_encode.c regular branch, MSB-first) ----------
_WIDTHS = np.array([6, 6, 5, 5, 4, 4, 3, 3]
                   + 4 * ([7, 2, 2, 6] + [3] * 13), np.int32)
_BIT_PARAM = np.repeat(np.arange(76), _WIDTHS)
_BIT_SHIFT = np.concatenate([np.arange(w - 1, -1, -1) for w in _WIDTHS])
_MAGIC_BITS = np.array([1, 1, 0, 1], np.int32)  # GSM_MAGIC 0xD
_BYTE_W = (1 << np.arange(7, -1, -1)).astype(np.int32)
# unpack: value[p] = sum over its bits of bit << shift
_UNPACK_W = np.zeros((264, 76), np.int32)
_UNPACK_W[np.arange(260) + 4, _BIT_PARAM] = 1 << _BIT_SHIFT


def gsm_pack(params):
    """(..., 76) int32 params -> (..., 33) uint8 frames."""
    bits = (params[..., _BIT_PARAM] >> _BIT_SHIFT) & 1
    magic = jnp.broadcast_to(jnp.asarray(_MAGIC_BITS),
                             bits.shape[:-1] + (4,))
    allbits = jnp.concatenate([magic, bits], axis=-1)
    return jnp.sum(allbits.reshape(allbits.shape[:-1] + (33, 8)) * _BYTE_W,
                   axis=-1).astype(jnp.uint8)


def gsm_unpack(frames):
    """(..., 33) uint8 frames -> (..., 76) int32 params."""
    bits = ((frames[..., :, None].astype(jnp.int32)
             >> np.arange(7, -1, -1)) & 1)
    bits = bits.reshape(frames.shape[:-1] + (264,))
    return jnp.einsum("...b,bp->...p", bits, jnp.asarray(_UNPACK_W),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.int32)


@jax.jit
def gsm_fr_encode(state, pcm):
    """int16 PCM (n*160,) -> (state', uint8 frames (n, 33))."""
    frames = pcm.astype(jnp.int32).reshape(-1, 160)
    state, params = lax.scan(_encode_frame, state, frames)
    return state, gsm_pack(params)


@jax.jit
def gsm_fr_decode(state, frames):
    """uint8 frames (n, 33) -> (state', int16 PCM (n*160,))."""
    params = gsm_unpack(frames)
    state, pcm = lax.scan(_decode_frame, state, params)
    return state, pcm.reshape(-1).astype(jnp.int16)


class GsmFrEncode(Block):
    """vocoder_gsm_fr_encode_sp: 160 int16 samples -> one 33-byte frame."""

    in_ports = (port_s(),)
    out_ports = (Port(jnp.uint8, vlen=33),)
    decim = 160

    def init_state(self):
        return gsm_init_encode_state()

    def apply(self, state, x):
        return gsm_fr_encode(state, x)


class GsmFrDecode(Block):
    """vocoder_gsm_fr_decode_ps: one 33-byte frame -> 160 int16 samples."""

    in_ports = (Port(jnp.uint8, vlen=33),)
    out_ports = (port_s(),)
    interp = 160

    def init_state(self):
        return gsm_init_decode_state()

    def apply(self, state, x):
        return gsm_fr_decode(state, x)
