"""Vocoder tests: bit-exact vs golden vectors from the reference C codecs.

Golden data (tests/data/vocoder_golden.npz) was produced by compiling the
reference's own codec sources (gr-vocoder/lib/g7xx, lib/gsm) into a dumper
and running them on a fixed synthetic speech-like signal — data only, no
reference code in this repo.  Analog of the reference's own QA approach
(gr-vocoder has no python QA; we hold ourselves to a stricter standard).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grtpu import vocoder

GOLD = np.load(os.path.join(os.path.dirname(__file__),
                            "data", "vocoder_golden.npz"))


class TestG711:
    def test_alaw_encode_exhaustive(self):
        pcm = np.arange(-32768, 32768, dtype=np.int16)
        got = np.asarray(vocoder.linear_to_alaw(jnp.asarray(pcm)))
        np.testing.assert_array_equal(got, GOLD["alaw_enc"])

    def test_ulaw_encode_exhaustive(self):
        pcm = np.arange(-32768, 32768, dtype=np.int16)
        got = np.asarray(vocoder.linear_to_ulaw(jnp.asarray(pcm)))
        np.testing.assert_array_equal(got, GOLD["ulaw_enc"])

    def test_alaw_decode_exhaustive(self):
        codes = np.arange(256, dtype=np.uint8)
        got = np.asarray(vocoder.alaw_to_linear(jnp.asarray(codes)))
        np.testing.assert_array_equal(got, GOLD["alaw_dec"])

    def test_ulaw_decode_exhaustive(self):
        codes = np.arange(256, dtype=np.uint8)
        got = np.asarray(vocoder.ulaw_to_linear(jnp.asarray(codes)))
        np.testing.assert_array_equal(got, GOLD["ulaw_dec"])

    def test_blocks_roundtrip_fixed_point(self):
        # One decode->encode cycle reaches a fixed point: re-encoding the
        # decoded value reproduces the same decoded value (codes themselves
        # can differ by the +-0 sign ambiguity, as in the reference).
        for enc_blk, dec_blk in [(vocoder.AlawEncode(), vocoder.AlawDecode()),
                                 (vocoder.UlawEncode(), vocoder.UlawDecode())]:
            codes = jnp.arange(256, dtype=jnp.uint8)
            _, pcm = dec_blk.apply(dec_blk.init_state(), codes)
            _, again = enc_blk.apply(enc_blk.init_state(), pcm)
            _, pcm2 = dec_blk.apply(dec_blk.init_state(), again)
            np.testing.assert_array_equal(np.asarray(pcm2), np.asarray(pcm))


@pytest.mark.parametrize("variant", ["g721", "g723_24", "g723_40"])
class TestG72x:
    def test_encode_bit_exact(self, variant):
        x = jnp.asarray(GOLD["input"])
        _, codes = vocoder.g72x_encode(variant, vocoder.g72x_init_state(), x)
        np.testing.assert_array_equal(np.asarray(codes),
                                      GOLD[f"{variant}_codes"])

    def test_decode_bit_exact(self, variant):
        codes = jnp.asarray(GOLD[f"{variant}_codes"])
        _, pcm = vocoder.g72x_decode(variant, vocoder.g72x_init_state(), codes)
        np.testing.assert_array_equal(np.asarray(pcm), GOLD[f"{variant}_dec"])

    def test_vmap_channels(self, variant):
        # Batched channels == independent runs (the bank deployment shape).
        x = jnp.stack([jnp.asarray(GOLD["input"][:1000]),
                       jnp.asarray(GOLD["input"][1000:2000])])
        states = jax.tree.map(
            lambda a: jnp.broadcast_to(a, (2,) + a.shape),
            vocoder.g72x_init_state())
        _, codes = jax.vmap(lambda s, xi: vocoder.g72x_encode(variant, s, xi)
                            )(states, x)
        _, ref0 = vocoder.g72x_encode(variant, vocoder.g72x_init_state(), x[0])
        np.testing.assert_array_equal(np.asarray(codes[0]), np.asarray(ref0))


def _cvsd_encode_scalar(pcm, p):
    """Independent scalar model of the reference encoder work() loop."""
    import math
    accum, step, runner, lc = 0, p.min_step, 0, 1
    bits = []
    for x in pcm:
        bit = 1 if int(x) >= accum else 0
        accum += step if bit else -step
        accum = math.floor(accum * p.accum_decay + 0.5)
        accum = max(min(accum, p.pos_accum_max), p.neg_accum_max)
        if lc >= p.J:
            m = int(p.j_mask)
            if (runner & m) == m or (runner & m) == 0:
                step = min(step + p.min_step, p.max_step)
            else:
                step = max(math.floor(step * p.step_decay + 0.5), p.min_step)
        runner = (runner << 1) | bit
        if lc <= p.K:
            lc += 1
        bits.append(bit)
    return np.array(bits, np.uint8)


def _cvsd_decode_scalar(data, p):
    """Independent scalar model of the reference decoder work() loop
    (including its shift-the-mask-value-into-the-runner quirk)."""
    import math
    accum, step, runner, lc = 0, p.min_step, 0, 1
    out = []
    for byte in data:
        for k in range(8):
            bv = int(byte) & (1 << (7 - k))
            runner = (runner << 1) | bv
            if lc >= p.J:
                m = int(p.j_mask)
                if (runner & m) == m or (runner & m) == 0:
                    step = min(step + p.min_step, p.max_step)
                else:
                    step = max(math.floor(step * p.step_decay + 0.5),
                               p.min_step)
            accum += step if bv else -step
            accum = math.floor(accum * p.accum_decay + 0.5)
            accum = max(min(accum, p.pos_accum_max), p.neg_accum_max)
            if lc <= p.K:
                lc += 1
            out.append(np.int16(accum))
    return np.array(out, np.int16)


class TestCvsd:
    def test_encode_matches_scalar_model(self):
        pcm = GOLD["input"][:2048].astype(np.int16)
        enc = vocoder.CvsdEncode()
        state, packed = enc.apply(enc.init_state(), jnp.asarray(pcm))
        want_bits = _cvsd_encode_scalar(pcm, enc.params)
        got_bits = np.unpackbits(np.asarray(packed))
        np.testing.assert_array_equal(got_bits, want_bits)

    def test_decode_matches_scalar_model(self):
        pcm = GOLD["input"][:2048].astype(np.int16)
        enc = vocoder.CvsdEncode()
        _, packed = enc.apply(enc.init_state(), jnp.asarray(pcm))
        dec = vocoder.CvsdDecode()
        _, got = dec.apply(dec.init_state(), packed)
        want = _cvsd_decode_scalar(np.asarray(packed), dec.params)
        np.testing.assert_array_equal(np.asarray(got), want)

    def test_roundtrip_tracks_waveform(self):
        # CVSD at 1 bit/sample tracks a slow ramp closely.
        t = np.arange(4096)
        pcm = (8000 * np.sin(2 * np.pi * t / 512)).astype(np.int16)
        enc, dec = vocoder.CvsdEncode(), vocoder.CvsdDecode()
        _, packed = enc.apply(enc.init_state(), jnp.asarray(pcm))
        _, back = dec.apply(dec.init_state(), packed)
        back = np.asarray(back, np.float64)
        # discard slope-acquisition transient
        corr = np.corrcoef(back[512:], pcm[512:].astype(np.float64))[0, 1]
        assert corr > 0.95

    def test_chunked_equals_whole(self):
        pcm = GOLD["input"][:4096].astype(np.int16)
        enc = vocoder.CvsdEncode()
        _, whole = enc.apply(enc.init_state(), jnp.asarray(pcm))
        st = enc.init_state()
        parts = []
        for chunk in np.split(pcm, 4):
            st, p = enc.apply(st, jnp.asarray(chunk))
            parts.append(np.asarray(p))
        np.testing.assert_array_equal(np.concatenate(parts),
                                      np.asarray(whole))
