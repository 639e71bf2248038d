"""grtpu.vocoder — voice codec blocks.

Re-design of gr-vocoder (reference: gr-vocoder):
waveform codecs whose per-sample feedback is expressed as ``lax.scan``
recurrences (vmappable over independent voice channels — the accelerator
win is batching hundreds of 8 kHz channels, not accelerating one), and
memoryless companders as branchless elementwise ops.

Block-name mapping (reference block -> grtpu):
  vocoder_alaw_encode_sb / _decode_bs   -> AlawEncode / AlawDecode
  vocoder_ulaw_encode_sb / _decode_bs   -> UlawEncode / UlawDecode
  vocoder_g721_encode_sb / _decode_bs   -> G721Encode / G721Decode
  vocoder_g723_24_* / g723_40_*         -> G723_24*/G723_40* (same pattern)
  vocoder_cvsd_encode_sb / _decode_bs   -> CvsdEncode / CvsdDecode
  vocoder_gsm_fr_encode_sp / _decode_ps -> GsmFrEncode / GsmFrDecode
  vocoder_codec2_encode_sp / _decode_ps -> Codec2Encode / Codec2Decode

All codecs are validated bit-exactly against golden vectors produced by the
reference's own C implementations (tests/data/vocoder_golden.npz).
"""

from grtpu.vocoder.g711 import (
    AlawDecode,
    AlawEncode,
    UlawDecode,
    UlawEncode,
    alaw_to_linear,
    alaw_to_ulaw,
    linear_to_alaw,
    linear_to_ulaw,
    ulaw_to_alaw,
    ulaw_to_linear,
)
from grtpu.vocoder.g72x import (
    G721Decode,
    G721Encode,
    G723_24Decode,
    G723_24Encode,
    G723_40Decode,
    G723_40Encode,
    g72x_decode,
    g72x_encode,
    g72x_init_state,
)
from grtpu.vocoder.codec2 import Codec2, Codec2Decode, Codec2Encode
from grtpu.vocoder.cvsd import CvsdDecode, CvsdEncode
from grtpu.vocoder.gsm import (
    GsmFrDecode,
    GsmFrEncode,
    gsm_fr_decode,
    gsm_fr_encode,
    gsm_init_decode_state,
    gsm_init_encode_state,
)

__all__ = [
    "AlawEncode", "AlawDecode", "UlawEncode", "UlawDecode",
    "linear_to_alaw", "alaw_to_linear", "linear_to_ulaw", "ulaw_to_linear",
    "alaw_to_ulaw", "ulaw_to_alaw",
    "G721Encode", "G721Decode", "G723_24Encode", "G723_24Decode",
    "G723_40Encode", "G723_40Decode",
    "g72x_encode", "g72x_decode", "g72x_init_state",
    "CvsdEncode", "CvsdDecode",
    "Codec2", "Codec2Encode", "Codec2Decode",
    "GsmFrEncode", "GsmFrDecode", "gsm_fr_encode", "gsm_fr_decode",
    "gsm_init_encode_state", "gsm_init_decode_state",
]
