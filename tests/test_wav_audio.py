"""WAV/AVI audio ingest codecs (codecs/wav_audio.py).

Differential gates: batched device block decoders vs the scalar oracles in
verify/ref_wav_audio.py (which transliterate pcm.c:45-75,380-470 and
adpcm.c:983-1106 semantics), plus container wiring tests.
"""

import struct

import numpy as np
import pytest

from amv_tpu.codecs import wav_audio
from amv_tpu.verify import ref_wav_audio as ref
from amv_tpu.containers import wav as wavmod
from amv_tpu.containers import avi


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# G.711 / PCM variants
# ---------------------------------------------------------------------------

def test_g711_tables_match_scalar():
    # spot-check the tables against the scalar formulas at every code
    for i in range(256):
        assert ref.ALAW_TABLE[i] == ref.alaw2linear(i)
        assert ref.ULAW_TABLE[i] == ref.ulaw2linear(i)
    # all outputs fit int16 exactly (no silent wrap in the table dtype)
    assert int(np.abs(ref.ALAW_TABLE.astype(np.int32)).max()) <= 32767
    assert int(np.abs(ref.ULAW_TABLE.astype(np.int32)).max()) <= 32767


def test_pcm_u8_and_wide_depths():
    data = bytes(range(256))
    out = wav_audio.decode_pcm_bytes(data, 1, 8, 1)
    np.testing.assert_array_equal(
        out, (np.arange(256, dtype=np.int16) - 128) << 8)
    # s24/s32: top 16 bits kept (pcm.c decode_to16)
    vals = np.array([-2**23, -1, 0, 1, 2**23 - 1], dtype="<i4")
    b24 = b"".join(int(v).to_bytes(3, "little", signed=True) for v in vals)
    out24 = wav_audio.decode_pcm_bytes(b24, 1, 24, 1)
    np.testing.assert_array_equal(out24, (vals >> 8).astype(np.int16))
    b32 = (vals << 8).astype("<i4").tobytes()
    out32 = wav_audio.decode_pcm_bytes(b32, 1, 32, 1)
    np.testing.assert_array_equal(out32, (vals >> 8).astype(np.int16))


def test_g711_decode_dispatch():
    data = bytes(_rng(0).integers(0, 256, 500, dtype=np.uint8))
    a = wav_audio.decode_pcm_bytes(data, 6, 8, 1)
    u = wav_audio.decode_pcm_bytes(data, 7, 8, 1)
    np.testing.assert_array_equal(a, ref.ALAW_TABLE[np.frombuffer(
        data, np.uint8)])
    np.testing.assert_array_equal(u, ref.ULAW_TABLE[np.frombuffer(
        data, np.uint8)])
    # stereo shape
    s = wav_audio.decode_pcm_bytes(data, 6, 8, 2)
    assert s.shape == (250, 2)


# ---------------------------------------------------------------------------
# IMA-ADPCM-WAV
# ---------------------------------------------------------------------------

def _ima_block(rng, channels, n_groups):
    hdr = b""
    for _ in range(channels):
        hdr += struct.pack("<hBB", int(rng.integers(-32768, 32768)),
                           int(rng.integers(0, 100)), 0)  # incl. >88 clamp
    body = bytes(rng.integers(0, 256, 4 * channels * n_groups,
                              dtype=np.uint8))
    return hdr + body


@pytest.mark.parametrize("channels", [1, 2])
def test_ima_wav_matches_oracle(channels):
    rng = _rng(3 + channels)
    block_align = 4 * channels + 4 * channels * 5
    data = b"".join(_ima_block(rng, channels, 5) for _ in range(4))
    got = wav_audio.decode_ima_wav(data, channels, block_align)
    want = ref.decode_blocks(data, channels, block_align, "ima")
    if channels == 1:
        want = want[:, 0]
    np.testing.assert_array_equal(got, want)


def test_ima_wav_short_trailing_block():
    rng = _rng(9)
    block_align = 4 + 20
    full = _ima_block(rng, 1, 5)
    tail = _ima_block(rng, 1, 2)[:4 + 7]  # partial: 7 nibble bytes
    got = wav_audio.decode_ima_wav(full + tail, 1, block_align)
    want = ref.decode_blocks(full + tail, 1, block_align, "ima")[:, 0]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# MS-ADPCM
# ---------------------------------------------------------------------------

def _ms_block(rng, channels, n_data):
    hdr = bytes(int(rng.integers(0, 7)) for _ in range(channels))
    for _ in range(channels):  # idelta
        hdr += struct.pack("<h", int(rng.integers(-200, 4000)))
    for _ in range(2 * channels):  # sample1, sample2
        hdr += struct.pack("<h", int(rng.integers(-32768, 32768)))
    return hdr + bytes(rng.integers(0, 256, n_data, dtype=np.uint8))


@pytest.mark.parametrize("channels", [1, 2])
def test_ms_matches_oracle(channels):
    rng = _rng(17 + channels)
    n_data = 24
    block_align = 7 * channels + n_data
    data = b"".join(_ms_block(rng, channels, n_data) for _ in range(4))
    got = wav_audio.decode_ms(data, channels, block_align)
    want = ref.decode_blocks(data, channels, block_align, "ms")
    if channels == 1:
        want = want[:, 0]
    np.testing.assert_array_equal(got, want)


def test_ms_negative_idelta_and_extremes():
    """Extreme header state: negative idelta, full-scale samples."""
    hdr = bytes([6]) + struct.pack("<hhh", -32768, 32767, -32768)
    body = bytes([0x7F, 0x88, 0xF0, 0x08] * 6)
    data = hdr + body
    got = wav_audio.decode_ms(data, 1, len(data))
    want = ref.decode_blocks(data, 1, len(data), "ms")[:, 0]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Container wiring
# ---------------------------------------------------------------------------

def _wav_bytes(fmt, channels, rate, bits, block_align, payload):
    hdr = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                rate * max(block_align, 1), block_align,
                                bits)
    hdr += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", 4 + len(hdr)) + b"WAVE" + hdr


def test_read_pcm_ima_wav(tmp_path):
    rng = _rng(23)
    block_align = 4 + 16
    payload = b"".join(_ima_block(rng, 1, 4) for _ in range(3))
    p = tmp_path / "ima.wav"
    p.write_bytes(_wav_bytes(0x11, 1, 8000, 4, block_align, payload))
    pcm, rate = wavmod.read_pcm(str(p))
    assert rate == 8000
    want = ref.decode_blocks(payload, 1, block_align, "ima")[:, 0]
    np.testing.assert_array_equal(pcm, want)


def test_read_pcm_u8_and_alaw(tmp_path):
    data = bytes(_rng(29).integers(0, 256, 320, dtype=np.uint8))
    p8 = tmp_path / "u8.wav"
    p8.write_bytes(_wav_bytes(1, 1, 11025, 8, 1, data))
    pcm, _ = wavmod.read_pcm(str(p8))
    np.testing.assert_array_equal(
        pcm, (np.frombuffer(data, np.uint8).astype(np.int16) - 128) << 8)
    pa = tmp_path / "alaw.wav"
    pa.write_bytes(_wav_bytes(6, 1, 8000, 8, 1, data))
    pcm, _ = wavmod.read_pcm(str(pa))
    np.testing.assert_array_equal(
        pcm, ref.ALAW_TABLE[np.frombuffer(data, np.uint8)])


def test_avi_extract_pcm_ms_stereo_downmix():
    rng = _rng(31)
    n_data = 16
    block_align = 14 + n_data
    payload = b"".join(_ms_block(rng, 2, n_data) for _ in range(2))
    st = avi.AviStream("audio", codec=struct.pack("<H", 2), channels=2,
                       sample_rate=22050, bits=4, chunks=[payload],
                       block_align=block_align)
    got = avi.extract_pcm(st)
    want2 = ref.decode_blocks(payload, 2, block_align, "ms")
    want = want2.mean(axis=1).astype(np.int16)
    np.testing.assert_array_equal(got, want)
