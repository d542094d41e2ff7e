"""Scalar reference codec tests on the seeded library clip."""

import numpy as np
import pytest

from amv_tpu.containers import riff
from amv_tpu.verify import ref_adpcm, ref_jpeg


@pytest.fixture(scope="module")
def streams(sample_amv_bytes):
    return riff.demux(sample_amv_bytes)


def test_adpcm_decode_plausible(streams):
    pcm = np.concatenate([ref_adpcm.decode_chunk(c)
                          for c in streams.audio_chunks[:20]])
    assert pcm.dtype == np.int16
    assert len(pcm) > 20000
    # real speech/music: non-trivial dynamics, no constant output
    assert pcm.std() > 100
    # ADPCM output must not be stuck at the rails
    assert np.mean(np.abs(pcm.astype(np.int32)) > 32000) < 0.05


def test_adpcm_roundtrip_consistency():
    rng = np.random.default_rng(0)
    # band-limited-ish signal the quantizer can track
    t = np.arange(22050)
    sig = (3000 * np.sin(2 * np.pi * 440 * t / 22050)
           + 500 * rng.standard_normal(22050)).astype(np.int16)
    chunks = ref_adpcm.encode(sig, frame_size=1378, sample_rate=22050)
    dec = np.concatenate([ref_adpcm.decode_chunk(c) for c in chunks])
    n = min(len(sig), len(dec))
    err = dec[:n].astype(np.float64) - sig[:n].astype(np.float64)
    # IMA ADPCM at 4 bits/sample keeps error well under the signal scale
    assert np.sqrt((err ** 2).mean()) < 600


def test_adpcm_chunk_layout():
    sig = np.zeros(22050, dtype=np.int16)
    chunks = ref_adpcm.encode(sig, frame_size=1378, sample_rate=22050)
    for c in chunks:
        count = int.from_bytes(c[4:8], "little")
        assert count == 2 * (len(c) - 8)
    # chunk boundary lands exactly on the 1-second mark (adpcm.c:474-476)
    totals = np.cumsum([int.from_bytes(c[4:8], "little") for c in chunks])
    assert 22050 in totals


def test_video_decode_frame0(streams):
    info = streams.info
    y, cb, cr = ref_jpeg.decode_frame(
        streams.video_chunks[0], info.width, info.height)
    assert y.shape == (96, 128)
    assert cb.shape == (48, 64)
    # plausibility: natural image statistics, not noise
    assert 16 < y.mean() < 240
    assert y.std() > 5
    # horizontal smoothness: adjacent-pixel deltas far below random (~74)
    d = np.abs(np.diff(y.astype(np.int32), axis=1)).mean()
    assert d < 25, f"decoded frame looks like noise (mean |dx| = {d})"


def test_video_encode_decode_roundtrip():
    rng = np.random.default_rng(1)
    h, w = 96, 128
    # smooth synthetic frame
    yy, xx = np.mgrid[0:h, 0:w]
    y = (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(np.uint8)
    cb = (128 + 40 * np.sin(xx[::2, ::2] / 11.0)).astype(np.uint8)
    cr = (128 + 40 * np.cos(yy[::2, ::2] / 13.0)).astype(np.uint8)
    payload = ref_jpeg.encode_frame(y, cb, cr)
    assert payload[:2] == b"\xFF\xD8" and payload[-2:] == b"\xFF\xD9"
    # no unescaped markers inside
    scan = payload[2:-2]
    i = scan.find(b"\xFF")
    while i != -1 and i < len(scan) - 1:
        assert scan[i + 1] == 0, "unescaped 0xFF in scan"
        i = scan.find(b"\xFF", i + 2)
    y2, cb2, cr2 = ref_jpeg.decode_frame(payload, w, h)
    # encoder(Q~2 MPEG1 matrix) + decoder(Q60 tables) mismatch is inherent to
    # the reference; so compare structure, not exact pixels: the decoded
    # image must correlate strongly with the source.
    c = np.corrcoef(y.astype(np.float64).ravel(),
                    y2.astype(np.float64).ravel())[0, 1]
    assert c > 0.9, f"round-trip correlation too low: {c}"


def test_video_decode_all_frames_headerless(streams):
    # every video chunk must start FFD8 and decode without VLC errors
    info = streams.info
    for payload in streams.video_chunks[:3]:
        y, _, _ = ref_jpeg.decode_frame(payload, info.width, info.height)
        assert y.shape == (info.height, info.width)
