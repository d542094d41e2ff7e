"""End-to-end pipeline + CLI-level tests."""

import numpy as np
import pytest

from amv_tpu.containers import riff
from amv_tpu.pipeline import decode as P
from amv_tpu.pipeline import encode as E
from amv_tpu.verify.compare import compare_amv
from amv_tpu.kernels import color


def _synth_clip(F=5, h=120, w=160, rate=22050, fps=16):
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(128 + 80 * np.sin(xx / 7.0 + f) * np.cos(yy / 9.0)).astype(np.uint8)
                  for f in range(F)])
    cb = np.stack([(128 + 50 * np.sin(xx[::2, ::2] / 12.0 - f)).astype(np.uint8)
                   for f in range(F)])
    cr = np.stack([(128 + 50 * np.cos(yy[::2, ::2] / 10.0 + f)).astype(np.uint8)
                   for f in range(F)])
    t = np.arange(int(F / fps * rate) + rate // 2)
    pcm = (8000 * np.sin(2 * np.pi * 440 * t / rate)).astype(np.int16)
    return y, cb, cr, pcm


def test_encode_decode_roundtrip_full():
    y, cb, cr, pcm = _synth_clip()
    data = E.encode_to_bytes(y, cb, cr, pcm, fps=16, sample_rate=22050)
    dec = P.decode_bytes(data)
    assert dec.info.width == 160 and dec.info.height == 120
    assert dec.y.shape == y.shape
    # lossy video: strong correlation required
    c = np.corrcoef(dec.y.astype(float).ravel(), y.astype(float).ravel())[0, 1]
    assert c > 0.9
    # audio round trip: decoded PCM tracks the source closely
    n = min(len(dec.pcm), len(pcm))
    err = dec.pcm[:n].astype(float) - pcm[:n].astype(float)
    assert np.sqrt((err ** 2).mean()) < 1200


def test_mux_deterministic_and_self_comparable():
    y, cb, cr, pcm = _synth_clip(F=3)
    a = E.encode_to_bytes(y, cb, cr, pcm)
    b = E.encode_to_bytes(y, cb, cr, pcm)
    assert a == b
    assert compare_amv(a, b) == []


def test_compare_detects_mismatch():
    y, cb, cr, pcm = _synth_clip(F=3)
    a = E.encode_to_bytes(y, cb, cr, pcm)
    y2 = y.copy()
    y2[1] = y2[1] ^ 0x10
    b = E.encode_to_bytes(y2, cb, cr, pcm)
    assert compare_amv(a, b) != []


def test_reencode_device_file_structure(sample_amv_bytes):
    """Decode the seeded library clip and re-encode: output must be a
    valid, well-formed AMV with the same frame count."""
    dec = P.decode_bytes(sample_amv_bytes, max_frames=12)
    pcm = dec.pcm[:int(12 / dec.info.fps_num * dec.info.sample_rate)]
    out = E.encode_to_bytes(dec.y, dec.cb, dec.cr, pcm,
                            fps=dec.info.fps_num,
                            sample_rate=dec.info.sample_rate)
    s = riff.demux(out)
    assert len(s.video_chunks) == 12
    dec2 = P.decode_bytes(out)
    # generation loss exists (known encoder/decoder table mismatch in the
    # reference design), but the image must stay recognizable (0.78 on
    # the seeded clip, whose source was itself encoded with the mismatch)
    c = np.corrcoef(dec2.y.astype(float).ravel(),
                    dec.y.astype(float).ravel())[0, 1]
    assert c > 0.7


def test_color_roundtrip():
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (2, 32, 48)).astype(np.uint8)
    cb = rng.integers(64, 192, (2, 16, 24)).astype(np.uint8)
    cr = rng.integers(64, 192, (2, 16, 24)).astype(np.uint8)
    rgb = color.yuv420_to_rgb(y, cb, cr, mode="bt601")
    assert rgb.shape == (2, 32, 48, 3)
    y2, cb2, cr2 = color.rgb_to_yuv420_bt601(rgb)
    # luma round-trips within clamp error
    mask = (rgb.max(axis=-1) < 250) & (rgb.min(axis=-1) > 5)
    dy = np.abs(y2.astype(int) - y.astype(int))[mask]
    assert dy.mean() < 2.0
    rgb_amv = color.yuv420_to_rgb(y, cb, cr, mode="amvlib")
    assert rgb_amv.shape == rgb.shape


def test_seek_decode(sample_amv_bytes):
    """Chunk-boundary seek: decoding from frame k equals the tail of a
    full decode (frames are intra-only; audio chunk headers carry state)."""
    full = P.decode_bytes(sample_amv_bytes, max_frames=10)
    part = P.decode_bytes(sample_amv_bytes, start_frame=6, max_frames=4)
    np.testing.assert_array_equal(part.y, full.y[6:10])
    np.testing.assert_array_equal(part.cb, full.cb[6:10])


def test_encode_trellis_flag():
    y, cb, cr, pcm = _synth_clip(F=2)
    a = E.encode_to_bytes(y, cb, cr, pcm, trellis=False)
    b = E.encode_to_bytes(y, cb, cr, pcm, trellis=True)
    da = P.decode_bytes(a)
    db = P.decode_bytes(b)
    n = min(len(da.pcm), len(db.pcm), len(pcm))
    ea = ((da.pcm[:n].astype(float) - pcm[:n]) ** 2).mean()
    eb = ((db.pcm[:n].astype(float) - pcm[:n]) ** 2).mean()
    assert eb <= ea * 1.02  # trellis never meaningfully worse


def test_decode_many_batched(sample_amv_bytes):
    from amv_tpu.pipeline.batch import decode_many
    y, cb, cr, pcm = _synth_clip(F=3)
    own = E.encode_to_bytes(y, cb, cr, pcm)
    outs = decode_many([sample_amv_bytes, own, sample_amv_bytes])
    single0 = P.decode_bytes(sample_amv_bytes)
    single1 = P.decode_bytes(own)
    np.testing.assert_array_equal(outs[0].y, single0.y)
    np.testing.assert_array_equal(outs[2].y, single0.y)
    np.testing.assert_array_equal(outs[1].y, single1.y)
    np.testing.assert_array_equal(outs[1].pcm, single1.pcm)
