"""amvlib API-shape parity (AMVDec.h:94-109, AmvLibTest.cpp:36-83).

Drives the AmvOpen/AmvReadNextFrame/... surface over the seeded library
clip exactly like the reference console test, and checks the decoded
buffers against the framework's batched paths.
"""

import numpy as np
import pytest

from amv_tpu import amvlib_api as A
from amv_tpu.containers import riff, wav


def test_open_close(sample_amv_path):
    amv = A.AmvOpen(sample_amv_path)
    assert amv is not None and amv.opened
    # totalframe = duration * fps (AMVDec.c:112-114): 4 s * 12 fps
    assert amv.totalframe == 48
    assert amv.amvinfo.width == 128 and amv.amvinfo.height == 96
    A.AmvClose(amv)
    assert not amv.opened
    assert A.AmvOpen("/nonexistent.amv") is None


def test_frame_walk_matches_demux(sample_amv_path, sample_amv_bytes):
    amv = A.AmvOpen(sample_amv_path)
    s = riff.demux(sample_amv_bytes)
    n = 0
    while True:
        assert A.AmvReadNextFrame(amv) == 0
        if amv.framebuf.framenum < 0:          # AMV_END_ semantics
            assert amv.framebuf.videobufflen == 0
            break
        assert amv.framebuf.videobuff == s.video_chunks[n]
        assert amv.framebuf.audiobuff == s.audio_chunks[n]
        n += 1
    assert n == len(s.video_chunks)
    # rewind restarts the walk (AmvRewindFrameStart, AMVDec.c:240-257)
    assert A.AmvRewindFrameStart(amv) == 0
    assert A.AmvReadNextFrame(amv) == 0
    assert amv.framebuf.framenum == 0
    A.AmvClose(amv)
    assert A.AmvReadNextFrame(amv) == -1


def test_video_decode_bottom_up_bgr(sample_amv_path):
    amv = A.AmvOpen(sample_amv_path)
    A.AmvReadNextFrame(amv)
    assert A.AmvVideoDecode(amv) == 0
    h, w = amv.amvinfo.height, amv.amvinfo.width
    assert amv.videobuf.shape == (h, w, 3)
    # cross-check against the batched amvlib-mode decoder directly
    from amv_tpu.codecs.amvlib_video import decode_frames_amvlib_rgb
    rgb = decode_frames_amvlib_rgb([amv.framebuf.videobuff], w, h)[0]
    np.testing.assert_array_equal(amv.videobuf, rgb[::-1, :, ::-1])


def test_audio_decode_matches_batched(sample_amv_path):
    amv = A.AmvOpen(sample_amv_path)
    A.AmvReadNextFrame(amv)
    assert A.AmvAudioDecode(amv) == 0
    from amv_tpu.codecs.amv_audio import decode_chunks
    np.testing.assert_array_equal(
        amv.audiobuf, decode_chunks([amv.framebuf.audiobuff]))


def test_jpeg_and_bmp_export(sample_amv_path, tmp_path):
    amv = A.AmvOpen(sample_amv_path)
    A.AmvReadNextFrame(amv)
    assert A.AmvCreateJpegFileFromFrameBuffer(amv, str(tmp_path)) == 0
    jpg = tmp_path / "0.jpg"
    data = jpg.read_bytes()
    assert data[:2] == b"\xFF\xD8" and data[-2:] == b"\xFF\xD9"
    bmp = tmp_path / "0.bmp"
    assert A.AmvConvertJpegFileToBmpFile(str(jpg), str(bmp)) == 0
    out = bmp.read_bytes()
    assert out[:2] == b"BM"
    w = int.from_bytes(out[18:22], "little")
    h = int.from_bytes(out[22:26], "little", signed=True)
    assert (w, h) == (amv.amvinfo.width, amv.amvinfo.height)


def test_wav_export_both_types(sample_amv_path, tmp_path):
    amv = A.AmvOpen(sample_amv_path)
    pcm_path = tmp_path / "out_pcm.wav"
    assert A.AmvCreateWavFileFromAmvFile(
        amv, A.AUDIO_FILE_TYPE_PCM, str(pcm_path)) == 0
    pcm, rate = wav.read_pcm(str(pcm_path))
    assert rate == amv.amvinfo.sample_rate
    from amv_tpu.codecs.amv_audio import decode_chunks
    np.testing.assert_array_equal(pcm,
                                  decode_chunks(amv.streams.audio_chunks))
    adpcm_path = tmp_path / "out_adpcm.wav"
    assert A.AmvCreateWavFileFromAmvFile(
        amv, A.AUDIO_FILE_TYPE_ADPCM_IMA, str(adpcm_path)) == 0
    raw = adpcm_path.read_bytes()
    assert raw[:4] == b"RIFF" and b"fact" in raw[:64]
    assert A.AmvCreateWavFileFromAmvFile(amv, 9, str(pcm_path)) == -1
