"""WAV container, PSNR tool, misc coverage."""

import numpy as np
import pytest

from amv_tpu.containers import wav
from amv_tpu.verify.psnr import psnr, stddev_diff, bytes_identical


def test_wav_pcm_roundtrip(tmp_path):
    sig = (1000 * np.sin(np.arange(4000) / 9.0)).astype(np.int16)
    p = tmp_path / "t.wav"
    wav.write_pcm(str(p), sig, 22050)
    got, rate = wav.read_pcm(str(p))
    assert rate == 22050
    np.testing.assert_array_equal(got, sig)


def test_wav_adpcm_raw(tmp_path):
    import struct
    chunks = [struct.pack("<hHI", 0, 0, 20) + bytes(10)]
    p = tmp_path / "a.wav"
    wav.write_adpcm_raw(str(p), chunks, 16000)
    data = p.read_bytes()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert b"fact" in data
    fmt_off = data.find(b"fmt ")
    assert struct.unpack_from("<H", data, fmt_off + 8)[0] == 0x11  # IMA ADPCM


def test_psnr_tool():
    a = np.zeros((8, 8), np.uint8)
    b = a.copy()
    assert psnr(a, b) == float("inf")
    b[0, 0] = 16
    assert 25 < psnr(a, b) < 55
    assert stddev_diff(a, b) == 2.0
    same, off = bytes_identical(b"abc", b"abc")
    assert same
    same, off = bytes_identical(b"abc", b"abd")
    assert not same and off == 2


def test_fixture_generators():
    from amv_tpu.verify import fixtures
    y, cb, cr = fixtures.videogen(3)
    assert y.shape == (3, 120, 160) and cb.shape == (3, 60, 80)
    y2, _, _ = fixtures.rotozoom(2)
    assert y2.shape == (2, 120, 160)
    pcm = fixtures.audiogen(0.5)
    assert pcm.dtype == np.int16 and len(pcm) == 11025
    sp = fixtures.speechgen(1600)
    assert sp.dtype == np.int16 and len(sp) == 1600


def test_corrupt_video_payload_no_crash(sample_amv_bytes):
    """Corrupt scan data must fail cleanly (ValueError) or decode to
    garbage — never crash the native module (mjpegdec returns -1 on bad
    VLC; we raise)."""
    from amv_tpu.containers import riff
    from amv_tpu.codecs import amv_video
    s = riff.demux(sample_amv_bytes)
    p = bytearray(s.video_chunks[0])
    for off in (10, 100, 500):
        p[off] ^= 0xFF
    try:
        amv_video.decode_frames([bytes(p)], s.info.width, s.info.height)
    except ValueError:
        pass  # clean rejection


def test_truncated_amv_rejected():
    from amv_tpu.containers import riff
    with pytest.raises(ValueError):
        riff.demux(b"RIFF\x00\x00\x00\x00AMV " + b"\x00" * 16)
    with pytest.raises(ValueError):
        riff.demux(b"not an amv file at all")


def test_cli_acodec_copy(tmp_path, sample_amv_path):
    """`-acodec copy`: raw-ADPCM WAV stream copy (amvlib's second WAV
    export mode) — data chunk is the joined '01wb' payloads."""
    import struct
    from amv_tpu import cli
    from amv_tpu.containers import riff
    src = sample_amv_path
    out = str(tmp_path / "raw.wav")
    assert cli.main(["-i", src, "--max-frames", "5",
                     "-acodec", "copy", out]) == 0
    data = out and open(out, "rb").read()
    s = riff.read(src)
    want = b"".join(s.audio_chunks[:5])
    fmt_off = data.find(b"fmt ")
    assert struct.unpack_from("<H", data, fmt_off + 8)[0] == 0x11
    d = data.find(b"data")
    assert data[d + 8:] == want
    fact = data.find(b"fact")
    total = struct.unpack_from("<I", data, fact + 8)[0]
    assert total == sum(struct.unpack_from("<I", c, 4)[0]
                        for c in s.audio_chunks[:5])


def test_cli_psnr_flag(tmp_path, capsys):
    """`-psnr` prints the CODEC_FLAG_PSNR-style mean summary."""
    from amv_tpu import cli
    rng = np.random.default_rng(3)
    h, w, F = 32, 48, 2
    y = rng.integers(0, 256, (F, h, w), np.uint8).astype(np.uint8)
    cb = rng.integers(0, 256, (F, h // 2, w // 2), np.uint8).astype(np.uint8)
    cr = rng.integers(0, 256, (F, h // 2, w // 2), np.uint8).astype(np.uint8)
    raw = tmp_path / "in.yuv"
    buf = b""
    for i in range(F):
        buf += y[i].tobytes() + cb[i].tobytes() + cr[i].tobytes()
    raw.write_bytes(buf)
    out = str(tmp_path / "o.amv")
    assert cli.main(["-i", str(raw), "-f", "amv", "-s", f"{w}x{h}",
                     "-psnr", out]) == 0
    text = capsys.readouterr().out
    assert "PSNR Mean Y:" in text and "All:" in text


def test_cli_duration_flag(tmp_path, sample_amv_path):
    """`-t SECONDS` caps output like ffmpeg: 0.5 s of a 16 fps AMV = 8
    frames; `-y` is accepted for invocation parity."""
    from amv_tpu import cli
    from amv_tpu.containers import riff
    src = sample_amv_path
    info = riff.read(src).info
    out = str(tmp_path / "cut.wav")
    assert cli.main(["-y", "-i", src, "-t", "0.5",
                     "-acodec", "copy", out]) == 0
    data = open(out, "rb").read()
    s = riff.read(src)
    want_n = max(1, int(0.5 * info.fps_num))
    want = b"".join(s.audio_chunks[:want_n])
    d = data.find(b"data")
    assert data[d + 8:] == want


def test_cli_amv_rescale(tmp_path, sample_amv_path):
    """`-i in.amv -s WxH out.amv` leaves the fused requantize path and
    runs the full decode -> sws rescale -> re-encode pipeline (the
    reference inserts sws_scale whenever -s differs, ffmpeg.c:757)."""
    from amv_tpu import cli
    from amv_tpu.containers import riff
    src = sample_amv_path
    out = str(tmp_path / "small.amv")
    assert cli.main(["-i", src, "--max-frames", "2",
                     "-s", "80x64", out]) == 0
    s = riff.read(out)
    assert (s.info.width, s.info.height) == (80, 64)
    assert len(s.video_chunks) == 2


def test_cli_amv_psnr_no_size(tmp_path, capsys, sample_amv_path):
    """`-psnr` on AMV->AMV without -s re-encodes at source geometry
    (no fused path, no -s requirement) and prints the summary."""
    from amv_tpu import cli
    src = sample_amv_path
    out = str(tmp_path / "re.amv")
    assert cli.main(["-i", src, "--max-frames", "2", "-psnr", out]) == 0
    text = capsys.readouterr().out
    assert "PSNR Mean Y:" in text and "All:" in text
