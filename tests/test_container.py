"""Container layer tests against the seeded library clip."""

import numpy as np
import pytest

from amv_tpu.containers import riff


def test_parse_header(sample_amv_bytes):
    info = riff.parse_header(sample_amv_bytes)
    # the clip conftest.sample_amv_bytes asks for: 48 frames at 12 fps
    assert info.width == 128
    assert info.height == 96
    assert info.fps_num == 12
    assert info.micro_sec_per_frame == 83333
    assert info.duration_sec == 4
    assert info.sample_rate == 16000
    assert info.channels == 1
    assert info.bits_per_sample == 16


def test_demux_chunks(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    # 4 s at 12 fps -> 48 frames, one audio chunk each
    assert len(s.video_chunks) == len(s.audio_chunks)
    assert len(s.video_chunks) == 48
    # strict V/A interleave
    kinds = [k for k, _ in s.order]
    assert kinds[0] == 0
    assert all(kinds[i] != kinds[i + 1] for i in range(len(kinds) - 1))
    # video chunks are SOI..EOI wrapped
    v0 = s.video_chunks[0]
    assert v0[:2] == b"\xFF\xD8"
    assert v0[-2:] == b"\xFF\xD9"
    # audio chunks carry the 8-byte ADPCM header; sample count sane
    a0 = s.audio_chunks[0]
    count = int.from_bytes(a0[4:8], "little")
    # device files may mark the final nibble as padding (odd count);
    # the reference encoder always writes the even count 2*(len-8)
    assert count in (2 * (len(a0) - 8), 2 * (len(a0) - 8) - 1)


def test_mux_roundtrip_structure(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    out = riff.mux(s.video_chunks, s.audio_chunks,
                   width=s.info.width, height=s.info.height,
                   fps=s.info.fps_num, sample_rate=s.info.sample_rate)
    s2 = riff.demux(out)
    assert s2.info.width == s.info.width
    assert s2.info.height == s.info.height
    assert s2.info.fps_num == s.info.fps_num
    assert s2.info.sample_rate == s.info.sample_rate
    assert s2.video_chunks == s.video_chunks
    assert s2.audio_chunks == s.audio_chunks
    assert [k for k, _ in s2.order] == [k for k, _ in s.order]
    # movi chunk stream is byte-identical to the device file from 0x13c on
    movi_end_src = sample_amv_bytes.find(b"AMV_END_")
    if movi_end_src == -1:  # device file may lack trailer; compare prefix
        movi_end_src = len(sample_amv_bytes)
    src_movi = sample_amv_bytes[0x13C:movi_end_src]
    dst_movi = out[0x13C:out.find(b"AMV_END_")]
    assert dst_movi == src_movi


def test_mux_header_offsets():
    out = riff.mux([b"\xFF\xD8\xFF\xD9"], [b"\x00" * 12],
                   width=160, height=120, fps=16)
    assert out[0x138:0x13C] == b"movi"
    assert out[0x13C:0x140] == b"00dc"
    assert out[0:4] == b"RIFF"
    assert out[8:12] == b"AMV "
