"""Seeded mutation fuzz over every host parser/bit-serial boundary.

The reference's decoders return -1 on malformed input (mjpegdec.c:699-703,
avidec.c resync loop); our contract is the same strengthened to "raise a
clean Python exception or return — never segfault (the C extension),
never hang, never read out of bounds".  Each case runs a few hundred
seeded byte-flip / truncation / length-field mutations of a valid file
through the parser.  Host-only: no device code, so mutations can change
geometry freely without triggering per-shape XLA compiles.
"""

import struct

import numpy as np
import pytest

from amv_tpu.containers import riff, avi, act
from amv_tpu.bitstream.jpeg_tables import canned_jpeg_header
from amv_tpu.bitstream.jpeg_parse import parse_jpeg
from amv_tpu.bitstream.entropy import huffman_decode_frames
from amv_tpu.native import entropy_native as native


def _mutations(data: bytes, rng, n, max_flips=8):
    """Yield n seeded mutants: byte flips, truncations, and 32-bit
    length-field scribbles (the classic parser-killer)."""
    for _ in range(n):
        b = bytearray(data)
        kind = rng.integers(0, 3)
        if kind == 0:                       # random byte flips
            for _ in range(int(rng.integers(1, max_flips + 1))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 1:                     # truncate anywhere
            b = b[:int(rng.integers(0, len(b)))]
        else:                               # scribble a le32 "length"
            if len(b) >= 4:
                pos = int(rng.integers(0, len(b) - 3))
                val = int(rng.integers(0, 2)) * 0xFFFFFFF0 + int(
                    rng.integers(0, 16))
                b[pos:pos + 4] = struct.pack("<I", val & 0xFFFFFFFF)
        yield bytes(b)


def test_fuzz_riff_demux(sample_amv_bytes):
    rng = np.random.default_rng(0xA151)
    survived = 0
    for mut in _mutations(sample_amv_bytes, rng, 300):
        try:
            s = riff.demux(mut)
            # whatever parsed must be internally consistent
            assert all(isinstance(c, bytes) for c in s.video_chunks[:4])
            survived += 1
        except Exception:
            pass
    assert survived > 0  # flips outside the header must still parse


def test_fuzz_avi_demux(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    w, h = s.info.width, s.info.height
    rng = np.random.default_rng(0xAA11)
    y = rng.integers(0, 256, (4, h, w), np.uint8).astype(np.uint8)
    cb = rng.integers(0, 256, (4, h // 2, w // 2), np.uint8).astype(np.uint8)
    cr = rng.integers(0, 256, (4, h // 2, w // 2), np.uint8).astype(np.uint8)
    pcm = rng.integers(-2000, 2000, 4000).astype(np.int16)
    data = avi.mux(y, cb, cr, pcm, fps=12, sample_rate=16000)
    for mut in _mutations(data, rng, 250):
        try:
            st = avi.demux(mut)
            avi.extract_yuv420(st)
            avi.extract_pcm(st)
        except Exception:
            pass


def test_fuzz_act_demux():
    rng = np.random.default_rng(0xAC7)
    frames = [bytes(rng.integers(0, 256, 10, np.uint8)) for _ in range(60)]
    data = act.mux(frames, sample_rate=8000)
    for mut in _mutations(data, rng, 250):
        try:
            frames_got, sr, dur = act.demux(mut)
            assert all(len(f) == 10 for f in frames_got[:4])
        except Exception:
            pass


def test_fuzz_jpeg_parse(sample_amv_bytes):
    """Full-header baseline JPEG (canned AMV rewrap) through the generic
    marker parser: every DQT/DHT/SOF/SOS/DRI length field gets abused."""
    s = riff.demux(sample_amv_bytes)
    w, h = s.info.width, s.info.height
    chunk = s.video_chunks[0]
    jpg = canned_jpeg_header(w, h) + chunk[2:]
    rng = np.random.default_rng(0x1960)
    survived = 0
    for mut in _mutations(jpg, rng, 300):
        try:
            fr = parse_jpeg(mut, allow_lossless=True)
            assert fr.width < 1 << 16 and fr.height < 1 << 16
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_c_huffman_decoder(sample_amv_bytes):
    """The C fast path (native/entropy.c): unescape + Huffman scan decode
    on mutated AMV payloads.  The memory-safety gate for the extension —
    a bounds bug here is a segfault, which pytest cannot catch, so the
    whole suite failing IS the signal."""
    s = riff.demux(sample_amv_bytes)
    M = ((s.info.width + 15) // 16) * ((s.info.height + 15) // 16)
    rng = np.random.default_rng(0xC0DE)
    survived = 0
    for mut in _mutations(s.video_chunks[0], rng, 400, max_flips=4):
        try:
            lv = huffman_decode_frames([mut], M)
            assert lv.shape == (1, M, 6, 64)
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_progressive_decode():
    """Progressive (SOF2) marker walk + the C per-scan coefficient pass
    (native/entropy.c:amv_progressive_scan) on mutated encodings."""
    from amv_tpu.bitstream.jpeg_progressive import (decode_progressive,
                                                    encode_progressive)
    rng = np.random.default_rng(0x50F2)
    lv = np.zeros((4, 1, 64), np.int16)
    lv[:, :, 0] = rng.integers(-40, 41, (4, 1))
    lv[:, :, 1:] = np.where(rng.random((4, 1, 63)) < 0.2,
                            rng.integers(-80, 81, (4, 1, 63)), 0)
    data = encode_progressive(lv, (16, 16), layout="gray")
    from amv_tpu.bitstream.jpeg_progressive import _Scans
    survived = 0
    for mut in _mutations(data, rng, 200):
        try:
            f = _Scans(mut).frame  # parse_jpeg rejects SOF2 outright
            if f.width * f.height > 1 << 22:
                continue  # scribbled SOF dims: don't size a giant grid
            decode_progressive(mut)
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_lossless_decode():
    """Lossless (SOF3) predictors on mutated encodings.  The row loop is
    pure Python, so mutants with scribbled SOF dims are skipped."""
    from amv_tpu.bitstream.jpeg_lossless import (decode_lossless,
                                                 encode_lossless)
    rng = np.random.default_rng(0x50F3)
    y = rng.integers(0, 256, (16, 16), np.uint8).astype(np.uint8)
    c = rng.integers(0, 256, (8, 8), np.uint8).astype(np.uint8)
    data = encode_lossless([y, c, c], predictor=4, restart_interval=2)
    survived = 0
    for mut in _mutations(data, rng, 200):
        try:
            fr = parse_jpeg(mut, allow_lossless=True)
            if fr.width * fr.height > 1 << 14:
                continue
            decode_lossless(mut)
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_c_custom_table_decoder(sample_amv_bytes):
    """parse_jpeg -> native.decode_scans_custom (the generic-table C
    scan decoder, native/entropy.c) with mutated tables and scan data —
    the restart-interval seed keeps frames off the stock-K.3 fast path
    that test_fuzz_c_huffman_decoder already covers."""
    from amv_tpu.codecs.mjpeg import encode_mjpeg_frames
    rng = np.random.default_rng(0xCC57)
    y = rng.integers(0, 256, (1, 32, 32), np.uint8).astype(np.uint8)
    cb = rng.integers(0, 256, (1, 16, 16), np.uint8).astype(np.uint8)
    cr = rng.integers(0, 256, (1, 16, 16), np.uint8).astype(np.uint8)
    data = encode_mjpeg_frames(y, cb, cr, restart_interval=2)[0]
    survived = 0
    for mut in _mutations(data, rng, 300):
        try:
            f = parse_jpeg(mut)
            mcu_w = 16 if any(h > 1 or v > 1
                              for (_, h, v, _) in f.components) else 8
            n_mcu = (((f.width + mcu_w - 1) // mcu_w) *
                     ((f.height + mcu_w - 1) // mcu_w))
            if not 0 < n_mcu <= 4096:
                continue
            pairs = [(dc_id, ac_id)
                     for (_, dc_id, ac_id, _) in f.mcu_blocks()]
            got = native.decode_scans_custom(
                [f.scan], n_mcu, f.huff, pairs,
                restart_interval=f.restart_interval)
            assert got.shape[0] == 1
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_wav_reader(tmp_path):
    """Minimal WAV reader on mutated chunk/length structure."""
    from amv_tpu.containers import wav
    rng = np.random.default_rng(0x3A5E)
    pcm = rng.integers(-3000, 3000, 500).astype(np.int16)
    p = tmp_path / "seed.wav"
    wav.write_pcm(str(p), pcm, 16000)
    data = p.read_bytes()
    mp = tmp_path / "mut.wav"
    survived = 0
    for mut in _mutations(data, rng, 250):
        mp.write_bytes(mut)
        try:
            got, rate = wav.read_pcm(str(mp))
            assert got.dtype == np.int16
            survived += 1
        except Exception:
            pass
    assert survived > 0


def test_fuzz_c_escape_roundtrip():
    """escape_frames/unescape_frames on adversarial word patterns: all-FF
    words (maximum escape expansion), zero bit counts, ragged lengths."""
    rng = np.random.default_rng(0xE5C)
    for _ in range(50):
        F = int(rng.integers(1, 5))
        W = int(rng.integers(1, 64))
        words = rng.integers(0, 1 << 32, (F, W),
                             np.uint64).astype(np.uint32).view(np.int32)
        if rng.integers(0, 2):
            words[:, : W // 2] = -1  # all-FF scan words
        bits = rng.integers(0, 32 * W + 1, F).astype(np.int32)
        payloads = native.escape_frames(words, bits)
        rows, lens = native.unescape_frames(payloads)
        assert len(payloads) == F and np.asarray(rows).shape[0] == F


def test_fuzz_wav_adpcm_formats(tmp_path):
    """WAV reader over mutated IMA-WAV / MS-ADPCM files: the block-layout
    parsers (header split, block_align walk, nibble reorder) must reject
    or decode, never crash/hang.  Mutation count is modest because
    block_align flips change decode shapes (each costs an XLA compile on
    the CPU mesh)."""
    import struct
    from amv_tpu.containers import wav
    rng = np.random.default_rng(0xADCC)

    def wav_bytes(fmt, block_align, payload):
        hdr = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, 1, 8000,
                                    8000, block_align, 4)
        hdr += b"data" + struct.pack("<I", len(payload)) + payload
        return b"RIFF" + struct.pack("<I", 4 + len(hdr)) + b"WAVE" + hdr

    seeds = []
    ima = b"".join(
        struct.pack("<hBB", int(rng.integers(-32768, 32768)),
                    int(rng.integers(0, 89)), 0) +
        bytes(rng.integers(0, 256, 16, dtype=np.uint8))
        for _ in range(3))
    seeds.append(wav_bytes(0x11, 20, ima))
    ms = b"".join(
        bytes([int(rng.integers(0, 7))]) +
        struct.pack("<hhh", 16, 0, 0) +
        bytes(rng.integers(0, 256, 13, dtype=np.uint8))
        for _ in range(3))
    seeds.append(wav_bytes(0x02, 20, ms))

    mp = tmp_path / "mut.wav"
    survived = 0
    for seed in seeds:
        for mut in _mutations(seed, rng, 40):
            mp.write_bytes(mut)
            try:
                got, rate = wav.read_pcm(str(mp))
                assert got.dtype == np.int16
                survived += 1
            except Exception:
                pass
    assert survived > 0
