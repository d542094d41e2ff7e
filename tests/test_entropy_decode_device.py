"""Device-side entropy decoder vs the host decoder: bit-exact."""

import numpy as np
import pytest
import jax.numpy as jnp

from amv_tpu.containers import riff
from amv_tpu.bitstream.entropy import huffman_decode_frames
from amv_tpu.verify.ref_jpeg import unescape_scan
from amv_tpu.kernels.entropy_decode import decode_scans_device


def _pack(scans):
    maxb = (max(len(x) for x in scans) + 3) & ~3
    arr = np.zeros((len(scans), maxb), np.uint8)
    for i, x in enumerate(scans):
        arr[i, :len(x)] = np.frombuffer(x, np.uint8)
    return arr


def test_device_entropy_decode_corpus(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    payloads = s.video_chunks[:10]
    want = huffman_decode_frames(payloads, 48)
    arr = _pack([unescape_scan(p[2:-2]) for p in payloads])
    got, ok = decode_scans_device(jnp.asarray(arr), 48)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.asarray(ok).all()


def test_device_entropy_decode_own_encoder():
    """Round trip through the device entropy ENCODER output."""
    from amv_tpu.bitstream.entropy import huffman_encode_frame
    rng = np.random.default_rng(41)
    n_mcu = 48
    lv = np.zeros((2, n_mcu, 6, 64), np.int16)
    lv[..., 0] = rng.integers(0, 256, (2, n_mcu, 6))
    mask = rng.random((2, n_mcu, 6, 63)) < 0.15
    lv[..., 1:] = np.where(mask, rng.integers(-200, 200, (2, n_mcu, 6, 63)), 0)
    payloads = [huffman_encode_frame(lv[f]) for f in range(2)]
    want = huffman_decode_frames(payloads, n_mcu)
    arr = _pack([unescape_scan(p[2:-2]) for p in payloads])
    got, ok = decode_scans_device(jnp.asarray(arr), n_mcu)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.asarray(ok).all()


def test_decode_frames_device_entropy_path(sample_amv_bytes):
    """decode_frames (device Huffman decode + transform) equals the host
    C Huffman decode feeding the same transform."""
    from amv_tpu.codecs import amv_video
    s = riff.demux(sample_amv_bytes)
    w, h = s.info.width, s.info.height
    a = amv_video.decode_transform(
        jnp.asarray(huffman_decode_frames(s.video_chunks[:4], 48)), 8, 6, w, h)
    b = amv_video.decode_frames(s.video_chunks[:4], w, h)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y)


@pytest.mark.parametrize("damage", ["invalid_code", "run_past_63",
                                    "zrl_past_63"])
def test_device_decoder_flags_malformed(sample_amv_bytes, damage):
    """Streams the C decoder rejects come back with ok False (the chain
    then hands that frame to the host), and the other frames of the
    batch still decode exactly."""
    from amv_tpu.native import entropy_native as native
    s = riff.demux(sample_amv_bytes)
    good = s.video_chunks[1:3]
    if damage == "invalid_code":
        p = bytearray(s.video_chunks[0])
        p[10:18] = b"\xFF\x00" * 4          # 32 one-bits: no such code
        bad = bytes(p)
    else:
        # DC 0, then AC symbols whose runs carry the scan position past
        # 63: four (run 15, size 1) levels, or four ZRLs and a level
        from amv_tpu.verify import ref_jpeg as R
        bw = R.BitWriter()
        R._encode_dc(bw, 0, R._ENC_DC_L)
        sizes, codes = R._ENC_AC_L
        syms = [0xF1] * 4 if damage == "run_past_63" else [0xF0] * 4 + [0x01]
        for sym in syms:
            bw.put_bits(int(sizes[sym]), int(codes[sym]))
            if sym & 0xF:
                bw.put_bits(1, 1)
        pad = -bw.bit_count() % 8
        bw.put_bits(pad + 8, (1 << (pad + 8)) - 1)
        bad = b"\xFF\xD8" + R.escape_ff(bw.flush()) + b"\xFF\xD9"
    with pytest.raises(ValueError):
        native.decode_frames([bad], 48)
    rows, _ = native.unescape_frames([bad] + good)
    got, ok = decode_scans_device(jnp.asarray(rows), 48)
    np.testing.assert_array_equal(np.asarray(ok), [False, True, True])
    np.testing.assert_array_equal(np.asarray(got)[1:],
                                  huffman_decode_frames(good, 48))
