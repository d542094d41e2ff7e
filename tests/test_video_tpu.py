"""Device video kernels vs the scalar oracle: bit-exact."""

import numpy as np
import pytest

from amv_tpu.bitstream import jpeg_tables as T
from amv_tpu.codecs import amv_video
from amv_tpu.containers import riff
from amv_tpu.kernels import fdct as KF
from amv_tpu.kernels import idct as KI
from amv_tpu.verify import ref_jpeg


def random_blocks(rng, n, spread=300):
    """int16 blocks resembling dequantized DCT coefficients."""
    b = (rng.standard_normal((n, 8, 8)) * spread).astype(np.int64)
    # sparsify like real data
    mask = rng.random((n, 8, 8)) < 0.7
    b[mask & (np.arange(64).reshape(8, 8) > 0)] = 0
    b[:, 0, 0] = rng.integers(-20000, 20000, n)
    return np.clip(b, -32768, 32767).astype(np.int16)


def test_idct_bit_exact_random():
    rng = np.random.default_rng(7)
    blocks = random_blocks(rng, 256)
    got = np.asarray(KI.idct_put(blocks))
    for i in range(blocks.shape[0]):
        want = ref_jpeg.idct_put(blocks[i])
        np.testing.assert_array_equal(got[i], want, err_msg=f"block {i}")


def test_idct_dc_only_rows():
    # the DC-only row shortcut differs from the general path: cover it
    blocks = np.zeros((4, 8, 8), dtype=np.int16)
    blocks[0, 0, 0] = 2048    # DC-only block
    blocks[1, 0, 0] = -1234
    blocks[2, 3, 0] = 2048    # one row DC-only, others zero
    blocks[3, 0, 0] = 2048
    blocks[3, 0, 7] = 1       # not DC-only
    got = np.asarray(KI.idct_put(blocks))
    for i in range(4):
        np.testing.assert_array_equal(got[i], ref_jpeg.idct_put(blocks[i]))


def test_idct_extreme_values():
    rng = np.random.default_rng(9)
    blocks = rng.integers(-32768, 32768, (64, 8, 8)).astype(np.int16)
    got = np.asarray(KI.idct_put(blocks))
    for i in range(blocks.shape[0]):
        np.testing.assert_array_equal(got[i], ref_jpeg.idct_put(blocks[i]))


def test_fdct_bit_exact():
    rng = np.random.default_rng(11)
    px = rng.integers(0, 256, (128, 8, 8)).astype(np.uint8)
    got = np.asarray(KF.fdct(px)).astype(np.int16)
    for i in range(px.shape[0]):
        want = ref_jpeg.fdct_islow(px[i].astype(np.int16))
        np.testing.assert_array_equal(got[i], want, err_msg=f"block {i}")


def test_fdct_quantize_bit_exact():
    rng = np.random.default_rng(13)
    px = rng.integers(0, 256, (64, 8, 8)).astype(np.uint8)
    qmat = ref_jpeg.encoder_qmat(2)
    got = np.asarray(KF.fdct_quantize(px, qmat))
    for i in range(px.shape[0]):
        want, _ = ref_jpeg.dct_quantize(px[i], qmat)
        np.testing.assert_array_equal(
            got[i].reshape(8, 8), want, err_msg=f"block {i}")


def test_decode_frames_matches_oracle(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    w, h = s.info.width, s.info.height
    n = 4
    y, cb, cr = amv_video.decode_frames(s.video_chunks[:n], w, h)
    for f in range(n):
        wy, wcb, wcr = ref_jpeg.decode_frame(s.video_chunks[f], w, h)
        np.testing.assert_array_equal(y[f], wy, err_msg=f"frame {f} Y")
        np.testing.assert_array_equal(cb[f], wcb, err_msg=f"frame {f} Cb")
        np.testing.assert_array_equal(cr[f], wcr, err_msg=f"frame {f} Cr")


def test_encode_frames_matches_oracle():
    rng = np.random.default_rng(17)
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    frames_y = np.stack([
        (128 + 60 * np.sin(xx / (5.0 + f)) * np.cos(yy / 7.0)).astype(np.uint8)
        for f in range(3)])
    frames_cb = np.stack([
        (128 + 40 * np.sin(xx[::2, ::2] / 11.0 + f)).astype(np.uint8)
        for f in range(3)])
    frames_cr = np.stack([
        (128 + 40 * np.cos(yy[::2, ::2] / 13.0 - f)).astype(np.uint8)
        for f in range(3)])
    got = amv_video.encode_frames(frames_y, frames_cb, frames_cr)
    for f in range(3):
        want = ref_jpeg.encode_frame(frames_y[f], frames_cb[f], frames_cr[f])
        assert got[f] == want, f"frame {f} payload mismatch"


def test_encode_nonaligned_size():
    # 160x120: the canonical CLI size; mb_h*16=128 > 120 exercises the
    # bottom-edge replication path
    rng = np.random.default_rng(19)
    h, w = 120, 160
    y = rng.integers(0, 256, (1, h, w)).astype(np.uint8)
    cb = rng.integers(0, 256, (1, h // 2, w // 2)).astype(np.uint8)
    cr = rng.integers(0, 256, (1, h // 2, w // 2)).astype(np.uint8)
    got = amv_video.encode_frames(y, cb, cr)
    want = ref_jpeg.encode_frame(y[0], cb[0], cr[0])
    assert got[0] == want
    # and the decode side handles the overhang as well
    gy, gcb, gcr = amv_video.decode_frames(got, w, h)
    wy, wcb, wcr = ref_jpeg.decode_frame(want, w, h)
    np.testing.assert_array_equal(gy[0], wy)
    np.testing.assert_array_equal(gcb[0], wcb)
    np.testing.assert_array_equal(gcr[0], wcr)
