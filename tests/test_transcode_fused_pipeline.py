"""transcode_levels_fused (pipeline API) vs the two-stage path."""

import numpy as np
import pytest
import jax.numpy as jnp

from amv_tpu.bitstream.entropy import huffman_decode_frames
from amv_tpu.codecs.amv_video import decode_transform, encode_transform
from amv_tpu.containers import riff
from amv_tpu.pipeline.transcode import transcode_levels_fused


def test_fused_pipeline_matches_two_stage(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    F, M, mbw, mbh = 3, 48, 8, 6
    levels = huffman_decode_frames(s.video_chunks[:F], M)
    y, cb, cr = decode_transform(jnp.asarray(levels), mbw, mbh, 128, 96)
    lv_ref = np.asarray(encode_transform(y, cb, cr, mbw, mbh, 2))
    lv2, pix = transcode_levels_fused(jnp.asarray(levels), 2)
    np.testing.assert_array_equal(np.asarray(lv2), lv_ref)


def test_fused_pipeline_qscale4(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    F, M, mbw, mbh = 2, 48, 8, 6
    levels = huffman_decode_frames(s.video_chunks[:F], M)
    y, cb, cr = decode_transform(jnp.asarray(levels), mbw, mbh, 128, 96)
    lv_ref = np.asarray(encode_transform(y, cb, cr, mbw, mbh, 4))
    lv2, _ = transcode_levels_fused(jnp.asarray(levels), 4)
    np.testing.assert_array_equal(np.asarray(lv2), lv_ref)


@pytest.mark.parametrize("qscale", [1, 2, 5, 31])
def test_fused_matches_two_stage_random_levels(qscale):
    """The plain fused transform skips plane assembly; on MB-aligned
    frames it must equal decode_transform + encode_transform bit for bit,
    including levels that drive the IDCT to clamp and int16 wrap."""
    rng = np.random.default_rng(qscale)
    F, mbw, mbh = 3, 3, 2
    levels = np.zeros((F, mbw * mbh, 6, 64), np.int16)
    levels[..., 0] = rng.integers(-40, 40, (F, mbw * mbh, 6))
    mask = rng.random((F, mbw * mbh, 6, 63)) < 0.3
    levels[..., 1:] = np.where(mask, rng.integers(-300, 300, mask.shape), 0)
    y, cb, cr = decode_transform(jnp.asarray(levels), mbw, mbh,
                                 16 * mbw, 16 * mbh)
    want = np.asarray(encode_transform(y, cb, cr, mbw, mbh, qscale))
    got, pix = transcode_levels_fused(jnp.asarray(levels), qscale)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert pix.shape == (F, mbw * mbh, 6, 8, 8) and pix.dtype == jnp.uint8


@pytest.mark.parametrize("width,height,quant", [(32, 16, "ffmpeg"),
                                                (40, 24, "ffmpeg"),
                                                (32, 16, "q60")])
def test_requantize_routes(width, height, quant):
    """requantize takes the fused transform only for MB-aligned frames in
    ffmpeg quant mode, else the two-stage transform."""
    from amv_tpu.pipeline.transcode import requantize
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    rng = np.random.default_rng(width + height)
    levels = np.zeros((2, mbw * mbh, 6, 64), np.int16)
    levels[..., 0] = rng.integers(-20, 20, (2, mbw * mbh, 6))
    levels[..., 3] = rng.integers(-9, 9, (2, mbw * mbh, 6))
    y, cb, cr = decode_transform(jnp.asarray(levels), mbw, mbh, width, height)
    want = np.asarray(encode_transform(y, cb, cr, mbw, mbh, 2, quant=quant))
    got = np.asarray(requantize(jnp.asarray(levels), width, height, 2, quant))
    np.testing.assert_array_equal(got, want)
