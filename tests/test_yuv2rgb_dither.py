"""Packed/dithered RGB output family vs the scalar C-transliteration
oracle (libswscale yuv2rgb.c:304-615, swscale.c:578-607 semantics)."""

import numpy as np
import pytest

from amv_tpu.kernels.yuv2rgb_dither import (
    yuv420_to_packed, yuv420_to_yuyv422, yuv420_to_uyvy422, _FORMATS)
from amv_tpu.verify.ref_yuv2rgb import ref_yuv420_to_packed

H, W = 16, 24


def _planes(seed=0, extreme=False):
    rng = np.random.default_rng(seed)
    if extreme:
        # saturated chroma + bright/dark luma exercises the arena
        # clamping conventions
        y = rng.choice([0, 1, 254, 255], size=(H, W)).astype(np.uint8)
        cb = rng.choice([0, 255], size=(H // 2, W // 2)).astype(np.uint8)
        cr = rng.choice([0, 255], size=(H // 2, W // 2)).astype(np.uint8)
    else:
        y = rng.integers(0, 256, (H, W), np.uint8)
        cb = rng.integers(0, 256, (H // 2, W // 2), np.uint8)
        cr = rng.integers(0, 256, (H // 2, W // 2), np.uint8)
    return y, cb, cr


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
@pytest.mark.parametrize("full_range", [True, False])
def test_packed_matches_oracle(fmt, full_range):
    y, cb, cr = _planes(seed=hash((fmt, full_range)) % 1000)
    got = np.asarray(yuv420_to_packed(y, cb, cr, fmt=fmt,
                                      full_range=full_range))
    want = ref_yuv420_to_packed(y, cb, cr, fmt, full_range=full_range)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["rgb565", "bgr565", "rgb555", "bgr555"])
@pytest.mark.parametrize("dither", [True, False])
def test_16bpp_dither_modes(fmt, dither):
    y, cb, cr = _planes(seed=7)
    got = np.asarray(yuv420_to_packed(y, cb, cr, fmt=fmt, dither=dither))
    want = ref_yuv420_to_packed(y, cb, cr, fmt, dither=dither)
    np.testing.assert_array_equal(got, want)
    if fmt == "rgb565":
        # sanity: field layout R5 G6 B5
        assert got.dtype == np.uint16
        gray = np.full((H, W), 255, np.uint8)
        flat = np.asarray(yuv420_to_packed(
            gray, np.full((H // 2, W // 2), 128, np.uint8),
            np.full((H // 2, W // 2), 128, np.uint8), fmt=fmt,
            dither=False))
        assert np.all(flat == 0xFFFF)


@pytest.mark.parametrize("fmt", sorted(_FORMATS))
def test_packed_extreme_chroma(fmt):
    """Saturated inputs hit the out-of-span table reads; kernel and
    oracle must agree on the documented clamping convention."""
    y, cb, cr = _planes(seed=3, extreme=True)
    got = np.asarray(yuv420_to_packed(y, cb, cr, fmt=fmt))
    want = ref_yuv420_to_packed(y, cb, cr, fmt)
    np.testing.assert_array_equal(got, want)


def test_batched_matches_single():
    y0, cb0, cr0 = _planes(seed=1)
    y1, cb1, cr1 = _planes(seed=2)
    y = np.stack([y0, y1])
    cb = np.stack([cb0, cb1])
    cr = np.stack([cr0, cr1])
    got = np.asarray(yuv420_to_packed(y, cb, cr, fmt="rgb8"))
    for i, (yy, ub, vr) in enumerate([(y0, cb0, cr0), (y1, cb1, cr1)]):
        np.testing.assert_array_equal(
            got[i], np.asarray(yuv420_to_packed(yy, ub, vr, fmt="rgb8")))


def test_monochrome_bit_order():
    # leftmost pixel must land in the MSB (yuv2rgb.c:589-593 the
    # accumulator shifts left as it fills)
    y = np.zeros((2, 8), np.uint8)
    y[0, 0] = 255  # only the first pixel bright
    cb = np.full((1, 4), 128, np.uint8)
    cr = np.full((1, 4), 128, np.uint8)
    out = np.asarray(yuv420_to_packed(y, cb, cr, fmt="monoblack"))
    assert out[0, 0] & 0x80  # MSB set
    want = ref_yuv420_to_packed(y, cb, cr, "monoblack")
    np.testing.assert_array_equal(out, want)


def test_rgb4_nibble_pack():
    y, cb, cr = _planes(seed=11)
    packed = np.asarray(yuv420_to_packed(y, cb, cr, fmt="rgb4"))
    by_byte = np.asarray(yuv420_to_packed(y, cb, cr, fmt="rgb4_byte"))
    np.testing.assert_array_equal(packed & 0xF, by_byte[:, 0::2])
    np.testing.assert_array_equal(packed >> 4, by_byte[:, 1::2])


def test_cli_pix_fmt_raw(tmp_path, sample_amv_path):
    """`-pix_fmt rgb565 out.raw` writes LE-packed dithered frames equal
    to the kernel applied to the decoded planes."""
    from amv_tpu import cli
    from amv_tpu.pipeline.decode import decode_file
    src = sample_amv_path
    out = str(tmp_path / "o.raw")
    assert cli.main(["-i", src, "--max-frames", "2",
                     "-pix_fmt", "rgb565", out]) == 0
    dec = decode_file(src, max_frames=2)
    want = np.asarray(yuv420_to_packed(dec.y, dec.cb, dec.cr,
                                       fmt="rgb565")).astype("<u2")
    got = np.frombuffer(open(out, "rb").read(), "<u2")
    np.testing.assert_array_equal(got, want.ravel())


def test_yuyv_uyvy_pack():
    y, cb, cr = _planes(seed=5)
    yuyv = np.asarray(yuv420_to_yuyv422(y, cb, cr))
    uyvy = np.asarray(yuv420_to_uyvy422(y, cb, cr))
    assert yuyv.shape == (H, 2 * W)
    np.testing.assert_array_equal(yuyv[:, 0::2], y)
    np.testing.assert_array_equal(yuyv[:, 1::4], np.repeat(cb, 2, axis=0))
    np.testing.assert_array_equal(yuyv[:, 3::4], np.repeat(cr, 2, axis=0))
    np.testing.assert_array_equal(uyvy[:, 1::2], y)
    np.testing.assert_array_equal(uyvy[:, 0::4], np.repeat(cb, 2, axis=0))
    np.testing.assert_array_equal(uyvy[:, 2::4], np.repeat(cr, 2, axis=0))
