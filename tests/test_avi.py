"""AVI container tests + the canonical AVI<->AMV conversion paths."""

import numpy as np
import pytest

from amv_tpu.containers import avi
from amv_tpu.pipeline import decode as P
from amv_tpu.pipeline import encode as E


def _clip(F=4, h=120, w=160):
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.stack([(128 + 60 * np.sin(xx / 8.0 + f)).astype(np.uint8)
                  for f in range(F)])
    cb = np.stack([(128 + 30 * np.cos(yy[::2, ::2] / 9.0)).astype(np.uint8)] * F)
    cr = np.stack([(128 + 30 * np.sin(xx[::2, ::2] / 7.0)).astype(np.uint8)] * F)
    pcm = (5000 * np.sin(np.arange(int(F / 16 * 22050)) * 0.1)).astype(np.int16)
    return y, cb, cr, pcm


def test_avi_mux_demux_roundtrip():
    y, cb, cr, pcm = _clip()
    data = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050)
    streams = avi.demux(data)
    kinds = [s.kind for s in streams]
    assert kinds == ["video", "audio"]
    vst, ast = streams
    assert (vst.width, vst.height) == (160, 120)
    assert vst.fps_num == 16
    assert ast.sample_rate == 22050
    y2, cb2, cr2 = avi.extract_yuv420(vst)
    np.testing.assert_array_equal(y2, y)
    np.testing.assert_array_equal(cb2, cb)
    np.testing.assert_array_equal(cr2, cr)
    pcm2 = avi.extract_pcm(ast)
    np.testing.assert_array_equal(pcm2, pcm)


def test_avi_to_amv_to_avi():
    """The reference's make-test round trip: avi -> amv -> avi."""
    y, cb, cr, pcm = _clip()
    avi_in = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050)
    streams = avi.demux(avi_in)
    vy, vcb, vcr = avi.extract_yuv420(streams[0])
    apcm = avi.extract_pcm(streams[1])
    amv = E.encode_to_bytes(vy, vcb, vcr, apcm, fps=16, sample_rate=22050)
    dec = P.decode_bytes(amv)
    avi_out = avi.mux(dec.y, dec.cb, dec.cr, dec.pcm, fps=16, sample_rate=22050)
    streams2 = avi.demux(avi_out)
    y3, _, _ = avi.extract_yuv420(streams2[0])
    c = np.corrcoef(y3.astype(float).ravel(), y.astype(float).ravel())[0, 1]
    assert c > 0.9


def test_avi_mjpeg_input(sample_amv_bytes):
    """MJPEG-in-AVI (the reference's typical hole.avi material) feeds the
    encoder via the parsed-table decoder."""
    import struct
    from amv_tpu.containers import riff
    from amv_tpu.bitstream.jpeg_tables import canned_jpeg_header
    s = riff.demux(sample_amv_bytes)
    w, h = s.info.width, s.info.height
    hdr = canned_jpeg_header(w, h)
    jpegs = [hdr + c[2:-2] + b"\xFF\xD9" for c in s.video_chunks[:3]]

    # hand-build a minimal MJPG AVI
    def chunk(tag, payload):
        pad = b"\x00" if len(payload) & 1 else b""
        return tag + struct.pack("<I", len(payload)) + payload + pad
    avih = struct.pack("<14I", 83333, 0, 0, 0x10, 3, 0, 1, 0, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG" + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0,
            1, 12, 0, 3, 0, 0xFFFFFFFF, 0) + struct.pack("<4h", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", 0, 0, 0, 0, 0)
    strl = b"LIST" + struct.pack("<I", 4 + len(chunk(b"strh", strh)) +
                                 len(chunk(b"strf", strf))) + b"strl" \
        + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl = b"LIST" + struct.pack("<I", 4 + len(chunk(b"avih", avih)) +
                                 len(strl)) + b"hdrl" + chunk(b"avih", avih) + strl
    movi = bytearray(b"movi")
    for j in jpegs:
        movi += chunk(b"00dc", j)
    body = b"AVI " + hdrl + b"LIST" + struct.pack("<I", len(movi)) + bytes(movi)
    data = b"RIFF" + struct.pack("<I", len(body)) + body

    streams = avi.demux(data)
    assert streams[0].codec.upper().startswith(b"MJPG")
    y, cb, cr = avi.extract_yuv420(streams[0])
    # must equal the unflipped AMV decode of the same frames
    from amv_tpu.codecs import amv_video
    ya, _, _ = amv_video.decode_frames(s.video_chunks[:3], w, h)
    np.testing.assert_array_equal(y, ya[:, ::-1])


def test_avi_idx1_written_and_used():
    """mux writes an idx1 index; demux reads chunks through it and the
    result equals the linear movi walk (avi_read_idx1 semantics)."""
    y, cb, cr, pcm = _clip()
    data = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050)
    assert b"idx1" in data
    st_idx = avi.demux(data, use_index=True)
    st_lin = avi.demux(data, use_index=False)
    assert all(s.index for s in st_idx)
    assert not any(s.index == [] for s in st_idx)
    for a, b in zip(st_idx, st_lin):
        assert a.chunks == b.chunks
    # every chunk flagged keyframe (all-intra raw video)
    assert all(k for (_, _, k) in st_idx[0].index)


def test_avi_seek_frame():
    y, cb, cr, pcm = _clip(F=6)
    data = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050)
    vst = avi.demux(data)[0]
    assert avi.seek_frame(vst, 3) == 3          # all keyframes
    assert avi.seek_frame(vst, 99) == 5         # clamped
    assert avi.seek_frame(vst, -2) == 0
    # non-key chunks back up to the previous keyframe
    vst.index = [(0, 1, True), (0, 1, False), (0, 1, False), (0, 1, True)]
    assert avi.seek_frame(vst, 2) == 0
    assert avi.seek_frame(vst, 3) == 3


def test_avi_odml_indx_chunks():
    """A hand-built OpenDML standard index ('indx' type 1 in strl) is
    honored for chunk extraction (read_braindead_odml_indx)."""
    import struct
    y, cb, cr, pcm = _clip(F=2)
    data = avi.mux(y, cb, cr, np.zeros(0, np.int16), fps=16,
                   sample_rate=22050)
    # locate the two 00dc payloads
    st = avi.demux(data, use_index=False)[0]
    offs = [o for (o, _, _) in st.index]
    sizes = [s for (_, s, _) in st.index]
    # build an indx chunk: type 1 (chunks), 2 longs/entry, base offset 0
    body = struct.pack("<HBBI4sQI", 2, 0, 1, 2, b"00dc", 0, 0)
    body += b"\x00" * 0
    for o, s in zip(offs, sizes):
        body += struct.pack("<II", o, s)
    indx = b"indx" + struct.pack("<I", len(body)) + body
    # splice into the video strl (after strf), fixing RIFF/LIST sizes is
    # unnecessary for the parser as long as offsets stay valid: rebuild
    # the file with demux on a synthetic stream instead
    streams = [avi.AviStream("video")]
    avi._parse_odml_indx(indx[8:] and data + indx, len(data) + 8,
                         len(body), 0, streams)
    got = [ (data + indx)[o:o+l] for (o, l, _) in streams[0].index ]
    assert got == st.chunks


@pytest.mark.parametrize("fourcc", [b"YUY2", b"UYVY"])
def test_avi_packed_422_formats(fourcc):
    """Packed 4:2:2 inputs land as 4:2:0 planes with exact Y and
    vertically-averaged chroma."""
    rng = np.random.default_rng(5)
    h, w = 16, 32
    y = rng.integers(0, 256, (h, w), np.uint8).astype(np.uint8)
    u = rng.integers(0, 256, (h, w // 2), np.uint8).astype(np.uint8)
    v = rng.integers(0, 256, (h, w // 2), np.uint8).astype(np.uint8)
    pk = np.zeros((h, w * 2), np.uint8)
    if fourcc == b"YUY2":
        pk[:, 0::2] = y
        pk[:, 1::4] = u
        pk[:, 3::4] = v
    else:
        pk[:, 1::2] = y
        pk[:, 0::4] = u
        pk[:, 2::4] = v
    st = avi.AviStream("video", codec=fourcc, width=w, height=h,
                       chunks=[pk.tobytes()])
    yg, cbg, crg = avi.extract_yuv420(st)
    np.testing.assert_array_equal(yg[0], y)
    want_cb = ((u[0::2].astype(np.uint16) + u[1::2] + 1) >> 1).astype(np.uint8)
    want_cr = ((v[0::2].astype(np.uint16) + v[1::2] + 1) >> 1).astype(np.uint8)
    np.testing.assert_array_equal(cbg[0], want_cb)
    np.testing.assert_array_equal(crg[0], want_cr)


def test_avi_gray_and_rgb32_formats():
    rng = np.random.default_rng(6)
    h, w = 16, 32
    g = rng.integers(0, 256, (h, w), np.uint8).astype(np.uint8)
    st = avi.AviStream("video", codec=b"Y800", width=w, height=h,
                       chunks=[g.tobytes()])
    yg, cbg, crg = avi.extract_yuv420(st)
    np.testing.assert_array_equal(yg[0], g)
    assert (cbg == 128).all() and (crg == 128).all()

    # 32-bit BGRX bottom-up DIB: gray ramp -> Y ramp
    val = np.arange(w, dtype=np.uint8)[None, :].repeat(h, 0)
    img = np.stack([val, val, val, np.zeros_like(val)], axis=-1)  # B G R X
    st32 = avi.AviStream("video", codec=b"DIB ", width=w, height=h,
                         bits=32, chunks=[img[::-1].tobytes()])
    y32, _, _ = avi.extract_yuv420(st32)
    # full-range BT.601 of gray (r=g=b=v): Y == v exactly
    np.testing.assert_array_equal(y32[0], val)


def test_avi_mux_mjpg_roundtrip():
    """MJPG-in-AVI write path (`-vcodec mjpeg`, mjpegenc.c generic headers):
    mux full-header JPEGs, demux, decode via the generic MJPEG decoder."""
    from amv_tpu.codecs.mjpeg import encode_mjpeg_frames
    y, cb, cr, pcm = _clip()
    chunks = encode_mjpeg_frames(y, cb, cr, qscale=2)
    data = avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050,
                   video_chunks=chunks)
    streams = avi.demux(data)
    vst, ast = streams
    assert bytes(vst.codec[:4]).upper() == b"MJPG"
    assert vst.chunks == chunks              # payload bytes survive the mux
    y2, cb2, cr2 = avi.extract_yuv420(vst)   # decode_mjpeg_frames path
    assert y2.shape == y.shape and cb2.shape == cb.shape
    err = np.abs(y2.astype(np.int32) - y.astype(np.int32)).mean()
    assert err < 4.0, f"MJPG roundtrip luma error {err}"
    np.testing.assert_array_equal(avi.extract_pcm(ast), pcm)


def test_cli_vcodec_mjpeg(tmp_path, sample_amv_path):
    """`python -m amv_tpu -i clip.amv -vcodec mjpeg out.avi` writes an
    MJPG AVI whose frames our own AVI reader decodes."""
    from amv_tpu import cli
    src = sample_amv_path
    out = str(tmp_path / "out.avi")
    assert cli.main(["-i", src, "--max-frames", "4",
                     "-vcodec", "mjpeg", out]) == 0
    with open(out, "rb") as f:
        streams = avi.demux(f.read())
    vst = streams[0]
    assert bytes(vst.codec[:4]).upper() == b"MJPG"
    assert len(vst.chunks) == 4
    assert vst.chunks[0][:2] == b"\xFF\xD8"
    y2, _, _ = avi.extract_yuv420(vst)
    assert y2.shape == (4, vst.height, vst.width)


def test_cli_vcodec_copy(tmp_path, sample_amv_bytes, sample_amv_path):
    """`-vcodec copy`: AMV scans remuxed as MJPG without re-encode —
    decoding the copied JPEGs equals the (unflipped) AMV decode."""
    from amv_tpu import cli
    from amv_tpu.codecs import amv_video
    from amv_tpu.containers import riff
    src = sample_amv_path
    out = str(tmp_path / "copy.avi")
    assert cli.main(["-i", src, "--max-frames", "3",
                     "-vcodec", "copy", out]) == 0
    with open(out, "rb") as f:
        streams = avi.demux(f.read())
    vst = streams[0]
    assert bytes(vst.codec[:4]).upper() == b"MJPG"
    assert len(vst.chunks) == 3
    s = riff.demux(sample_amv_bytes)
    # payload after the canned header must be the stored scan, untouched
    from amv_tpu.bitstream.jpeg_tables import canned_jpeg_header
    hdr = canned_jpeg_header(s.info.width, s.info.height)
    assert vst.chunks[0] == hdr + s.video_chunks[0][2:-2] + b"\xFF\xD9"
    y, _, _ = avi.extract_yuv420(vst)
    ya, _, _ = amv_video.decode_frames(s.video_chunks[:3],
                                       s.info.width, s.info.height)
    np.testing.assert_array_equal(y, ya[:, ::-1])


def _expand(v, width):
    """Bit-replicate a `width`-bit channel to 8 bits (5->8: <<3 | >>2)."""
    v = v.astype(np.uint16)
    return ((v << (8 - width)) | (v >> max(0, 2 * width - 8))).astype(np.uint8)


def test_avi_rgb16_bitfields_565():
    """BI_BITFIELDS 16-bit DIB with 565 masks (how real RGB565 AVIs are
    declared — avidec.c passes the strf masks to raw.c pix_fmt
    selection): demux parses the masks, extract decodes 565; a plain
    BI_RGB 16-bit stream stays RGB555."""
    import struct as _s
    rng = np.random.default_rng(11)
    h, w = 8, 12
    v = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    row = (w * 2 + 3) & ~3
    dib = np.zeros((h, row), np.uint8)
    dib[:, :w * 2] = v[::-1].view(np.uint8).reshape(h, w * 2)  # bottom-up
    payload = dib.tobytes()

    def chunk(tag, body):
        return tag + _s.pack("<I", len(body)) + body + (b"\0" * (len(body) & 1))

    strh = (b"vids" + b"\0" * 16 + _s.pack("<II", 1, 10) + b"\0" * 28)
    bmih = _s.pack("<IiiHH4sIiiII", 40, w, h, 1, 16, b"\x03\0\0\0",
                   len(payload), 0, 0, 0, 0)
    strf = bmih + _s.pack("<III", 0xF800, 0x07E0, 0x001F)
    strl = b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf)
    hdrl = b"hdrl" + chunk(b"LIST", strl)
    movi = b"movi" + chunk(b"00db", payload)
    body = b"AVI " + chunk(b"LIST", hdrl) + chunk(b"LIST", movi)
    data = b"RIFF" + _s.pack("<I", len(body)) + body

    (st,) = avi.demux(data)
    assert st.bitmasks == (0xF800, 0x07E0, 0x001F)
    assert st.bits == 16 and st.codec == b"DIB "
    yg, _, _ = avi.extract_yuv420(st)
    from amv_tpu.kernels.color import rgb_to_yuv420_bt601
    rgb = np.stack([_expand((v >> 11) & 31, 5), _expand((v >> 5) & 63, 6),
                    _expand(v & 31, 5)], axis=-1)
    yw, _, _ = rgb_to_yuv420_bt601(rgb[None])
    np.testing.assert_array_equal(yg[0], np.asarray(yw)[0])

    # BI_RGB 16-bit default stays 555
    st555 = avi.AviStream("video", codec=b"DIB ", width=w, height=h,
                          bits=16, chunks=[payload])
    y5, _, _ = avi.extract_yuv420(st555)
    rgb5 = np.stack([_expand((v >> 10) & 31, 5), _expand((v >> 5) & 31, 5),
                     _expand(v & 31, 5)], axis=-1)
    yw5, _, _ = rgb_to_yuv420_bt601(rgb5[None])
    np.testing.assert_array_equal(y5[0], np.asarray(yw5)[0])


def test_avi_pal8_palette_input():
    """pal8 bottom-up DIB (swscale.c pal8 input): indices go through the
    BGRX RGBQUAD palette; an identity-gray palette stays the luma fast
    path."""
    rng = np.random.default_rng(7)
    h, w = 16, 20                       # w not a multiple of 4: row pad
    idxs = rng.integers(0, 256, (h, w), np.uint8).astype(np.uint8)
    pal = rng.integers(0, 256, (256, 4), np.uint8).astype(np.uint8)
    row = (w + 3) & ~3
    dib = np.zeros((h, row), np.uint8)
    dib[:, :w] = idxs[::-1]             # bottom-up
    st = avi.AviStream("video", codec=b"DIB ", width=w, height=h,
                       bits=8, chunks=[dib.tobytes()], palette=pal)
    yg, cbg, crg = avi.extract_yuv420(st)
    from amv_tpu.kernels.color import rgb_to_yuv420_bt601
    rgb = pal[idxs][:, :, 2::-1]
    yw, cbw, crw = (np.asarray(a) for a in rgb_to_yuv420_bt601(
        np.ascontiguousarray(rgb)[None]))
    np.testing.assert_array_equal(yg[0], yw[0])
    np.testing.assert_array_equal(cbg[0], cbw[0])
    np.testing.assert_array_equal(crg[0], crw[0])

    # identity-gray palette: keep exact-luma semantics
    gray_pal = np.stack([np.arange(256)] * 3 + [np.zeros(256)],
                        axis=-1).astype(np.uint8)
    stg = avi.AviStream("video", codec=b"DIB ", width=w, height=h,
                        bits=8, chunks=[idxs.tobytes()], palette=gray_pal)
    # gray path reads top-down unpadded (Y800 semantics)
    yg2, cbg2, _ = avi.extract_yuv420(stg)
    np.testing.assert_array_equal(yg2[0], idxs)
    assert (cbg2 == 128).all()
