"""AMV MJPEG-variant video codec on the device.

Decode: the host only strips framing and 0xFF00 stuffing (C unescape);
Huffman scan decode (backend.entropy_decoder), DC prediction, dequant,
IDCT, MCU->plane assembly and the AMV vertical flip run as one jitted
program over a whole batch of frames.

Encode: flip/pad, block extraction, FDCT, quantization and the Huffman
pack with stuffing, escaping and framing (kernels/entropy_encode.py) run
on device for the batch; only payload bytes come back.

A frame the device chain cannot finish (a malformed scan, or an encoded
frame over its byte budget) goes through the host C entropy coder and is
counted in backend.host_fallbacks.

Reference semantics: sp5xdec.c + mjpegdec.c (decode), mjpegenc.c +
mpegvideo_enc.c (encode); see kernels/idct.py and kernels/fdct.py for the
exact arithmetic provenance.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..bitstream import jpeg_tables as T
from ..bitstream.entropy import (huffman_decode_frames, huffman_encode_frame)
from ..kernels import idct as KI
from ..kernels import fdct as KF
from ..kernels.entropy_encode import encode_frames_device

_QM_RASTER = np.zeros((6, 64), dtype=np.int32)
_QM_RASTER[:4, T.ZIGZAG] = T.SP5X_QUANT_LUMA_ZZ
_QM_RASTER[4:, T.ZIGZAG] = T.SP5X_QUANT_CHROMA_ZZ

_ZZ = jnp.asarray(T.ZIGZAG)
_UNZZ = jnp.asarray(T.UNZIGZAG)


@partial(jax.jit, static_argnames=("mb_w", "mb_h", "width", "height"))
def decode_transform(levels_zz: jnp.ndarray, mb_w: int, mb_h: int,
                     width: int, height: int):
    """Quantized levels -> YUV420 planes (flipped to display orientation).

    levels_zz: int16 [F, n_mcu, 6, 64] in ZIGZAG order; position 0 holds the
               DC *difference* (pre-prediction).
    Returns (y uint8 [F, H, W], cb uint8 [F, H/2, W/2], cr likewise).
    """
    F, M = levels_zz.shape[0], levels_zz.shape[1]
    lv = levels_zz.astype(jnp.int32)

    # --- DC prediction (decode_block:387-389), init 1024 per scan ----------
    qm0_l = int(T.SP5X_QUANT_LUMA_ZZ[0])
    qm0_c = int(T.SP5X_QUANT_CHROMA_ZZ[0])
    dc_y = jnp.cumsum(lv[:, :, :4, 0].reshape(F, M * 4) * qm0_l, axis=1)
    dc_y = (dc_y + 1024).reshape(F, M, 4)
    dc_cb = jnp.cumsum(lv[:, :, 4, 0] * qm0_c, axis=1) + 1024
    dc_cr = jnp.cumsum(lv[:, :, 5, 0] * qm0_c, axis=1) + 1024
    dc = jnp.concatenate([dc_y, dc_cb[..., None], dc_cr[..., None]], axis=-1)

    # --- zigzag -> raster + dequant + IDCT ---------------------------------
    # raster[j] = levels[unzigzag[j]]: a gather, which compiles much faster
    # than the equivalent scatter on every backend
    raster = jnp.take(lv, _UNZZ, axis=-1)
    qm = jnp.asarray(_QM_RASTER)[None, None]
    pix = KI.dequantize_idct(raster, dc, qm)  # uint8 [F, M, 6, 8, 8]
    return assemble_planes(pix, mb_w, mb_h, width, height)


def assemble_planes(pix, mb_w: int, mb_h: int, width: int, height: int):
    """Decoded blocks uint8 [F, M, 6, 8, 8] -> YUV420 display planes
    (MCU assembly + AMV flip, mjpeg_decode_scan:672-723)."""
    F = pix.shape[0]
    mcu = pix.reshape(F, mb_h, mb_w, 6, 8, 8)
    yb = mcu[:, :, :, :4].reshape(F, mb_h, mb_w, 2, 2, 8, 8)
    ycoded = yb.transpose(0, 1, 3, 5, 2, 4, 6).reshape(F, 16 * mb_h, 16 * mb_w)
    cbc = mcu[:, :, :, 4].transpose(0, 1, 3, 2, 4).reshape(F, 8 * mb_h, 8 * mb_w)
    crc = mcu[:, :, :, 5].transpose(0, 1, 3, 2, 4).reshape(F, 8 * mb_h, 8 * mb_w)
    y = ycoded[:, height - 1::-1, :width]
    ch, cw = height // 2, width // 2
    cb = cbc[:, ch - 1::-1, :cw]
    cr = crc[:, ch - 1::-1, :cw]
    return y, cb, cr


@partial(jax.jit, static_argnames=("width", "height"))
def decode_scans(scans, width: int, height: int):
    """Device decode chain: unescaped scan rows uint8 [F, W] ->
    (y, cb, cr display planes, ok bool [F])."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    levels, ok = backend.entropy_decoder()(scans, mb_w * mb_h)
    return (*decode_transform(levels, mb_w, mb_h, width, height), ok)


def decode_frames(payloads: list[bytes], width: int, height: int):
    """Decode a batch of AMV '00dc' payloads to YUV420 planes (numpy).

    Only the unescaped scan bytes go to the device; frames the device
    decoder rejects are decoded by the host C decoder, which raises
    ValueError on malformed data (mjpegdec.c returns -1 there)."""
    from ..pipeline.transcode import unescape_sorted
    rows, inv = unescape_sorted(payloads)
    y, cb, cr, ok = (np.asarray(a)[inv] for a in
                     decode_scans(jnp.asarray(rows), width, height))
    bad = np.flatnonzero(~ok)
    if len(bad):
        backend.count_host_fallback("decode", len(bad))
        mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
        lv = huffman_decode_frames([payloads[i] for i in bad], mb_w * mb_h)
        planes = decode_transform(jnp.asarray(lv), mb_w, mb_h, width, height)
        for dst, src in zip((y, cb, cr), planes):
            dst[bad] = np.asarray(src)
    return y, cb, cr


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("mb_w", "mb_h"))
def extract_blocks(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray,
                   mb_w: int, mb_h: int):
    """YUV420 planes -> encoder block layout uint8 [F, n_mcu, 6, 8, 8]
    (flip + bottom/right edge replication, amv_encode_picture:467-471 +
    ff_emulated_edge_mc)."""
    F = y.shape[0]

    def flip_pad(p, th, tw):
        p = p[:, ::-1]
        h, w = p.shape[1], p.shape[2]
        p = jnp.pad(p, ((0, 0), (0, th - h), (0, tw - w)), mode="edge")
        return p

    yc = flip_pad(y, 16 * mb_h, 16 * mb_w)
    cbc = flip_pad(cb, 8 * mb_h, 8 * mb_w)
    crc = flip_pad(cr, 8 * mb_h, 8 * mb_w)
    yb = yc.reshape(F, mb_h, 2, 8, mb_w, 2, 8).transpose(0, 1, 4, 2, 5, 3, 6)
    cbb = cbc.reshape(F, mb_h, 8, mb_w, 8).transpose(0, 1, 3, 2, 4)
    crb = crc.reshape(F, mb_h, 8, mb_w, 8).transpose(0, 1, 3, 2, 4)
    return jnp.concatenate([
        yb.reshape(F, mb_h * mb_w, 4, 8, 8),
        cbb.reshape(F, mb_h * mb_w, 1, 8, 8),
        crb.reshape(F, mb_h * mb_w, 1, 8, 8),
    ], axis=2)


@partial(jax.jit, static_argnames=("mb_w", "mb_h", "qscale", "quant"))
def encode_transform(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray,
                     mb_w: int, mb_h: int, qscale: int = 2,
                     quant: str = "ffmpeg"):
    """YUV420 frames -> quantized levels [F, n_mcu, 6, 64] (zigzag order).

    Implements the flip + bottom/right edge replication
    (amv_encode_picture:467-471 + ff_emulated_edge_mc) and the
    fdct+quantize path on device.

    quant="ffmpeg" (default) replicates the reference encoder exactly:
    MPEG-1 intra matrix x qscale (mpegvideo_enc.c:2866-2876) +
    dct_quantize_c bias arithmetic — faithful INCLUDING its known bug:
    the AMV decoder dequantizes with the fixed sp5x Q60 pair
    (sp5x.h:187-195), not this matrix, so decode(encode(x)) lands at
    ~19 dB.  quant="q60" is the *device-consistent* mode that finishes
    what the reference's README set out to do (AMVmuxer/README:14-19):
    quantize with the same Q60 pair the decoder will use (round to
    nearest; DC = 128 + round((dct-1024)/q0) so the entropy coder's
    last_dc=128 chain telescopes into the decoder's 1024 + cumsum*q0
    reconstruction), giving >=30 dB round trips.
    """
    if quant == "q60":
        blocks = extract_blocks(y, cb, cr, mb_w, mb_h)
        coefs = KF.fdct(blocks).reshape(*blocks.shape[:-2], 64)
        # ff_jpeg_fdct_islow output is the JPEG DCT x8; decoder-side
        # reconstruction is level*q (raster, wrap16) + 1024 DC offset
        off = np.zeros((6, 64), np.int32)
        off[:, 0] = 8192                     # 8 x the decoder's 1024 DC
        num = coefs - jnp.asarray(off)
        den = jnp.asarray(8 * _QM_RASTER)    # [6, 64]
        mag = (jnp.abs(num) + (den >> 1)) // den
        lv = jnp.clip(jnp.where(num < 0, -mag, mag), -1023, 1023)
        lv = lv.at[..., 0].add(128)          # absolute DC for last_dc=128
        return lv.astype(jnp.int16)[..., _ZZ]
    if quant != "ffmpeg":
        raise ValueError(f"unknown quant mode {quant!r}")
    qmat = jnp.asarray(
        ((1 << 22) // (8 * _encoder_quant_matrix(qscale).astype(np.int64)))
        .astype(np.int32))
    blocks = extract_blocks(y, cb, cr, mb_w, mb_h)
    levels_raster = KF.fdct_quantize(blocks, qmat)  # [F, M, 6, 64]
    return levels_raster[..., _ZZ]  # zigzag order for the entropy coder


def _encoder_quant_qmat_np(qscale: int) -> np.ndarray:
    m = _encoder_quant_matrix(qscale)
    return ((1 << 22) // (8 * m.astype(np.int64))).astype(np.int32)


def _encoder_quant_matrix(qscale: int) -> np.ndarray:
    m = np.empty(64, dtype=np.int32)
    m[0] = T.MPEG1_INTRA_MATRIX[0]
    m[1:] = np.clip((T.MPEG1_INTRA_MATRIX[1:] * qscale) >> 3, 0, 255)
    return m


def encode_bytes_bound(n_mcu: int) -> int:
    """Per-frame payload budget for the device encoder: 140 bytes per
    block covers quantized noise at qscale 2 with escapes; a frame that
    needs more is counted and packed on the host."""
    return max(4096, n_mcu * 6 * 140)


@partial(jax.jit, static_argnames=("qscale", "quant", "max_bytes"))
def encode_planes(y, cb, cr, qscale: int = 2, quant: str = "ffmpeg", *,
                  max_bytes: int):
    """Device encode chain: YUV420 planes -> (payload uint8
    [F, max_bytes], lens int32 [F], levels int16 [F, M, 6, 64], ok)."""
    F, H, W = y.shape
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    levels = encode_transform(y, cb, cr, mb_w, mb_h, qscale, quant=quant)
    payload, lens = encode_frames_device(levels, max_bytes=max_bytes)
    return payload, lens, levels, lens <= max_bytes


def encode_frames(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  qscale: int = 2, quant: str = "ffmpeg") -> list[bytes]:
    """Encode YUV420 frames into AMV '00dc' payloads on the device.

    quant="q60" selects the device-consistent quantizer (see
    encode_transform)."""
    F, H, W = y.shape
    mb_w, mb_h = (W + 15) // 16, (H + 15) // 16
    payload, lens, levels, ok = encode_planes(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), qscale, quant,
        max_bytes=encode_bytes_bound(mb_w * mb_h))
    payload, lens, ok = np.asarray(payload), np.asarray(lens), np.asarray(ok)
    out = [payload[f, :lens[f]].tobytes() for f in range(F)]
    bad = np.flatnonzero(~ok)
    if len(bad):
        backend.count_host_fallback("encode", len(bad))
        lv = np.asarray(levels)
        for f in bad:
            out[f] = huffman_encode_frame(lv[f])
    return out
