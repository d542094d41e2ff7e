"""Device-resident AMV transcode: re-encode with minimal host traffic.

One chain runs on every platform (kernels chosen by amv_tpu.backend):

1. host: C unescape of each '00dc' payload into zero-padded scan rows;
2. device: Huffman decode (backend.entropy_decoder);
3. device: DC prediction cumsum, dequant, IDCT, FDCT and re-quantization
   (transcode_levels_fused on MB-aligned frames in ffmpeg quant mode,
   else the two-stage decode_transform + encode_transform);
4. device: Huffman encode with stuffing, 0xFF escaping and SOI/EOI
   framing (kernels/entropy_encode.py:encode_frames_device);
5. host: RIFF mux.

`transcode_bytes` runs a file through pipeline/serving.py:AsyncTranscoder,
so device memory is bounded by one batch whatever the file's length.
Per frame only the input scan and the output payload cross the host
link.  A frame whose scan is malformed, or whose output overflows the
byte budget, is re-encoded on the host and counted in
backend.host_fallbacks["transcode"].

This is the throughput-oriented API surface of the framework (the role
the reference's `ffmpeg -i in.amv -f amv out.amv` plays).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import backend
from ..bitstream import jpeg_tables as T
from ..bitstream.entropy import huffman_decode_frames, huffman_encode_frame
from ..codecs.amv_video import (_QM_RASTER, _encoder_quant_qmat_np,
                                decode_transform, encode_transform)
from ..containers import riff
from ..kernels import fdct as KF
from ..kernels import idct as KI
from ..kernels.entropy_encode import encode_frames_device
from ..native import entropy_native as native


@partial(jax.jit, static_argnames=("qscale",))
def transcode_levels_fused(levels_zz, qscale=2):
    """Fused transcode: zigzag levels -> re-quantized zigzag levels
    (+ decoded pixel blocks), without assembling display planes.

    Decode's MCU->plane assembly and encode's plane->MCU extraction are
    exact inverses (incl. the AMV flip) on MB-aligned frames, so no pixel
    leaves block layout: dequant + IDCT feed FDCT + quant directly.
    Bit-exact with decode_transform + encode_transform for 16-aligned
    width/height; for other sizes the two paths differ only in the
    invisible bottom/right pad blocks (two-stage re-replicates edges,
    fused keeps the decoded pad).

    Returns (levels2_zz int16 [F, M, 6, 64], pix uint8 [F, M, 6, 8, 8]).
    """
    F, M = levels_zz.shape[0], levels_zz.shape[1]
    lv = levels_zz.astype(jnp.int32)
    qdc_l = int(T.SP5X_QUANT_LUMA_ZZ[0])
    qdc_c = int(T.SP5X_QUANT_CHROMA_ZZ[0])
    dc_y = (jnp.cumsum(lv[:, :, :4, 0].reshape(F, M * 4) * qdc_l, axis=1)
            .reshape(F, M, 4) + 1024)
    dc_cb = jnp.cumsum(lv[:, :, 4, 0] * qdc_c, axis=1) + 1024
    dc_cr = jnp.cumsum(lv[:, :, 5, 0] * qdc_c, axis=1) + 1024
    dc = jnp.concatenate([dc_y, dc_cb[..., None], dc_cr[..., None]], axis=-1)
    raster = jnp.take(lv, jnp.asarray(T.UNZIGZAG), axis=-1)
    pix = KI.dequantize_idct(raster, dc, jnp.asarray(_QM_RASTER)[None, None])
    lv2 = KF.fdct_quantize(pix, jnp.asarray(_encoder_quant_qmat_np(qscale)))
    return jnp.take(lv2, jnp.asarray(T.ZIGZAG), axis=-1), pix


def requantize(levels, width: int, height: int, qscale: int = 2,
               quant: str = "ffmpeg"):
    """Decoded levels (slot 0 = DC difference) -> re-encoded levels
    (slot 0 = DC value), the transform stage of the chain."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    if quant == "ffmpeg" and width % 16 == 0 and height % 16 == 0:
        return transcode_levels_fused(levels, qscale)[0]
    y, cb, cr = decode_transform(levels, mb_w, mb_h, width, height)
    return encode_transform(y, cb, cr, mb_w, mb_h, qscale, quant=quant)


def out_bytes_bound(in_bytes: int) -> int:
    """Output payload budget per frame for an input scan width: twice the
    input plus framing, in whole KiB so nearby widths share a compiled
    shape.  A frame that needs more is counted and re-encoded on host."""
    return (2 * in_bytes + 1024 + 1023) // 1024 * 1024


@partial(jax.jit, static_argnames=("width", "height", "qscale", "quant",
                                   "max_bytes"))
def transcode_scans(scans, *, width: int, height: int, qscale: int = 2,
                    quant: str = "ffmpeg", max_bytes: int):
    """The device part of the chain: unescaped scan rows uint8 [F, W] ->
    (payload uint8 [F, max_bytes], lens int32 [F], ok bool [F]).
    payload[f, :lens[f]] is the framed '00dc' payload of frame f when
    ok[f]; ok is False for a malformed scan or an output overflow."""
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    levels, ok = backend.entropy_decoder()(scans, mb_w * mb_h)
    lv2 = requantize(levels, width, height, qscale, quant)
    payload, lens = encode_frames_device(lv2, max_bytes=max_bytes)
    return payload, lens, ok & (lens <= max_bytes)


def unescape_sorted(payloads: list[bytes]):
    """C unescape into zero-padded rows, sorted by payload length so that
    frames of similar length decode side by side; returns (rows, inv)
    with rows[inv] in input order."""
    order = np.argsort([len(p) for p in payloads], kind="stable")
    rows, _ = native.unescape_frames([payloads[i] for i in order])
    return rows, np.argsort(order)


def collect_payloads(payload, lens, ok, inv, n: int, host_reencode):
    """Device output (in sorted order) -> payload bytes in input order;
    frames with ok False go through host_reencode(indices) and are
    counted."""
    payload, lens, ok = (np.asarray(a)[inv][:n] for a in (payload, lens, ok))
    out = [payload[f, :lens[f]].tobytes() for f in range(n)]
    bad = np.flatnonzero(~ok)
    if len(bad):
        backend.count_host_fallback("transcode", len(bad))
        for f, p in zip(bad, host_reencode(bad)):
            out[f] = p
    return out


def host_reencode(payloads: list[bytes], width: int, height: int,
                  qscale: int = 2, quant: str = "ffmpeg") -> list[bytes]:
    """Bit-exact host re-encode (C Huffman decode and encode around the
    device transform); raises ValueError on malformed scans."""
    if not payloads:
        return []
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    lv = huffman_decode_frames(payloads, mb_w * mb_h)
    lv2 = np.asarray(requantize(jnp.asarray(lv), width, height, qscale,
                                quant))
    return [huffman_encode_frame(lv2[f]) for f in range(len(payloads))]


def transcode_bytes(data: bytes, *, qscale: int = 2,
                    quant: str = "ffmpeg") -> bytes:
    """Re-encode a complete .amv file: video re-quantized at qscale
    through the device chain in bounded batches (pipeline/serving.py
    AsyncTranscoder, batch size from batch_frames_for); audio chunks are
    already bit-exact ADPCM and pass through.

    quant="q60" re-quantizes with the decoder's own Q60 tables
    (device-consistent mode, codecs/amv_video.encode_transform)."""
    from .serving import AsyncTranscoder, batch_frames_for
    s = riff.demux(data)
    w, h = s.info.width, s.info.height
    tr = AsyncTranscoder(w, h, qscale=qscale, quant=quant,
                         batch_frames=batch_frames_for(len(s.video_chunks),
                                                       w, h))
    return riff.mux(tr.transcode(s.video_chunks), s.audio_chunks,
                    width=w, height=h, fps=s.info.fps_num,
                    sample_rate=s.info.sample_rate)
