"""WAV/AVI audio ingest codecs: PCM variants, G.711, IMA/MS ADPCM.

The reference accepts many more audio codecs in AVI/WAV inputs than the
AMV pipeline emits; these are the ones real-world inputs actually carry:

* PCM u8/s16/s24/s32 -> s16 (pcm.c:380-470: keep the top 16 bits);
* A-law / mu-law (pcm.c:45-75 G.711 expansion, table lookup);
* IMA-ADPCM-WAV, wFormatTag 0x11 (adpcm.c:983-1014);
* MS-ADPCM, wFormatTag 0x02 (adpcm.c:1041-1106).

Both ADPCM flavors reset their codec state in every block header, so a
whole stream decodes as one batched device dispatch with (block x channel)
lanes — the same parallelism gift as AMV's chunk headers.  The host only
does layout: header split + nibble reorder.  Bit-exactness is gated
against the scalar transliterations in `verify/ref_wav_audio.py`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..kernels import adpcm as K
from ..verify.ref_wav_audio import (ALAW_TABLE, ULAW_TABLE,
                                    MS_ADAPT_COEFF1, MS_ADAPT_COEFF2)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_ADPCM_MS = 0x0002
WAVE_FORMAT_ALAW = 0x0006
WAVE_FORMAT_MULAW = 0x0007
WAVE_FORMAT_ADPCM_IMA = 0x0011


def _deinterleave(samples: np.ndarray, channels: int) -> np.ndarray:
    n = len(samples) // channels * channels
    out = samples[:n]
    return out.reshape(-1, channels) if channels > 1 else out


def decode_pcm_bytes(data: bytes, fmt: int, bits: int, channels: int,
                     block_align: int = 0) -> np.ndarray:
    """Decode an audio byte stream to int16 PCM [n] (mono) or [n, ch]."""
    if fmt == WAVE_FORMAT_PCM:
        if bits == 8:
            s = ((np.frombuffer(data, np.uint8).astype(np.int16) - 128)
                 << 8)
        elif bits == 16:
            s = np.frombuffer(data[:len(data) & ~1], "<i2")
        elif bits in (24, 32):
            # decode_to16: keep the top 16 bits (pcm.c:340-378)
            w = bits // 8
            n = len(data) // w
            b = np.frombuffer(data, np.uint8,
                              n * w).reshape(n, w)[:, w - 2:]
            s = b.copy().view("<i2").reshape(-1)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
        return _deinterleave(np.ascontiguousarray(s), channels)
    if fmt == WAVE_FORMAT_ALAW:
        return _deinterleave(ALAW_TABLE[np.frombuffer(data, np.uint8)],
                             channels)
    if fmt == WAVE_FORMAT_MULAW:
        return _deinterleave(ULAW_TABLE[np.frombuffer(data, np.uint8)],
                             channels)
    if fmt == WAVE_FORMAT_ADPCM_IMA:
        return decode_ima_wav(data, channels, block_align)
    if fmt == WAVE_FORMAT_ADPCM_MS:
        return decode_ms(data, channels, block_align)
    raise ValueError(f"unsupported WAVE format tag 0x{fmt:04x}")


def _split_blocks(data: bytes, block_align: int, min_len: int):
    if block_align <= 0:
        block_align = len(data)
    return [data[o:o + block_align] for o in range(0, len(data), block_align)
            if len(data[o:o + block_align]) >= min_len]


def decode_ima_wav(data: bytes, channels: int, block_align: int
                   ) -> np.ndarray:
    """IMA-ADPCM-WAV (adpcm.c:983-1014): 4-byte channel headers, 4-byte
    channel-interleaved nibble groups, LOW nibble first, expand shift=3.
    One batched dispatch over (block, channel) lanes."""
    blocks = _split_blocks(data, block_align, 4 * channels)
    if not blocks:
        return np.zeros((0, channels) if channels > 1 else 0, np.int16)
    preds, sidxs, streams = [], [], []
    for blk in blocks:
        hdr = np.frombuffer(blk[:4 * channels], np.uint8).reshape(
            channels, 4)
        preds.extend(hdr[:, :2].copy().view("<i2")[:, 0].tolist())
        sidxs.extend(np.minimum(hdr[:, 2], 88).tolist())
        body = np.frombuffer(blk[4 * channels:], np.uint8)
        if channels == 1:
            lohi = np.stack([body & 0xF, body >> 4], -1).reshape(-1)
            streams.append([lohi])
        else:
            ng = len(body) // (4 * channels)
            g = body[:ng * 4 * channels].reshape(ng, channels, 4)
            lohi = np.stack([g & 0xF, g >> 4], -1)  # [ng, ch, 4, 2]
            streams.append([lohi[:, i].reshape(-1) for i in range(channels)])
    lens = [len(s[0]) for s in streams]
    n = max(lens)
    rows = np.zeros((len(blocks) * channels, n), np.int32)
    for bi, chs in enumerate(streams):
        for ci, st in enumerate(chs):
            rows[bi * channels + ci, :len(st)] = st
    dec = np.asarray(K.decode_nibbles(
        jnp.asarray(rows), jnp.asarray(preds, jnp.int32),
        jnp.asarray(sidxs, jnp.int32)))
    out = []
    for bi, ln in enumerate(lens):
        blk = dec[bi * channels:(bi + 1) * channels, :ln]  # [ch, ln]
        out.append(blk.T)
    pcm = np.concatenate(out, axis=0)
    return pcm if channels > 1 else pcm[:, 0]


def decode_ms(data: bytes, channels: int, block_align: int) -> np.ndarray:
    """MS-ADPCM (adpcm.c:1041-1106): 7-byte channel headers; emits
    sample1 then sample2 (this fork's order), then 2 samples/byte, high
    nibble = left channel. One batched dispatch over lanes."""
    blocks = _split_blocks(data, block_align, 7 * channels)
    if not blocks:
        return np.zeros((0, channels) if channels > 1 else 0, np.int16)
    c1s, c2s, idls, s1s, s2s, streams = [], [], [], [], [], []
    for blk in blocks:
        b = np.frombuffer(blk, np.uint8)
        pos = 0
        pr = [min(int(b[pos + i]), 6) for i in range(channels)]
        pos += channels
        le16 = lambda o: int(b[o:o + 2].copy().view("<i2")[0])
        idl = [le16(pos + 2 * i) for i in range(channels)]
        pos += 2 * channels
        s1 = [le16(pos + 2 * i) for i in range(channels)]
        pos += 2 * channels
        s2 = [le16(pos + 2 * i) for i in range(channels)]
        pos += 2 * channels
        c1s.extend(MS_ADAPT_COEFF1[p] for p in pr)
        c2s.extend(MS_ADAPT_COEFF2[p] for p in pr)
        idls.extend(idl)
        s1s.extend(s1)
        s2s.extend(s2)
        body = b[pos:]
        if channels == 1:
            streams.append([np.stack([body >> 4, body & 0xF],
                                     -1).reshape(-1)])
        else:
            streams.append([body >> 4, body & 0xF])
    lens = [len(s[0]) for s in streams]
    n = max(lens)
    rows = np.zeros((len(blocks) * channels, n), np.int32)
    for bi, chs in enumerate(streams):
        for ci, st in enumerate(chs):
            rows[bi * channels + ci, :len(st)] = st
    dec = np.asarray(K.decode_ms_nibbles(
        jnp.asarray(rows), jnp.asarray(c1s, jnp.int32),
        jnp.asarray(c2s, jnp.int32), jnp.asarray(idls, jnp.int32),
        jnp.asarray(s1s, jnp.int32), jnp.asarray(s2s, jnp.int32)))
    out = []
    for bi, ln in enumerate(lens):
        hdr = np.array([s1s[bi * channels:(bi + 1) * channels],
                        s2s[bi * channels:(bi + 1) * channels]], np.int16)
        blk = dec[bi * channels:(bi + 1) * channels, :ln]  # [ch, ln]
        out.append(np.concatenate([hdr, blk.T], axis=0))
    pcm = np.concatenate(out, axis=0)
    return pcm if channels > 1 else pcm[:, 0]
