"""Scalar oracles for the WAV/AVI audio ingest codecs.

Transliterations (behavioral, Python-idiom) of the reference decode
semantics for the audio formats an AVI/WAV input may carry besides
s16 PCM:

* G.711 A-law / mu-law expansion — pcm.c:45-75 (the SUN g711.c math);
* PCM u8/s8/u16/s24/s32 to s16 — pcm.c:380-470 (decode_to16 keeps the
  top 16 bits; u8 is ``(x - 128) << 8``);
* IMA-ADPCM-WAV block decode — adpcm.c:983-1014 (4-byte per-channel
  block header {le16 predictor, u8 step_index clamped to 88, pad},
  then 4-byte channel-interleaved nibble groups, LOW nibble first —
  unlike AMV's high-first order — expand shift=3);
* MS-ADPCM block decode — adpcm.c:743-756,1041-1106 (7-byte per-channel
  header {predictor index -> AdaptCoeff pair, le16 idelta, le16 sample1,
  le16 sample2}; emits sample1 THEN sample2 first — this fork's quirk —
  then two samples per byte, high nibble first, left channel on the
  high nibble for stereo).

These run sample-at-a-time and exist only as differential ground truth
for the batched device decoders in `codecs/wav_audio.py`.
"""

from __future__ import annotations

import numpy as np

from .ref_adpcm import STEP_TABLE, INDEX_TABLE

# MS-ADPCM tables (libsndfile-derived spec data, adpcm.c:79-90)
MS_ADAPTATION_TABLE = [
    230, 230, 230, 230, 307, 409, 512, 614,
    768, 614, 512, 409, 307, 230, 230, 230,
]
MS_ADAPT_COEFF1 = [256, 512, 0, 192, 240, 460, 392]
MS_ADAPT_COEFF2 = [0, -256, 0, 64, 0, -208, -232]


def _clip16(x: int) -> int:
    return -32768 if x < -32768 else (32767 if x > 32767 else x)


# ---------------------------------------------------------------------------
# G.711 (pcm.c:45-75)
# ---------------------------------------------------------------------------

def alaw2linear(a_val: int) -> int:
    a_val ^= 0x55
    t = a_val & 0xF
    seg = (a_val & 0x70) >> 4
    if seg:
        t = (t + t + 1 + 32) << (seg + 2)
    else:
        t = (t + t + 1) << 3
    return t if (a_val & 0x80) else -t


def ulaw2linear(u_val: int) -> int:
    u_val = ~u_val & 0xFF
    t = ((u_val & 0xF) << 3) + 0x84
    t <<= (u_val & 0x70) >> 4
    return (0x84 - t) if (u_val & 0x80) else (t - 0x84)


ALAW_TABLE = np.array([alaw2linear(i) for i in range(256)], dtype=np.int16)
ULAW_TABLE = np.array([ulaw2linear(i) for i in range(256)], dtype=np.int16)


# ---------------------------------------------------------------------------
# IMA-ADPCM-WAV (adpcm.c:716-740 expand, :983-1014 block layout)
# ---------------------------------------------------------------------------

def _ima_expand(state: list, nibble: int) -> int:
    """state = [predictor, step_index], mutated; returns the sample."""
    predictor, step_index = state
    step = STEP_TABLE[step_index]
    step_index = min(max(step_index + INDEX_TABLE[nibble], 0), 88)
    diff = ((2 * (nibble & 7) + 1) * step) >> 3
    predictor = _clip16(predictor - diff if (nibble & 8) else predictor + diff)
    state[0], state[1] = predictor, step_index
    return predictor


def decode_ima_wav_block(block: bytes, channels: int) -> np.ndarray:
    """One IMA-WAV block -> int16 [n, channels] (header samples not
    emitted, matching the reference's commented-out line)."""
    states = []
    pos = 0
    for _ in range(channels):
        pred = int(np.frombuffer(block[pos:pos + 2], "<i2")[0])
        sidx = min(block[pos + 2], 88)
        states.append([pred, sidx])
        pos += 4
    out = []
    if channels == 1:
        for b in block[pos:]:
            out.append(_ima_expand(states[0], b & 0xF))
            out.append(_ima_expand(states[0], b >> 4))
    else:
        n_groups = (len(block) - pos) // (4 * channels)
        for g in range(n_groups):
            base = pos + g * 4 * channels
            for m in range(4):
                row = []
                for i in range(channels):
                    row.append(_ima_expand(states[i],
                                           block[base + 4 * i + m] & 0xF))
                out.append(row)
                row = []
                for i in range(channels):
                    row.append(_ima_expand(states[i],
                                           block[base + 4 * i + m] >> 4))
                out.append(row)
    return np.asarray(out, dtype=np.int16).reshape(-1, channels)


# ---------------------------------------------------------------------------
# MS-ADPCM (adpcm.c:743-756 expand, :1041-1106 block layout)
# ---------------------------------------------------------------------------

def _w32(x: int) -> int:
    """Wrap to int32 (the reference computes in C `int`; pathological
    streams can overflow idelta, which wraps in practice)."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


def _ms_expand(state: list, nibble: int) -> int:
    """state = [sample1, sample2, idelta, coeff1, coeff2], mutated."""
    s1, s2, idelta, c1, c2 = state
    predictor = _w32(s1 * c1 + s2 * c2)
    # C integer division truncates toward zero
    predictor = abs(predictor) // 256 * (1 if predictor >= 0 else -1)
    signed = nibble - 0x10 if (nibble & 8) else nibble
    predictor = _w32(predictor + signed * idelta)
    state[1] = s1
    state[0] = _clip16(predictor)
    state[2] = max(_w32(MS_ADAPTATION_TABLE[nibble] * idelta) >> 8, 16)
    return state[0]


def decode_ms_block(block: bytes, channels: int) -> np.ndarray:
    """One MS-ADPCM block -> int16 [n, channels]."""
    st = channels - 1
    pos = 0
    preds = []
    for _ in range(channels):
        # av_clip(,0,7) in the reference indexes one past the 7-entry
        # coeff tables for predictor 7 (latent OOB read); we clamp to 6
        preds.append(min(block[pos], 6))
        pos += 1
    ideltas = []
    for _ in range(channels):
        ideltas.append(int(np.frombuffer(block[pos:pos + 2], "<i2")[0]))
        pos += 2
    s1 = []
    for _ in range(channels):
        s1.append(int(np.frombuffer(block[pos:pos + 2], "<i2")[0]))
        pos += 2
    s2 = []
    for _ in range(channels):
        s2.append(int(np.frombuffer(block[pos:pos + 2], "<i2")[0]))
        pos += 2
    states = [[s1[i], s2[i], ideltas[i],
               MS_ADAPT_COEFF1[preds[i]], MS_ADAPT_COEFF2[preds[i]]]
              for i in range(channels)]
    # reference emits sample1 then sample2 (adpcm.c:1076-1080)
    out = [list(s1), list(s2)]
    for b in block[pos:]:
        if st == 0:
            out.append([_ms_expand(states[0], (b >> 4) & 0xF)])
            out.append([_ms_expand(states[0], b & 0xF)])
        else:
            out.append([_ms_expand(states[0], (b >> 4) & 0xF),
                        _ms_expand(states[1], b & 0xF)])
    return np.asarray(out, dtype=np.int16).reshape(-1, channels)


def decode_blocks(data: bytes, channels: int, block_align: int,
                  kind: str) -> np.ndarray:
    """Split `data` into block_align-sized blocks and decode each
    independently (state resets per block)."""
    dec = decode_ima_wav_block if kind == "ima" else decode_ms_block
    if block_align <= 0:
        block_align = len(data)
    out = []
    for off in range(0, len(data), block_align):
        blk = data[off:off + block_align]
        if len(blk) < (4 if kind == "ima" else 7) * channels:
            break
        out.append(dec(blk, channels))
    if not out:
        return np.zeros((0, channels), dtype=np.int16)
    return np.concatenate(out, axis=0)
