"""Scalar reference implementation of the AMV IMA-ADPCM codec.

Bit-exact reimplementation of the reference semantics:

* decode: AMVmuxer/ffmpeg/libavcodec/adpcm.c:1268-1290 (chunk header
  {le16 predictor, le16 step_index, le32 sample_count}, high-nibble-first,
  adpcm_ima_expand_nibble with shift=3, adpcm.c:716-740);
* encode: adpcm.c:461-496 (adpcm_ima_compress_sample at :219-227, the
  odd-frame extra-sample carry and second-boundary padding at :469-476).

Pure Python/numpy; used as the oracle for the device kernels.
"""

from __future__ import annotations

import struct

import numpy as np

INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8,
                        -1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)

STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17,
    19, 21, 23, 25, 28, 31, 34, 37, 41, 45,
    50, 55, 60, 66, 73, 80, 88, 97, 107, 118,
    130, 143, 157, 173, 190, 209, 230, 253, 279, 307,
    337, 371, 408, 449, 494, 544, 598, 658, 724, 796,
    876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358,
    5894, 6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899,
    15289, 16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], dtype=np.int32)

# yamaha_difflookup (adpcm.c:86-89), used by the encoder's reconstruction.
YAMAHA_DIFFLOOKUP = np.array([1, 3, 5, 7, 9, 11, 13, 15,
                              -1, -3, -5, -7, -9, -11, -13, -15], dtype=np.int32)


def expand_nibble(predictor: int, step_index: int, nibble: int):
    """adpcm_ima_expand_nibble with shift=3 (adpcm.c:716-740)."""
    step = int(STEP_TABLE[step_index])
    new_index = step_index + int(INDEX_TABLE[nibble])
    new_index = min(max(new_index, 0), 88)
    sign = nibble & 8
    delta = nibble & 7
    diff = ((2 * delta + 1) * step) >> 3
    predictor = predictor - diff if sign else predictor + diff
    predictor = min(max(predictor, -32768), 32767)
    return predictor, new_index


def decode_chunk(chunk: bytes) -> np.ndarray:
    """Decode one '01wb' payload to int16 PCM (adpcm.c:1268-1290).

    Note the reference decodes every nibble byte present, ignoring the
    header's sample count (it only skips those 4 bytes).
    """
    if len(chunk) < 8:
        return np.zeros(0, dtype=np.int16)
    predictor = struct.unpack_from("<h", chunk, 0)[0]
    step_index = struct.unpack_from("<H", chunk, 2)[0]
    step_index = min(max(step_index, 0), 88)
    data = np.frombuffer(chunk, dtype=np.uint8)[8:]
    out = np.empty(2 * len(data), dtype=np.int16)
    p, s = int(predictor), int(step_index)
    k = 0
    for byte in data:
        b = int(byte)
        # AMV: high nibble first (FFSWAP at adpcm.c:1281-1282)
        for nib in ((b >> 4) & 0xF, b & 0xF):
            p, s = expand_nibble(p, s, nib)
            out[k] = p
            k += 1
    return out


def compress_sample(prev_sample: int, step_index: int, sample: int):
    """adpcm_ima_compress_sample (adpcm.c:219-227)."""
    step = int(STEP_TABLE[step_index])
    delta = sample - prev_sample
    nibble = min(7, abs(delta) * 4 // step) + (8 if delta < 0 else 0)
    # C integer division truncates toward zero; both operands' product sign
    # handled via int(); YAMAHA_DIFFLOOKUP gives +/- odd values.
    recon = step * int(YAMAHA_DIFFLOOKUP[nibble])
    recon = recon // 8 if recon >= 0 else -((-recon) // 8)
    prev_sample = prev_sample + recon
    prev_sample = min(max(prev_sample, -32768), 32767)
    step_index = min(max(step_index + int(INDEX_TABLE[nibble]), 0), 88)
    return nibble, prev_sample, step_index


def chunk_lengths(total_samples: int, frame_size: int, sample_rate: int):
    """Per-chunk sample-pair counts n, replicating adpcm_encode_frame's
    scheduling (adpcm.c:466-478): n = frame_size>>1 plus the odd-frame carry,
    plus second-boundary padding.

    Returns a list of n values (each chunk encodes 2n samples).  The list
    covers ceil-enough chunks to consume total_samples (the last chunk may
    read past the end; callers pad the input with zeros as the reference's
    buffer reuse effectively does).
    """
    ns = []
    samples_written = 0
    extra = 0
    consumed = 0
    while consumed < total_samples:
        n = frame_size >> 1
        extra += frame_size & 1
        n += extra >> 1
        extra &= 1
        i = (samples_written + 2 * n) % sample_rate
        if i and i + frame_size > sample_rate:
            n += (sample_rate - i) >> 1
        ns.append(n)
        samples_written += 2 * n
        consumed += 2 * n
    return ns


def encode(samples: np.ndarray, frame_size: int, sample_rate: int,
           init_step_index: int = 0):
    """Encode a whole PCM stream into AMV audio chunks.

    Returns list[bytes] ('01wb' payloads).  Chunk segmentation follows
    adpcm.c:461-478; the codec state step_index persists across chunks while
    prev_sample is reset to the chunk's first input sample (adpcm.c:464).

    Deviation from the reference noted for the record: when padding makes a
    chunk consume more than frame_size samples, the reference encoder reads
    past its per-call input buffer (stale fifo memory).  We instead consume
    the continuing stream, which keeps the bitstream self-consistent; chunk
    sizes and sample counts still match the reference exactly.
    """
    samples = np.asarray(samples, dtype=np.int16)
    ns = chunk_lengths(len(samples), frame_size, sample_rate)
    total = 2 * sum(ns)
    padded = np.zeros(total, dtype=np.int16)
    padded[:len(samples)] = samples
    chunks = []
    step_index = init_step_index
    pos = 0
    for n in ns:
        first = int(padded[pos])
        header = struct.pack("<hHI", first, step_index, (n << 1) & 0xFFFFFFFF)
        prev = first
        out = bytearray()
        for k in range(n):
            nib_hi, prev, step_index = compress_sample(
                prev, step_index, int(padded[pos + 2 * k]))
            nib_lo, prev, step_index = compress_sample(
                prev, step_index, int(padded[pos + 2 * k + 1]))
            out.append(((nib_hi << 4) | (nib_lo & 0xF)) & 0xFF)
        chunks.append(header + bytes(out))
        pos += 2 * n
    return chunks
