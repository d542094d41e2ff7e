"""AMV IMA-ADPCM audio codec orchestration (host framing, device kernels
chosen by amv_tpu.backend).

Chunk framing follows AMVmuxer/ffmpeg/libavcodec/adpcm.c:
* decode: each '01wb' payload = {le16 predictor, le16 step_index,
  le32 sample_count} + packed nibbles, high nibble first (adpcm.c:1268-1290);
* encode: chunk scheduling with odd-frame carry and second-boundary padding
  (adpcm.c:461-496), step_index carried across chunks, prev_sample reset to
  each chunk's first input sample.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from .. import backend
from ..kernels import adpcm as K
from ..verify.ref_adpcm import chunk_lengths


def decode_chunks(chunks: list[bytes]) -> np.ndarray:
    """Decode '01wb' payloads to one contiguous int16 PCM stream.

    All chunks decode in a single batched device dispatch (they are
    independent: the header resets the codec state per chunk).
    Like the reference decoder, every nibble byte present is decoded; the
    header's sample count is ignored (adpcm.c:1272-1274 just skips it).
    """
    if not chunks:
        return np.zeros(0, dtype=np.int16)
    n = len(chunks)
    lens = np.array([max(len(c) - 8, 0) for c in chunks], dtype=np.int64)
    max_len = int(lens.max())
    payload = np.zeros((n, max_len), dtype=np.uint8)
    pred = np.zeros(n, dtype=np.int32)
    sidx = np.zeros(n, dtype=np.int32)
    for i, c in enumerate(chunks):
        if len(c) < 8:
            continue
        pred[i] = struct.unpack_from("<h", c, 0)[0]
        sidx[i] = min(max(struct.unpack_from("<H", c, 2)[0], 0), 88)
        payload[i, :lens[i]] = np.frombuffer(c, dtype=np.uint8)[8:]
    pcm = np.asarray(K.decode_chunks(
        jnp.asarray(payload), jnp.asarray(pred), jnp.asarray(sidx)))
    return np.concatenate([pcm[i, :2 * lens[i]] for i in range(n)])


def encode_stream(samples: np.ndarray, frame_size: int,
                  sample_rate: int = 22050,
                  init_step_index: int = 0,
                  trellis: bool = False) -> list[bytes]:
    """Encode an int16 PCM stream into AMV '01wb' chunk payloads.

    One device pass over the whole stream (the quantizer feedback makes
    the recurrence sequential, and the step index carries across chunks);
    chunk boundaries and headers are data-independent and assembled on
    host.

    trellis=True uses the Viterbi quantizer (the reference's `-trellis`
    feature, adpcm.c:287-443 equivalent) for lower distortion.
    """
    samples = np.asarray(samples, dtype=np.int16)
    if trellis:
        return _encode_stream_trellis(samples, frame_size, sample_rate,
                                      init_step_index)
    ns = chunk_lengths(len(samples), frame_size, sample_rate)
    total = 2 * sum(ns)
    padded = np.zeros(total, dtype=np.int32)
    padded[:len(samples)] = samples
    starts = np.zeros(len(ns), dtype=np.int64)
    np.cumsum(np.asarray(ns[:-1]) * 2, out=starts[1:])
    reset = np.zeros(total, dtype=bool)
    reset[starts] = True

    nibbles, sidx_before = backend.adpcm_encoder()(
        jnp.asarray(padded[None, :]), jnp.asarray(reset[None, :]),
        jnp.asarray([init_step_index], dtype=jnp.int32))
    nibbles = np.asarray(nibbles[0])
    sidx_before = np.asarray(sidx_before[0])

    packed = K.nibbles_to_bytes(nibbles)
    chunks = []
    for k, n in enumerate(ns):
        s = int(starts[k])
        header = struct.pack("<hHI", int(padded[s]), int(sidx_before[s]),
                             (n << 1) & 0xFFFFFFFF)
        chunks.append(header + packed[s // 2: s // 2 + n].tobytes())
    return chunks


def _encode_stream_trellis(samples: np.ndarray, frame_size: int,
                           sample_rate: int, init_step_index: int):
    from .adpcm_trellis import trellis_encode_fast
    ns = chunk_lengths(len(samples), frame_size, sample_rate)
    total = 2 * sum(ns)
    padded = np.zeros(total, dtype=np.int16)
    padded[:len(samples)] = samples
    chunks = []
    step_index = init_step_index
    pos = 0
    for n in ns:
        seg = padded[pos:pos + 2 * n]
        first = int(seg[0])
        start_step = step_index  # the decoder seeds from the chunk header
        nibbles, step_index = trellis_encode_fast(seg, start_step,
                                                  init_predictor=first)
        header = struct.pack("<hHI", first, start_step, (n << 1) & 0xFFFFFFFF)
        chunks.append(header + K.nibbles_to_bytes(nibbles).tobytes())
        pos += 2 * n
    return chunks
