"""WAV import/export (amvlib's AmvCreateWavFileFromAmvFile parity).

Reference: C-AMVDecoder/amvlib/AMVDec.c:384-547 — exports either decoded
s16 PCM or the raw ADPCM stream (wFormatTag=0x11 with a `fact` chunk).
"""

from __future__ import annotations

import struct

import numpy as np


def write_pcm(path: str, pcm: np.ndarray, sample_rate: int, channels: int = 1):
    pcm = np.asarray(pcm, dtype="<i2")
    data = pcm.tobytes()
    block_align = 2 * channels
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                 sample_rate * block_align, block_align, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def write_adpcm_raw(path: str, chunks: list[bytes], sample_rate: int,
                    channels: int = 1):
    """Raw IMA-ADPCM WAV with fact header (AMVDec.c:447-530 layout)."""
    data = b"".join(chunks)
    total_samples = sum(
        struct.unpack_from("<I", c, 4)[0] for c in chunks if len(c) >= 8)
    block_align = 2 * channels
    hdr = b"RIFF" + struct.pack("<I", 4 + 26 + 12 + 8 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHHHH", 18, 0x11, channels, sample_rate,
                                 sample_rate // 2, block_align, 4, 0, 0)
    hdr += b"fact" + struct.pack("<II", 4, total_samples)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def read_pcm(path: str):
    """WAV reader -> (pcm int16 [n] or [n, ch], rate).

    Decodes the audio formats the reference's WAV/AVI ingest accepts:
    PCM u8/s16/s24/s32, A-law, mu-law (pcm.c:380-470), IMA-ADPCM-WAV
    (tag 0x11) and MS-ADPCM (tag 0x02) blocks (adpcm.c:983-1106) via
    `codecs/wav_audio.py` (batched device block decode)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a WAV file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        tag = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:pos + 8 + size]
        if tag == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif tag == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("missing fmt/data chunk")
    audio_fmt, channels, rate, _, block_align, bits = fmt
    if channels < 1:
        raise ValueError("WAV fmt declares zero channels")
    if audio_fmt == 1 and bits == 16:
        samples = np.frombuffer(pcm[:len(pcm) & ~1], dtype="<i2")
        n = len(samples) // channels * channels
        samples = samples[:n]
        if channels > 1:
            samples = samples.reshape(-1, channels)
        return samples, rate
    from ..codecs.wav_audio import decode_pcm_bytes
    return decode_pcm_bytes(pcm, audio_fmt, bits, channels,
                            block_align), rate
