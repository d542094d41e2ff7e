"""Seeded AMV library clips, made in-process from a seed.

The tests, ``chip_smoke.py`` and the fuzz soak read this corpus instead
of a device file: moving-gradient video with a seeded texture (so frame
lengths vary the way a real library's do) is encoded by the C reference
encoder (native.ref_encode_frame), the audio by the scalar ADPCM oracle
(verify/ref_adpcm.encode), and both are muxed by containers.riff.  None
of the code under test makes a byte of it.
"""

from __future__ import annotations

import numpy as np

from . import fixtures, ref_adpcm


def planes(frames: int, width: int, height: int, seed: int = 0):
    """YUV420 planes uint8 [F, H, W], [F, H/2, W/2] x 2: a drifting
    gradient over a seeded texture that scrolls one pixel per frame and
    fades in and out, so frame lengths vary by about 2x."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    tex = rng.integers(-12, 12, (height, 2 * width))
    ctex = rng.integers(-8, 8, (height // 2, width))
    y = np.empty((frames, height, width), np.uint8)
    cb = np.empty((frames, height // 2, width // 2), np.uint8)
    cr = np.empty_like(cb)
    for f in range(frames):
        g = 128 + 70 * np.sin(xx / 7.0 + 0.3 * f) * np.cos(yy / 9.0 - 0.2 * f)
        s = f % width
        a = 0.2 + 0.8 * (0.5 + 0.5 * np.sin(f / 7.0))
        y[f] = np.clip(g + a * tex[:, s:s + width], 0, 255)
        c = ctex[:, s // 2:s // 2 + width // 2]
        cb[f] = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 11.0 - 0.1 * f) + c,
                        0, 255)
        cr[f] = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 10.0 + 0.1 * f) - c,
                        0, 255)
    return y, cb, cr


def library_clip(width: int = 128, height: int = 96, fps: int = 12,
                 seconds: float = 4.0, sample_rate: int = 16000,
                 seed: int = 0, qscale: int = 2) -> bytes:
    """A complete .amv file: int(seconds * fps) frames of `planes`, and
    mono IMA-ADPCM audio chunked the way the reference encoder chunks it
    (one chunk per video frame)."""
    from ..containers import riff
    from ..native import entropy_native as native
    from ..pipeline.encode import av_rescale_near

    n = int(round(seconds * fps))
    y, cb, cr = planes(n, width, height, seed)
    video = [native.ref_encode_frame(y[f], cb[f], cr[f], qscale)
             for f in range(n)]
    pcm = fixtures.audiogen(seconds, sample_rate, seed=seed)
    audio = ref_adpcm.encode(pcm, av_rescale_near(sample_rate, 1, fps),
                             sample_rate)[:n]
    return riff.mux(video, audio, width=width, height=height, fps=fps,
                    sample_rate=sample_rate)


_PARITY_MAGIC = 0x6996966996696996


def g729_frames(n: int, seed: int = 0) -> np.ndarray:
    """n random G.729A frames (uint8 [n, 10]) with every parameter drawn
    from its legal range and a passing pitch parity bit: valid dictation
    bitstreams that drive every decoder path."""
    rng = np.random.default_rng(seed)
    widths = (1, 7, 5, 5, 8, 1, 13, 4, 3, 4, 5, 13, 4, 3, 4)
    vals = [rng.integers(0, 1 << w, n) for w in widths]
    vals[4] = rng.integers(60, 197, n)                 # P1: in-range delay
    vals[5] = ((_PARITY_MAGIC >> (vals[4] >> 2)) & 1) ^ 1
    word = np.zeros(n, object)
    for v, w in zip(vals, widths):
        word = (word << w) | v.astype(object)
    return np.array([int(x).to_bytes(10, "big") for x in word],
                    dtype="S10").view(np.uint8).reshape(n, 10)
