"""Device-resident transcode pipeline."""

import numpy as np
import pytest

from amv_tpu.containers import riff
from amv_tpu.pipeline.transcode import transcode_bytes
from amv_tpu.pipeline.decode import decode_bytes


def test_transcode_device_corpus(sample_amv_bytes):
    out = transcode_bytes(sample_amv_bytes)
    s_in = riff.demux(sample_amv_bytes)
    s_out = riff.demux(out)
    assert len(s_out.video_chunks) == len(s_in.video_chunks)
    assert s_out.audio_chunks == s_in.audio_chunks  # pass-through
    # re-encoded video still decodes and matches the source decode closely
    d_in = decode_bytes(sample_amv_bytes, audio=False, max_frames=6)
    d_out = decode_bytes(out, audio=False, max_frames=6)
    c = np.corrcoef(d_in.y.astype(float).ravel(),
                    d_out.y.astype(float).ravel())[0, 1]
    # one generation of the reference's asymmetric encode(MPEG1 matrix)/
    # decode(Q60) quantization costs fidelity; the seeded clip's noise
    # texture is what it loses most (0.72 on this clip)
    assert c > 0.65
    # byte oracle: the C reference decoder + encoder at qscale 2
    from amv_tpu.native import entropy_native as native
    want = [native.ref_encode_frame(
        *native.ref_decode_frame(p, s_in.info.width, s_in.info.height), 2)
        for p in s_in.video_chunks]
    assert s_out.video_chunks == want


def test_transcode_bytes_in_bounded_batches(sample_amv_bytes, monkeypatch):
    """A file longer than one batch goes through several fixed-shape
    batches (pad frames dropped) and still equals the C oracle."""
    from amv_tpu.native import entropy_native as native
    from amv_tpu.pipeline import serving
    s_in = riff.demux(sample_amv_bytes)
    w, h = s_in.info.width, s_in.info.height
    n_mcu = ((w + 15) // 16) * ((h + 15) // 16)
    monkeypatch.setattr(serving, "BATCH_MCUS", 32 * n_mcu)
    assert serving.batch_frames_for(len(s_in.video_chunks), w, h) == 32
    assert len(s_in.video_chunks) % 32
    s_out = riff.demux(transcode_bytes(sample_amv_bytes))
    assert s_out.video_chunks == [native.ref_encode_frame(
        *native.ref_decode_frame(p, w, h), 2) for p in s_in.video_chunks]
