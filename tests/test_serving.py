"""AsyncTranscoder (pipeline/serving.py): fixed-shape batched serving.

Byte contract: for any payload stream, the served output must equal the
host re-encode payload-for-payload, in input order, across batch
boundaries, partial final batches (pad frames dropped) and batches
whose scan rows need column padding up to the compiled width.  Tiny
shapes on the CPU; the core test covers order restore, batch split,
frame padding and column padding in ONE compiled shape."""
import numpy as np
import pytest

from amv_tpu.bitstream.entropy import (huffman_decode_frames,
                                       huffman_encode_frame)
from amv_tpu.pipeline.serving import AsyncTranscoder, batch_frames_for

W, H = 32, 48  # 2x3 MCUs: a tiny MB-aligned geometry
M = 6


def _payloads(F, seed=7, spread=True):
    """Synthetic valid scans with strongly varying lengths (the serving
    path length-sorts within each batch and must restore order)."""
    rng = np.random.default_rng(seed)
    lv = np.zeros((F, M, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-30, 60, (F, M, 6))
    lv[..., 1] = rng.integers(-8, 8, (F, M, 6))
    lv[:, :, :, 9] = rng.integers(-4, 4, (F, M, 6))
    if spread:
        lv[: F // 3, 1:] = 0          # short frames
        lv[F // 3: F // 2, :, :, 20] = 25   # long frames
    return [huffman_encode_frame(lv[f]) for f in range(F)]


def _want(payloads, qscale=2):
    import jax.numpy as jnp
    from amv_tpu.pipeline.transcode import transcode_levels_fused
    lv = huffman_decode_frames(payloads, M)
    lv2 = np.asarray(transcode_levels_fused(jnp.asarray(lv), qscale)[0])
    return [huffman_encode_frame(lv2[f]) for f in range(len(payloads))]


def test_serving_matches_host_reencode_across_batches():
    # 20 frames shortest-first / batch_frames=8 -> two full batches +
    # one partial (pad frames dropped).  Shortest-first means batch 1
    # holds only short scans: its unescape stride is narrower than the
    # global w_bytes, so the column-padding path is exercised; the
    # within-batch length sort + inverse covers order restoration.
    pays = sorted(_payloads(20), key=len)
    tr = AsyncTranscoder(W, H, batch_frames=8, depth=2)
    got = tr.transcode(pays)
    assert got == _want(pays)


def test_serving_lazy_width_guard():
    # lazy w_bytes from batch 1 must reject a later, wider batch with a
    # clear error; the chain itself is stubbed out (the guard runs
    # before it and interpret evals cost minutes)
    pays = sorted(_payloads(16, seed=11), key=len)
    tr = AsyncTranscoder(W, H, batch_frames=8, depth=2)
    tr._chain = _rejecting_chain(tr)
    with pytest.raises(ValueError, match="row width"):
        list(tr.stream(pays))


def _rejecting_chain(tr):
    """A stand-in device chain whose every frame comes back not ok."""
    def chain(rows):
        n = tr.batch_frames
        return (np.zeros((n, 8), np.uint8), np.zeros(n, np.int32),
                np.zeros(n, bool))
    return chain


def test_serving_host_fallback_bit_exact():
    # frames the chain rejects are re-encoded on the host, bit-exact, in
    # order, and counted
    from amv_tpu import backend
    pays = _payloads(5, seed=3)
    tr = AsyncTranscoder(W, H, batch_frames=8)
    tr._chain = _rejecting_chain(tr)
    before = backend.host_fallbacks["transcode"]
    assert tr.transcode(pays) == _want(pays)
    assert backend.host_fallbacks["transcode"] - before == len(pays)


def test_serving_sharded_mesh_matches_host():
    # frames shard over a 2-device mesh inside one served batch
    import jax
    from amv_tpu.parallel.sharding import make_mesh
    mesh = make_mesh(jax.devices()[:2])
    pays = _payloads(8, seed=9)
    tr = AsyncTranscoder(W, H, batch_frames=8, depth=2, mesh=mesh)
    assert tr.transcode(pays) == _want(pays)


def test_serving_mesh_batch_divisibility():
    import jax
    from amv_tpu.parallel.sharding import make_mesh
    mesh = make_mesh(jax.devices()[:2])
    with pytest.raises(ValueError, match="mesh.size"):
        AsyncTranscoder(W, H, batch_frames=7, mesh=mesh)


@pytest.mark.parametrize("n,w,h,want", [
    (0, 32, 48, 1), (1, 160, 120, 1), (5, 160, 120, 8),
    (3840, 160, 120, 4096), (75000, 160, 120, 4096),
    (960, 320, 240, 1024), (20000, 320, 240, 1024), (500, 1920, 1088, 64)])
def test_batch_frames_for(n, w, h, want):
    # next power of two of the frame count, capped at BATCH_MCUS
    # macroblocks so device memory does not grow with file length
    assert batch_frames_for(n, w, h) == want
