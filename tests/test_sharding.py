"""Multi-device sharding on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax

from amv_tpu.parallel.sharding import (make_mesh, sharded_decode_step,
                                       sharded_encode_step,
                                       sharded_adpcm_decode)


@pytest.fixture(scope="module")
def mesh():
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    return make_mesh(jax.devices()[:8])


def test_mesh_shape(mesh):
    # frames are independent, so the mesh is 1-D over frames
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("dp",)


def test_sharded_video_roundtrip_matches_single(mesh):
    from amv_tpu.codecs.amv_video import decode_transform, encode_transform
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    F, M = 8, 80  # 160x120
    levels = rng.integers(-32, 32, (F, M, 6, 64)).astype(np.int16)
    dec = sharded_decode_step(mesh, 10, 8, 160, 120)
    y, cb, cr = dec(jnp.asarray(levels))
    y1, cb1, cr1 = decode_transform(jnp.asarray(levels), 10, 8, 160, 120)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y1))
    enc = sharded_encode_step(mesh, 10, 8)
    lv = enc(y, cb, cr)
    lv1 = encode_transform(y1, cb1, cr1, 10, 8)
    np.testing.assert_array_equal(np.asarray(lv), np.asarray(lv1))


def test_sharded_adpcm_matches_single(mesh):
    import jax.numpy as jnp
    from amv_tpu.kernels.adpcm import decode_chunks
    rng = np.random.default_rng(4)
    C, L = 16, 64
    payload = rng.integers(0, 256, (C, L)).astype(np.uint8)
    pred = rng.integers(-1000, 1000, C).astype(np.int32)
    sidx = rng.integers(0, 89, C).astype(np.int32)
    fn = sharded_adpcm_decode(mesh)
    got = np.asarray(fn(jnp.asarray(payload), jnp.asarray(pred),
                        jnp.asarray(sidx)))
    want = np.asarray(decode_chunks(jnp.asarray(payload), jnp.asarray(pred),
                                    jnp.asarray(sidx)))
    np.testing.assert_array_equal(got, want)


def test_sharded_adpcm_encode_matches_single(mesh):
    import jax.numpy as jnp
    from amv_tpu.kernels.adpcm import encode_samples
    from amv_tpu.parallel.sharding import sharded_adpcm_encode
    rng = np.random.default_rng(5)
    B, n = 8, 128
    samples = rng.integers(-20000, 20000, (B, n)).astype(np.int32)
    reset = np.zeros((B, n), bool)
    reset[:, 0] = True
    sidx0 = rng.integers(0, 89, B).astype(np.int32)
    fn = sharded_adpcm_encode(mesh)
    got = fn(jnp.asarray(samples), jnp.asarray(reset), jnp.asarray(sidx0))
    want = encode_samples(jnp.asarray(samples), jnp.asarray(reset),
                          jnp.asarray(sidx0))
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))


def test_sharded_g729_chain_matches_single(mesh):
    import jax.numpy as jnp
    from amv_tpu.codecs import g729a
    from amv_tpu.parallel.sharding import sharded_g729_decode_chain
    from test_g729 import make_frame
    rng = np.random.default_rng(6)
    T, B = 8, 8
    frames = np.zeros((T, B, 10), np.uint8)
    for t in range(T):
        for b in range(B):
            frames[t, b] = np.frombuffer(make_frame(rng), np.uint8)
    want = g729a.decode_streams(frames)          # [B, T*80]
    parms = jnp.asarray(g729a.unpack_frames(frames))
    fn = sharded_g729_decode_chain(mesh)
    st, pcm = fn(g729a.init_state(B), parms)     # pcm [T, B, 80]
    got = np.asarray(pcm).transpose(1, 0, 2).reshape(B, T * 80)
    np.testing.assert_array_equal(got, np.asarray(want))


def _scan_rows(seed, F=16, M=2):
    from amv_tpu.bitstream.entropy import huffman_encode_frame
    from amv_tpu.pipeline.transcode import unescape_sorted
    rng = np.random.default_rng(seed)
    lv = np.zeros((F, M, 6, 64), np.int16)
    lv[..., 0] = rng.integers(-8, 48, (F, M, 6))
    lv[..., 1] = rng.integers(-4, 4, (F, M, 6))
    payloads = [huffman_encode_frame(lv[f]) for f in range(F)]
    rows, inv = unescape_sorted(payloads)
    return payloads, rows, inv


def test_sharded_complete_transcode_matches_single(mesh):
    """The complete device chain (Huffman decode + transform + Huffman
    encode with framing) sharded over the mesh equals the single-device
    run and the host re-encode payloads."""
    import jax.numpy as jnp
    from amv_tpu.parallel.sharding import sharded_transcode_scans
    from amv_tpu.pipeline.transcode import (host_reencode, out_bytes_bound,
                                            transcode_scans)
    payloads, rows, inv = _scan_rows(11)
    kw = dict(width=32, height=16, max_bytes=out_bytes_bound(rows.shape[1]))
    got = sharded_transcode_scans(mesh, **kw)(jnp.asarray(rows))
    want = transcode_scans(jnp.asarray(rows), **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    payload, lens, ok = (np.asarray(a)[inv] for a in got)
    assert ok.all()
    assert ([payload[f, :lens[f]].tobytes() for f in range(len(payloads))]
            == host_reencode(payloads, 32, 16))


def test_sharded_decode_scans_matches_single(mesh):
    import jax.numpy as jnp
    from amv_tpu.kernels.entropy_decode import decode_scans_device
    from amv_tpu.parallel.sharding import sharded_entropy_decode
    _, rows, _ = _scan_rows(12)
    got = sharded_entropy_decode(mesh, 2)(jnp.asarray(rows))
    want = decode_scans_device(jnp.asarray(rows), 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_g729_encoder_matches_single(mesh):
    """The batched device G.729A encoder frame step sharded on dp must emit
    the same parameters (and state) as the unsharded step."""
    import jax.numpy as jnp
    from amv_tpu.codecs import g729a
    from amv_tpu.codecs.g729a_encoder_tpu import encode_frame_batch
    from amv_tpu.parallel.sharding import sharded_g729_encode_step
    rng = np.random.default_rng(11)
    B = 8
    sig = (3000 * rng.standard_normal((B, 80))).astype(np.float32)
    st0 = g729a.init_state(B)
    hist0 = jnp.zeros((B, 160))
    st_w, hist_w, parm_w = encode_frame_batch(st0, hist0, jnp.asarray(sig))
    fn = sharded_g729_encode_step(mesh)
    st_g, hist_g, parm_g = fn(g729a.init_state(B), jnp.zeros((B, 160)),
                              jnp.asarray(sig))
    np.testing.assert_array_equal(np.asarray(parm_g), np.asarray(parm_w))
    np.testing.assert_array_equal(np.asarray(st_g["exc"]),
                                  np.asarray(st_w["exc"]))
    np.testing.assert_array_equal(np.asarray(hist_g), np.asarray(hist_w))
