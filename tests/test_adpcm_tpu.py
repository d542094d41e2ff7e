"""Device ADPCM kernels vs the scalar oracle: bit-exact."""

import numpy as np
import pytest

from amv_tpu.codecs import amv_audio
from amv_tpu.containers import riff
from amv_tpu.verify import ref_adpcm


def test_decode_bit_exact_random():
    rng = np.random.default_rng(42)
    chunks = []
    for i in range(7):
        n = int(rng.integers(4, 700))
        header = (int(rng.integers(-30000, 30000)).to_bytes(2, "little", signed=True)
                  + int(rng.integers(0, 89)).to_bytes(2, "little")
                  + (2 * n).to_bytes(4, "little"))
        chunks.append(header + rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    got = amv_audio.decode_chunks(chunks)
    want = np.concatenate([ref_adpcm.decode_chunk(c) for c in chunks])
    np.testing.assert_array_equal(got, want)


def test_decode_bit_exact_device_corpus(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    got = amv_audio.decode_chunks(s.audio_chunks)
    want = np.concatenate([ref_adpcm.decode_chunk(c) for c in s.audio_chunks])
    np.testing.assert_array_equal(got, want)


def test_decode_clamp_stress():
    # force predictor clamping: long runs of max-magnitude nibbles
    header = (0).to_bytes(2, "little", signed=True) + (88).to_bytes(2, "little") \
        + (400).to_bytes(4, "little")
    data = bytes([0x77] * 100 + [0xFF] * 100)  # big + then big -
    chunk = header + data
    got = amv_audio.decode_chunks([chunk])
    want = ref_adpcm.decode_chunk(chunk)
    np.testing.assert_array_equal(got, want)


def test_encode_bit_exact():
    rng = np.random.default_rng(3)
    t = np.arange(50000)
    sig = (6000 * np.sin(2 * np.pi * 300 * t / 22050)
           + 1500 * rng.standard_normal(len(t))).astype(np.int16)
    got = amv_audio.encode_stream(sig, frame_size=1378, sample_rate=22050)
    want = ref_adpcm.encode(sig, frame_size=1378, sample_rate=22050)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def test_encode_odd_frame_size():
    sig = (1000 * np.sin(np.arange(30000) / 5.0)).astype(np.int16)
    got = amv_audio.encode_stream(sig, frame_size=1333, sample_rate=16000)
    want = ref_adpcm.encode(sig, frame_size=1333, sample_rate=16000)
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        assert g == w


def _random_chunks(rng, n_chunks, max_bytes=400):
    payload = rng.integers(0, 256, (n_chunks, max_bytes)).astype(np.uint8)
    pred = rng.integers(-32768, 32768, n_chunks).astype(np.int32)
    sidx = rng.integers(0, 89, n_chunks).astype(np.int32)
    return payload, pred, sidx


@pytest.mark.parametrize("method", ["scan", "associative"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_methods_match_oracle(method, seed):
    """Both plain-JAX decode forms (the per-sample reference scan and the
    log-depth associative scan that decode_chunks runs) equal the scalar
    oracle chunk by chunk."""
    import jax.numpy as jnp
    from amv_tpu.kernels.adpcm import (bytes_to_nibbles, decode_chunks,
                                       decode_nibbles_scan)
    import struct
    rng = np.random.default_rng(seed)
    payload, pred, sidx = (jnp.asarray(a) for a in _random_chunks(rng, 5, 300))
    if method == "scan":
        got = decode_nibbles_scan(bytes_to_nibbles(payload), pred, sidx)
    else:
        got = decode_chunks(payload, pred, sidx)
    got = np.asarray(got)
    for c in range(5):
        chunk = (struct.pack("<hHI", int(pred[c]), int(sidx[c]), 600)
                 + np.asarray(payload[c]).tobytes())
        np.testing.assert_array_equal(got[c], ref_adpcm.decode_chunk(chunk))


def _encode_case(rng, B, n, n_resets):
    samples = rng.integers(-32768, 32768, (B, n)).astype(np.int32)
    samples[:, n // 2:] //= 64                     # quiet second half
    reset = np.zeros((B, n), bool)
    reset[:, 0] = True
    reset[:, rng.integers(1, n, n_resets)] = True
    sidx0 = rng.integers(0, 89, B).astype(np.int32)
    return samples, reset, sidx0


@pytest.mark.parametrize("B,n,n_resets", [(1, 97, 0), (3, 200, 4),
                                          (33, 64, 2)])
def test_triton_encoder_interpret_matches_scan(B, n, n_resets):
    """The Pallas (Triton route) ADPCM encoder in interpret mode equals
    the plain lax.scan encoder, nibbles and step indices, including lane
    padding past 32 streams and chunk-start resets."""
    import jax.numpy as jnp
    from amv_tpu.kernels.adpcm import encode_samples
    from amv_tpu.kernels.adpcm_encode_triton import encode_samples_triton
    args = [jnp.asarray(a) for a in
            _encode_case(np.random.default_rng(B * n), B, n, n_resets)]
    got = encode_samples_triton(*args, interpret=True)
    want = encode_samples(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.gpu
def test_triton_encoder_compiled_matches_scan():
    """The compiled kernel on the card equals the plain encoder."""
    import jax.numpy as jnp
    from amv_tpu.kernels.adpcm import encode_samples
    from amv_tpu.kernels.adpcm_encode_triton import encode_samples_triton
    args = [jnp.asarray(a) for a in
            _encode_case(np.random.default_rng(5), 40, 4096, 6)]
    for g, w in zip(encode_samples_triton(*args), encode_samples(*args)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
