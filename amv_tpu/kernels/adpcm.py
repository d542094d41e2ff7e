"""IMA-ADPCM (AMV flavor) kernels in plain JAX.

Decode is reformulated from the reference's sequential per-sample loop
(AMVmuxer/ffmpeg/libavcodec/adpcm.c:716-740, 1268-1290) into two
*associative* scans, because both recurrences are clipped additions:

    step_index_t = clip(step_index_{t-1} + index_table[nib_t], 0, 88)
    predictor_t  = clip(predictor_{t-1} +/- diff_t, -32768, 32767)

Maps of the form x -> min(max(x + a, lo), hi) are closed under composition:

    (m2 . m1)(x) = min(max(x + (a1+a2), min(max(lo1+a2, lo2), hi2)),
                                        min(max(hi1+a2, lo2), hi2))

so `jax.lax.associative_scan` computes every prefix state in O(log n)
depth, fully parallel across samples AND across chunks.  diff_t depends
only on the step_index chain (not the predictor), which is what decouples
the two scans.  The result is bit-exact with the reference decoder.

`decode_chunks` and the IMA-WAV decoder (codecs/wav_audio.py) run this
associative form on every platform.  `decode_nibbles_scan` is the
sequential per-sample form of the same recurrence, kept as the reference
the tests compare against (PERF.md records both timed on the GPU).

Chunks are independent by construction (each '01wb' chunk header carries
its own {predictor, step_index}), so the batch dimension is free
parallelism; multi-chip sharding shards the chunk axis.

Encode (adpcm.c:219-227) has feedback through the quantizer, so it stays a
`lax.scan`, batched across independent streams (the GPU runs the same
recurrence as a Pallas kernel, adpcm_encode_triton.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..verify.ref_adpcm import INDEX_TABLE, STEP_TABLE, YAMAHA_DIFFLOOKUP

_INDEX_TABLE = jnp.asarray(INDEX_TABLE, dtype=jnp.int32)
_STEP_TABLE = jnp.asarray(STEP_TABLE, dtype=jnp.int32)
_DIFFLOOKUP = jnp.asarray(YAMAHA_DIFFLOOKUP, dtype=jnp.int32)


def _compose_clipped_add(f, g):
    """Compose clipped-add maps: returns g∘f applied element-wise.

    f, g are (a, lo, hi) tuples of equal-shaped int32 arrays, where a map is
    m(x) = min(max(x + a, lo), hi).  associative_scan composes left-to-right,
    so (f, g) -> apply f first, then g.
    """
    a1, lo1, hi1 = f
    a2, lo2, hi2 = g
    a = a1 + a2
    lo = jnp.clip(lo1 + a2, lo2, hi2)
    hi = jnp.clip(hi1 + a2, lo2, hi2)
    return a, lo, hi


@partial(jax.jit, static_argnames=())
def decode_nibbles(nibbles: jnp.ndarray, init_predictor: jnp.ndarray,
                   init_step_index: jnp.ndarray) -> jnp.ndarray:
    """Decode IMA-ADPCM nibbles to int16 PCM, fully parallel.

    nibbles:        int32 [n_chunks, n_samples] (already in decode order,
                    i.e. high nibble of each byte first for AMV)
    init_predictor: int32 [n_chunks]
    init_step_index:int32 [n_chunks]
    returns:        int16 [n_chunks, n_samples]
    """
    n_chunks, n = nibbles.shape

    # --- scan 1: step_index chain -----------------------------------------
    deltas = jnp.take(_INDEX_TABLE, nibbles, axis=0)
    lo = jnp.zeros_like(deltas)
    hi = jnp.full_like(deltas, 88)
    a_c, lo_c, hi_c = jax.lax.associative_scan(
        _compose_clipped_add, (deltas, lo, hi), axis=1)
    # state AFTER sample t:
    s_after = jnp.clip(init_step_index[:, None] + a_c, lo_c, hi_c)
    # step used by sample t is the state BEFORE t:
    s_before = jnp.concatenate(
        [init_step_index[:, None], s_after[:, :-1]], axis=1)

    # --- per-sample signed difference --------------------------------------
    step = jnp.take(_STEP_TABLE, s_before, axis=0)
    delta = nibbles & 7
    diff = ((2 * delta + 1) * step) >> 3
    signed_diff = jnp.where((nibbles & 8) != 0, -diff, diff)

    # --- scan 2: clamped predictor chain ------------------------------------
    lo = jnp.full_like(signed_diff, -32768)
    hi = jnp.full_like(signed_diff, 32767)
    a_c, lo_c, hi_c = jax.lax.associative_scan(
        _compose_clipped_add, (signed_diff, lo, hi), axis=1)
    pred = jnp.clip(init_predictor[:, None] + a_c, lo_c, hi_c)
    return pred.astype(jnp.int16)


def bytes_to_nibbles(data: jnp.ndarray) -> jnp.ndarray:
    """uint8 [..., n_bytes] -> int32 [..., 2*n_bytes], high nibble first
    (the AMV order, adpcm.c:1281-1282)."""
    d = data.astype(jnp.int32)
    hi = (d >> 4) & 0xF
    lo = d & 0xF
    return jnp.stack([hi, lo], axis=-1).reshape(*d.shape[:-1], -1)


@jax.jit
def decode_chunks(payload: jnp.ndarray, init_predictor: jnp.ndarray,
                  init_step_index: jnp.ndarray) -> jnp.ndarray:
    """Decode a batch of equal-padded chunks with the associative scan.

    payload: uint8 [n_chunks, max_bytes] nibble bytes (without the 8-byte
             header; zero-padded past each chunk's real length — callers
             slice the valid prefix of each row afterwards).
    """
    return decode_nibbles(bytes_to_nibbles(payload),
                          init_predictor.astype(jnp.int32),
                          init_step_index.astype(jnp.int32))


@jax.jit
def decode_nibbles_scan(nibbles: jnp.ndarray, init_predictor: jnp.ndarray,
                        init_step_index: jnp.ndarray) -> jnp.ndarray:
    """Sequential lax.scan over samples, chunk-parallel across rows: the
    reference form of `decode_nibbles` (same arguments, same result)."""
    def step(carry, nt):
        p, s = carry
        step_v = jnp.take(_STEP_TABLE, s)
        s2 = jnp.clip(s + jnp.take(_INDEX_TABLE, nt), 0, 88)
        diff = ((2 * (nt & 7) + 1) * step_v) >> 3
        p2 = jnp.clip(jnp.where((nt & 8) != 0, p - diff, p + diff),
                      -32768, 32767)
        return (p2, s2), p2.astype(jnp.int16)

    (_, _), out = jax.lax.scan(
        step, (init_predictor.astype(jnp.int32),
               init_step_index.astype(jnp.int32)), nibbles.T)
    return out.T


# ---------------------------------------------------------------------------
# Encoder: sequential scan over samples (feedback through the quantizer),
# vectorized across independent streams.
# ---------------------------------------------------------------------------

def _compress_step(carry, inp):
    """One adpcm_ima_compress_sample step (adpcm.c:219-227), batched.

    carry: (prev_sample int32 [B], step_index int32 [B])
    inp:   (sample int32 [B], reset_prev bool [B]) — reset_prev marks chunk
           starts where prev_sample := sample (adpcm.c:464).
    """
    prev, sidx = carry
    sample, reset = inp
    prev = jnp.where(reset, sample, prev)
    step = jnp.take(_STEP_TABLE, sidx, axis=0)
    delta = sample - prev
    nibble = jnp.minimum(7, jnp.abs(delta) * 4 // step) + \
        jnp.where(delta < 0, 8, 0)
    recon = step * jnp.take(_DIFFLOOKUP, nibble, axis=0)
    # C truncating division by 8 (toward zero)
    recon = jnp.where(recon >= 0, recon >> 3, -((-recon) >> 3))
    prev = jnp.clip(prev + recon, -32768, 32767)
    sidx = jnp.clip(sidx + jnp.take(_INDEX_TABLE, nibble, axis=0), 0, 88)
    return (prev, sidx), (nibble, sidx)


@jax.jit
def encode_samples(samples: jnp.ndarray, reset_mask: jnp.ndarray,
                   init_step_index: jnp.ndarray):
    """Encode PCM streams to nibbles.

    samples:    int32 [B, n] (chunk-concatenated, padded)
    reset_mask: bool [B, n] true at each chunk's first sample
    returns (nibbles int32 [B, n], step_index_before int32 [B, n])
            step_index_before[t] is the codec state before encoding sample t
            (chunk headers store it at chunk starts).
    """
    B = samples.shape[0]
    prev0 = jnp.zeros((B,), jnp.int32)
    sidx0 = init_step_index.astype(jnp.int32)

    def step(carry, inp):
        (prev, sidx) = carry
        new_carry, (nib, _) = _compress_step(carry, inp)
        return new_carry, (nib, sidx)  # sidx = state BEFORE this sample

    (_, _), (nibbles, sidx_before) = jax.lax.scan(
        step, (prev0, sidx0), (samples.T.astype(jnp.int32), reset_mask.T))
    return nibbles.T, sidx_before.T


def nibbles_to_bytes(nibbles: np.ndarray) -> np.ndarray:
    """int nibbles [..., 2k] -> uint8 bytes [..., k], high nibble first."""
    hi = nibbles[..., 0::2]
    lo = nibbles[..., 1::2]
    return ((hi << 4) | (lo & 0xF)).astype(np.uint8)


# ---------------------------------------------------------------------------
# MS-ADPCM block decode (adpcm.c:743-756 expand, :1041-1106 layout): the
# per-block 7-byte channel headers make blocks independent, so the batch
# axis is (blocks x channels) lanes and the scan walks each lane's nibble
# stream (2 nibbles/byte mono, 1/byte per channel stereo).
# ---------------------------------------------------------------------------

from ..verify.ref_wav_audio import (MS_ADAPTATION_TABLE, MS_ADAPT_COEFF1,
                                    MS_ADAPT_COEFF2)

_MS_ADAPT = jnp.asarray(MS_ADAPTATION_TABLE, dtype=jnp.int32)


@jax.jit
def decode_ms_nibbles(nibbles: jnp.ndarray, coeff1: jnp.ndarray,
                      coeff2: jnp.ndarray, idelta: jnp.ndarray,
                      sample1: jnp.ndarray, sample2: jnp.ndarray):
    """Decode MS-ADPCM nibble streams, lane-parallel.

    nibbles: int32 [B, n] in emit order; state vectors int32 [B] from the
    block headers. Returns int16 [B, n] (the header's sample1/sample2 are
    emitted by the caller, not here). The C `/ 256` truncates toward
    zero and `>> 8` floors — both reproduced exactly.
    """
    def step(carry, nib):
        s1, s2, idl = carry
        pred = s1 * coeff1.astype(jnp.int32) + s2 * coeff2.astype(jnp.int32)
        # C / 256 truncates toward zero (bias-then-floor form is exact
        # even at INT32_MIN, where negating would wrap)
        pred = (pred + ((pred >> 31) & 255)) >> 8
        signed = jnp.where((nib & 8) != 0, nib - 0x10, nib)
        pred = pred + signed * idl
        s1n = jnp.clip(pred, -32768, 32767)
        idl2 = jnp.maximum((jnp.take(_MS_ADAPT, nib) * idl) >> 8, 16)
        return (s1n, s1, idl2), s1n.astype(jnp.int16)

    (_, _, _), out = jax.lax.scan(
        step, (sample1.astype(jnp.int32), sample2.astype(jnp.int32),
               idelta.astype(jnp.int32)), nibbles.T)
    return out.T
