"""Batched bit-exact integer IDCT (FFmpeg simple_idct) in plain JAX.

Replicates AMVmuxer/ffmpeg/libavcodec/simple_idct.c:78-253 exactly:

* row pass (idctRowCondDC): int16 arithmetic domain with the numerically
  significant DC-only shortcut (rows whose AC terms are all zero produce
  int16(dc << 3) in all lanes, which differs from the general path by
  rounding) and int16 wraparound on store;
* column pass (idctSparseColPut): int32 accumulation, >> 20, clamp to
  uint8.  The reference's `if (col[k])` guards skip additions of zero and
  have no numeric effect, so the vectorized form is unconditional.

All arithmetic is int32 two's-complement (XLA integer ops wrap), matching C.

Layout: blocks [N, 8, 8] int16 (raster order).  The butterflies are pure
element-wise VPU work over the N axis; XLA fuses the whole transform into a
few kernels.  `dequantize` fuses the preceding levels*qmat multiply and the
DC prediction add (decode_block:387-424 semantics) so only int16 levels
travel from the entropy decoder to the device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
ROW_SHIFT, COL_SHIFT = 11, 20


def _wrap16(x):
    """C int16 store semantics in int32 arithmetic."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def idct_rows(blocks: jnp.ndarray) -> jnp.ndarray:
    """Row pass on [..., 8, 8] int32 (values in int16 range) -> int32."""
    # blocks[..., row, col]: c[i] = i-th element of every row, shape [..., 8]
    c = [blocks[..., :, i] for i in range(8)]

    dc_only = (c[1] | c[2] | c[3] | c[4] | c[5] | c[6] | c[7]) == 0
    shortcut = _wrap16(c[0] << 3)

    a0 = W4 * c[0] + (1 << (ROW_SHIFT - 1))
    a1 = a0 + W6 * c[2]
    a2 = a0 - W6 * c[2]
    a3 = a0 - W2 * c[2]
    a0 = a0 + W2 * c[2]
    b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7]
    b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7]
    b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7]
    b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7]
    a0 = a0 + W4 * c[4] + W6 * c[6]
    a1 = a1 - W4 * c[4] - W2 * c[6]
    a2 = a2 - W4 * c[4] + W2 * c[6]
    a3 = a3 + W4 * c[4] - W6 * c[6]

    out = [
        _wrap16((a0 + b0) >> ROW_SHIFT),
        _wrap16((a1 + b1) >> ROW_SHIFT),
        _wrap16((a2 + b2) >> ROW_SHIFT),
        _wrap16((a3 + b3) >> ROW_SHIFT),
        _wrap16((a3 - b3) >> ROW_SHIFT),
        _wrap16((a2 - b2) >> ROW_SHIFT),
        _wrap16((a1 - b1) >> ROW_SHIFT),
        _wrap16((a0 - b0) >> ROW_SHIFT),
    ]
    out = [jnp.where(dc_only, shortcut, o) for o in out]
    return jnp.stack(out, axis=-1)


def idct_cols_put(rows: jnp.ndarray) -> jnp.ndarray:
    """Column pass + uint8 clamp on [..., 8, 8] int32 -> uint8."""
    c = [rows[..., i, :] for i in range(8)]
    bias = (1 << (COL_SHIFT - 1)) // W4  # == 32 (simple_idct.c:190)
    a0 = W4 * (c[0] + bias)
    a1 = a0 + W6 * c[2] - W4 * c[4] - W2 * c[6]
    a2 = a0 - W6 * c[2] - W4 * c[4] + W2 * c[6]
    a3 = a0 - W2 * c[2] + W4 * c[4] - W6 * c[6]
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6]
    b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7]
    b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7]
    b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7]
    b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7]

    out = [
        (a0 + b0) >> COL_SHIFT,
        (a1 + b1) >> COL_SHIFT,
        (a2 + b2) >> COL_SHIFT,
        (a3 + b3) >> COL_SHIFT,
        (a3 - b3) >> COL_SHIFT,
        (a2 - b2) >> COL_SHIFT,
        (a1 - b1) >> COL_SHIFT,
        (a0 - b0) >> COL_SHIFT,
    ]
    stacked = jnp.stack(out, axis=-2)
    return jnp.clip(stacked, 0, 255).astype(jnp.uint8)


@jax.jit
def idct_put(blocks: jnp.ndarray) -> jnp.ndarray:
    """simple_idct_put on a batch: int16 [..., 8, 8] -> uint8 [..., 8, 8]."""
    return idct_cols_put(idct_rows(blocks.astype(jnp.int32)))


@jax.jit
def dequantize_idct(levels: jnp.ndarray, dc: jnp.ndarray,
                    qmat_raster: jnp.ndarray) -> jnp.ndarray:
    """Fused dequant + IDCT.

    levels: int16/int32 [..., 64] AC levels in RASTER order (entry 0 unused)
    dc:     int32 [...] resolved DC values (post-prediction, pre-wrap)
    qmat_raster: int32 [..., 64] dequant matrix per block (broadcastable)
    returns uint8 [..., 8, 8]
    """
    deq = _wrap16(levels.astype(jnp.int32) * qmat_raster)
    deq = deq.at[..., 0].set(_wrap16(dc))
    return idct_put(deq.reshape(*deq.shape[:-1], 8, 8))
