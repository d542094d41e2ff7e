"""IMA-ADPCM stream encoder as a Pallas kernel on the Triton route.

The encoder's quantizer feeds back into its own state
(adpcm_ima_compress_sample, adpcm.c:219-227), and the AMV muxer encodes
a whole track as one stream because the step index carries across
chunks: a 4-minute 22,050 Hz track is about 5.3M dependent steps.  As a
lax.scan that is one XLA loop iteration, several kernel launches, per
sample.  Here each stream is one lane of a 32-lane program that keeps
{prev_sample, step_index} in registers and walks the time-major samples
in a single kernel loop, with the next rows loaded ahead of use.

Same contract as kernels/adpcm.py:encode_samples, which is the plain
reference it is tested against (interpret mode on the CPU).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..verify.ref_adpcm import STEP_TABLE

LANES = 32   # streams per program: one warp
AHEAD = 4    # rows loaded ahead of the one being encoded
_STEPS = np.zeros(128, np.int32)
_STEPS[:len(STEP_TABLE)] = STEP_TABLE


def _encode_kernel(x_ref, sidx0_ref, step_ref, o_ref, *, n: int, width: int):
    """x_ref int32 [(n + AHEAD) * width]: time-major, sample in the low 16
    bits, chunk-start flag in bit 16.  o_ref int32 [n * width]:
    nibble | step_index_before << 4."""
    lanes = pl.program_id(0) * LANES + jnp.arange(LANES)
    sidx = sidx0_ref[lanes]
    prev = jnp.zeros((LANES,), jnp.int32)
    ahead = tuple(x_ref[k * width + lanes] for k in range(AHEAD))

    def body(t, carry):
        prev, sidx, *rows = carry
        x = rows[0]
        nxt = x_ref[(t + AHEAD) * width + lanes]
        sample = (x << 16) >> 16
        prev = jnp.where(((x >> 16) & 1) != 0, sample, prev)
        step = step_ref[sidx]
        delta = sample - prev
        mag = jnp.minimum(7, lax.div(jnp.abs(delta) * 4, step))
        o_ref[t * width + lanes] = (mag + jnp.where(delta < 0, 8, 0)
                                    + (sidx << 4))
        recon = (step * (2 * mag + 1)) >> 3
        prev = jnp.clip(jnp.where(delta < 0, prev - recon, prev + recon),
                        -32768, 32767)
        sidx = jnp.clip(sidx + jnp.where(mag < 4, -1, 2 * mag - 6), 0, 88)
        return (prev, sidx, *rows[1:], nxt)

    lax.fori_loop(0, n, body, (prev, sidx) + ahead)


@partial(jax.jit, static_argnames=("interpret",))
def encode_samples_triton(samples, reset_mask, init_step_index,
                          interpret: bool = False):
    """Encode PCM streams to nibbles.

    samples int32 [B, n] (int16 range), reset_mask bool [B, n] (chunk
    starts), init_step_index int32 [B] -> (nibbles int32 [B, n],
    step_index_before int32 [B, n])."""
    B, n = samples.shape
    width = -(-B // LANES) * LANES
    x = ((samples.astype(jnp.int32) & 0xFFFF)
         | (reset_mask.astype(jnp.int32) << 16)).T
    x = jnp.pad(x, ((0, AHEAD), (0, width - B))).reshape(-1)
    sidx0 = jnp.pad(init_step_index.astype(jnp.int32), (0, width - B))
    out = pl.pallas_call(
        partial(_encode_kernel, n=n, width=width),
        out_shape=jax.ShapeDtypeStruct((n * width,), jnp.int32),
        grid=(width // LANES,),
        compiler_params=pltriton.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="adpcm_encode",
    )(x, sidx0, jnp.asarray(_STEPS))
    out = out.reshape(n, width)[:, :B].T
    return out & 15, out >> 4
