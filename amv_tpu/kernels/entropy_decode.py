"""Plain JAX JPEG entropy decoder: symbol-sequential, frame-parallel.

Huffman decode is bit-serial *within* a frame, but frames are independent:
this decoder runs one `lax.while_loop` whose every iteration decodes one
symbol in EVERY active frame (frames are SIMD lanes).  Per step it peeks
24 bits via byte gathers, classifies through flat 16-bit LUTs, consumes
code+mantissa, and emits (destination, level) pairs that one final scatter
turns into the [F, M*6, 64] level tensor.  ~4-6K steps decode a whole
batch regardless of batch size — the cross-frame parallel analog of the
reference's per-MCU loop (mjpegdec.c:659-736).

The input is the unescaped scan (0xFF00 stuffing removed on host — a
cheap byte pass) padded with zeros.  Semantics are identical to
bitstream/entropy.py: levels in zigzag order, slot 0 = DC difference.
A frame the C decoder would reject (an invalid code, a coefficient past
position 63, a size-0 symbol other than EOB/ZRL, or a scan that does not
finish within the step budget) comes back with ok False.  This is the
CPU implementation and the reference for the GPU kernel
(entropy_decode_cuda.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream import jpeg_tables as T


def _dec_luts():
    """Flat LUTs [4, 65536]: table 0=DC-L, 1=DC-C, 2=AC-L, 3=AC-C."""
    syms = np.zeros((4, 1 << 16), np.int32)
    lens = np.zeros((4, 1 << 16), np.int32)
    for t, (bits, vals) in enumerate((
            (T.BITS_DC_LUMA, T.VALS_DC_LUMA),
            (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
            (T.BITS_AC_LUMA, T.VALS_AC_LUMA),
            (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA))):
        s, l = T.build_decode_table(bits, vals)
        syms[t] = s
        lens[t] = l
    return syms.reshape(-1), lens.reshape(-1)


_LUT_SYM, _LUT_LEN = _dec_luts()


@partial(jax.jit, static_argnames=("n_mcu", "max_steps"))
def decode_scans_device(scans: jnp.ndarray, n_mcu: int,
                        max_steps: int = 0):
    """scans: uint8 [F, max_bytes] unescaped scan data (zero padded).

    Returns (levels int16 [F, n_mcu, 6, 64] (zigzag, slot0 = DC diff),
    ok bool [F]).
    """
    F, max_bytes = scans.shape
    n_blocks = n_mcu * 6
    if max_steps == 0:
        max_steps = max_bytes * 8 // 3 + 64  # min useful symbol ~3 bits

    # pack bytes into big-endian u32 words for 2-gather 24-bit peeks; two
    # trailing zero words make reads past the row end see zeros, like the
    # C reader's zero fill
    s = jnp.pad(scans.astype(jnp.uint32), ((0, 0), (0, -max_bytes % 4 + 8)))
    words = ((s[:, 0::4] << 24) | (s[:, 1::4] << 16) |
             (s[:, 2::4] << 8) | s[:, 3::4])          # [F, W]
    n_words = words.shape[1]

    rows = jnp.arange(F)
    lut_sym, lut_len = jnp.asarray(_LUT_SYM), jnp.asarray(_LUT_LEN)

    def peek32(bitpos):
        w = (bitpos >> 5).astype(jnp.int32)
        sh = (bitpos & 31).astype(jnp.uint32)
        w0 = words[rows, jnp.clip(w, 0, n_words - 1)]
        w1 = words[rows, jnp.clip(w + 1, 0, n_words - 1)]
        hi = jnp.where(sh > 0, (w0 << sh) | (w1 >> (32 - sh)), w0)
        return hi  # 32 bits starting at bitpos (MSB-first)

    def extend(v, n):
        """JPEG 'extend' of the n-bit mantissa v."""
        neg = v < (jnp.uint32(1) << jnp.clip(n - 1, 0, 31).astype(jnp.uint32))
        full = (jnp.int32(1) << n) - 1
        return jnp.where(n == 0, 0,
                         jnp.where(neg, v.astype(jnp.int32) - full,
                                   v.astype(jnp.int32)))

    # state: bitpos [F], block [F], pos [F] (0=expect DC, else next AC scan
    # position), bad [F] (malformed: the frame stops), step counter
    def cond(carry):
        step, bitpos, block, pos, bad, out_idx, out_val = carry
        return (step < max_steps) & jnp.any(block < n_blocks)

    def body(carry):
        step, bitpos, block, pos, bad, out_idx, out_val = carry
        active = block < n_blocks
        btype = block % 6
        luma = btype < 4
        is_dc = pos == 0
        tab = jnp.where(is_dc, 0, 2) + jnp.where(luma, 0, 1)
        pk = peek32(bitpos)
        peek16 = (pk >> 16).astype(jnp.int32)
        lut_i = tab * 65536 + peek16
        sym = jnp.take(lut_sym, lut_i)
        ln = jnp.take(lut_len, lut_i)

        # mantissa bits follow the code
        nbits = jnp.where(is_dc, sym, sym & 0xF)
        mant_raw = jnp.where(
            nbits > 0,
            (pk << ln.astype(jnp.uint32)) >> (32 - nbits).astype(jnp.uint32),
            jnp.uint32(0))
        level = extend(mant_raw, nbits)

        run = jnp.where(is_dc, 0, sym >> 4)
        is_eob = (~is_dc) & (sym == 0)
        is_zrl = (~is_dc) & (sym == 0xF0)

        new_pos_ac = pos + run + 1
        # coefficient destination (zigzag slot); DC writes slot 0
        dst_pos = jnp.where(is_dc, 0, new_pos_ac - 1)
        write = active & (is_dc | (~is_eob & ~is_zrl))
        dest = jnp.where(write, block * 64 + jnp.clip(dst_pos, 0, 63),
                         n_blocks * 64)  # overflow slot
        consumed = ln + nbits

        # malformed: invalid code, size-0 symbol other than EOB/ZRL, or a
        # coefficient past scan position 63 (native/entropy.c rejects all)
        is_level = (~is_dc) & (~is_eob) & (~is_zrl)
        malformed = active & ((ln == 0) |
                              (is_level & (((sym & 0xF) == 0) |
                                           (new_pos_ac - 1 > 63))))
        write = write & ~malformed

        # state transitions
        hit63 = is_level & (new_pos_ac - 1 >= 63)
        end_block = is_eob | hit63
        pos_next = jnp.where(is_dc, 1,
                    jnp.where(is_zrl, pos + 16,
                     jnp.where(end_block, 0, new_pos_ac)))
        block_next = jnp.where(malformed, n_blocks,
                               jnp.where(active & end_block, block + 1, block))
        bitpos_next = jnp.where(active, bitpos + consumed, bitpos)

        # emit buffers are [max_steps, F]: each step writes one contiguous
        # row (the [F, max_steps] layout's column writes are lane-strided
        # and dominate the step cost)
        dest = jnp.where(write, dest, n_blocks * 64)
        out_idx = out_idx.at[step].set(dest.astype(jnp.int32))
        out_val = out_val.at[step].set(
            jnp.where(write, level, 0).astype(jnp.int16))
        return (step + 1, bitpos_next, block_next, pos_next, bad | malformed,
                out_idx, out_val)

    def body4(carry):
        # unroll 4 symbols per loop iteration: the per-iteration cost is
        # dominated by fixed dispatch of many tiny [F] ops, so unrolling
        # amortizes it (~2x wall win measured at F=252)
        for _ in range(4):
            carry = body(carry)
        return carry

    max_steps = (max_steps + 3) & ~3
    out_idx0 = jnp.full((max_steps, F), n_blocks * 64, jnp.int32)
    out_val0 = jnp.zeros((max_steps, F), jnp.int16)
    carry = (jnp.int32(0), jnp.zeros(F, jnp.int32), jnp.zeros(F, jnp.int32),
             jnp.zeros(F, jnp.int32), jnp.zeros(F, bool), out_idx0, out_val0)
    step, bitpos, block, pos, bad, out_idx, out_val = jax.lax.while_loop(
        cond, body4, carry)

    flat = jnp.zeros((F, n_blocks * 64 + 1), jnp.int16)
    flat = flat.at[rows[:, None], out_idx.T].add(out_val.T)
    ok = (block >= n_blocks) & ~bad
    return flat[:, :n_blocks * 64].reshape(F, n_mcu, 6, 64), ok
