"""Device-side JPEG entropy encoder (Huffman pack in plain JAX).

Unlike decode, Huffman *encoding* has no bit-serial feedback (the only
sequential dependency, the DC prediction chain, is a cumulative sum), so
the whole entropy stage vectorizes:

1. per-coefficient tokens: runs come from an exclusive prefix-max of
   nonzero scan positions; each coefficient renders to a <=64-bit
   (value, length) pair covering its ZRLs + run/size code + mantissa;
2. bit layout: per-token global bit offsets are two nested cumulative
   sums (within block, then across blocks);
3. packing: tokens scatter-add into big-endian u32 words (tokens never
   overlap, so add == or);
4. byte stuffing (0xFF -> 0xFF00) is an exclusive cumsum of FF counts
   feeding a scatter, plus SOI/EOI framing and the 1-bit stuffing pad.

Bit-exact with the host/C encoder (mjpegenc.c encode_block semantics);
see tests/test_entropy_device.py.

Output stays on device: [F, max_bytes] uint8 + per-frame lengths, so a
full transcode ships only bitstreams across the host link.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream import jpeg_tables as T


def _enc_tables():
    """Per-symbol (code, size) for DC/AC, luma/chroma as [256] arrays."""
    out = {}
    for name, bits, vals in (
        ("dc_l", T.BITS_DC_LUMA, T.VALS_DC_LUMA),
        ("dc_c", T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
        ("ac_l", T.BITS_AC_LUMA, T.VALS_AC_LUMA),
        ("ac_c", T.BITS_AC_CHROMA, T.VALS_AC_CHROMA),
    ):
        sizes, codes = T.build_huffman_codes(bits, vals)
        out[name] = (jnp.asarray(codes, jnp.uint32), jnp.asarray(sizes, jnp.int32))
    return out


_TB = _enc_tables()


def _bitlen16(v):
    """bit_length of v in [0, 65535] (av_log2_16bit(v)+1 for v>0; 0 for 0)."""
    r = jnp.zeros(v.shape, jnp.int32)
    for s in (8, 4, 2, 1):
        m = v >= (1 << s)
        r = r + jnp.where(m, s, 0)
        v = jnp.where(m, v >> s, v)
    return r + jnp.where(v > 0, 1, 0)


def _coef_tokens(levels_zz, is_luma):
    """Render per-coefficient tokens.

    levels_zz: int32 [..., 64] zigzag (pos 0 = DC *value*).
    is_luma: bool [...] per block.
    Returns (val_hi, val_lo, length): token bit strings, MSB-first within
    `length` bits, as two uint32 halves (hi = first 32 bits).
    Slots: 0 = DC placeholder (filled by caller with diff), 1..63 = AC,
    64 = EOB slot.
    """
    lv = levels_zz
    nz = lv != 0
    idx = jnp.arange(64, dtype=jnp.int32)
    # previous nonzero scan position (DC counts as position 0)
    pos_or_zero = jnp.where(nz, idx, 0).at[..., 0].set(0)
    prev_nz = jax.lax.associative_scan(
        jnp.maximum, pos_or_zero, axis=-1)
    prev_nz_excl = jnp.concatenate(
        [jnp.zeros_like(prev_nz[..., :1]), prev_nz[..., :-1]], axis=-1)
    run = idx - prev_nz_excl - 1  # valid where nz & idx>0

    val = lv
    absval = jnp.abs(val)
    mant = jnp.where(val < 0, val - 1, val)
    nbits = _bitlen16(absval)

    ac_codes_l, ac_sizes_l = _TB["ac_l"]
    ac_codes_c, ac_sizes_c = _TB["ac_c"]
    lum = is_luma[..., None]

    def ac_entry(sym):
        code = jnp.where(lum, jnp.take(ac_codes_l, sym),
                         jnp.take(ac_codes_c, sym)).astype(jnp.uint32)
        size = jnp.where(lum, jnp.take(ac_sizes_l, sym),
                         jnp.take(ac_sizes_c, sym))
        return code, size

    run16 = jnp.clip(run, 0, 63)
    n_zrl = run16 >> 4
    run_rem = run16 & 15
    sym = (run_rem << 4) | nbits
    code, size = ac_entry(sym)
    # ZRL is one symbol: pick its code per block, not by a gather over a
    # constant index array (which XLA would constant-fold at compile time)
    zrl_code = jnp.where(lum, ac_codes_l[0xF0], ac_codes_c[0xF0])
    zrl_size = jnp.where(lum, ac_sizes_l[0xF0], ac_sizes_c[0xF0])

    # assemble MSB-first into a 64-bit value: [ZRL]*n + code + mantissa
    # build the token with two uint32 lanes (hi = first 32 bits), composed
    # by left-shift-and-or; all windows are < 2^26 so lanes never overflow
    hi = jnp.zeros(lv.shape, jnp.uint32)
    lo = jnp.zeros(lv.shape, jnp.uint32)
    ln = jnp.zeros(lv.shape, jnp.int32)

    def append(hi, lo, ln, code, size):
        """(hi,lo,ln) <<= size; |= code (code < 2^26)."""
        # shift the 64-bit (hi,lo) left by size
        size_u = size.astype(jnp.uint32)
        new_hi = jnp.where(size > 0,
                           (hi << size_u) | (lo >> (32 - size_u).astype(jnp.uint32)),
                           hi)
        new_lo = jnp.where(size > 0, lo << size_u, lo)
        new_lo = new_lo | code.astype(jnp.uint32)
        return new_hi, new_lo, ln + size

    for k in range(3):  # up to 3 ZRLs
        do = n_zrl > k
        h2, l2, n2 = append(hi, lo, ln, zrl_code, zrl_size)
        hi = jnp.where(do, h2, hi)
        lo = jnp.where(do, l2, lo)
        ln = jnp.where(do, n2, ln)
    hi, lo, ln = append(hi, lo, ln, code, size)
    mant_u = (mant.astype(jnp.uint32) &
              ((jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1))
    hi, lo, ln = append(hi, lo, ln, mant_u, nbits)

    # inactive slots (zero coefficients and slot 0) produce no bits
    active = nz & (idx > 0)
    hi = jnp.where(active, hi, 0)
    lo = jnp.where(active, lo, 0)
    ln = jnp.where(active, ln, 0)

    # left-align to MSB of the 64-bit container for the packer
    shift = (64 - ln).astype(jnp.uint32)
    big = shift >= 32
    hi_a = jnp.where(big, lo, hi)
    lo_a = jnp.where(big, jnp.uint32(0), lo)
    sh = jnp.where(big, shift - 32, shift)
    hi_b = (hi_a << sh) | jnp.where(
        sh > 0, lo_a >> (32 - sh).astype(jnp.uint32), 0)
    lo_b = lo_a << sh
    return hi_b, lo_b, ln, run


def _dc_tokens(dc_diff, is_luma):
    """DC token bit strings (MSB-aligned in 32 bits) + lengths."""
    dc_codes_l, dc_sizes_l = _TB["dc_l"]
    dc_codes_c, dc_sizes_c = _TB["dc_c"]
    val = dc_diff
    mant = jnp.where(val < 0, val - 1, val)
    nbits = _bitlen16(jnp.abs(val))
    code = jnp.where(is_luma, jnp.take(dc_codes_l, nbits),
                     jnp.take(dc_codes_c, nbits)).astype(jnp.uint32)
    size = jnp.where(is_luma, jnp.take(dc_sizes_l, nbits),
                     jnp.take(dc_sizes_c, nbits))
    mant_u = (mant.astype(jnp.uint32) &
              ((jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1))
    v = (code << nbits.astype(jnp.uint32)) | mant_u
    ln = size + nbits
    v_aligned = v << (32 - ln).astype(jnp.uint32)
    return v_aligned, ln


def _eob_tokens(levels_zz, is_luma):
    ac_codes_l, ac_sizes_l = _TB["ac_l"]
    ac_codes_c, ac_sizes_c = _TB["ac_c"]
    emit = levels_zz[..., 63] == 0
    code = jnp.where(is_luma, ac_codes_l[0], ac_codes_c[0]).astype(jnp.uint32)
    size = jnp.where(is_luma, ac_sizes_l[0], ac_sizes_c[0])
    ln = jnp.where(emit, size, 0)
    v = jnp.where(emit, code << (32 - size).astype(jnp.uint32), 0)
    return v, ln


@partial(jax.jit, static_argnames=("max_bytes",))
def encode_frames_device(levels_zz, max_bytes: int):
    """Quantized levels -> escaped AMV payloads, fully on device.

    levels_zz: int16 [F, M, 6, 64] zigzag; slot 0 = DC value.
    Returns (payload uint8 [F, max_bytes], lengths int32 [F]) where
    payload[f, :lengths[f]] is SOI + escaped scan + EOI.
    """
    F, M = levels_zz.shape[0], levels_zz.shape[1]
    B = M * 6
    lv = levels_zz.astype(jnp.int32).reshape(F, B, 64)
    is_luma = (jnp.arange(6) < 4)[None, None, :].repeat(M, 1).reshape(1, B)
    is_luma = jnp.broadcast_to(is_luma, (F, B))

    # --- DC diffs ----------------------------------------------------------
    lv6 = levels_zz.astype(jnp.int32)
    dc_y = lv6[:, :, :4, 0].reshape(F, M * 4)
    dc_y_diff = dc_y - jnp.concatenate(
        [jnp.full((F, 1), 128, jnp.int32), dc_y[:, :-1]], axis=1)
    dc_cb = lv6[:, :, 4, 0]
    dc_cb_diff = dc_cb - jnp.concatenate(
        [jnp.full((F, 1), 128, jnp.int32), dc_cb[:, :-1]], axis=1)
    dc_cr = lv6[:, :, 5, 0]
    dc_cr_diff = dc_cr - jnp.concatenate(
        [jnp.full((F, 1), 128, jnp.int32), dc_cr[:, :-1]], axis=1)
    dc_diff = jnp.concatenate([
        dc_y_diff.reshape(F, M, 4),
        dc_cb_diff[:, :, None], dc_cr_diff[:, :, None]], axis=2).reshape(F, B)

    # --- tokens -------------------------------------------------------------
    ac_hi, ac_lo, ac_ln, _ = _coef_tokens(lv, is_luma)      # [F,B,64]
    dc_v, dc_ln = _dc_tokens(dc_diff, is_luma)              # [F,B]
    eob_v, eob_ln = _eob_tokens(lv, is_luma)                # [F,B]

    # token stream per block: slot0=DC, slots1..63=AC, slot64=EOB
    tok_hi = jnp.concatenate([dc_v[..., None], ac_hi[..., 1:],
                              eob_v[..., None]], axis=-1)
    tok_lo = jnp.concatenate([jnp.zeros_like(dc_v)[..., None],
                              ac_lo[..., 1:],
                              jnp.zeros_like(eob_v)[..., None]], axis=-1)
    tok_ln = jnp.concatenate([dc_ln[..., None], ac_ln[..., 1:],
                              eob_ln[..., None]], axis=-1)   # [F,B,65]

    # --- bit offsets ----------------------------------------------------------
    tok_ln_flat = tok_ln.reshape(F, B * 65)
    ends = jnp.cumsum(tok_ln_flat, axis=1)
    offsets = ends - tok_ln_flat                              # exclusive
    total_bits = ends[:, -1]

    # --- pack into big-endian u32 words ---------------------------------------
    n_words = max_bytes // 4
    o32 = (offsets >> 5).astype(jnp.int32)
    sh = (offsets & 31).astype(jnp.uint32)
    hi = tok_hi.reshape(F, B * 65)
    lo = tok_lo.reshape(F, B * 65)
    # word contributions: value is MSB-aligned 64-bit (hi,lo); shifting right
    # by sh spreads it over words o32, o32+1, o32+2
    w0 = hi >> sh
    w1 = jnp.where(sh > 0, hi << (32 - sh), 0) | (lo >> sh)
    w2 = jnp.where(sh > 0, lo << (32 - sh), 0)
    words = jnp.zeros((F, n_words), jnp.uint32)
    rows = jnp.broadcast_to(jnp.arange(F)[:, None], o32.shape)
    for wk, dd in ((w0, 0), (w1, 1), (w2, 2)):
        idxs = jnp.clip(o32 + dd, 0, n_words - 1)
        valid = (tok_ln.reshape(F, B * 65) > 0)
        words = words.at[rows, idxs].add(jnp.where(valid, wk, 0))

    # --- stuffing pad: set bits [total_bits, ceil8) to 1 ----------------------
    pad = (8 - (total_bits & 7)) & 7
    pad_val = ((jnp.uint32(1) << pad.astype(jnp.uint32)) - 1)
    pad_off = total_bits
    pw = (pad_off >> 5).astype(jnp.int32)
    # the pad completes the current byte, so it never straddles a word:
    # (pad_off & 31) + pad == next byte boundary <= 32
    contrib = jnp.where(
        pad > 0,
        pad_val << (32 - (pad_off.astype(jnp.uint32) & 31)
                    - pad.astype(jnp.uint32)),
        0)
    words = words.at[jnp.arange(F), jnp.clip(pw, 0, n_words - 1)].add(contrib)
    scan_bytes_len = (total_bits + pad) >> 3

    # words -> bytes (big-endian)
    b0 = (words >> 24).astype(jnp.uint8)
    b1 = ((words >> 16) & 0xFF).astype(jnp.uint8)
    b2 = ((words >> 8) & 0xFF).astype(jnp.uint8)
    b3 = (words & 0xFF).astype(jnp.uint8)
    scan = jnp.stack([b0, b1, b2, b3], axis=-1).reshape(F, n_words * 4)

    # --- escape 0xFF and frame with SOI/EOI -----------------------------------
    pos_idx = jnp.arange(scan.shape[1])
    in_scan = pos_idx[None, :] < scan_bytes_len[:, None]
    is_ff = (scan == 0xFF) & in_scan
    nff_before = jnp.cumsum(is_ff.astype(jnp.int32), axis=1) - is_ff
    out = jnp.zeros((F, max_bytes), jnp.uint8)
    opos = jnp.clip(2 + pos_idx[None, :] + nff_before, 0, max_bytes - 1)
    rows2 = jnp.broadcast_to(jnp.arange(F)[:, None], scan.shape)
    out = out.at[rows2, opos].add(jnp.where(in_scan, scan, 0))
    # zero byte after each FF is already zero in `out` (we only add)
    out = out.at[:, 0].set(0xFF).at[:, 1].set(0xD8)
    n_ff = jnp.sum(is_ff, axis=1)
    end = 2 + scan_bytes_len + n_ff
    out = out.at[jnp.arange(F), jnp.clip(end, 0, max_bytes - 1)].set(0xFF)
    out = out.at[jnp.arange(F), jnp.clip(end + 1, 0, max_bytes - 1)].set(0xD9)
    return out, end + 2
