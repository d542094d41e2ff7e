"""Scalar reference implementation of the AMV MJPEG-variant video codec.

Bit-exact, slow, pure numpy/Python.  This is the oracle the device kernels are
validated against.  Semantics replicated from the reference:

decode (FFmpeg-compatible path):
* frame unwrap + canned tables: sp5xdec.c:50-88 (payload[2:-2], Q60 pair);
* scan unescape (0xFF 0x00 -> 0xFF): mjpegdec.c:1176-1199;
* per-block Huffman + dequant: mjpegdec.c decode_block:376-430 (values
  stored into int16 with C wrap; DC predictor chain kept in full int,
  init 1024 per scan, mjpegdec.c:731,806);
* integer IDCT: simple_idct.c idctRowCondDC/idctSparseColPut:78-253,
  including the numerically-significant DC-only row shortcut;
* upside-down output: mjpegdec.c:672-677.

encode:
* flip + bottom edge replication: mjpegenc.c amv_encode_picture:454-473 +
  mpegvideo_enc.c:1510-1517 (ff_emulated_edge_mc);
* quant matrix: mpegvideo_enc.c:2866-2876 (MPEG-1 intra matrix x qscale>>3,
  clipped to uint8; effective CLI default qscale is 2: lambda=0 ->
  update_qscale clips to qmin=2, mpegvideo_enc.c:143-145 + utils.c qmin);
* FDCT: jfdctint.c ff_jpeg_fdct_islow (CONST_BITS=13, PASS1_BITS=4);
* quantizer: mpegvideo_enc.c dct_quantize_c:3640-3725 with
  intra_quant_bias=0 (AMV, mpegvideo_enc.c:492-496), DC (x+32)/64
  (y/c_dc_scale=8), followed by clip_coeffs to +/-1023 on overflow;
* entropy coding: mjpegenc.c encode_block:379-435, K.3 tables, last_dc
  init 128 (mpegvideo_enc.c:2036), stuffing with 1-bits
  (ff_mjpeg_encode_stuffing:338-343), escape_FF:282-336, SOI/EOI only
  (ff_mjpeg_encode_picture_header:203-204).
"""

from __future__ import annotations

import numpy as np

from ..bitstream import jpeg_tables as T

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _i16(x):
    """C int16 store (wraparound)."""
    return ((int(x) + 0x8000) & 0xFFFF) - 0x8000


def unescape_scan(data: bytes) -> bytes:
    """Remove 0x00 stuffing after 0xFF, keep RSTn markers in the stream,
    stop at any other real marker (mjpegdec.c:1176-1199: consecutive
    0xFFs collapse; FF 00 -> FF; FF D0-D7 passes through for the
    restart resync in the block decoder).  A real marker ends the scan
    BEFORE its preceding 0xFF (mjpegdec.c:1181 `t -= 2` backs off over
    the FF+marker pair), so the unescaped scan never carries a trailing
    marker prefix; a bare trailing 0xFF at end-of-data stays (no marker
    followed)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        x = data[i]
        i += 1
        out.append(x)
        if x == 0xFF:
            while i < n and data[i] == 0xFF:
                i += 1
            if i >= n:
                break
            x = data[i]
            i += 1
            if 0xD0 <= x <= 0xD7:
                out.append(x)
            elif x != 0:
                out.pop()  # real marker: its FF prefix isn't scan data
                break
    return bytes(out)


class BitReader:
    """MSB-first bit reader; reads past the end return 0 bits."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte_i = self.pos >> 3
            bit_i = 7 - (self.pos & 7)
            bit = (self.data[byte_i] >> bit_i) & 1 if byte_i < len(self.data) else 0
            v = (v << 1) | bit
            self.pos += 1
        return v

    def get_xbits(self, n: int) -> int:
        """JPEG 'extend' read (bitstream.h get_xbits semantics)."""
        v = self.get_bits(n)
        if v < (1 << (n - 1)):
            return v - (1 << n) + 1
        return v


class BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def put_bits(self, n: int, value: int):
        value &= (1 << n) - 1
        self.acc = (self.acc << n) | value
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def bit_count(self):
        return len(self.buf) * 8 + self.nbits

    def flush(self) -> bytes:
        assert self.nbits == 0, "stuff to byte boundary before flushing"
        return bytes(self.buf)


# Decode LUTs (built once)
_DC_L = T.build_decode_table(T.BITS_DC_LUMA, T.VALS_DC_LUMA)
_DC_C = T.build_decode_table(T.BITS_DC_CHROMA, T.VALS_DC_CHROMA)
_AC_L = T.build_decode_table(T.BITS_AC_LUMA, T.VALS_AC_LUMA)
_AC_C = T.build_decode_table(T.BITS_AC_CHROMA, T.VALS_AC_CHROMA)

# Encode tables
_ENC_DC_L = T.build_huffman_codes(T.BITS_DC_LUMA, T.VALS_DC_LUMA)
_ENC_DC_C = T.build_huffman_codes(T.BITS_DC_CHROMA, T.VALS_DC_CHROMA)
_ENC_AC_L = T.build_huffman_codes(T.BITS_AC_LUMA, T.VALS_AC_LUMA)
_ENC_AC_C = T.build_huffman_codes(T.BITS_AC_CHROMA, T.VALS_AC_CHROMA)

def _read_vlc(br: BitReader, lut):
    lut_sym, lut_len = lut
    # peek 16 bits without consuming
    save = br.pos
    peek = br.get_bits(16)
    br.pos = save
    ln = int(lut_len[peek])
    if ln == 0:
        raise ValueError("invalid Huffman code")
    br.pos += ln
    return int(lut_sym[peek])


# ---------------------------------------------------------------------------
# Huffman scan decode -> quantized levels (zigzag order)
# ---------------------------------------------------------------------------

def huffman_decode_scan(scan: bytes, n_mcu: int):
    """Decode the entropy-coded scan into per-block coefficient levels.

    Returns int32 array [n_mcu, 6, 64] in ZIGZAG order: entry 0 is the DC
    *difference* (pre-prediction), entries 1..63 are AC levels (pre-dequant).
    Block order per MCU: Y00 Y01 Y10 Y11 Cb Cr (mjpeg_decode_scan order for
    h=v=2 luma).
    """
    br = BitReader(scan)
    levels = np.zeros((n_mcu, 6, 64), dtype=np.int32)
    for m in range(n_mcu):
        for b in range(6):
            luma = b < 4
            dc_lut = _DC_L if luma else _DC_C
            ac_lut = _AC_L if luma else _AC_C
            sym = _read_vlc(br, dc_lut)
            diff = br.get_xbits(sym) if sym else 0
            levels[m, b, 0] = diff
            i = 0
            while True:
                code = _read_vlc(br, ac_lut)
                if code == 0x00:  # EOB
                    break
                run = code >> 4
                size = code & 0xF
                if size == 0:
                    if run != 15:  # only ZRL has size 0 besides EOB in K.3
                        raise ValueError("unexpected AC symbol")
                    i += 16  # ZRL: 16 zero coefficients (decode_block:400)
                    continue
                level = br.get_xbits(size)
                i += run + 1
                if i > 63:
                    raise ValueError("AC index overflow")
                levels[m, b, i] = level
                if i == 63:
                    break
    return levels


def dequantize(levels: np.ndarray):
    """DC prediction + dequantization, int16 wrap (decode_block:387-424).

    levels: [n_mcu, 6, 64] zigzag-order ints.
    Returns int16 blocks [n_mcu, 6, 8, 8] in raster order.
    """
    n_mcu = levels.shape[0]
    blocks = np.zeros((n_mcu, 6, 64), dtype=np.int64)
    # AC dequant (zigzag pos 1..63)
    qm_zz = np.stack([T.SP5X_QUANT_LUMA_ZZ] * 4 + [T.SP5X_QUANT_CHROMA_ZZ] * 2)
    ac = levels * qm_zz[None, :, :]
    # DC prediction: components 0 (Y: blocks 0..3 chained in scan order),
    # 1 (Cb), 2 (Cr); predictor carried in full int precision, init 1024.
    dc_y = levels[:, :4, 0].reshape(-1) * int(T.SP5X_QUANT_LUMA_ZZ[0])
    dc_y = np.cumsum(dc_y) + 1024
    dc_cb = np.cumsum(levels[:, 4, 0] * int(T.SP5X_QUANT_CHROMA_ZZ[0])) + 1024
    dc_cr = np.cumsum(levels[:, 5, 0] * int(T.SP5X_QUANT_CHROMA_ZZ[0])) + 1024
    blocks[:, :, :] = ac
    blocks[:, :4, 0] = dc_y.reshape(n_mcu, 4)
    blocks[:, 4, 0] = dc_cb
    blocks[:, 5, 0] = dc_cr
    # int16 store wrap, then scatter zigzag->raster
    blocks = ((blocks + 0x8000) & 0xFFFF) - 0x8000
    raster = np.zeros_like(blocks)
    raster[:, :, T.ZIGZAG] = blocks
    return raster.astype(np.int16).reshape(n_mcu, 6, 8, 8)


# ---------------------------------------------------------------------------
# simple_idct (bit-exact)
# ---------------------------------------------------------------------------

_W1, _W2, _W3, _W4, _W5, _W6, _W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
_ROW_SHIFT = 11
_COL_SHIFT = 20


def _idct_row(row: np.ndarray) -> np.ndarray:
    """idctRowCondDC on one int16[8] row -> int16[8] (simple_idct.c:78-181)."""
    r = [int(v) for v in row]
    if not any(r[1:]):
        v = _i16(r[0] << 3)
        return np.full(8, v, dtype=np.int16)
    a0 = _W4 * r[0] + (1 << (_ROW_SHIFT - 1))
    a1 = a2 = a3 = a0
    a0 += _W2 * r[2]
    a1 += _W6 * r[2]
    a2 -= _W6 * r[2]
    a3 -= _W2 * r[2]
    b0 = _W1 * r[1] + _W3 * r[3]
    b1 = _W3 * r[1] - _W7 * r[3]
    b2 = _W5 * r[1] - _W1 * r[3]
    b3 = _W7 * r[1] - _W5 * r[3]
    if r[4] or r[5] or r[6] or r[7]:
        a0 += _W4 * r[4] + _W6 * r[6]
        a1 += -_W4 * r[4] - _W2 * r[6]
        a2 += -_W4 * r[4] + _W2 * r[6]
        a3 += _W4 * r[4] - _W6 * r[6]
        b0 += _W5 * r[5] + _W7 * r[7]
        b1 += -_W1 * r[5] - _W5 * r[7]
        b2 += _W7 * r[5] + _W3 * r[7]
        b3 += _W3 * r[5] - _W1 * r[7]
    # NOTE: C accumulates in 32-bit int; wrap before shifting to stay exact.
    def w32(x):
        return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000
    out = [w32(a0 + b0) >> _ROW_SHIFT, w32(a1 + b1) >> _ROW_SHIFT,
           w32(a2 + b2) >> _ROW_SHIFT, w32(a3 + b3) >> _ROW_SHIFT,
           w32(a3 - b3) >> _ROW_SHIFT, w32(a2 - b2) >> _ROW_SHIFT,
           w32(a1 - b1) >> _ROW_SHIFT, w32(a0 - b0) >> _ROW_SHIFT]
    return np.array([_i16(v) for v in out], dtype=np.int16)


def _idct_col_put(col: np.ndarray) -> np.ndarray:
    """idctSparseColPut on one int16[8] column -> uint8[8] (simple_idct.c:183-253)."""
    c = [int(v) for v in col]
    bias = (1 << (_COL_SHIFT - 1)) // _W4  # == 32
    a0 = _W4 * (c[0] + bias)
    a1 = a2 = a3 = a0
    a0 += _W2 * c[2]
    a1 += _W6 * c[2]
    a2 -= _W6 * c[2]
    a3 -= _W2 * c[2]
    b0 = _W1 * c[1] + _W3 * c[3]
    b1 = _W3 * c[1] - _W7 * c[3]
    b2 = _W5 * c[1] - _W1 * c[3]
    b3 = _W7 * c[1] - _W5 * c[3]
    a0 += _W4 * c[4] + _W6 * c[6]
    a1 += -_W4 * c[4] - _W2 * c[6]
    a2 += -_W4 * c[4] + _W2 * c[6]
    a3 += _W4 * c[4] - _W6 * c[6]
    b0 += _W5 * c[5] + _W7 * c[7]
    b1 += -_W1 * c[5] - _W5 * c[7]
    b2 += _W7 * c[5] + _W3 * c[7]
    b3 += _W3 * c[5] - _W1 * c[7]

    def w32(x):
        return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000

    vals = [w32(a0 + b0) >> _COL_SHIFT, w32(a1 + b1) >> _COL_SHIFT,
            w32(a2 + b2) >> _COL_SHIFT, w32(a3 + b3) >> _COL_SHIFT,
            w32(a3 - b3) >> _COL_SHIFT, w32(a2 - b2) >> _COL_SHIFT,
            w32(a1 - b1) >> _COL_SHIFT, w32(a0 - b0) >> _COL_SHIFT]
    return np.array([min(max(v, 0), 255) for v in vals], dtype=np.uint8)


def idct_put(block: np.ndarray) -> np.ndarray:
    """simple_idct_put on one int16[8,8] block -> uint8[8,8]."""
    tmp = np.empty((8, 8), dtype=np.int16)
    for i in range(8):
        tmp[i] = _idct_row(block[i])
    out = np.empty((8, 8), dtype=np.uint8)
    for j in range(8):
        out[:, j] = _idct_col_put(tmp[:, j])
    return out


# ---------------------------------------------------------------------------
# Frame decode
# ---------------------------------------------------------------------------

def decode_frame(payload: bytes, width: int, height: int):
    """Decode one AMV '00dc' payload to YUV420 planes (Y, Cb, Cr) uint8.

    Output is the display-oriented (already un-flipped) image.
    """
    mb_w = (width + 15) // 16
    mb_h = (height + 15) // 16
    scan = unescape_scan(payload[2:len(payload) - 2])
    levels = huffman_decode_scan(scan, mb_w * mb_h)
    blocks = dequantize(levels)
    pix = np.empty((blocks.shape[0], 6, 8, 8), dtype=np.uint8)
    for m in range(blocks.shape[0]):
        for b in range(6):
            pix[m, b] = idct_put(blocks[m, b])
    return assemble_planes(pix, width, height, mb_w, mb_h)


def assemble_planes(pix: np.ndarray, width: int, height: int, mb_w: int, mb_h: int):
    """MCU blocks -> flipped/cropped planes (mjpeg_decode_scan + AMV flip)."""
    mcu = pix.reshape(mb_h, mb_w, 6, 8, 8)
    # Y: [mb_h, mb_w, 2, 2, 8, 8] -> coded plane [16*mb_h, 16*mb_w]
    y_blocks = mcu[:, :, :4].reshape(mb_h, mb_w, 2, 2, 8, 8)
    ycoded = y_blocks.transpose(0, 2, 4, 1, 3, 5).reshape(16 * mb_h, 16 * mb_w)
    cb_coded = mcu[:, :, 4].transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
    cr_coded = mcu[:, :, 5].transpose(0, 2, 1, 3).reshape(8 * mb_h, 8 * mb_w)
    # AMV flip: coded row r -> display row (height-1-r); coded rows >= height
    # land outside the picture and are dropped (mjpegdec.c:672-677).
    y = ycoded[:height][::-1, :width].copy()
    ch, cw = height // 2, width // 2
    cb = cb_coded[:ch][::-1, :cw].copy()
    cr = cr_coded[:ch][::-1, :cw].copy()
    return y, cb, cr


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encoder_quant_matrix(qscale: int = 2) -> np.ndarray:
    """intra_matrix in raster order (mpegvideo_enc.c:2866-2876)."""
    m = np.empty(64, dtype=np.int32)
    m[0] = T.MPEG1_INTRA_MATRIX[0]
    scaled = (T.MPEG1_INTRA_MATRIX[1:] * qscale) >> 3
    m[1:] = np.clip(scaled, 0, 255)
    return m


def encoder_qmat(qscale: int = 2) -> np.ndarray:
    """q_intra_matrix[8] (ff_convert_matrix for jpeg fdct, QMAT_SHIFT=22)."""
    m = encoder_quant_matrix(qscale)
    return ((1 << 22) // (8 * m.astype(np.int64))).astype(np.int32)


def fdct_islow(block: np.ndarray) -> np.ndarray:
    """ff_jpeg_fdct_islow, bit-exact (jfdctint.c:184-341).

    block: int [8,8] (pixel values 0..255 as int16); returns int16 [8,8].
    """
    CONST_BITS, PASS1_BITS = 13, 4
    F = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373,
             c1175=9633, c1501=12299, c1847=15137, c1961=16069,
             c2053=16819, c2562=20995, c3072=25172)

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    data = block.astype(np.int64).copy()
    # Pass 1: rows
    for r in range(8):
        d = data[r]
        t0, t7 = d[0] + d[7], d[0] - d[7]
        t1, t6 = d[1] + d[6], d[1] - d[6]
        t2, t5 = d[2] + d[5], d[2] - d[5]
        t3, t4 = d[3] + d[4], d[3] - d[4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        d[0] = _i16((t10 + t11) << PASS1_BITS)
        d[4] = _i16((t10 - t11) << PASS1_BITS)
        z1 = (t12 + t13) * F["c0541"]
        d[2] = _i16(descale(z1 + t13 * F["c0765"], CONST_BITS - PASS1_BITS))
        d[6] = _i16(descale(z1 - t12 * F["c1847"], CONST_BITS - PASS1_BITS))
        z1, z2 = t4 + t7, t5 + t6
        z3, z4 = t4 + t6, t5 + t7
        z5 = (z3 + z4) * F["c1175"]
        t4 *= F["c0298"]
        t5 *= F["c2053"]
        t6 *= F["c3072"]
        t7 *= F["c1501"]
        z1 *= -F["c0899"]
        z2 *= -F["c2562"]
        z3 = z3 * -F["c1961"] + z5
        z4 = z4 * -F["c0390"] + z5
        d[7] = _i16(descale(t4 + z1 + z3, CONST_BITS - PASS1_BITS))
        d[5] = _i16(descale(t5 + z2 + z4, CONST_BITS - PASS1_BITS))
        d[3] = _i16(descale(t6 + z2 + z3, CONST_BITS - PASS1_BITS))
        d[1] = _i16(descale(t7 + z1 + z4, CONST_BITS - PASS1_BITS))
    # Pass 2: columns
    for c in range(8):
        d = data[:, c]
        t0, t7 = d[0] + d[7], d[0] - d[7]
        t1, t6 = d[1] + d[6], d[1] - d[6]
        t2, t5 = d[2] + d[5], d[2] - d[5]
        t3, t4 = d[3] + d[4], d[3] - d[4]
        t10, t13 = t0 + t3, t0 - t3
        t11, t12 = t1 + t2, t1 - t2
        d[0] = _i16(descale(t10 + t11, PASS1_BITS))
        d[4] = _i16(descale(t10 - t11, PASS1_BITS))
        z1 = (t12 + t13) * F["c0541"]
        d[2] = _i16(descale(z1 + t13 * F["c0765"], CONST_BITS + PASS1_BITS))
        d[6] = _i16(descale(z1 - t12 * F["c1847"], CONST_BITS + PASS1_BITS))
        z1, z2 = t4 + t7, t5 + t6
        z3, z4 = t4 + t6, t5 + t7
        z5 = (z3 + z4) * F["c1175"]
        t4 *= F["c0298"]
        t5 *= F["c2053"]
        t6 *= F["c3072"]
        t7 *= F["c1501"]
        z1 *= -F["c0899"]
        z2 *= -F["c2562"]
        z3 = z3 * -F["c1961"] + z5
        z4 = z4 * -F["c0390"] + z5
        d[7] = _i16(descale(t4 + z1 + z3, CONST_BITS + PASS1_BITS))
        d[5] = _i16(descale(t5 + z2 + z4, CONST_BITS + PASS1_BITS))
        d[3] = _i16(descale(t6 + z2 + z3, CONST_BITS + PASS1_BITS))
        d[1] = _i16(descale(t7 + z1 + z4, CONST_BITS + PASS1_BITS))
    return data.astype(np.int16)


def dct_quantize(block_pixels: np.ndarray, qmat: np.ndarray):
    """get_pixels + fdct + dct_quantize_c (intra, bias=0) + clip_coeffs.

    block_pixels: uint8 [8,8].  Returns (levels int16[8,8] raster,
    last_nonzero scan index).
    """
    block = fdct_islow(block_pixels.astype(np.int16))
    flat = block.astype(np.int64).reshape(64)
    # DC: q = dc_scale(8)<<3 = 64; block[0] assumed positive
    flat[0] = (flat[0] + 32) // 64
    threshold1 = (1 << 22) - 0 - 1
    last_non_zero = 0
    out = np.zeros(64, dtype=np.int64)
    out[0] = flat[0]
    for i in range(63, 0, -1):
        j = int(T.ZIGZAG[i])
        # C: int32 multiply (wraps)
        level = ((flat[j] * int(qmat[j]) + 0x80000000) & 0xFFFFFFFF) - 0x80000000
        if abs(level) > threshold1:
            last_non_zero = i
            break
    for i in range(1, last_non_zero + 1):
        j = int(T.ZIGZAG[i])
        level = ((flat[j] * int(qmat[j]) + 0x80000000) & 0xFFFFFFFF) - 0x80000000
        if abs(level) > threshold1:
            if level > 0:
                out[j] = level >> 22
            else:
                out[j] = -((-level) >> 22)
        else:
            out[j] = 0
    # clip_coeffs (mpegvideo_enc.c:1403-1433): only applied on overflow, but
    # clipping to +/-1023 is a no-op when no value exceeds it.
    out[1:] = np.clip(out[1:], -1023, 1023)
    return out.astype(np.int16).reshape(8, 8), last_non_zero


def _encode_dc(bw: BitWriter, diff: int, table):
    sizes, codes = table
    if diff == 0:
        bw.put_bits(int(sizes[0]), int(codes[0]))
        return
    mant = diff
    val = diff
    if val < 0:
        val = -val
        mant -= 1
    nbits = val.bit_length()
    bw.put_bits(int(sizes[nbits]), int(codes[nbits]))
    bw.put_bits(nbits, mant & ((1 << nbits) - 1))


def _encode_block(bw: BitWriter, levels: np.ndarray, last_index: int,
                  last_dc: int, dc_table, ac_table):
    sizes, codes = ac_table
    dc = int(levels[0, 0])
    _encode_dc(bw, dc - last_dc, dc_table)
    flat = levels.reshape(64)
    run = 0
    for i in range(1, last_index + 1):
        j = int(T.ZIGZAG[i])
        val = int(flat[j])
        if val == 0:
            run += 1
            continue
        while run >= 16:
            bw.put_bits(int(sizes[0xF0]), int(codes[0xF0]))
            run -= 16
        mant = val
        if val < 0:
            val = -val
            mant -= 1
        nbits = val.bit_length()
        code = (run << 4) | nbits
        bw.put_bits(int(sizes[code]), int(codes[code]))
        bw.put_bits(nbits, mant & ((1 << nbits) - 1))
        run = 0
    if last_index < 63 or run != 0:
        bw.put_bits(int(sizes[0]), int(codes[0]))
    return dc


def escape_ff(scan: bytes) -> bytes:
    """0xFF -> 0xFF 0x00 in the entropy-coded segment (escape_FF semantics)."""
    return scan.replace(b"\xFF", b"\xFF\x00")


def flip_pad_plane(plane: np.ndarray, coded_h: int, coded_w: int) -> np.ndarray:
    """Flip vertically and pad to coded dims by edge replication.

    Replicates amv_encode_picture's negative-linesize flip plus
    ff_emulated_edge_mc's clamp for MBs past the bottom/right edge.
    """
    flipped = plane[::-1]
    out = np.empty((coded_h, coded_w), dtype=plane.dtype)
    h, w = plane.shape
    out[:h, :w] = flipped
    if coded_h > h:
        out[h:, :w] = flipped[h - 1]
    if coded_w > w:
        out[:, w:] = out[:, w - 1:w]
    return out


def encode_frame(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                 qscale: int = 2) -> bytes:
    """Encode YUV420 planes into one AMV '00dc' payload."""
    height, width = y.shape
    mb_w = (width + 15) // 16
    mb_h = (height + 15) // 16
    qmat = encoder_qmat(qscale)

    yc = flip_pad_plane(y, 16 * mb_h, 16 * mb_w)
    cbc = flip_pad_plane(cb, 8 * mb_h, 8 * mb_w)
    crc = flip_pad_plane(cr, 8 * mb_h, 8 * mb_w)

    bw = BitWriter()
    last_dc = [128, 128, 128]
    for my in range(mb_h):
        for mx in range(mb_w):
            blocks = [
                yc[my * 16:my * 16 + 8, mx * 16:mx * 16 + 8],
                yc[my * 16:my * 16 + 8, mx * 16 + 8:mx * 16 + 16],
                yc[my * 16 + 8:my * 16 + 16, mx * 16:mx * 16 + 8],
                yc[my * 16 + 8:my * 16 + 16, mx * 16 + 8:mx * 16 + 16],
                cbc[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8],
                crc[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8],
            ]
            for b, px in enumerate(blocks):
                levels, lnz = dct_quantize(px, qmat)
                comp = 0 if b < 4 else (b & 1) + 1
                dc_t = _ENC_DC_L if b < 4 else _ENC_DC_C
                ac_t = _ENC_AC_L if b < 4 else _ENC_AC_C
                last_dc[comp] = _encode_block(
                    bw, levels, lnz, last_dc[comp], dc_t, ac_t)
    # stuffing to byte boundary with 1-bits
    pad = (-bw.bit_count()) & 7
    if pad:
        bw.put_bits(pad, (1 << pad) - 1)
    scan = bw.flush()
    return b"\xFF\xD8" + escape_ff(scan) + b"\xFF\xD9"
