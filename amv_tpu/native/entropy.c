/*
 * Native entropy codec + single-core scalar reference for the AMV
 * MJPEG-variant, plus scalar IMA-ADPCM reference.
 *
 * Two roles:
 *  1. fast host-side Huffman scan decode/encode feeding the device kernels
 *     (the bit-serial boundary of the pipeline);
 *  2. a faithful single-core C implementation of the full reference decode
 *     and encode paths (entropy + integer DCT + assembly), the byte oracle
 *     of the device chain and a single-core C anchor for its speed.
 *
 * Algorithms reimplemented from the reference semantics (sp5xdec.c,
 * mjpegdec.c decode_block/mjpeg_decode_scan, simple_idct.c, jfdctint.c,
 * mpegvideo_enc.c dct_quantize_c, mjpegenc.c encode_block/escape_FF,
 * adpcm.c IMA-AMV cases); constants are the public JPEG K.3 / MPEG-1
 * tables. No reference code is copied.
 *
 * Build: gcc -O2 -shared -fPIC -o libamventropy.so entropy.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#ifdef __SSE2__
#include <emmintrin.h>
#endif

#define API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Tables                                                              */
/* ------------------------------------------------------------------ */

static const uint8_t zigzag[64] = {
     0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63
};

/* K.3 Huffman specs (JPEG standard) */
static const uint8_t bits_dc_l[17] = {0,0,1,5,1,1,1,1,1,1,0,0,0,0,0,0,0};
static const uint8_t vals_dc[12]   = {0,1,2,3,4,5,6,7,8,9,10,11};
static const uint8_t bits_dc_c[17] = {0,0,3,1,1,1,1,1,1,1,1,1,0,0,0,0,0};
static const uint8_t bits_ac_l[17] = {0,0,2,1,3,3,2,4,3,5,5,4,4,0,0,1,0x7d};
static const uint8_t vals_ac_l[162] = {
    0x01,0x02,0x03,0x00,0x04,0x11,0x05,0x12,0x21,0x31,0x41,0x06,0x13,0x51,0x61,0x07,
    0x22,0x71,0x14,0x32,0x81,0x91,0xa1,0x08,0x23,0x42,0xb1,0xc1,0x15,0x52,0xd1,0xf0,
    0x24,0x33,0x62,0x72,0x82,0x09,0x0a,0x16,0x17,0x18,0x19,0x1a,0x25,0x26,0x27,0x28,
    0x29,0x2a,0x34,0x35,0x36,0x37,0x38,0x39,0x3a,0x43,0x44,0x45,0x46,0x47,0x48,0x49,
    0x4a,0x53,0x54,0x55,0x56,0x57,0x58,0x59,0x5a,0x63,0x64,0x65,0x66,0x67,0x68,0x69,
    0x6a,0x73,0x74,0x75,0x76,0x77,0x78,0x79,0x7a,0x83,0x84,0x85,0x86,0x87,0x88,0x89,
    0x8a,0x92,0x93,0x94,0x95,0x96,0x97,0x98,0x99,0x9a,0xa2,0xa3,0xa4,0xa5,0xa6,0xa7,
    0xa8,0xa9,0xaa,0xb2,0xb3,0xb4,0xb5,0xb6,0xb7,0xb8,0xb9,0xba,0xc2,0xc3,0xc4,0xc5,
    0xc6,0xc7,0xc8,0xc9,0xca,0xd2,0xd3,0xd4,0xd5,0xd6,0xd7,0xd8,0xd9,0xda,0xe1,0xe2,
    0xe3,0xe4,0xe5,0xe6,0xe7,0xe8,0xe9,0xea,0xf1,0xf2,0xf3,0xf4,0xf5,0xf6,0xf7,0xf8,
    0xf9,0xfa
};
static const uint8_t bits_ac_c[17] = {0,0,2,1,2,4,4,3,4,7,5,4,4,0,1,2,0x77};
static const uint8_t vals_ac_c[162] = {
    0x00,0x01,0x02,0x03,0x11,0x04,0x05,0x21,0x31,0x06,0x12,0x41,0x51,0x07,0x61,0x71,
    0x13,0x22,0x32,0x81,0x08,0x14,0x42,0x91,0xa1,0xb1,0xc1,0x09,0x23,0x33,0x52,0xf0,
    0x15,0x62,0x72,0xd1,0x0a,0x16,0x24,0x34,0xe1,0x25,0xf1,0x17,0x18,0x19,0x1a,0x26,
    0x27,0x28,0x29,0x2a,0x35,0x36,0x37,0x38,0x39,0x3a,0x43,0x44,0x45,0x46,0x47,0x48,
    0x49,0x4a,0x53,0x54,0x55,0x56,0x57,0x58,0x59,0x5a,0x63,0x64,0x65,0x66,0x67,0x68,
    0x69,0x6a,0x73,0x74,0x75,0x76,0x77,0x78,0x79,0x7a,0x82,0x83,0x84,0x85,0x86,0x87,
    0x88,0x89,0x8a,0x92,0x93,0x94,0x95,0x96,0x97,0x98,0x99,0x9a,0xa2,0xa3,0xa4,0xa5,
    0xa6,0xa7,0xa8,0xa9,0xaa,0xb2,0xb3,0xb4,0xb5,0xb6,0xb7,0xb8,0xb9,0xba,0xc2,0xc3,
    0xc4,0xc5,0xc6,0xc7,0xc8,0xc9,0xca,0xd2,0xd3,0xd4,0xd5,0xd6,0xd7,0xd8,0xd9,0xda,
    0xe2,0xe3,0xe4,0xe5,0xe6,0xe7,0xe8,0xe9,0xea,0xf2,0xf3,0xf4,0xf5,0xf6,0xf7,0xf8,
    0xf9,0xfa
};

/* sp5x Q60 quant pair, zigzag order (decoder tables) */
static const int32_t q60_l[64] = {
    13, 9,10,11,10, 8,13,11,10,11,14,14,13,15,19,32,
    21,19,18,18,19,39,28,30,23,32,46,41,49,48,46,41,
    45,44,51,58,74,62,51,54,70,55,44,45,64,87,65,70,
    76,78,82,83,82,50,62,90,97,90,80,96,74,81,82,79
};
static const int32_t q60_c[64] = {
    14,14,14,19,17,19,38,21,21,38,79,53,45,53,79,79,
    79,79,79,79,79,79,79,79,79,79,79,79,79,79,79,79,
    79,79,79,79,79,79,79,79,79,79,79,79,79,79,79,79,
    79,79,79,79,79,79,79,79,79,79,79,79,79,79,79,79
};

/* MPEG-1 default intra matrix, raster order (encoder matrix basis) */
static const int32_t mpeg1_intra[64] = {
     8,16,19,22,26,27,29,34,16,16,22,24,27,29,34,37,
    19,22,26,27,29,34,34,38,22,22,26,27,29,34,37,40,
    22,26,27,29,32,35,40,48,26,27,29,32,35,40,48,58,
    26,27,29,34,38,46,56,69,27,29,35,38,46,56,69,83
};

/* ------------------------------------------------------------------ */
/* Huffman decode LUTs (16-bit peek)                                   */
/* ------------------------------------------------------------------ */

/* One fused entry per 16-bit peek: (sym << 5) | len, len in 1..16
 * (0 = invalid code).  One load + one cache line per token instead of
 * the two parallel byte arrays the r4 decoder used.  e1 is an
 * L1-resident 256-entry first level for codes of <= 8 bits (the vast
 * majority of tokens): the 128 KB e[] table is effectively a random
 * L2 access per token (the low peek bits are the *next* stream bits),
 * and that load latency sits on the serial token critical path. */
typedef struct { uint16_t e1[256]; uint16_t e[65536]; } DecTable;
typedef struct { uint16_t code[256]; uint8_t size[256]; } EncTable;

static DecTable dt_dc_l, dt_dc_c, dt_ac_l, dt_ac_c;
static EncTable et_dc_l, et_dc_c, et_ac_l, et_ac_c;
static int tables_ready = 0;

/* Returns 0, or -1 for an infeasible table (code counts violating the
 * Kraft bound, or more than 256 values).  Untrusted DHT data reaches
 * this through amv_decode_scans_custom: without the `code >= 1<<L`
 * check a non-canonical bits[] walks `prefix + t` past the 65536-entry
 * LUT — a heap overflow (found by tests/test_fuzz_parsers.py). */
static int build_tables_one(DecTable *dt, EncTable *et,
                            const uint8_t *bits, const uint8_t *vals) {
    memset(dt->e, 0, sizeof(dt->e));
    memset(dt->e1, 0, sizeof(dt->e1));
    memset(et->size, 0, sizeof(et->size));
    uint32_t code = 0; int k = 0;
    for (int L = 1; L <= 16; L++) {
        for (int j = 0; j < bits[L]; j++) {
            if (k >= 256 || code >= (1u << L)) return -1;
            int sym = vals[k++];
            et->code[sym] = (uint16_t)code;
            et->size[sym] = (uint8_t)L;
            uint32_t prefix = code << (16 - L);
            uint32_t span = 1u << (16 - L);
            uint16_t ent = (uint16_t)((sym << 5) | L);
            for (uint32_t t = 0; t < span; t++)
                dt->e[prefix + t] = ent;
            code++;
        }
        code <<= 1;
    }
    for (int p = 0; p < 256; p++) {
        uint16_t ent = dt->e[p << 8];
        dt->e1[p] = (uint16_t)((ent & 31) <= 8 ? ent : 0);
    }
    return 0;
}

static void ensure_tables(void) {
    if (tables_ready) return;
    /* spec constants — always feasible */
    (void)build_tables_one(&dt_dc_l, &et_dc_l, bits_dc_l, vals_dc);
    (void)build_tables_one(&dt_dc_c, &et_dc_c, bits_dc_c, vals_dc);
    (void)build_tables_one(&dt_ac_l, &et_ac_l, bits_ac_l, vals_ac_l);
    (void)build_tables_one(&dt_ac_c, &et_ac_c, bits_ac_c, vals_ac_c);
    tables_ready = 1;
}

/* ------------------------------------------------------------------ */
/* Bit reader (MSB-first, 64-bit cache; zero-fill past the end)        */
/* ------------------------------------------------------------------ */

typedef struct {
    const uint8_t *buf;
    size_t size;
    size_t byte_pos;
    uint64_t cache;   /* top `bits` bits valid, MSB-aligned */
    int bits;
} BitReader;

static void br_init(BitReader *br, const uint8_t *buf, size_t size) {
    br->buf = buf; br->size = size; br->byte_pos = 0; br->cache = 0; br->bits = 0;
}

static inline void br_fill(BitReader *br) {
    if (br->bits >= 56) return;               /* >= 56 valid bits already */
    if (br->byte_pos + 8 <= br->size) {
        /* bulk refill: one 8-byte unaligned load + bswap replaces the
         * r4 per-byte while loop (a branch per byte was the decode hot
         * loop's biggest single cost).  Mask keeps the "bits above
         * `bits` are zero" invariant the tail path relies on. */
        uint64_t v;
        memcpy(&v, br->buf + br->byte_pos, 8);
        int nb = br->bits | 56;               /* new valid-bit count */
        br->cache |= (__builtin_bswap64(v) >> br->bits) &
                     (~0ull << (64 - nb));
        br->byte_pos += (size_t)((nb - br->bits) >> 3);
        br->bits = nb;
        return;
    }
    while (br->bits <= 56) {                  /* zero-fill tail */
        uint64_t b = (br->byte_pos < br->size) ? br->buf[br->byte_pos] : 0;
        br->byte_pos++;
        br->cache |= b << (56 - br->bits);
        br->bits += 8;
    }
}

static inline uint32_t br_peek16(BitReader *br) {
    br_fill(br);
    return (uint32_t)(br->cache >> 48);
}

static inline void br_skip(BitReader *br, int n) {
    br->cache <<= n;
    br->bits -= n;
}

static inline int32_t br_get_xbits_nf(BitReader *br, int n) {
    /* no-refill variant: caller guarantees >= n valid bits (true right
     * after a peek-fill + skip(<=16): bits >= 56-16 = 40 >= 16).
     * Branchless JPEG extend: the sign bit of a coefficient is random,
     * so the naive `if (v < 2^(n-1))` mispredicts ~half of all level
     * tokens (~15 cycles each on this core). */
    uint32_t v = (uint32_t)(br->cache >> (64 - n));
    br_skip(br, n);
    uint32_t neg = ((v >> (n - 1)) & 1u) - 1u;   /* 0 or all-ones */
    return (int32_t)(v - (neg & ((1u << n) - 1u)));
}

static inline int32_t br_get_xbits(BitReader *br, int n) {
    /* JPEG extend: value v of n bits; if MSB==0 -> v - 2^n + 1 */
    br_fill(br);
    return br_get_xbits_nf(br, n);
}

/* ------------------------------------------------------------------ */
/* Scan unescape (mjpegdec 0xFF00 removal)                             */
/* ------------------------------------------------------------------ */

/* mjpegdec.c:1176-1199 semantics: FF 00 -> FF (stuffing removal),
 * consecutive FFs collapse, FF D0-D7 (RSTn) passes through for the
 * restart resync in the block decoder, any other marker ends the scan
 * BEFORE its 0xFF prefix (mjpegdec.c:1181 `t -= 2`), so the scan never
 * carries a trailing marker prefix byte. */
static size_t unescape(const uint8_t *src, size_t n, uint8_t *dst) {
    size_t i = 0, j = 0;
#ifdef __SSE2__
    /* bulk path: 0xFF bytes are rare (~1/256 of scan data), so scan 16
     * bytes per compare+movemask and memcpy FF-free spans wholesale;
     * each FF is then handled by the same scalar sequence as the tail
     * loop below (identical semantics, byte for byte). */
    {
        const __m128i ff = _mm_set1_epi8((char)0xFF);
        while (i + 16 <= n) {
            __m128i v = _mm_loadu_si128((const __m128i *)(src + i));
            int m = _mm_movemask_epi8(_mm_cmpeq_epi8(v, ff));
            if (m == 0) {
                _mm_storeu_si128((__m128i *)(dst + j), v);
                i += 16; j += 16;
                continue;
            }
            int k = __builtin_ctz((unsigned)m);
            memcpy(dst + j, src + i, (size_t)k);
            i += (size_t)k; j += (size_t)k;
            dst[j++] = src[i++];               /* the 0xFF itself */
            while (i < n && src[i] == 0xFF) i++;
            if (i >= n) return j;
            uint8_t x = src[i++];
            if (x >= 0xD0 && x <= 0xD7) dst[j++] = x;
            else if (x) { j--; return j; }     /* marker: scan ends */
        }
    }
#endif
    while (i < n) {
        uint8_t x = src[i++];
        dst[j++] = x;
        if (x == 0xFF) {
            while (i < n && src[i] == 0xFF) i++;
            if (i >= n) break;
            x = src[i++];
            if (x >= 0xD0 && x <= 0xD7) dst[j++] = x;
            else if (x) { j--; break; }
        }
    }
    return j;
}

/* ------------------------------------------------------------------ */
/* Huffman scan decode -> zigzag levels                                */
/* ------------------------------------------------------------------ */

static int decode_scan_levels(const uint8_t *scan, size_t scan_len,
                              int n_mcu, int16_t *out /* [n_mcu*6*64] */) {
    BitReader br;
    br_init(&br, scan, scan_len);
    for (int m = 0; m < n_mcu; m++) {
        for (int b = 0; b < 6; b++) {
            int luma = b < 4;
            DecTable *dc = luma ? &dt_dc_l : &dt_dc_c;
            DecTable *ac = luma ? &dt_ac_l : &dt_ac_c;
            int16_t *blk = out + ((size_t)m * 6 + b) * 64;
            /* zero per block, not per frame: the 36 KB frame memset
             * evicted its own lines from L1 before the sparse level
             * stores came back to them */
            memset(blk, 0, 64 * sizeof(int16_t));
            uint32_t peek = br_peek16(&br);
            uint32_t ent = dc->e1[peek >> 8];
            if (!ent) ent = dc->e[peek];
            int len = (int)(ent & 31);
            if (!len) return -(int)(m * 6 + b + 1);
            int sym = (int)(ent >> 5);
            br_skip(&br, len);
            blk[0] = sym ? (int16_t)br_get_xbits_nf(&br, sym) : 0;
            int i = 0;
            for (;;) {
                peek = br_peek16(&br);
                ent = ac->e1[peek >> 8];
                if (!ent) ent = ac->e[peek];
                len = (int)(ent & 31);
                if (!len) return -(int)(m * 6 + b + 1);
                sym = (int)(ent >> 5);
                br_skip(&br, len);
                if (sym == 0x00) break;          /* EOB */
                int run = sym >> 4, size = sym & 0xF;
                if (size == 0) {
                    if (run != 15) return -(int)(m * 6 + b + 1);
                    i += 16;                      /* ZRL */
                    continue;
                }
                int32_t level = br_get_xbits_nf(&br, size);
                i += run + 1;
                if (i > 63) return -(int)(m * 6 + b + 1);
                blk[i] = (int16_t)level;
                if (i == 63) break;               /* no EOB after pos 63 */
            }
        }
    }
    return 0;
}

/* Batch unescape + row packing for the device-side entropy decoder:
 * strips SOI/EOI framing, removes 0xFF00 stuffing, writes each scan
 * into a zero-padded row of dst (row_stride bytes).  Returns the
 * longest scan length, or -1 on overflow. */
API int64_t amv_unescape_frames(const uint8_t *payload_blob,
                                const int64_t *offsets, const int64_t *sizes,
                                int n_frames, uint8_t *dst,
                                int64_t row_stride, int64_t *out_lens) {
    int64_t maxlen = 0;
    for (int f = 0; f < n_frames; f++) {
        const uint8_t *p = payload_blob + offsets[f];
        int64_t sz = sizes[f];
        if (sz < 4) { out_lens[f] = 0; continue; }
        if (sz - 4 > row_stride) return -1;
        size_t l = unescape(p + 2, (size_t)sz - 4, dst + (size_t)f * row_stride);
        out_lens[f] = (int64_t)l;
        if ((int64_t)l > maxlen) maxlen = (int64_t)l;
    }
    return maxlen;
}

/* Inverse of amv_unescape_frames for the device entropy ENCODER: takes
 * per-frame big-endian scan words + bit counts (bits beyond the count
 * are zero), applies the 1-bit stuffing pad (mjpegenc
 * ff_mjpeg_encode_stuffing), 0xFF00 escaping (escape_FF) and SOI/EOI
 * framing.  Returns 0 or -(frame+1) on row overflow. */
API int64_t amv_escape_frames(const int32_t *words, int64_t w_out,
                              const int64_t *bits, int n_frames,
                              uint8_t *dst, int64_t dst_stride,
                              int64_t *out_lens) {
    for (int f = 0; f < n_frames; f++) {
        const int32_t *w = words + (size_t)f * w_out;
        int64_t nbits = bits[f];
        int64_t nbytes = (nbits + 7) >> 3;
        if (nbytes > w_out * 4) return -(f + 1);
        uint8_t *d = dst + (size_t)f * dst_stride;
        int64_t j = 0;
        d[j++] = 0xFF; d[j++] = 0xD8;                    /* SOI */
        for (int64_t i = 0; i < nbytes; i++) {
            uint8_t b = (uint8_t)(((uint32_t)w[i >> 2]) >> (24 - 8 * (i & 3)));
            if (i == nbytes - 1) {
                int pad = (int)((8 - (nbits & 7)) & 7);
                b |= (uint8_t)((1u << pad) - 1);         /* 1-stuffing */
            }
            if (j + 4 > dst_stride) return -(f + 1);
            d[j++] = b;
            if (b == 0xFF) d[j++] = 0x00;                /* escape_FF */
        }
        d[j++] = 0xFF; d[j++] = 0xD9;                    /* EOI */
        out_lens[f] = j;
    }
    return 0;
}

API int amv_decode_frames(const uint8_t *payload_blob, const int64_t *offsets,
                          const int64_t *sizes, int n_frames, int n_mcu,
                          int16_t *out_levels) {
    ensure_tables();
    size_t max_sz = 0;
    for (int f = 0; f < n_frames; f++)
        if ((size_t)sizes[f] > max_sz) max_sz = (size_t)sizes[f];
    uint8_t *tmp = (uint8_t *)malloc(max_sz + 64);
    if (!tmp) return -1000000;
    int rc = 0;
    for (int f = 0; f < n_frames; f++) {
        const uint8_t *p = payload_blob + offsets[f];
        int64_t sz = sizes[f];
        if (sz < 4) { rc = -2000000 - f; break; }
        size_t scan_len = unescape(p + 2, (size_t)sz - 4, tmp);
        int r = decode_scan_levels(tmp, scan_len, n_mcu,
                                   out_levels + (size_t)f * n_mcu * 6 * 64);
        if (r < 0) { rc = r - 3000000; break; }
    }
    free(tmp);
    return rc;
}

/* Generic-table variant for standard baseline MJPEG (mjpegdec.c with
 * per-frame DHT): caller supplies up to 8 Huffman specs (slots 0-3 = DC
 * classes id 0-3, slots 4-7 = AC id 0-3) and a per-block (dc,ac) slot map
 * for the n_blk blocks of one interleaved MCU (6 for 4:2:0, 4 for 4:2:2,
 * 3 for 4:4:4, 1 for grayscale).  restart_interval > 0 resyncs to the
 * byte-aligned RSTn marker every that many MCUs (mjpegdec.c:533-548;
 * DC prediction reset is the caller's segmented cumsum — levels here are
 * raw differences).  Input rows are raw *escaped* scan bytes (no SOI/EOI
 * framing).  Levels come out in zigzag order with slot 0 = DC difference,
 * same contract as amv_decode_frames. */
API int amv_decode_scans_custom(const uint8_t *scan_blob,
                                const int64_t *offsets, const int64_t *sizes,
                                int n_frames, int n_mcu, int n_blk,
                                int restart_interval,
                                const uint8_t *bits8 /* [8][17] */,
                                const uint8_t *vals8 /* [8][256] */,
                                const uint8_t *tab_ids /* [n_blk][2] */,
                                int16_t *out_levels) {
    DecTable *tabs = (DecTable *)malloc(8 * sizeof(DecTable));
    if (!tabs) return -1000000;
    EncTable scratch;
    int bad[8];
    for (int t = 0; t < 8; t++)
        bad[t] = build_tables_one(&tabs[t], &scratch,
                                  bits8 + t * 17, vals8 + t * 256) != 0;
    for (int b = 0; b < n_blk; b++) {
        int di = tab_ids[b * 2], ai = tab_ids[b * 2 + 1];
        if (di > 7 || ai > 7 || bad[di] || bad[ai]) {
            free(tabs);
            return -7000000 - b;   /* malformed or unusable table */
        }
    }
    size_t max_sz = 0;
    for (int f = 0; f < n_frames; f++)
        if ((size_t)sizes[f] > max_sz) max_sz = (size_t)sizes[f];
    uint8_t *tmp = (uint8_t *)malloc(max_sz + 64);
    if (!tmp) { free(tabs); return -1000000; }
    int rc = 0;
    for (int f = 0; f < n_frames && rc == 0; f++) {
        size_t scan_len = unescape(scan_blob + offsets[f],
                                   (size_t)sizes[f], tmp);
        int16_t *out = out_levels + (size_t)f * n_mcu * n_blk * 64;
        memset(out, 0, (size_t)n_mcu * n_blk * 64 * sizeof(int16_t));
        BitReader br;
        br_init(&br, tmp, scan_len);
        for (int m = 0; m < n_mcu && rc == 0; m++) {
            if (restart_interval > 0 && m > 0 && m % restart_interval == 0) {
                br_skip(&br, br.bits & 7);        /* byte align */
                uint32_t pk = br_peek16(&br);
                if ((pk & 0xFFF8) == 0xFFD0) br_skip(&br, 16);
                else { rc = -(int)(m * n_blk + 1) - 4000000; break; }
            }
            for (int b = 0; b < n_blk; b++) {
                DecTable *dc = &tabs[tab_ids[b * 2]];
                DecTable *ac = &tabs[tab_ids[b * 2 + 1]];
                int16_t *blk = out + ((size_t)m * n_blk + b) * 64;
                uint32_t peek = br_peek16(&br);
                uint32_t ent = dc->e1[peek >> 8];
                if (!ent) ent = dc->e[peek];
                int len = (int)(ent & 31);
                if (!len) { rc = -(int)(m * n_blk + b + 1) - 3000000; break; }
                int sym = (int)(ent >> 5);
                /* custom tables may map any 0..255 value here, but a DC
                 * size > 15 is malformed (and would shift-overflow the
                 * 64-bit xbits read) — mjpegdec.c rejects it the same */
                if (sym > 15) { rc = -(int)(m * n_blk + b + 1) - 3000000; break; }
                br_skip(&br, len);
                blk[0] = sym ? (int16_t)br_get_xbits_nf(&br, sym) : 0;
                int i = 0;
                for (;;) {
                    peek = br_peek16(&br);
                    ent = ac->e1[peek >> 8];
                    if (!ent) ent = ac->e[peek];
                    len = (int)(ent & 31);
                    if (!len) { rc = -(int)(m * n_blk + b + 1) - 3000000; break; }
                    sym = (int)(ent >> 5);
                    br_skip(&br, len);
                    if (sym == 0x00) break;
                    int run = sym >> 4, size = sym & 0xF;
                    if (size == 0) {
                        if (run != 15) { rc = -(int)(m * n_blk + b + 1) - 3000000; break; }
                        i += 16;
                        continue;
                    }
                    int32_t level = br_get_xbits_nf(&br, size);
                    i += run + 1;
                    if (i > 63) { rc = -(int)(m * n_blk + b + 1) - 3000000; break; }
                    blk[i] = (int16_t)level;
                    if (i == 63) break;
                }
                if (rc) break;
            }
        }
    }
    free(tmp);
    free(tabs);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Bit writer                                                          */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *buf;
    size_t cap, len;
    uint64_t acc;
    int bits;
} BitWriter;

static void bw_init(BitWriter *bw, uint8_t *buf, size_t cap) {
    bw->buf = buf; bw->cap = cap; bw->len = 0; bw->acc = 0; bw->bits = 0;
}

static inline void bw_put(BitWriter *bw, int n, uint32_t v) {
    bw->acc = (bw->acc << n) | (v & ((1u << n) - 1));
    bw->bits += n;
    while (bw->bits >= 8) {
        bw->bits -= 8;
        if (bw->len < bw->cap) bw->buf[bw->len] = (uint8_t)(bw->acc >> bw->bits);
        bw->len++;
    }
    bw->acc &= (1ull << bw->bits) - 1;
}

/* ------------------------------------------------------------------ */
/* Entropy encode from zigzag levels (mjpegenc encode_block semantics) */
/* ------------------------------------------------------------------ */

static inline int bitlen(uint32_t v) { return 32 - __builtin_clz(v); }

static void encode_dc(BitWriter *bw, int diff, EncTable *et) {
    if (diff == 0) { bw_put(bw, et->size[0], et->code[0]); return; }
    int mant = diff, val = diff;
    if (val < 0) { val = -val; mant--; }
    int n = bitlen((uint32_t)val);
    bw_put(bw, et->size[n], et->code[n]);
    bw_put(bw, n, (uint32_t)mant & ((1u << n) - 1));
}

API int64_t amv_encode_frame(const int16_t *levels /* [n_mcu*6*64] zigzag */,
                             int n_mcu, uint8_t *out, int64_t out_cap) {
    ensure_tables();
    /* scan bits into a temp buffer, then escape 0xFF while emitting */
    size_t scan_cap = (size_t)n_mcu * 6 * 64 * 4 + 1024;
    uint8_t *scan = (uint8_t *)malloc(scan_cap);
    if (!scan) return -1;
    BitWriter bw;
    bw_init(&bw, scan, scan_cap);
    int last_dc[3] = {128, 128, 128};
    for (int m = 0; m < n_mcu; m++) {
        for (int b = 0; b < 6; b++) {
            int luma = b < 4;
            int comp = luma ? 0 : (b & 1) + 1;
            EncTable *dct = luma ? &et_dc_l : &et_dc_c;
            EncTable *act = luma ? &et_ac_l : &et_ac_c;
            const int16_t *blk = levels + ((size_t)m * 6 + b) * 64;
            int dc = blk[0];
            encode_dc(&bw, dc - last_dc[comp], dct);
            last_dc[comp] = dc;
            int run = 0, wrote63 = 0;
            for (int i = 1; i < 64; i++) {
                int val = blk[i];
                if (!val) { run++; continue; }
                while (run >= 16) { bw_put(&bw, act->size[0xF0], act->code[0xF0]); run -= 16; }
                int mant = val;
                if (val < 0) { val = -val; mant--; }
                int n = bitlen((uint32_t)val);
                int code = (run << 4) | n;
                bw_put(&bw, act->size[code], act->code[code]);
                bw_put(&bw, n, (uint32_t)mant & ((1u << n) - 1));
                run = 0;
                if (i == 63) wrote63 = 1;
            }
            if (!wrote63)
                bw_put(&bw, act->size[0], act->code[0]);  /* EOB */
        }
    }
    int pad = (8 - (bw.bits & 7)) & 7;
    if (pad) bw_put(&bw, pad, (1u << pad) - 1);
    size_t scan_len = bw.len;
    if (scan_len > scan_cap) { free(scan); return -2; }
    /* assemble: SOI + escaped scan + EOI */
    int64_t j = 0;
    if (out_cap < 4) { free(scan); return -3; }
    out[j++] = 0xFF; out[j++] = 0xD8;
    for (size_t i = 0; i < scan_len; i++) {
        if (j + 3 > out_cap) { free(scan); return -3; }
        out[j++] = scan[i];
        if (scan[i] == 0xFF) out[j++] = 0x00;
    }
    out[j++] = 0xFF; out[j++] = 0xD9;
    free(scan);
    return j;
}

/* ------------------------------------------------------------------ */
/* Single-core scalar reference decode path (benchmark anchor)         */
/* simple_idct semantics: see simple_idct.c:78-253                     */
/* ------------------------------------------------------------------ */

#define W1 22725
#define W2 21407
#define W3 19266
#define W4 16383
#define W5 12873
#define W6 8867
#define W7 4520

static void idct_row(int16_t *row) {
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
        int16_t v = (int16_t)(row[0] << 3);
        for (int i = 0; i < 8; i++) row[i] = v;
        return;
    }
    int a0 = W4 * row[0] + (1 << 10);
    int a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * row[2]; a1 += W6 * row[2]; a2 -= W6 * row[2]; a3 -= W2 * row[2];
    int b0 = W1 * row[1] + W3 * row[3];
    int b1 = W3 * row[1] - W7 * row[3];
    int b2 = W5 * row[1] - W1 * row[3];
    int b3 = W7 * row[1] - W5 * row[3];
    a0 += W4 * row[4] + W6 * row[6];
    a1 += -W4 * row[4] - W2 * row[6];
    a2 += -W4 * row[4] + W2 * row[6];
    a3 += W4 * row[4] - W6 * row[6];
    b0 += W5 * row[5] + W7 * row[7];
    b1 += -W1 * row[5] - W5 * row[7];
    b2 += W7 * row[5] + W3 * row[7];
    b3 += W3 * row[5] - W1 * row[7];
    row[0] = (int16_t)((a0 + b0) >> 11);
    row[7] = (int16_t)((a0 - b0) >> 11);
    row[1] = (int16_t)((a1 + b1) >> 11);
    row[6] = (int16_t)((a1 - b1) >> 11);
    row[2] = (int16_t)((a2 + b2) >> 11);
    row[5] = (int16_t)((a2 - b2) >> 11);
    row[3] = (int16_t)((a3 + b3) >> 11);
    row[4] = (int16_t)((a3 - b3) >> 11);
}

static inline uint8_t clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : (uint8_t)v); }

static void idct_col_put(uint8_t *dst, int stride, const int16_t *col) {
    int a0 = W4 * (col[0] + 32);
    int a1 = a0, a2 = a0, a3 = a0;
    a0 += W2 * col[16]; a1 += W6 * col[16]; a2 -= W6 * col[16]; a3 -= W2 * col[16];
    int b0 = W1 * col[8] + W3 * col[24];
    int b1 = W3 * col[8] - W7 * col[24];
    int b2 = W5 * col[8] - W1 * col[24];
    int b3 = W7 * col[8] - W5 * col[24];
    a0 += W4 * col[32] + W6 * col[48];
    a1 += -W4 * col[32] - W2 * col[48];
    a2 += -W4 * col[32] + W2 * col[48];
    a3 += W4 * col[32] - W6 * col[48];
    b0 += W5 * col[40] + W7 * col[56];
    b1 += -W1 * col[40] - W5 * col[56];
    b2 += W7 * col[40] + W3 * col[56];
    b3 += W3 * col[40] - W1 * col[56];
    dst[0 * stride] = clamp255((a0 + b0) >> 20);
    dst[1 * stride] = clamp255((a1 + b1) >> 20);
    dst[2 * stride] = clamp255((a2 + b2) >> 20);
    dst[3 * stride] = clamp255((a3 + b3) >> 20);
    dst[4 * stride] = clamp255((a3 - b3) >> 20);
    dst[5 * stride] = clamp255((a2 - b2) >> 20);
    dst[6 * stride] = clamp255((a1 - b1) >> 20);
    dst[7 * stride] = clamp255((a0 - b0) >> 20);
}

static void idct_put_8x8(uint8_t *dst, int stride, int16_t *blk) {
    for (int i = 0; i < 8; i++) idct_row(blk + i * 8);
    uint8_t tmp[64];
    for (int j = 0; j < 8; j++) idct_col_put(tmp + j, 8, blk + j);
    for (int r = 0; r < 8; r++) memcpy(dst + r * stride, tmp + r * 8, 8);
}

/* full scalar decode of one frame: payload -> flipped YUV planes */
API int amv_ref_decode_frame(const uint8_t *payload, int64_t size,
                             int width, int height,
                             uint8_t *y_out, uint8_t *cb_out, uint8_t *cr_out) {
    ensure_tables();
    int mb_w = (width + 15) / 16, mb_h = (height + 15) / 16;
    int n_mcu = mb_w * mb_h;
    uint8_t *tmp = (uint8_t *)malloc((size_t)size + 64);
    int16_t *levels = (int16_t *)malloc((size_t)n_mcu * 6 * 64 * sizeof(int16_t));
    uint8_t *ycoded = (uint8_t *)malloc((size_t)(16 * mb_h) * (16 * mb_w));
    uint8_t *cbcoded = (uint8_t *)malloc((size_t)(8 * mb_h) * (8 * mb_w));
    uint8_t *crcoded = (uint8_t *)malloc((size_t)(8 * mb_h) * (8 * mb_w));
    int rc = -1;
    if (!tmp || !levels || !ycoded || !cbcoded || !crcoded) goto done;
    {
        size_t scan_len = unescape(payload + 2, (size_t)size - 4, tmp);
        rc = decode_scan_levels(tmp, scan_len, n_mcu, levels);
        if (rc < 0) goto done;
    }
    {
        int ystride = 16 * mb_w, cstride = 8 * mb_w;
        int32_t qml[64], qmc[64];
        for (int i = 0; i < 64; i++) { qml[zigzag[i]] = q60_l[i]; qmc[zigzag[i]] = q60_c[i]; }
        int last_dc[3] = {1024, 1024, 1024};
        int16_t blk[64];
        for (int m = 0; m < n_mcu; m++) {
            int mx = m % mb_w, my = m / mb_w;
            for (int b = 0; b < 6; b++) {
                const int16_t *lv = levels + ((size_t)m * 6 + b) * 64;
                int comp = b < 4 ? 0 : (b - 3);
                const int32_t *qm = b < 4 ? qml : qmc;
                memset(blk, 0, sizeof(blk));
                int dc = lv[0] * qm[0] + last_dc[comp];
                last_dc[comp] = dc;
                blk[0] = (int16_t)dc;
                for (int i = 1; i < 64; i++) {
                    int j = zigzag[i];
                    if (lv[i]) blk[j] = (int16_t)(lv[i] * qm[j]);
                }
                uint8_t *dst; int stride;
                if (b < 4) {
                    dst = ycoded + (my * 16 + (b >> 1) * 8) * ystride + mx * 16 + (b & 1) * 8;
                    stride = ystride;
                } else if (b == 4) {
                    dst = cbcoded + my * 8 * cstride + mx * 8; stride = cstride;
                } else {
                    dst = crcoded + my * 8 * cstride + mx * 8; stride = cstride;
                }
                idct_put_8x8(dst, stride, blk);
            }
        }
        /* flip + crop */
        for (int r = 0; r < height; r++)
            memcpy(y_out + (size_t)r * width,
                   ycoded + (size_t)(height - 1 - r) * ystride, width);
        int ch = height / 2, cw = width / 2;
        for (int r = 0; r < ch; r++) {
            memcpy(cb_out + (size_t)r * cw, cbcoded + (size_t)(ch - 1 - r) * cstride, cw);
            memcpy(cr_out + (size_t)r * cw, crcoded + (size_t)(ch - 1 - r) * cstride, cw);
        }
        rc = 0;
    }
done:
    free(tmp); free(levels); free(ycoded); free(cbcoded); free(crcoded);
    return rc;
}

/* ------------------------------------------------------------------ */
/* Single-core scalar reference encode path (benchmark anchor)         */
/* jfdctint + dct_quantize_c semantics                                 */
/* ------------------------------------------------------------------ */

#define DESC(x, n) (((x) + (1 << ((n) - 1))) >> (n))

static void fdct_islow(int16_t *data) {
    /* pass 1: rows (CONST_BITS=13, PASS1_BITS=4) */
    for (int r = 0; r < 8; r++) {
        int16_t *d = data + r * 8;
        int32_t t0 = d[0] + d[7], t7 = d[0] - d[7];
        int32_t t1 = d[1] + d[6], t6 = d[1] - d[6];
        int32_t t2 = d[2] + d[5], t5 = d[2] - d[5];
        int32_t t3 = d[3] + d[4], t4 = d[3] - d[4];
        int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        d[0] = (int16_t)((t10 + t11) << 4);
        d[4] = (int16_t)((t10 - t11) << 4);
        int32_t z1 = (t12 + t13) * 4433;
        d[2] = (int16_t)DESC(z1 + t13 * 6270, 9);
        d[6] = (int16_t)DESC(z1 - t12 * 15137, 9);
        int32_t za = t4 + t7, zb = t5 + t6, zc = t4 + t6, zd = t5 + t7;
        int32_t z5 = (zc + zd) * 9633;
        t4 *= 2446; t5 *= 16819; t6 *= 25172; t7 *= 12299;
        za *= -7373; zb *= -20995;
        zc = zc * -16069 + z5;
        zd = zd * -3196 + z5;
        d[7] = (int16_t)DESC(t4 + za + zc, 9);
        d[5] = (int16_t)DESC(t5 + zb + zd, 9);
        d[3] = (int16_t)DESC(t6 + zb + zc, 9);
        d[1] = (int16_t)DESC(t7 + za + zd, 9);
    }
    /* pass 2: columns */
    for (int c = 0; c < 8; c++) {
        int16_t *d = data + c;
        int32_t t0 = d[0] + d[56], t7 = d[0] - d[56];
        int32_t t1 = d[8] + d[48], t6 = d[8] - d[48];
        int32_t t2 = d[16] + d[40], t5 = d[16] - d[40];
        int32_t t3 = d[24] + d[32], t4 = d[24] - d[32];
        int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        d[0]  = (int16_t)DESC(t10 + t11, 4);
        d[32] = (int16_t)DESC(t10 - t11, 4);
        int32_t z1 = (t12 + t13) * 4433;
        d[16] = (int16_t)DESC(z1 + t13 * 6270, 17);
        d[48] = (int16_t)DESC(z1 - t12 * 15137, 17);
        int32_t za = t4 + t7, zb = t5 + t6, zc = t4 + t6, zd = t5 + t7;
        int32_t z5 = (zc + zd) * 9633;
        t4 *= 2446; t5 *= 16819; t6 *= 25172; t7 *= 12299;
        za *= -7373; zb *= -20995;
        zc = zc * -16069 + z5;
        zd = zd * -3196 + z5;
        d[56] = (int16_t)DESC(t4 + za + zc, 17);
        d[40] = (int16_t)DESC(t5 + zb + zd, 17);
        d[24] = (int16_t)DESC(t6 + zb + zc, 17);
        d[8]  = (int16_t)DESC(t7 + za + zd, 17);
    }
}

API int64_t amv_ref_encode_frame(const uint8_t *y, const uint8_t *cb,
                                 const uint8_t *cr, int width, int height,
                                 int qscale, uint8_t *out, int64_t out_cap) {
    ensure_tables();
    int mb_w = (width + 15) / 16, mb_h = (height + 15) / 16;
    int cw = width / 2, ch = height / 2;
    int ystride = 16 * mb_w, cstride = 8 * mb_w;
    int yrows = 16 * mb_h, crows = 8 * mb_h;
    uint8_t *yc = (uint8_t *)malloc((size_t)yrows * ystride);
    uint8_t *cbc = (uint8_t *)malloc((size_t)crows * cstride);
    uint8_t *crc = (uint8_t *)malloc((size_t)crows * cstride);
    int16_t *levels = (int16_t *)malloc((size_t)mb_w * mb_h * 6 * 64 * sizeof(int16_t));
    if (!yc || !cbc || !crc || !levels) { free(yc); free(cbc); free(crc); free(levels); return -1; }

    /* flip + edge pad */
    for (int r = 0; r < yrows; r++) {
        int sr = r < height ? (height - 1 - r) : 0;
        memcpy(yc + (size_t)r * ystride, y + (size_t)sr * width, width);
        for (int cpad = width; cpad < ystride; cpad++)
            yc[(size_t)r * ystride + cpad] = yc[(size_t)r * ystride + width - 1];
    }
    for (int r = 0; r < crows; r++) {
        int sr = r < ch ? (ch - 1 - r) : 0;
        memcpy(cbc + (size_t)r * cstride, cb + (size_t)sr * cw, cw);
        memcpy(crc + (size_t)r * cstride, cr + (size_t)sr * cw, cw);
        for (int cpad = cw; cpad < cstride; cpad++) {
            cbc[(size_t)r * cstride + cpad] = cbc[(size_t)r * cstride + cw - 1];
            crc[(size_t)r * cstride + cpad] = crc[(size_t)r * cstride + cw - 1];
        }
    }

    /* quant matrix + qmat (mpegvideo_enc.c:2866-2876 + ff_convert_matrix) */
    int32_t mat[64], qmat[64];
    mat[0] = mpeg1_intra[0];
    for (int i = 1; i < 64; i++) {
        int v = (mpeg1_intra[i] * qscale) >> 3;
        mat[i] = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
    for (int i = 0; i < 64; i++)
        qmat[i] = (int32_t)((1ll << 22) / (8 * mat[i]));

    int16_t blk[64];
    for (int m = 0; m < mb_w * mb_h; m++) {
        int mx = m % mb_w, my = m / mb_w;
        for (int b = 0; b < 6; b++) {
            const uint8_t *src; int stride;
            if (b < 4) {
                src = yc + (size_t)(my * 16 + (b >> 1) * 8) * ystride + mx * 16 + (b & 1) * 8;
                stride = ystride;
            } else if (b == 4) {
                src = cbc + (size_t)my * 8 * cstride + mx * 8; stride = cstride;
            } else {
                src = crc + (size_t)my * 8 * cstride + mx * 8; stride = cstride;
            }
            for (int r = 0; r < 8; r++)
                for (int c2 = 0; c2 < 8; c2++)
                    blk[r * 8 + c2] = src[r * stride + c2];
            fdct_islow(blk);
            int16_t *lv = levels + ((size_t)m * 6 + b) * 64;
            lv[0] = (int16_t)((blk[0] + 32) / 64);
            for (int i = 1; i < 64; i++) {
                int j = zigzag[i];
                int32_t level = blk[j] * qmat[j];
                int32_t q;
                if (level >= 0) q = level >> 22; else q = -((-level) >> 22);
                if (q > 1023) q = 1023; else if (q < -1023) q = -1023;
                lv[i] = (int16_t)q;
            }
        }
    }
    int64_t n = amv_encode_frame(levels, mb_w * mb_h, out, out_cap);
    free(yc); free(cbc); free(crc); free(levels);
    return n;
}

/* ------------------------------------------------------------------ */
/* Scalar IMA-ADPCM (AMV) reference (benchmark anchor)                 */
/* ------------------------------------------------------------------ */

static const int32_t ima_index_table[16] = {-1,-1,-1,-1,2,4,6,8,-1,-1,-1,-1,2,4,6,8};
static const int32_t ima_step_table[89] = {
    7,8,9,10,11,12,13,14,16,17,19,21,23,25,28,31,34,37,41,45,50,55,60,66,73,80,
    88,97,107,118,130,143,157,173,190,209,230,253,279,307,337,371,408,449,494,
    544,598,658,724,796,876,963,1060,1166,1282,1411,1552,1707,1878,2066,2272,
    2499,2749,3024,3327,3660,4026,4428,4871,5358,5894,6484,7132,7845,8630,9493,
    10442,11487,12635,13899,15289,16818,18500,20350,22385,24623,27086,29794,32767
};

API int64_t adpcm_ref_decode(const uint8_t *data, int64_t nbytes,
                             int predictor, int step_index, int16_t *out) {
    int64_t k = 0;
    int p = predictor, s = step_index;
    for (int64_t i = 0; i < nbytes; i++) {
        int byte = data[i];
        for (int half = 0; half < 2; half++) {
            int nib = half == 0 ? (byte >> 4) & 0xF : byte & 0xF;
            int step = ima_step_table[s];
            s += ima_index_table[nib];
            if (s < 0) s = 0; else if (s > 88) s = 88;
            int diff = ((2 * (nib & 7) + 1) * step) >> 3;
            p += (nib & 8) ? -diff : diff;
            if (p < -32768) p = -32768; else if (p > 32767) p = 32767;
            out[k++] = (int16_t)p;
        }
    }
    return k;
}

/* ------------------------------------------------------------------------
 * Progressive JPEG scan decoder (T.81 G.1.2 / G.2, libjpeg jdphuff
 * semantics -- the vendored mjpegdec.c covers only the Ah==0 subset).
 * One call decodes ONE scan pass over the zigzag coefficient planes;
 * the Python driver (bitstream/jpeg_progressive.py) parses markers,
 * snapshots Huffman tables per SOS, and precomputes the block-order
 * map so this stays pure entropy work.  Mirrors the pure-Python
 * decoder 1:1 (differentially tested against it).
 * --------------------------------------------------------------------- */

typedef struct {
    const uint8_t *d;
    long n, p;                 /* next raw byte */
    uint64_t acc;
    int nb;
} PBits;

static int pb_byte(PBits *b) {
    if (b->p >= b->n) return 0;          /* past end: zero fill */
    uint8_t v = b->d[b->p++];
    if (v == 0xFF && b->p < b->n && b->d[b->p] == 0x00)
        b->p++;                          /* drop stuffing byte */
    return v;
}

static void pb_fill(PBits *b) {
    while (b->nb <= 56) {
        b->acc = (b->acc << 8) | (uint64_t)pb_byte(b);
        b->nb += 8;
    }
}

static uint32_t pb_bits(PBits *b, int n) {
    if (!n) return 0;
    pb_fill(b);
    uint32_t v = (uint32_t)((b->acc >> (b->nb - n)) & ((1u << n) - 1));
    b->nb -= n;
    return v;
}

static int32_t pb_xbits(PBits *b, int n) {
    /* branchless JPEG extend (random sign bit mispredicts otherwise) */
    uint32_t v = pb_bits(b, n);
    uint32_t neg = ((v >> (n - 1)) & 1u) - 1u;
    return (int32_t)(v - (neg & ((1u << n) - 1u)));
}

static int pb_rst(PBits *b) {
    b->nb -= b->nb & 7;                  /* byte align */
    uint32_t mk = pb_bits(b, 16);
    return (mk & 0xFFF8) == 0xFFD0 ? 0 : -1;
}

typedef struct {
    int32_t maxcode[17], mincode[17], valptr[17];
    uint8_t vals[256];
    int ok;
} PHuff;

static void ph_build(PHuff *h, const uint8_t *t) {
    /* t: bits[17] (t[0] unused) + vals[256] */
    int code = 0, k = 0, l;
    for (l = 1; l <= 16; l++) {
        h->valptr[l] = k;
        h->mincode[l] = code;
        code += t[l];
        k += t[l];
        h->maxcode[l] = code - 1;        /* < mincode when empty */
        code <<= 1;
    }
    if (k > 256) {
        /* infeasible DHT (more values than vals[] holds): poison the
         * table so ph_vlc's vals[] index stays in bounds and lookups
         * fail cleanly with -1 (fuzz-found OOB read otherwise) */
        for (l = 1; l <= 16; l++) { h->mincode[l] = 0; h->maxcode[l] = -1; }
        k = 0;
    }
    memcpy(h->vals, t + 17, 256);
    h->ok = k > 0;
}

static int ph_vlc(PBits *b, const PHuff *h) {
    int code = (int)pb_bits(b, 1), l = 1;
    while (h->maxcode[l] < h->mincode[l] || code > h->maxcode[l]) {
        code = (code << 1) | (int)pb_bits(b, 1);
        if (++l > 16) return -1;
    }
    return h->vals[h->valptr[l] + code - h->mincode[l]];
}

static void pb_refine_tail(PBits *b, int32_t *bk, int k, int se,
                           int32_t p1, int32_t m1) {
    for (; k <= se; k++)
        if (bk[k]) {
            if (pb_bits(b, 1) && !(bk[k] & p1))
                bk[k] += bk[k] > 0 ? p1 : m1;
        }
}

static int prog_scan_one(
    const uint8_t *scan, long scan_len,
    int32_t *coef,               /* [nblocks_total * 64], zigzag */
    const int64_t *blk,          /* [units*bpu] block index or -1 */
    const uint8_t *tabsel,       /* [bpu] huffman slot (0..3) */
    const uint8_t *cisel,        /* [bpu] dc predictor slot (0..3) */
    long units, int bpu,
    const uint8_t *htabs,        /* [4][17+256] bits+vals */
    int ss, int se, int ah, int al, int ri) {
    PBits b = {scan, scan_len, 0, 0, 0};
    PHuff ph[4];
    int i;
    /* T.81 B.2.3 bounds: Ss/Se index a 64-entry zigzag block and Ah/Al
     * are bit positions <= 13; a scribbled SOS (fuzz-found Ss=246)
     * would otherwise walk bk[ss..se] past the block (heap overflow) */
    if (ss < 0 || ss > 63 || se < ss || se > 63 ||
        ah < 0 || ah > 13 || al < 0 || al > 13) return -7;
    for (i = 0; i < bpu; i++)
        if (tabsel[i] > 3 || cisel[i] > 3) return -6;
    for (i = 0; i < 4; i++)
        ph_build(&ph[i], htabs + i * (17 + 256));

    if (ss == 0) {               /* DC scan (interleaved or single) */
        int32_t pred[4] = {0, 0, 0, 0};
        long u;
        for (u = 0; u < units; u++) {
            if (ri && u && u % ri == 0) {
                if (pb_rst(&b)) return -2;
                pred[0] = pred[1] = pred[2] = pred[3] = 0;
            }
            for (i = 0; i < bpu; i++) {
                int32_t val;
                long t = blk[u * bpu + i];
                if (ah == 0) {
                    int sym = ph_vlc(&b, &ph[tabsel[i]]);
                    if (sym < 0 || sym > 15) return -3;
                    pred[cisel[i]] += sym ? pb_xbits(&b, sym) : 0;
                    val = pred[cisel[i]] << al;
                    if (t >= 0) coef[t * 64] = val;
                } else {
                    val = (int32_t)pb_bits(&b, 1) << al;
                    if (t >= 0) coef[t * 64] |= val;
                }
            }
        }
        return 0;
    }

    {                            /* AC scan: single component, bpu==1 */
        const PHuff *tab = &ph[tabsel[0]];
        long eobrun = 0, u;
        int32_t p1 = 1 << al, m1 = -(1 << al);
        int32_t dummy[64];
        for (u = 0; u < units; u++) {
            long t = blk[u];
            int32_t *bk;
            if (ri && u && u % ri == 0) {
                if (pb_rst(&b)) return -2;
                eobrun = 0;
            }
            if (t >= 0) {
                bk = coef + t * 64;
            } else {
                memset(dummy, 0, sizeof dummy);
                bk = dummy;
            }
            if (ah == 0) {
                int k;
                if (eobrun > 0) { eobrun--; continue; }
                k = ss;
                while (k <= se) {
                    int rs = ph_vlc(&b, tab);
                    int r, sz;
                    if (rs < 0) return -3;
                    r = rs >> 4; sz = rs & 15;
                    if (sz == 0) {
                        if (r == 15) { k += 16; continue; }
                        eobrun = (1L << r) - 1;
                        if (r) eobrun += pb_bits(&b, r);
                        break;
                    }
                    k += r;
                    if (k > se) return -4;
                    bk[k] = pb_xbits(&b, sz) << al;
                    k++;
                }
            } else {             /* AC refinement */
                int k, hit;
                if (eobrun > 0) {
                    eobrun--;
                    pb_refine_tail(&b, bk, ss, se, p1, m1);
                    continue;
                }
                k = ss; hit = 0;
                while (k <= se) {
                    int rs = ph_vlc(&b, tab);
                    int r, sz;
                    int32_t insert = 0;
                    if (rs < 0) return -3;
                    r = rs >> 4; sz = rs & 15;
                    if (sz == 0) {
                        if (r < 15) {
                            eobrun = (1L << r) - 1;
                            if (r) eobrun += pb_bits(&b, r);
                            hit = 1;
                            break;
                        }
                        /* r == 15: skip 16 zero-history coeffs */
                    } else {
                        if (sz != 1) return -5;
                        insert = pb_bits(&b, 1) ? p1 : m1;
                    }
                    while (k <= se) {
                        if (bk[k]) {
                            if (pb_bits(&b, 1) && !(bk[k] & p1))
                                bk[k] += bk[k] > 0 ? p1 : m1;
                        } else {
                            if (r == 0) {
                                if (insert) bk[k] = insert;
                                k++;
                                break;
                            }
                            r--;
                        }
                        k++;
                    }
                }
                if (hit)
                    pb_refine_tail(&b, bk, k, se, p1, m1);
            }
        }
    }
    return 0;
}

API int amv_progressive_scan(
    const uint8_t *scan, long scan_len, int32_t *coef,
    const int64_t *blk, const uint8_t *tabsel, const uint8_t *cisel,
    long units, int bpu, const uint8_t *htabs,
    int ss, int se, int ah, int al, int ri) {
    return prog_scan_one(scan, scan_len, coef, blk, tabsel, cisel,
                         units, bpu, htabs, ss, se, ah, al, ri);
}

/* Whole-frame progressive driver: every scan in ONE call.  The
 * per-scan ctypes round-trip dominated the progressive host path
 * (~0.15 ms of Python marshalling per scan vs ~10 us of C entropy
 * work at 128x96); batching the scan loop here removes it.
 * meta[s*6 .. s*6+5] = ss, se, ah, al, ri, bpu; per-scan block maps
 * are concatenated in blk_all with fence offsets blk_off[n_scans+1];
 * tabsel/cisel rows are padded to stride 16.  Returns 0 or
 * -(scan_index*1000) + prog_scan_one's negative code. */
API int amv_progressive_frame(
    const uint8_t *scan_blob,
    const int64_t *scan_off, const int64_t *scan_len, int n_scans,
    const int32_t *meta      /* [n_scans][6] */,
    const int64_t *blk_all, const int64_t *blk_off /* [n_scans+1] */,
    const uint8_t *tabsel_all /* [n_scans][16] */,
    const uint8_t *cisel_all  /* [n_scans][16] */,
    const uint8_t *htabs_all  /* [n_scans][4][273] */,
    int32_t *coef) {
    for (int s = 0; s < n_scans; s++) {
        const int32_t *mt = meta + s * 6;
        int bpu = mt[5];
        if (bpu <= 0 || bpu > 16) return -(s * 1000) - 9;
        long nblk = (long)(blk_off[s + 1] - blk_off[s]);
        if (nblk < 0) return -(s * 1000) - 9;
        int rc = prog_scan_one(scan_blob + scan_off[s], (long)scan_len[s],
                               coef, blk_all + blk_off[s],
                               tabsel_all + (size_t)s * 16,
                               cisel_all + (size_t)s * 16,
                               nblk / bpu, bpu,
                               htabs_all + (size_t)s * 4 * 273,
                               mt[0], mt[1], mt[2], mt[3], mt[4]);
        if (rc) return -(s * 1000) + rc;
    }
    return 0;
}
