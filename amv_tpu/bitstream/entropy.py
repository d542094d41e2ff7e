"""Host-side entropy coding layer (Huffman scan decode/encode).

Bit-serial Huffman coding on the host (the device chain runs its own, see
kernels/entropy_decode*.py and entropy_encode.py): decode
produces quantized coefficient levels for the device, encode packs the
device's quantized levels into the bitstream.  This module provides the
canonical (pure Python) implementation; `amv_tpu.native` supplies a C
fast path with the same interface, used automatically when built.

Conventions:
* decoded levels are int16 [F, n_mcu, 6, 64] in ZIGZAG order; position 0 is
  the DC *difference* (prediction is resolved on device);
* encoder input levels are int16 [n_mcu, 6, 64] in ZIGZAG order; position 0
  is the quantized DC *value* (the DC diff chain, init 128, is applied
  here: mpegvideo_enc.c:2036 + mjpegenc.c:387-400).
"""

from __future__ import annotations

import numpy as np

from . import jpeg_tables as T
from ..verify import ref_jpeg as R


def _decode_frame_py(payload: bytes, n_mcu: int) -> np.ndarray:
    scan = R.unescape_scan(payload[2:len(payload) - 2])
    return R.huffman_decode_scan(scan, n_mcu).astype(np.int16)


def _encode_frame_py(levels_zz: np.ndarray) -> bytes:
    bw = R.BitWriter()
    last_dc = [128, 128, 128]
    n_mcu = levels_zz.shape[0]
    for m in range(n_mcu):
        for b in range(6):
            comp = 0 if b < 4 else (b & 1) + 1
            dc_t = R._ENC_DC_L if b < 4 else R._ENC_DC_C
            ac_t = R._ENC_AC_L if b < 4 else R._ENC_AC_C
            zz = levels_zz[m, b]
            dc = int(zz[0])
            R._encode_dc(bw, dc - last_dc[comp], dc_t)
            last_dc[comp] = dc
            sizes, codes = ac_t
            nz = np.nonzero(zz[1:])[0]
            run = 0
            prev = 0
            for idx in nz:
                i = int(idx) + 1
                run = i - prev - 1
                prev = i
                val = int(zz[i])
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
            if prev != 63:
                bw.put_bits(int(sizes[0]), int(codes[0]))  # EOB
    pad = (-bw.bit_count()) & 7
    if pad:
        bw.put_bits(pad, (1 << pad) - 1)
    scan = bw.flush()
    return b"\xFF\xD8" + R.escape_ff(scan) + b"\xFF\xD9"


# --- native fast path -------------------------------------------------------
try:
    from ..native import entropy_native as _native
except Exception:  # pragma: no cover - native build optional
    _native = None


def huffman_decode_frames(payloads: list[bytes], n_mcu: int) -> np.ndarray:
    """Decode a batch of '00dc' payloads -> int16 [F, n_mcu, 6, 64] levels."""
    if _native is not None:
        return _native.decode_frames(payloads, n_mcu)
    out = np.zeros((len(payloads), n_mcu, 6, 64), dtype=np.int16)
    for f, p in enumerate(payloads):
        out[f] = _decode_frame_py(p, n_mcu)
    return out


def huffman_encode_frame(levels_zz: np.ndarray) -> bytes:
    """Encode one frame's quantized levels -> '00dc' payload."""
    if _native is not None:
        return _native.encode_frame(np.ascontiguousarray(levels_zz, np.int16))
    return _encode_frame_py(levels_zz)
