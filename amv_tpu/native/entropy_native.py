"""ctypes bindings for the native entropy codec (libamventropy.so).

Builds on first import if the shared object is missing and a C compiler is
available; importing this module raises on any failure, and callers
(amv_tpu.bitstream.entropy) fall back to the pure-Python path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libamventropy.so")


def _build():
    """Compile entropy.c into _SO with the system C compiler (host-tuned
    codegen when the compiler takes -march=native).  The library is
    written under a temporary name and renamed into place, so processes
    that build at the same time never load a half-written file."""
    cc = os.environ.get("CC", "cc")
    flags = ["-O3", "-fPIC", "-shared", "-fvisibility=hidden", "-Wall"]
    if subprocess.run([cc, "-march=native", "-E", "-xc", os.devnull],
                      capture_output=True).returncode == 0:
        flags.append("-march=native")
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    try:
        subprocess.run([cc, *flags, "-o", tmp,
                        os.path.join(_DIR, "entropy.c")],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


if not os.path.exists(_SO) or (
        os.path.getmtime(_SO) < os.path.getmtime(os.path.join(_DIR, "entropy.c"))):
    _build()

_lib = ctypes.CDLL(_SO)

_lib.amv_decode_frames.restype = ctypes.c_int
_lib.amv_decode_frames.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int16)]

_lib.amv_encode_frame.restype = ctypes.c_int64
_lib.amv_encode_frame.argtypes = [
    ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]

_lib.amv_ref_decode_frame.restype = ctypes.c_int
_lib.amv_ref_decode_frame.argtypes = [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8)]

_lib.amv_ref_encode_frame.restype = ctypes.c_int64
_lib.amv_ref_encode_frame.argtypes = [
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]

_lib.adpcm_ref_decode.restype = ctypes.c_int64
_lib.adpcm_ref_decode.argtypes = [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_int16)]


def decode_frames(payloads: list[bytes], n_mcu: int) -> np.ndarray:
    blob = b"".join(payloads)
    offsets = np.zeros(len(payloads), dtype=np.int64)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    # np.empty: amv_decode_frames zeroes every block itself; np.zeros
    # paid a second 9 MB lazy-zero page touch per call
    out = np.empty((len(payloads), n_mcu, 6, 64), dtype=np.int16)
    rc = _lib.amv_decode_frames(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(payloads), n_mcu,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if rc != 0:
        raise ValueError(f"native huffman decode failed (rc={rc})")
    return out


_lib.amv_unescape_frames.restype = ctypes.c_int64
_lib.amv_unescape_frames.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64)]


_lib.amv_escape_frames.restype = ctypes.c_int64
_lib.amv_escape_frames.argtypes = [
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64)]


def escape_frames(words: np.ndarray, bits: np.ndarray) -> list[bytes]:
    """(words int32 [F, w_out] big-endian scan words, bits int64/int32
    [F]) -> framed '00dc' payload bytes per frame (1-pad + 0xFF00 escape
    + SOI/EOI)."""
    words = np.ascontiguousarray(words, np.int32)
    bits64 = np.ascontiguousarray(bits, np.int64)
    F, w_out = words.shape
    stride = w_out * 4 * 2 + 8  # worst case: every byte escapes
    dst = np.zeros((F, stride), np.uint8)
    lens = np.zeros(F, np.int64)
    rc = _lib.amv_escape_frames(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w_out,
        bits64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), F,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), stride,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise ValueError(f"native escape failed (rc={rc})")
    return [dst[f, :lens[f]].tobytes() for f in range(F)]


def unescape_frames(payloads: list[bytes]):
    """Batch SOI/EOI strip + 0xFF00 unescape into a zero-padded row
    matrix (the device entropy decoder's input format).

    Returns (rows uint8 [F, stride], lens int64 [F]); stride is the max
    unescaped length rounded up to a multiple of 4 (word packing).
    """
    blob = b"".join(payloads)
    offsets = np.zeros(len(payloads), dtype=np.int64)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    stride = (int(sizes.max()) + 3) & ~3
    rows = np.zeros((len(payloads), stride), np.uint8)
    lens = np.zeros(len(payloads), np.int64)
    rc = _lib.amv_unescape_frames(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(payloads),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        stride, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc < 0:
        raise ValueError(f"native unescape failed (rc={rc})")
    maxlen = (int(rc) + 3) & ~3
    return rows[:, :maxlen], lens


_lib.amv_decode_scans_custom.restype = ctypes.c_int
_lib.amv_decode_scans_custom.argtypes = [
    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int16)]


def decode_scans_custom(scans: list[bytes], n_mcu: int,
                        huff: dict, tab_pairs: list,
                        restart_interval: int = 0) -> np.ndarray:
    """Baseline-MJPEG scan decode with arbitrary parsed tables, any
    interleaved sampling (blocks/MCU from len(tab_pairs)) and optional
    restart markers (mjpegdec.c:533-548 RSTn resync).

    scans: raw escaped scan byte strings (no SOI/EOI);
    huff: {(class, id): (bits[17], vals[...])} as parsed from DHT;
    tab_pairs: per MCU block b, (dc_id, ac_id) table ids — 6 entries
        for 4:2:0, 4 for 4:2:2, 3 for 4:4:4, 1 for grayscale;
    restart_interval: MCUs between RSTn markers (0 = none).  DC levels
        stay raw differences; the caller's cumsum must reset per
        restart segment.
    Returns int16 [F, n_mcu, n_blk, 64] zigzag levels (slot 0 = DC diff).
    """
    n_blk = len(tab_pairs)
    bits8 = np.zeros((8, 17), np.uint8)
    vals8 = np.zeros((8, 256), np.uint8)
    for (cls, tid), (bits, vals) in huff.items():
        # untrusted DHT data: bound-check before the C LUT build (which
        # also validates the canonical Kraft bound itself)
        if cls not in (0, 1) or not 0 <= tid <= 3:
            raise ValueError(f"bad Huffman table id ({cls},{tid})")
        if len(bits) != 17 or len(vals) > 256 or \
                int(np.sum(bits[1:])) != len(vals):
            raise ValueError(f"inconsistent DHT ({cls},{tid}): "
                             f"{int(np.sum(bits[1:]))} codes, "
                             f"{len(vals)} values")
        slot = cls * 4 + tid
        bits8[slot, :len(bits)] = bits
        vals8[slot, :len(vals)] = vals
    tab_ids = np.zeros((n_blk, 2), np.uint8)
    for b, (dc_id, ac_id) in enumerate(tab_pairs):
        if not (0 <= dc_id <= 3 and 0 <= ac_id <= 3):
            raise ValueError(f"bad scan table selector ({dc_id},{ac_id})")
        tab_ids[b] = (dc_id, 4 + ac_id)
    blob = b"".join(scans)
    offsets = np.zeros(len(scans), dtype=np.int64)
    sizes = np.array([len(x) for x in scans], dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.zeros((len(scans), n_mcu, n_blk, 64), dtype=np.int16)
    rc = _lib.amv_decode_scans_custom(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(scans), n_mcu, n_blk, restart_interval,
        bits8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vals8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        tab_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if rc != 0:
        raise ValueError(f"native custom-table decode failed (rc={rc})")
    return out


def encode_frame(levels_zz: np.ndarray) -> bytes:
    levels = np.ascontiguousarray(levels_zz, dtype=np.int16)
    n_mcu = levels.shape[0]
    cap = levels.size * 4 + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = _lib.amv_encode_frame(
        levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n_mcu,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"native huffman encode failed (rc={n})")
    return out[:n].tobytes()


def ref_decode_frame(payload: bytes, width: int, height: int):
    """Full single-core C decode (benchmark anchor)."""
    y = np.zeros((height, width), dtype=np.uint8)
    cb = np.zeros((height // 2, width // 2), dtype=np.uint8)
    cr = np.zeros_like(cb)
    rc = _lib.amv_ref_decode_frame(
        payload, len(payload), width, height,
        y.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"native ref decode failed (rc={rc})")
    return y, cb, cr


def ref_encode_frame(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                     qscale: int = 2) -> bytes:
    h, w = y.shape
    cap = w * h * 4 + 65536
    out = np.zeros(cap, dtype=np.uint8)
    n = _lib.amv_ref_encode_frame(
        np.ascontiguousarray(y).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.ascontiguousarray(cb).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        np.ascontiguousarray(cr).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, qscale,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError(f"native ref encode failed (rc={n})")
    return out[:n].tobytes()


def ref_adpcm_decode(data: bytes, predictor: int, step_index: int) -> np.ndarray:
    out = np.zeros(2 * len(data), dtype=np.int16)
    n = _lib.adpcm_ref_decode(
        data, len(data), predictor, step_index,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    return out[:n]


_lib.amv_progressive_scan.restype = ctypes.c_int
_lib.amv_progressive_scan.argtypes = [
    ctypes.c_char_p, ctypes.c_long,
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]


_lib.amv_progressive_frame.restype = ctypes.c_int
_lib.amv_progressive_frame.argtypes = [
    ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)]


class ProgressivePlan:
    """Prepacked per-header arrays for amv_progressive_frame.  All of
    this depends only on the frame's header metadata (tables, SOF, SOS
    parameters), so a stream of same-header frames packs once."""
    __slots__ = ("n", "blk_all", "blk_off", "tab16", "cis16", "ht",
                 "meta")

    def __init__(self, blks, tabsels, cisels, htabs_list, metas):
        n = self.n = len(metas)
        blks = [np.ascontiguousarray(b, np.int64) for b in blks]
        self.blk_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(b) for b in blks], out=self.blk_off[1:])
        self.blk_all = (np.concatenate(blks) if blks else
                        np.zeros(0, np.int64))
        self.tab16 = np.zeros((n, 16), np.uint8)
        self.cis16 = np.zeros((n, 16), np.uint8)
        for s in range(n):
            self.tab16[s, :len(tabsels[s])] = tabsels[s]
            self.cis16[s, :len(cisels[s])] = cisels[s]
        self.ht = np.ascontiguousarray(np.stack(htabs_list), np.uint8)
        assert self.ht.shape == (n, 4, 273)
        self.meta = np.ascontiguousarray(
            np.asarray(metas, np.int32).reshape(n, 6))


def progressive_frame(scans: list, coef: np.ndarray,
                      plan: ProgressivePlan) -> None:
    """All progressive scans of one frame in a single C call
    (amv_progressive_frame; the per-scan ctypes crossing dominated the
    host path).  scans[s] = that scan's escaped bytes; plan carries the
    prepacked header-derived arrays (block maps, table selectors,
    Huffman snapshots, (ss, se, ah, al, ri, bpu) rows).  coef int32
    [NB_total, 64] is modified in place; raises on malformed scans
    (the caller restarts with the Python scan decoder)."""
    assert coef.dtype == np.int32 and coef.flags.c_contiguous
    n = plan.n
    assert len(scans) == n
    blob = b"".join(scans)
    off = np.zeros(n, np.int64)
    lens = np.array([len(s) for s in scans], np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p64 = ctypes.POINTER(ctypes.c_int64)
    rc = _lib.amv_progressive_frame(
        blob, off.ctypes.data_as(p64), lens.ctypes.data_as(p64), n,
        plan.meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        plan.blk_all.ctypes.data_as(p64),
        plan.blk_off.ctypes.data_as(p64),
        plan.tab16.ctypes.data_as(p8), plan.cis16.ctypes.data_as(p8),
        plan.ht.ctypes.data_as(p8),
        coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise ValueError(f"progressive frame decode failed (rc={rc})")


def progressive_scan(scan: bytes, coef: np.ndarray, blk: np.ndarray,
                     tabsel: np.ndarray, cisel: np.ndarray, bpu: int,
                     htabs: np.ndarray, ss: int, se: int, ah: int,
                     al: int, ri: int) -> None:
    """One progressive-JPEG scan pass over zigzag coefficient planes.

    coef int32 [NB_total, 64] (modified in place), blk int64
    [units*bpu] flat block indices (-1 = bit-consuming skip), tabsel /
    cisel uint8 [bpu], htabs uint8 [4, 273] (bits[17] + vals[256] per
    slot).  Raises on malformed scans (caller falls back to the Python
    scan decoder, which reports the precise position)."""
    assert coef.dtype == np.int32 and coef.flags.c_contiguous
    blk = np.ascontiguousarray(blk, np.int64)
    tabsel = np.ascontiguousarray(tabsel, np.uint8)
    cisel = np.ascontiguousarray(cisel, np.uint8)
    htabs = np.ascontiguousarray(htabs, np.uint8)
    assert htabs.shape == (4, 273)
    units = len(blk) // bpu
    rc = _lib.amv_progressive_scan(
        scan, len(scan),
        coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tabsel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cisel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        units, bpu,
        htabs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ss, se, ah, al, ri)
    if rc != 0:
        raise ValueError(f"progressive scan decode failed (rc={rc})")
