"""C generic-table entropy decoder vs the fixed-table AMV decoder."""

import numpy as np

from amv_tpu.containers import riff
from amv_tpu.bitstream.entropy import huffman_decode_frames


def test_custom_table_decoder_matches_k3(sample_amv_bytes):
    """decode_scans_custom with K.3 specs supplied as runtime tables must
    equal the canned-table decoder on the same scans."""
    from amv_tpu.bitstream import jpeg_tables as T
    from amv_tpu.native import entropy_native as native

    s = riff.demux(sample_amv_bytes)
    payloads = s.video_chunks[:6]
    ref = huffman_decode_frames(payloads, 48)
    scans = [p[2:-2] for p in payloads]   # strip SOI/EOI, keep escapes
    huff = {(0, 0): (T.BITS_DC_LUMA, T.VALS_DC_LUMA),
            (0, 1): (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
            (1, 0): (T.BITS_AC_LUMA, T.VALS_AC_LUMA),
            (1, 1): (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA)}
    pairs = [(0, 0)] * 4 + [(1, 1)] * 2
    got = native.decode_scans_custom(scans, 48, huff, pairs)
    np.testing.assert_array_equal(got, ref)


def test_custom_table_decoder_remapped_ids(sample_amv_bytes):
    """Same decode with tables installed under swapped ids exercises the
    slot indirection."""
    from amv_tpu.bitstream import jpeg_tables as T
    from amv_tpu.native import entropy_native as native

    s = riff.demux(sample_amv_bytes)
    payloads = s.video_chunks[:3]
    ref = huffman_decode_frames(payloads, 48)
    scans = [p[2:-2] for p in payloads]
    huff = {(0, 3): (T.BITS_DC_LUMA, T.VALS_DC_LUMA),
            (0, 2): (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
            (1, 1): (T.BITS_AC_LUMA, T.VALS_AC_LUMA),
            (1, 0): (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA)}
    pairs = [(3, 1)] * 4 + [(2, 0)] * 2
    got = native.decode_scans_custom(scans, 48, huff, pairs)
    np.testing.assert_array_equal(got, ref)
