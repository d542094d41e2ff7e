"""GPU Huffman decoder (kernels/entropy_decode_cuda.py): what the CPU can
check — the two-level LUTs, a Python model of the kernel's bit reader,
the wrapper's padding, the build step and the kernel choice — plus
`gpu`-marked tests of the compiled kernel against the C decoder."""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from amv_tpu import backend
from amv_tpu.bitstream import jpeg_tables as T
from amv_tpu.bitstream.entropy import huffman_decode_frames
from amv_tpu.containers import riff
from amv_tpu.kernels import entropy_decode_cuda as C
from amv_tpu.kernels.entropy_decode import decode_scans_device
from amv_tpu.native import entropy_native as native


@pytest.mark.parametrize("table", range(4))
def test_two_level_luts_match_flat_table(table):
    """Every 16-bit peek resolves through lut1 (and lut2 behind a slot
    pointer) to the flat table's (sym << 5) | len entry."""
    lut1, lut2 = C.build_luts()
    bits, vals = C._TABLES[table]
    syms, lens = T.build_decode_table(bits, vals)
    peek = np.arange(1 << 16)
    e = lut1[table][peek >> 8].astype(np.uint32)
    ptr = (e & 0x8000) != 0
    e = np.where(ptr, lut2[table][np.where(ptr, e & 0x7FFF, 0), peek & 255], e)
    np.testing.assert_array_equal(e, (syms.astype(np.uint32) << 5) | lens)
    assert int((e & 31).max()) <= 16


def _model_decode(row: bytes, n_mcu: int):
    """Python transcription of decode_scans_kernel (entropy_decode.cu):
    one frame, 64-bit cache refilled a big-endian word at a time."""
    lut1, lut2 = C.build_luts()
    words = np.frombuffer(row, ">u4")
    st = {"cache": 0, "bits": 0, "pos": 0}
    mask = (1 << 64) - 1

    def refill():
        if st["bits"] < 32:
            w = int(words[st["pos"]]) if st["pos"] < len(words) else 0
            st["cache"] |= w << (32 - st["bits"])
            st["bits"] += 32
            st["pos"] += 1

    def take(n):
        v = st["cache"] >> (64 - n)
        st["cache"] = (st["cache"] << n) & mask
        st["bits"] -= n
        return v

    def code(t):
        peek = st["cache"] >> 48
        e = int(lut1[t, peek >> 8])
        if e & 0x8000:
            e = int(lut2[t, e & 0x7FFF, peek & 255])
        if e & 31:
            take(e & 31)
        return e

    def xbits(n):
        v = take(n)
        return v - (1 << n) + 1 if v < (1 << (n - 1)) else v

    out = np.zeros((n_mcu * 6, 64), np.int16)
    for blk in range(n_mcu * 6):
        luma = blk % 6 < 4
        refill()
        e = code(0 if luma else 1)
        if not e & 31:
            return out, -(blk + 1)
        out[blk, 0] = xbits(e >> 5) if e >> 5 else 0
        i = 0
        while True:
            refill()
            e = code(2 if luma else 3)
            if not e & 31:
                return out, -(blk + 1)
            sym = e >> 5
            if sym == 0:
                break
            run, size = sym >> 4, sym & 15
            if size == 0:
                if run != 15:
                    return out, -(blk + 1)
                i += 16
                continue
            level = xbits(size)
            i += run + 1
            if i > 63:
                return out, -(blk + 1)
            out[blk, i] = level
            if i == 63:
                break
    return out, 0


def test_kernel_model_matches_c_decoder(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    rows, _ = native.unescape_frames(s.video_chunks[:2])
    want = huffman_decode_frames(s.video_chunks[:2], 48)
    for f in range(2):
        got, rc = _model_decode(rows[f].tobytes(), 48)
        assert rc == 0
        np.testing.assert_array_equal(got.reshape(48, 6, 64), want[f])


def test_kernel_model_flags_invalid_code(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    p = bytearray(s.video_chunks[0])
    p[10:18] = b"\xFF\x00" * 4
    rows, _ = native.unescape_frames([bytes(p)])
    _, rc = _model_decode(rows[0].tobytes(), 48)
    assert rc < 0


@pytest.mark.parametrize("width", [5, 8, 13, 16])
def test_pad_rows_whole_words(width):
    scans = jnp.arange(3 * width, dtype=jnp.uint8).reshape(3, width)
    got = np.asarray(C.pad_rows(scans))
    assert got.shape == (3, -(-width // 4) * 4)
    np.testing.assert_array_equal(got[:, :width], np.asarray(scans))
    assert not got[:, width:].any()


def _fake_nvcc(tmp_path, rc=0):
    log = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        f"echo call >> {log}\n"
        + ('while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n'
           if rc == 0 else "echo 'bad source' >&2\n")
        + f"exit {rc}\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


def test_library_built_once_per_source_hash(tmp_path, monkeypatch):
    nvcc, log = _fake_nvcc(tmp_path)
    monkeypatch.setattr(C, "_nvcc", lambda: nvcc)
    out = tmp_path / "build"
    so = C.library_path(str(out))
    assert os.path.basename(so).startswith("libamvdecode-")
    assert os.path.exists(so) and os.listdir(out) == [os.path.basename(so)]
    assert C.library_path(str(out)) == so
    assert log.read_text().count("call") == 1


def test_library_build_failure_raises(tmp_path, monkeypatch):
    nvcc, _ = _fake_nvcc(tmp_path, rc=1)
    monkeypatch.setattr(C, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad source"):
        C.library_path(str(tmp_path / "build"))
    assert os.listdir(tmp_path / "build") == []


@pytest.mark.parametrize("plat,decoder,adpcm_enc", [
    ("gpu", "decode_scans_cuda", "encode_samples_triton"),
    ("cpu", "decode_scans_device", "encode_samples"),
])
def test_backend_choice(monkeypatch, plat, decoder, adpcm_enc):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    assert backend.entropy_decoder().__name__ == decoder
    assert backend.adpcm_encoder().__name__ == adpcm_enc


@pytest.mark.parametrize("plat", ["rocm", "METAL", "neuron"])
def test_backend_rejects_other_platforms(monkeypatch, plat):
    monkeypatch.setattr(jax, "default_backend", lambda: plat)
    for select in (backend.entropy_decoder, backend.adpcm_encoder):
        with pytest.raises(RuntimeError, match="unsupported JAX platform"):
            select()


@pytest.mark.gpu
def test_cuda_decoder_matches_c_and_xla(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    rows, _ = native.unescape_frames(s.video_chunks)
    want = huffman_decode_frames(s.video_chunks, 48)
    got, ok = C.decode_scans_cuda(jnp.asarray(rows), 48)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert np.asarray(ok).all()
    ref, _ = decode_scans_device(jnp.asarray(rows), 48)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


@pytest.mark.gpu
def test_cuda_decoder_flags_malformed(sample_amv_bytes):
    s = riff.demux(sample_amv_bytes)
    p = bytearray(s.video_chunks[0])
    p[10:18] = b"\xFF\x00" * 4
    rows, _ = native.unescape_frames([bytes(p)] + s.video_chunks[1:3])
    got, ok = C.decode_scans_cuda(jnp.asarray(rows), 48)
    np.testing.assert_array_equal(np.asarray(ok), [False, True, True])
    np.testing.assert_array_equal(
        np.asarray(got)[1:], huffman_decode_frames(s.video_chunks[1:3], 48))
