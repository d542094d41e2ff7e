"""GPU Huffman scan decode: the CUDA kernel in cuda/entropy_decode.cu,
called through jax.ffi.

Huffman decode is bit-serial within a frame and free across frames, and
a SIMT thread keeps its own bit cursor, so the kernel runs one thread
per frame with the bit reader in registers and the four Huffman tables
in shared memory.  The plain JAX decoder (entropy_decode.py) is the same
contract and the reference the kernel is checked against.

The shared library is built from the committed source with nvcc at first
use, into ``cuda/build/`` (listed in .gitignore), under a name keyed by
the source's hash, so a changed source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..bitstream import jpeg_tables as T

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_SRC = os.path.join(_DIR, "entropy_decode.cu")
BUILD_DIR = os.path.join(_DIR, "build")
_TARGET = "amv_decode_scans"
N_SLOTS = 8            # second-level slots per table (kSlots in the source)
_TABLES = ((T.BITS_DC_LUMA, T.VALS_DC_LUMA),
           (T.BITS_DC_CHROMA, T.VALS_DC_CHROMA),
           (T.BITS_AC_LUMA, T.VALS_AC_LUMA),
           (T.BITS_AC_CHROMA, T.VALS_AC_CHROMA))


def build_luts():
    """Two-level decode LUTs (layout documented in the .cu source):
    lut1 uint16 [4, 256], lut2 uint16 [4, N_SLOTS, 256]."""
    lut1 = np.zeros((4, 256), np.uint16)
    lut2 = np.zeros((4, N_SLOTS, 256), np.uint16)
    for t, (bits, vals) in enumerate(_TABLES):
        syms, lens = T.build_decode_table(bits, vals)
        ent = (syms.astype(np.uint32) << 5) | lens
        n_slots = 0
        for p in range(256):
            e = ent[p << 8: (p + 1) << 8]
            longest = int(lens[p << 8: (p + 1) << 8].max())
            if longest == 0:
                continue
            if longest <= 8:
                lut1[t, p] = e[0]
                continue
            assert n_slots < N_SLOTS, "Huffman table needs more LUT slots"
            lut1[t, p] = 0x8000 | n_slots
            lut2[t, n_slots] = e
            n_slots += 1
    return lut1, lut2


def pad_rows(scans):
    """Zero-pad scan rows to a whole number of 32-bit words (the kernel
    reads the stream a word at a time)."""
    pad = -scans.shape[1] % 4
    return jnp.pad(scans, ((0, 0), (0, pad))) if pad else scans


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the GPU entropy decoder is built "
                       "from cuda/entropy_decode.cu at first use")


def library_path(out_dir: str = BUILD_DIR) -> str:
    """Build (once per source hash) and return the kernel library."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(out_dir, f"libamvdecode-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, _SRC]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    os.replace(tmp, so)
    return so


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(library_path())
    jax.ffi.register_ffi_target(_TARGET, jax.ffi.pycapsule(lib.AmvDecodeScans),
                                platform="CUDA")


_LUT1, _LUT2 = build_luts()


@partial(jax.jit, static_argnames=("n_mcu",))
def decode_scans_cuda(scans, n_mcu: int):
    """scans uint8 [F, max_bytes] unescaped, zero-padded ->
    (levels int16 [F, n_mcu, 6, 64] zigzag with slot 0 = DC difference,
     ok bool [F]); a frame with a malformed block has ok False."""
    _register()
    scans = pad_rows(scans.astype(jnp.uint8))
    F = scans.shape[0]
    call = jax.ffi.ffi_call(
        _TARGET,
        (jax.ShapeDtypeStruct((F, n_mcu, 6, 64), jnp.int16),
         jax.ShapeDtypeStruct((F,), jnp.int32)))
    levels, status = call(scans, jnp.asarray(_LUT1), jnp.asarray(_LUT2),
                          n_mcu=np.int64(n_mcu))
    return levels, status == 0
