"""Kernel selection: the one place that maps the JAX platform to each
stage's implementation.

* ``"gpu"`` gets the Hopper kernels that measurement kept (PERF.md,
  "Kernel decisions");
* ``"cpu"`` gets the plain JAX versions;
* any other platform raises.  Nothing falls back.

Every selector is called at trace time, so a jitted chain picks its
kernels once per compilation.  The module also keeps the two pieces of
process state the entry points share: the persistent compile cache and
the count of frames that left the device chain for a host re-encode.
"""

from __future__ import annotations

import collections
import os

import jax

from .kernels import adpcm, entropy_decode

PLATFORMS = ("gpu", "cpu")

# frames (or chunks) that took a host re-encode, by stage; the device
# chain hands a frame to the host only on bad VLC data or an output
# budget overflow, so on a valid corpus every count stays 0
host_fallbacks: collections.Counter = collections.Counter()


def platform() -> str:
    """The JAX platform, checked against the supported ones."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(f"unsupported JAX platform {p!r}: amv_tpu runs "
                           f"on {' or '.join(PLATFORMS)}")
    return p


def entropy_decoder():
    """Huffman scan decode: (scans uint8 [F, W], n_mcu) ->
    (levels int16 [F, n_mcu, 6, 64], ok bool [F])."""
    if platform() == "gpu":
        from .kernels.entropy_decode_cuda import decode_scans_cuda
        return decode_scans_cuda
    return entropy_decode.decode_scans_device


def adpcm_encoder():
    """IMA-ADPCM stream encode: (samples int32 [B, n], reset bool [B, n],
    step_index [B]) -> (nibbles int32 [B, n], step_index_before [B, n])."""
    if platform() == "gpu":
        from .kernels.adpcm_encode_triton import encode_samples_triton
        return encode_samples_triton
    return adpcm.encode_samples


def count_host_fallback(stage: str, n: int) -> None:
    if n:
        host_fallbacks[stage] += int(n)


def enable_compile_cache(root: str | None = None) -> str:
    """Point JAX's persistent compile cache at JAX_COMPILATION_CACHE_DIR
    when it is set (JAX reads it itself), else at ``.jax_cache/`` in the
    checkout.  Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        if root is None:
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = os.path.join(root, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
