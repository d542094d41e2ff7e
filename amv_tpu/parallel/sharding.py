"""Multi-device sharding for the AMV codec pipeline.

The codec has no cross-frame or cross-chunk state (video frames are
independent intra-only pictures; each audio chunk carries its own codec
state; each speech stream is its own recurrence), so scaling is pure
data parallelism: a 1-D 'dp' mesh over frames, chunks or streams, with
zero collectives.  The reference has no distributed runtime at all
(SURVEY.md §2.5).

Chains that contain a custom kernel (the GPU Huffman decoder is a
jax.ffi call, the ADPCM encoder a Pallas call) have no partitioning
rule, so they are mapped explicitly with shard_map: each device runs the
whole chain on its local frames.  Plain XLA stages shard through jit
in/out shardings.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import backend
from ..codecs.amv_video import decode_transform, encode_transform
from ..kernels import adpcm as KA


def make_mesh(devices=None) -> Mesh:
    """A 1-D ('dp',) mesh over the given devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("dp",))


def _data_parallel(fn, mesh: Mesh, n_in: int, n_out: int):
    """jit(shard_map(fn)) with every input and output split on 'dp'."""
    spec = P("dp")
    out_specs = spec if n_out == 1 else (spec,) * n_out
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                                 out_specs=out_specs, check_vma=False))


def sharded_decode_step(mesh: Mesh, mb_w: int, mb_h: int,
                        width: int, height: int):
    """Jitted video decode transform with frames sharded on dp."""
    s = NamedSharding(mesh, P("dp"))
    fn = partial(decode_transform, mb_w=mb_w, mb_h=mb_h,
                 width=width, height=height)
    return jax.jit(fn, in_shardings=(s,), out_shardings=(s, s, s))


def sharded_encode_step(mesh: Mesh, mb_w: int, mb_h: int, qscale: int = 2):
    """Jitted video encode transform with frames sharded on dp."""
    s = NamedSharding(mesh, P("dp"))
    fn = partial(encode_transform, mb_w=mb_w, mb_h=mb_h, qscale=qscale)
    return jax.jit(fn, in_shardings=(s, s, s), out_shardings=s)


def sharded_transcode_step(mesh: Mesh, qscale: int = 2):
    """Jitted fused transform (pipeline.transcode.transcode_levels_fused)
    with frames sharded on dp: even the DC-prediction cumsum is
    per-frame, so each device transcodes its frames independently."""
    from ..pipeline.transcode import transcode_levels_fused
    s = NamedSharding(mesh, P("dp"))
    fn = partial(transcode_levels_fused, qscale=qscale)
    return jax.jit(fn, in_shardings=(s,), out_shardings=(s, s))


def sharded_entropy_decode(mesh: Mesh, n_mcu: int):
    """Device Huffman decode (backend.entropy_decoder) with frames sharded
    on dp: scans are independent bitstreams.  Returns (levels, ok)."""
    def fn(scans):
        return backend.entropy_decoder()(scans, n_mcu)
    return _data_parallel(fn, mesh, 1, 2)


def sharded_transcode_scans(mesh: Mesh, **kw):
    """The complete device transcode chain (pipeline.transcode
    .transcode_scans: Huffman decode, transform, Huffman encode with
    framing) with frames sharded over the mesh; kw are its keyword
    arguments.  Returns (payload, lens, ok) like the unsharded chain."""
    from ..pipeline.transcode import transcode_scans
    return _data_parallel(partial(transcode_scans, **kw), mesh, 1, 3)


def sharded_adpcm_decode(mesh: Mesh):
    """ADPCM chunk decode (kernels.adpcm.decode_chunks) with chunks
    sharded on dp."""
    s = NamedSharding(mesh, P("dp"))
    return jax.jit(KA.decode_chunks, in_shardings=(s, s, s), out_shardings=s)


def sharded_adpcm_encode(mesh: Mesh):
    """ADPCM stream encode (backend.adpcm_encoder) with streams sharded
    on dp: each stream carries its own {prev_sample, step_index}."""
    def fn(samples, reset, sidx):
        return backend.adpcm_encoder()(samples, reset, sidx)
    return _data_parallel(fn, mesh, 3, 2)


def sharded_g729_decode_chain(mesh: Mesh):
    """Jitted G.729A frame-chain decoder with streams sharded on dp.

    Takes (state pytree [B,...], parms int32 [T, B, 16]) like
    codecs.g729a._decode_chain; the frame axis stays sequential."""
    from ..codecs.g729a import _decode_chain
    st_s = NamedSharding(mesh, P("dp"))
    parms_s = NamedSharding(mesh, P(None, "dp"))
    return jax.jit(_decode_chain, in_shardings=(st_s, parms_s),
                   out_shardings=(st_s, parms_s))


def sharded_g729_decode_scan(mesh: Mesh):
    """Jitted lax.scan G.729A decoder (one dispatch for T frames,
    codecs.g729a.decode_frames_scan) with streams sharded on dp."""
    from ..codecs.g729a import decode_frames_scan
    st_s = NamedSharding(mesh, P("dp"))
    parms_s = NamedSharding(mesh, P(None, "dp"))
    return jax.jit(decode_frames_scan.__wrapped__,
                   in_shardings=(st_s, parms_s),
                   out_shardings=(st_s, parms_s))


def sharded_g729_encode_scan(mesh: Mesh):
    """Jitted lax.scan G.729A encoder chain (encode_frames_scan):
    state/hist shard on dp, frames [T, B, 80] shard the stream axis."""
    from ..codecs.g729a_encoder_tpu import encode_frames_scan
    s = NamedSharding(mesh, P("dp"))
    f_s = NamedSharding(mesh, P(None, "dp"))
    return jax.jit(encode_frames_scan.__wrapped__,
                   in_shardings=(s, s, f_s), out_shardings=(s, s, f_s))


def sharded_g729_encode_step(mesh: Mesh):
    """Jitted G.729A encoder frame step with streams sharded on dp.
    Takes (state pytree [B,...], hist [B,160], samples [B,80]) and
    returns (state, hist, parm [B,16])."""
    from ..codecs.g729a_encoder_tpu import encode_frame_batch
    s = NamedSharding(mesh, P("dp"))
    return jax.jit(encode_frame_batch.__wrapped__,
                   in_shardings=(s, s, s), out_shardings=(s, s, s))
