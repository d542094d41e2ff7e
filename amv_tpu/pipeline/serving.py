"""Batched AMV transcode: fixed-shape batches, deep dispatch.

`AsyncTranscoder` runs the device chain (transcode.transcode_scans) over
fixed-shape batches of frames; `transcode_bytes` (pipeline/transcode.py)
runs every file through it.

* device memory is bounded by one batch, whatever the input length:
  `batch_frames_for` sizes a file's batch to the next power of two of
  its frame count, capped at BATCH_MCUS macroblocks;
* compiled shapes are few: a batch is (batch_frames, w_bytes), w_bytes
  is rounded up to whole KiB, and the last batch is padded with repeats
  of its shortest payload whose outputs are dropped;
* `depth` batches stay in flight: JAX dispatch is async, so batch
  i+1's host unescape (C), host->device copy and dispatch ride under
  batch i's device work, and the host collection of batch i-depth
  overlaps the same way;
* frames are length-sorted within each batch and the original order is
  restored on emit.

Frames the chain rejects (bad VLC data, an output budget overflow) are
re-encoded on the host one by one and counted in
backend.host_fallbacks["transcode"]; the rest of the batch keeps its
device output.  Reference semantics: mjpegdec.c:376-430 decode,
mjpegenc.c:379-450 encode.
"""
from __future__ import annotations

import collections
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .transcode import (collect_payloads, host_reencode, out_bytes_bound,
                        transcode_scans, unescape_sorted)

# macroblocks per device batch at most: the chain's temporaries take
# about 13 KB per macroblock, so a batch stays near 7 GB of device memory
BATCH_MCUS = 1 << 19


def batch_frames_for(n_frames: int, width: int, height: int) -> int:
    """Frames per batch for an input of n_frames: the next power of two
    (so inputs of similar length share a compiled shape), at most
    BATCH_MCUS macroblocks, at least 1."""
    n_mcu = ((width + 15) // 16) * ((height + 15) // 16)
    cap = 1 << max(0, (BATCH_MCUS // n_mcu).bit_length() - 1)
    need = 1 << max(0, n_frames - 1).bit_length()
    return min(cap, need)


def row_width(payloads) -> int:
    """Unescaped-row width for a known payload list: the longest escaped
    payload (which bounds its unescaped scan) rounded up to whole KiB."""
    return -(-max(len(p) for p in payloads) // 1024) * 1024


class AsyncTranscoder:
    """Order-preserving AMV payload transcoder over fixed-shape batches.

    Parameters
    ----------
    width, height : frame geometry (fixed per instance).
    qscale : re-encode quantizer scale (reference default 2).
    quant : "ffmpeg" or "q60" re-quantization (transcode.requantize).
    batch_frames : frames per device batch = the one compiled shape.
    depth : batches kept in flight before blocking on the oldest.
    w_bytes : fixed unescaped-row width.  None = set from the first
        batch (or, via `transcode`, from the whole input rounded up to
        whole KiB); a later batch with longer scans then raises — pass
        an explicit bound for open-ended streams.
    mesh : optional jax.sharding.Mesh — each batch's frames shard over
        the whole mesh (frames are independent bitstreams: zero
        collectives, parallel/sharding.sharded_transcode_scans);
        batch_frames must divide by mesh.size.
    """

    def __init__(self, width: int, height: int, qscale: int = 2,
                 quant: str = "ffmpeg", batch_frames: int = 4096,
                 depth: int = 4, w_bytes: int | None = None, mesh=None):
        if mesh is not None and batch_frames % mesh.size:
            raise ValueError(f"batch_frames={batch_frames} must divide "
                             f"by mesh.size={mesh.size}")
        self.width, self.height = width, height
        self.qscale, self.quant = qscale, quant
        self.batch_frames = batch_frames
        self.depth = max(1, depth)
        self.w_bytes = w_bytes
        self.mesh = mesh
        self._chains = {}

    def _chain(self, rows):
        max_bytes = out_bytes_bound(self.w_bytes)
        fn = self._chains.get(max_bytes)
        if fn is None:
            kw = dict(width=self.width, height=self.height,
                      qscale=self.qscale, quant=self.quant,
                      max_bytes=max_bytes)
            if self.mesh is None:
                fn = partial(transcode_scans, **kw)
            else:
                from ..parallel.sharding import sharded_transcode_scans
                fn = sharded_transcode_scans(self.mesh, **kw)
            self._chains[max_bytes] = fn
        return fn(rows)

    # ------------------------------------------------------------------
    def _issue(self, payloads):
        """Enqueue one batch; returns unfetched device handles + meta."""
        n = len(payloads)
        pad_src = min(payloads, key=len)
        batch = list(payloads) + [pad_src] * (self.batch_frames - n)
        rows, inv = unescape_sorted(batch)
        if self.w_bytes is None:
            self.w_bytes = rows.shape[1]
        if rows.shape[1] > self.w_bytes:
            raise ValueError(
                f"batch scan width {rows.shape[1]} exceeds the compiled "
                f"row width {self.w_bytes}; construct AsyncTranscoder with "
                "a w_bytes bound for this stream")
        if rows.shape[1] < self.w_bytes:
            rows = np.pad(rows, ((0, 0), (0, self.w_bytes - rows.shape[1])))
        arr = jnp.asarray(rows)
        if self.mesh is None:
            arr = jax.device_put(arr)  # mesh mode: jit shards placement
        return (*self._chain(arr), inv, n, payloads)

    def _drain(self, entry):
        """Block on one batch's handles; return payload bytes in order."""
        payload, lens, ok, inv, n, payloads = entry
        return collect_payloads(
            payload, lens, ok, inv, n,
            lambda idx: host_reencode([payloads[i] for i in idx],
                                      self.width, self.height, self.qscale,
                                      self.quant))

    # ------------------------------------------------------------------
    def stream(self, payload_iter):
        """Yield re-encoded payloads in input order; `depth` batches of
        `batch_frames` frames stay queued on the device ahead of the
        oldest one being collected."""
        inflight = collections.deque()
        buf = []
        for p in payload_iter:
            buf.append(p)
            if len(buf) == self.batch_frames:
                inflight.append(self._issue(buf))
                buf = []
                if len(inflight) >= self.depth:
                    yield from self._drain(inflight.popleft())
        if buf:
            inflight.append(self._issue(buf))
        while inflight:
            yield from self._drain(inflight.popleft())

    def transcode(self, payloads) -> list[bytes]:
        """Transcode a known-size payload list (row width bounded up
        front and rounded to whole KiB, so any batch mix compiles once
        and inputs of similar scan width share the compiled shape)."""
        payloads = list(payloads)
        if not payloads:
            return []
        if self.w_bytes is None:
            self.w_bytes = row_width(payloads)
        return list(self.stream(payloads))
