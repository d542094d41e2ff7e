"""Image rescale kernels (libswscale's scaling role, L5).

The reference CLI feeds arbitrary input video through sws_scale to the
fixed AMV encode size (`ffmpeg.c:757,1684`; canonical `-s 160x120`,
AMVmuxer/Makefile:25-27).  This module provides that capability
on the device: separable polyphase filtering, expressed as a handful of
static gathers + integer multiply-accumulates per axis so XLA keeps the
whole thing fused and the result is bit-reproducible on any backend
(swscale itself uses 14-bit fixed-point accumulation, swscale.c; we
mirror that arithmetic but do not chase bit-identity with its
version-specific filter tables).

Filters (the reference's full SWS_* flag set, swscale.h /
swscale.c:1065-1161 initFilter kernels):
  * 'bilinear' — 2-tap triangle (SWS_BILINEAR)
  * 'bicubic'  — 4-tap cubic with a = -0.6, ffmpeg's default bicubic
    parameter (swscale default when no flags given, utils.c)
  * 'point'    — nearest neighbour (SWS_POINT), no anti-alias stretch
  * 'area'     — box average (SWS_AREA): exact pixel averaging on
    integer downscales, nearest-dominated on upscales
  * 'lanczos'  — 6-tap Lanczos-3 windowed sinc (SWS_LANCZOS)
  * 'gauss'    — 2^(-3 d^2) Gaussian, default param 3 (SWS_GAUSS,
    swscale.c:1133-1137)
  * 'sinc'     — unwindowed sinc, support 20 (SWS_SINC,
    swscale.c:1138-1141)
  * 'spline'   — natural bicubic spline via the reference's
    getSplineCoeff recursion (SWS_SPLINE, swscale.c:971-980,1153-1157)
  * 'experimental' — raised-cosine window, default A = 1 (SWS_X,
    swscale.c:1114-1125)
'bicublin' (SWS_BICUBLIN: bicubic luma, bilinear chroma,
swscale.c:2295-2341) is handled at the resize_yuv420 level.
All use the standard center convention src = (dst + 0.5) * L / Ld - 0.5
with edge clamping (replicated borders, like swscale).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_SHIFT = 14  # swscale's 14-bit coefficient fixed point


def _cubic(x: np.ndarray, a: float = -0.6) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1, (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * (ax**3 - 5 * ax**2 + 8 * ax - 4), 0.0))


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _box(x: np.ndarray) -> np.ndarray:
    return (np.abs(x) <= 0.5).astype(np.float64)


def _lanczos(x: np.ndarray, a: float = 3.0) -> np.ndarray:
    ax = np.abs(x)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(ax < a, out, 0.0)


def _gauss(x: np.ndarray, p: float = 3.0) -> np.ndarray:
    return np.exp2(-p * x * x)


def _sinc(x: np.ndarray) -> np.ndarray:
    return np.sinc(x)


def _spline(x: np.ndarray) -> np.ndarray:
    """Natural bicubic spline: getSplineCoeff(1, 0, p, -p-1, d) with
    p = -2.196152422706632 (swscale.c:971-980,1153-1157), the tail
    recursion unrolled over the 10-pixel support."""
    p = -2.196152422706632
    d = np.abs(x).astype(np.float64)
    a = np.ones_like(d)
    b = np.zeros_like(d)
    c = np.full_like(d, p)
    e = np.full_like(d, -p - 1.0)
    for _ in range(10):
        go = d > 1.0
        a, b, c, e = (np.where(go, 0.0, a),
                      np.where(go, b + 2 * c + 3 * e, b),
                      np.where(go, c + 3 * e, c),
                      np.where(go, -b - 3 * c - 6 * e, e))
        d = np.where(go, d - 1.0, d)
    return ((e * d + c) * d + b) * d + a


def _xexp(x: np.ndarray) -> np.ndarray:
    """SWS_X 'experimental': cos window with signed pow A (default 1),
    mapped to [0, 1] (swscale.c:1114-1125) — zero beyond d = 1."""
    d = np.abs(x)
    c = np.where(d < 1.0, np.cos(d * np.pi), -1.0)
    return c * 0.5 + 0.5


def _build_taps(src_l: int, dst_l: int, filt: str):
    """Per-output-sample tap indices + 2^14-scaled int weights.

    Returns (idx int32 [dst_l, T], w int32 [dst_l, T]).  When
    downscaling, the kernel is stretched by the scale factor (anti-alias),
    matching swscale's filter construction.
    """
    scale = src_l / dst_l
    stretch = max(1.0, scale)
    if filt == "point":
        # nearest neighbour: one tap, no anti-alias stretch (SWS_POINT)
        pos = (np.arange(dst_l) + 0.5) * scale - 0.5
        idx = np.clip(np.floor(pos + 0.5).astype(np.int64),
                      0, src_l - 1)[:, None]
        w = np.full((dst_l, 1), 1 << _SHIFT, np.int64)
        return idx.astype(np.int32), w.astype(np.int32)
    if filt == "bilinear":
        base_r, fn = 1.0, _triangle
    elif filt == "bicubic":
        base_r, fn = 2.0, _cubic
    elif filt == "area":
        base_r, fn = 0.5, _box
    elif filt == "lanczos":
        base_r, fn = 3.0, _lanczos
    elif filt == "gauss":
        base_r, fn = 4.0, _gauss      # sizeFactor 8, swscale.c:1068
    elif filt == "sinc":
        base_r, fn = 10.0, _sinc      # sizeFactor 20, swscale.c:1070
    elif filt == "spline":
        base_r, fn = 10.0, _spline    # sizeFactor 20, swscale.c:1071
    elif filt == "experimental":
        base_r, fn = 4.0, _xexp       # sizeFactor 8, swscale.c:1066
    else:
        raise ValueError(f"unknown filter {filt!r}")
    radius = base_r * stretch
    ntaps = max(2, int(np.ceil(2 * radius)))
    pos = (np.arange(dst_l) + 0.5) * scale - 0.5
    # centered tap window: ceil(pos - ntaps/2) puts the ntaps integers
    # symmetrically around pos.  (The previous floor(pos - radius + 0.5)
    # was off by up to one tap for fractional phases — e.g. 2-tap
    # bilinear upscale degenerated to nearest-neighbour for frac < 0.5.)
    i0 = np.ceil(pos - ntaps / 2).astype(np.int64)
    t = np.arange(ntaps)
    idx = i0[:, None] + t[None, :]
    x = (idx - pos[:, None]) / stretch
    w = fn(x)
    s = w.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    wq = np.floor(w / s * (1 << _SHIFT) + 0.5).astype(np.int64)
    # force exact sum 2^14 (push the residue onto the largest tap) so flat
    # areas stay flat
    resid = (1 << _SHIFT) - wq.sum(axis=1)
    wq[np.arange(dst_l), np.abs(w).argmax(axis=1)] += resid
    idx = np.clip(idx, 0, src_l - 1)
    return idx.astype(np.int32), wq.astype(np.int32)


@partial(jax.jit, static_argnames=("dst_l", "filt", "axis"))
def _resize_axis(x: jnp.ndarray, dst_l: int, filt: str, axis: int):
    src_l = x.shape[axis]
    idx, w = _build_taps(src_l, dst_l, filt)
    acc = jnp.zeros(x.shape[:axis] + (dst_l,) + x.shape[axis + 1:],
                    jnp.int32)
    wshape = [1] * x.ndim
    wshape[axis] = dst_l
    for t in range(idx.shape[1]):
        col = jnp.take(x, jnp.asarray(idx[:, t]), axis=axis)
        acc = acc + col * jnp.asarray(w[:, t]).reshape(wshape)
    return acc


@partial(jax.jit, static_argnames=("dst_h", "dst_w", "filt"))
def resize_plane(x: jnp.ndarray, dst_h: int, dst_w: int,
                 filt: str = "bicubic") -> jnp.ndarray:
    """uint8 [..., H, W] -> uint8 [..., dst_h, dst_w].

    Horizontal pass at 14-bit precision, rounded back to 14 bits, then
    the vertical pass (swscale's hScale -> vScale ordering).
    """
    h = _resize_axis(x.astype(jnp.int32), dst_w, filt, x.ndim - 1)
    h = (h + (1 << (_SHIFT - 1))) >> _SHIFT
    v = _resize_axis(h, dst_h, filt, x.ndim - 2)
    v = (v + (1 << (_SHIFT - 1))) >> _SHIFT
    return jnp.clip(v, 0, 255).astype(jnp.uint8)


def resize_yuv420(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray,
                  dst_h: int, dst_w: int, filt: str = "bicubic"):
    """Resize YUV420 planes to dst (luma dst, chroma dst/2).

    'bicublin' = bicubic luma + bilinear chroma (SWS_BICUBLIN: swscale
    builds the luma scaler with SWS_BICUBIC and the chroma scaler with
    SWS_BILINEAR, swscale.c:2295-2341)."""
    if dst_h % 2 or dst_w % 2:
        raise ValueError("YUV420 target dims must be even")
    yf, cf = ("bicubic", "bilinear") if filt == "bicublin" else (filt, filt)
    return (resize_plane(y, dst_h, dst_w, yf),
            resize_plane(cb, dst_h // 2, dst_w // 2, cf),
            resize_plane(cr, dst_h // 2, dst_w // 2, cf))
