"""Batched device G.729A encoder: B independent streams encoded in lockstep.

The device twin of codecs/g729a_encoder.py (same algorithm: hybrid float
analysis + exact-integer shadow-decoder searches), built on the batched
exact decoder primitives of codecs/g729a.py, so the encoder's shadow state
*is* the batched decoder state and tracks the real decoder bit-exactly.

The reference repo vendors no encoder at all (G.729/README:1-12 — it wraps
the external ITU sources); this module both fills that gap and runs it as
one jitted program per frame across the whole stream batch:

* LP analysis / LSF extraction: f32 windowed autocorrelation + Levinson +
  a 512-point Chebyshev-grid root search, all [B]-vectorized;
* LSF quantization: switched-MA two-stage VQ searched through the
  decoder's exact integer reconstruction ([2*top8] candidates, codewords
  gathered from the integer tables);
* closed-loop pitch: EXHAUSTIVE over the full static (lag, fraction)
  grid — all 124 integer lags x 3 fractions scored in the synthesis
  domain via one Toeplitz matmul, no open-loop pre-estimate (stronger
  than the ITU two-stage search);
* fixed codebook: exhaustive joint 8x8x8x16 ACELP search with the
  pitch-sharpened impulse response (d/phi from two matmuls);
* gains: exhaustive exact GA x GB (decoder gain arithmetic replayed for
  all 128 combos);
* state update: the decoder's own batched routines (decode_ac_vector,
  fix_fc_vector, get_gain_code, mem_update, lp_synthesis_filter).

Every float contraction runs at Precision.HIGHEST: a GPU may otherwise
run float32 matrix products in TF32 (about three decimal digits), which
moves the search scores and so the chosen codewords.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..verify import ref_g729 as R
from . import g729_tables as T
from . import g729a as G
from .g729a_encoder import _WLP, _LAG_WINDOW, pack_parameters

_HI = jax.lax.Precision.HIGHEST
_ein = partial(jnp.einsum, precision=_HI)

SUBFRAME, FRAME = 40, 80
PITCH_MIN, PITCH_MAX = 20, 143
_HIST_SPAN = PITCH_MAX + R.INTERPOL_LEN  # AC-candidate history window


# ---------------------------------------------------------------------------
# float analysis helpers (all [B]-batched)
# ---------------------------------------------------------------------------

def _levinson_batch(r):
    """r [B,11] -> a [B,11] (a[:,0]=1)."""
    B = r.shape[0]
    a = jnp.zeros((B, 11)).at[:, 0].set(1.0)
    err = r[:, 0]
    for i in range(1, 11):
        acc = r[:, i]
        for j in range(1, i):
            acc = acc + a[:, j] * r[:, i - j]
        k = jnp.where(err > 0, -acc / jnp.where(err > 0, err, 1.0), 0.0)
        new = a
        for j in range(1, i + 1):
            new = new.at[:, j].set(a[:, j] + k * a[:, i - j])
        a = new
        err = jnp.maximum(err * (1 - k * k), 1e-6)
    return a


def _chebyshev_roots(c5, mid):
    """First 5 roots in (0, pi) of mid + 2*sum_k c5[:,k-1] cos(k w).

    c5 [B,5], mid [B] -> roots [B,5] (radians), found [B] bool.
    """
    grid = jnp.linspace(0.0, np.pi, 512)
    kk = jnp.arange(1, 6)
    cosg = jnp.cos(grid[:, None] * kk[None, :])          # [512,5]
    vals = mid[:, None] + 2.0 * jnp.matmul(c5, cosg.T, precision=_HI)
    sign_change = vals[:, :-1] * vals[:, 1:] < 0         # [B,511]
    # index of the k-th sign change per row (k = 0..4)
    csum = jnp.cumsum(sign_change.astype(jnp.int32), axis=1)
    idxs = []
    for k in range(1, 6):
        hit = sign_change & (csum == k)
        idxs.append(jnp.argmax(hit, axis=1))             # [B]
    idx = jnp.stack(idxs, axis=1)                        # [B,5]
    found = csum[:, -1] >= 5
    lo = jnp.take(grid, idx)
    hi = jnp.take(grid, idx + 1)
    flo = jnp.take_along_axis(vals, idx, axis=1)

    def value(w):            # w [B,5]
        c = jnp.cos(w[..., None] * kk)                   # [B,5,5]
        return mid[:, None] + 2.0 * _ein("bk,brk->br", c5, c)

    # 12 bisection steps refine the pi/511 grid interval to ~1.5e-6 rad —
    # two orders below the Q13 LSF quantization step (2^-13 rad =
    # 1.2e-4), so deeper iteration cannot change the quantizer's choice
    # (30 iterations measured ~2.5 ms/frame-step at B=1024 vs ~1 ms)
    for _ in range(12):
        mid_w = 0.5 * (lo + hi)
        fm = value(mid_w)
        take_hi = flo * fm <= 0
        hi = jnp.where(take_hi, mid_w, hi)
        lo = jnp.where(take_hi, lo, mid_w)
        flo = jnp.where(take_hi, flo, fm)
    return 0.5 * (lo + hi), found


def _lp_to_lsf_batch(a):
    """a [B,11] -> lsf [B,10] ascending radians (uniform fallback)."""
    # P(z) = A + z^-11 rev(A); Q = A - z^-11 rev(A); deflate (1 +/- z^-1)
    arev = a[:, ::-1]
    p = jnp.concatenate([a, jnp.zeros_like(a[:, :1])], axis=1) \
        + jnp.concatenate([jnp.zeros_like(a[:, :1]), arev], axis=1)
    q = jnp.concatenate([a, jnp.zeros_like(a[:, :1])], axis=1) \
        - jnp.concatenate([jnp.zeros_like(a[:, :1]), arev], axis=1)
    # synthetic division by (1 + z^-1) / (1 - z^-1): 11 coeffs out
    pd = [p[:, 0]]
    qd = [q[:, 0]]
    for i in range(1, 11):
        pd.append(p[:, i] - pd[-1])
        qd.append(q[:, i] + qd[-1])
    pd = jnp.stack(pd, axis=1)   # [B,11] symmetric
    qd = jnp.stack(qd, axis=1)
    # symmetric deg-10: value = c[5] + 2*sum_{k=1..5} c[5-k] cos(k w)
    rp, okp = _chebyshev_roots(pd[:, 4::-1], pd[:, 5])
    rq, okq = _chebyshev_roots(qd[:, 4::-1], qd[:, 5])
    lsf = jnp.sort(jnp.concatenate([rp, rq], axis=1), axis=1)
    ok = okp & okq
    uniform = np.pi * (jnp.arange(1, 11) / 11.0)
    return jnp.where(ok[:, None], lsf, uniform[None, :])


# ---------------------------------------------------------------------------
# LSF quantization (exact integer search, batched)
# ---------------------------------------------------------------------------

_MA_PRED_NP = np.asarray(T.MA_PREDICTOR, np.int64)        # [2,4,10]
_MA_SUM_NP = np.asarray(T.MA_PREDICTOR_SUM, np.int64)     # [2,10]
_CB_L1_NP = np.asarray(T.CB_L1, np.int64)                 # [128,10]
_CB_L23_NP = np.asarray(T.CB_L2_L3, np.int64)             # [32,10]


def _quantize_lsf_batch(st, lsf_rad):
    """lsf_rad [B,10] float -> (L0, L1, L2, L3) int32 [B] each."""
    target = jnp.round(jnp.clip(lsf_rad * 8192.0, 40, 25681)).astype(jnp.int32)
    cb1 = jnp.asarray(_CB_L1_NP.astype(np.int32))
    cb23 = jnp.asarray(_CB_L23_NP.astype(np.int32))
    best_err = None
    best = None
    for L0 in (0, 1):
        msum = jnp.asarray(_MA_SUM_NP[L0].astype(np.int32))      # [10]
        mp = jnp.asarray(_MA_PRED_NP[L0].astype(np.int32))       # [4,10]
        pred = jnp.sum(st["lq_prev"] * mp[None], axis=1)         # [B,10]
        # float target for the VQ pre-search (exact err re-checked below)
        lq_t = ((target.astype(jnp.float32) * 32768.0) -
                pred.astype(jnp.float32)) / msum.astype(jnp.float32)
        d1 = jnp.sum(jnp.abs(cb1[None].astype(jnp.float32) -
                             lq_t[:, None, :]), axis=2)          # [B,128]
        _, l1c = jax.lax.top_k(-d1, 8)                           # [B,8]
        c1 = jnp.take(cb1, l1c, axis=0)                          # [B,8,10]
        resid = lq_t[:, None, :] - c1.astype(jnp.float32)
        d2 = jnp.sum((cb23[None, None, :, :5].astype(jnp.float32)
                      - resid[:, :, None, :5]) ** 2, axis=3)     # [B,8,32]
        l2c = jnp.argmin(d2, axis=2)                             # [B,8]
        d3 = jnp.sum((cb23[None, None, :, 5:].astype(jnp.float32)
                      - resid[:, :, None, 5:]) ** 2, axis=3)
        l3c = jnp.argmin(d3, axis=2)
        # exact reconstruction of each candidate (decoder semantics)
        c23l = jnp.take(cb23, l2c, axis=0)
        c23h = jnp.take(cb23, l3c, axis=0)
        lq = jnp.concatenate([c1[..., :5] + c23l[..., :5],
                              c1[..., 5:] + c23h[..., 5:]], axis=2)
        cols = [lq[..., i] for i in range(10)]
        for J in (10, 5):
            for i in range(1, 10):
                diff = (cols[i - 1] - cols[i] + J) >> 1
                pos = diff > 0
                cols[i - 1] = jnp.where(pos, cols[i - 1] - diff, cols[i - 1])
                cols[i] = jnp.where(pos, cols[i] + diff, cols[i])
        lqs = jnp.stack(cols, axis=2)                            # [B,8,10]
        rec = (lqs * msum[None, None] + pred[:, None, :]) >> 15
        err = jnp.sum((rec - target[:, None, :]) ** 2, axis=2)   # [B,8]
        ebest = jnp.min(err, axis=1)
        kbest = jnp.argmin(err, axis=1)
        rows = jnp.arange(err.shape[0])
        cand = (jnp.full_like(kbest, L0), l1c[rows, kbest],
                l2c[rows, kbest], l3c[rows, kbest])
        if best is None:
            best_err, best = ebest, cand
        else:
            tk = ebest < best_err
            best = tuple(jnp.where(tk, c, b) for c, b in zip(cand, best))
            best_err = jnp.minimum(ebest, best_err)
    return best


# ---------------------------------------------------------------------------
# subframe search pieces
# ---------------------------------------------------------------------------

def _impulse_response(lp):
    """lp [B,10] Q12 -> h [B,40] float impulse response of 1/A."""
    a = lp.astype(jnp.float32) / 4096.0
    h = jnp.zeros((lp.shape[0], SUBFRAME)).at[:, 0].set(1.0)
    for n in range(1, SUBFRAME):
        acc = jnp.zeros(lp.shape[0])
        for i in range(min(10, n)):
            acc = acc + a[:, i] * h[:, n - 1 - i]
        h = h.at[:, n].set(-acc)
    return h


def _zir(lp, syn_filter_data):
    """Zero-input response of 1/A from the shadow memory. [B,40] float."""
    a = lp.astype(jnp.float32) / 4096.0
    hist = syn_filter_data.astype(jnp.float32)   # [B,10] oldest-first
    out = []
    for _ in range(SUBFRAME):
        s = -_ein("bi,bi->b", a, hist[:, ::-1])
        out.append(s)
        hist = jnp.concatenate([hist[:, 1:], s[:, None]], axis=1)
    return jnp.stack(out, axis=1)


def _toeplitz(h):
    """h [B,40] -> H [B,n,k] with H[n,k] = h[n-k] (lower-triangular)."""
    n = np.arange(SUBFRAME)
    idx = np.maximum(n[:, None] - n[None, :], 0)
    mask = (n[:, None] >= n[None, :])
    return jnp.where(jnp.asarray(mask)[None], h[:, jnp.asarray(idx)], 0.0)


# static interpolation-tap matrices for the 3 fractional phases
_C1_NP = np.array([[float(R._INTERP_FLAT[3 * i + f]) for i in range(10)]
                   for f in range(3)], np.float32)
_C2_NP = np.array([[float(R._INTERP_FLAT[3 * i + 3 - f]) for i in range(10)]
                   for f in range(3)], np.float32)
_UPS_LEN = PITCH_MAX + 1  # history positions q in [-144, -1] (lag 143 frac=-1 reads q=-144)
# gather window for each q: history indices (q - i) and (q + i + 1)
_UWIN = np.concatenate(
    [(np.arange(-_UPS_LEN, 0)[:, None] - np.arange(10)[None, :]),
     (np.arange(-_UPS_LEN, 0)[:, None] + np.arange(10)[None, :] + 1)],
    axis=1) + _HIST_SPAN                    # [143, 20], indices into histf
_UWIN = np.clip(_UWIN, 0, _HIST_SPAN - 1)  # q >= -10 taps would poke past
# the history end; the exact decoder reads generated samples there — the
# clamp only affects the *search* scores of short lags (ITU's own search
# uses a periodic-extension approximation in the same region)


def _build_cand_grid():
    """Static exhaustive closed-loop candidate grid: every legal
    (integer lag, fraction) pair, with a constant index table into the
    flattened phase-upsampled history U [3 * _UPS_LEN].

    A constant-index gather plus one larger einsum scores every
    candidate, so the search is exhaustive over all 124 lags instead of a
    +-5 window around an open-loop estimate (the open-loop stage is gone
    entirely), and the scored criterion can only improve.

    Returns (t_flat [C], f_flat [C], idx [C, 40], valid_sf1 [C]) with
    C = 124 * 3; validity for subframe 2 is a per-lane window mask
    computed at trace time.
    """
    ts = np.arange(PITCH_MIN, PITCH_MAX + 1)
    fs = np.array([-1, 0, 1])
    C = len(ts) * len(fs)
    t_flat = np.repeat(ts, 3)
    f_flat = np.tile(fs, len(ts))
    idx = np.zeros((C, SUBFRAME), np.int32)
    valid1 = np.zeros(C, bool)
    n = np.arange(SUBFRAME)
    for k in range(C):
        t, f = int(t_flat[k]), int(f_flat[k])
        fp = -f
        ti = t
        if fp < 0:
            fp += 3
            ti += 1
        # period repetition for lags shorter than the subframe: q >= 0
        # reads the previous period (q - ti <= 39 - 2*PITCH_MIN < 0, one
        # wrap is always enough)
        q = n - ti
        q = np.where(q >= 0, q - ti, q)
        idx[k] = fp * _UPS_LEN + (q + _UPS_LEN)
        # subframe 1 encoding: fractions exist only for t <= 84, and
        # (PITCH_MIN, -1) is excluded (matches the legacy candidate set)
        valid1[k] = (f == 0 or t <= 84) and not (t == PITCH_MIN and f == -1)
    return t_flat, f_flat, idx, valid1


_CAND_T, _CAND_F, _CAND_IDX, _CAND_VALID1 = _build_cand_grid()


def _ac_candidates_all(exc, off):
    """All-candidate AC grid via phase-upsampled history (decode_ac_vector's
    interpolation precomputed at all 3 fractional phases over the last
    PITCH_MAX excitation samples).  One constant-index gather builds the
    [B, C, 40] grid for the static (lag, fraction) set; the chosen
    candidate is still materialized exactly by the shadow decoder.

    exc [B, EXC_LEN] int32 -> acv [B, C, 40] float32.
    """
    base = G.EXC_OFF + off
    histf = jax.lax.dynamic_slice_in_dim(
        exc, base - _HIST_SPAN, _HIST_SPAN, axis=1).astype(jnp.float32)
    taps = histf[:, jnp.asarray(_UWIN)]                    # [B,144,20]
    coef = jnp.concatenate([jnp.asarray(_C1_NP), jnp.asarray(_C2_NP)],
                           axis=1)                         # [3,20]
    U = _ein("bjk,fk->bfj", taps, coef) / 16384.0    # [B,3,144]
    B = exc.shape[0]
    Uf = U.reshape(B, 3 * _UPS_LEN)
    return Uf[:, jnp.asarray(_CAND_IDX)]                   # [B,C,40]


_TRK0 = np.arange(0, SUBFRAME, 5)
_TRK1, _TRK2 = _TRK0 + 1, _TRK0 + 2
_TRK3 = np.concatenate([_TRK0 + 3, _TRK0 + 4])


def _fc_search(r, h2):
    """Exhaustive joint ACELP search. r,h2 [B,40] -> (fc_idx, signs) [B]."""
    H2 = _toeplitz(h2)
    d = _ein("bmk,bm->bk", H2, r)
    phi = _ein("bmk,bml->bkl", H2, H2)
    sgn = jnp.where(d >= 0, 1.0, -1.0)
    dabs = jnp.abs(d)
    phi_s = phi * sgn[:, :, None] * sgn[:, None, :]

    def dg(P):   # diagonal entries at positions P
        return phi_s[:, jnp.asarray(P), jnp.asarray(P)]

    def cr(Pa, Pb):
        return phi_s[:, jnp.asarray(Pa)[:, None], jnp.asarray(Pb)[None, :]]

    num = (dabs[:, _TRK0][:, :, None, None, None]
           + dabs[:, _TRK1][:, None, :, None, None]
           + dabs[:, _TRK2][:, None, None, :, None]
           + dabs[:, _TRK3][:, None, None, None, :])
    den = (dg(_TRK0)[:, :, None, None, None]
           + dg(_TRK1)[:, None, :, None, None]
           + dg(_TRK2)[:, None, None, :, None]
           + dg(_TRK3)[:, None, None, None, :]
           + 2.0 * (cr(_TRK0, _TRK1)[:, :, :, None, None]
                    + cr(_TRK0, _TRK2)[:, :, None, :, None]
                    + cr(_TRK0, _TRK3)[:, :, None, None, :]
                    + cr(_TRK1, _TRK2)[:, None, :, :, None]
                    + cr(_TRK1, _TRK3)[:, None, :, None, :]
                    + cr(_TRK2, _TRK3)[:, None, None, :, :]))
    score = (num * num) / jnp.maximum(den, 1e-9)
    B = r.shape[0]
    flat = score.reshape(B, -1)
    kf = jnp.argmax(flat, axis=1)
    k3 = kf % 16
    k2 = (kf // 16) % 8
    k1 = (kf // 128) % 8
    k0 = kf // 1024
    rows = jnp.arange(B)
    jbit = k3 // 8
    row3 = k3 % 8
    fc_idx = k0 | (k1 << 3) | (k2 << 6) | (row3 << 10) | (jbit << 9)
    pos = [jnp.asarray(_TRK0)[k0], jnp.asarray(_TRK1)[k1],
           jnp.asarray(_TRK2)[k2], jnp.asarray(_TRK3)[k3]]
    signs = jnp.zeros(B, jnp.int32)
    for t, p in enumerate(pos):
        bit = (sgn[rows, p] > 0).astype(jnp.int32)
        signs = signs | (bit << t)
    return fc_idx.astype(jnp.int32), signs


_GP128_NP = np.array([int(T.CB_GA[c // 16][0]) + int(T.CB_GB[c % 16][0])
                      for c in range(128)], np.int32)
_CB1SUM_NP = np.array([int(T.CB_GA[c // 16][1]) + int(T.CB_GB[c % 16][1])
                       for c in range(128)], np.int32)
def _gain_search(st, fc, y_ac, y_fc, target):
    """Exhaustive GA x GB with the decoder's exact gc arithmetic.

    Returns (ga, gb) [B] int32.  Does not mutate st.
    """
    energy = jnp.sum(fc * fc, axis=1)
    e = G._mul_sh15(G.l_log2_j(jnp.maximum(energy, 1)), -24660)
    e = e + ((R.l_log2(SUBFRAME) * 24660) >> 15) + 0xD8888 - 2
    e = e << 10
    e = e + jnp.sum(st["pred_energ_q"] * G._MA_COEFF[None, :], axis=1)
    e = (5439 * (e >> 15)) >> 8
    expn = e >> 15
    emant = G.l_pow2_j(e & 0x7FFF) & 0x7FFF
    cb1 = jnp.asarray(_CB1SUM_NP)                       # [128]
    prod = emant[:, None] * (cb1[None, :] >> 1)         # [B,128]
    pos = (25 - expn) > 0
    sh_r = jnp.where(pos, 25 - expn, 0).astype(jnp.uint32)[:, None]
    sh_l = jnp.where(pos, 0, expn - 25).astype(jnp.uint32)[:, None]
    gc = G._i16(jnp.where(pos[:, None], prod >> sh_r, prod << sh_l))
    gp = jnp.asarray(_GP128_NP).astype(jnp.float32) / 16384.0   # [128]
    gcf = gc.astype(jnp.float32) / 16384.0                      # [B,128]
    # err(c) = |t|^2 - 2 gp (t.ya) - 2 gc (t.yf) + gp^2|ya|^2
    #          + 2 gp gc (ya.yf) + gc^2 |yf|^2
    t_ya = _ein("bn,bn->b", target, y_ac)
    t_yf = _ein("bn,bn->b", target, y_fc)
    ya2 = _ein("bn,bn->b", y_ac, y_ac)
    yf2 = _ein("bn,bn->b", y_fc, y_fc)
    yayf = _ein("bn,bn->b", y_ac, y_fc)
    err = (-2.0 * gp[None, :] * t_ya[:, None]
           - 2.0 * gcf * t_yf[:, None]
           + (gp * gp)[None, :] * ya2[:, None]
           + 2.0 * gp[None, :] * gcf * yayf[:, None]
           + gcf * gcf * yf2[:, None])
    c = jnp.argmin(err, axis=1)
    return (c // 16).astype(jnp.int32), (c % 16).astype(jnp.int32)


# ---------------------------------------------------------------------------
# frame encoder
# ---------------------------------------------------------------------------

def _parity_batch(P1):
    """P0 such that parity_check passes (the decoder's own check)."""
    ok0 = G.parity_check_j(P1, jnp.zeros_like(P1))
    return jnp.where(ok0 == 1, 0, 1).astype(jnp.int32)


@jax.jit
def encode_frame_batch(st, hist, samples):
    """One 80-sample frame for B streams.

    st: decoder-shadow state (g729a.init_state); hist [B,160] float scaled
    past input; samples [B,80] int-valued float.  Returns
    (st, hist, parm [B,16] int32) where parm uses the
    decode_frame_batch column layout (col 15 = 0).

    The closed-loop pitch search is exhaustive over the full static
    (lag, fraction) grid (_build_cand_grid), so no open-loop estimate —
    and no residual history state — is needed.
    """
    B = samples.shape[0]
    x = samples.astype(jnp.float32) * 0.5    # decoder upscales 2x on output

    # ---- LP analysis -------------------------------------------------------
    buf = jnp.concatenate([hist, x], axis=1)[:, -240:]
    wbuf = buf * jnp.asarray(_WLP, jnp.float32)[None, :]
    r = jnp.stack([_ein("bn,bn->b", wbuf[:, :240 - k], wbuf[:, k:])
                   for k in range(11)], axis=1)
    r = r.at[:, 0].set(jnp.maximum(r[:, 0] * 1.0001 + 10.0, 1e-3))
    r = r * jnp.asarray(_LAG_WINDOW, jnp.float32)[None, :]
    a = _levinson_batch(r)
    lsf = _lp_to_lsf_batch(a)

    L0, L1, L2, L3 = _quantize_lsf_batch(st, lsf)
    lsf_q = G.lsf_decode(st, L0, L1, L2, L3)
    lsp = G.lsf2lsp(lsf_q)
    lp1, lp2 = G.lp_decode(st, lsp)

    cand_t = jnp.asarray(_CAND_T.astype(np.int32))
    cand_f = jnp.asarray(_CAND_F.astype(np.int32))

    parm_cols = {}
    prev_int = None
    for i in range(2):
        lp_i = lp1 if i == 0 else lp2
        xs = jax.lax.dynamic_slice_in_dim(x, i * SUBFRAME, SUBFRAME, axis=1)
        h = _impulse_response(lp_i)
        Hmat = _toeplitz(h)
        target = xs - _zir(lp_i, st["syn_filter_data"])

        # ---- closed-loop pitch at 1/3 resolution, exhaustive grid ----------
        if i == 0:
            valid = jnp.asarray(_CAND_VALID1)[None, :]     # [1,C]
        else:
            # 5-bit relative window around subframe 1's integer lag
            # (all three fractions are encodable anywhere in the window)
            base = jnp.clip(prev_int - 5, PITCH_MIN, PITCH_MAX - 9)
            valid = (cand_t[None, :] >= base[:, None]) & \
                    (cand_t[None, :] <= base[:, None] + 9)
        acv = _ac_candidates_all(st["exc"], i * SUBFRAME)
        y = _ein("bnk,bck->bcn", Hmat, acv)
        e = _ein("bcn,bcn->bc", y, y)
        c = jnp.maximum(_ein("bcn,bn->bc", y, target), 0.0)
        score = jnp.where(valid & (e > 0), c * c / jnp.maximum(e, 1e-9), -1.0)
        kbest = jnp.argmax(score, axis=1)
        t_int = jnp.take(cand_t, kbest)
        t_frac = jnp.take(cand_f, kbest)

        if i == 0:
            P1 = jnp.where(t_int <= 84, 3 * t_int + t_frac - 58, t_int + 112)
            parm_cols["ac0"] = P1
            parm_cols["parity"] = _parity_batch(P1)
            prev_int = t_int
        else:
            base = jnp.clip(prev_int - 5, PITCH_MIN, PITCH_MAX - 9)
            parm_cols["ac1"] = 3 * (t_int - base) + t_frac + 2

        # ---- exact AC vector via the shadow decoder ------------------------
        st["exc"] = G.decode_ac_vector(st["exc"], t_int, t_frac,
                                       i * SUBFRAME)
        acv_x = jax.lax.dynamic_slice_in_dim(
            st["exc"], G.EXC_OFF + i * SUBFRAME, SUBFRAME,
            axis=1).astype(jnp.float32)
        y_ac = _ein("bnk,bk->bn", Hmat, acv_x)
        e_ac = _ein("bn,bn->b", y_ac, y_ac)
        gp_f = jnp.clip(_ein("bn,bn->b", y_ac, target)
                        / jnp.maximum(e_ac, 1e-9), 0.0, 1.2)

        # ---- fixed codebook -------------------------------------------------
        rres = target - gp_f[:, None] * y_ac
        # pitch sharpening h2[n] = h[n] + gp_sh * h2[n - t]: the source
        # index n - t < PITCH_MIN <= t is never itself sharpened, so the
        # recurrence collapses to a single shifted add — expressed as a
        # compare-mask matmul instead of 40 per-lane dynamic gathers
        gp_sh = st["pitch_sharp"].astype(jnp.float32) / 16384.0
        nk = jnp.asarray(np.arange(SUBFRAME)[:, None]
                         - np.arange(SUBFRAME)[None, :])   # [n,k] = n - k
        smat = (nk[None] == t_int[:, None, None]).astype(jnp.float32)
        h2 = h + gp_sh[:, None] * _ein("bnk,bk->bn", smat, h)
        fc_idx, signs = _fc_search(rres, h2)
        parm_cols[f"fc{i}"] = fc_idx
        parm_cols[f"ps{i}"] = signs

        fc, _err = G.decode_fc_vector(fc_idx, signs)
        fc = G.fix_fc_vector(fc, t_int, st["pitch_sharp"])
        y_fc = _ein("bnk,bk->bn", Hmat, fc.astype(jnp.float32))

        # ---- gains -----------------------------------------------------------
        ga, gb = _gain_search(st, fc, y_ac, y_fc, target)
        parm_cols[f"ga{i}"] = ga
        parm_cols[f"gb{i}"] = gb

        gc = G.get_gain_code(st, ga, gb, fc)   # mutates pred_energ_q
        gp = jnp.take(G._CB_GA[:, 0], ga) + jnp.take(G._CB_GB[:, 0], gb)
        st["gain_pitch"] = gp
        st["gain_code"] = gc
        st["pitch_sharp"] = G._clip(gp, G.SHARP_MIN, G.SHARP_MAX)
        st["exc"] = G.mem_update(st["exc"], fc, gp, gc, i * SUBFRAME)

        exc_sub = jax.lax.dynamic_slice_in_dim(
            st["exc"], G.EXC_OFF + i * SUBFRAME, SUBFRAME, axis=1)
        out1, fd1, ovf = G.lp_synthesis_filter(
            lp_i, exc_sub, st["syn_filter_data"], False)

        # rare overflow rescale-and-redo under a scalar lax.cond: the
        # common case pays one synthesis scan per subframe, not two
        # (same trick as the decoder; shadow state stays bit-exact)
        def _redo(_):
            exc_scaled = jnp.where(ovf[:, None], st["exc"] >> 2, st["exc"])
            exc_sub2 = jax.lax.dynamic_slice_in_dim(
                exc_scaled, G.EXC_OFF + i * SUBFRAME, SUBFRAME, axis=1)
            out2, fd2, _ = G.lp_synthesis_filter(
                lp_i, exc_sub2, st["syn_filter_data"], True)
            return exc_scaled, jnp.where(ovf[:, None], fd2, fd1)

        def _keep(_):
            return st["exc"], fd1

        st["exc"], st["syn_filter_data"] = jax.lax.cond(
            jnp.any(ovf), _redo, _keep, None)
        st["pitch_prev"] = t_int

    st["exc"] = jax.lax.dynamic_update_slice_in_dim(
        st["exc"],
        jax.lax.dynamic_slice_in_dim(st["exc"], 2 * SUBFRAME,
                                     PITCH_MAX + R.INTERPOL_LEN, axis=1),
        0, axis=1)

    hist = jnp.concatenate([hist, x], axis=1)[:, -160:]
    parm = jnp.stack([
        L0, L1, L2, L3, parm_cols["parity"], parm_cols["ac0"],
        parm_cols["ac1"], parm_cols["fc0"], parm_cols["fc1"],
        parm_cols["ps0"], parm_cols["ps1"], parm_cols["ga0"],
        parm_cols["ga1"], parm_cols["gb0"], parm_cols["gb1"],
        jnp.zeros(B, jnp.int32)], axis=1)
    return st, hist, parm


@jax.jit
def encode_frames_scan(st, hist, frames):
    """Encode T frames in ONE dispatch: frames float32 [T, B, 80] ->
    (st, hist, parms int32 [T, B, 16]).

    A lax.scan of the frame step: one dispatch per T frames instead of
    one per frame, like g729a.decode_streams on the decode side."""
    def body(carry, xs):
        stc, hc = carry
        stc, hc, parm = encode_frame_batch(stc, hc, xs)
        return (stc, hc), parm
    (st, hist), parms = jax.lax.scan(body, (st, hist), frames)
    return st, hist, parms


def encode_streams_tpu(pcm: np.ndarray, chunk: int = 16) -> np.ndarray:
    """PCM int16 [B, n_frames*80] -> packed frames uint8 [n_frames, B, 10].

    Frames run through encode_frames_scan in fixed-size chunks (one
    dispatch + one jit signature per chunk size, remainder per-frame)."""
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 1:
        pcm = pcm[None]
    B = pcm.shape[0]
    n_frames = pcm.shape[1] // FRAME
    st = G.init_state(B)
    hist = jnp.zeros((B, 160))
    parms = []
    f = 0
    while f + chunk <= n_frames:
        xs = jnp.asarray(
            pcm[:, f * FRAME:(f + chunk) * FRAME]
            .reshape(B, chunk, FRAME).transpose(1, 0, 2))
        st, hist, pchunk = encode_frames_scan(st, hist, xs)
        parms.extend(pchunk[t] for t in range(chunk))
        f += chunk
    for f in range(f, n_frames):
        xs = jnp.asarray(pcm[:, f * FRAME:(f + 1) * FRAME])
        st, hist, parm = encode_frame_batch(st, hist, xs)
        parms.append(parm)   # stays on device: dispatches pipeline async
    from .g729a_encoder import pack_parameters_batch
    pn = np.asarray(jnp.stack(parms))         # [n_frames, B, 16]
    return pack_parameters_batch(pn)
