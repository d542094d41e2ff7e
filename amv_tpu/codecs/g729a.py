"""Batched device G.729 Annex A decoder (JAX, bit-exact fixed point).

The G.729 recurrence structure is stream-sequential (every frame updates
LSF/gain/excitation memories), so the device's axis of parallelism is the
*stream batch*: B independent speech streams decode in lockstep, one
`lax.scan` step per frame.  All per-sample recurrences (LP synthesis,
adaptive-codebook interpolation with short lags, AGC, high-pass) are inner
`lax.scan`/`fori_loop`s over <=160 steps on [B]-wide vectors; everything
else (codebook gathers, correlations, FIR residual, tilt application) is
fully parallel elementwise work.

Semantics follow amv_tpu.verify.ref_g729 (itself differentially validated
bit-exact against the compiled reference decoder, G.729/g729a_native.c);
every integer wrap/clip is reproduced.  int32 two's-complement wraparound
is XLA's native behavior.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import g729_tables as T
from ..verify import ref_g729 as R

SUBFRAME = R.SUBFRAME
PITCH_MIN, PITCH_MAX = R.PITCH_MIN, R.PITCH_MAX
INTERPOL_LEN = R.INTERPOL_LEN
SHARP_MIN, SHARP_MAX = R.SHARP_MIN, R.SHARP_MAX
GAMMA_N, GAMMA_D, GAMMA_T, GAMMA_P = R.GAMMA_N, R.GAMMA_D, R.GAMMA_T, R.GAMMA_P

EXC_LEN = 2 * 44 + PITCH_MAX + 2 * INTERPOL_LEN  # incl. zero OOB tail
EXC_OFF = PITCH_MAX + INTERPOL_LEN
RES_LEN = 44 + PITCH_MAX

_CB_L1 = jnp.asarray(T.CB_L1)
_CB_L2_L3 = jnp.asarray(T.CB_L2_L3)
_CB_GA = jnp.asarray(T.CB_GA)
_CB_GB = jnp.asarray(T.CB_GB)
_MA_PRED = jnp.asarray(T.MA_PREDICTOR)          # [2,4,10]
_MA_SUM = jnp.asarray(T.MA_PREDICTOR_SUM)       # [2,10]
_MA_SUM_INV = jnp.asarray(T.MA_PREDICTOR_SUM_INV)
_MA_COEFF = jnp.asarray(T.MA_PREDICTION_COEFF)  # [4]
_BASE_COS = jnp.asarray(T.BASE_COS)
_SLOPE_COS = jnp.asarray(T.SLOPE_COS)
_TAB_POW2 = jnp.asarray(T.TAB_POW2)
_TAB_LOG2 = jnp.asarray(T.TAB_LOG2)
_TAB_INV_SQRT = jnp.asarray(T.TAB_INV_SQRT)
_INTERP_FLAT = jnp.asarray(T.INTERP_FILTER.reshape(-1))

# magic parity table (3.7.2)
_PARITY_LO = 0x96696996
_PARITY_HI = 0x69969669


def _i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _clip(x, lo, hi):
    return jnp.clip(x, lo, hi)


def _mul_sh15(a, b):
    """Exact (int64(a)*b)>>15 truncated to int32, using int32 ops only.

    Valid for |b| <= 32767: split a = hi*2^16 + lo (lo in [0,65535]);
    (a*b)>>15 = hi*b*2 + (lo*b >> 15), exact mod 2^32 (matches the C
    int cast of the 64-bit product shift)."""
    hi = a >> 16
    lo = a & 0xFFFF
    return hi * b * 2 + ((lo * b) >> 15)


def _masked_gather(x, idx, axis_size):
    """x [B, L] gathered at per-row idx [B, K] -> [B, K]; an index
    outside [0, axis_size) reads 0."""
    valid = (idx >= 0) & (idx < axis_size)
    got = jnp.take_along_axis(x, jnp.where(valid, idx, 0), axis=1)
    return jnp.where(valid, got, 0)


def av_log2_j(v):
    """floor(log2(v)) for v>0 (int32), exact."""
    v = v.astype(jnp.uint32)
    r = jnp.zeros(v.shape, jnp.int32)
    for s in (16, 8, 4, 2, 1):
        m = v >= (jnp.uint32(1) << s)
        r = r + jnp.where(m, s, 0)
        v = jnp.where(m, v >> s, v)
    return r


def l_log2_j(value):
    power_int = av_log2_j(value)
    result = (value.astype(jnp.uint32) << (31 - power_int).astype(jnp.uint32))
    frac_x0 = ((result & 0x7C000000) >> 26).astype(jnp.int32)
    frac_dx = ((result & 0x03FFF800) >> 11).astype(jnp.int32)
    r = jnp.take(_TAB_LOG2, frac_x0) << 15
    r += frac_dx * (jnp.take(_TAB_LOG2, frac_x0 + 1) - jnp.take(_TAB_LOG2, frac_x0))
    return (power_int << 15) + (r >> 15)


def l_pow2_j(power):
    frac_x0 = (power & 0x7C00) >> 10
    frac_dx = (power & 0x03FF) << 5
    result = jnp.take(_TAB_POW2, frac_x0) << 15
    result += frac_dx * (jnp.take(_TAB_POW2, frac_x0 + 1) - jnp.take(_TAB_POW2, frac_x0))
    return (result + 16384) >> 15


def l_inv_sqrt_j(arg):
    power_int = (av_log2_j(arg) >> 1) + 1
    result = (arg.astype(jnp.uint32) << (32 - (power_int << 1)).astype(jnp.uint32))
    frac_x0 = ((result >> 26)).astype(jnp.int32) - 16
    frac_dx = ((result >> 11) & 0x7FE0).astype(jnp.int32)
    r = jnp.take(_TAB_INV_SQRT, frac_x0) << 15
    r += frac_dx * (jnp.take(_TAB_INV_SQRT, frac_x0 + 1) - jnp.take(_TAB_INV_SQRT, frac_x0))
    return (r.astype(jnp.uint32) >> power_int.astype(jnp.uint32)).astype(jnp.int32)


def l_div_j(num, denom, base):
    """Vectorized l_div with the x86 shift-count masking for diff<0."""
    zero = num == 0
    sig = jnp.logical_xor(num < 0, denom < 0)
    num_a = jnp.abs(num)
    den_a = jnp.abs(denom)
    diff = 26 - av_log2_j(jnp.maximum(num_a, 1))
    num_s = (num_a << (jnp.minimum(base, diff) & 31).astype(jnp.uint32))
    den_s = (den_a >> ((jnp.maximum(base, diff) - diff) & 31).astype(jnp.uint32))
    den_s = jnp.maximum(den_s, 1)  # upstream guarantees nonzero
    q = num_s // den_s
    q = jnp.where(sig, -q, q)
    return jnp.where(zero, 0, q)


def g729_round_j(v):
    return jnp.where(v > (0x7FFFFFFF - 0x8000), 32767, (v + 0x8000) >> 16)


def parity_check_j(P1, P0):
    idx = P1 >> 2
    word = jnp.where(idx >= 32, jnp.uint32(_PARITY_HI), jnp.uint32(_PARITY_LO))
    bit = ((word >> (idx & 31).astype(jnp.uint32)) & 1).astype(jnp.int32)
    return (bit ^ P0) & 1


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def init_state(batch: int):
    B = batch
    z = lambda *s: jnp.zeros((B,) + s, jnp.int32)
    return dict(
        exc=z(EXC_LEN),
        pitch_prev=z(),
        lq_prev=jnp.broadcast_to(jnp.asarray(T.LQ_INIT)[None, None, :],
                                 (B, 4, 10)).astype(jnp.int32),
        lsp_prev=jnp.broadcast_to(jnp.asarray(T.LSP_INIT)[None, :],
                                  (B, 10)).astype(jnp.int32),
        lsf_prev=z(10),
        pred_energ_q=jnp.full((B, 4), -14336, jnp.int32),
        gain_pitch=z(),
        gain_code=z(),
        pitch_sharp=jnp.full((B,), SHARP_MIN, jnp.int32),
        residual=z(RES_LEN),
        syn_filter_data=z(10),
        res_filter_data=z(10),
        pos_filter_data=z(10),
        ht_prev_data=z(),
        gain_coeff=jnp.full((B,), 4096, jnp.int32),
        rand_value=jnp.full((B,), 21845, jnp.int32),
        prev_mode=z(),
        hpf_f=z(2),
        hpf_z=z(2),
    )


# ---------------------------------------------------------------------------
# LSF / LSP / LP
# ---------------------------------------------------------------------------

def _lq_rotate(st, lq):
    st["lq_prev"] = jnp.concatenate([lq[:, None, :], st["lq_prev"][:, :3, :]],
                                    axis=1)


def lsf_restore_from_previous(st):
    lsfq = st["lsf_prev"]
    mp = jnp.take(_MA_PRED, st["prev_mode"], axis=0)        # [B,4,10]
    mpinv = jnp.take(_MA_SUM_INV, st["prev_mode"], axis=0)  # [B,10]
    v = (lsfq << 15) - jnp.sum(st["lq_prev"] * mp, axis=1)
    lq = ((v >> 15) * mpinv) >> 12
    _lq_rotate(st, lq)
    return lsfq


def lsf_decode(st, L0, L1, L2, L3):
    c1 = jnp.take(_CB_L1, L1, axis=0)       # [B,10]
    c23 = jnp.take(_CB_L2_L3, L2, axis=0)
    c23h = jnp.take(_CB_L2_L3, L3, axis=0)
    lq = jnp.concatenate([c1[:, :5] + c23[:, :5], c1[:, 5:] + c23h[:, 5:]],
                         axis=1)
    for J in (10, 5):
        cols = [lq[:, i] for i in range(10)]
        for i in range(1, 10):
            diff = (cols[i - 1] - cols[i] + J) >> 1
            pos = diff > 0
            cols[i - 1] = jnp.where(pos, cols[i - 1] - diff, cols[i - 1])
            cols[i] = jnp.where(pos, cols[i] + diff, cols[i])
        lq = jnp.stack(cols, axis=1)
    mp = jnp.take(_MA_PRED, L0, axis=0)   # [B,4,10]
    msum = jnp.take(_MA_SUM, L0, axis=0)  # [B,10]
    s = lq * msum + jnp.sum(st["lq_prev"] * mp, axis=1)
    lsfq = _i16(s >> 15)
    st["lsf_prev"] = lsfq
    _lq_rotate(st, lq)
    st["prev_mode"] = L0
    # bubble sort: fixed compare-exchange network matching the C loop order
    cols = [lsfq[:, i] for i in range(10)]
    for j in range(9, 0, -1):
        for i in range(j):
            a, b = cols[i], cols[i + 1]
            swap = a > b
            cols[i] = jnp.where(swap, b, a)
            cols[i + 1] = jnp.where(swap, a, b)
    cols[0] = jnp.maximum(cols[0], R.LSFQ_MIN)
    for i in range(9):
        cols[i + 1] = jnp.maximum(cols[i + 1], cols[i] + R.LSFQ_DIFF_MIN)
    cols[9] = jnp.minimum(cols[9], R.LSFQ_MAX)
    return jnp.stack(cols, axis=1)


def lsf2lsp(lsf):
    freq = _i16((lsf * 20861) >> 15)
    offset = freq & 0xFF
    ind = freq >> 8
    return _i16(jnp.take(_BASE_COS, ind) +
                ((jnp.take(_SLOPE_COS, ind) * offset) >> 12))


def _lsp_poly(lsp_sub):
    """lsp_sub: list of 5 [B] arrays -> list of 6 [B] Q24 arrays."""
    B = lsp_sub[0].shape
    f = [None] * 6
    f[0] = jnp.full(B, 1 << 24, jnp.int32)
    f[1] = -lsp_sub[0] << 10
    for i in range(2, 6):
        f[i] = f[i - 2]
        for j in range(i, 1, -1):
            f[j] = f[j] - (_mul_sh15(f[j - 1] >> 1, lsp_sub[i - 1]) << 2) \
                + f[j - 2]
        f[1] = f[1] - (lsp_sub[i - 1] << 10)
    return f


def lsp2lp(lsp_cols):
    """lsp_cols: list of 10 [B] arrays -> [B,10] Q12 LP."""
    f1 = _lsp_poly(lsp_cols[0::2])
    f2 = _lsp_poly(lsp_cols[1::2])
    lp = [None] * 10
    for i in range(5):
        ff1 = f1[i + 1] + f1[i] + (1 << 12)
        ff2 = f2[i + 1] - f2[i]
        lp[i] = _i16((ff1 + ff2) >> 13)
        lp[9 - i] = _i16((ff1 - ff2) >> 13)
    return jnp.stack(lp, axis=1)


def lp_decode(st, lsp_2nd):
    lsp1_cols = [(lsp_2nd[:, i] >> 1) + (st["lsp_prev"][:, i] >> 1)
                 for i in range(10)]
    lp1 = lsp2lp(lsp1_cols)
    lp2 = lsp2lp([lsp_2nd[:, i] for i in range(10)])
    st["lsp_prev"] = lsp_2nd
    return lp1, lp2


# ---------------------------------------------------------------------------
# codebooks / excitation
# ---------------------------------------------------------------------------

def decode_ac_vector(exc, pitch_delay_int, pitch_delay_frac, off):
    """exc [B,EXC_LEN]; per-stream pitch; writes SUBFRAME samples at
    EXC_OFF+off. Returns updated exc.

    One fused take_along_axis per sample (the 20 interpolation taps load
    as a single [B,20] gather; the per-term clip chain then runs on
    registers) — 20x fewer gather ops than the naive form."""
    frac = -pitch_delay_frac
    neg = frac < 0
    frac = jnp.where(neg, frac + 3, frac)
    pd = jnp.where(neg, pitch_delay_int + 1, pitch_delay_int)
    base = EXC_OFF + off

    # tap coefficient pairs for this stream's frac: c1[i], c2[i] [B,10]
    i_idx = jnp.arange(10)
    c1 = jnp.take(_INTERP_FLAT, 3 * i_idx[None, :] + frac[:, None])
    c2 = jnp.take(_INTERP_FLAT, 3 * i_idx[None, :] + 3 - frac[:, None])
    # relative offsets of the 20 taps from position n: -pd-i and -pd+i+1
    rel1 = -pd[:, None] - i_idx[None, :]           # [B,10]
    rel2 = -pd[:, None] + i_idx[None, :] + 1       # [B,10]
    rel = jnp.concatenate([rel1, rel2], axis=1)    # [B,20]
    coef = jnp.concatenate([c1, c2], axis=1)       # [B,20]

    def body(n, exc):
        taps = _masked_gather(exc, base + n + rel, EXC_LEN)      # [B,20]
        terms = taps * coef
        v = jnp.zeros(exc.shape[0], jnp.int32)
        # C accumulation order: (t1[0], t2[0], t1[1], t2[1], ...) with a
        # clip after every addition (g729_decode_ac_vector:822-829)
        for i in range(10):
            v = _clip(v + terms[:, i], -(1 << 30), (1 << 30) - 1)
            v = _clip(v + terms[:, 10 + i], -(1 << 30), (1 << 30) - 1)
        val = g729_round_j(v << 1)
        return exc.at[:, base + n].set(val)

    return jax.lax.fori_loop(0, SUBFRAME, body, exc)


def decode_fc_vector(fc_index, pulses_signs):
    """[B] indexes -> fc [B,40] Q13 (+ data_error flag)."""
    B = fc_index.shape[0]
    fc = jnp.zeros((B, SUBFRAME), jnp.int32)
    err = jnp.zeros((B,), jnp.int32)
    rows = jnp.arange(B)
    fi, ps = fc_index, pulses_signs
    for i in range(3):
        index = (fi & 7) * 5 + i
        val = jnp.where(ps & 1, 8191, -8192)
        fc = fc.at[rows, jnp.minimum(index, SUBFRAME - 1)].set(
            jnp.where(index < SUBFRAME, val, fc[rows, jnp.minimum(index, SUBFRAME - 1)]))
        err = err | (index >= SUBFRAME)
        fi >>= 3
        ps >>= 1
    index = ((fi >> 1) & 7) * 5 + 3 + (fi & 1)
    val = jnp.where(ps & 1, 8191, -8192)
    fc = fc.at[rows, jnp.minimum(index, SUBFRAME - 1)].set(
        jnp.where(index < SUBFRAME, val, fc[rows, jnp.minimum(index, SUBFRAME - 1)]))
    err = err | (index >= SUBFRAME)
    return fc, err


def fix_fc_vector(fc, pitch_delay, gain_pitch):
    """fc[i] += (fc[i-pd]*gp)>>14 for i>=pd, sequential in i (3.8/4.1.4)."""
    def body(i, fc):
        src_idx = jnp.maximum(i - pitch_delay, 0)
        src = _masked_gather(fc, src_idx[:, None], SUBFRAME)[:, 0]
        new = _i16(fc[:, i] + ((src * gain_pitch) >> 14))
        return fc.at[:, i].set(jnp.where(i >= pitch_delay, new, fc[:, i]))
    return jax.lax.fori_loop(0, SUBFRAME, body, fc)


def get_gain_code(st, ga, gb, fc):
    energy = jnp.sum(fc * fc, axis=1)  # fits int32 for valid fc
    energy = _mul_sh15(l_log2_j(jnp.maximum(energy, 1)), -24660)
    energy += (R.l_log2(SUBFRAME) * 24660) >> 15
    energy += 0xD8888
    energy -= 2
    energy <<= 10
    energy += jnp.sum(st["pred_energ_q"] * _MA_COEFF[None, :], axis=1)
    energy = (5439 * (energy >> 15)) >> 8
    expn = energy >> 15
    energy = l_pow2_j(energy & 0x7FFF) & 0x7FFF
    st["pred_energ_q"] = jnp.concatenate(
        [jnp.zeros((energy.shape[0], 1), jnp.int32), st["pred_energ_q"][:, :3]],
        axis=1)
    cb1_sum = jnp.take(_CB_GA[:, 1], ga) + jnp.take(_CB_GB[:, 1], gb)
    pe0 = _i16((24660 * ((l_log2_j(cb1_sum) >> 2) - (13 << 13))) >> 15)
    st["pred_energ_q"] = st["pred_energ_q"].at[:, 0].set(pe0)
    energy = energy * (cb1_sum >> 1)
    pos = 25 - expn > 0
    sh_r = jnp.where(pos, 25 - expn, 0).astype(jnp.uint32)
    sh_l = jnp.where(pos, 0, expn - 25).astype(jnp.uint32)
    energy = jnp.where(pos, energy >> sh_r, energy << sh_l)
    return _i16(energy)


def mem_update(exc, fc, gp, gc, off):
    seg = jax.lax.dynamic_slice_in_dim(exc, EXC_OFF + off, SUBFRAME, axis=1)
    s = seg * gp[:, None] + fc * gc[:, None]
    s = _clip(s, -32768 << 14, 32767 << 14)
    return jax.lax.dynamic_update_slice_in_dim(
        exc, g729_round_j(s << 2), EXC_OFF + off, axis=1)


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

def lp_synthesis_filter(lp, inp, filter_data, clip_output):
    """lp [B,10], inp [B,40], filter_data [B,10] (prev 10 outputs, oldest
    first).  Returns (out [B,40], new_filter_data, overflow [B] bool).
    When clip_output, overflowing samples are clipped (second pass)."""
    def step(carry, x_t):
        hist = carry  # [B,10], hist[:, -1] = most recent
        s = x_t << 12
        for i in range(10):
            s = s - lp[:, i] * hist[:, 9 - i]
        s = s >> 12
        ovf = (s > 32767) | (s < -32768)
        s_out = jnp.clip(s, -32768, 32767) if clip_output else s
        hist = jnp.concatenate([hist[:, 1:], s_out[:, None]], axis=1)
        return hist, (s_out, ovf)

    hist, (out, ovf) = jax.lax.scan(step, filter_data, inp.T)
    out = out.T
    overflow = jnp.any(ovf, axis=0)
    return out, hist, overflow


def residual_fir(lp_gn, speech, pos_filter_data):
    """A(z/GAMMA_N) FIR (4.2.1 Eq.79): fully parallel."""
    ext = jnp.concatenate([pos_filter_data, speech], axis=1)  # [B,50]
    s = speech << 12
    for i in range(10):
        s = s + lp_gn[:, i:i + 1] * jax.lax.dynamic_slice_in_dim(
            ext, 10 - i - 1, SUBFRAME, axis=1)
    s = _clip(s, -32768 << 12, 32767 << 12)
    return g729_round_j(s << 4)


def long_term_filter(residual, intT1):
    res = residual
    B = res.shape[0]
    base = jnp.minimum(intT1, PITCH_MAX - 3)  # [B]
    n_idx = jnp.arange(SUBFRAME)[None, None, :]           # [1,1,40]
    k_off = jnp.arange(-3, 4)[None, :, None]              # [1,7,1]
    k = base[:, None, None] + k_off                       # [B,7,1]
    idx = PITCH_MAX - k + n_idx                           # [B,7,40]
    idx2 = idx.reshape(B, 7 * SUBFRAME)
    lagged = _masked_gather(res, idx2, res.shape[1]).reshape(B, 7, SUBFRAME)
    cur = (res[:, None, PITCH_MAX:PITCH_MAX + SUBFRAME] >> 1)
    corr = jnp.sum((lagged >> 1) * cur, axis=2)           # [B,7]
    best = jnp.argmax(corr, axis=1)                       # first max
    corr_max = jnp.take_along_axis(corr, best[:, None], axis=1)[:, 0]
    intT0 = (base + best - 3)
    idx_t0 = PITCH_MAX - intT0[:, None] + jnp.arange(SUBFRAME)[None, :]
    lag_t0 = _masked_gather(res, idx_t0, res.shape[1]) >> 1
    corr_t0 = jnp.sum(lag_t0 * lag_t0, axis=1)
    cur0 = res[:, PITCH_MAX:PITCH_MAX + SUBFRAME] >> 1
    corr_0 = jnp.sum(cur0 * cur0, axis=1)
    tmp = av_log2_j(jnp.maximum(jnp.maximum(corr_0, jnp.maximum(corr_t0, corr_max)), 1))
    sh = jnp.where(tmp > 14, tmp - 14, 0).astype(jnp.uint32)
    corr_t0 >>= sh
    corr_0 >>= sh
    corr_max >>= sh
    gl = jnp.where(corr_max * corr_max < (corr_0 * corr_t0) >> 1, 0,
                   jnp.where((corr_t0 == 0) | (corr_max > corr_t0), 32768,
                             l_div_j(corr_max, jnp.maximum(corr_t0, 1), 15)))
    gl = (gl * GAMMA_P) >> 15
    inv_glgp = jnp.where(gl < -32768, 0, l_div_j(
        jnp.full_like(gl, 32768), 32768 + gl, 15))
    glgp_inv_glgp = 32768 - inv_glgp
    out = _i16((res[:, PITCH_MAX:PITCH_MAX + SUBFRAME] * inv_glgp[:, None] +
                _masked_gather(res, idx_t0, res.shape[1]) * glgp_inv_glgp[:, None])
               >> 15)
    return out, intT0


_GAMMA_POWS_N = []
_GAMMA_POWS_D = []
_gp = GAMMA_N
for _ in range(10):
    _GAMMA_POWS_N.append(_gp)
    _gp = (_gp * GAMMA_N) >> 15
_gp = GAMMA_D
for _ in range(10):
    _GAMMA_POWS_D.append(_gp)
    _gp = (_gp * GAMMA_D) >> 15
_GAMMA_POWS_N = jnp.asarray(np.array(_GAMMA_POWS_N, np.int32))
_GAMMA_POWS_D = jnp.asarray(np.array(_GAMMA_POWS_D, np.int32))


def tilt_compensation(st, lp_gn, lp_gd, res_pst):
    B = res_pst.shape[0]
    # impulse response of A(z/gn)/A(z/gd): sequential over 22
    hist0 = jnp.zeros((B, 10), jnp.int32)
    hf_in = jnp.concatenate(
        [jnp.full((B, 1), 4096, jnp.int32), lp_gn,
         jnp.zeros((B, 11), jnp.int32)], axis=1)  # [B,22]

    def step(hist, x_t):
        s = x_t
        for i in range(10):
            s = s - ((lp_gd[:, i] * hist[:, 9 - i]) >> 12)
        s = _i16(s)
        hist = jnp.concatenate([hist[:, 1:], s[:, None]], axis=1)
        return hist, s

    _, hf = jax.lax.scan(step, hist0, hf_in.T)
    hf = hf.T  # [B,22]
    rh0 = jnp.sum(hf * hf, axis=1) >> 12
    rh1 = jnp.sum(hf[:, :-1] * hf[:, 1:], axis=1) >> 12
    rh1 = (rh1 * GAMMA_T) >> 15
    gt = jnp.where(rh1 > 0, -l_div_j(rh1, jnp.maximum(rh0, 1), 12), 0)
    prev = jnp.concatenate([st["ht_prev_data"][:, None], res_pst[:, :-1]], axis=1)
    st["ht_prev_data"] = res_pst[:, -1]
    return _i16(res_pst + ((gt[:, None] * prev) >> 12))


def adaptive_gain_control(st, gain_before, gain_after, speech):
    has_after = gain_after != 0
    gain = jnp.where(gain_before != 0,
                     l_inv_sqrt_j(jnp.maximum(
                         l_div_j(gain_after, jnp.maximum(gain_before, 1), 12), 1)) >> 11,
                     0)
    gain = jnp.where(gain_before != 0, gain, 0)

    def step(gp, x_t):
        gp = (29491 * gp + 3276 * gain) >> 15
        return gp, _i16((x_t * gp) >> 12)

    gp_final, out = jax.lax.scan(step, st["gain_coeff"], speech.T)
    out = out.T
    st["gain_coeff"] = jnp.where(has_after, gp_final, st["gain_coeff"])
    return jnp.where(has_after[:, None], out, speech)


def postfilter(st, lp, pitch_delay_int, speech):
    lp_gn = _i16((lp * _GAMMA_POWS_N[None, :]) >> 15)
    lp_gd = _i16((lp * _GAMMA_POWS_D[None, :]) >> 15)
    gain_before = jnp.sum((speech >> 4) * (speech >> 4), axis=1)
    res_new = residual_fir(lp_gn, speech, st["pos_filter_data"])
    st["pos_filter_data"] = speech[:, SUBFRAME - 10:]
    residual = jax.lax.dynamic_update_slice_in_dim(
        st["residual"], res_new, PITCH_MAX, axis=1)
    residual_filt, intT0 = long_term_filter(residual, pitch_delay_int)
    st["residual"] = jax.lax.dynamic_update_slice_in_dim(
        residual, jax.lax.dynamic_slice_in_dim(residual, SUBFRAME, PITCH_MAX, axis=1),
        0, axis=1)
    residual_filt = tilt_compensation(st, lp_gn, lp_gd, residual_filt)
    out, st["res_filter_data"], _ = lp_synthesis_filter(
        lp_gd, residual_filt, st["res_filter_data"], clip_output=True)
    gain_after = jnp.sum((out >> 4) * (out >> 4), axis=1)
    return adaptive_gain_control(st, gain_before, gain_after, out)


def high_pass_filter(st, speech):
    """speech [B,160] -> filtered; state carries f[2] (int32), z[2]."""
    def step(carry, x_t):
        f1, f2, z1, z2 = carry
        f0 = (_mul_sh15(f1, 15836) + _mul_sh15(f2, -7667)
              + 7699 * (x_t - 2 * z1 + z2))
        f0 = f0 << 2  # int32 wrap
        out = jnp.clip(f0 >> 14, -32768, 32767)
        return (f0, f1, x_t, z1), out

    carry0 = (st["hpf_f"][:, 0], st["hpf_f"][:, 1],
              st["hpf_z"][:, 0], st["hpf_z"][:, 1])
    (f1, f2, z1, z2), out = jax.lax.scan(step, carry0, speech.T)
    st["hpf_f"] = jnp.stack([f1, f2], axis=1)
    st["hpf_z"] = jnp.stack([z1, z2], axis=1)
    return out.T


# ---------------------------------------------------------------------------
# frame decode
# ---------------------------------------------------------------------------

PARM_FIELDS = ["ma_predictor", "quantizer_1st", "quantizer_2nd_lo",
               "quantizer_2nd_hi", "parity", "ac_index0", "ac_index1",
               "fc_index0", "fc_index1", "pulses_signs0", "pulses_signs1",
               "ga0", "ga1", "gb0", "gb1", "erasure"]


def unpack_frames(frames: np.ndarray) -> np.ndarray:
    """frames uint8 [T,B,10] -> parms int32 [T,B,16] (vectorized host)."""
    bits = np.unpackbits(frames, axis=-1).astype(np.int32)  # [T,B,80]

    def f(lo, n):
        v = np.zeros(bits.shape[:2], np.int32)
        for i in range(n):
            v = (v << 1) | bits[..., lo + i]
        return v

    # bit layout (g729a_native.c:1852-1868): L0@0:1 L1@1:7 L2@8:5 L3@13:5
    # P1@18:8 P0@26:1 C1@27:13 S1@40:4 GA1@44:3 GB1@47:4
    # P2@51:5 C2@56:13 S2@69:4 GA2@73:3 GB2@76:4
    out = np.stack([
        f(0, 1), f(1, 7), f(8, 5), f(13, 5), f(26, 1), f(18, 8), f(51, 5),
        f(27, 13), f(56, 13), f(40, 4), f(69, 4), f(44, 3), f(73, 3),
        f(47, 4), f(76, 4),
        (frames.sum(axis=-1) == 0).astype(np.int32),
    ], axis=-1)
    return out


@jax.jit
def decode_frame_batch(st, parm):
    """st: state dict; parm int32 [B,16] -> (st, pcm [B,160] int16)."""
    era = parm[:, 15] != 0
    ac0, ac1 = parm[:, 5], parm[:, 6]
    bad_pitch = parity_check_j(ac0, parm[:, 4]) == 0
    data_error = era

    # Both LSF paths mutate lq_prev/prev_mode: run them on copies and
    # select elementwise per stream.
    st_e = {k: v for k, v in st.items()}
    lsf_err = lsf_restore_from_previous(st_e)
    st_g = {k: v for k, v in st.items()}
    lsf_good = lsf_decode(st_g, parm[:, 0], parm[:, 1], parm[:, 2], parm[:, 3])
    sel = lambda a, b: jnp.where(era.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)
    lsf = sel(lsf_err, lsf_good)
    for k in ("lq_prev", "lsf_prev"):
        st[k] = sel(st_e[k], st_g[k])
    st["prev_mode"] = sel(st_e["prev_mode"], st_g["prev_mode"])

    lsp = lsf2lsp(lsf)
    lp1, lp2 = lp_decode(st, lsp)

    outs = []
    for i in range(2):
        lp = lp1 if i == 0 else lp2
        if i == 0:
            pd3x_good = jnp.where(ac0 >= 197, 3 * ac0 - 335, ac0 + 59)
            pd3x = jnp.where(bad_pitch | data_error,
                             3 * st["pitch_prev"] + 1, pd3x_good)
        else:
            pd3x_good = ac1 + 3 * _clip(st["pitch_prev"] - 5,
                                        PITCH_MIN, PITCH_MAX - 9) - 1
            pd3x = jnp.where(data_error, 3 * st["pitch_prev"] + 1, pd3x_good)
        pd_int = pd3x // 3
        st["exc"] = decode_ac_vector(st["exc"], pd_int, pd3x % 3 - 1,
                                     i * SUBFRAME)

        # erasure: pseudo-random fc parameters
        r1 = (31821 * st["rand_value"] + 13849) & 0xFFFF
        r2 = (31821 * r1 + 13849) & 0xFFFF
        st["rand_value"] = jnp.where(data_error, r2, st["rand_value"])
        fci = jnp.where(data_error, r1 & 0x1FFF, parm[:, 7 + i])
        psi = jnp.where(data_error, r2 & 0x000F, parm[:, 9 + i])

        fc, err = decode_fc_vector(fci, psi)
        data_error = data_error | (err != 0)
        fc = fix_fc_vector(fc, pd_int, st["pitch_sharp"])

        gp_err = jnp.minimum((29491 * st["gain_pitch"]) >> 15, 29491)
        gc_err = (8028 * st["gain_code"]) >> 13
        # erasure gain memory attenuation
        p = st["pred_energ_q"]
        avg = p[:, 3] + p[:, 2] + p[:, 1] + p[:, 0]
        pred_err = jnp.concatenate(
            [jnp.maximum((avg >> 2) - 4096, -14336)[:, None], p[:, :3]], axis=1)

        st_gain = {k: v for k, v in st.items()}
        gc_good = get_gain_code(st_gain, parm[:, 11 + i], parm[:, 13 + i], fc)
        gp_good = (jnp.take(_CB_GA[:, 0], parm[:, 11 + i]) +
                   jnp.take(_CB_GB[:, 0], parm[:, 13 + i]))

        de = data_error
        st["gain_pitch"] = jnp.where(de, gp_err, gp_good)
        st["gain_code"] = jnp.where(de, gc_err, gc_good)
        st["pred_energ_q"] = jnp.where(de[:, None], pred_err,
                                       st_gain["pred_energ_q"])

        st["pitch_sharp"] = _clip(st["gain_pitch"], SHARP_MIN, SHARP_MAX)
        st["exc"] = mem_update(st["exc"], fc, st["gain_pitch"],
                               st["gain_code"], i * SUBFRAME)

        exc_sub = jax.lax.dynamic_slice_in_dim(
            st["exc"], EXC_OFF + i * SUBFRAME, SUBFRAME, axis=1)
        out1, fd1, ovf = lp_synthesis_filter(lp, exc_sub,
                                             st["syn_filter_data"], False)

        # the rescale-and-redo pass (g729dec overflow handling) is rare:
        # run it under a scalar lax.cond so the common case pays one
        # 40-step synthesis scan per subframe, not two (bit-exact — the
        # redo branch reproduces the unconditional arithmetic verbatim)
        def _redo(_):
            exc_scaled = jnp.where(ovf[:, None], st["exc"] >> 2, st["exc"])
            exc_sub2 = jax.lax.dynamic_slice_in_dim(
                exc_scaled, EXC_OFF + i * SUBFRAME, SUBFRAME, axis=1)
            out2, fd2, _ = lp_synthesis_filter(lp, exc_sub2,
                                               st["syn_filter_data"], True)
            return (exc_scaled,
                    jnp.where(ovf[:, None], out2,
                              jnp.clip(out1, -32768, 32767)),
                    jnp.where(ovf[:, None], fd2, fd1))

        def _keep(_):
            return (st["exc"], jnp.clip(out1, -32768, 32767), fd1)

        st["exc"], speech, st["syn_filter_data"] = jax.lax.cond(
            jnp.any(ovf), _redo, _keep, None)

        speech = postfilter(st, lp, pd_int, speech)

        st["pitch_prev"] = jnp.where(
            data_error, jnp.minimum(st["pitch_prev"] + 1, PITCH_MAX), pd_int)
        outs.append(speech)

    st["exc"] = jax.lax.dynamic_update_slice_in_dim(
        st["exc"],
        jax.lax.dynamic_slice_in_dim(st["exc"], 2 * SUBFRAME,
                                     PITCH_MAX + INTERPOL_LEN, axis=1),
        0, axis=1)

    pcm = jnp.concatenate(outs, axis=1)
    pcm = high_pass_filter(st, pcm)
    return st, pcm.astype(jnp.int16)


DECODE_CHUNK = 8


@partial(jax.jit, static_argnames=())
def _decode_chain(st, parms_chunk):
    """Unrolled chain of DECODE_CHUNK frame steps in one program.

    The unrolled chunk path serves arbitrary-T streaming decode, where
    one scan signature per T would recompile; decode_frames_scan is the
    one-dispatch form for a known T."""
    outs = []
    for i in range(DECODE_CHUNK):
        st, pcm = decode_frame_batch(st, parms_chunk[i])
        outs.append(pcm)
    return st, jnp.stack(outs)


@jax.jit
def decode_frames_scan(st, parms):
    """lax.scan of the frame step: parms int32 [T, B, 16] ->
    (st, pcm int16 [T, B, 80]) in ONE dispatch.  Bit-identical to the
    unrolled chain (one dispatch, one big schedule)."""
    def body(stc, pf):
        stc, pcm = decode_frame_batch(stc, pf)
        return stc, pcm
    return jax.lax.scan(body, st, parms)


def decode_streams(frames: np.ndarray) -> np.ndarray:
    """frames uint8 [T, B, 10] -> PCM int16 [B, T*80].

    Decodes B independent G.729A streams in lockstep on the device.
    """
    T_, B = frames.shape[0], frames.shape[1]
    if T_ == 0:
        return np.zeros((B, 0), np.int16)
    parms = unpack_frames(frames)
    tp = (T_ + DECODE_CHUNK - 1) // DECODE_CHUNK * DECODE_CHUNK
    if tp != T_:
        # pad with erasure frames; their outputs (and the state they
        # mutate) are discarded
        pad = np.zeros((tp - T_, B, 16), np.int32)
        pad[..., 15] = 1
        parms = np.concatenate([parms, pad], axis=0)
    st = init_state(B)
    pcms = []
    for t0 in range(0, tp, DECODE_CHUNK):
        st, pcm = _decode_chain(st, jnp.asarray(parms[t0:t0 + DECODE_CHUNK]))
        pcms.append(pcm)
    pcm = jnp.concatenate(pcms, axis=0)[:T_]
    return np.asarray(pcm.transpose(1, 0, 2).reshape(B, T_ * 80))
