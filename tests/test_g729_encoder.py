"""G.729A encoder tests: valid bitstreams + reconstruction quality."""

import numpy as np
import pytest

from amv_tpu.codecs.g729a_encoder import G729Encoder, encode_stream
from amv_tpu.containers import act
from amv_tpu.verify.ref_g729 import G729Decoder, bytes2parm, parity_check


def _speechlike(n=4800, seed=7):
    rng = np.random.default_rng(seed)
    exc = rng.standard_normal(n) * 300
    pt = np.zeros(n)
    pt[::75] = 4000
    voiced = (np.sin(2 * np.pi * np.arange(n) / 3000) > 0)
    exc = np.where(voiced, exc * 0.3 + pt, exc)
    sig = exc.copy()
    for i in range(2, n):
        sig[i] = exc[i] + 1.5 * sig[i - 1] - 0.7 * sig[i - 2]
    return np.clip(sig * 0.5, -20000, 20000).astype(np.int16)


def test_bitstream_validity():
    sig = _speechlike(1600)
    frames = encode_stream(sig)
    assert len(frames) == 20
    for f in frames:
        assert len(f) == 10
        parm, erased = bytes2parm(f)
        assert not erased
        assert parity_check(parm["ac_index"][0], parm["parity"]) == 1
        # decoded pitch must be in the legal range
        P1 = parm["ac_index"][0]
        pd3x = 3 * P1 - 335 if P1 >= 197 else P1 + 59
        assert 20 <= pd3x // 3 <= 143


import functools


@functools.lru_cache(maxsize=1)
def _roundtrip_4800():
    """Shared (slow) encode+decode of the 4800-sample fixture."""
    sig = _speechlike(4800)
    frames = encode_stream(sig)
    dec = G729Decoder()
    out = np.concatenate([dec.decode_frame(f) for f in frames])
    return sig, out


def test_roundtrip_quality():
    sig, out = _roundtrip_4800()
    a = out[400:len(sig)].astype(float)
    b = sig[400:len(sig)].astype(float)
    c = np.corrcoef(a, b)[0, 1]
    # measured 0.902 on this fixture (round 2); gate with small headroom
    assert c > 0.88, f"roundtrip correlation too low: {c}"
    # scale preserved within 3 dB
    assert 0.5 < a.std() / b.std() < 1.5
    segs = []
    for s0 in range(0, len(a) - 160, 160):
        e = ((a[s0:s0 + 160] - b[s0:s0 + 160]) ** 2).mean()
        p = (b[s0:s0 + 160] ** 2).mean()
        if p > 1e4:
            segs.append(10 * np.log10(max(p, 1) / max(e, 1)))
    # measured 6.9 dB segSNR vs the RAW input (round 2, greedy mode) —
    # but the
    # decoder's fixed 100 Hz output high-pass phase-distorts the
    # waveform: even a PERFECT encoder caps at 8.3 dB on this fixture
    # measured this way.  Gate with headroom against regressions.
    assert np.mean(segs) > 6.0, f"segSNR too low: {np.mean(segs):.2f}"


def test_roundtrip_quality_hp_reference():
    """segSNR against the proper reference: the input passed through the
    decoder's fixed pre-scale + 100 Hz output high-pass (spec 4.2.5).

    This removes the fixed-filter phase-distortion artifact from the
    metric (it is not coding error — it caps the raw-input segSNR at
    8.3 dB on this fixture no matter the encoder).  Measured: 12.27 dB
    (round 2, greedy); 12.77 dB (round 5, the frame-select default:
    candidate frames are scored through the FULL decode incl. the
    adaptive postfilter — whose long-term stage comb-filters at the
    transmitted pitch, so waveform-best pitch is not output-best —
    and the gate rises 10.5 -> 12.5 per the r4 verdict)."""
    sig = _speechlike(4800)
    # reference chain: x0.5 then the decoder's output HP (gain 2)
    d = G729Decoder()
    buf = [int(v) >> 1 for v in sig.tolist()]
    ref = []
    for f0 in range(len(buf) // 80):
        ch = buf[f0 * 80:(f0 + 1) * 80]
        d.high_pass_filter(ch)
        ref.extend(ch)
    ref = np.array(ref, dtype=float)

    _, out = _roundtrip_4800()
    a = out[400:len(sig)].astype(float)
    b = ref[400:len(sig)]
    segs = []
    for s0 in range(0, len(a) - 160, 160):
        e = ((a[s0:s0 + 160] - b[s0:s0 + 160]) ** 2).mean()
        p = (b[s0:s0 + 160] ** 2).mean()
        if p > 1e4:
            segs.append(10 * np.log10(max(p, 1) / max(e, 1)))
    snr = float(np.mean(segs))
    assert snr > 12.5, f"HP-referenced segSNR too low: {snr:.2f}"


def test_encoder_decoder_state_tracking():
    """The encoder's shadow decoder must track an actual decoder exactly."""
    sig = _speechlike(1600, seed=9)
    enc = G729Encoder()
    dec = G729Decoder()
    for f in range(len(sig) // 80):
        fr = enc.encode_frame(sig[f * 80:(f + 1) * 80].astype(np.float64))
        dec.decode_frame(fr)
        assert enc.shadow.exc_base == dec.exc_base, f"frame {f}"
        assert enc.shadow.syn_filter_data == dec.syn_filter_data, f"frame {f}"
        assert enc.shadow.pred_energ_q == dec.pred_energ_q, f"frame {f}"


def test_pcm_to_act_to_pcm():
    """Full speech pipeline: PCM -> G.729A -> ACT file -> decode."""
    sig = _speechlike(2400)
    frames = encode_stream(sig)
    data = act.mux(frames, sample_rate=8000)
    got_frames, rate, _ = act.demux(data)
    dec = G729Decoder()
    out = np.concatenate([dec.decode_frame(f)
                          for f in got_frames[:len(frames)]])
    c = np.corrcoef(out[400:len(sig)].astype(float),
                    sig[400:len(sig)].astype(float))[0, 1]
    assert c > 0.7


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a closed jaxpr, nested
    jaxprs (jit, cond, scan, while) included."""
    from jax.extend import core
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, core.ClosedJaxpr):
                    out.extend(_dot_precisions(sub.jaxpr))
                elif isinstance(sub, core.Jaxpr):
                    out.extend(_dot_precisions(sub))
    return out


def test_device_encoder_contractions_run_at_highest_precision():
    """A GPU may run float32 matrix products in TF32 (~3 decimal digits),
    which moves the codebook search scores; every contraction of the
    device encoder's frame step is pinned to Precision.HIGHEST."""
    import jax
    import jax.numpy as jnp
    from amv_tpu.codecs import g729a as G
    from amv_tpu.codecs.g729a_encoder_tpu import encode_frame_batch
    closed = jax.make_jaxpr(encode_frame_batch.__wrapped__)(
        G.init_state(2), jnp.zeros((2, 160)), jnp.zeros((2, 80)))
    precisions = _dot_precisions(closed.jaxpr)
    assert len(precisions) > 10
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precisions), set(precisions)
