#!/usr/bin/env python3
"""Smoke test of the AMV codec on one NVIDIA GPU, through the CLI.

Run from the repository root:

    python chip_smoke.py              # every phase, one GPU
    python chip_smoke.py --chips 4    # the transcode phase over 4 GPUs

Everything runs in this one process on a corpus made from --seed: video
by the C reference encoder (native.ref_encode_frame), audio by the
scalar ADPCM oracle, G.729A frames from verify/corpus.py, muxed by the
repository's own RIFF, AVI and ACT writers.  Each phase goes through
amv_tpu.cli.main and is byte-exact against an independent oracle:

1. transcode  -i lib160.amv -f amv out.amv (160x120, 16 fps, 240 s) and a
   320x240 60 s clip: each frame equals C decode + C encode at qscale 2,
   audio passes through;
2. decode     -i lib160.amv out.avi / out.wav: planes equal the C
   decoder, PCM equals the C ADPCM decoder;
3. encode     -i in.avi -f amv -r 16 -s 160x120 -ac 1 -ar 22050 out.amv:
   video equals the C encoder, audio the scalar ADPCM encoder;
4. ACT        -i dict.act out.wav equals verify/ref_g729.py, and
   g729a.decode_streams on 64 streams x 30 s agrees with it on a subset;
5. the G.729A device encoder on 64 x 10 s streams passes the segSNR gate
   of tests/test_g729_encoder_tpu.py;
6. each hand-written GPU kernel equals its plain JAX reference at these
   widths, with both timed on the card, end to end and alone.

No frame may take a host re-encode.  The last line of output is one JSON
object naming the device; any failure exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def best_ms(fn, reps: int = 3) -> float:
    """Best wall time of fn() over reps warm runs, in ms (fn blocks)."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return 1e3 * min(times)


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    yield
    log(f"phase {name}: ok in {time.perf_counter() - t:.3f} s")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def plain_kernels():
    """Swap the GPU kernels for the plain JAX versions, for timing the
    same CLI path both ways."""
    from amv_tpu import backend
    from amv_tpu.codecs import amv_video
    from amv_tpu.kernels import adpcm, entropy_decode
    from amv_tpu.pipeline import transcode
    saved = (backend.entropy_decoder, backend.adpcm_encoder)
    backend.entropy_decoder = lambda: entropy_decode.decode_scans_device
    backend.adpcm_encoder = lambda: adpcm.encode_samples
    jitted = (transcode.transcode_scans, amv_video.decode_scans)
    for fn in jitted:
        fn.clear_cache()
    try:
        yield
    finally:
        backend.entropy_decoder, backend.adpcm_encoder = saved
        for fn in jitted:
            fn.clear_cache()


def oracle_transcode(payloads, width, height):
    from amv_tpu.native import entropy_native as native
    return [native.ref_encode_frame(
        *native.ref_decode_frame(p, width, height), 2) for p in payloads]


def run_cli(*argv) -> None:
    from amv_tpu import cli
    check(cli.main(list(argv)) == 0, f"cli {' '.join(argv)}")


def transcode_phase(tmp, args, lib160_want):
    from amv_tpu.containers import riff
    from amv_tpu.verify.corpus import library_clip
    src, out = os.path.join(tmp, "lib160.amv"), os.path.join(tmp, "out.amv")
    with phase("transcode 160x120 240 s (3840 frames)"):
        run_cli("-i", src, "-f", "amv", out)
        s_in, s_out = riff.read(src), riff.read(out)
        check(s_out.video_chunks == lib160_want, "160x120 video != oracle")
        check(s_out.audio_chunks == s_in.audio_chunks, "audio not passed")
    with phase("transcode 320x240 60 s (960 frames)"):
        data = library_clip(320, 240, fps=16, seconds=60, sample_rate=22050,
                            seed=args.seed + 1)
        src2, out2 = os.path.join(tmp, "lib320.amv"), os.path.join(tmp, "o2.amv")
        with open(src2, "wb") as f:
            f.write(data)
        run_cli("-i", src2, "-f", "amv", out2)
        s_in2 = riff.demux(data)
        check(riff.read(out2).video_chunks ==
              oracle_transcode(s_in2.video_chunks, 320, 240),
              "320x240 video != oracle")


def four_card_phase(tmp, args, lib160, lib160_want):
    import jax
    from amv_tpu.containers import riff
    from amv_tpu.parallel.sharding import make_mesh
    from amv_tpu.pipeline.serving import AsyncTranscoder
    from amv_tpu.pipeline.transcode import transcode_bytes
    check(len(jax.devices()) >= 4, "--chips 4 needs 4 GPUs")
    s = riff.demux(lib160)
    with phase("transcode over a 4-GPU mesh (AsyncTranscoder)"):
        tr = AsyncTranscoder(160, 120, batch_frames=960, depth=2,
                             mesh=make_mesh(jax.devices()[:4]))
        t = time.perf_counter()
        got = tr.transcode(s.video_chunks)
        log(f"4-GPU AsyncTranscoder first pass {time.perf_counter() - t:.3f} s")
        check(got == lib160_want, "4-GPU transcode != oracle")
        check(got == riff.demux(transcode_bytes(lib160)).video_chunks,
              "4-GPU transcode != 1-GPU transcode_bytes")
        one = AsyncTranscoder(160, 120, batch_frames=960, depth=2)
        check(one.transcode(s.video_chunks) == got,
              "4-GPU transcode != 1-GPU AsyncTranscoder")
        log(f"4-GPU AsyncTranscoder steady "
            f"{best_ms(lambda: tr.transcode(s.video_chunks)):.3f} ms; "
            f"1-GPU AsyncTranscoder "
            f"{best_ms(lambda: one.transcode(s.video_chunks)):.3f} ms "
            f"({len(s.video_chunks)} frames 160x120, 960-frame batches)")


def decode_phase(tmp, lib160):
    import numpy as np
    from amv_tpu.containers import avi, riff, wav
    from amv_tpu.native import entropy_native as native
    src = os.path.join(tmp, "lib160.amv")
    s = riff.demux(lib160)
    with phase("decode to AVI and WAV"):
        planes = [native.ref_decode_frame(p, 160, 120) for p in s.video_chunks]
        pcm = np.concatenate([native.ref_adpcm_decode(
            c[8:], int.from_bytes(c[:2], "little", signed=True),
            min(int.from_bytes(c[2:4], "little"), 88))
            for c in s.audio_chunks])
        out_avi, out_wav = os.path.join(tmp, "d.avi"), os.path.join(tmp, "d.wav")
        run_cli("-i", src, out_avi)
        run_cli("-i", src, out_wav)
        streams = avi.read(out_avi)
        y, cb, cr = avi.extract_yuv420(streams[0])
        for i, plane in enumerate((y, cb, cr)):
            check(np.array_equal(plane, np.stack([p[i] for p in planes])),
                  f"decoded plane {i} != C decoder")
        check(np.array_equal(avi.extract_pcm(streams[1]), pcm),
              "AVI PCM != C ADPCM decoder")
        got, rate = wav.read_pcm(out_wav)
        check(rate == 22050 and np.array_equal(got, pcm),
              "WAV PCM != C ADPCM decoder")


def encode_phase(tmp, args):
    from amv_tpu.containers import avi, riff
    from amv_tpu.native import entropy_native as native
    from amv_tpu.pipeline.encode import av_rescale_near
    from amv_tpu.verify import corpus, fixtures, ref_adpcm
    with phase("encode AVI (I420 + PCM, 160x120, 60 s) to AMV"):
        y, cb, cr = corpus.planes(960, 160, 120, seed=args.seed + 2)
        pcm = fixtures.audiogen(60, 22050, seed=args.seed + 2)
        src, out = os.path.join(tmp, "in.avi"), os.path.join(tmp, "e.amv")
        with open(src, "wb") as f:
            f.write(avi.mux(y, cb, cr, pcm, fps=16, sample_rate=22050))
        run_cli("-i", src, "-f", "amv", "-r", "16", "-s", "160x120",
                "-ac", "1", "-ar", "22050", out)
        s = riff.read(out)
        check(s.video_chunks == [native.ref_encode_frame(y[f], cb[f], cr[f], 2)
                                 for f in range(len(y))],
              "encoded video != C encoder")
        check(s.audio_chunks == ref_adpcm.encode(
            pcm, av_rescale_near(22050, 1, 16), 22050),
              "encoded audio != scalar ADPCM encoder")
    return pcm


def act_phase(tmp, args):
    import numpy as np
    from amv_tpu.codecs import g729a
    from amv_tpu.containers import act, wav
    from amv_tpu.verify.corpus import g729_frames
    from amv_tpu.verify.ref_g729 import G729Decoder

    def oracle(frames):
        dec = G729Decoder()
        return np.concatenate([dec.decode_frame(bytes(f)) for f in frames])

    with phase("ACT (G.729A, 30 s dictation) to WAV"):
        src, out = os.path.join(tmp, "dict.act"), os.path.join(tmp, "a.wav")
        frames = [f.tobytes() for f in g729_frames(3000, seed=args.seed + 3)]
        with open(src, "wb") as f:
            f.write(act.mux(frames, sample_rate=8000))
        run_cli("-i", src, out)
        with open(src, "rb") as f:
            stored = act.demux(f.read())[0]
        got, rate = wav.read_pcm(out)
        check(rate == 8000 and np.array_equal(got, oracle(stored)),
              "ACT decode != ref_g729")
    with phase("G.729A decode_streams, 64 streams x 30 s"):
        fr = g729_frames(3000 * 64, seed=args.seed + 4).reshape(3000, 64, 10)
        t = time.perf_counter()
        pcm = np.asarray(g729a.decode_streams(fr))
        log(f"G.729A decode 64 x 3000 frames (compile included) "
            f"{time.perf_counter() - t:.3f} s")
        for b in (0, 63):
            check(np.array_equal(pcm[b, :80 * 1000], oracle(fr[:1000, b])),
                  f"decode_streams stream {b} != ref_g729")


def g729_encoder_phase(args):
    import numpy as np
    from amv_tpu.codecs import g729a
    from amv_tpu.codecs.g729a_encoder_tpu import encode_streams_tpu
    from amv_tpu.verify.fixtures import speechgen
    from amv_tpu.verify.ref_g729 import G729Decoder
    with phase("G.729A device encoder, 64 x 10 s"):
        sigs = np.stack([speechgen(80000, seed=args.seed + 100 + b)
                         for b in range(64)])
        t = time.perf_counter()
        frames = encode_streams_tpu(sigs)
        log(f"G.729A encode 64 x 1000 frames (compile included) "
            f"{time.perf_counter() - t:.3f} s")
        check(frames.shape == (1000, 64, 10), "encoder output shape")
        out = np.asarray(g729a.decode_streams(frames))
        dec = G729Decoder()
        check(np.array_equal(out[0], np.concatenate(
            [dec.decode_frame(frames[f, 0].tobytes()) for f in range(1000)])),
            "device decode of encoded stream 0 != ref_g729")
        worst = []
        for b in range(64):     # the gate of tests/test_g729_encoder_tpu.py
            a, r = out[b, 400:].astype(float), sigs[b, 400:].astype(float)
            c = np.corrcoef(a, r)[0, 1]
            segs = []
            for s0 in range(0, len(a) - 160, 160):
                e = ((a[s0:s0 + 160] - r[s0:s0 + 160]) ** 2).mean()
                p = (r[s0:s0 + 160] ** 2).mean()
                if p > 1e4:
                    segs.append(10 * np.log10(max(p, 1) / max(e, 1)))
            snr = float(np.mean(segs))
            worst.append(snr)
            check(c > 0.8 and snr > 4.0,
                  f"stream {b}: corr {c:.3f}, segSNR {snr:.2f} dB")
        log(f"G.729A encoder segSNR min {min(worst):.3f} dB, mean "
            f"{float(np.mean(worst)):.3f} dB (gate 4.0)")


def kernel_phase(tmp, lib160, enc_pcm):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from amv_tpu.codecs import amv_audio
    from amv_tpu.containers import riff
    from amv_tpu.kernels import adpcm
    from amv_tpu.kernels.adpcm_encode_triton import encode_samples_triton
    from amv_tpu.kernels.entropy_decode import decode_scans_device
    from amv_tpu.kernels.entropy_decode_cuda import decode_scans_cuda
    from amv_tpu.pipeline.encode import av_rescale_near
    from amv_tpu.verify.ref_adpcm import chunk_lengths
    from amv_tpu.pipeline.serving import batch_frames_for, row_width
    from amv_tpu.pipeline.transcode import (out_bytes_bound, transcode_bytes,
                                            transcode_scans, unescape_sorted)
    with phase("kernels vs plain JAX"):
        for name in ("lib160.amv", "lib320.amv"):
            s = riff.read(os.path.join(tmp, name))
            w, h = s.info.width, s.info.height
            m = (w // 16) * (h // 16)
            rows, _ = unescape_sorted(s.video_chunks)
            x = jax.device_put(jnp.asarray(rows))
            got, want = decode_scans_cuda(x, m), decode_scans_device(x, m)
            for a, b in zip(got, want):
                check(np.array_equal(np.asarray(a), np.asarray(b)),
                      f"CUDA decoder != plain decoder at {w}x{h}")
            tk = best_ms(lambda: jax.block_until_ready(decode_scans_cuda(x, m)))
            tx = best_ms(lambda: jax.block_until_ready(decode_scans_device(x, m)))
            log(f"kernel huffman_decode {w}x{h} F={len(rows)}: "
                f"cuda {tk:.3f} ms, xla {tx:.3f} ms")
        data = open(os.path.join(tmp, "lib160.amv"), "rb").read()
        tk = best_ms(lambda: transcode_bytes(data), reps=2)
        with plain_kernels():
            tx = best_ms(lambda: transcode_bytes(data), reps=2)
        log(f"end-to-end transcode_bytes 160x120 3840 frames: "
            f"cuda decoder {tk:.3f} ms, xla decoder {tx:.3f} ms")
        # the one batch transcode_bytes runs for this file
        chunks = riff.demux(data).video_chunks
        bf, wb = batch_frames_for(len(chunks), 160, 120), row_width(chunks)
        compiled = transcode_scans.lower(
            jax.ShapeDtypeStruct((bf, wb), jnp.uint8), width=160,
            height=120, max_bytes=out_bytes_bound(wb)).compile()
        log(f"transcode step [{bf}, {wb}] memory_analysis: "
            f"{compiled.memory_analysis()}")

        # ADPCM encode: the whole 60 s track is one stream (step index
        # carries across chunks)
        fs = av_rescale_near(22050, 1, 16)
        ns = chunk_lengths(len(enc_pcm), fs, 22050)
        padded = np.zeros((1, 2 * sum(ns)), np.int32)
        padded[0, :len(enc_pcm)] = enc_pcm
        reset = np.zeros(padded.shape, bool)
        reset[0, np.cumsum([0] + [2 * n for n in ns[:-1]])] = True
        samples, reset = jnp.asarray(padded), jnp.asarray(reset)
        sidx = jnp.zeros(1, jnp.int32)
        got = encode_samples_triton(samples, reset, sidx)
        want = adpcm.encode_samples(samples, reset, sidx)
        for a, b in zip(got, want):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  "Triton ADPCM encoder != plain scan")
        tk = best_ms(lambda: jax.block_until_ready(
            encode_samples_triton(samples, reset, sidx)))
        log(f"kernel adpcm_encode n={samples.shape[1]}: triton {tk:.3f} ms "
            "(xla: see the end-to-end line)")
        tk = best_ms(lambda: amv_audio.encode_stream(enc_pcm, fs, 22050))
        with plain_kernels():
            tx = best_ms(lambda: amv_audio.encode_stream(enc_pcm, fs, 22050),
                         reps=1)
        log(f"end-to-end encode_stream 60 s: triton {tk:.3f} ms, "
            f"xla {tx:.3f} ms")

        # ADPCM decode: the associative form the codec runs against the
        # per-sample reference scan, on the 240 s track's chunks
        chunks = riff.demux(data).audio_chunks
        n = max(len(c) for c in chunks) - 8
        payload = jnp.asarray(np.stack([np.frombuffer(
            c[8:].ljust(n, b"\0"), np.uint8) for c in chunks]))
        pred = jnp.asarray([int.from_bytes(c[:2], "little", signed=True)
                            for c in chunks], jnp.int32)
        sidx = jnp.asarray([min(int.from_bytes(c[2:4], "little"), 88)
                            for c in chunks], jnp.int32)
        nib = adpcm.bytes_to_nibbles(payload)
        check(np.array_equal(
            np.asarray(adpcm.decode_chunks(payload, pred, sidx)),
            np.asarray(adpcm.decode_nibbles_scan(nib, pred, sidx))),
            "associative ADPCM decode != reference scan")
        ta = best_ms(lambda: jax.block_until_ready(
            adpcm.decode_chunks(payload, pred, sidx)))
        ts = best_ms(lambda: jax.block_until_ready(
            adpcm.decode_nibbles_scan(nib, pred, sidx)))
        te = best_ms(lambda: amv_audio.decode_chunks(chunks))
        log(f"adpcm_decode {len(chunks)} chunks x {n} B: associative "
            f"{ta:.3f} ms, scan {ts:.3f} ms; end-to-end decode_chunks "
            f"{te:.3f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the transcode phase, over 4 GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import jax
        from amv_tpu import backend
        from amv_tpu.containers import riff
        from amv_tpu.verify.corpus import library_clip
    except ImportError as e:
        print(f"error: run from the repository root ({e})", file=sys.stderr)
        return 2
    if backend.platform() != "gpu":
        print(f"error: JAX found no GPU (devices {jax.devices()})",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"nvidia-smi: {smi.splitlines()[0] if smi else 'unavailable'}")
    log(f"jax {jax.__version__}, devices {jax.devices()}")
    log(f"compile cache: {backend.enable_compile_cache(HERE)}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=HERE) as tmp:
        with phase("corpus (240 s 160x120 clip and its oracle)"):
            lib160 = library_clip(160, 120, fps=16, seconds=240,
                                  sample_rate=22050, seed=args.seed)
            with open(os.path.join(tmp, "lib160.amv"), "wb") as f:
                f.write(lib160)
            want = oracle_transcode(riff.demux(lib160).video_chunks, 160, 120)
        if args.chips == 4:
            four_card_phase(tmp, args, lib160, want)
        else:
            transcode_phase(tmp, args, want)
            decode_phase(tmp, lib160)
            enc_pcm = encode_phase(tmp, args)
            act_phase(tmp, args)
            g729_encoder_phase(args)
            kernel_phase(tmp, lib160, enc_pcm)
    fallbacks = sum(backend.host_fallbacks.values())
    log(f"host re-encodes: {fallbacks} {dict(backend.host_fallbacks)}")
    check(fallbacks == 0, "frames took a host re-encode")
    log(f"total {time.perf_counter() - t0:.3f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
