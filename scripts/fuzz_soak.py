"""Long-running seeded fuzz soak over every host parser / C boundary.

Same mutation model as tests/test_fuzz_parsers.py (byte flips,
truncations, le32 length scribbles) but at soak scale: each (target,
seed) batch runs in a SUBPROCESS so a C-extension segfault / glibc
abort is detected by return code instead of killing the harness — this
is exactly how the round-3 custom-table heap overflow surfaced (a
malloc abort under test_fuzz_parsers).

Master mode:
    python scripts/fuzz_soak.py --minutes 30
Worker mode (spawned by master; also usable for repro):
    python scripts/fuzz_soak.py --worker TARGET --seed N --n 2000
"""
import argparse
import os
import struct
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

def _corpus() -> bytes:
    """The seeded 128x96 library clip the tests use (verify/corpus.py)."""
    from amv_tpu.verify.corpus import library_clip
    return library_clip(128, 96, fps=12, seconds=4.0, sample_rate=16000,
                        seed=2026)


def mutations(data: bytes, rng, n, max_flips=8):
    for _ in range(n):
        b = bytearray(data)
        kind = rng.integers(0, 3)
        if kind == 0:
            for _ in range(int(rng.integers(1, max_flips + 1))):
                b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        elif kind == 1:
            b = b[:int(rng.integers(0, len(b)))]
        else:
            if len(b) >= 4:
                pos = int(rng.integers(0, len(b) - 3))
                val = int(rng.integers(0, 2)) * 0xFFFFFFF0 + int(
                    rng.integers(0, 16))
                b[pos:pos + 4] = struct.pack("<I", val & 0xFFFFFFFF)
        yield bytes(b)


# ---------------------------------------------------------------- targets

def t_riff(rng, n):
    from amv_tpu.containers import riff
    data = _corpus()
    for mut in mutations(data, rng, n):
        try:
            s = riff.demux(mut)
            [c[:1] for c in s.video_chunks[:4]]
        except Exception:
            pass


def t_avi(rng, n):
    from amv_tpu.containers import riff, avi
    s = riff.demux(_corpus())
    w, h = s.info.width, s.info.height
    y = rng.integers(0, 256, (4, h, w), np.uint8).astype(np.uint8)
    cb = rng.integers(0, 256, (4, h // 2, w // 2), np.uint8).astype(np.uint8)
    cr = rng.integers(0, 256, (4, h // 2, w // 2), np.uint8).astype(np.uint8)
    pcm = rng.integers(-2000, 2000, 4000).astype(np.int16)
    data = avi.mux(y, cb, cr, pcm, fps=12, sample_rate=16000)
    for mut in mutations(data, rng, n):
        try:
            st = avi.demux(mut)
            avi.extract_yuv420(st)
            avi.extract_pcm(st)
        except Exception:
            pass


def t_act(rng, n):
    from amv_tpu.containers import act
    frames = [bytes(rng.integers(0, 256, 10, np.uint8)) for _ in range(60)]
    data = act.mux(frames, sample_rate=8000)
    for mut in mutations(data, rng, n):
        try:
            act.demux(mut)
        except Exception:
            pass


def t_jpeg_parse(rng, n):
    from amv_tpu.containers import riff
    from amv_tpu.bitstream.jpeg_tables import canned_jpeg_header
    from amv_tpu.bitstream.jpeg_parse import parse_jpeg
    s = riff.demux(_corpus())
    jpg = canned_jpeg_header(s.info.width, s.info.height) \
        + s.video_chunks[0][2:]
    for mut in mutations(jpg, rng, n):
        try:
            parse_jpeg(mut, allow_lossless=True)
        except Exception:
            pass


def t_c_huffman(rng, n):
    from amv_tpu.containers import riff
    from amv_tpu.bitstream.entropy import huffman_decode_frames
    s = riff.demux(_corpus())
    M = (((s.info.width + 15) // 16) * ((s.info.height + 15) // 16))
    base = s.video_chunks[0]
    for mut in mutations(base, rng, n):
        try:
            huffman_decode_frames([mut], M)
        except Exception:
            pass


def t_c_custom(rng, n):
    from amv_tpu.bitstream.jpeg_parse import parse_jpeg
    from amv_tpu.codecs.mjpeg import encode_mjpeg_frames
    from amv_tpu.native import entropy_native as native
    y = rng.integers(0, 256, (1, 32, 32), np.uint8).astype(np.uint8)
    cb = rng.integers(0, 256, (1, 16, 16), np.uint8).astype(np.uint8)
    cr = rng.integers(0, 256, (1, 16, 16), np.uint8).astype(np.uint8)
    data = encode_mjpeg_frames(y, cb, cr, restart_interval=2)[0]
    for mut in mutations(data, rng, n):
        try:
            f = parse_jpeg(mut)
            mcu_w = 16 if any(h > 1 or v > 1
                              for (_, h, v, _) in f.components) else 8
            n_mcu = (((f.width + mcu_w - 1) // mcu_w) *
                     ((f.height + mcu_w - 1) // mcu_w))
            if not 0 < n_mcu <= 4096:
                continue
            pairs = [(dc_id, ac_id)
                     for (_, dc_id, ac_id, _) in f.mcu_blocks()]
            native.decode_scans_custom(
                [f.scan], n_mcu, f.huff, pairs,
                restart_interval=f.restart_interval)
        except Exception:
            pass


def t_progressive(rng, n):
    from amv_tpu.bitstream.jpeg_progressive import (decode_progressive,
                                                    encode_progressive,
                                                    _Scans)
    lv = np.zeros((4, 1, 64), np.int16)
    lv[:, :, 0] = rng.integers(-40, 41, (4, 1))
    lv[:, :, 1:] = np.where(rng.random((4, 1, 63)) < 0.2,
                            rng.integers(-80, 81, (4, 1, 63)), 0)
    data = encode_progressive(lv, (16, 16), layout="gray")
    for mut in mutations(data, rng, n):
        try:
            f = _Scans(mut).frame
            if f.width * f.height > 1 << 22:
                continue
            decode_progressive(mut)
        except Exception:
            pass


def t_lossless(rng, n):
    from amv_tpu.bitstream.jpeg_parse import parse_jpeg
    from amv_tpu.bitstream.jpeg_lossless import (decode_lossless,
                                                 encode_lossless)
    y = rng.integers(0, 256, (16, 16), np.uint8).astype(np.uint8)
    c = rng.integers(0, 256, (8, 8), np.uint8).astype(np.uint8)
    data = encode_lossless([y, c, c], predictor=4, restart_interval=2)
    for mut in mutations(data, rng, n):
        try:
            fr = parse_jpeg(mut, allow_lossless=True)
            if fr.width * fr.height > 1 << 14:
                continue
            decode_lossless(mut)
        except Exception:
            pass


def t_wav(rng, n):
    from amv_tpu.containers import wav
    pcm = rng.integers(-3000, 3000, 500).astype(np.int16)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "seed.wav")
        wav.write_pcm(p, pcm, 16000)
        data = open(p, "rb").read()
        mp = os.path.join(td, "mut.wav")
        for mut in mutations(data, rng, n):
            open(mp, "wb").write(mut)
            try:
                wav.read_pcm(mp)
            except Exception:
                pass


def t_unescape(rng, n):
    from amv_tpu.native import entropy_native as native
    base = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
    for mut in mutations(base, rng, n):
        try:
            native.unescape_frames([mut])
        except Exception:
            pass


TARGETS = {
    "riff": t_riff, "avi": t_avi, "act": t_act, "jpeg_parse": t_jpeg_parse,
    "c_huffman": t_c_huffman, "c_custom": t_c_custom,
    "progressive": t_progressive, "lossless": t_lossless,
    "wav": t_wav, "unescape": t_unescape,
}


LOCKFILE = os.path.join(tempfile.gettempdir(), "amv_fuzz_soak.lock")
LOAD_MAX = 1.5   # this host has ONE core; anything compiling pushes >1


def _wait_for_quiet_host(max_wait_s=600):
    """Refuse to fuzz on a contended host (r3 verdict item 8: a worker
    that replays in 0.2 s blew an 1800 s timeout because it ran beside a
    1684 s single-core XLA compile).  Waits up to max_wait_s for the
    1-min loadavg to drop, then aborts rather than produce a false
    positive."""
    t0 = time.time()
    while True:
        try:
            load = os.getloadavg()[0]
        except OSError:
            return
        if load <= LOAD_MAX:
            return
        if time.time() - t0 > max_wait_s:
            print(f"ABORT: host load {load:.1f} > {LOAD_MAX} for "
                  f"{max_wait_s}s — run the soak when nothing is "
                  f"compiling (subprocess timeouts would be starvation, "
                  f"not hangs)", flush=True)
            sys.exit(2)
        print(f"# waiting for quiet host (load {load:.1f})...", flush=True)
        time.sleep(30)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--minutes", type=float, default=30)
    args = ap.parse_args()

    if args.worker:
        rng = np.random.default_rng(args.seed)
        TARGETS[args.worker](rng, args.n)
        return

    # single-instance lock: two soaks (or a soak over a stale lock from a
    # dead master) must not share the one host core.  Acquisition is
    # atomic (O_CREAT|O_EXCL) and release is a try/finally so abort paths
    # (_wait_for_quiet_host sys.exit, worker TimeoutExpired) cannot leave
    # the lock behind (r4 ADVICE).
    for attempt in range(2):
        try:
            fd = os.open(LOCKFILE, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            break
        except FileExistsError:
            try:
                other = int(open(LOCKFILE).read().strip())
                os.kill(other, 0)
                print(f"ABORT: soak already running (pid {other}, "
                      f"{LOCKFILE})", flush=True)
                sys.exit(2)
            except (ValueError, ProcessLookupError, PermissionError):
                # stale lock: remove and retry the atomic create once
                try:
                    os.remove(LOCKFILE)
                except OSError:
                    pass
    else:
        print("ABORT: could not acquire soak lock", flush=True)
        sys.exit(2)

    try:
        _wait_for_quiet_host()

        deadline = time.time() + args.minutes * 60
        seed = int(time.time()) & 0xFFFFFF
        fails = []
        rounds = 0
        while time.time() < deadline:
            for name in TARGETS:
                if time.time() >= deadline:
                    break
                _wait_for_quiet_host()
                r = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--worker",
                     name, "--seed", str(seed), "--n", str(args.n)],
                    capture_output=True, text=True, timeout=1800)
                if r.returncode != 0:
                    fails.append((name, seed, r.returncode))
                    print(f"FAIL {name} seed={seed} rc={r.returncode}\n"
                          f"--- stderr tail ---\n{r.stderr[-2000:]}",
                          flush=True)
                else:
                    print(f"ok {name} seed={seed} n={args.n}", flush=True)
            seed += 1
            rounds += 1
        print(f"done: {rounds} rounds, {len(fails)} failures: {fails}",
              flush=True)
    finally:
        try:
            os.remove(LOCKFILE)
        except OSError:
            pass
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
