"""ffmpeg-shaped CLI for the AMV codec framework.

Mirrors the reference's canonical invocations (AMVmuxer/Makefile:24-33):

  # decode .amv -> WAV / raw YUV / BMP or JPEG frame dumps
  python -m amv_tpu -i clip.amv out.wav
  python -m amv_tpu -i clip.amv out.yuv
  python -m amv_tpu -i clip.amv frames/frame_%04d.bmp
  python -m amv_tpu -i clip.amv frames/frame_%04d.jpg

  # encode AVI or raw YUV420 + WAV -> .amv (the `ffmpeg ... -f amv` shape)
  python -m amv_tpu -i in.avi -f amv -r 16 -s 160x120 -ar 22050 out.amv
  python -m amv_tpu -i in.yuv -i in.wav -f amv -r 16 -s 160x120 out.amv

  # G.729A speech: ACT file <-> WAV, ITU .BIT export (act2bit)
  python -m amv_tpu -i rec.act out.wav
  python -m amv_tpu -i in8k.wav -f act out.act
  python -m amv_tpu -i rec.act out.bit

  # decode .amv -> MJPG-compressed AVI (the `-vcodec mjpeg` shape)
  python -m amv_tpu -i clip.amv -vcodec mjpeg out.avi

  # tools: probe, structural diff (compare_amv), seek, timing
  python -m amv_tpu --info clip.amv
  python -m amv_tpu --compare good.amv bad.amv
  python -m amv_tpu -i clip.amv --seek 100 --benchmark out.avi
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np


def _write_bmp(path: str, rgb: np.ndarray):
    h, w, _ = rgb.shape
    row = (w * 3 + 3) & ~3
    img = np.zeros((h, row), dtype=np.uint8)
    bgr = rgb[::-1, :, ::-1]  # bottom-up, BGR
    img[:, :w * 3] = bgr.reshape(h, w * 3)
    hdr = b"BM" + struct.pack("<IHHI", 54 + img.size, 0, 0, 54)
    hdr += struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(hdr + img.tobytes())


def _export_jpeg(path: str, payload: bytes, width: int, height: int):
    """Canonical JPEG reconstruction of one AMV frame (sp5xdec.c:50-88).

    The image is stored upside-down (AMV convention) — viewers show it
    flipped; this matches the reference's raw frame export semantics."""
    from .bitstream.jpeg_tables import canned_jpeg_header
    with open(path, "wb") as f:
        f.write(canned_jpeg_header(width, height))
        f.write(payload[2:len(payload) - 2])
        f.write(b"\xFF\xD9")


def main(argv=None):
    p = argparse.ArgumentParser(prog="amv_tpu", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", dest="inputs", action="append", default=[],
                   help="input file (repeatable)")
    p.add_argument("-f", dest="format", default=None, help="force format (amv)")
    p.add_argument("-r", dest="fps", type=int, default=16, help="frame rate")
    p.add_argument("-s", dest="size", default=None, help="WxH frame size")
    p.add_argument("-sws_flags", dest="sws_flags", default="bicubic",
                   choices=["bilinear", "bicubic", "point", "area",
                            "lanczos", "gauss", "sinc", "spline",
                            "experimental", "bicublin"],
                   help="rescale filter (full libswscale SWS_* flag set, "
                        "swscale.c:1065-1161; default bicubic like ffmpeg)")
    p.add_argument("-ar", dest="sample_rate", type=int, default=22050)
    p.add_argument("-ac", dest="channels", type=int, default=1)
    p.add_argument("-qscale", dest="qscale", type=int, default=2)
    p.add_argument("-amv_quant", dest="amv_quant",
                   choices=["ffmpeg", "q60"], default="ffmpeg",
                   help="AMV encode quantizer: ffmpeg = bit-exact "
                        "reference mode (MPEG-1 matrix x qscale, "
                        "mpegvideo_enc.c:2866-2876 — faithful incl. the "
                        "~19 dB decode-mismatch bug the reference never "
                        "fixed); q60 = device-consistent mode quantizing "
                        "with the decoder's own sp5x Q60 tables "
                        "(sp5x.h:187-195), >=30 dB round trips — the fix "
                        "AMVmuxer/README:14-19 set out to find")
    p.add_argument("-vcodec", dest="vcodec",
                   choices=["rawvideo", "mjpeg", "copy"],
                   default="rawvideo",
                   help="AVI output video codec: rawvideo (I420 planes), "
                        "mjpeg (full-header baseline JPEG frames, the "
                        "reference's `-vcodec mjpeg` shape), or copy "
                        "(no re-encode: AMV scans wrapped with the canned "
                        "JPEG header, sp5xdec.c:50-88; frames stay "
                        "bottom-up as stored)")
    p.add_argument("-acodec", dest="acodec", choices=["pcm", "copy"],
                   default="pcm",
                   help="WAV output codec: pcm (decode) or copy (raw "
                        "IMA-ADPCM stream with fact header, amvlib's "
                        "second WAV export mode, AMVDec.c:447-530)")
    p.add_argument("-pix_fmt", dest="pix_fmt", default=None,
                   choices=["rgb32", "bgr32", "rgb24", "bgr24",
                            "rgb565", "bgr565", "rgb555", "bgr555",
                            "rgb8", "bgr8", "rgb4", "bgr4",
                            "rgb4_byte", "bgr4_byte", "monob",
                            "yuyv422", "uyvy422"],
                   help="packed pixel format for .raw/.rgb rawvideo "
                        "output (libswscale yuv2rgb output family incl. "
                        "ordered dithering, yuv2rgb.c:304-615)")
    p.add_argument("-psnr", dest="psnr", action="store_true",
                   help="after encoding, print mean Y/U/V/All PSNR of the "
                        "output vs the input (CODEC_FLAG_PSNR, "
                        "mpegvideo_enc.c PSNR accounting)")
    p.add_argument("-trellis", dest="trellis", action="store_true",
                   help="Viterbi ADPCM quantizer (lower audio distortion)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("-t", dest="duration", type=float, default=None,
                   help="limit output duration in seconds (frames = t * "
                        "source fps, the ffmpeg -t shape)")
    p.add_argument("-y", dest="overwrite", action="store_true",
                   help="overwrite output (accepted for ffmpeg invocation "
                        "parity; outputs are always overwritten)")
    p.add_argument("--compare", nargs=2, metavar=("GOOD", "BAD"),
                   help="structural diff of two AMV files")
    p.add_argument("--info", metavar="FILE",
                   help="print stream info (ffprobe-style) and exit")
    p.add_argument("--seek", type=int, default=0,
                   help="start decoding at this frame index")
    p.add_argument("--color", choices=["bt601", "amvlib"], default="bt601")
    p.add_argument("--benchmark", action="store_true",
                   help="print elapsed utime after the operation (ffmpeg -benchmark)")
    p.add_argument("output", nargs="?", help="output file")
    args = p.parse_args(argv)

    if args.channels != 1:
        # adpcm.c:190-200: the AMV ADPCM encoder is mono-only; the
        # reference CLI would fail at codec open, we fail at parse
        raise SystemExit("-ac must be 1: AMV audio is mono "
                         "(IMA-ADPCM AMV, adpcm.c mono guard)")

    if args.info:
        return _info(args.info)

    if args.compare:
        from .verify.compare import compare_amv
        a = open(args.compare[0], "rb").read()
        b = open(args.compare[1], "rb").read()
        issues = compare_amv(a, b)
        for msg in issues:
            print(msg)
        print("Check successfully finished" if not issues
              else f"{len(issues)} mismatches")
        return 1 if issues else 0

    if not args.inputs or not args.output:
        p.error("need -i input(s) and an output")

    if args.duration is not None and args.max_frames is None:
        # ffmpeg -t: cap output duration; expressed as a frame/chunk limit
        # against the source rate (AMV header fps, ACT 10 ms frames,
        # otherwise the -r target rate)
        src0 = args.inputs[0]
        e0 = os.path.splitext(src0)[1].lower()
        if e0 == ".amv":
            from .containers import riff
            with open(src0, "rb") as f:
                info = riff.parse_header(f.read(0x140))
            args.max_frames = max(1, int(args.duration * info.fps_num))
        elif e0 == ".act":
            args.max_frames = max(1, int(args.duration * 100))
        else:
            args.max_frames = max(1, int(args.duration * args.fps))

    out = args.output
    ext = os.path.splitext(out)[1].lower()

    from .backend import enable_compile_cache
    enable_compile_cache()
    import resource
    import time as _time
    from .utils.profiling import trace
    t0 = _time.perf_counter()
    try:
        with trace("cli"):  # device trace when AMV_TRACE_DIR is set
            if args.format == "amv" or ext == ".amv":
                src_ext = os.path.splitext(args.inputs[0])[1].lower()
                if (len(args.inputs) == 1 and src_ext == ".amv"
                        and not args.size and not args.psnr):
                    # fused same-geometry requantize path; -s (rescale)
                    # or -psnr forces the full decode->encode pipeline
                    # like ffmpeg.c's filter-graph insertion
                    return _transcode(args)
                return _encode(args)
            if args.format == "act" or ext == ".act":
                return _encode_act(args)
            return _decode(args)
    finally:
        if args.benchmark:
            ru = resource.getrusage(resource.RUSAGE_SELF)
            print(f"bench: utime={ru.ru_utime:.3f}s "
                  f"wall={_time.perf_counter() - t0:.3f}s "
                  f"maxrss={ru.ru_maxrss // 1024}MB")


def _transcode(args):
    """AMV -> AMV re-encode (the `ffmpeg -i in.amv -f amv out.amv` shape):
    the device transcode chain, audio passes through bit-exact."""
    from .pipeline.transcode import transcode_bytes
    with open(args.inputs[0], "rb") as f:
        data = f.read()
    out = transcode_bytes(data, qscale=args.qscale or 2,
                          quant=args.amv_quant)
    with open(args.output, "wb") as f:
        f.write(out)
    mode = ("quant=q60" if args.amv_quant == "q60"
            else f"qscale={args.qscale or 2}")
    print(f"wrote {args.output}: {len(out)} bytes (requantized {mode})")
    return 0


def _encode_act(args):
    """WAV (8 kHz mono PCM) -> G.729A -> .act file."""
    from .containers import act as actmod, wav
    from .codecs.g729a_encoder import encode_stream
    src = args.inputs[0]
    pcm, rate = wav.read_pcm(src)
    if pcm.ndim > 1:
        pcm = pcm.mean(axis=1).astype(np.int16)
    if rate != 8000:
        from .kernels.resample import resample_pcm
        print(f"resampling audio {rate} -> 8000 Hz")
        pcm = resample_pcm(pcm, rate, 8000)
    if args.max_frames:
        pcm = pcm[:args.max_frames * 80]
    frames = encode_stream(pcm)
    data = actmod.mux(frames, sample_rate=8000)
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {args.output}: {len(frames)} G.729A frames, {len(data)} bytes")
    return 0


def _info(path):
    """Stream info dump (the reference CLI's probe/banner output role)."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        data = f.read()
    if ext == ".act":
        from .containers import act
        frames, rate, dur = act.demux(data)
        print(f"Input: ACT, G.729A mono {rate} Hz")
        print(f"  {len(frames)} frames ({len(frames) * 10} ms), "
              f"recorded duration {dur / 100:.2f} s")
        return 0
    if ext == ".avi":
        from .containers import avi
        for st in avi.demux(data):
            if st.kind == "video":
                print(f"Stream: video {st.codec!r} {st.width}x{st.height} "
                      f"{st.fps_num}/{st.fps_den} fps, {len(st.chunks)} frames")
            else:
                print(f"Stream: audio fmt={st.codec!r} {st.sample_rate} Hz "
                      f"{st.channels}ch {st.bits}bit, {len(st.chunks)} chunks")
        return 0
    from .containers import riff
    s = riff.demux(data)
    i = s.info
    n_samples = sum(2 * max(len(c) - 8, 0) for c in s.audio_chunks)
    print(f"Input: AMV, {i.width}x{i.height} @ {i.fps_num} fps, "
          f"duration {i.duration_sec} s")
    print(f"  Stream 0: video (AMV MJPEG-variant), {len(s.video_chunks)} frames")
    print(f"  Stream 1: audio (IMA-ADPCM AMV), mono {i.sample_rate} Hz, "
          f"{len(s.audio_chunks)} chunks, {n_samples} samples")
    return 0


def _decode(args):
    from .pipeline.decode import decode_file
    from .containers import wav
    src = args.inputs[0]
    out = args.output
    ext = os.path.splitext(out)[1].lower()
    src_ext = os.path.splitext(src)[1].lower()

    if src_ext == ".act":
        # ACT -> G.729A decode -> WAV/ITU-bitstream (the ffmpeg -i test.act path)
        from .containers import act as actmod
        with open(src, "rb") as f:
            data = f.read()
        frames, rate, _ = actmod.demux(data)
        if args.max_frames:
            frames = frames[:args.max_frames]
        if ext == ".bit":
            with open(out, "wb") as f:
                f.write(actmod.to_itu_bitstream(frames))
            print(f"wrote {out}: {len(frames)} ITU serial frames")
            return 0
        from .codecs import g729a
        arr = np.frombuffer(b"".join(frames), np.uint8).reshape(-1, 1, 10)
        pcm = g729a.decode_streams(arr)[0]
        wav.write_pcm(out, pcm, rate, 1)
        print(f"wrote {out}: {len(pcm)} samples @ {rate} Hz (G.729A)")
        return 0

    if ext == ".wav":
        if args.acodec == "copy":
            # amvlib's raw-ADPCM export: stream-copy the '01wb' payloads
            # (8-byte chunk headers included) under wFormatTag=0x11
            from .containers import riff
            s = riff.read(src)
            chunks = s.audio_chunks[args.seek:]
            if args.max_frames:
                chunks = chunks[:args.max_frames]
            wav.write_adpcm_raw(out, chunks, s.info.sample_rate)
            print(f"wrote {out}: {len(chunks)} raw ADPCM chunks @ "
                  f"{s.info.sample_rate} Hz (stream copy)")
            return 0
        dec = decode_file(src, video=False, max_frames=args.max_frames,
                          start_frame=args.seek)
        wav.write_pcm(out, dec.pcm, dec.info.sample_rate, dec.info.channels)
        print(f"wrote {out}: {len(dec.pcm)} samples @ {dec.info.sample_rate} Hz")
        return 0

    if ext in (".jpg", ".jpeg"):
        from .containers import riff
        s = riff.read(src)
        n = len(s.video_chunks[:args.max_frames] if args.max_frames
                else s.video_chunks)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        for i in range(n):
            _export_jpeg(out % i if "%" in out else out,
                         s.video_chunks[i], s.info.width, s.info.height)
            if "%" not in out:
                break
        print(f"wrote {n if '%' in out else 1} JPEG frame(s)")
        return 0

    if ext == ".avi" and args.vcodec == "copy":
        # stream copy: wrap each stored AMV scan with the canned JPEG
        # header (exactly what sp5x_decode_frame prepends, sp5xdec.c:50-88)
        # and mux as MJPG.  No video re-encode; frames remain bottom-up
        # as stored in the container (the flip lives in the decoders).
        from .containers import avi, riff
        from .bitstream.jpeg_tables import canned_jpeg_header
        s = riff.read(src)
        vchunks = s.video_chunks[args.seek:]
        if args.max_frames:
            vchunks = vchunks[:args.max_frames]
        hdr = canned_jpeg_header(s.info.width, s.info.height)
        chunks = [hdr + c[2:len(c) - 2] + b"\xFF\xD9" for c in vchunks]
        dec = decode_file(src, video=False, max_frames=args.max_frames,
                          start_frame=args.seek)
        geom = np.zeros((len(chunks), s.info.height, s.info.width), np.uint8)
        data = avi.mux(geom, geom, geom, dec.pcm, fps=s.info.fps_num,
                       sample_rate=s.info.sample_rate, video_chunks=chunks)
        with open(out, "wb") as f:
            f.write(data)
        print(f"wrote {out}: {len(chunks)} frames MJPG (stream copy) + PCM")
        return 0

    dec = decode_file(src, max_frames=args.max_frames, start_frame=args.seek)
    if ext == ".avi":
        from .containers import avi
        chunks = None
        if args.vcodec == "mjpeg":
            # mjpegenc.c generic (non-AMV) path: full DQT/DHT/SOF0/SOS
            # headers + escaped scan per frame, muxed as MJPG
            from .codecs.mjpeg import encode_mjpeg_frames
            chunks = encode_mjpeg_frames(dec.y, dec.cb, dec.cr,
                                         qscale=args.qscale or 2)
        data = avi.mux(dec.y, dec.cb, dec.cr, dec.pcm,
                       fps=dec.info.fps_num, sample_rate=dec.info.sample_rate,
                       video_chunks=chunks)
        with open(out, "wb") as f:
            f.write(data)
        print(f"wrote {out}: {dec.y.shape[0]} frames "
              f"{'MJPG' if chunks else 'I420'} + PCM")
        return 0
    if ext == ".yuv":
        with open(out, "wb") as f:
            for fidx in range(dec.y.shape[0]):
                f.write(dec.y[fidx].tobytes())
                f.write(dec.cb[fidx].tobytes())
                f.write(dec.cr[fidx].tobytes())
        print(f"wrote {out}: {dec.y.shape[0]} frames "
              f"{dec.info.width}x{dec.info.height} yuv420p")
        return 0
    if ext in (".rgb", ".raw"):
        import numpy as _np
        from .kernels import yuv2rgb_dither as y2r
        fmt = args.pix_fmt or "rgb24"
        if fmt == "yuyv422":
            frames = _np.asarray(y2r.yuv420_to_yuyv422(dec.y, dec.cb,
                                                       dec.cr))
        elif fmt == "uyvy422":
            frames = _np.asarray(y2r.yuv420_to_uyvy422(dec.y, dec.cb,
                                                       dec.cr))
        else:
            kfmt = "monoblack" if fmt == "monob" else fmt
            frames = _np.asarray(y2r.yuv420_to_packed(
                dec.y, dec.cb, dec.cr, fmt=kfmt))
            if frames.dtype == _np.uint16:
                frames = frames.astype("<u2")   # LE like the reference
            elif frames.dtype == _np.uint32:
                frames = frames.astype("<u4")
        with open(out, "wb") as f:
            for fidx in range(frames.shape[0]):
                f.write(frames[fidx].tobytes())
        print(f"wrote {out}: {frames.shape[0]} frames "
              f"{dec.info.width}x{dec.info.height} {fmt}")
        return 0
    if ext == ".bmp":
        from .kernels.color import yuv420_to_rgb
        rgb = yuv420_to_rgb(dec.y, dec.cb, dec.cr, mode=args.color)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        for i in range(rgb.shape[0]):
            _write_bmp(out % i if "%" in out else out, rgb[i])
            if "%" not in out:
                break
        print(f"wrote {rgb.shape[0] if '%' in out else 1} BMP frame(s)")
        return 0
    raise SystemExit(f"unsupported output format: {ext}")


def _encode(args):
    from .pipeline.encode import encode_to_file
    from .containers import wav
    if args.size:
        w, h = map(int, args.size.lower().split("x"))
    else:
        w = h = None  # AMV/AVI inputs carry geometry; raw YUV needs -s
    yuv_path = wav_path = avi_path = amv_path = None
    for src in args.inputs:
        e = os.path.splitext(src)[1].lower()
        if e == ".wav":
            wav_path = src
        elif e == ".avi":
            avi_path = src
        elif e == ".amv":
            amv_path = src
        else:
            yuv_path = src
    pcm = None
    if amv_path:
        # AMV -> AMV with -s/-psnr: full decode -> rescale -> re-encode
        # (the reference CLI inserts sws_scale whenever -s differs,
        # ffmpeg.c:757; the fused requantize path can't rescale)
        from .pipeline.decode import decode_file
        dec = decode_file(amv_path, max_frames=args.max_frames,
                          start_frame=args.seek)
        y, cb, cr, pcm = dec.y, dec.cb, dec.cr, dec.pcm
        if w is None:
            w, h = dec.info.width, dec.info.height
        if (dec.info.width, dec.info.height) != (w, h):
            import jax.numpy as jnp
            from .kernels.scale import resize_yuv420
            print(f"rescaling {dec.info.width}x{dec.info.height} -> "
                  f"{w}x{h} ({args.sws_flags})")
            y, cb, cr = (np.asarray(p) for p in resize_yuv420(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), h, w,
                filt=args.sws_flags))
        if dec.info.sample_rate != args.sample_rate and len(pcm):
            from .kernels.resample import resample_pcm
            print(f"resampling audio {dec.info.sample_rate} -> "
                  f"{args.sample_rate} Hz")
            pcm = resample_pcm(pcm, dec.info.sample_rate, args.sample_rate)
        n_frames = y.shape[0]
    elif avi_path:
        from .containers import avi as avimod
        streams = avimod.read(avi_path)
        vstreams = [st for st in streams if st.kind == "video"]
        astreams = [st for st in streams if st.kind == "audio"]
        if not vstreams:
            raise SystemExit("AVI input has no video stream")
        vst = vstreams[0]
        if args.seek:
            # index-based seek (idx1/ODML when present): back up to the
            # nearest keyframe like avi_read_seek (avidec.c:933-1012)
            start = avimod.seek_frame(vst, args.seek)
            vst.chunks = vst.chunks[start:]
            vst.index = vst.index[start:]
        if args.max_frames:
            vst.chunks = vst.chunks[:args.max_frames]
        y, cb, cr = avimod.extract_yuv420(vst)
        # the reference CLI rescales any input to -s (sws_scale,
        # ffmpeg.c:757); separable polyphase resize on device
        if args.size and (vst.width, vst.height) != (w, h):
            import jax.numpy as jnp
            from .kernels.scale import resize_yuv420
            print(f"rescaling {vst.width}x{vst.height} -> {w}x{h} "
                  f"({args.sws_flags})")
            y, cb, cr = (np.asarray(p) for p in resize_yuv420(
                jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), h, w,
                filt=args.sws_flags))
        else:
            w, h = vst.width, vst.height
        if astreams and astreams[0].codec == b"\x01\x00":
            pcm = avimod.extract_pcm(astreams[0])
            in_rate = astreams[0].sample_rate or args.sample_rate
            if in_rate != args.sample_rate:
                from .kernels.resample import resample_pcm
                print(f"resampling audio {in_rate} -> {args.sample_rate} Hz")
                pcm = resample_pcm(pcm, in_rate, args.sample_rate)
        n_frames = y.shape[0]
    else:
        if yuv_path is None:
            raise SystemExit("encode requires a raw .yuv or .avi input")
        if w is None:
            raise SystemExit("raw YUV encode requires -s WxH")
        frame_bytes = w * h * 3 // 2
        raw = open(yuv_path, "rb").read()
        n_frames = len(raw) // frame_bytes
        if args.max_frames:
            n_frames = min(n_frames, args.max_frames)
        y = np.empty((n_frames, h, w), np.uint8)
        cb = np.empty((n_frames, h // 2, w // 2), np.uint8)
        cr = np.empty((n_frames, h // 2, w // 2), np.uint8)
        for i in range(n_frames):
            o = i * frame_bytes
            y[i] = np.frombuffer(raw, np.uint8, w * h, o).reshape(h, w)
            cb[i] = np.frombuffer(raw, np.uint8, w * h // 4, o + w * h).reshape(h // 2, w // 2)
            cr[i] = np.frombuffer(raw, np.uint8, w * h // 4, o + w * h * 5 // 4).reshape(h // 2, w // 2)
    if pcm is None and wav_path:
        pcm, rate = wav.read_pcm(wav_path)
        if pcm.ndim > 1:
            pcm = pcm.mean(axis=1).astype(np.int16)
        if rate != args.sample_rate:
            # the reference CLI resamples to -ar (resample2.c via
            # do_audio_out); polyphase resampler on device
            from .kernels.resample import resample_pcm
            print(f"resampling audio {rate} -> {args.sample_rate} Hz")
            pcm = resample_pcm(pcm, rate, args.sample_rate)
    if pcm is None:
        pcm = np.zeros(n_frames * args.sample_rate // args.fps, np.int16)
    size = encode_to_file(args.output, y, cb, cr, pcm, fps=args.fps,
                          sample_rate=args.sample_rate, qscale=args.qscale,
                          trellis=args.trellis, quant=args.amv_quant)
    print(f"wrote {args.output}: {size} bytes, {n_frames} frames")
    if args.psnr:
        # CODEC_FLAG_PSNR summary (mpegvideo_enc.c accumulates per-plane
        # SSE and prints mean PSNR at close); we decode the file back
        from .pipeline.decode import decode_file
        dec = decode_file(args.output, audio=False)
        sse = [float(np.sum((p.astype(np.int64) - q.astype(np.int64)) ** 2))
               for p, q in ((dec.y, y), (dec.cb, cb), (dec.cr, cr))]
        cnt = [float(p.size) for p in (y, cb, cr)]
        def db(s, n):
            return 99.99 if s == 0 else min(
                99.99, 10 * np.log10(255.0 * 255.0 * n / s))
        print(f"PSNR Mean Y:{db(sse[0], cnt[0]):2.2f} "
              f"U:{db(sse[1], cnt[1]):2.2f} V:{db(sse[2], cnt[2]):2.2f} "
              f"All:{db(sum(sse), sum(cnt)):2.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
