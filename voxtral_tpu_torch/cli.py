"""Command-line interface of the port (counterpart of `voxtral_tpu/cli.py`,
with the same flags and output), mirroring the reference CLI (main.c:27-43):

  python -m voxtral_tpu_torch.cli -d MODEL_DIR (-i file.wav | --stdin) [options]

  -d DIR        model dir with consolidated.safetensors + tekken.json
  -i FILE.wav   transcribe a WAV file (fed through the streaming engine in
                <=1 s chunks, like main.c:107-119)
  --stdin       stream raw PCM s16le 16 kHz mono from stdin (WAV header
                auto-detected and skipped, main.c:304-381)
  --batch       one-shot batch pipeline instead of the streaming engine
  -I SECONDS    processing interval (default 2.0)
  --delay MS    transcription delay 80..2400 ms (default 480)
  --alt CUTOFF  report up to 4 alternative tokens within CUTOFF
  --continuous  live mode: watchdog auto-restarts (implied by --stdin)
  --monitor     live pipeline symbols on stderr
  --debug / --silent   verbosity
  --parity      f32 compute (bit-parity mode, TF32 off) instead of bf16
  --backend fused|bucketed   streaming backend (fused = B=1 fleet,
                default on CUDA; bucketed on the CPU)
  --kv int8     int8 KV rings for the fused backend; --enc-kv int4
                additionally nibble-packs the ENCODER rings: together
                the serving configuration
  --random-init SEED   synthetic random weights (no model dir needed);
                combine with --tiny for the miniature config (the JAX
                CLI's weights for the same seed)
  --cpu         run on the CPU; without it the run needs CUDA and raises
                on a machine without it
  --profile DIR a torch.profiler trace of the run, DIR/trace.json

Transcription text goes to stdout (streamed); everything else to stderr.
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import time

import numpy as np


def log(args, level, msg):
    if args.verbosity >= level:
        print(msg, file=sys.stderr, flush=True)


def drain(stream, args, out=sys.stdout):
    """Print pending tokens; alt format `[best|alt1|alt2]` (main.c:49-105)."""
    if args.alt is not None:
        for piece, alts in stream.get_alt():
            if alts:
                out.write("[" + "|".join([piece] + alts) + "]")
            else:
                out.write(piece)
    else:
        for piece in stream.get():
            out.write(piece)
    out.flush()


def build(args):
    import torch

    from voxtral_tpu_torch.config import tiny_config, voxtral_4b
    from voxtral_tpu_torch.tokenizer import Tokenizer
    from voxtral_tpu_torch.utils import device_memory_gb

    if args.parity:
        # f32 products stay f32 on the card (no TF32 in matmul or cuDNN)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dtype = torch.float32
    else:
        dtype = torch.bfloat16

    if args.tiny:
        cfg = tiny_config().with_dtype(dtype)
    else:
        cfg = voxtral_4b(param_dtype=dtype, compute_dtype=dtype)

    tokenizer = None
    if args.model_dir:
        tok_path = os.path.join(args.model_dir, "tekken.json")
        if os.path.exists(tok_path):
            t0 = time.time()
            tokenizer = Tokenizer(tok_path)
            log(args, 2, f"tokenizer loaded in {time.time()-t0:.1f}s "
                f"({tokenizer.vocab_size} tokens)")

    t0 = time.time()
    if args.random_init is not None:
        from voxtral_tpu_torch.weights import random_params, random_params_host
        if args.tiny:
            params = random_params_host(cfg, seed=args.random_init,
                                        device=args.device)
        else:
            params = random_params(cfg, seed=args.random_init,
                                   device=args.device)
        log(args, 1, f"random params initialized in {time.time()-t0:.1f}s")
    else:
        from voxtral_tpu_torch.weights import load_params
        path = os.path.join(args.model_dir, "consolidated.safetensors")
        params = load_params(path, cfg, device=args.device)
        log(args, 1, f"model loaded in {time.time()-t0:.1f}s")
    mem = device_memory_gb(args.device)
    if mem:
        # the reference prints its GPU memory gauge after load
        # (voxtral.c:281-283)
        log(args, 1, f"device memory: {mem['hbm_used_gb']} / "
            f"{mem['hbm_limit_gb']} GiB")
    return params, cfg, tokenizer


def open_stream(args, params, cfg, tokenizer, continuous):
    from voxtral_tpu_torch.runtime import StreamConfig, VoxStream
    return VoxStream(params, cfg, tokenizer=tokenizer, stream_cfg=StreamConfig(
        interval=args.interval, delay_tokens=args.delay // 80,
        continuous=continuous, monitor=args.monitor,
        n_alt=4 if args.alt is not None else 1,
        alt_cutoff=args.alt if args.alt is not None else 0.0,
        backend=args.backend, kv_dtype=args.kv,
        enc_kv_dtype=args.enc_kv), device=args.device)


def run_file(args, params, cfg, tokenizer):
    from voxtral_tpu_torch.audio import load_audio

    audio = load_audio(args.input, cfg.audio.sample_rate)
    log(args, 1, f"audio: {len(audio)/cfg.audio.sample_rate:.1f}s")

    if args.batch:
        from voxtral_tpu_torch.models import transcribe_tokens_batch
        t0 = time.time()
        tokens, _ = transcribe_tokens_batch(params, cfg, audio,
                                            delay_tokens=args.delay // 80,
                                            device=args.device)
        dt = time.time() - t0
        text = tokenizer.decode(tokens).strip() if tokenizer else str(tokens)
        print(text)
        log(args, 1, f"batch: {len(tokens)} tokens in {dt:.2f}s "
            f"(RTF {dt/(len(audio)/16000):.3f})")
        return

    s = open_stream(args, params, cfg, tokenizer, args.continuous)
    sr = cfg.audio.sample_rate
    t0 = time.time()
    for i in range(0, len(audio), sr):            # <=1 s chunks
        s.feed(audio[i:i + sr])
        drain(s, args)
    s.finish()
    drain(s, args)
    print(flush=True)
    st = s.stats()
    dt = time.time() - t0
    if st.get("step_ms_includes_encoder"):
        # fused backend: one step covers mel->decode, so encoder/prefill
        # phases are not separately timed (stats() reports None)
        log(args, 1, f"Encoder: {st['mel_frames']} mel -> "
            f"{st['generated']} steps (fused into the step)")
        log(args, 1, f"Decoder: {st['text_tokens']} text tokens "
            f"({st['generated']} steps) in {st['decoder_ms']:.0f} ms "
            f"({st['ms_per_step']:.1f} ms/step incl. encoder)")
    else:
        log(args, 1, f"Encoder: {st['mel_frames']} mel -> "
            f"{st['generated']} steps ({st['encoder_ms']:.0f} ms)")
        log(args, 1, f"Decoder: {st['text_tokens']} text tokens "
            f"({st['generated']} steps) in {st['decoder_ms']:.0f} ms "
            f"(prefill {st['prefill_ms']:.0f} ms "
            f"+ {st['ms_per_step']:.1f} ms/step)")
    log(args, 1, f"RTF: {dt / max(st['audio_s'], 1e-9):.3f}")


def run_stdin(args, params, cfg, tokenizer):
    s = open_stream(args, params, cfg, tokenizer, True)

    stdin = sys.stdin.buffer
    first = stdin.read(4)
    if first == b"RIFF":
        # skip WAV header: read until "data" chunk id (main.c:304-340);
        # a header truncated mid-walk is a hard error (the audio bytes
        # never arrive), reported instead of a silent exit / struct.error
        stdin.read(8)
        while True:
            cid = stdin.read(4)
            sz = stdin.read(4)
            if len(cid) < 4 or len(sz) < 4:
                log(args, 1, "stdin: truncated WAV header, no data chunk")
                return
            (size,) = struct.unpack("<I", sz)
            if cid == b"data":
                break
            stdin.read(size + (size & 1))
        first = b""
    buf = first
    chunk_bytes = int(cfg.audio.sample_rate * 0.25) * 2   # 250 ms
    while True:
        data = stdin.read(chunk_bytes)
        if not data:
            break
        buf += data
        n = len(buf) // 2
        if n == 0:
            continue
        samples = np.frombuffer(buf[:n * 2], dtype="<i2").astype(np.float32) / 32768.0
        buf = buf[n * 2:]
        s.feed(samples)
        drain(s, args)
    s.finish()
    drain(s, args)
    print(flush=True)


def run_mic(args, params, cfg, tokenizer):
    from voxtral_tpu_torch.audio.mic import mic_loop

    s = open_stream(args, params, cfg, tokenizer, True)
    mic_loop(s, lambda st: drain(st, args), rate=cfg.audio.sample_rate,
             log=lambda m: log(args, 1, m))
    print(flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="voxtral_tpu_torch")
    ap.add_argument("-d", "--model-dir", default=None)
    ap.add_argument("-i", "--input", default=None, help="WAV file")
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--from-mic", action="store_true",
                    help="live microphone (arecord/ffmpeg backend)")
    ap.add_argument("--batch", action="store_true")
    ap.add_argument("-I", "--interval", type=float, default=2.0)
    ap.add_argument("--delay", type=int, default=480)
    ap.add_argument("--alt", type=float, default=None)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--monitor", action="store_true")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--silent", action="store_true")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--random-init", type=int, default=None, metavar="SEED")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run to "
                         "DIR/trace.json")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "fused", "bucketed"),
                    help="streaming engine backend: fused = B=1 fleet "
                         "(device mel, one fleet step per chunk; default "
                         "on CUDA), bucketed = general ragged-slice path "
                         "(default on the CPU)")
    ap.add_argument("--kv", default="float", choices=("float", "int8"),
                    help="KV ring storage for the fused backend: float "
                         "keeps weight precision (default); int8 halves "
                         "the decoder rings like the serving fleet")
    ap.add_argument("--enc-kv", default=None,
                    choices=("float", "int8", "int4"),
                    help="ENCODER KV ring storage override for the fused "
                         "backend (default: follow --kv). int4 nibble-"
                         "packs the encoder rings; with --kv int8 and Q8 "
                         "weights this is the serving configuration")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (without it the run needs CUDA)")
    args = ap.parse_args(argv)
    args.device = "cpu" if args.cpu else "cuda"

    args.verbosity = 2 if args.debug else (0 if args.silent else 1)
    args.delay = max(80, min(2400, args.delay))
    if not args.input and not args.stdin and not args.from_mic:
        ap.error("need -i FILE, --stdin, or --from-mic")
    if not args.model_dir and args.random_init is None:
        ap.error("need -d MODEL_DIR or --random-init SEED")

    from voxtral_tpu_torch.utils import resolve_device
    resolve_device(args.device)          # raises without CUDA unless --cpu
    params, cfg, tokenizer = build(args)
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if args.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    try:
        if args.from_mic:
            run_mic(args, params, cfg, tokenizer)
        elif args.stdin:
            run_stdin(args, params, cfg, tokenizer)
        else:
            run_file(args, params, cfg, tokenizer)
    except BrokenPipeError:
        # downstream closed stdout (e.g. | head): exit quietly like any
        # well-behaved pipe citizen
        try:
            sys.stdout.close()
        except OSError:
            pass
        os._exit(0)
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
            log(args, 1, f"profiler trace written to {args.profile}")


if __name__ == "__main__":
    main()
