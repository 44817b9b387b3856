"""Streaming transcription from a WAV file or the microphone (the port's
counterpart of ``examples/run_streaming.py``).

Reads the microphone (if sounddevice is installed) or a WAV file in 0.05 s
steps, feeds the streaming pipeline, and renders committed (green) /
assumption (yellow) words in place. Runs on the card unless ``--cpu``.

Usage:
    python -m thewhisper_tpu_torch.run_streaming --model /path/to/checkpoint \
        --file a.wav [--chunk-length 10] [--no-vad] [--no-realtime] [--cpu]
"""

from __future__ import annotations

import argparse

GREEN = "\x1b[32m"
YELLOW = "\x1b[33m"
RESET = "\x1b[0m"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--file", default=None, help="WAV file (default: microphone)")
    ap.add_argument("--chunk-length", type=int, default=10,
                    choices=[10, 15, 20, 30])
    ap.add_argument("--language", default="en")
    ap.add_argument("--step", type=float, default=0.05)
    ap.add_argument("--no-vad", action="store_true")
    ap.add_argument("--no-realtime", action="store_true",
                    help="process the file as fast as possible")
    ap.add_argument("--cpu", action="store_true",
                    help="run the model on the CPU instead of the card")
    args = ap.parse_args(argv)

    from thewhisper_tpu_torch.streaming import (
        FileStream,
        MicStream,
        StdoutStream,
        StreamingPipeline,
    )

    pipe = StreamingPipeline(
        model=args.model,
        chunk_length_s=args.chunk_length,
        language=args.language,
        use_vad=not args.no_vad,
        device="cpu" if args.cpu else "cuda",
    )
    if args.file:
        stream = FileStream(args.file, step_size_s=args.step,
                            real_time=not args.no_realtime)
    else:
        stream = MicStream(step_size_s=args.step)

    out = StdoutStream()
    try:
        while True:
            chunk = stream.next_chunk()
            if chunk is None:
                break
            committed, assumption = pipe(chunk)
            colored_committed = [
                {"text": GREEN + w["text"] + RESET} for w in committed]
            colored_assumption = [
                {"text": YELLOW + w["text"] + RESET} for w in assumption]
            out.write(colored_committed, colored_assumption)
    except KeyboardInterrupt:
        pass
    finally:
        out.close()
        stream.close()


if __name__ == "__main__":
    main()
