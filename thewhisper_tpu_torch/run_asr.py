"""Offline transcription with word timestamps (the port's counterpart of
``examples/run_asr.py``).

Usage:
    python -m thewhisper_tpu_torch.run_asr AUDIO --model /path/to/checkpoint \
        [--model-size S|XL|XL32] [--chunk-length 10|15|20|30] [--language en] \
        [--max-new-tokens 224] [--draft ngram|layer-skip:N|PATH] \
        [--srt out.srt|out.vtt] [--cpu]

As in the reference's examples, the call-time window is ``chunk_length - 1``
seconds with overlap. AUDIO is a WAV, or any container ``ffmpeg`` reads
where it is installed. Runs on the card unless ``--cpu``; without a card it
fails rather than fall back to the CPU. Prints the text, the word chunks as
JSON and the seconds the call took; ``--srt`` also writes subtitles (SRT or
WebVTT by the file's extension).
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("audio")
    ap.add_argument("--model", required=True, help="HF checkpoint directory")
    ap.add_argument("--model-size", default=None,
                    help='"S" (int8), "S-legacy" (int8 decoder), "XL32" '
                         '(f32); any other name, "XL" among them, bf16')
    ap.add_argument("--chunk-length", type=int, default=30,
                    choices=[10, 15, 20, 30])
    ap.add_argument("--language", default="en")
    ap.add_argument("--max-new-tokens", type=int, default=224)
    ap.add_argument("--cpu", action="store_true",
                    help="run the model on the CPU instead of the card")
    ap.add_argument("--srt", default=None, metavar="PATH",
                    help="also write subtitles (.srt or .vtt by extension)")
    ap.add_argument("--draft", default=None,
                    help='speculative decoding: "ngram", "layer-skip:N", '
                         "or a draft checkpoint/.npz (greedy-exact)")
    args = ap.parse_args(argv)

    import torch

    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run_asr runs on the card; pass "
                           "--cpu to run on the CPU")

    from thewhisper_tpu_torch.pipeline import ASRPipeline

    pipeline = ASRPipeline(
        args.model,
        model_size=args.model_size,
        chunk_length_s=args.chunk_length,
        language=args.language,
        device="cpu" if args.cpu else "cuda",
        draft=args.draft,
    )

    t0 = time.perf_counter()
    result = pipeline(
        args.audio,
        return_timestamps="word",
        generate_kwargs={
            "num_beams": 1,
            "language": args.language,
            "max_new_tokens": args.max_new_tokens,
        },
        chunk_length_s=args.chunk_length - 1,
    )
    dt = time.perf_counter() - t0

    print(result["text"])
    print()
    print(json.dumps(result["chunks"], indent=2, default=str))
    if args.srt:
        from thewhisper_tpu_torch.utils.subtitles import write_subtitles

        write_subtitles(args.srt, result.get("chunks", []))
        print(f"\n[subtitles written to {args.srt}]")
    print(f"\n[transcribed in {dt:.2f}s]")
    return result


if __name__ == "__main__":
    main()
