"""Distill a speculative-decoding draft from a Whisper checkpoint (the
port's counterpart of ``examples/run_distill.py``).

Initializes a shallow draft from the target's first N decoder layers
(``engine.speculative.make_layer_skip_draft``), trains it to imitate the
target decoder's logits over the shared encoder states
(``training/distill.py``), reports held-out draft/target greedy agreement
(the statistic the speculative acceptance rate tracks), and saves a
decoder-only draft (``<out>.npz`` + ``<out>.json``, JAX's format) that
``WhisperEngine.from_checkpoint(model, draft="<out>")`` of either package
loads. Runs on the card unless ``--cpu``.

Data: a jsonl manifest ``{"audio": wav_path, "text": str}`` per line; with
``--self-label`` the teacher transcribes its own target tokens instead.

Usage:
    python -m thewhisper_tpu_torch.run_distill --model /ckpt \
        --manifest train.jsonl --layers 2 --steps 200 --out /drafts/turbo2 \
        [--cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="HF checkpoint directory")
    ap.add_argument("--manifest", required=True, help="jsonl {audio, text}")
    ap.add_argument("--out", required=True, help="output draft path (.npz)")
    ap.add_argument("--layers", type=int, default=2,
                    help="decoder layers in the draft")
    ap.add_argument("--chunk-length", type=int, default=10,
                    choices=[10, 15, 20, 30])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=1e-4)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--language", default="en")
    ap.add_argument("--max-tokens", type=int, default=96)
    ap.add_argument("--holdout", type=int, default=2,
                    help="manifest samples held out for the agreement eval")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--self-label", action="store_true",
                    help="ignore manifest text; teacher transcribes "
                         "its own target tokens for each window")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
    from thewhisper_tpu_torch.audio.io import load_audio
    from thewhisper_tpu_torch.config import GenerationOptions, LANGUAGES, SpecialTokens
    from thewhisper_tpu_torch.engine import WhisperEngine
    from thewhisper_tpu_torch.engine.speculative import (
        make_layer_skip_draft,
        save_draft,
    )
    from thewhisper_tpu_torch.models.load import load_checkpoint
    from thewhisper_tpu_torch.pipeline import _try_load_hf_tokenizer
    from thewhisper_tpu_torch.training import (
        greedy_agreement,
        init_distill_state,
        make_distill_step,
    )

    device = "cpu" if args.cpu else "cuda"
    teacher, arch = load_checkpoint(args.model, device=device,
                                    chunk_length_s=args.chunk_length)
    student = make_layer_skip_draft(teacher, args.layers)
    print(f"draft: {args.layers} of {arch.decoder_layers} decoder layers")

    sp = SpecialTokens.for_vocab(arch.vocab_size)
    lang_id = sp.language_id(args.language, LANGUAGES[: sp.n_languages])
    prompt = [sp.sot, lang_id, sp.transcribe, sp.no_timestamps]
    featurizer = LogMelFeaturizer(n_mels=arch.n_mels,
                                  chunk_length_s=args.chunk_length, device=device)

    tokenizer = engine = None
    if args.self_label:
        engine = WhisperEngine(teacher)
    else:
        tokenizer = _try_load_hf_tokenizer(args.model)
        if tokenizer is None:
            raise SystemExit(
                "checkpoint has no tokenizer files (use --self-label)")

    samples = []
    with open(args.manifest) as f:
        for line in f:
            item = json.loads(line)
            mel = featurizer(load_audio(item["audio"]))[0]
            if args.self_label:
                res = engine.transcribe_features(
                    mel[None], GenerationOptions(
                        max_new_tokens=args.max_tokens - len(prompt) - 1,
                        language=args.language))
                gen = res.tokens[0, len(prompt): len(prompt) + int(res.num_generated[0])]
                ids = prompt + [int(t) for t in gen] + [sp.eot]
            else:
                enc_ids = tokenizer.encode(item["text"], add_special_tokens=False)
                ids = (prompt + list(enc_ids[: args.max_tokens - len(prompt) - 1])
                       + [sp.eot])
            samples.append((mel, ids))
    if args.holdout < 0 or len(samples) <= args.holdout:
        raise SystemExit("manifest too small for the requested holdout")
    held, train = samples[: args.holdout], samples[args.holdout:]
    print(f"{len(train)} train / {len(held)} held-out samples")

    seq_len = args.max_tokens

    def pack(batch_samples):
        b = len(batch_samples)
        tokens = np.full((b, seq_len), sp.eot, np.int64)
        mask = np.zeros((b, seq_len), np.float32)
        for bi, (_, ids) in enumerate(batch_samples):
            ids = ids[:seq_len]
            tokens[bi, : len(ids)] = ids
            mask[bi, len(prompt): len(ids)] = 1.0
        return {"mel": torch.stack([s[0] for s in batch_samples]),
                "tokens": torch.from_numpy(tokens).to(device),
                "loss_mask": torch.from_numpy(mask).to(device)}

    eval_batch = pack(held) if held else None
    agree0 = None
    if eval_batch is not None:
        agree0 = float(greedy_agreement(student, teacher, eval_batch))
        print(f"held-out draft/target greedy agreement before: {agree0:.3f}")

    state, tx = init_distill_state(student, learning_rate=args.learning_rate)
    step = make_distill_step(tx, temperature=args.temperature)
    rng = np.random.default_rng(0)
    for it in range(args.steps):
        idx = rng.integers(0, len(train), args.batch_size)
        state, loss = step(state, teacher, pack([train[i] for i in idx]))
        if it % 20 == 0 or it == args.steps - 1:
            print(f"step {it:5d}  kl {float(loss):.5f}")

    if eval_batch is not None:
        agree1 = float(greedy_agreement(state.student, teacher, eval_batch))
        print(f"held-out agreement after: {agree1:.3f} (was {agree0:.3f})")
    save_draft(args.out, state.student)
    print(f"draft written to {args.out}(.npz/.json): use with "
          f'WhisperEngine.from_checkpoint(model, draft="{args.out}")')


if __name__ == "__main__":
    main()
