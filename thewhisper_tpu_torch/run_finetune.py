"""Fine-tune a Whisper checkpoint on a local audio manifest (the port's
counterpart of ``examples/run_finetune.py``, on one device: no ``--dp`` or
``--tp``).

Data comes from a jsonl manifest ``{"audio": wav_path, "text": str}`` per
line; the model loads from an HF checkpoint with interpolated positions at
the target chunk length, trains a teacher-forced cross-entropy objective
with AdamW, and is exported as an HF-layout checkpoint marked as a
flexible-chunk fine-tune. Runs on the card unless ``--cpu``.

Usage:
    python -m thewhisper_tpu_torch.run_finetune --model /ckpt \
        --manifest train.jsonl --chunk-length 10 --steps 100 \
        --batch-size 8 --out /tuned_ckpt [--remat] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                   "merges.txt", "normalizer.json", "added_tokens.json",
                   "special_tokens_map.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="HF checkpoint directory")
    ap.add_argument("--manifest", required=True, help="jsonl {audio, text}")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--chunk-length", type=int, default=10,
                    choices=[10, 15, 20, 30])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=1e-5)
    ap.add_argument("--language", default="en")
    ap.add_argument("--max-tokens", type=int, default=128)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--remat", action="store_true",
                    help="recompute layers in the backward pass (less "
                         "activation memory for about a third more work)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="also save the train state every N steps")
    args = ap.parse_args(argv)

    import numpy as np

    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
    from thewhisper_tpu_torch.audio.io import load_audio
    from thewhisper_tpu_torch.config import LANGUAGES, SpecialTokens
    from thewhisper_tpu_torch.models.checkpoint import (
        save_hf_checkpoint,
        save_train_state,
    )
    from thewhisper_tpu_torch.models.load import load_checkpoint
    from thewhisper_tpu_torch.pipeline import _try_load_hf_tokenizer
    from thewhisper_tpu_torch.training import init_train_state, make_train_step
    from thewhisper_tpu_torch.training.train import place_batch

    device = "cpu" if args.cpu else "cuda"
    model, arch = load_checkpoint(
        args.model, device=device, chunk_length_s=args.chunk_length,
        position_mode="interpolate")
    tokenizer = _try_load_hf_tokenizer(args.model)
    if tokenizer is None:
        raise SystemExit("checkpoint has no tokenizer files")

    sp = SpecialTokens.for_vocab(arch.vocab_size)
    lang_id = sp.language_id(args.language, LANGUAGES[: sp.n_languages])
    prompt = [sp.sot, lang_id, sp.transcribe, sp.no_timestamps]
    featurizer = LogMelFeaturizer(n_mels=arch.n_mels,
                                  chunk_length_s=args.chunk_length, device=device)

    # Materialize the dataset (fits for fine-tuning-sized manifests).
    samples = []
    with open(args.manifest) as f:
        for line in f:
            item = json.loads(line)
            audio = load_audio(item["audio"])[: args.chunk_length * 16000]
            ids = tokenizer.encode(item["text"], add_special_tokens=False)
            ids = prompt + list(ids[: args.max_tokens - len(prompt) - 1]) + [sp.eot]
            samples.append((audio, ids))
    if not samples:
        raise SystemExit("empty manifest")
    print(f"{len(samples)} training samples")

    state, tx = init_train_state(model, learning_rate=args.learning_rate)
    train_step = make_train_step(tx, remat=args.remat)
    rng = np.random.default_rng(0)
    seq_len = args.max_tokens

    def make_batch():
        idx = rng.integers(0, len(samples), args.batch_size)
        tokens = np.full((args.batch_size, seq_len), sp.eot, np.int64)
        mask = np.zeros((args.batch_size, seq_len), np.float32)
        padded = np.zeros((args.batch_size, args.chunk_length * 16000), np.float32)
        for bi, i in enumerate(idx):
            padded[bi, : len(samples[i][0])] = samples[i][0]
        for bi, i in enumerate(idx):
            ids = samples[i][1][:seq_len]
            tokens[bi, : len(ids)] = ids
            # Loss on the transcript + EOT, not the forced prompt.
            mask[bi, len(prompt): len(ids)] = 1.0
        return {"mel": featurizer(padded),
                **place_batch({"tokens": tokens, "loss_mask": mask}, device)}

    for it in range(args.steps):
        state, loss = train_step(state, make_batch())
        if it % 10 == 0 or it == args.steps - 1:
            print(f"step {it:5d}  loss {float(loss):.4f}")
        if args.save_every and it and it % args.save_every == 0:
            save_train_state(state, os.path.join(args.out, f"state_{it}.pt"))

    # chunk_length_s marks the export as a flexible-chunk fine-tune, so
    # load_checkpoint truncates positions on reload instead of interpolating.
    save_hf_checkpoint(state.params, arch, args.out,
                       chunk_length_s=args.chunk_length)
    # Carry the tokenizer along so the output directory is self-contained.
    for fname in TOKENIZER_FILES:
        src = os.path.join(args.model, fname)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(args.out, fname))
    print(f"fine-tuned checkpoint written to {args.out}")


if __name__ == "__main__":
    main()
