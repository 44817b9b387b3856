"""Fine-tune a Whisper checkpoint on a local audio manifest (the port's
counterpart of ``examples/run_finetune.py``), on one device or on a
``(dp, tp)`` mesh.

Data comes from a jsonl manifest ``{"audio": wav_path, "text": str}`` per
line; the model loads from an HF checkpoint with interpolated positions at
the target chunk length, trains a teacher-forced cross-entropy objective
with AdamW, and is exported as an HF-layout checkpoint marked as a
flexible-chunk fine-tune. Runs on the card unless ``--cpu``.

The mesh (JAX's ``--dp``/``--tp``): batch rows over ``dp``, heads and the
MLP's hidden width over ``tp`` (``parallel.mesh``). Under ``torchrun`` the
ranks come from its environment (``parallel.launch.init``; dp x tp must
be the world size, JAX's split where a flag is missing); otherwise, with
dp x tp > 1, this process spawns the ranks (``parallel.launch.spawn``).
``--backend nccl`` (the default) takes one card a rank and raises where
there are fewer cards than ranks; ``--backend gloo`` runs several ranks on
one card or on the CPU. Each rank featurizes only its rows (K1 on the
card); rank 0 prints the losses and writes the checkpoint.

Usage:
    python -m thewhisper_tpu_torch.run_finetune --model /ckpt \
        --manifest train.jsonl --chunk-length 10 --steps 100 \
        --batch-size 8 --out /tuned_ckpt [--remat] [--cpu] \
        [--dp 2 --tp 2 [--backend gloo]]
    torchrun --nproc-per-node 4 -m thewhisper_tpu_torch.run_finetune \
        ... --dp 2 --tp 2
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                   "merges.txt", "normalizer.json", "added_tokens.json",
                   "special_tokens_map.json")

# Seconds the spawned ranks of a fine-tune may run.
SPAWN_TIMEOUT_S = 7 * 24 * 3600.0


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--dp", type=int, default=None,
                    help="data-parallel ranks (batch rows)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel ranks (heads, MLP width)")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="collectives: nccl (a card a rank) or gloo "
                         "(several ranks on one card, or the CPU)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU instead of the card")
    ap.add_argument("--remat", action="store_true",
                    help="recompute layers in the backward pass (less "
                         "activation memory for about a third more work)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="also save the train state every N steps")
    return ap


def _check_backend(backend: str, world: int, cpu: bool) -> None:
    """NCCL takes one card a rank: refuse it for CPU ranks and for more
    ranks than cards (``ValueError`` naming gloo) instead of switching."""
    if backend != "nccl" or world == 1:
        return
    import torch

    cards = 0 if cpu else torch.cuda.device_count()
    if cards < world:
        raise ValueError(
            f"--backend nccl takes one card a rank: {world} ranks, {cards} "
            "cards; --backend gloo runs several ranks on one card or on "
            "the CPU")


def main(argv=None):
    """Parse ``argv`` and fine-tune; returns rank 0's
    ``{"losses": [...], "out": dir, "mesh": (dp, tp)}``."""
    args = _parser().parse_args(argv)
    from thewhisper_tpu_torch.parallel import launch
    from thewhisper_tpu_torch.parallel.mesh import mesh_shape

    device = "cpu" if args.cpu else "cuda"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        world = int(os.environ["WORLD_SIZE"])
        dp, tp = mesh_shape(world, args.dp, args.tp)
        _check_backend(args.backend, world, args.cpu)
        launch.init(args.backend, device=device)
        try:
            return _rank(args, dp, tp, device)
        finally:
            dist.destroy_process_group()
    dp, tp = args.dp or 1, args.tp or 1
    if dp * tp == 1:
        return _train(args, None, device)
    _check_backend(args.backend, dp * tp, args.cpu)
    return launch.spawn(_rank, dp * tp, args, dp, tp, device,
                        backend=args.backend, device=device,
                        timeout_s=SPAWN_TIMEOUT_S)[0]


def _rank(args, dp: int, tp: int, device: str):
    """One rank of a meshed fine-tune, its process group up."""
    from thewhisper_tpu_torch.parallel.mesh import local_device, make_mesh

    mesh = make_mesh(dp=dp, tp=tp, device=local_device(device))
    return _train(args, mesh, mesh.device)


def _train(args, mesh, device):
    import numpy as np

    from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
    from thewhisper_tpu_torch.audio.io import load_audio
    from thewhisper_tpu_torch.config import LANGUAGES, SpecialTokens
    from thewhisper_tpu_torch.models.checkpoint import (
        save_hf_checkpoint,
        save_train_state,
    )
    from thewhisper_tpu_torch.models.load import load_checkpoint
    from thewhisper_tpu_torch.parallel.mesh import shard_params
    from thewhisper_tpu_torch.pipeline import _try_load_hf_tokenizer
    from thewhisper_tpu_torch.training import init_train_state, make_train_step
    from thewhisper_tpu_torch.training.train import local_rows, place_batch

    lead = mesh is None or mesh.rank == 0
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
    dp, tp = (1, 1) if mesh is None else mesh.shape
    if lead:
        print(f"{len(samples)} training samples")
        print(f"mesh: dp={dp} tp={tp}", flush=True)
    rows = local_rows(args.batch_size, mesh)
    if mesh is not None:
        shard_params(model, mesh)

    state, tx = init_train_state(model, learning_rate=args.learning_rate)
    train_step = make_train_step(tx, remat=args.remat, mesh=mesh)
    # Every rank draws the same global batch and keeps its dp rows.
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
        return {"mel": featurizer(padded[rows]),
                **place_batch({"tokens": tokens, "loss_mask": mask}, device,
                              mesh)}

    losses = []
    for it in range(args.steps):
        state, loss = train_step(state, make_batch())
        losses.append(float(loss))
        if lead and (it % 10 == 0 or it == args.steps - 1):
            print(f"step {it:5d}  loss {losses[-1]:.4f}", flush=True)
        if args.save_every and it and it % args.save_every == 0:
            save_train_state(state, os.path.join(args.out, f"state_{it}.pt"))

    # chunk_length_s marks the export as a flexible-chunk fine-tune, so
    # load_checkpoint truncates positions on reload instead of interpolating.
    save_hf_checkpoint(state.params, arch, args.out,
                       chunk_length_s=args.chunk_length)
    if lead:
        # Carry the tokenizer along so the output directory is self-contained.
        for fname in TOKENIZER_FILES:
            src = os.path.join(args.model, fname)
            if os.path.exists(src):
                shutil.copyfile(src, os.path.join(args.out, fname))
        print(f"fine-tuned checkpoint written to {args.out}", flush=True)
    return {"losses": losses, "out": args.out, "mesh": (dp, tp)}


if __name__ == "__main__":
    main()
