"""Distillation CLI (port of `eraxvif5tts_tpu/training/distill_cli.py`;
reference `src/f5_tts/train/distil_reload.py:630` ``main``): teacher 22-layer
checkpoint -> pruned student with combined student/distill/spec-l1 losses.
Cosine LR (`:892-897`), checkpoint save/rotate + resume with epoch
back-calculation (`:437-628, 908-921`), the optional duration predictor, and
a final EMA export in the reference torch layout so the student loads into
``F5TTSWrapper``. Runs on the card unless ``--device cpu`` is given: the
teacher in eval mode with its parameters in the compute dtype (the serving
kernels), the student with fp32 parameters in training mode (the training
kernels)."""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os

import torch

from eraxvif5tts_tpu_torch.compression.convert import (
    _tensors,
    infer_depth,
    infer_text_num_embeds,
    load_state_dict,
    normalize_reference_state_dict,
)
from eraxvif5tts_tpu_torch.configs import PRESETS
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.text.tokenizer import get_tokenizer
from eraxvif5tts_tpu_torch.training.cli import epoch_batches
from eraxvif5tts_tpu_torch.training.dataset import DynamicBatchSampler, load_dataset
from eraxvif5tts_tpu_torch.training.distill import DistillConfig, DistillTrainer
from eraxvif5tts_tpu_torch.training.trainer import batch_seed, latest_checkpoint, make_optimizer


def _backbone_state_dict(sd: dict) -> dict:
    prefix = "transformer."
    return _tensors({k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()})


def main(argv=None):
    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-distill")
    p.add_argument("--teacher_ckpt", required=True)
    p.add_argument("--student_ckpt", default=None, help="pruned init (else random)")
    p.add_argument("--student_depth", type=int, default=14)
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--tokenizer", default="custom")
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--num_warmup_updates", type=int, default=1000)
    p.add_argument("--lr_schedule", default="cosine", choices=["cosine", "linear"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size_per_gpu", type=int, default=3200)
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--distill_loss_weight", type=float, default=0.5)
    p.add_argument("--distill_loss_type", default="mse", choices=["mse", "l1"])
    p.add_argument("--spec_l1_weight", type=float, default=0.0)
    p.add_argument("--duration_loss_weight", type=float, default=0.5)
    p.add_argument("--use_duration_predictor", action="store_true")
    p.add_argument("--checkpoint_dir", default="ckpts/distill")
    p.add_argument("--save_per_updates", type=int, default=50000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--resume", default=None, nargs="?", const="auto",
                   help="checkpoint path, or bare --resume for the newest one")
    p.add_argument("--export_path", default=None,
                   help="final EMA export (.safetensors/.pt, reference key layout)")
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="matmul dtype for teacher+student; student params stay float32")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    vocab_char_map, vocab_size = get_tokenizer(
        args.tokenizer_path or args.dataset_name, args.tokenizer,
        base_data_path=args.data_dir,
    )

    teacher_sd = normalize_reference_state_dict(load_state_dict(args.teacher_ckpt))
    teacher_depth = infer_depth(teacher_sd)
    teacher_vocab = infer_text_num_embeds(teacher_sd)
    base = PRESETS["F5TTS_v1_Base"]
    teacher_cfg = dataclasses.replace(
        base, arch=dataclasses.replace(base.arch, depth=teacher_depth))
    student_cfg = dataclasses.replace(
        base, arch=dataclasses.replace(base.arch, depth=args.student_depth))
    cdtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    teacher = build_backbone(teacher_cfg, text_num_embeds=teacher_vocab)
    teacher.load_state_dict(_backbone_state_dict(teacher_sd), strict=True)
    teacher.to(device=args.device, dtype=cdtype)
    del teacher_sd
    student = build_backbone(student_cfg, text_num_embeds=teacher_vocab, compute_dtype=cdtype)
    if args.student_ckpt:
        student_sd = normalize_reference_state_dict(load_state_dict(args.student_ckpt))
        student.load_state_dict(_backbone_state_dict(student_sd), strict=True)
    student.to(args.device)

    dataset = load_dataset(args.dataset_name, args.tokenizer, data_dir=args.data_dir)
    frame_lengths = [dataset.frame_length(i) for i in range(len(dataset))]
    sampler = DynamicBatchSampler(frame_lengths, args.batch_size_per_gpu,
                                  max_samples=args.max_samples, random_seed=args.seed)
    steps_per_epoch = max(len(sampler), 1)
    total_updates = max(steps_per_epoch * args.epochs, 1)

    duration_predictor = None
    if args.use_duration_predictor:
        from eraxvif5tts_tpu_torch.models.duration import (
            DurationPredictor,
            predictor_vocab_size,
        )

        duration_predictor = DurationPredictor(
            vocab_size=predictor_vocab_size(teacher_vocab), d_model=512,
            d_filter=32, kernel_size=3, dropout=0.5).to(args.device)

    trainer = DistillTrainer(
        student_cfm=CFM(student),
        teacher_transformer=teacher,
        optimizer=make_optimizer(learning_rate=args.learning_rate,
                                 num_warmup_updates=args.num_warmup_updates,
                                 total_updates=total_updates,
                                 decay_type=args.lr_schedule),
        config=DistillConfig(
            distill_loss_weight=args.distill_loss_weight,
            distill_loss_type=args.distill_loss_type,
            spec_l1_weight=args.spec_l1_weight,
            duration_loss_weight=args.duration_loss_weight,
        ),
        checkpoint_dir=args.checkpoint_dir,
        keep_last_n_checkpoints=args.keep_last_n_checkpoints,
        duration_predictor=duration_predictor,
        duration_lr=args.learning_rate * 3.0,  # reference `distil_reload.py:846-861`
    )
    state = trainer.init_state()

    # resume with epoch back-calculation (`distil_reload.py:908-921`): the meta
    # sidecar carries the exact (epoch, batch) cursor; without it, derive the
    # epoch from the update count.
    start_epoch = skip_batches = 0
    resume_path = args.resume
    if resume_path == "auto":
        resume_path = latest_checkpoint(args.checkpoint_dir)
    if resume_path:
        state = trainer.load_checkpoint(resume_path, state)
        if trainer.resume_meta:
            start_epoch = trainer.resume_meta.get("epoch", 0)
            skip_batches = trainer.resume_meta.get("batch_in_epoch", 0)
        else:
            start_epoch = state.step // steps_per_epoch
            skip_batches = state.step % steps_per_epoch
        print(f"[distill] resumed update {state.step} "
              f"(epoch {start_epoch}, batch {skip_batches})")

    device = next(student.parameters()).device
    step = state.step
    for epoch in range(start_epoch, args.epochs):
        it = epoch_batches(dataset, sampler, vocab_char_map, epoch)
        batch_idx = 0
        if epoch == start_epoch and skip_batches:
            it = itertools.islice(it, skip_batches, None)
            batch_idx = skip_batches
        for batch in it:
            gen = torch.Generator(device=device).manual_seed(
                batch_seed(args.seed, epoch, batch_idx))
            state, metrics = trainer.train_step(state, batch, gen)
            batch_idx += 1
            step = state.step
            if step % args.log_every == 0:
                print(f"update {step}: " +
                      " ".join(f"{k}={v:.4f}" for k, v in metrics.items() if k != "skipped"))
            if args.save_per_updates and step % args.save_per_updates == 0:
                trainer.save_checkpoint(state, meta={"epoch": epoch, "batch_in_epoch": batch_idx})
        skip_batches = 0

    trainer.save_checkpoint(state, last=True,
                            meta={"epoch": args.epochs - 1, "batch_in_epoch": 0})
    export_path = args.export_path or os.path.join(
        args.checkpoint_dir, f"student_{args.student_depth}L_ema.safetensors")
    trainer.export_student_torch(state, export_path, depth=args.student_depth,
                                 conv_layers=base.arch.conv_layers)
    print(f"[distill] exported EMA student: {export_path}")
    return state


if __name__ == "__main__":
    main()
