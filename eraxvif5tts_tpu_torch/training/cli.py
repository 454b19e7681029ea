"""Training entry points (port of `eraxvif5tts_tpu/training/cli.py`).

- ``train_main``: YAML-config training (reference `src/f5_tts/train/train.py:16-86`,
  hydra replaced with the typed config tree).
- ``finetune_main``: argparse finetune/from-scratch CLI with the experiment presets
  including the pruned students (reference `train/finetune_cli.py:192-498`,
  presets `:222-249`), vocab extension (`:287-305`), the duration-predictor
  curriculum (`:349-361`), the xavier-family scratch init (`:26-97`),
  per-save sample synthesis (`trainer.py:1387-1419`), and mid-epoch resume
  (`trainer.py:1196-1206`).

Both run on the card unless ``--device cpu`` is given. Config knobs are
honored or loudly refused, never silently ignored: ``batch_size_type:
sample`` batches by sample count, ``logger: wandb`` falls back with a printed
line when wandb is missing, ``bnb_optimizer: true`` raises (the port always
uses its AdamW). The JAX package's ``--scan-layers`` (a compile-time mode)
is left out, as in the port's servers.

Several devices: one process a device, started by ``torchrun`` (or in a
process group the caller initialised), e.g. ``torchrun --nproc-per-node 8 -m
eraxvif5tts_tpu_torch.training.cli finetune ... --n-model 2 --zero1``. The
trainer then runs on a ``(data, model)`` mesh (`parallel/mesh.py`) over all
the processes, each on ``cuda:LOCAL_RANK``: ``--n-model`` is the tensor-
parallel size, ``--zero1`` (``optim.zero1``) partitions the AdamW moments
and the EMA over ``data``. Every rank loads every global batch and trains
on its rows; with ``--multihost`` each data rank loads only its own
batches instead (:func:`multihost_epoch_batches`, the JAX per-process
striding, here over data ranks: the model peers of a rank load the same).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from eraxvif5tts_tpu_torch.configs import (
    PRESETS,
    TrainConfig,
    load_yaml_config,
    resolve_remat_policy,
)
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.parallel import mesh as pm
from eraxvif5tts_tpu_torch.text.tokenizer import get_tokenizer
from eraxvif5tts_tpu_torch.training.dataset import (
    TRAIN_FRAME_BUCKETS,
    TRAIN_TEXT_BUCKETS,
    CustomDataset,
    DynamicBatchSampler,
    collate,
    load_dataset,
    prefetch_batches,
    sample_phonemes,
)
from eraxvif5tts_tpu_torch.training.trainer import Trainer, make_optimizer

# sample-count batching packs up to this many frames before max_samples kicks in
# (i.e. never, for realistic sample counts) — see DatasetConfig.batch_size_type.
_UNBOUNDED_FRAMES = 1 << 30


def training_mesh(n_model: int = 1, device: str | torch.device = "cuda"):
    """The trainer's mesh: None on one process (no process group, no
    ``torchrun`` environment, ``n_model`` 1), else a ``(data, model)`` mesh
    over every process (the group is initialised from ``torchrun``'s
    environment when there is none)."""
    world = int(os.environ.get("WORLD_SIZE", 1))
    if n_model == 1 and not dist.is_initialized() and world == 1:
        return None
    return pm.make_mesh(n_model=n_model, device_type=torch.device(device).type)


def build_sampler(dataset, cfg: TrainConfig, seed: int) -> DynamicBatchSampler:
    """Frame-budget packing, or fixed sample-count batches when the config says
    ``batch_size_type: sample`` (reference `trainer.py:1137-1170` branches on it)."""
    frame_lengths = [dataset.frame_length(i) for i in range(len(dataset))]
    if cfg.datasets.batch_size_type == "sample":
        return DynamicBatchSampler(
            frame_lengths, _UNBOUNDED_FRAMES,
            max_samples=cfg.datasets.batch_size_per_gpu, random_seed=seed,
        )
    if cfg.datasets.batch_size_type != "frame":
        raise ValueError(
            f"batch_size_type must be 'frame' or 'sample', got "
            f"{cfg.datasets.batch_size_type!r}"
        )
    return DynamicBatchSampler(
        frame_lengths, cfg.datasets.batch_size_per_gpu,
        max_samples=cfg.datasets.max_samples, random_seed=seed,
    )


def build_trainer(cfg: TrainConfig, vocab_size: int, total_updates: int,
                  checkpoint_dir: Optional[str] = None, n_model: int = 1,
                  duration_predictor=None, duration_focus_updates: int = 12000,
                  phoneme_map: Optional[dict] = None,
                  device: str | torch.device = "cuda", mesh=None) -> Trainer:
    """The trainer of ``cfg`` with a fresh backbone (fp32 parameters,
    ``compute_dtype`` compute) on ``device``: on a mesh (``mesh``, or
    :func:`training_mesh` of ``n_model``) on this process's card
    (``cuda:LOCAL_RANK``), with ZeRO-1 when ``optim.zero1``."""
    if mesh is None:
        mesh = training_mesh(n_model, device)
    if mesh is not None and torch.device(device).type == "cuda":
        device = pm.local_device()
    if cfg.optim.bnb_optimizer:
        raise ValueError(
            "bnb_optimizer=true (bitsandbytes' 8-bit AdamW) is not used: the port "
            "always trains with its own AdamW — drop the flag from the config")
    if cfg.model.compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(
            f"compute_dtype {cfg.model.compute_dtype!r}: training supports "
            "'bfloat16' or 'float32'")
    if cfg.optim.mu_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(
            f"optim.mu_dtype must be null|float32|bfloat16, got {cfg.optim.mu_dtype!r}")
    if cfg.model.arch.remat_policy == "auto" and cfg.model.arch.checkpoint_activations:
        # frame-budget batching: batch_size_per_gpu IS the per-card frame
        # count; sample batching has no frame bound, so stay conservative
        per_chip = (cfg.datasets.batch_size_per_gpu
                    if cfg.datasets.batch_size_type == "frame" else None)
        policy = resolve_remat_policy("auto", per_chip)
        note = ""
        if policy != "full":  # the port checkpoints whole blocks only
            policy, note = "full", f" ({policy!r} is not ported: whole blocks, 'full')"
        print(f"[trainer] remat_policy auto -> {policy!r}{note} "
              f"(per-card frame budget {per_chip})")
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(
                cfg.model, arch=dataclasses.replace(cfg.model.arch, remat_policy=policy)))

    dtype = torch.bfloat16 if cfg.model.compute_dtype == "bfloat16" else torch.float32
    transformer = build_backbone(cfg.model, text_num_embeds=vocab_size, compute_dtype=dtype)
    optimizer = make_optimizer(
        learning_rate=cfg.optim.learning_rate,
        num_warmup_updates=cfg.optim.num_warmup_updates,
        total_updates=total_updates,
        max_grad_norm=cfg.optim.max_grad_norm,
        mu_dtype=cfg.optim.mu_dtype,
    )
    return Trainer(
        cfm=CFM(transformer.to(device)),
        optimizer=optimizer,
        grad_accumulation_steps=cfg.optim.grad_accumulation_steps,
        checkpoint_dir=checkpoint_dir or cfg.ckpts.save_dir,
        keep_last_n_checkpoints=cfg.ckpts.keep_last_n_checkpoints,
        duration_predictor=duration_predictor,
        duration_focus_updates=duration_focus_updates,
        phoneme_map=phoneme_map,
        mesh=mesh,
        zero1=cfg.optim.zero1,
    )


def epoch_batches(dataset: CustomDataset, sampler: DynamicBatchSampler,
                  vocab_char_map: dict, epoch: int, tokenize=None,
                  phoneme_map: Optional[dict] = None, executor=None):
    """One epoch of collated bucketed batches (generator).

    ``executor`` (a ThreadPoolExecutor) parallelizes the per-sample fetch —
    on audio-path datasets each ``dataset[i]`` runs a host mel FFT."""
    sampler.set_epoch(epoch)
    for batch_indices in sampler:
        if executor is not None:
            samples = list(executor.map(dataset.__getitem__, batch_indices))
        else:
            samples = [dataset[i] for i in batch_indices]
        if any(s.mel is None for s in samples):
            # mels come precomputed or on the fly from audio_path; a None here
            # means unreadable rows — be LOUD, a silent skip once made a whole
            # run train on zero batches
            bad = [i for i, s in zip(batch_indices, samples) if s.mel is None]
            print(f"[dataset] WARNING: skipping batch, no mel for rows {bad[:5]}"
                  f"{'...' if len(bad) > 5 else ''}")
            continue
        yield collate(samples, vocab_char_map, tokenize=tokenize,
                      phoneme_map=phoneme_map)


def multihost_epoch_batches(dataset, sampler, vocab_char_map, epoch, mesh,
                            tokenize=None, phoneme_map=None, executor=None,
                            process_index: Optional[int] = None,
                            process_count: Optional[int] = None,
                            fixed_rows: Optional[int] = None, phoneme_group=None):
    """This data rank's slice of an epoch (the JAX package's per-process
    slice, `eraxvif5tts_tpu/training/cli.py:157-209`).

    Each data rank takes every ``process_count``-th packed batch (the
    reference's DDP dispatches whole batches round-robin the same way) and
    collates it to FIXED shapes (the top frame and text bucket, ``fixed_rows``
    rows), so that every rank's batch has one shape; the tail is trimmed so
    that every rank runs the same number of batches (a ragged last round
    would leave a collective waiting), and a batch with unreadable rows
    raises for the same reason. JAX strides over processes, each loading
    for its local devices; the port runs a process a device and strides
    over the data rank, so model peers load the same batch. The batches are
    :class:`~eraxvif5tts_tpu_torch.parallel.mesh.LocalBatch`es when the mesh
    has more than one data rank (the trainer reads them as this rank's rows
    of a global batch). ``process_index`` / ``process_count`` default to the
    mesh's data rank and size (injectable for tests).

    A growing ``phoneme_map`` would give one phoneme different ids on
    ranks that see different rows: with ``phoneme_group`` (the data peers,
    ``parallel.mesh.new_axis_group``) every round's phonemes are gathered
    from the ranks and grow every rank's map in rank order, the batches'
    order, so all ranks hold the map one process grows over the same
    batches."""
    pi = pm.axis_rank(mesh, "data") if process_index is None else process_index
    pc = pm.axis_size(mesh, "data") if process_count is None else process_count
    if fixed_rows is None:
        fixed_rows = max((len(b) for b in sampler), default=1)
    top_frames = (TRAIN_FRAME_BUCKETS[-1],)
    top_text = (TRAIN_TEXT_BUCKETS[-1],)

    sampler.set_epoch(epoch)
    # the same number of batches for every rank
    usable = (len(sampler) // pc) * pc
    for i, batch_indices in enumerate(sampler):
        if i >= usable or i % pc != pi:
            continue
        if executor is not None:
            samples = list(executor.map(dataset.__getitem__, batch_indices))
        else:
            samples = [dataset[j] for j in batch_indices]
        if any(s.mel is None for s in samples):
            raise RuntimeError(
                f"multi-host batch {i} has unreadable rows: every rank must run the same "
                "number of batches, so a skipped batch would leave the collectives waiting")
        if phoneme_map is not None and phoneme_group is not None:
            share_phonemes(samples, phoneme_map, phoneme_group)
        local = collate(samples, vocab_char_map, tokenize=tokenize, phoneme_map=phoneme_map,
                        frame_buckets=top_frames, text_buckets=top_text,
                        pad_batch_to=fixed_rows)
        yield pm.LocalBatch(local) if pm.axis_size(mesh, "data") > 1 else local


def share_phonemes(samples, phoneme_map: dict, group) -> None:
    """Grow ``phoneme_map`` with every rank of ``group``'s rows of this
    round, in rank order."""
    from eraxvif5tts_tpu_torch.text.phoneme import phoneme_to_indices

    every: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, [sample_phonemes(s) for s in samples], group=group)
    for lists in every:
        for phones in lists:
            phoneme_to_indices(phones, phoneme_map, grow=True)


def batch_iterator(dataset: CustomDataset, sampler: DynamicBatchSampler,
                   vocab_char_map: dict, tokenize=None, epochs: int = 1,
                   phoneme_map: Optional[dict] = None):
    for epoch in range(epochs):
        yield from epoch_batches(dataset, sampler, vocab_char_map, epoch,
                                 tokenize=tokenize, phoneme_map=phoneme_map)


def _make_tokenize(tokenizer: str):
    def tokenize(text):
        if tokenizer == "pinyin":
            from eraxvif5tts_tpu_torch.text.pinyin import convert_char_to_pinyin

            return convert_char_to_pinyin([text])[0] if isinstance(text, str) else text
        return list(text) if isinstance(text, str) else text

    return tokenize


def _run_training(trainer: Trainer, cfg: TrainConfig, dataset, sampler,
                  vocab_char_map, state, seed: int, tokenize=None,
                  phoneme_map: Optional[dict] = None, resume: Optional[str] = None,
                  log_samples: Optional[bool] = None, log_every: int = 100,
                  multihost: bool = False):
    """Shared drive loop: resume (incl. mid-epoch), per-save samples and
    predictor files, loggers, the data pipeline's worker pool and prefetch;
    with ``multihost`` each data rank loads its own batches
    (:func:`multihost_epoch_batches`)."""
    from eraxvif5tts_tpu_torch.models.duration import save_duration_predictor

    main = pm.is_main(trainer.mesh)
    start_epoch = skip_batches = 0
    if resume:
        state = trainer.load_checkpoint(resume, state)
        if trainer.resume_meta:
            start_epoch, skip_batches = trainer.restore_meta(trainer.resume_meta)
        if main:
            print(f"[cli] resuming at epoch {start_epoch}, batch {skip_batches}, "
                  f"update {state.step}")
    n_data = pm.axis_size(trainer.mesh, "data") if multihost else 1
    trainer.set_steps_per_epoch(max(len(sampler) // n_data, 1))
    # the loader's phoneme gathers run on the prefetch thread: a group of their own
    phoneme_group = (pm.new_axis_group(trainer.mesh, "data")
                     if multihost and phoneme_map is not None else None)

    def log_fn(step, metrics):
        print(f"update {step}: " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    sample_fn = None
    if (cfg.ckpts.log_samples if log_samples is None else log_samples):
        from eraxvif5tts_tpu_torch.training.sampling import make_sample_fn, prompts_from_dataset

        prompts = prompts_from_dataset(dataset, count=1)
        if prompts:
            base_sample = make_sample_fn(
                trainer.cfm, vocab_char_map, prompts,
                out_dir=os.path.join(trainer.checkpoint_dir, "samples"),
                tokenize=tokenize,
            )

            def sample_fn(state, step):
                written = base_sample(state, step)
                print(f"[cli] wrote sample artifacts: {written}")
                if state.dur_predictor is not None and phoneme_map is not None:
                    p = os.path.join(trainer.checkpoint_dir, f"duration_predictor_{step}.pt")
                    save_duration_predictor(p, state.dur_predictor, phoneme_map, update=step)
                    print(f"[cli] saved duration predictor: {p}")

    # Input-pipeline overlap (honors datasets.num_workers; the reference gets
    # this from DataLoader workers, `trainer.py:1137-1170`): a producer thread
    # prefetches collated batches and a pool parallelizes per-sample mel FFTs
    # so host prep of batch N+1 hides under the card's update N.
    num_workers = getattr(cfg.datasets, "num_workers", 0)
    executor = None
    if num_workers and num_workers > 1:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=num_workers,
                                      thread_name_prefix="sample-fetch")

    def make_epoch_iter(e):
        if multihost:
            gen = multihost_epoch_batches(dataset, sampler, vocab_char_map, e, trainer.mesh,
                                          tokenize=tokenize, phoneme_map=phoneme_map,
                                          executor=executor, phoneme_group=phoneme_group)
        else:
            gen = epoch_batches(dataset, sampler, vocab_char_map, e, tokenize=tokenize,
                                phoneme_map=phoneme_map, executor=executor)
        return prefetch_batches(gen) if num_workers else gen

    try:
        state = trainer.train(
            state, seed=seed,
            epoch_iter=make_epoch_iter,
            epochs=cfg.optim.epochs, start_epoch=start_epoch, skip_batches=skip_batches,
            log_every=log_every,
            save_per_updates=cfg.ckpts.save_per_updates,
            last_per_updates=cfg.ckpts.last_per_updates,
            log_fn=log_fn, sample_fn=sample_fn, logger=cfg.ckpts.logger,
            tensorboard_dir=(os.path.join(trainer.checkpoint_dir, "runs")
                             if cfg.ckpts.logger == "tensorboard" else None),
        )
    finally:
        if executor is not None:
            executor.shutdown(wait=True, cancel_futures=True)
    trainer.save_checkpoint(state, last=True,
                            meta=trainer._make_meta(cfg.optim.epochs - 1, 0))
    if state.dur_predictor is not None and phoneme_map is not None and main:
        save_duration_predictor(
            os.path.join(trainer.checkpoint_dir, "duration_predictor_last.pt"),
            state.dur_predictor, phoneme_map, update=state.step)
    return state


def _total_updates(sampler, cfg: TrainConfig) -> int:
    return max(len(sampler) * cfg.optim.epochs // cfg.optim.grad_accumulation_steps, 1)


def train_main(argv=None):
    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-train")
    p.add_argument("config", help="YAML config (reference `configs/*.yaml` format)")
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--resume", default=None, help="checkpoint dir/path to resume")
    p.add_argument("--seed", type=int, default=666)  # reference `train.py:86`
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel size: the mesh is (processes / n-model) x n-model")
    p.add_argument("--multihost", action="store_true",
                   help="each data rank loads its own batches (torchrun's environment "
                        "starts the group)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.multihost and not dist.is_initialized():
        pm.init_from_environment(torch.device(args.device).type)
    mesh = training_mesh(args.n_model, args.device)

    cfg = load_yaml_config(args.config)
    tokenizer_path = cfg.model.tokenizer_path or cfg.datasets.name
    vocab_char_map, vocab_size = get_tokenizer(
        tokenizer_path, cfg.model.tokenizer, base_data_path=args.data_dir
    )
    dataset = load_dataset(cfg.datasets.name, cfg.model.tokenizer,
                           data_dir=args.data_dir,
                           mel_spec_kwargs=dataclasses.asdict(cfg.model.mel_spec))
    sampler = build_sampler(dataset, cfg, args.seed)
    trainer = build_trainer(cfg, vocab_size, _total_updates(sampler, cfg), device=args.device,
                            mesh=mesh)
    state = trainer.init_state()
    return _run_training(
        trainer, cfg, dataset, sampler, vocab_char_map, state, args.seed,
        tokenize=_make_tokenize(cfg.model.tokenizer), resume=args.resume,
        multihost=args.multihost,
    )


def finetune_parser() -> argparse.ArgumentParser:
    """The finetune / from-scratch CLI's arguments (``finetune_main``'s; the
    project manager's ``settings_to_cli_args`` writes argv for it)."""
    p = argparse.ArgumentParser(prog="eraxvif5tts-torch-finetune")
    p.add_argument("--exp_name", default="F5TTS_v1_Base",
                   choices=list(PRESETS) + ["F5TTS_v1_Custom_Prune_14", "F5TTS_v1_Custom_Prune_12"])
    p.add_argument("--dataset_name", required=True)
    p.add_argument("--pretrain", default=None, help="source checkpoint (.pt/.safetensors)")
    p.add_argument("--tokenizer", default="custom", choices=["pinyin", "char", "custom"])
    p.add_argument("--tokenizer_path", default=None)
    p.add_argument("--data-dir", default="./data")
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--batch_size_per_gpu", type=int, default=3200)
    p.add_argument("--batch_size_type", default="frame", choices=["frame", "sample"])
    p.add_argument("--max_samples", type=int, default=64)
    p.add_argument("--grad_accumulation_steps", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_warmup_updates", type=int, default=20000)
    p.add_argument("--save_per_updates", type=int, default=50000)
    p.add_argument("--last_per_updates", type=int, default=5000)
    p.add_argument("--keep_last_n_checkpoints", type=int, default=-1)
    p.add_argument("--finetune", action="store_true", default=True)
    p.add_argument("--from-scratch", dest="finetune", action="store_false")
    p.add_argument("--use_duration_predictor", action="store_true")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="training matmul dtype; params/optimizer stay float32")
    p.add_argument("--duration_focus_updates", type=int, default=12000)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: the AdamW moments and the EMA partitioned over the data axis")
    p.add_argument("--n-model", type=int, default=1,
                   help="tensor-parallel size: the mesh is (processes / n-model) x n-model")
    p.add_argument("--logger", default="tensorboard",
                   choices=["tensorboard", "wandb", "none"])
    p.add_argument("--log_samples", action="store_true", default=False)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume", default=None, help="checkpoint dir/path to resume")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--multihost", action="store_true",
                   help="each data rank loads its own batches (torchrun's environment "
                        "starts the group)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def finetune_main(argv=None):
    args = finetune_parser().parse_args(argv)
    if args.multihost and not dist.is_initialized():
        pm.init_from_environment(torch.device(args.device).type)
    mesh = training_mesh(args.n_model, args.device)

    # pruned-student presets (reference `finetune_cli.py:222-249`)
    exp = args.exp_name
    if exp == "F5TTS_v1_Custom_Prune_14":
        model_cfg = PRESETS["F5TTS_v1_Pruned_14"]
    elif exp == "F5TTS_v1_Custom_Prune_12":
        model_cfg = PRESETS["F5TTS_v1_Pruned_12"]
    else:
        model_cfg = PRESETS[exp]

    tokenizer_path = args.tokenizer_path or args.dataset_name
    vocab_char_map, vocab_size = get_tokenizer(
        tokenizer_path, args.tokenizer, base_data_path=args.data_dir
    )

    from eraxvif5tts_tpu_torch.configs import CkptConfig, DatasetConfig, OptimConfig

    cfg = TrainConfig(
        model=dataclasses.replace(model_cfg, tokenizer=args.tokenizer,
                                  tokenizer_path=args.tokenizer_path,
                                  compute_dtype=args.compute_dtype),
        optim=OptimConfig(
            epochs=args.epochs, learning_rate=args.learning_rate,
            num_warmup_updates=args.num_warmup_updates,
            grad_accumulation_steps=args.grad_accumulation_steps,
            max_grad_norm=args.max_grad_norm,
            zero1=args.zero1,
        ),
        datasets=DatasetConfig(name=args.dataset_name,
                               batch_size_per_gpu=args.batch_size_per_gpu,
                               batch_size_type=args.batch_size_type,
                               max_samples=args.max_samples),
        ckpts=CkptConfig(save_per_updates=args.save_per_updates,
                         last_per_updates=args.last_per_updates,
                         keep_last_n_checkpoints=args.keep_last_n_checkpoints,
                         logger=None if args.logger == "none" else args.logger,
                         log_samples=args.log_samples,
                         save_dir=args.checkpoint_dir or f"ckpts/{args.exp_name}"),
    )

    dataset = load_dataset(cfg.datasets.name, args.tokenizer, data_dir=args.data_dir,
                           mel_spec_kwargs=dataclasses.asdict(cfg.model.mel_spec))
    sampler = build_sampler(dataset, cfg, args.seed)

    # the reference checkpoint, its vocab table extended if the dataset's vocab
    # outgrew it (`finetune_cli.py:287-305`); a larger table is kept whole
    sd = None
    model_vocab = vocab_size
    if args.finetune and args.pretrain:
        from eraxvif5tts_tpu_torch.compression.convert import (
            _tensors,
            infer_text_num_embeds,
            load_state_dict,
            normalize_reference_state_dict,
        )
        from eraxvif5tts_tpu_torch.compression.pruner import expand_text_embedding

        sd = normalize_reference_state_dict(load_state_dict(args.pretrain))
        ckpt_vocab = infer_text_num_embeds(sd)
        if vocab_size > ckpt_vocab:
            sd = expand_text_embedding(sd, vocab_size)
        model_vocab = max(vocab_size, ckpt_vocab)
        prefix = "transformer."
        sd = _tensors({k[len(prefix):] if k.startswith(prefix) else k: v
                       for k, v in sd.items()})

    # duration-predictor curriculum (reference `finetune_cli.py:349-361`): the
    # predictor is instantiated as (vocab, 512, 32, k=3, p=0.5); phonemes are
    # collated into the batch and the Trainer runs the two-phase focus schedule.
    duration_predictor = None
    phoneme_map: Optional[dict] = None
    if args.use_duration_predictor:
        from eraxvif5tts_tpu_torch.models.duration import (
            DurationPredictor,
            predictor_vocab_size,
        )
        from eraxvif5tts_tpu_torch.text.phoneme import PhonemeMap

        pred_vocab = predictor_vocab_size(vocab_size)
        duration_predictor = DurationPredictor(vocab_size=pred_vocab, d_model=512,
                                               d_filter=32, kernel_size=3, dropout=0.5)
        # collate ids must stay < pred_vocab (outside ids embed as NaN)
        phoneme_map = PhonemeMap(max_index=pred_vocab - 1)

    trainer = build_trainer(cfg, model_vocab, _total_updates(sampler, cfg),
                            mesh=mesh, duration_predictor=duration_predictor,
                            duration_focus_updates=args.duration_focus_updates,
                            phoneme_map=phoneme_map, device=args.device)
    transformer = trainer.cfm.transformer
    if sd is not None:
        transformer.load_state_dict(sd, strict=True)
    elif not args.finetune:
        # xavier-family scratch init (reference `finetune_cli.py:26-97`), before
        # init_state: the EMA and the align copy are then copies of its draws
        from eraxvif5tts_tpu_torch.training.scratch_init import init_weights_tts

        init_weights_tts(transformer, args.seed + 2)
        if duration_predictor is not None:
            init_weights_tts(duration_predictor, args.seed + 3)
    state = trainer.init_state()
    return _run_training(
        trainer, cfg, dataset, sampler, vocab_char_map, state, args.seed,
        tokenize=_make_tokenize(args.tokenizer), phoneme_map=phoneme_map,
        resume=args.resume, multihost=args.multihost,
    )


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "finetune":
        finetune_main(sys.argv[2:])
    else:
        train_main()
