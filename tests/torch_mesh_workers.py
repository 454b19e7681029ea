"""The processes of the port's multi-device tests (`tests/test_torch_mesh*.py`).

Each worker is one rank of a gloo group on the CPU, started by :func:`spawn`
with the ``spawn`` start method and a ``file://`` rendezvous in the test's
temporary directory (never a fixed port: several pytest workers run at
once). This module imports torch, numpy and the port only: the ranks never
import JAX, whose side the tests compute in the parent process. Inputs come
from ``inputs.pt`` in the directory, each rank writes ``out_{rank}.pt``.
"""

from __future__ import annotations

import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from eraxvif5tts_tpu_torch.configs import ArchConfig, MelSpecConfig, ModelConfig
from eraxvif5tts_tpu_torch.models.cfm import CFM, LossDraws
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.parallel import mesh as pm
from eraxvif5tts_tpu_torch.training import trainer as ttr

# dim 64, depth 2, 2 heads x 32, ff_mult 2: TP 2 gives each rank one head
# and 64 feed-forward columns
ARCH = ArchConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                  conv_layers=1, dropout=0.0)
MEL = 8
VOCAB = 8
PRED_VOCAB = 12  # the duration predictor's phoneme table
TIMEOUT = 240


def spawn(target: str, world: int, tmp: str, inputs: dict) -> list[dict]:
    """Run ``target`` (a name in this module) on ``world`` ranks; returns
    each rank's output. Raises if a rank fails or outlasts ``TIMEOUT``."""
    import torch.multiprocessing as mp

    os.makedirs(tmp, exist_ok=True)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_main, args=(target, rank, world, tmp)) for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(TIMEOUT)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [os.path.join(tmp, f"error_{r}.txt") for r in range(world)]
    for path in errors:
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                raise AssertionError(f"rank failed:\n{f.read()}")
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    return [torch.load(os.path.join(tmp, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _main(target: str, rank: int, world: int, tmp: str) -> None:
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/group", rank=rank,
                                world_size=world)
        inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
        out = globals()[target](rank, world, tmp, inputs)
        torch.save(out, os.path.join(tmp, f"out_{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w", encoding="utf-8") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# training


def make_trainer(weights: dict, arch: ArchConfig = ARCH, mesh=None, zero1: bool = False,
                 accumulate: int = 1, checkpoint_dir=None) -> ttr.Trainer:
    dit = DiT(arch, VOCAB, MEL)
    dit.load_state_dict(weights)
    spec = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10, max_grad_norm=0.05)
    return ttr.Trainer(cfm=CFM(dit.train()), optimizer=ttr.make_optimizer(**spec),
                       ema_update_after_step=0, ema_update_every=1, mesh=mesh, zero1=zero1,
                       grad_accumulation_steps=accumulate, checkpoint_dir=checkpoint_dir)


def draws_of(step):
    """A step's draws: a LossDraws (as a dict) or a generator seed."""
    if isinstance(step, int):
        return torch.Generator().manual_seed(step)
    return LossDraws(**step)


def make_curriculum_trainer(weights: dict, dur_weights: dict, arch: ArchConfig,
                            focus_updates: int, mesh=None) -> ttr.Trainer:
    """A trainer with the duration-predictor curriculum (d_model 16, filter
    16) on ``dur_weights``; ``focus_updates`` updates of phase 1."""
    from eraxvif5tts_tpu_torch.models.duration import DurationPredictor

    dit = DiT(arch, VOCAB, MEL)
    dit.load_state_dict(weights)
    dur = DurationPredictor(PRED_VOCAB, 16, 16)
    dur.load_state_dict(dur_weights)
    spec = dict(learning_rate=1e-3, num_warmup_updates=1, total_updates=10, max_grad_norm=0.05)
    return ttr.Trainer(cfm=CFM(dit.train()), optimizer=ttr.make_optimizer(**spec),
                       ema_update_after_step=0, ema_update_every=1, mesh=mesh,
                       duration_predictor=dur, duration_focus_updates=focus_updates,
                       duration_lr=1e-3)


def run_steps(trainer: ttr.Trainer, state, batches, draws, save_after=None) -> list[dict]:
    metrics = []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        state, m = trainer.train_step(state, batch, draws_of(d))
        metrics.append(m)
        if save_after is not None and i + 1 == save_after:
            trainer.save_checkpoint(state)
    return metrics


def consolidated(trainer: ttr.Trainer, state) -> dict:
    """The whole params and EMA (numpy), whatever the layout."""
    if trainer.mesh is None:
        data = {"params": state.model.state_dict(), "ema_params": state.ema_params}
    else:
        data = trainer._consolidated(state)
    return {k: {n: t.detach().numpy().copy() for n, t in data[k].items()}
            for k in ("params", "ema_params")}


def state_numel(state) -> int:
    """Elements of optimizer state and EMA this rank holds."""
    opt = sum(t.numel() for s in state.optimizer.state.values() for k, t in s.items()
              if k != "step")
    return opt + sum(t.numel() for t in state.ema_params.values())


def train_cases(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """Every case of ``inputs["cases"]`` in turn, in this one group: a case
    is (name, n_model, zero1, accumulate, dropout, steps, save_after)."""
    out = {}
    for name, n_model, zero1, accumulate, dropout, steps, save_after in inputs["cases"]:
        arch = dataclasses.replace(ARCH, dropout=dropout)
        mesh = pm.make_mesh(n_model=n_model, device_type="cpu")
        ckpt = os.path.join(tmp, f"ckpt_{name}") if save_after else None
        trainer = make_trainer(inputs["weights"], arch, mesh, zero1, accumulate, ckpt)
        state = trainer.init_state()
        held = state_numel(state)
        batches = [inputs["batches"][i] for i, _ in steps]
        metrics = run_steps(trainer, state, batches, [d for _, d in steps], save_after)
        out[name] = dict(metrics=metrics, state_numel=held, **consolidated(trainer, state))
    return out


def curriculum_cases(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """The duration-predictor curriculum, each of ``inputs["curriculum"]``
    (name, n_model, dropout, focus updates, steps) in this one group: the
    metrics, the whole params and EMA, the predictor's weights and the
    rank's first row of the global batch."""
    out = {}
    for name, n_model, dropout, focus, steps in inputs["curriculum"]:
        arch = dataclasses.replace(ARCH, dropout=dropout)
        mesh = pm.make_mesh(n_model=n_model, device_type="cpu")
        trainer = make_curriculum_trainer(inputs["weights"], inputs["dur_weights"], arch, focus,
                                          mesh)
        state = trainer.init_state()
        batches = [inputs["batches"][i] for i, _ in steps]
        metrics = run_steps(trainer, state, batches, [d for _, d in steps])
        out[name] = dict(metrics=metrics, **consolidated(trainer, state),
                         dur={k: v.detach().numpy().copy()
                              for k, v in state.dur_predictor.state_dict().items()},
                         row0=trainer._shard.batch_offset)
    return out


def resume_case(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """A fresh group resumes a checkpoint and runs the remaining steps."""
    name, n_model, zero1, accumulate, dropout, steps, path = inputs["resume"]
    arch = dataclasses.replace(ARCH, dropout=dropout)
    mesh = pm.make_mesh(n_model=n_model, device_type="cpu")
    trainer = make_trainer(inputs["weights"], arch, mesh, zero1, accumulate)
    state = trainer.load_checkpoint(path, trainer.init_state())
    batches = [inputs["batches"][i] for i, _ in steps]
    metrics = run_steps(trainer, state, batches, [d for _, d in steps])
    return dict(metrics=metrics, step=state.step, **consolidated(trainer, state))


# ---------------------------------------------------------------------------
# serving and the CLI


def wrapper_config(arch_kw: dict) -> ModelConfig:
    return ModelConfig(name="tiny", arch=ArchConfig(**arch_kw), mel_spec=MelSpecConfig())


def build_wrapper(inputs: dict, mesh=None):
    """The port's fp32 wrapper on ``inputs``' weights (JAX trees as numpy),
    the sampler noise replaced by the JAX draw the parent computed."""
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    w = F5TTSWrapper(model_cfg=wrapper_config(inputs["arch"]), vocab_char_map=inputs["vocab"],
                     nfe_step=2, params=inputs["params"], vocoder_params=inputs["vparams"],
                     compute_dtype="float32", device="cpu", duration_buckets=(64, 128),
                     text_buckets=(64,), mesh=mesh)
    w._draw_noise = lambda generator, n_frames: inputs["noise"][n_frames]
    w.preprocess_reference(ref_audio=inputs["ref_wav"], ref_sample_rate=24000,
                           ref_text="hello there")
    return w


def wrapper_cases(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """``generate_batch`` on a data mesh, then on a model mesh, of the group."""
    out = {}
    for name, n_model in (("data", 1), ("model", world)):
        w = build_wrapper(inputs, pm.make_mesh(n_model=n_model, device_type="cpu"))
        out[name] = [np.asarray(x) for x in w.generate_batch(inputs["texts"], seed=0,
                                                              use_pinyin=False)]
        out[name + "_heads"] = w.transformer.transformer_blocks[0].attn.heads
    return out


def cli_cases(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """``train_main`` / ``finetune_main`` from argv in this group, each of
    ``inputs["entries"]`` (name, entry, argv) in turn."""
    from eraxvif5tts_tpu_torch import configs
    from eraxvif5tts_tpu_torch.training import cli

    base = configs.PRESETS["F5TTS_v1_Base"]
    configs.PRESETS["F5TTS_v1_Base"] = dataclasses.replace(
        base, arch=dataclasses.replace(base.arch, **inputs["arch"]))
    out = {}
    for name, entry, argv in inputs["entries"]:
        state = (cli.finetune_main if entry == "finetune" else cli.train_main)(argv)
        moments = [t for s in state.optimizer.state.values() for k, t in s.items()
                   if k != "step"]
        out[name] = dict(step=state.step, heads=state.model.transformer_blocks[0].attn.heads,
                         finite=all(bool(torch.isfinite(p).all())
                                    for p in state.model.parameters()),
                         moments_1d=bool(moments) and all(t.ndim == 1 for t in moments),
                         predictor=state.dur_predictor is not None and all(
                             bool(torch.isfinite(p).all())
                             for p in state.dur_predictor.parameters()))
    return out


def phoneme_dataset():
    """Ten rows whose phonemes (three of ``a`` .. ``t`` each) first appear
    in different batches, and their sampler (two rows a batch)."""
    from eraxvif5tts_tpu_torch.training.dataset import DynamicBatchSampler, Sample

    rng = np.random.default_rng(0)
    letters = [chr(ord("a") + i) for i in range(20)]
    rows = [Sample(text=f"row {i}", duration_frames=16 + i,
                   mel=rng.standard_normal((16 + i, 8)).astype(np.float32),
                   phoneme=" ".join(rng.choice(letters, 3, replace=False)))
            for i in range(10)]

    class Rows:
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    return Rows(), DynamicBatchSampler([r.mel.shape[0] for r in rows], 64, max_samples=2,
                                       random_seed=0)


def phoneme_case(rank: int, world: int, tmp: str, inputs: dict) -> dict:
    """``multihost_epoch_batches`` with a growing phoneme map on a data
    mesh of the group, the phonemes shared over a loader group: the map
    and this rank's phoneme ids."""
    from eraxvif5tts_tpu_torch.text.phoneme import PhonemeMap
    from eraxvif5tts_tpu_torch.training import cli

    dataset, sampler = phoneme_dataset()
    mesh = pm.make_mesh(device_type="cpu")
    phoneme_map = PhonemeMap(max_index=64)
    batches = list(cli.multihost_epoch_batches(
        dataset, sampler, inputs["vocab"], 0, mesh, phoneme_map=phoneme_map,
        phoneme_group=pm.new_axis_group(mesh, "data")))
    return {"map": dict(phoneme_map), "phoneme": [b["phoneme"] for b in batches]}
