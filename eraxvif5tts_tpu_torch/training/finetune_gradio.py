"""Gradio finetuning UI with reference tab parity (port of
`eraxvif5tts_tpu/training/finetune_gradio.py`; reference
`src/f5_tts/train/finetune_gradio.py`, 2162 LoC).

Tab map (reference line refs):
- project bar: create/select project (`:632-654`)
- Transcribe Data (`:1688`, work `:656-726`): wav dir -> metadata.csv + spot-check
- Vocab Check (`:1732`, work `:1294-1405`): missing tokens + extend w/ embedding expansion
- Prepare Data (`:1767`, work `:765-899`): metadata -> arrow/duration/vocab + spot-check
- Train Model (`:1816`, work `:363-631`, settings `:61-171`, auto-settings `:905-993`):
  full hyperparameter form, save/load per-project settings, suggested values from
  dataset stats, launch/stop, live log tail
- Test Model (`:2049`, work `:1458-1505`, ckpt list `:1510-1543`): checkpoint pick,
  ref audio + text -> synthesis through the port's F5TTSWrapper (bf16, on
  ``cuda`` unless the caller passes ``device``)
- Prune Checkpoint (`:2112`, work `:994-1019`)
- System Info (`:2129`, work `:1565-1644`)

Every callback is a module-level function over the UI-agnostic core
(`training/project.py`, `training/prepare.py`, `compression/`), so the full
surface is testable without gradio (tests/test_torch_project.py); `build_app`
imports gradio when called and raises ImportError without it, and only wires
widgets to these functions.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from eraxvif5tts_tpu_torch.training.prepare import prepare_csv_wavs
from eraxvif5tts_tpu_torch.training.project import (
    DEFAULT_SETTINGS,
    ProjectStore,
    TrainingProcess,
    calculate_train,
    prune_checkpoint_to_ema,
    random_metadata_sample,
    settings_to_cli_args,
    system_stats,
    transcribe_directory,
    vocab_check,
    vocab_count,
    vocab_extend,
)

DEFAULT_DATA_ROOT = os.environ.get(
    "ERAXVIF5TTS_DATA", os.path.join(os.getcwd(), "data")
)

# The Train tab's form fields, in display order. Keys index DEFAULT_SETTINGS;
# the same list drives ui_save_settings/ui_load_settings so form<->dict mapping
# can't drift.
SETTING_FIELDS = [
    "exp_name", "learning_rate", "batch_size_per_gpu", "batch_size_type",
    "max_samples", "grad_accumulation_steps", "max_grad_norm", "epochs",
    "num_warmup_updates", "save_per_updates", "keep_last_n_checkpoints",
    "last_per_updates", "finetune", "file_checkpoint_train",
    "tokenizer_type", "tokenizer_file", "compute_dtype", "logger",
]


# ---------------------------------------------------------------------------
# headless callbacks (one per UI action)


def ui_create_project(store: ProjectStore, name: str, tokenizer_type: str):
    """-> (project list, created name). Reference `create_data_project` (`:648`)."""
    if not name.strip():
        raise ValueError("project name is empty")
    full = store.create(name.strip(), tokenizer_type)
    return store.list_projects(), full


def ui_transcribe(store: ProjectStore, project: str, wav_dir: str,
                  language: str, asr_fn=None) -> str:
    """Transcribe `wav_dir` (or the project's own wavs/ when blank) into the
    project's `dataset/metadata.csv` (`transcribe_all`, `:656`)."""
    wav_dir = wav_dir.strip() or os.path.join(store.path(project), "wavs")
    out_csv = os.path.join(store.path(project), "dataset", "metadata.csv")
    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    n = transcribe_directory(wav_dir, out_csv, language=language or None,
                             asr_fn=asr_fn)
    return f"transcribed {n} files -> {out_csv}"


def ui_random_sample(store: ProjectStore, project: str, seed=None):
    """(text, audio path) spot-check of the metadata (`:1420-1446`)."""
    meta = os.path.join(store.path(project), "dataset", "metadata.csv")
    return random_metadata_sample(meta, seed=seed)


def ui_vocab_check(store: ProjectStore, project: str) -> tuple[str, str]:
    """-> (missing tokens joined, status line). Reference `vocab_check` (`:1362`)."""
    proj = store.path(project)
    meta = os.path.join(proj, "dataset", "metadata.csv")
    vocab = os.path.join(proj, "vocab.txt")
    if not os.path.isfile(vocab):
        vocab = _default_vocab()
    if not os.path.isfile(vocab):
        return "", ("no vocab.txt yet — run Prepare Data first (it writes the "
                    "project vocab), or copy your base model's vocab file to "
                    f"{os.path.join(proj, 'vocab.txt')}")
    missing = vocab_check(meta, vocab,
                          use_pinyin=project.endswith("_pinyin"))
    joined = " ".join(missing)
    return joined, (f"{len(missing)} token(s) missing from {vocab}"
                    if missing else "vocab covers the dataset")


def ui_vocab_extend(store: ProjectStore, project: str, symbols: str,
                    ckpt_in: str, ckpt_out: str) -> str:
    """Append symbols to the project vocab, optionally expanding a checkpoint's
    text-embedding rows to match (`vocab_extend`, `:1294`)."""
    tokens = [t for t in symbols.split() if t]
    if not tokens:
        return "no symbols to add"
    proj = store.path(project)
    vocab = os.path.join(proj, "vocab.txt")
    if not os.path.isfile(vocab):
        default = _default_vocab()
        if not os.path.isfile(default):
            return ("no vocab.txt yet — run Prepare Data first (it writes the "
                    "project vocab), or copy your base model's vocab file to "
                    f"{vocab}")
        import shutil

        shutil.copyfile(default, vocab)
    new_size = vocab_extend(vocab, tokens, ckpt_in.strip() or None,
                            ckpt_out.strip() or None)
    out = f"vocab now {new_size} tokens ({vocab_count(' '.join(tokens))} requested)"
    if ckpt_in.strip():
        out += f"; expanded checkpoint -> {ckpt_out}"
    return out


def ui_prepare(store: ProjectStore, project: str, use_pinyin: Optional[bool] = None) -> str:
    """dataset/metadata.csv -> arrow + duration.json + vocab (`create_metadata`,
    `:765`)."""
    proj = store.path(project)
    if use_pinyin is None:
        use_pinyin = project.endswith("_pinyin")
    summary = prepare_csv_wavs(
        os.path.join(proj, "dataset"), proj, use_pinyin=use_pinyin
    )
    return json.dumps(summary)


def ui_calculate_train(store: ProjectStore, project: str, settings: dict) -> dict:
    """Suggested hyperparameters from the prepared dataset's duration.json
    (`calculate_train`, `:905`); merges into a copy of `settings`."""
    suggested = calculate_train(
        os.path.join(store.path(project), "duration.json"),
        batch_size_type=settings.get("batch_size_type", "frame"),
        num_warmup_updates=int(settings.get("num_warmup_updates", 100)),
        finetune=bool(settings.get("finetune", True)),
    )
    merged = {**settings}
    for k in ("epochs", "learning_rate", "batch_size_per_gpu", "max_samples",
              "num_warmup_updates"):
        merged[k] = suggested[k]
    return merged


def ui_save_settings(store: ProjectStore, project: str, *values) -> str:
    """Persist the Train form (positional, SETTING_FIELDS order) to
    `setting.json` (`save_settings`, `:61`)."""
    settings = dict(zip(SETTING_FIELDS, values))
    path = store.save_settings(project, _coerce_settings(settings))
    return f"saved {path}"


def ui_load_settings(store: ProjectStore, project: str) -> list:
    """Load `setting.json` -> form values in SETTING_FIELDS order
    (`load_settings`, `:114`)."""
    s = store.load_settings(project)
    return [s[k] for k in SETTING_FIELDS]


def ui_start_training(store: ProjectStore, proc: TrainingProcess, project: str,
                      *values) -> str:
    """Persist the form, then launch `eraxvif5tts-torch-finetune` as a subprocess
    (`start_training`, `:363`). Returns a status line."""
    if proc.running:
        return "already running — stop it first"
    settings = _coerce_settings(dict(zip(SETTING_FIELDS, values)))
    store.save_settings(project, settings)
    args = settings_to_cli_args(project, settings, store.root)
    log = os.path.join(store.path(project), "train.log")
    pid = proc.start(args, log_path=log)
    return f"started pid {pid}; log: {log}"


def ui_stop_training(proc: TrainingProcess) -> str:
    return "stopped" if proc.stop() else "not running"


def ui_tail_log(store: ProjectStore, project: str, n: int = 40) -> str:
    """Last lines of the project train log (`stream_output`, `:506`)."""
    path = os.path.join(store.path(project), "train.log")
    if not os.path.isfile(path):
        return "(no log yet)"
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return "".join(f.readlines()[-n:])


def ui_list_checkpoints(store: ProjectStore, project: str) -> list[str]:
    return store.list_checkpoints(project)


def ui_test_infer(store: ProjectStore, project: str, ckpt: str, ref_audio: str,
                  ref_text: str, gen_text: str, nfe: int = 32,
                  speed: float = 1.0, wrapper_factory=None, device="cuda"):
    """Synthesize with a project checkpoint (`infer`, `:1458`). Returns
    (sample_rate, wav numpy). `wrapper_factory(ckpt, vocab)` is injectable for
    tests; default builds `F5TTSWrapper` with the project's exp_name config,
    in bf16 on ``device``."""
    if not ckpt:
        raise ValueError("pick a checkpoint first")
    if wrapper_factory is None:
        from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

        settings = store.load_settings(project)
        wrapper_factory = lambda c, v: F5TTSWrapper(  # noqa: E731
            model_name=settings["exp_name"], ckpt_path=c,
            vocab_file=v if os.path.isfile(v) else None,
            compute_dtype="bfloat16", device=device)
    tts = wrapper_factory(ckpt, os.path.join(store.path(project), "vocab.txt"))
    tts.preprocess_reference(ref_audio, ref_text)
    wav = tts.generate(gen_text, nfe_step=int(nfe), speed=float(speed))
    return tts.target_sample_rate, wav


def ui_list_samples(store: ProjectStore, project: str) -> list[str]:
    """Per-save synthesis wavs (`get_audio_project`, `:1544`)."""
    return store.list_sample_audio(project)


def ui_prune(src: str, dst: str) -> str:
    n = prune_checkpoint_to_ema(src, dst)
    return f"kept {n} tensors -> {dst}"


def ui_system_stats() -> str:
    return json.dumps(system_stats(), indent=2)


def _coerce_settings(settings: dict) -> dict:
    """Gradio textboxes hand strings back; coerce to DEFAULT_SETTINGS' types."""
    out = {}
    for k, v in settings.items():
        ref = DEFAULT_SETTINGS.get(k)
        if isinstance(ref, bool):
            out[k] = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
        elif isinstance(ref, int):
            out[k] = int(float(v))
        elif isinstance(ref, float):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _default_vocab() -> str:
    """Site-wide fallback vocab. Not shipped with the package (the reference's
    vocab file belongs to its released checkpoints); callers must handle a
    missing file — `ui_vocab_check`/`ui_vocab_extend` degrade to a
    run-Prepare-Data-first message."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "configs", "vocab.txt")


# ---------------------------------------------------------------------------
# gradio shell


def build_app(data_root: str = DEFAULT_DATA_ROOT):
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "gradio is not installed; the same operations are available as "
            "library functions (this module's ui_* callbacks over "
            "training/project.py) and CLIs (eraxvif5tts-torch-train / "
            "eraxvif5tts-torch-finetune)"
        ) from e

    store = ProjectStore(data_root)
    proc = TrainingProcess()

    with gr.Blocks(title="EraXviF5TTS finetuning") as app:
        gr.Markdown("# EraXviF5TTS — finetuning project manager")
        with gr.Row():
            projects = store.list_projects()
            project_dd = gr.Dropdown(projects, label="Project",
                                     value=projects[0] if projects else None,
                                     allow_custom_value=True)
            new_name = gr.Textbox(label="New project name")
            new_tok = gr.Radio(["pinyin", "char", "custom"], value="pinyin",
                               label="Tokenizer")
            create_btn = gr.Button("Create")
        create_btn.click(
            lambda n, t: (lambda ps, created: (gr.update(choices=ps, value=created)))(
                *ui_create_project(store, n, t)),
            [new_name, new_tok], project_dd)

        with gr.Tab("Transcribe Data"):
            wav_dir = gr.Textbox(label="Wav directory (blank = project wavs/)")
            lang = gr.Textbox(label="Language", value="vi")
            tr_out = gr.Textbox(label="Result")
            gr.Button("Transcribe").click(
                lambda p, d, l: ui_transcribe(store, p, d, l),
                [project_dd, wav_dir, lang], tr_out)
            sample_text = gr.Textbox(label="Random sample text")
            sample_audio = gr.Audio(label="Random sample audio", type="filepath")
            gr.Button("Random sample").click(
                lambda p: ui_random_sample(store, p),
                [project_dd], [sample_text, sample_audio])

        with gr.Tab("Vocab Check"):
            missing_box = gr.Textbox(label="Missing tokens")
            vc_status = gr.Textbox(label="Status")
            gr.Button("Check vocab").click(
                lambda p: ui_vocab_check(store, p),
                [project_dd], [missing_box, vc_status])
            ckpt_in = gr.Textbox(label="Checkpoint to expand (optional)")
            ckpt_out = gr.Textbox(label="Expanded checkpoint output")
            ve_out = gr.Textbox(label="Extend result")
            gr.Button("Extend vocab").click(
                lambda p, s, ci, co: ui_vocab_extend(store, p, s, ci, co),
                [project_dd, missing_box, ckpt_in, ckpt_out], ve_out)

        with gr.Tab("Prepare Data"):
            gr.Markdown("Builds arrow + duration.json + vocab from the "
                        "project's `dataset/metadata.csv`.")
            prep_out = gr.Textbox(label="Summary")
            gr.Button("Prepare").click(
                lambda p: ui_prepare(store, p), [project_dd], prep_out)
            p_text = gr.Textbox(label="Random sample text")
            p_audio = gr.Audio(label="Random sample audio", type="filepath")
            gr.Button("Random sample").click(
                lambda p: ui_random_sample(store, p),
                [project_dd], [p_text, p_audio])

        with gr.Tab("Train Model"):
            f = {}
            with gr.Row():
                f["exp_name"] = gr.Radio(
                    ["F5TTS_v1_Base", "F5TTS_Base", "E2TTS_Base"],
                    value=DEFAULT_SETTINGS["exp_name"], label="exp_name")
                f["tokenizer_type"] = gr.Radio(
                    ["pinyin", "char", "custom"],
                    value=DEFAULT_SETTINGS["tokenizer_type"], label="tokenizer")
                f["finetune"] = gr.Checkbox(
                    value=DEFAULT_SETTINGS["finetune"], label="finetune")
            with gr.Row():
                f["learning_rate"] = gr.Number(
                    value=DEFAULT_SETTINGS["learning_rate"], label="learning_rate")
                f["batch_size_per_gpu"] = gr.Number(
                    value=DEFAULT_SETTINGS["batch_size_per_gpu"],
                    label="batch_size_per_gpu")
                f["batch_size_type"] = gr.Radio(
                    ["frame", "sample"], value=DEFAULT_SETTINGS["batch_size_type"],
                    label="batch_size_type")
                f["max_samples"] = gr.Number(
                    value=DEFAULT_SETTINGS["max_samples"], label="max_samples")
            with gr.Row():
                f["grad_accumulation_steps"] = gr.Number(
                    value=DEFAULT_SETTINGS["grad_accumulation_steps"],
                    label="grad_accumulation_steps")
                f["max_grad_norm"] = gr.Number(
                    value=DEFAULT_SETTINGS["max_grad_norm"], label="max_grad_norm")
                f["epochs"] = gr.Number(
                    value=DEFAULT_SETTINGS["epochs"], label="epochs")
                f["num_warmup_updates"] = gr.Number(
                    value=DEFAULT_SETTINGS["num_warmup_updates"],
                    label="num_warmup_updates")
            with gr.Row():
                f["save_per_updates"] = gr.Number(
                    value=DEFAULT_SETTINGS["save_per_updates"],
                    label="save_per_updates")
                f["keep_last_n_checkpoints"] = gr.Number(
                    value=DEFAULT_SETTINGS["keep_last_n_checkpoints"],
                    label="keep_last_n_checkpoints")
                f["last_per_updates"] = gr.Number(
                    value=DEFAULT_SETTINGS["last_per_updates"],
                    label="last_per_updates")
            with gr.Row():
                f["file_checkpoint_train"] = gr.Textbox(
                    value="", label="pretrain checkpoint (optional)")
                f["tokenizer_file"] = gr.Textbox(
                    value="", label="custom tokenizer file (optional)")
                f["compute_dtype"] = gr.Radio(
                    ["bfloat16", "float32"],
                    value=DEFAULT_SETTINGS["compute_dtype"], label="compute_dtype")
                f["logger"] = gr.Radio(
                    ["tensorboard", "wandb", "none"],
                    value=DEFAULT_SETTINGS["logger"], label="logger")
            fields = [f[k] for k in SETTING_FIELDS]
            status = gr.Textbox(label="Status")
            log_box = gr.Textbox(label="Training log", lines=14)
            with gr.Row():
                def _auto(p, *v):
                    # one calculation (it reads + stats duration.json), then
                    # fan the dict out to the form fields
                    s = ui_calculate_train(store, p, dict(zip(SETTING_FIELDS, v)))
                    return [s[k] for k in SETTING_FIELDS]

                gr.Button("Auto settings").click(_auto, [project_dd, *fields],
                                                 fields)
                gr.Button("Save settings").click(
                    lambda p, *v: ui_save_settings(store, p, *v),
                    [project_dd, *fields], status)
                gr.Button("Load settings").click(
                    lambda p: ui_load_settings(store, p), [project_dd], fields)
            with gr.Row():
                gr.Button("Start training", variant="primary").click(
                    lambda p, *v: ui_start_training(store, proc, p, *v),
                    [project_dd, *fields], status)
                gr.Button("Stop").click(lambda: ui_stop_training(proc), [], status)
                gr.Button("Refresh log").click(
                    lambda p: ui_tail_log(store, p), [project_dd], log_box)

        with gr.Tab("Test Model"):
            ckpt_dd = gr.Dropdown([], label="Checkpoint", allow_custom_value=True)
            gr.Button("Refresh checkpoints").click(
                lambda p: gr.update(choices=ui_list_checkpoints(store, p)),
                [project_dd], ckpt_dd)
            ref_audio = gr.Audio(label="Reference audio", type="filepath")
            ref_text = gr.Textbox(label="Reference text")
            gen_text = gr.Textbox(label="Text to generate")
            with gr.Row():
                nfe = gr.Slider(4, 64, value=32, step=1, label="NFE steps")
                speed = gr.Slider(0.3, 2.0, value=1.0, step=0.1, label="Speed")
            out_audio = gr.Audio(label="Synthesized")
            gr.Button("Synthesize", variant="primary").click(
                lambda p, c, ra, rt, g, n, s: ui_test_infer(
                    store, p, c, ra, rt, g, nfe=n, speed=s),
                [project_dd, ckpt_dd, ref_audio, ref_text, gen_text, nfe, speed],
                out_audio)
            samples_dd = gr.Dropdown([], label="Per-save samples",
                                     allow_custom_value=True)
            sample_play = gr.Audio(label="Sample playback", type="filepath")
            gr.Button("Refresh samples").click(
                lambda p: gr.update(choices=ui_list_samples(store, p)),
                [project_dd], samples_dd)
            samples_dd.change(lambda s: s, samples_dd, sample_play)

        with gr.Tab("Prune Checkpoint"):
            src = gr.Textbox(label="Training checkpoint (.pt/.safetensors)")
            dst = gr.Textbox(label="EMA-only output")
            pr_out = gr.Textbox(label="Result")
            gr.Button("Prune to EMA").click(
                lambda s, d: ui_prune(s, d), [src, dst], pr_out)

        with gr.Tab("System Info"):
            stats_box = gr.Textbox(label="Stats", lines=16)
            gr.Button("Refresh").click(ui_system_stats, [], stats_box)
    return app


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", default=DEFAULT_DATA_ROOT)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--share", action="store_true")
    args = ap.parse_args()
    build_app(args.data_root).launch(server_name=args.host,
                                     server_port=args.port, share=args.share)


if __name__ == "__main__":
    main()
