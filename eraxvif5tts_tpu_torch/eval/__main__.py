"""Test-set evaluation CLI: ``python -m eraxvif5tts_tpu_torch.eval <task> ...``
(port of `eraxvif5tts_tpu/eval/__main__.py`).

Entry-point parity with the reference's scripts
`eval/eval_seedtts_testset.py`, `eval/eval_librispeech_test_clean.py` and
`eval/eval_utmos.py`: each subcommand loads the matching metainfo, scores the
generated wavs (threaded — the reference shards over a per-GPU ``mp.Pool``,
`eval_seedtts_testset.py:62-70`; one process scores through a thread pool
instead) and writes ``_{task}_results.jsonl`` + a summary line into the
generated-wav directory, printing the aggregate like the reference (`:76-86`).

Scoring backends stay pluggable (zero-egress policy): ASR defaults to the
per-language backend from ``load_asr_fn``, the speaker embedder needs an
ECAPA checkpoint (``--ecapa_ckpt`` / ``ECAPA_CKPT``) and runs on ``--device``
(default ``cuda``), UTMOS defaults to the torch.hub predictor.
``main(argv, asr_fn=..., embed_fn=..., utmos_fn=...)`` accepts injected
scorers for offline use and tests.
"""

from __future__ import annotations

import argparse
import os

from eraxvif5tts_tpu_torch.eval.scorers import (
    default_speaker_embed_fn,
    eval_sim_dir,
    eval_utmos_dir,
    eval_wer_dir,
)
from eraxvif5tts_tpu_torch.eval.utils_eval import (
    get_librispeech_test,
    get_seedtts_testset_metainfo,
)
from eraxvif5tts_tpu_torch.infer.utils_infer import resolve_device


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m eraxvif5tts_tpu_torch.eval",
        description="WER / SIM / UTMOS over a directory of generated wavs",
    )
    sub = ap.add_subparsers(dest="task", required=True)

    se = sub.add_parser("seedtts", help="Seed-TTS testset (reference eval_seedtts_testset.py)")
    se.add_argument("-m", "--metalst", required=True, help="meta.lst path")
    se.add_argument("-g", "--gen_wav_dir", required=True)
    se.add_argument("-e", "--eval_task", default="wer", choices=("wer", "sim"))
    se.add_argument("-l", "--lang", default="en", choices=("en", "zh", "vi"))
    se.add_argument("-n", "--num_workers", type=int, default=4)
    se.add_argument("--ecapa_ckpt", default=None, help="UniSpeech WavLM-ECAPA ckpt (sim)")
    se.add_argument("--device", default=None, help="torch device of the sim scorer (default: cuda)")

    li = sub.add_parser("librispeech",
                        help="LibriSpeech test-clean cross-sentence (reference eval_librispeech_test_clean.py)")
    li.add_argument("-m", "--metalst", required=True, help="cross-sentence metalst")
    li.add_argument("-p", "--librispeech_path", required=True,
                    help="LibriSpeech/test-clean root (speaker/chapter/*.flac)")
    li.add_argument("-g", "--gen_wav_dir", required=True)
    li.add_argument("-e", "--eval_task", default="wer", choices=("wer", "sim"))
    li.add_argument("-n", "--num_workers", type=int, default=4)
    li.add_argument("--ecapa_ckpt", default=None)
    li.add_argument("--device", default=None, help="torch device of the sim scorer (default: cuda)")

    ut = sub.add_parser("utmos", help="UTMOS naturalness MOS (reference eval_utmos.py)")
    ut.add_argument("-g", "--gen_wav_dir", required=True)

    sub.add_parser(
        "infill", add_help=False,
        help="seeded infill battery on trained weights (offline mel-domain "
             "metrics; see eval/infill.py) — remaining args pass through")
    return ap


def main(argv=None, asr_fn=None, embed_fn=None, utmos_fn=None) -> dict:
    argv_list = list(argv) if argv is not None else None
    if argv_list is None:
        import sys

        argv_list = sys.argv[1:]
    if argv_list[:1] == ["infill"]:
        from eraxvif5tts_tpu_torch.eval.infill import run

        return run(argv_list[1:])

    args = _parser().parse_args(argv_list)
    gen_dir = args.gen_wav_dir

    if args.task == "utmos":
        out = os.path.join(gen_dir, "_utmos_results.jsonl")
        summary = eval_utmos_dir(gen_dir, out_jsonl=out, utmos_fn=utmos_fn)
        print(f"UTMOS: {summary['utmos_mean']} ({summary['n']} samples) -> {out}")
        return summary

    if args.task == "seedtts":
        metainfo = get_seedtts_testset_metainfo(args.metalst)
        language = args.lang
    else:  # librispeech: rows share the (utt, prompt_text, prompt_wav,
        # gt_text, gt_wav) shape — gen utterance scored against its own text,
        # SIM against the cross-sentence reference clip
        metainfo = get_librispeech_test(args.metalst, args.librispeech_path)
        language = "en"

    out = os.path.join(gen_dir, f"_{args.eval_task}_results.jsonl")
    if args.eval_task == "wer":
        summary = eval_wer_dir(gen_dir, metainfo, language=language,
                               out_jsonl=out, asr_fn=asr_fn,
                               num_workers=args.num_workers)
        print(f"WER: {summary['wer_mean']} ({summary['n']} samples) -> {out}")
    else:
        if embed_fn is None:
            embed_fn = default_speaker_embed_fn(args.ecapa_ckpt,
                                                resolve_device(args.device))
        summary = eval_sim_dir(gen_dir, metainfo, embed_fn, out_jsonl=out,
                               num_workers=args.num_workers)
        print(f"SIM: {summary['sim_mean']} ({summary['n']} samples) -> {out}")
    return summary


if __name__ == "__main__":
    main()
