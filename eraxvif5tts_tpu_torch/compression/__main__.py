"""Command-line front end for the compression toolkit (port of
`eraxvif5tts_tpu/compression/__main__.py`).

The reference ships these as five standalone scripts
(`src/model_pruning/excellent_definitive-f5tts-pruner.py`, `pt_to_safetensor.py`,
`get_embeding_size.py`, `inspect_pt.py`, `reset_f5tts_epoch_enhanced.py`); here
they are subcommands over the same library core (the port's
`compression/pruner.py` and `compression/convert.py`):

    python -m eraxvif5tts_tpu_torch.compression prune model.pt pruned.safetensors --target-layers 14
    python -m eraxvif5tts_tpu_torch.compression prune model.pt pruned.safetensors \
        --manual-blocks 0,1,2,3,5,8,11,14,17,20,21 --target-layers 11
    python -m eraxvif5tts_tpu_torch.compression convert model.pt model.safetensors
    python -m eraxvif5tts_tpu_torch.compression inspect model.safetensors
    python -m eraxvif5tts_tpu_torch.compression embedding-size model.safetensors
    python -m eraxvif5tts_tpu_torch.compression expand-embedding model.pt out.safetensors --vocab-size 3000
    python -m eraxvif5tts_tpu_torch.compression reset-epoch full_ckpt.pt weights_only.safetensors
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="eraxvif5tts-compression",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prune", help="SNR-scored layer pruning (22 -> 14/12), "
                                     "first-2/last-2 always kept")
    p.add_argument("ckpt")
    p.add_argument("output", help=".safetensors or .pt")
    p.add_argument("--target-layers", type=int, default=14)
    p.add_argument("--manual-blocks", default=None,
                   help="comma-separated block ids to keep (overrides scoring)")
    p.add_argument("--no-ema", dest="use_ema", action="store_false",
                   help="prune the raw model weights instead of the EMA copy")
    p.add_argument("--skip-test", action="store_true",
                   help="skip the smoke re-load of the pruned checkpoint")

    p = sub.add_parser("convert", help=".pt <-> .safetensors with state-dict "
                                       "discovery, EMA-prefix cleaning")
    p.add_argument("ckpt")
    p.add_argument("output")
    p.add_argument("--no-ema", dest="use_ema", action="store_false")

    p = sub.add_parser("inspect", help="structure dump (tensor count, params, "
                                       "depth, first keys)")
    p.add_argument("ckpt")
    p.add_argument("--max-keys", type=int, default=50)

    p = sub.add_parser("embedding-size", help="text-embedding vocab rows")
    p.add_argument("ckpt")

    p = sub.add_parser("expand-embedding", help="grow the text-embedding table "
                                                "for vocab extension")
    p.add_argument("ckpt")
    p.add_argument("output")
    p.add_argument("--vocab-size", type=int, required=True,
                   help="new vocab size (table grows to vocab_size+1 rows)")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("reset-epoch", help="strip optimizer/scheduler/counters, "
                                           "keep weights")
    p.add_argument("ckpt")
    p.add_argument("output")
    return ap


def main(argv: list[str] | None = None) -> int:
    from eraxvif5tts_tpu_torch.compression.pruner import (
        convert_pt_to_safetensors,
        expand_text_embedding,
        get_embedding_size,
        inspect_checkpoint,
        load_state_dict,
        normalize_reference_state_dict,
        prune_checkpoint,
        reset_training_counters,
        save_state_dict,
        test_pruned_model,
    )

    args = build_parser().parse_args(argv)
    if args.cmd == "prune":
        manual = ([int(b) for b in args.manual_blocks.split(",")]
                  if args.manual_blocks else None)
        report = prune_checkpoint(args.ckpt, args.output,
                                  target_layers=args.target_layers,
                                  manual_blocks=manual, use_ema=args.use_ema)
        print(f"kept blocks: {report.blocks_to_keep}")
        print(f"params: {report.params_before:,} -> {report.params_after:,}"
              f" ({report.params_after / report.params_before:.1%})")
        if report.used_fallback:
            print("note: histogram scoring degenerate, used position-based "
                  "U-shape fallback")
        if not args.skip_test:
            ok = test_pruned_model(args.output)
            print(f"smoke re-load: {'OK' if ok else 'FAILED'}")
            return 0 if ok else 1
    elif args.cmd == "convert":
        n = convert_pt_to_safetensors(args.ckpt, args.output, use_ema=args.use_ema)
        print(f"wrote {n} tensors -> {args.output}")
    elif args.cmd == "inspect":
        print(json.dumps(inspect_checkpoint(args.ckpt, max_keys=args.max_keys),
                         indent=2))
    elif args.cmd == "embedding-size":
        print(get_embedding_size(args.ckpt))
    elif args.cmd == "expand-embedding":
        sd = normalize_reference_state_dict(load_state_dict(args.ckpt))
        out = expand_text_embedding(sd, args.vocab_size, seed=args.seed)
        save_state_dict(out, args.output)
        key = next(k for k in out if k.endswith("text_embed.text_embed.weight"))
        print(f"text embedding rows: {sd[key].shape[0]} -> {out[key].shape[0]}")
    elif args.cmd == "reset-epoch":
        reset_training_counters(args.ckpt, args.output)
        print(f"weights-only checkpoint -> {args.output}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `inspect ... | head`
        sys.exit(0)
