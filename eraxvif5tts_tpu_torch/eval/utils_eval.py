"""Eval utilities: test-set metainfo loaders, length-bucketed prompt batching,
WER / SIM scorers (the port's own copy of `eraxvif5tts_tpu/eval/utils_eval.py`;
`tests/test_torch_hostcopies.py` holds it to the original).

Parity targets (reference `src/f5_tts/eval/utils_eval.py`):
- ``get_seedtts_testset_metainfo`` / librispeech pair loaders (`:18-54`);
- ``get_inference_prompt`` length bucketing (`:72-204`): prompts are grouped by
  target total duration into linear buckets over [min_tokens, max_tokens] and packed
  into batches under a frame budget;
- ``run_asr_wer`` (`:305-373`) with a native Levenshtein WER (no jiwer dependency);
  the ASR backend is the port's ``infer.utils_infer.transcribe`` (a local
  Whisper directory or an injected callable; nothing is downloaded);
- ``run_sim`` (`:379-418`) speaker cosine similarity with a pluggable embedder.
"""

from __future__ import annotations

import os
import re
import string
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


# ---------------------------------------------------------------------------
# metainfo loaders


def get_seedtts_testset_metainfo(metalst: str) -> list[tuple[str, str, str, str, str]]:
    """Rows: (utt, prompt_text, prompt_wav, gt_text, gt_wav)."""
    out = []
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) == 4:
                utt, prompt_text, prompt_wav, gt_text = parts
                gt_wav = ""
            else:
                utt, prompt_text, prompt_wav, gt_text, gt_wav = parts[:5]
            if not os.path.isabs(prompt_wav):
                prompt_wav = os.path.join(os.path.dirname(metalst), prompt_wav)
            out.append((utt, prompt_text, prompt_wav, gt_text, gt_wav))
    return out


def get_librispeech_test(metalst: str, librispeech_test_clean_path: str):
    """Pairs of (ref utterance, gen utterance) from the cross-sentence list."""
    out = []
    with open(metalst, "r", encoding="utf-8") as f:
        for line in f:
            ref_utt, ref_dur, ref_text, gen_utt, gen_dur, gen_text = line.strip().split("\t")
            def wav_path(utt):
                spk, chap = utt.split("-")[:2]
                return os.path.join(librispeech_test_clean_path, spk, chap, utt + ".flac")
            out.append((gen_utt, ref_text, wav_path(ref_utt), gen_text, wav_path(gen_utt)))
    return out


# ---------------------------------------------------------------------------
# prompt bucketing


@dataclass
class PromptBatch:
    utts: list[str] = field(default_factory=list)
    ref_mels: Optional[np.ndarray] = None  # [b, n_cond_max, d]
    ref_mel_lens: Optional[np.ndarray] = None
    total_mel_lens: Optional[np.ndarray] = None
    final_texts: list = field(default_factory=list)
    bucket_frames: int = 0


def get_inference_prompt(
    metainfo,
    mel_fn: Callable[[np.ndarray], np.ndarray],  # wav [t] -> mel [n, d]
    load_wav: Callable[[str], tuple[np.ndarray, int]],
    tokenize: Callable[[str], list[str]],
    speed: float = 1.0,
    hop_length: int = 256,
    sample_rate: int = 24000,
    min_seconds: float = 3.0,
    max_seconds: float = 40.0,
    num_buckets: int = 200,
    batch_frames: int = 12000,
    use_truth_duration: bool = False,
) -> list[PromptBatch]:
    """Group prompts into duration buckets packed under a frame budget
    (`utils_eval.py:72-204`)."""
    min_frames = int(min_seconds * sample_rate / hop_length)
    max_frames = int(max_seconds * sample_rate / hop_length)
    edges = np.linspace(min_frames, max_frames, num_buckets + 1)

    buckets: dict[int, list] = {}
    for utt, prompt_text, prompt_wav, gt_text, gt_wav in metainfo:
        wav, sr = load_wav(prompt_wav)
        if wav.ndim == 2:
            wav = wav.mean(axis=0)
        mel = mel_fn(wav)
        ref_frames = mel.shape[0]
        if use_truth_duration and gt_wav:
            gt, gsr = load_wav(gt_wav)
            total = ref_frames + int(len(gt) / gsr * sample_rate / hop_length / speed)
        else:
            ref_bytes = max(len(prompt_text.encode("utf-8")), 1)
            gen_bytes = len(gt_text.encode("utf-8"))
            total = ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)
        total = int(np.clip(total, min_frames, max_frames))
        bucket_idx = int(np.searchsorted(edges, total, side="right") - 1)
        bucket_idx = min(max(bucket_idx, 0), num_buckets - 1)
        tokens = tokenize(prompt_text + " " + gt_text)
        buckets.setdefault(bucket_idx, []).append(
            (utt, mel, ref_frames, total, tokens)
        )

    batches: list[PromptBatch] = []
    for bucket_idx in sorted(buckets):
        items = buckets[bucket_idx]
        bucket_frames_cap = int(edges[bucket_idx + 1])
        max_batch = max(1, batch_frames // bucket_frames_cap)
        for i in range(0, len(items), max_batch):
            group = items[i : i + max_batch]
            n_cond_max = max(g[1].shape[0] for g in group)
            d = group[0][1].shape[1]
            mels = np.zeros((len(group), n_cond_max, d), np.float32)
            for j, g in enumerate(group):
                mels[j, : g[1].shape[0]] = g[1]
            batches.append(PromptBatch(
                utts=[g[0] for g in group],
                ref_mels=mels,
                ref_mel_lens=np.asarray([g[2] for g in group], np.int32),
                total_mel_lens=np.asarray([g[3] for g in group], np.int32),
                final_texts=[g[4] for g in group],
                bucket_frames=bucket_frames_cap,
            ))
    return batches


# ---------------------------------------------------------------------------
# WER


# ASCII + CJK punctuation (reference strips `zhon.hanzi.punctuation +
# string.punctuation`, `utils_eval.py:322-330`; the CJK set is reproduced here
# natively so zh WER needs no extra dependency): full/half-width stops, ideographic
# comma, corner/lenticular brackets, wave dash, middle dot, fullwidth forms.
_CJK_PUNCT = (
    "、。〈〉《》「」『』"
    "【】〔〕〜・—‘’“”"
    "…·！＂＃＄％＆＇（）"
    "＊＋，－．／：；＜＝＞"
    "？＠［＼］＾＿｀｛｜｝～"
)
_PUNCT_RE = re.compile(rf"[{re.escape(string.punctuation + _CJK_PUNCT)}]")


def _to_simplified(text: str) -> str:
    """Traditional -> simplified, matching the reference's `zhconv.convert(hypo,
    "zh-cn")` (`utils_eval.py:324`). Gated: without ``zhconv`` installed the text
    passes through unchanged (ASR output is usually already simplified)."""
    try:
        import zhconv  # type: ignore

        return zhconv.convert(text, "zh-cn")
    except ImportError:
        return text


def normalize_text(text: str, language: str = "en") -> list[str]:
    """Tokens for WER. en: lowercase words; zh: simplified-form characters
    (reference scores zh per character after traditional->simplified conversion
    and punctuation strip, `utils_eval.py:322-338`)."""
    text = _PUNCT_RE.sub(" ", text.lower())
    if language == "zh":
        return [c for c in _to_simplified(text) if not c.isspace()]
    return text.split()


def edit_distance(ref: list, hyp: list) -> int:
    """Levenshtein distance (replaces the jiwer dependency)."""
    m, n = len(ref), len(hyp)
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def word_error_rate(truth: str, hypothesis: str, language: str = "en") -> float:
    ref = normalize_text(truth, language)
    hyp = normalize_text(hypothesis, language)
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(ref, hyp) / len(ref)


def _ordered_pool_map(fn, items, num_workers: int):
    """Map ``fn`` over ``items`` with a thread pool, preserving order.

    The reference parallelizes WER/SIM scoring with a per-GPU ``mp.Pool``
    (`eval_seedtts_testset.py:62-70`); here one process scores, so scoring
    parallelism is thread-level — wav IO and torch scoring backends release
    the GIL, the Python glue does not dominate.
    """
    if num_workers <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(fn, items))


def load_asr_fn(language: str, ckpt_dir: str = "") -> Callable[[str], str]:
    """ASR backend per language (reference ``load_asr_model``,
    `utils_eval.py:283-300`): zh -> funasr paraformer-zh (Seed-TTS setting),
    every other language -> Whisper through the port's
    ``infer.utils_infer.transcribe``. Both are LOUDLY gated — the backends need
    model weights (and for zh the ``funasr`` package); the Whisper pipeline is
    built only from a local directory (``initialize_asr_pipeline(path)``), so
    without one pass your own ``asr_fn`` instead."""
    if language == "zh":
        try:
            from funasr import AutoModel  # type: ignore
        except ImportError as e:
            raise ImportError(
                "zh WER uses the funasr paraformer-zh backend (reference "
                "utils_eval.py:283-292); `pip install funasr` and point ckpt_dir "
                "at the paraformer-zh weights, or pass asr_fn=... with your own "
                "transcriber"
            ) from e
        model = AutoModel(
            model=os.path.join(ckpt_dir, "paraformer-zh") if ckpt_dir else "paraformer-zh",
            disable_update=True,
        )

        def asr_fn(path: str) -> str:
            res = model.generate(input=path, batch_size_s=300, disable_pbar=True)
            return _to_simplified(res[0]["text"])

        return asr_fn
    # every other language goes through Whisper, which is multilingual — the
    # reference's faster-whisper call pins language="en" for its English sets
    # (`utils_eval.py:313-317`) but this project's primary eval language is
    # Vietnamese; pass asr_fn=... to swap the backend entirely
    from eraxvif5tts_tpu_torch.infer.utils_infer import transcribe

    return lambda p: transcribe(p, language=language)


def run_asr_wer(
    pairs: list[tuple[str, str]],  # (wav_path, truth_text)
    language: str = "en",
    asr_fn: Optional[Callable[[str], str]] = None,
    num_workers: int = 1,
) -> list[dict]:
    """Transcribe + WER per utterance (`utils_eval.py:305-373`). ``asr_fn`` defaults
    to the per-language backend from ``load_asr_fn`` (zh: paraformer, en: whisper).
    ``num_workers > 1`` scores utterances through a thread pool (order preserved)."""
    if asr_fn is None:
        asr_fn = load_asr_fn(language)

    def score(pair):
        wav_path, truth = pair
        hypo = asr_fn(wav_path)
        return {
            "wav": wav_path,
            "truth": truth,
            "hypo": hypo,
            "wer": word_error_rate(truth, hypo, language),
        }

    return _ordered_pool_map(score, pairs, num_workers)


# ---------------------------------------------------------------------------
# speaker similarity


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a = a / (np.linalg.norm(a) + 1e-8)
    b = b / (np.linalg.norm(b) + 1e-8)
    return float(np.dot(a, b))


def run_sim(
    pairs: list[tuple[str, str]],  # (generated_wav, prompt_wav)
    embed_fn: Callable[[str], np.ndarray],
    num_workers: int = 1,
) -> list[dict]:
    """Speaker-similarity cosine between generated and prompt embeddings
    (`utils_eval.py:379-418`). ``embed_fn`` is the speaker embedder — the reference
    uses WavLM-large ECAPA-TDNN; any embedding extractor works here.

    Prompt embeddings are computed once per distinct prompt wav (test sets reuse
    prompts across utterances); ``num_workers > 1`` embeds through a thread pool.
    """
    import threading

    prompt_cache: dict[str, np.ndarray] = {}
    lock = threading.Lock()

    def prompt_embed(path: str) -> np.ndarray:
        with lock:
            cached = prompt_cache.get(path)
        if cached is not None:
            return cached
        emb = embed_fn(path)
        with lock:
            prompt_cache[path] = emb
        return emb

    def score(pair):
        gen_wav, prompt_wav = pair
        sim = cosine_similarity(embed_fn(gen_wav), prompt_embed(prompt_wav))
        return {"gen": gen_wav, "prompt": prompt_wav, "sim": sim}

    return _ordered_pool_map(score, pairs, num_workers)
