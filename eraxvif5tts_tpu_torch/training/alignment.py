"""Monotonic alignment search (MAS) and the duration-loss machinery (port of
`eraxvif5tts_tpu/training/alignment.py`).

Parity targets: reference `src/f5_tts/model/alignment_utils.py` (three alignment
algorithms + phase manager) and `trainer.py:829-1079` (`calculate_duration_loss`).

The JAX package keeps MAS on XLA (no Pallas kernel); the port writes it in
plain torch with the same arithmetic:

- **viterbi**: the DP ``path[n,t] = sim[n,t] + max(path[n-1,t], path[n,t-1])``
  in its closed form ``path[n] = cumsum(sim[n]) + cummax(enter[n])``. The
  rows depend on each other, so they run as a Python loop (the JAX
  ``lax.scan`` over text rows), each row vectorised over the frames
  (``torch.cummax``); the prefix sums of every pair of neighbouring rows'
  difference are taken at once before the loop. Backtracking recovers the
  exact argmax boundaries, one row at a time from the top.
- **window**: expected-position window argmax (`alignment_utils.py:214-258`),
  a loop over text rows with a masked argmax each.
- **progressive**: uniform split + one boundary-refinement pass by prefix-sum
  gains. Each boundary's search reads the uniform bounds only, so every
  boundary and every shift is evaluated at once (the JAX package unrolls two
  Python loops over them); the first shift with the largest strictly positive
  gain wins, as in its sequential ``delta > best_delta`` scan. A gain is
  summed from the two rows' difference, so that equal neighbouring rows
  (one phoneme twice) tie exactly on every device (below).

Argmax ties go to the first index in both packages. Where the JAX package
subtracts two prefix sums, viterbi and progressive take the prefix sum of a
difference: equal in exact arithmetic, and exactly 0 where two neighbouring
rows are equal (the same phoneme twice), a tie that the JAX form leaves to
rounding and so to the device (the card's cumulative sums round otherwise
than the CPU's). All functions return
per-token **durations** ``[b, nt]`` (int64 here, int32 in JAX). On the card
each row of viterbi and window is a handful of small launches: a few
thousand an update at the training text buckets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = -1e9


def _masked_similarity(similarity: torch.Tensor, phoneme_lens: torch.Tensor,
                       mel_lens: torch.Tensor) -> torch.Tensor:
    b, nt, T = similarity.shape
    dev = similarity.device
    row_ok = torch.arange(nt, device=dev)[None, :] < phoneme_lens[:, None]
    col_ok = torch.arange(T, device=dev)[None, :] < mel_lens[:, None]
    sim = similarity.masked_fill(~row_ok[:, :, None], NEG)
    return sim.masked_fill(~col_ok[:, None, :], NEG)


def viterbi_alignment_durations(similarity: torch.Tensor, phoneme_lens: torch.Tensor,
                                mel_lens: torch.Tensor) -> torch.Tensor:
    """Exact MAS durations. ``similarity [b, nt, T]`` -> ``durations [b, nt]``."""
    sim = _masked_similarity(similarity, phoneme_lens, mel_lens)
    b, nt, T = sim.shape
    dev = sim.device
    # Standard MAS recurrence (`alignment.py:56-63`): row n entering at column
    # s means row n-1 ended at s-1, so its entry score is
    #   enter[n, s] = path[n-1, s-1] - c[n, s-1] = d[n-1, s-1] + m[n-1, s-1]
    # with c the rows' prefix sums, d[n-1] = c[n-1] - c[n] (taken as the prefix
    # sums of the rows' difference) and m[n-1] = cummax(enter[n-1]), since
    # path[n-1] = c[n-1] + m[n-1]. Equal in exact arithmetic to the JAX form
    # (c[n-1] + m[n-1]) - c[n]; here two equal neighbouring rows (a phoneme
    # twice) give enter[n] = m[n-1] exactly, so their boundary is the first
    # best column on any device instead of one chosen by rounding.
    d_all = torch.cumsum(sim[:, :-1] - sim[:, 1:], dim=-1)  # [b, nt-1, T]
    enter = torch.full((b, T), NEG, device=dev)
    enter[:, 0] = 0.0
    enters = [enter]
    for n in range(1, nt):
        m = torch.cummax(enter, dim=1).values
        enter = torch.nn.functional.pad((d_all[:, n - 1] + m)[:, :-1], (1, 0), value=NEG)
        enters.append(enter)
    enters = torch.stack(enters, dim=1)  # [b, nt, T]

    # Backtrack top-down: row n ends at t_cur; its entry column is the argmax
    # of enters[n, :t_cur+1]; the row below ends at entry - 1.
    col = torch.arange(T, device=dev)[None, :]
    t_cur = mel_lens.to(torch.int64) - 1
    plens = phoneme_lens.to(torch.int64)
    durs = [None] * nt
    for n in range(nt - 1, -1, -1):
        valid_row = n < plens
        t_row = torch.where(n == plens - 1, mel_lens.to(torch.int64) - 1, t_cur)
        scores = torch.where(col <= t_row[:, None], enters[:, n], NEG)
        entry = torch.argmax(scores, dim=-1)
        if n == 0:  # row 0 always starts at frame 0
            entry = torch.zeros_like(entry)
        durs[n] = torch.where(valid_row, t_row - entry + 1, 0)
        t_cur = torch.where(valid_row, entry - 1, t_cur)
    return torch.clamp(torch.stack(durs, dim=1), min=0)


def windowed_alignment_durations(similarity: torch.Tensor, phoneme_lens: torch.Tensor,
                                 mel_lens: torch.Tensor,
                                 window_size: float = 0.2) -> torch.Tensor:
    """Expected-position window argmax (`alignment_utils.py:214-258`)."""
    b, nt, T = similarity.shape
    dev = similarity.device
    window = max(2, int(T * window_size))
    mel_lens = mel_lens.to(torch.int64)
    plens = phoneme_lens.to(torch.int64)
    fpp = mel_lens.to(torch.float32) / torch.clamp(plens, min=1)  # frames per phoneme
    col = torch.arange(T, device=dev)[None, :]
    start = torch.zeros((b,), dtype=torch.int64, device=dev)
    durs = []
    for n in range(nt):
        is_last = n == plens - 1
        valid = n < plens
        expected_end = ((n + 1) * fpp).to(torch.int64)
        ws = torch.maximum(start, expected_end - window)
        we = torch.minimum(mel_lens - 1, expected_end + window)
        inside = (col >= ws[:, None]) & (col <= we[:, None])
        scores = torch.where(inside, similarity[:, n], NEG)
        best_end = torch.maximum(torch.argmax(scores, dim=-1), start)  # never backwards
        end = torch.where(is_last, mel_lens - 1, best_end)
        dur = torch.where(valid & (start <= mel_lens - 1), end - start + 1, 0)
        durs.append(torch.clamp(dur, min=0))
        start = torch.where(valid & ~is_last, end + 1, start)
    return torch.stack(durs, dim=1)


def progressive_alignment_durations(similarity: torch.Tensor, phoneme_lens: torch.Tensor,
                                    mel_lens: torch.Tensor,
                                    shift_range: int = 5) -> torch.Tensor:
    """Uniform split + one parallel boundary-refinement pass
    (`alignment_utils.py:260-334`)."""
    sim = _masked_similarity(similarity, phoneme_lens, mel_lens)
    b, nt, T = sim.shape
    dev = sim.device
    mel_lens = mel_lens.to(torch.int64)
    n_idx = torch.arange(nt + 1, device=dev, dtype=torch.float32)[None, :]
    bounds = (n_idx * mel_lens[:, None] / torch.clamp(phoneme_lens, min=1)[:, None]
              ).to(torch.int64)
    bounds = torch.minimum(bounds, mel_lens[:, None])  # [b, nt+1]
    if nt < 2:
        nb = bounds
    else:
        # moving boundary k right by s reassigns frames [bk, bk+s) from row k
        # to row k-1; its gain is the sum of sim[k-1] - sim[k] over them, taken
        # from the prefix sums of the rows' difference (JAX: the difference of
        # the two rows' prefix sums, equal in exact arithmetic). Where two
        # neighbouring rows are equal (a phoneme twice) the gain is then
        # exactly 0 and the boundary stays, on any device, where the JAX
        # package's rounding decides
        diff = sim[:, : nt - 1] - sim[:, 1:]  # row k-1 minus row k, k = 1 .. nt-1
        csum = torch.nn.functional.pad(torch.cumsum(diff, dim=-1), (1, 0))  # [b, nt-1, T+1]
        bk = bounds[:, 1:nt]  # interior boundaries: [b, nt-1]
        lo_lim = bounds[:, : nt - 1] + 1
        hi_lim = bounds[:, 2:] - 1
        shifts = [s for s in range(-shift_range, shift_range + 1) if s != 0]
        s = torch.tensor(shifts, device=dev)[None, None, :]
        tgt = torch.minimum(torch.maximum(bk[..., None] + s, lo_lim[..., None]),
                            hi_lim[..., None])  # [b, nt-1, S]
        lo = torch.minimum(bk[..., None], tgt)
        hi = torch.maximum(bk[..., None], tgt)
        # an index of -1 (a boundary squeezed against its neighbours when a
        # sample has more phonemes than frames) wraps, as the JAX gather's
        width = csum.shape[-1]
        hi, lo = (torch.where(i < 0, i + width, i) for i in (hi, lo))
        gain = torch.gather(csum, 2, hi) - torch.gather(csum, 2, lo)
        delta = torch.where(tgt > bk[..., None], gain, -gain)
        idx = torch.argmax(delta, dim=-1, keepdim=True)  # the first maximum, as the scan's
        best = torch.gather(delta, 2, idx)[..., 0]
        pick = torch.gather(tgt, 2, idx)[..., 0] - bk
        best_shift = torch.where(best > 0, pick, 0)
        nb = torch.cat([bounds[:, :1], bk + best_shift, bounds[:, nt:]], dim=1)
    nb = torch.cummax(nb, dim=1).values  # keep monotone if parallel shifts collided
    durations = nb[:, 1:] - nb[:, :-1]
    valid = torch.arange(nt, device=dev)[None, :] < phoneme_lens[:, None]
    return torch.where(valid, torch.clamp(durations, min=0), 0)


def monotonic_alignment_durations(similarity: torch.Tensor, phoneme_lens: torch.Tensor,
                                  mel_lens: torch.Tensor,
                                  algorithm: str = "viterbi") -> torch.Tensor:
    """Dispatcher (`alignment_utils.py:337-355`)."""
    if algorithm == "viterbi":
        return viterbi_alignment_durations(similarity, phoneme_lens, mel_lens)
    if algorithm == "window":
        return windowed_alignment_durations(similarity, phoneme_lens, mel_lens)
    if algorithm == "progressive":
        return progressive_alignment_durations(similarity, phoneme_lens, mel_lens)
    raise ValueError(f"unknown alignment algorithm: {algorithm!r}")


# ---------------------------------------------------------------------------
# similarity matrix + duration loss (`trainer.py:925-1019`)


def build_similarity(phoneme_embed: torch.Tensor, mel: torch.Tensor,
                     mel_proj_matrix: torch.Tensor, phoneme_lens: torch.Tensor,
                     mel_lens: torch.Tensor, diag_bias: float = 3.0) -> torch.Tensor:
    """Normalized embedding/mel-projection similarity with diagonal window bias."""
    pe = phoneme_embed / (torch.linalg.vector_norm(phoneme_embed, dim=2, keepdim=True) + 1e-8)
    mp = mel @ mel_proj_matrix
    mp = mp / (torch.linalg.vector_norm(mp, dim=2, keepdim=True) + 1e-8)
    sim = torch.einsum("bnd,btd->bnt", pe, mp)

    b, nt, T = sim.shape
    dev = sim.device
    p = torch.arange(nt, device=dev, dtype=torch.float32)[None, :, None]
    t = torch.arange(T, device=dev, dtype=torch.float32)[None, None, :]
    m_len = mel_lens[:, None, None].to(torch.float32)
    p_len = torch.clamp(phoneme_lens, min=1)[:, None, None].to(torch.float32)
    center = p * m_len / p_len
    window = torch.clamp(m_len / 10.0, min=3.0)
    in_window = (t >= center - window) & (t < center + window)
    sim = sim + torch.where(in_window, diag_bias, 0.0)
    return _masked_similarity(sim, phoneme_lens, mel_lens)


def make_mel_proj_matrix(n_mels: int, embed_dim: int, seed: int = 0) -> np.ndarray:
    """Fixed random projection (`trainer.py:934-939`), created once and reused;
    numpy, so that both packages draw the same matrix."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n_mels, embed_dim)) / math.sqrt(n_mels)).astype(np.float32)


def duration_loss(dur_predictor, align_predictor, mel_proj_matrix: torch.Tensor,
                  phoneme_ids: torch.Tensor, mel: torch.Tensor, mel_lens: torch.Tensor,
                  algorithm: str = "window", deterministic: bool = True, weight_sum=None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked MSE between predicted and MAS-target log durations of
    ``phoneme_ids [b, nt]`` (0 = pad) against ``mel [b, T, n_mels]`` /
    ``mel_lens [b]``. ``align_predictor`` is the frozen copy whose embedding
    rows (``DurationPredictor.embed``, the JAX gather's rows) feed the
    similarity (the JAX package passes its table).

    Returns (loss, mae, target_durations). The MAS target is computed without
    gradient from the frozen embeddings and the fixed mel projection (the
    reference wraps the block in ``torch.no_grad()``, `trainer.py:925`), in
    full fp32 (TF32 off). ``deterministic`` runs the predictor without
    dropout (the trainers always do). ``weight_sum`` maps this call's count
    of phonemes to the one the means divide by (a data rank passes the sum
    over the global batch, as ``CFM.loss`` does)."""
    from eraxvif5tts_tpu_torch.models.modules import fp32_convolutions

    mask = phoneme_ids > 0
    phoneme_lens = mask.sum(dim=1)
    with torch.no_grad(), fp32_convolutions():
        phoneme_embed = align_predictor.embed(phoneme_ids)
        sim = build_similarity(phoneme_embed, mel.float(), mel_proj_matrix, phoneme_lens,
                               mel_lens)
        durations = monotonic_alignment_durations(sim, phoneme_lens, mel_lens, algorithm)
        maskf = mask.to(torch.float32)
        # no zero-length phonemes (`trainer.py:983-987`)
        durations = torch.maximum(durations.to(torch.float32) * maskf, 0.1 * maskf)

    target_logw = torch.log(durations + 1e-6)
    logw = dur_predictor(phoneme_ids, mask, deterministic=deterministic)
    denom = (maskf.sum() if weight_sum is None else weight_sum(maskf.sum())) + 1e-8
    loss = ((logw - target_logw).square() * maskf).sum() / denom
    pred_dur = torch.exp(torch.clamp(logw, -10, 10))
    mae = ((pred_dur - durations).abs() * maskf).sum() / denom
    return loss, mae, durations


# ---------------------------------------------------------------------------
# Curriculum state machines (host side; copies of the JAX package's)


class AlignmentMethodManager:
    """Phase machine (`alignment_utils.py:361-435`): phase 1 = duration-focus
    (window alignment), phase 2 = full model; switch window -> viterbi at epoch 3;
    cosine-decay the duration weight 0.5 -> 0.1 over 10 epochs of phase 2."""

    def __init__(self):
        self.current_method = "window"
        self.phase = 1
        self.initial_dur_weight = 0.5
        self.target_dur_weight = 0.1
        self.decay_epochs = 10
        self.max_decay_steps = None
        self.viterbi_start_epoch = 3

    def set_steps_per_epoch(self, steps_per_epoch: int) -> int:
        self.max_decay_steps = steps_per_epoch * self.decay_epochs
        return self.max_decay_steps

    def update(self, global_update: int, duration_focus_updates: int,
               phase2_start_update: int | None, current_epoch: int | None):
        """Advance the machine; returns (method, weight, transitioned_to_phase2)."""
        transitioned = False
        if self.phase == 1 and global_update >= duration_focus_updates:
            self.phase = 2
            transitioned = True
        if self.phase == 2 and current_epoch is not None and (
            self.current_method != "viterbi" and current_epoch >= self.viterbi_start_epoch
        ):
            self.current_method = "viterbi"
        if self.phase == 2 and phase2_start_update is not None and self.max_decay_steps:
            steps = min(global_update - phase2_start_update, self.max_decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * steps / self.max_decay_steps))
            weight = self.target_dur_weight + (
                self.initial_dur_weight - self.target_dur_weight
            ) * cos
        else:
            weight = self.initial_dur_weight
        return self.current_method, weight, transitioned


class DurationWeightScheduler:
    """Quality-adaptive weight schedule (`trainer.py:36-91`): EMA-smoothed
    coverage/diagonal quality -> sigmoid target, exponential epoch decay,
    rate-limited delta."""

    def __init__(self, total_epochs, initial_weight=1.5, min_weight=0.1,
                 ema_alpha=0.05, slope=8.0, center=0.75, decay_rate=3.0,
                 decay_start_frac=0.1, max_delta=0.01):
        self.total_epochs = total_epochs
        self.initial_weight = initial_weight
        self.min_weight = min_weight
        self.ema_alpha = ema_alpha
        self.slope = slope
        self.center = center
        self.decay_rate = decay_rate
        self.decay_start_epoch = max(1, int(total_epochs * decay_start_frac))
        self.max_delta = max_delta
        self.ema_cov = 0.0
        self.ema_diag = 0.0
        self.prev_weight = initial_weight
        self.phase = 1

    def step(self, update, coverage, diagonal, epoch, steps_per_epoch):
        self.ema_cov = self.ema_alpha * coverage + (1 - self.ema_alpha) * self.ema_cov
        self.ema_diag = self.ema_alpha * diagonal + (1 - self.ema_alpha) * self.ema_diag
        quality = min(1.0, max(0.0, 0.4 * self.ema_cov + 0.6 * self.ema_diag))
        if self.phase == 1:
            return self.initial_weight
        sig = 1.0 / (1.0 + math.exp(-self.slope * (quality - self.center)))
        target = self.min_weight + (1 - sig) * (self.initial_weight - self.min_weight)
        if epoch > self.decay_start_epoch:
            prog = (epoch - self.decay_start_epoch) / (self.total_epochs - self.decay_start_epoch)
            target = self.min_weight + (target - self.min_weight) * math.exp(-self.decay_rate * prog)
        delta = max(-self.max_delta, min(target - self.prev_weight, self.max_delta))
        self.prev_weight = self.prev_weight + delta
        return self.prev_weight
