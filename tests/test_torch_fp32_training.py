"""PyTorch port, fp32 training: what the CPU can check of the fp32 training
attention kernels (`csrc/train_attention_fp32.cu`) and of the trainers'
fp32 hold.

- The kernels' domain: q, k, v all bf16 or all fp32 (mixed dtypes and fp16
  raise), dO in q's dtype, 16-byte aligned, n % 64 == 0 up to 4096.
- Their launch geometry, stated in Python beside the wrappers
  (`forward_geometry_fp32`, `backward_geometry_fp32`), over every n of the
  domain: every row owned by one block, the shared memory within the card's
  232,448 bytes a block and leaving two blocks an SM.
- The TF32 hold: an fp32 model's `Trainer.train_step` and
  `DistillTrainer.train_step` run the loss, its backward and the
  checkpointed blocks' recompute inside one `fp32_convolutions` block, so
  both process-wide TF32 flags are off there even when the caller turned
  them on, and back on after the step; a bf16 model takes no block.

The fp32 arithmetic itself is held elsewhere on the CPU and not repeated
here: `tests/test_torch_training_attention.py:78` holds the plain version
(what the kernels are compared with on the card) on fp32 inputs, with
dropout and a masked sample, against the JAX Pallas kernels in interpret
mode and the dense oracle, forward and gradients within 5e-5, and `:218`
at n = 192 with an empty sample; `tests/test_torch_training.py:142` holds
three fp32 `Trainer` steps to the JAX trainer within 1e-5. The kernels
against the plain version run on the card (`tests/test_torch_cuda.py`,
marker `cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu_torch.configs import ArchConfig
from eraxvif5tts_tpu_torch.models import modules
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.training import distill as tdistill
from eraxvif5tts_tpu_torch.training import trainer as ttr

ARCH = ArchConfig(dim=64, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                  conv_layers=1, dropout=0.1, checkpoint_activations=True,
                  remat_policy="full")
MEL, VOCAB, B, N = 8, 12, 2, 64


def _qkv(dtype=torch.float32, n=128, offset=0):
    flat = torch.zeros(2 * n * 2 * 64 + offset, dtype=dtype)
    return flat[offset:].view(2, n, 2, 64)


LENS = torch.full((2,), 128, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_checks_take_bf16_or_fp32(dtype):
    q = _qkv(dtype)
    tta._check_cuda_args(q, q, q, LENS)
    stats = torch.zeros(2, 2, 128)
    tta._check_backward_args(q, stats, stats, dtype)


@pytest.mark.parametrize("case", ["mixed k", "mixed v", "fp16", "fp64"])
def test_cuda_checks_refuse_other_dtypes(case):
    q = _qkv()
    args = {"mixed k": (q, q.bfloat16(), q), "mixed v": (q.bfloat16(), q.bfloat16(), q),
            "fp16": (q.half(),) * 3, "fp64": (q.double(),) * 3}[case]
    with pytest.raises(TypeError):
        tta._check_cuda_args(*args, LENS)


@pytest.mark.parametrize("case", ["unaligned", "n % 64", "n > 4096", "head dim"])
def test_cuda_checks_refuse_fp32_outside_the_domain(case):
    q = {"unaligned": _qkv(offset=1), "n % 64": _qkv(n=96), "n > 4096": _qkv(n=4160),
         "head dim": torch.zeros(2, 128, 2, 32)}[case]
    with pytest.raises(ValueError):
        tta._check_cuda_args(q, q, q, LENS)


def test_fp32_backward_checks_refuse_other_gradients():
    stats = torch.zeros(2, 2, 128)
    with pytest.raises(ValueError, match="dout"):  # dO in another dtype than q's
        tta._check_backward_args(_qkv(torch.bfloat16), stats, stats, torch.float32)
    with pytest.raises(ValueError, match="dout"):
        tta._check_backward_args(_qkv(offset=2), stats, stats, torch.float32)
    with pytest.raises(ValueError, match="lse"):
        tta._check_backward_args(_qkv(), stats.transpose(1, 2), stats, torch.float32)


@pytest.mark.parametrize("n", list(range(64, 4096 + 1, 64)))
def test_fp32_geometry_covers_every_row_once_within_the_card(n):
    b, h = 3, 16
    fwd, bwd = tta.forward_geometry_fp32(b, n, h), tta.backward_geometry_fp32(b, n, h)
    for geo in (fwd, bwd):
        assert geo["grid"] == (len(geo["blocks"]), h, b)
        assert geo["threads"] == 256 and geo["rows"] == geo["tile"] == 64
        covered = np.zeros(n, np.int64)
        for block, (start, rows) in enumerate(geo["blocks"]):
            assert (start, rows) == (block * geo["rows"], geo["rows"])
            assert start + rows <= n  # no block reads past the sample
            covered[start:start + rows] += 1
        np.testing.assert_array_equal(covered, 1)
        assert geo["blocks_per_sm"] >= 2
    for shared in (fwd["shared_bytes"], bwd["dq_shared_bytes"], bwd["dkv_shared_bytes"]):
        assert 48 * 1024 < shared <= tta.SHARED_LIMIT
        assert 2 * (shared + 1024) <= tta.SM_SHARED


def test_fp32_shared_bytes_add_up():
    tile = 64 * tta.FP32_STRIDE * 4  # a [64, 64] tile padded to 68 floats a row
    bwd = tta.backward_geometry_fp32(1, 4096, 16)
    assert tta.forward_geometry_fp32(1, 4096, 16)["shared_bytes"] == 4 * tile == 69632
    assert bwd["dq_shared_bytes"] == 5 * tile == 87040
    assert bwd["dkv_shared_bytes"] == 6 * tile + 2 * 64 * 4 == 104960
    assert tta.forward_geometry_fp32(1, 4096, 16)["blocks_per_sm"] == 3
    assert bwd["blocks_per_sm"] == 2


# ---- the TF32 hold ----------------------------------------------------------


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture
def tf32_on():
    """Both TF32 flags on, as a caller may leave them; restored after."""
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _watch(monkeypatch):
    """Record the TF32 flags at every block's attention: in the first
    forward, in the checkpointed recompute inside the backward, and where
    the gradient passes its output in the backward. (A module forward hook
    would not see the recompute: the checkpoint reruns the block without
    its hooks.)"""
    seen = {"forward": [], "backward": []}
    attention = modules.train_attention

    def watched(*args, **kwargs):
        seen["forward"].append(_flags())
        out = attention(*args, **kwargs)
        if out.requires_grad:
            out.register_hook(lambda g: seen["backward"].append(_flags()))
        return out

    monkeypatch.setattr(modules, "train_attention", watched)
    return seen


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    text = torch.randint(0, VOCAB, (B, 16), generator=g)
    text[1, 10:] = -1
    return {"mel": torch.randn((B, N, MEL), generator=g), "text": text,
            "lens": torch.tensor([N, N - 9])}


def _student(dtype=None):
    torch.manual_seed(0)
    return DiT(ARCH, VOCAB, MEL, compute_dtype=dtype).train()


def _check_held(seen, depth):
    # each block runs twice (forward, checkpointed recompute) and is passed once backward
    assert len(seen["forward"]) == 2 * depth and len(seen["backward"]) == depth, seen
    assert set(seen["forward"] + seen["backward"]) == {(False, False)}, seen
    assert _flags() == (True, True)


def test_trainer_holds_fp32_through_backward_and_recompute(tf32_on, monkeypatch):
    dit = _student()
    assert dit.dtype == torch.float32
    trainer = ttr.Trainer(cfm=CFM(dit), optimizer=ttr.make_optimizer(num_warmup_updates=1,
                                                                      total_updates=10))
    state = trainer.init_state()
    seen = _watch(monkeypatch)
    state, metrics = trainer.train_step(state, _batch(), torch.Generator().manual_seed(1))
    assert metrics["applied"] == 1.0 and np.isfinite(metrics["loss"])
    _check_held(seen, ARCH.depth)


def test_distill_trainer_holds_fp32_through_backward_and_recompute(tf32_on, monkeypatch):
    torch.manual_seed(1)
    teacher = DiT(dataclasses.replace(ARCH, depth=3, checkpoint_activations=False),
                  VOCAB, MEL).eval()
    student = _student()
    trainer = tdistill.DistillTrainer(
        student_cfm=CFM(student), teacher_transformer=teacher,
        optimizer=ttr.make_optimizer(num_warmup_updates=1, total_updates=10),
        config=tdistill.DistillConfig())
    state = trainer.init_state()
    seen = _watch(monkeypatch)
    state, metrics = trainer.train_step(state, _batch(2), torch.Generator().manual_seed(3))
    assert metrics["skipped"] == 0.0 and np.isfinite(metrics["loss"])
    _check_held(seen, ARCH.depth)


def test_bf16_model_takes_no_fp32_block(tf32_on, monkeypatch):
    """A bf16-compute model's step never enters `fp32_convolutions` (no lock,
    the flags as the caller left them); an fp32 one's does."""
    entered = []
    block = modules.fp32_convolutions

    def counted():
        entered.append(True)
        return block()

    monkeypatch.setattr(modules, "fp32_convolutions", counted)
    seen = _watch(monkeypatch)
    for dtype, want in ((torch.bfloat16, False), (torch.float32, True)):
        entered.clear()
        seen["forward"].clear()
        seen["backward"].clear()
        dit = _student(dtype)
        trainer = ttr.Trainer(cfm=CFM(dit), optimizer=ttr.make_optimizer(
            num_warmup_updates=1, total_updates=10))
        trainer.train_step(trainer.init_state(), _batch(), torch.Generator().manual_seed(1))
        assert bool(entered) == want
        assert set(seen["forward"] + seen["backward"]) == {(not want, not want)}
