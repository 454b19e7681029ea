"""PyTorch port, training attention and dropout: the position-hash masks bit
for bit against the JAX functions, and the port's `train_attention` (its
plain version, which CPU tensors take) against the JAX Pallas kernel in
interpret mode and its dense oracle, forward and q/k/v gradients.

Sizes as `tests/test_train_attention.py`: B = 2, N = 256, H = 4, D = 64,
fp32. Tolerances: masks and hash dropout exact; attention 5e-5 absolute (the
JAX test's own bound for its kernel against the dense oracle).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.ops import dropout as jdrop
from eraxvif5tts_tpu.ops import train_attention as jta
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.ops.dropout import hash_dropout
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.serving_attention import serving_attention_reference

B, N, H, D = 2, 256, 4, 64
SEEDS = [0, 7, 0x7FFFFFFF, 0x80000001, 0xFFFFFFFF]  # the last two with the top bit set


def _key_words(seed):
    return [int(w) for w in np.asarray(jax.random.key_data(jax.random.key(seed))).reshape(-1)]


@pytest.mark.parametrize("keep", [0.9, 0.5])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_bit_identical_to_jax(seed, keep):
    for b_idx, h_idx, q0, k0, bq, bk, n in ((0, 0, 0, 0, 64, 64, 256),
                                            (1, 3, 128, 64, 64, 128, 256),
                                            (8, 15, 4032, 3968, 64, 128, 4096)):
        want = jta.dropout_keep_mask(jnp.uint32(seed), b_idx, h_idx, q0, k0, bq, bk, n, keep)
        got = tta.dropout_keep_mask(seed, b_idx, h_idx, q0, k0, bq, bk, n, keep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_hash_dropout_bit_identical_to_jax(seed, rate, dtype):
    x = np.random.default_rng(seed % 97).standard_normal((3, 37, 24)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jdrop.hash_dropout(jnp.asarray(x, jdt), rate, jax.random.key(seed))
    got = hash_dropout(torch.from_numpy(x).to(tdt), rate, _key_words(seed))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert hash_dropout(torch.from_numpy(x), 0.0, _key_words(seed)) is not None


@pytest.mark.parametrize("seed", SEEDS)
def test_attention_seed_matches_jax_derivation(seed):
    kd = jax.random.key_data(jax.random.key(seed)).reshape(-1)
    want = (jta._fmix32(kd[0].astype(jnp.uint32))
            ^ jta._fmix32(kd[-1].astype(jnp.uint32) + jnp.uint32(0x9E3779B9)))
    assert tta.attention_seed(_key_words(seed)) == int(want)


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, N, H, D)).astype(np.float32) for _ in range(3))
    lens = np.array([N, 150], np.int32)
    return q, k, v, lens


def test_train_attention_matches_pallas_interpret_and_dense_with_dropout():
    q, k, v, lens = _inputs()
    mask = np.arange(N)[None, :] < lens[:, None]
    key = jax.random.key(7)
    seed = tta.attention_seed(_key_words(7))
    jmask = jnp.asarray(mask)
    out_mask = jmask[:, :, None, None]

    def loss_kernel(q, k, v):
        o = jta.train_attention(q, k, v, key_valid=jmask, dropout_rate=0.1,
                                dropout_rng=key, interpret=True)
        return jnp.sum(jnp.where(out_mask, o, 0.0) ** 2), o

    def loss_dense(q, k, v):
        o = jta.dense_reference(q, k, v, key_valid=jmask, dropout_rate=0.1,
                                seed=int(np.int32(np.uint32(seed))))
        return jnp.sum(jnp.where(out_mask, o, 0.0) ** 2), o

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tta.train_attention(tq, tk, tv, key_valid=torch.from_numpy(mask),
                              dropout_rate=0.1, seed=seed)
    (out * torch.from_numpy(mask)[:, :, None, None]).pow(2).sum().backward()
    got = [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    for loss in (loss_kernel, loss_dense):
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        want = [np.asarray(o)] + [np.asarray(g) for g in grads]
        # padded query rows differ in nothing the caller keeps: compare valid rows
        np.testing.assert_allclose(got[0] * mask[:, :, None, None],
                                   want[0] * mask[:, :, None, None], atol=5e-5)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, atol=5e-5)
    # padded keys receive zero dk / dv
    assert np.abs(got[2][1, 150:]).max() == 0.0 and np.abs(got[3][1, 150:]).max() == 0.0


def test_train_attention_without_dropout_is_serving_attention():
    """keep = 1 (the dropout-free training role of the library flash kernel):
    the same function as the serving attention without rotary."""
    q, k, v, lens = _inputs()
    lens = np.array([0, 150], np.int32)  # a sample with no valid key averages every key
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    mask = lens_to_mask(torch.from_numpy(lens), N)
    got = tta.train_attention(tq, tk, tv, key_valid=mask)
    want = serving_attention_reference(tq, tk, tv, torch.from_numpy(lens))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got).all()


def test_train_attention_seed_determinism():
    q, k, v, _ = _inputs()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = tta.train_attention(tq, tk, tv, dropout_rate=0.2, seed=3)
    torch.testing.assert_close(tta.train_attention(tq, tk, tv, dropout_rate=0.2, seed=3), a,
                               rtol=0, atol=0)
    assert (tta.train_attention(tq, tk, tv, dropout_rate=0.2, seed=4) - a).abs().max() > 1e-3


def test_reference_batch_offset_gives_a_slice_its_masks_in_the_batch():
    q, k, v, lens = _inputs()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tl = torch.from_numpy(lens)
    whole = tta.train_attention_reference(tq, tk, tv, tl, 0.1, seed=11)
    part = tta.train_attention_reference(tq[1:], tk[1:], tv[1:], tl[1:], 0.1, seed=11,
                                         batch_offset=1)
    torch.testing.assert_close(part, whole[1:], rtol=0, atol=0)
    unsalted = tta.train_attention_reference(tq[1:], tk[1:], tv[1:], tl[1:], 0.1, seed=11)
    assert (unsalted - whole[1:]).abs().max() > 1e-3


def test_train_attention_rejects_what_the_kernels_do_not_take():
    q = torch.zeros(2, 128, 2, 64, dtype=torch.bfloat16)
    lens = torch.full((2,), 128, dtype=torch.int32)
    tta._check_cuda_args(q, q, q, lens)
    with pytest.raises(TypeError, match="bfloat16"):
        tta._check_cuda_args(q.float(), q.float(), q.float(), lens)
    bad_n = torch.zeros(2, 96, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tta._check_cuda_args(bad_n, bad_n, bad_n, lens)
    bad_d = torch.zeros(2, 128, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tta._check_cuda_args(bad_d, bad_d, bad_d, lens)
    t = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tta._check_cuda_args(t, t, t, lens)
    with pytest.raises(ValueError, match="lens"):
        tta._check_cuda_args(q, q, q, lens[:1])
