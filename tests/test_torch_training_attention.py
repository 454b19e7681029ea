"""PyTorch port, training attention and dropout: the position-hash masks bit
for bit against the JAX functions, and the port's `train_attention` (its
plain version, which CPU tensors take) against the JAX Pallas kernel in
interpret mode and its dense oracle, forward and q/k/v gradients.

Sizes as `tests/test_train_attention.py`: B = 2, N = 256, H = 4, D = 64,
fp32. Tolerances: masks and hash dropout exact; attention 5e-5 absolute (the
JAX test's own bound for its kernel against the dense oracle). The bf16 case
at N = 192 (a length the CUDA backward's 128-row blocks do not divide, a
sample with no valid key) is held to 3e-2 relative L2: both sides round P to
bf16 before the PV product but sum in other orders, and the outputs and
gradients themselves are bf16 (2^-8 relative a value). The backward kernels'
launch geometry is plain Python beside the wrappers and is checked for every
n of the domain.
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
    tta._check_cuda_args(q.float(), q.float(), q.float(), lens)  # the fp32 kernels' domain
    with pytest.raises(TypeError, match="one dtype"):
        tta._check_cuda_args(q, q.float(), q, lens)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tta._check_cuda_args(q.half(), q.half(), q.half(), lens)
    bad_n = torch.zeros(2, 96, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tta._check_cuda_args(bad_n, bad_n, bad_n, lens)
    wide = torch.zeros(2, 128, 2, 128, dtype=torch.bfloat16)  # d = 128: the second build
    tta._check_cuda_args(wide, wide, wide, lens)
    library = torch.zeros(2, 128, 2, 256, dtype=torch.bfloat16)  # d = 256: kernel 6's role
    tta._check_cuda_args(library, library, library, lens)
    tta._check_cuda_args(library.float(), library.float(), library.float(), lens)
    for dtype in (torch.bfloat16, torch.float32):
        bad_d = torch.zeros(2, 128, 2, 32, dtype=dtype)  # no kernel is built
        with pytest.raises(ValueError, match="head dim"):
            tta._check_cuda_args(bad_d, bad_d, bad_d, lens)
    t = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tta._check_cuda_args(t, t, t, lens)
    with pytest.raises(ValueError, match="lens"):
        tta._check_cuda_args(q, q, q, lens[:1])


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
@pytest.mark.parametrize("n", list(range(64, 4096 + 1, 64)))
def test_backward_geometry_covers_every_row_once_within_the_card(n, d):
    b, h = 3, 16
    geo = tta.backward_geometry(b, n, h, d)
    assert geo["grid"] == (len(geo["warpgroups"]), h, b)
    assert geo["threads"] == 128 * (geo["rows"] // geo["tile"] + 1)
    covered = np.zeros(n, np.int64)
    for block, groups in enumerate(geo["warpgroups"]):
        assert 1 <= len(groups) <= geo["rows"] // geo["tile"]
        for start, rows in groups:
            # a warpgroup's rows lie in its block and inside the sample
            assert rows == geo["tile"] and start % geo["tile"] == 0
            assert block * geo["rows"] <= start and start + rows <= (block + 1) * geo["rows"]
            covered[start:start + rows] += 1  # raises nothing past n: checked below
            assert start + rows <= n
    np.testing.assert_array_equal(covered, 1)
    assert geo["stages"] >= 2 and geo["shared_bytes"] <= tta.SHARED_LIMIT
    # the tensor map keeps n a dimension of its own: a tile that started past
    # a sample's end would read zeros, never the next sample
    tm = geo["tensor_map"]
    assert tm["dims"] == (d, h, n, b) and tm["box"] == (64, 1, geo["tile"], 1)
    assert tm["strides"] == (2 * d, h * 2 * d, n * h * 2 * d)
    assert all(stride % 16 == 0 for stride in tm["strides"])
    assert tm["box"][0] * 2 == 128  # one 128-byte swizzle atom wide, a panel
    assert tm["panels"] == tuple(range(0, d, 64))
    # setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168, at both head dims
    assert 128 * geo["registers"][0] + 256 * geo["registers"][1] <= 384 * 168


@pytest.mark.parametrize("d, shared, own, ring", [(64, 101448, 32768, 4 * 16896),
                                                  (128, 199752, 65536, 4 * 33280)])
def test_backward_geometry_shared_bytes_add_up(d, shared, own, ring):
    geo = tta.backward_geometry(1, 4096, 16, d)
    tile = geo["tile"] * d * 2
    assert 2 * (geo["rows"] // geo["tile"]) * tile == own
    assert geo["stages"] * (2 * tile + 2 * geo["tile"] * 4) == ring
    assert geo["shared_bytes"] == 1024 + own + ring + 8 * (2 * geo["stages"] + 1) == shared


def test_backward_rejects_unaligned_gradients():
    dout = torch.zeros(2 * 64 * 2 * 64 + 8, dtype=torch.bfloat16)[8:].view(2, 64, 2, 64)
    stats = torch.zeros(2, 2, 64)
    tta._check_backward_args(dout, stats, stats)
    odd = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, 64)
    with pytest.raises(ValueError, match="dout"):
        tta._check_backward_args(odd, stats, stats)
    with pytest.raises(ValueError, match="lse"):
        tta._check_backward_args(dout, stats.transpose(1, 2), stats)
    with pytest.raises(ValueError, match="dd"):
        tta._check_backward_args(dout, stats, stats.half())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_reference_at_n192_with_an_empty_sample_matches_jax():
    """n = 192, lens [192, 0, 155], dropout 0.1, bf16: the plain version (what
    the card's kernels are held against at this shape) against the JAX
    package on the CPU: its Pallas kernels in interpret mode where its gate
    admits the shape, else its dense oracle."""
    n, h = 192, 4
    rng = np.random.default_rng(5)
    q, k, v, dout = (rng.standard_normal((3, n, h, D)).astype(np.float32) for _ in range(4))
    lens = np.array([192, 0, 155], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    seed = tta.attention_seed(_key_words(9))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dout))
    jmask = jnp.asarray(mask)

    if jta.can_use_train_kernel(n, D, jnp.bfloat16):
        def jax_fn(q, k, v):
            return jta.train_attention(q, k, v, key_valid=jmask, dropout_rate=0.1,
                                       dropout_rng=jax.random.key(9), interpret=True)
    else:
        def jax_fn(q, k, v):
            return jta.dense_reference(q, k, v, key_valid=jmask, dropout_rate=0.1,
                                       seed=int(np.int32(np.uint32(seed))))

    want_o, vjp = jax.vjp(jax_fn, jq, jk, jv)
    want = [np.asarray(t.astype(jnp.float32)) for t in (want_o, *vjp(jdo.astype(want_o.dtype)))]

    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    out = tta.train_attention_reference(tq, tk, tv, torch.from_numpy(lens), 0.1, seed)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout).bfloat16())
    got = [t.detach().float().numpy() for t in (out, *grads)]
    assert all(np.isfinite(a).all() for a in got)
    # the empty sample's padded rows are kept too: both sides average every key
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel_l2(a, b) <= 3e-2, (name, _rel_l2(a, b))
    # masked keys receive zero dk; the empty sample's dk is zero everywhere
    assert np.abs(got[2][2, 155:]).max() == 0.0 and np.abs(got[2][1]).max() == 0.0
    assert np.abs(got[3][2, 155:]).max() == 0.0 and np.abs(got[3][1]).max() > 0.0
