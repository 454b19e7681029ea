"""PyTorch port, fp32 training: what the CPU can check of the fp32 training
attention kernels (`csrc/train_attention_fp32.cu`) and of the trainers'
fp32 hold.

- The kernels' domain: q, k, v all bf16 or all fp32 (mixed dtypes and fp16
  raise), dO in q's dtype, 16-byte aligned, n % 64 == 0 up to 6144 (the
  MMDiT's joint sequence).
- Their launch geometry, stated in Python beside the wrappers
  (`forward_geometry_fp32`, `backward_geometry_fp32`), over every n of the
  domain: every row owned by one block, the shared memory within the card's
  232,448 bytes a block and leaving two blocks an SM; the backward's
  shared-memory reads free of bank conflicts.
- The backward's 3xTF32 arithmetic, emulated in numpy (the rna split, the
  mma's k-steps, a fresh accumulator a pass): within the card's limit of a
  float64 reference where one TF32 pass is not.
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
import math

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
    # "n > 4096": past the bound, which is the MMDiT's joint 6144 since kernel
    # 4 takes the joint sequence
    q = {"unaligned": _qkv(offset=1), "n % 64": _qkv(n=96), "n > 4096": _qkv(n=tta.MAX_N + 64),
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


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
@pytest.mark.parametrize("n", list(range(64, 4096 + 1, 64)))
def test_fp32_geometry_covers_every_row_once_within_the_card(n, d):
    b, h = 3, 16
    fwd, bwd = tta.forward_geometry_fp32(b, n, h, d), tta.backward_geometry_fp32(b, n, h, d)
    # the backward's ring: two stages at d = 64 (four warps, 64-row tiles); at
    # 128 the pairs of warps, two stages of 32-key (dq) and 16-query (dk/dv)
    # tiles, the fixed operands in registers (no fixed tile in shared memory)
    assert bwd["bwd_stages"] == 2 and bwd["fixed_tiles"] == 0
    assert (bwd["dq_threads"], bwd["dkv_threads"], bwd["dq_tile"], bwd["dkv_tile"]) == \
        {64: (128, 128, 64, 64), 128: (256, 256, 32, 16)}[d]
    # whole streamed tiles, none past the sample's end
    assert n % bwd["dq_tile"] == n % bwd["dkv_tile"] == 0
    if d == 128:
        assert bwd["own_slots"]  # the slots in a room of their own
    # the forward: four warps at d = 64; at d = 128 two sets of four (eight
    # warps an SM), each set's warps covering the block's rows
    assert fwd["sets"] == {64: 1, 128: 2}[d] and bwd["threads"] == 128
    for geo in (fwd, bwd):
        sets = fwd["sets"] if geo is fwd else 1
        assert geo["grid"] == (len(geo["blocks"]), h, b)
        assert geo["threads"] == 128 * sets and geo["rows"] == geo["tile"] == 64
        assert geo["stride"] == d + 4
        # a warp per m16 tile of the block's rows (in each set)
        assert geo["warps"] * 32 == geo["threads"] and geo["warps"] // sets * 16 == geo["rows"]
        covered = np.zeros(n, np.int64)
        for block, (start, rows) in enumerate(geo["blocks"]):
            assert (start, rows) == (block * geo["rows"], geo["rows"])
            assert start + rows <= n  # no block reads past the sample
            covered[start:start + rows] += 1
        np.testing.assert_array_equal(covered, 1)
        assert geo["blocks_per_sm"] == {64: 2, 128: 1}[d]
    # the forward's ring: two stages of 64 keys at d = 64, one stage of 32 a set at 128
    assert (fwd["stages"], fwd["key_tile"]) == {64: (2, 64), 128: (1, 32)}[d]
    assert bwd["stages"] == 2  # FP32_STAGES, as before; the backward's own ring is bwd_stages
    if d == 128:
        # every key tile of a sample walked by one set: all of them with no key
        # masked, those that hold a valid key with lens inside, none past them
        for length in (n, n - 37, 1, 0):
            tiles = tta.set_key_tiles(n, length, d)
            walked = sorted(t for part in tiles for t in part)
            want = n // 32 if length <= 0 else -(-max(length, 1) // 32)
            assert walked == list(range(want))
            assert all(t % 2 == s for s, part in enumerate(tiles) for t in part)
    for shared in (fwd["shared_bytes"], bwd["dq_shared_bytes"], bwd["dkv_shared_bytes"]):
        assert 48 * 1024 < shared <= tta.SHARED_LIMIT
        assert fwd["blocks_per_sm"] * (shared + 1024) <= tta.SM_SHARED


@pytest.mark.parametrize("d, fwd_bytes, dq_bytes, dkv_bytes, per_sm",
                         [(64, 104448, 104448, 105472, 2), (128, 202752, 184320, 88064, 1)])
def test_fp32_shared_bytes_add_up(d, fwd_bytes, dq_bytes, dkv_bytes, per_sm):
    tile = 64 * (d + 4) * 4  # a [64, d] tile padded to d + 4 floats a row
    fwd, bwd = tta.forward_geometry_fp32(1, 4096, 16, d), tta.backward_geometry_fp32(1, 4096, 16, d)
    stages, fixed = bwd["bwd_stages"], bwd["fixed_tiles"]
    if d == 64:
        # the forward: a ring of two stages of K and V, and their small parts
        assert fwd["stages"] == 2 and fwd["shared_bytes"] == (2 * 2 + 2) * tile == fwd_bytes
    else:
        # the forward: Q's big and small parts, and two sets' one stage of a
        # 32-key K and V tile, big and small (4 x 16,896 bytes a set)
        keys = fwd["key_tile"]
        assert fwd["stages"] == 1 and fwd["sets"] == 2 and keys == 32
        assert fwd["shared_bytes"] == 2 * tile + 2 * 4 * keys * (d + 4) * 4 == fwd_bytes
        # set 1's O and (m, l) for the merge fit in the two sets' room
        assert 64 * d * 4 + 4 * 32 * 16 <= 2 * 4 * keys * (d + 4) * 4
    assert fixed == 0  # the fixed operands in registers at both head dims
    if d == 64:
        # dq: its ring of K and V and their small parts
        assert bwd["dq_shared_bytes"] == (stages * 2 + 2) * tile == dq_bytes
        # dk/dv: Q, dO and the query tile's 64 LSE and 64 D values a stage;
        # Q's and dO's small parts
        assert bwd["dkv_shared_bytes"] == stages * (2 * tile + 2 * 64 * 4) + 2 * tile == dkv_bytes
    else:
        # the pairs: two stages of a tile pair's big and small parts (padded
        # [32, 128] for dq's K and V, [16, 128] for dk/dv's Q and dO), the
        # next tile's two operands unpadded in a raw room, and the slots in a
        # room of their own (dq: two warps' [16, 32] scores a pair, four
        # pairs; dk/dv: P, [16, 16] a pair)
        assert stages == 2
        for key, rows, slots in (("dq", 32, 4 * 2 * 16 * 32 * 4), ("dkv", 16, 4 * 16 * 16 * 4)):
            raw = 2 * rows * d * 4
            assert bwd[f"{key}_tile"] == rows and bwd[f"{key}_raw_bytes"] == raw
            assert bwd[f"{key}_shared_bytes"] == \
                stages * 4 * rows * (d + 4) * 4 + raw + slots == {"dq": dq_bytes, "dkv": dkv_bytes}[key]
        assert (bwd["score_slot_bytes"], bwd["p_slot_bytes"]) == (16384, 4096)
        # one block an SM all the same: eight warps whose registers hold a
        # fixed operand split once (128 a lane) beside their accumulators
        assert tta._per_sm(dkv_bytes) == 2
    assert fwd["blocks_per_sm"] == bwd["blocks_per_sm"] == per_sm


@pytest.mark.parametrize("d", tta.KERNEL_HEAD_DIMS)
def test_fp32_backward_tile_reads_are_conflict_free(d):
    """Every shared-memory read of a streamed tile that the fp32 dq and dk/dv
    kernels make, and the forward core with them (its K tile read as dq's,
    its V tile as dq's K in dQ += dS K; rotating a K chunk reads and writes
    the chunk its thread copied and splits, as the split does), on rows
    padded to FP32_STRIDE (68) floats: the eight rows
    an `ldmatrix` matrix reads (16 bytes each) land in eight distinct bank
    quads, and the 32 lanes of the products' B read (rows 8 j + 2 (lane %
    4) + {0, 1}, the k-step permuted to take the score accumulators as A as
    they lie; column 8 nn + lane / 4) in 32 distinct banks. The plain
    transposed read (rows lane % 4) would collide on the same rows; each
    16-byte copy and split chunk stays 16-byte aligned. At d = 128 and 256
    the rows are d + 4 = 132 and 260 floats, 4 past a multiple of 32 banks
    as 68 is, and an A fragment read from a padded tile as `SharedA` reads
    it (rows lane / 4, columns lane % 4: the d = 256 forward's Q) hits 32
    distinct banks. The pairs of warps' backward at d = 128 and 256 (16-row
    streamed tiles): the same reads, the pairs' slots (dq's scores and dS,
    dk/dv's P: a lane's float4 at consecutive slots) and the raw rooms
    (rows of d floats, no padding: each thread copies and splits its own
    16-byte chunks, a quarter-warp's in one row) meet no conflict; at d =
    256 so do the fixed operands' A fragments by `ldmatrix` (`LdmA`: four
    8-row matrices, rows lane % 8 and + 8, columns 0-3 and 4-7 of the
    k-step), which at d = 128 come from registers (no fixed tile)."""
    stride = tta.forward_geometry_fp32(1, 64, 1, d)["stride"]
    assert stride == (tta.FP32_STRIDE if d == 64 else d + 4)
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    for row0 in range(0, 64, 8):
        for col in range(0, d, 4):  # ldmatrix: one 16-byte row of each of eight rows
            quads = ((row0 + np.arange(8)) * stride + col) % 32 // 4
            assert len(set(quads.tolist())) == 8
    assert len(set(((g * stride + c) % 32).tolist())) == 32  # an A fragment (`SharedA`)
    for j in range(8):
        for nn in range(d // 8):
            for half in range(2):
                banks = ((8 * j + 2 * c + half) * stride + 8 * nn + g) % 32
                assert len(set(banks.tolist())) == 32
    assert len(set(((c * stride + g) % 32).tolist())) < 32
    assert (stride * 4) % 16 == 0 and (64 * stride * 4) % 16 == 0
    if d == 64:
        return
    geo = tta.backward_geometry_fp32(1, 64, 1, d)
    assert (geo["dq_tile"], geo["dkv_tile"]) == tta.FP32_PAIR_TILES[d] == {128: (32, 16),
                                                                          256: (16, 16)}[d]
    assert geo["fixed_tiles"] == {128: 0, 256: 2}[d]
    # the slots: slot (pair, warp, n-tile) * 32 + lane, float4
    for floats in (geo["p_slot_bytes"] // 4, geo["score_slot_bytes"] // 4):
        for slot0 in range(0, floats // 4, 32):
            for quarter in range(4):
                quads = (4 * (slot0 + 8 * quarter + np.arange(8))) % 32 // 4
                assert len(set(quads.tolist())) == 8
    for kk in range(d // 8 if geo["fixed_tiles"] else 0):  # LdmA: matrix m's rows, 16 bytes each
        for mat in range(4):
            rows8 = 8 * (mat & 1) + np.arange(8)
            quads = (rows8 * stride + 8 * kk + 4 * (mat >> 1)) % 32 // 4
            assert len(set(quads.tolist())) == 8
    # the raw rooms and the split of their chunks into padded tiles: chunk i
    # = thread + 256 m at row i / (d / 4), column 4 (i % (d / 4))
    for key in ("dq", "dkv"):
        rows = geo[f"{key}_tile"]
        for m in range(rows * d // 4 // geo["dq_threads"]):
            for quarter in range(geo["dq_threads"] // 8):
                i = 8 * quarter + np.arange(8) + geo["dq_threads"] * m
                for width in (d, stride):  # the raw room's rows, the padded tiles'
                    quads = ((i // (d // 4)) * width + 4 * (i % (d // 4))) % 32 // 4
                    assert len(set(quads.tolist())) == 8
        assert geo[f"{key}_raw_bytes"] % 16 == 0 and (rows * stride * 4) % 16 == 0


# ---- the 3xTF32 arithmetic of the dq and dk/dv kernels, emulated ------------


def tf32_rna(x) -> np.ndarray:
    """`cvt.rna.tf32.f32` on finite fp32: to nearest with ties away from zero,
    10 explicit mantissa bits, the low 13 bits of the result zero."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def toward_zero(x) -> np.ndarray:
    """float64 to fp32, rounded toward zero."""
    x32 = x.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x)
    x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def mma_product(a, b, passes: int, chain: int | None = None, rz: bool = True) -> np.ndarray:
    """``a [M, K] @ b [K, N]`` as the kernels' `mma.sync.m16n8k8` take it:
    k-steps of 8 in order, each adding its exact products (11 x 11 mantissa
    bits fit fp32's 24) to an fp32 accumulator, the sum rounded toward zero
    (``rz``; a model of the tensor core's sum, which is not IEEE round to
    nearest) or to nearest. ``passes`` 3 is 3xTF32 (big = rna(x), small =
    rna(x - big); big * small, small * big, then big * big), 1 a single TF32
    pass on rna(x). With ``chain``, a fresh accumulator every ``chain``
    k-steps, added to the running fp32 sum to nearest (the kernels' scores
    passes); without, one accumulator throughout."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    a_big, b_big = tf32_rna(a), tf32_rna(b)
    terms = [(a_big, b_big)]
    if passes == 3:
        terms = [(a_big, tf32_rna(b - b_big)), (tf32_rna(a - a_big), b_big), (a_big, b_big)]
    total = acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for step, k0 in enumerate(range(0, a.shape[1], 8)):
        for x, y in terms:
            exact = acc.astype(np.float64) + (x[:, k0:k0 + 8].astype(np.float64)
                                              @ y[k0:k0 + 8].astype(np.float64))
            acc = toward_zero(exact) if rz else exact.astype(np.float32)
        if chain is not None and (step + 1) % chain == 0:
            total, acc = total + acc, np.zeros_like(acc)
    return total + acc


def test_tf32_rounding_is_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # of a TF32 mantissa at 1
    x = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 3 * ulp / 2,
                  3.0, -0.0], np.float32)
    want = np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0, -0.0], np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)  # ties go up in magnitude, not to even
    r = np.random.default_rng(5).standard_normal(4096).astype(np.float32) * 10.0
    big = tf32_rna(r)
    assert not (big.view(np.uint32) & 0x1FFF).any()
    assert np.all(np.abs(r - big) <= np.abs(r) * 2.0 ** -11)
    small = tf32_rna(r - big)
    assert np.all(np.abs(r - (big.astype(np.float64) + small)) <= np.abs(r) * 2.0 ** -21)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_3xtf32_backward_holds_the_fp32_limit_where_one_tf32_pass_fails(dropout):
    """dq, dk and dv of b = 1, h = 2, n = 128 (the second head's keys masked
    past 107) with the kernels' arithmetic: the scores (one accumulator over
    d) and the three gradient products (a fresh accumulator every scores
    pass of 32 columns, four k-steps) through :func:`mma_product`, the
    elementwise work in fp32 in the kernels' order. In 3xTF32 they lie
    within chip_smoke's FP32_GRAD_TOL (the limit the card holds the kernels
    to) of a float64 reference; in one TF32 pass beyond it, as the smoke's
    TF32 control is."""
    import chip_smoke

    n, d, seed = 128, 64, 0x5EED
    scale, keep = 1.0 / math.sqrt(d), 1.0 - dropout
    rng = np.random.default_rng(11)
    worst = {3: 0.0, 1: 0.0}
    for hi, length in ((0, n), (1, n - 21)):
        q, k, v, dout = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(4))
        valid = np.arange(n) < length
        keep_mask = (tta.dropout_keep_mask(seed, 0, hi, 0, 0, n, n, n, keep).numpy()
                     if dropout else np.ones((n, n), bool))
        f64 = [x.astype(np.float64) for x in (q, k, v, dout)]
        logits = np.where(valid, f64[0] @ f64[1].T * scale, -1e30)
        lse = np.log(np.exp(logits - logits.max(1, keepdims=True)).sum(1)) + logits.max(1)
        p = np.exp(logits - lse[:, None])
        pd = np.where(keep_mask, p / keep, 0.0)
        dd = (f64[3] * (pd @ f64[2])).sum(1)
        ds = np.where(valid, p * (np.where(keep_mask, f64[3] @ f64[2].T / keep, 0.0)
                                  - dd[:, None]), 0.0)
        want = (ds @ f64[1] * scale, ds.T @ f64[0] * scale, pd.T @ f64[3])
        lse32, dd32 = lse.astype(np.float32), dd.astype(np.float32)
        factor = np.where(keep_mask, np.float32(1.0 / keep), np.float32(0.0))
        for passes in (3, 1):
            s = mma_product(q, k.T, passes)
            p32 = np.exp(np.where(valid, s * np.float32(scale), np.float32(-1e30))
                         - lse32[:, None])
            dp = mma_product(dout, v.T, passes)
            ds32 = np.where(valid, p32 * (dp * factor - dd32[:, None]), np.float32(0.0))
            got = (mma_product(ds32, k, passes, 4) * np.float32(scale),
                   mma_product(ds32.T, q, passes, 4) * np.float32(scale),
                   mma_product((p32 * factor).T, dout, passes, 4))
            for g, w in zip(got, want):
                assert g.dtype == np.float32
                worst[passes] = max(worst[passes], float(np.abs(g - w).max() / np.abs(w).max()))
    assert worst[3] <= chip_smoke.FP32_GRAD_TOL, worst
    assert worst[1] > chip_smoke.FP32_GRAD_TOL, worst


def _rotate(x, cos, sin) -> np.ndarray:
    """Interleaved-pair rotary as the plain version and the kernel round it:
    fl(fl(x cos) + fl(rotate_half(x) sin)), in x's dtype."""
    half = np.empty_like(x)
    half[:, 0::2], half[:, 1::2] = -x[:, 1::2], x[:, 0::2]
    return x * cos + half * sin


def emulate_forward(q, k, v, length: int, passes: int, train: bool, factor=None,
                    cos=None, sin=None) -> tuple[np.ndarray, np.ndarray]:
    """One head of the fp32 forward core (`csrc/fp32_forward.cuh`) in numpy,
    with its arithmetic: q and k rotated in fp32 (``cos`` given), the key
    tiles of 64 up to the last valid one (all where none is valid), each in
    two passes of 32 keys; per pass S = Q K^T through :func:`mma_product`
    (one accumulator over d), the masked logit (-1e30; training's 0 where no
    key is valid), the online softmax in fp32 (the running maximum from
    -inf, alpha = exp(m_old - m_new)), the pass's Pd V in a fresh
    accumulator (``factor`` the keep factors) folded into O as alpha O +
    part; then O / l and LSE = m + log l. ``passes`` 3 is the kernels'
    3xTF32, 1 one TF32 pass."""
    n, d = q.shape
    scale, tile, width = np.float32(1.0 / math.sqrt(d)), 64, 32
    if cos is not None:
        q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    masked = np.float32(0.0 if train and length <= 0 else -1e30)
    tiles = n // tile if length <= 0 else -(-min(length, n) // tile)
    o = np.zeros((n, d), np.float32)
    m = np.full(n, -np.inf, np.float32)
    l = np.zeros(n, np.float32)
    for key0 in range(0, tiles * tile, width):
        keys = slice(key0, key0 + width)
        s = np.where(np.arange(key0, key0 + width) < length,
                     mma_product(q, k[keys].T, passes) * scale, masked)
        m_new = np.maximum(m, s.max(1))
        alpha = np.exp(m - m_new)
        p = np.exp(s - m_new[:, None])
        l = l * alpha + p.sum(1, dtype=np.float32)
        pd = p if factor is None else p * factor[:, keys]
        o = alpha[:, None] * o + mma_product(pd, v[keys], passes)
        m = m_new
    return o / l[:, None], m + np.log(l)


@pytest.mark.parametrize("mode", ["train, dropout 0", "train, dropout 0.1", "serve, rotary",
                                  "serve, no rotary"])
def test_3xtf32_forward_holds_the_fp32_limit_where_one_tf32_pass_fails(mode):
    """The fp32 forwards' arithmetic (:func:`emulate_forward`) at b = 1, h =
    2, n = 192 (three key tiles, six passes), the first head's keys masked past 150 and
    the second with none valid (lens = 0): kernel 4a's (training, its
    dropout) and kernel 1's (serving, with and without rotary). In 3xTF32 O
    lies within chip_smoke's FP32_TOL * (1 + |ref|) of a float64 reference
    and the LSE within LSE_REL_TOL (relative L2); in one TF32 pass O lies
    beyond its limit, as the smoke's TF32 controls do."""
    import chip_smoke
    from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

    n, d, seed = 192, 64, 0xF0D
    train, dropout = mode.startswith("train"), 0.1 if mode.endswith("0.1") else 0.0
    keep = 1.0 - dropout
    cos = sin = None
    if mode == "serve, rotary":
        angles = rotary_freqs(n, d).numpy().astype(np.float32)
        cos, sin = np.cos(angles), np.sin(angles)
    rng = np.random.default_rng(sum(map(ord, mode)))
    worst = {3: [0.0, 0.0], 1: [0.0, 0.0]}
    for hi, length in ((0, 150), (1, 0)):
        q, k, v = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(3))
        factor = None
        if dropout:
            mask = tta.dropout_keep_mask(seed, 0, hi, 0, 0, n, n, n, keep).numpy()
            factor = np.where(mask, np.float32(1.0 / keep), np.float32(0.0))
        q64, k64 = q.astype(np.float64), k.astype(np.float64)
        if cos is not None:
            q64, k64 = _rotate(q64, cos, sin), _rotate(k64, cos, sin)
        logits = q64 @ k64.T / math.sqrt(d)
        if length > 0:
            logits[:, length:] = -1e30
        else:  # every key averaged, as either masked logit gives
            logits[:] = 0.0 if train else -1e30
        top = logits.max(1, keepdims=True)
        e = np.exp(logits - top)
        lse = np.log(e.sum(1)) + top[:, 0]
        p = e / e.sum(1, keepdims=True)
        want = (p if factor is None else p * factor) @ v.astype(np.float64)
        for passes in (3, 1):
            out, got_lse = emulate_forward(q, k, v, length, passes, train, factor, cos, sin)
            assert out.dtype == got_lse.dtype == np.float32
            err = float((np.abs(out - want) / (1 + np.abs(want))).max())
            lse_err = float(np.linalg.norm(got_lse - lse) / np.linalg.norm(lse))
            worst[passes] = [max(worst[passes][0], err), max(worst[passes][1], lse_err)]
    assert worst[3][0] <= chip_smoke.FP32_TOL, worst
    if train:  # serving writes no LSE
        assert worst[3][1] <= chip_smoke.LSE_REL_TOL, worst
    assert worst[1][0] > chip_smoke.FP32_TOL, worst


def emulate_forward_sets(q, k, v, length: int, train: bool, factor=None,
                         sets: int = tta.FP32_SETS) -> tuple[np.ndarray, np.ndarray]:
    """One head of the two-set fp32 forward (`csrc/fp32_forward.cuh`
    ``forward_sets``, d = 128 and 256) in numpy, in 3xTF32: key tiles of
    ``FP32_SET_KEYS[d]`` up to the last valid one (all where none is valid),
    set s walking tiles s, s + ``sets``, ... with its own online softmax (S
    through :func:`mma_product` as two chains, the even k-steps of 8 and the
    odd ones, added in fp32; the masked logit, the running maximum from
    -inf, the tile's Pd V in a fresh accumulator folded as fmaf(alpha, O,
    part)); then the merge: m the larger maximum, each set's l and O scaled
    by exp(m_s - m) (0 for a set that saw no tile), O / l and LSE = m + log
    l. ``sets`` = 1 is one walk over every tile."""
    n, d = q.shape
    scale, keys = np.float32(1.0 / math.sqrt(d)), tta.FP32_SET_KEYS[d]
    masked = np.float32(0.0 if train and length <= 0 else -1e30)
    steps = np.arange(d).reshape(-1, 8)  # the columns of each k-step
    even, odd = steps[0::2].ravel(), steps[1::2].ravel()
    parts = []
    for tiles in (tta.set_key_tiles(n, length, d) if sets == 2 else
                  [sorted(sum(tta.set_key_tiles(n, length, d), []))]):
        o = np.zeros((n, d), np.float32)
        m = np.full(n, -np.inf, np.float32)
        l = np.zeros(n, np.float32)
        for t in tiles:
            cols = slice(t * keys, (t + 1) * keys)
            kt = k[cols].T
            scores = mma_product(q[:, even], kt[even], 3) + mma_product(q[:, odd], kt[odd], 3)
            s = np.where(np.arange(t * keys, (t + 1) * keys) < length, scores * scale, masked)
            m_new = np.maximum(m, s.max(1))
            alpha = np.exp(m - m_new)
            p = np.exp(s - m_new[:, None])
            l = l * alpha + p.sum(1, dtype=np.float32)
            pd = p if factor is None else p * factor[:, cols]
            part = mma_product(pd, v[cols], 3)
            o = (alpha[:, None].astype(np.float64) * o + part).astype(np.float32)
            m = m_new
        parts.append((m, l, o))
    if len(parts) == 1:
        (m, l, o), = parts
        return o / l[:, None], m + np.log(l)
    (m0, l0, o0), (m1, l1, o1) = parts
    m = np.maximum(m0, m1)
    a0, a1 = np.exp(m0 - m), np.exp(m1 - m)
    l = a0 * l0 + a1 * l1
    o = a0[:, None] * o0 + a1[:, None] * o1
    return o / l[:, None], m + np.log(l)


# (n, valid keys) a case: every key averaged (lens = 0); every valid key in
# set 0's first tile (set 1 sees none); an odd count of key tiles
SET_CASES = {128: ((128, 0), (128, 20), (128, 80)), 256: ((64, 0), (64, 10), (64, 40))}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("d", [128, 256])
def test_two_set_merge_holds_the_fp32_limit(d, train):
    """The two-set forward's arithmetic (:func:`emulate_forward_sets`) for a
    sample with no valid key, one whose valid keys all lie in set 0's first
    tile, and one with an odd number of key tiles (set 0 walks one more),
    kernel 4a's mode with dropout 0.1 and kernel 1's without: O within
    chip_smoke's FP32_TOL * (1 + |ref|) of a float64 reference and the LSE
    within LSE_REL_TOL. Where set 1 sees no tile the merge adds exactly
    nothing: the bits are one walk's over the same tiles."""
    import chip_smoke

    rng = np.random.default_rng(d + train)
    keep = 0.9 if train else 1.0
    for hi, (n, length) in enumerate(SET_CASES[d]):
        tiles = tta.set_key_tiles(n, length, d)
        q, k, v = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(3))
        factor = None
        if train:
            mask = tta.dropout_keep_mask(0xC0FFEE, 0, hi, 0, 0, n, n, n, keep).numpy()
            factor = np.where(mask, np.float32(1.0 / keep), np.float32(0.0))
        logits = q.astype(np.float64) @ k.astype(np.float64).T / math.sqrt(d)
        if length > 0:
            logits[:, length:] = -1e30
        else:
            logits[:] = 0.0 if train else -1e30
        top = logits.max(1, keepdims=True)
        e = np.exp(logits - top)
        lse = np.log(e.sum(1)) + top[:, 0]
        p = e / e.sum(1, keepdims=True)
        want = (p if factor is None else p * factor) @ v.astype(np.float64)
        out, got_lse = emulate_forward_sets(q, k, v, length, train, factor)
        assert out.dtype == got_lse.dtype == np.float32
        assert float((np.abs(out - want) / (1 + np.abs(want))).max()) <= chip_smoke.FP32_TOL
        assert float(np.linalg.norm(got_lse - lse) / np.linalg.norm(lse)) <= \
            chip_smoke.LSE_REL_TOL
        if not tiles[1]:
            one = emulate_forward_sets(q, k, v, length, train, factor, sets=1)
            np.testing.assert_array_equal(out, one[0])
            np.testing.assert_array_equal(got_lse, one[1])
    assert [len(t) for t in tta.set_key_tiles(*SET_CASES[d][1], d)] == [1, 0]
    assert [len(t) for t in tta.set_key_tiles(*SET_CASES[d][2], d)] == [2, 1]


@pytest.mark.parametrize("d", [128, 256])
def test_two_set_shared_reads_are_conflict_free(d):
    """The shared-memory traffic of the two-set forward (`forward_sets`), on
    rows padded to d + 4 floats: the Q A fragments every warp of both sets
    reads (rows lane / 4 and + 8, columns 8 kk + lane % 4 and + 4; at d = 128
    from Q's big and small tiles alike) hit 32 distinct banks; the split K
    tile's `ldmatrix` reads (each matrix's eight 16-byte rows) eight
    distinct bank quads; the products' B reads of the split V tile (rows 8 j
    + 2 (lane % 4) + {0, 1} of the tile's kN n-tiles, column 64 half + 8 nn
    + lane / 4) 32 distinct banks; each 16-byte copy, rotation and split of
    a chunk (a set's 128 threads over a tile, all 256 over Q) eight distinct
    quads a quarter-warp; the merge's float4 writes and reads, a lane's
    registers at consecutive slots, likewise. Every tile starts 16-byte
    aligned."""
    geo = tta.forward_geometry_fp32(1, 64, 1, d)
    stride, keys = geo["stride"], geo["key_tile"]
    assert stride == d + 4 and keys == tta.FP32_SET_KEYS[d]
    lanes = np.arange(32)
    g, c = lanes // 4, lanes % 4
    for warp in range(4):
        for kk in range(d // 8):
            for at in (0, 8 * stride, 4, 8 * stride + 4):  # a0, a1, a2, a3
                banks = ((16 * warp + g) * stride + c + 8 * kk + at) % 32
                assert len(set(banks.tolist())) == 32
    for jp in range(keys // 16):  # the scores' ldmatrix.x4 of two n-tiles
        for kk in range(d // 8):
            for mat in range(4):
                rows = 16 * jp + 8 * (mat >> 1) + np.arange(8)
                quads = (rows * stride + 8 * kk + 4 * (mat & 1)) % 32 // 4
                assert len(set(quads.tolist())) == 8
    for j in range(keys // 8):  # O += Pd V: B at rows 8 j + 2 c + {0, 1}
        for half in range(d // 64):
            for nn in range(8):
                for odd in range(2):
                    banks = ((8 * j + 2 * c + odd) * stride + 64 * half + 8 * nn + g) % 32
                    assert len(set(banks.tolist())) == 32
    for threads, rows in ((128, keys), (256, 64)):  # chunk i = thread + threads m
        for m in range(rows * d // 4 // threads):
            for quarter in range(threads // 8):
                i = 8 * quarter + np.arange(8) + threads * m
                quads = ((i // (d // 4)) * stride + 4 * (i % (d // 4))) % 32 // 4
                assert len(set(quads.tolist())) == 8
    for nn in range(d // 8):  # the merge: slot (warp * d / 8 + nn) * 32 + lane, float4
        slots = (3 * (d // 8) + nn) * 32 + lanes
        for quarter in range(4):
            quads = (4 * slots[8 * quarter:8 * quarter + 8]) % 32 // 4
            assert len(set(quads.tolist())) == 8
    assert (keys * stride * 4) % 16 == 0 and (64 * stride * 4) % 16 == 0


def chained_product(a, b, chains: int) -> np.ndarray:
    """``a @ b`` as the d = 128 and 256 backward's scores take it: k-step kk (8
    columns of ``a``) into chain kk % ``chains``, each chain one accumulator
    (:func:`mma_product`, 3xTF32), the chains added in order in fp32."""
    steps = np.arange(a.shape[1]).reshape(-1, 8)
    total = None
    for i in range(chains):
        cols = steps[i::chains].ravel()
        part = mma_product(a[:, cols], b[cols], 3)
        total = part if total is None else total + part
    return total


# the pairs' score chains at each head dim: dq's and dk/dv's
# (`Fp32DqPairs` / `Fp32DkvPairs` kChains in `csrc/train_attention_fp32.cu`)
PAIR_CHAINS = {128: (2, 2), 256: (4, 2)}


def emulate_pairs_backward(q, k, v, dout, length: int, factor=None):
    """One head of the fp32 dq and dk/dv kernels at d = 128 and 256 in numpy,
    in their order (`csrc/train_attention_fp32.cu`, the pairs of warps): the
    forward's LSE and D = rowsum(dO * O) from float64, rounded to fp32 as the
    kernels read them; streamed tiles of `FP32_PAIR_TILES[d]` rows (dq's
    keys, dk/dv's queries), scores in `PAIR_CHAINS[d]` chains.

    dq: the key tiles up to the last valid one (none where no key is valid:
    dq is zero); per tile S = Q K^T and dP = dO V^T, each warp of the pair
    computing one, trading halves, forming dS of half the tile's n-tiles
    and trading it, so that both hold the same dS; dQ's two column halves
    (one a warp) each take the tile's dS K in a fresh accumulator, added to
    the output in fp32. dk/dv: every query tile; S^T and dP^T; warp A's P
    handed to warp B with its sign bit set
    where the keep bit drops the element, B taking |x| and the factor from
    the sign; dV += Pd^T dO and dK += dS^T Q a fresh accumulator a tile.
    Returns (dq, dk, dv, the handed-over P and factors as B reads them, as A
    made them)."""
    n, d = q.shape
    (rows, dkv_rows), scale = tta.FP32_PAIR_TILES[d], np.float32(1.0 / math.sqrt(d))
    dq_chains, dkv_chains = PAIR_CHAINS[d]
    keep_f = np.ones((n, n), np.float32) if factor is None else factor
    masked = np.float32(0.0 if length <= 0 else -1e30)
    valid = np.arange(n) < length
    f64 = [x.astype(np.float64) for x in (q, k, v, dout)]
    logits = np.where(valid, f64[0] @ f64[1].T / math.sqrt(d), float(masked))
    top = logits.max(1, keepdims=True)
    lse = (np.log(np.exp(logits - top).sum(1)) + top[:, 0]).astype(np.float32)
    p64 = np.exp(logits - lse.astype(np.float64)[:, None])
    dd = (f64[3] * ((p64 * keep_f) @ f64[2])).sum(1).astype(np.float32)

    dq = np.zeros((n, d), np.float32)
    halves = np.zeros((n, d), np.float32)
    tiles = 0 if length <= 0 else -(-min(length, n) // rows)
    for t in range(tiles):
        keys = slice(t * rows, (t + 1) * rows)
        s = chained_product(q, k[keys].T, dq_chains)
        dp = chained_product(dout, v[keys].T, dq_chains)
        ok = valid[keys]
        p = np.exp(np.where(ok, s * scale, masked) - lse[:, None])
        ds = np.where(ok, p * (dp * keep_f[:, keys] - dd[:, None]), np.float32(0.0))
        dq = dq + mma_product(ds, k[keys], 3)
        halves = halves + np.concatenate(
            [mma_product(ds, k[keys][:, c:c + d // 2], 3) for c in (0, d // 2)], axis=1)
    np.testing.assert_array_equal(dq, halves)  # a warp's half of the columns is the same sum

    dk = np.zeros((n, d), np.float32)
    dv = np.zeros((n, d), np.float32)
    handed = []
    for t in range(n // dkv_rows):
        queries = slice(t * dkv_rows, (t + 1) * dkv_rows)
        st = chained_product(k, q[queries].T, dkv_chains)
        dpt = chained_product(v, dout[queries].T, dkv_chains)
        p = np.exp(np.where(valid[:, None], st * scale, masked) - lse[None, queries])
        f = keep_f[queries].T
        x = np.where(f != 0, p, -p)  # A: P, its sign bit set where dropped
        p_b = np.abs(x)              # B
        f_b = np.where(np.signbit(x), np.float32(0.0), keep_f.max())
        handed.append((p_b, f_b, p, f))
        dst = np.where(valid[:, None], p_b * (dpt * f_b - dd[None, queries]), np.float32(0.0))
        dv = dv + mma_product(p * f, dout[queries], 3)
        dk = dk + mma_product(dst, q[queries], 3)
    return dq * scale, dk * scale, dv, handed


# (n, valid keys) a case: every key averaged (lens = 0); every valid key in
# the first key tile; an odd count of 16-key tiles (three; two of d = 128's
# 32-key dq tiles, the second part masked), the second block of keys wholly
# masked
PAIR_CASES = ((64, 0), (64, 9), (128, 40))


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_pair_backward_holds_the_fp32_limit(dropout, d):
    """The d = 128 and 256 dq and dk/dv arithmetic (:func:`emulate_pairs_backward`)
    for a sample with no valid key, one whose valid keys all lie in one
    tile and one with an odd count of key tiles and a block of keys all
    masked, at dropout 0 and 0.1: dq, dk and dv within chip_smoke's
    FP32_GRAD_TOL of their float64 scale; P and the keep factor reach the
    dK warp bit for bit through the sign bit; masked keys get exactly zero
    dk and dv, and dq is exactly zero where no key is valid."""
    import chip_smoke

    keep = 1.0 - dropout
    rng = np.random.default_rng(d + int(dropout * 10))
    for hi, (n, length) in enumerate(PAIR_CASES):
        q, k, v, dout = (rng.standard_normal((n, d)).astype(np.float32) for _ in range(4))
        factor = None
        if dropout:
            mask = tta.dropout_keep_mask(0x5A1E, 0, hi, 0, 0, n, n, n, keep).numpy()
            factor = np.where(mask, np.float32(1.0) / np.float32(keep), np.float32(0.0))
        valid = np.arange(n) < length
        f64 = [x.astype(np.float64) for x in (q, k, v, dout)]
        logits = f64[0] @ f64[1].T / math.sqrt(d)
        logits = np.where(valid, logits, -1e30) if length > 0 else np.zeros_like(logits)
        p = np.exp(logits - logits.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        f = np.ones((n, n)) if factor is None else factor.astype(np.float64)
        dd = (f64[3] * ((p * f) @ f64[2])).sum(1)
        ds = np.where(valid, p * (f64[3] @ f64[2].T * f - dd[:, None]), 0.0)
        want = (ds @ f64[1] / math.sqrt(d), ds.T @ f64[0] / math.sqrt(d), (p * f).T @ f64[3])
        dq, dk, dv, handed = emulate_pairs_backward(q, k, v, dout, length, factor)
        for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            assert got.dtype == np.float32
            scale = np.abs(w).max()
            if scale == 0.0:
                np.testing.assert_array_equal(got, 0.0, err_msg=name)
            else:
                assert float(np.abs(got - w).max() / scale) <= chip_smoke.FP32_GRAD_TOL, name
        for p_b, f_b, p_a, f_a in handed:
            np.testing.assert_array_equal(p_b.view(np.uint32), p_a.view(np.uint32))
            np.testing.assert_array_equal(f_b, f_a)
        if length > 0:
            np.testing.assert_array_equal(dk[length:], 0.0)
            np.testing.assert_array_equal(dv[length:], 0.0)
        else:
            np.testing.assert_array_equal(dq, 0.0)
    dq_rows, dkv_rows = tta.FP32_PAIR_TILES[d]
    assert -(-PAIR_CASES[1][1] // dq_rows) == -(-PAIR_CASES[1][1] // dkv_rows) == 1
    assert -(-PAIR_CASES[2][1] // 16) == 3 and PAIR_CASES[2][1] % dq_rows > 0


def test_pass_partials_bound_the_drift_of_an_accumulator_rounded_toward_zero():
    """Why the kernels add each pass's products to the output in fp32 on the
    CUDA cores: a row of dq sums 4096 keys (512 k-steps, 1,536 mma). With the
    sums rounded toward zero (:func:`mma_product`'s model), one accumulator
    over the row drifts: on an H100, dq reached 5.0e-5 of its scale at n =
    4096 that way, past FP32_GRAD_TOL. Fresh accumulators every four k-steps
    keep the error at fp32's level, as rounding to nearest throughout does."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((16, 4096)) * np.exp(rng.standard_normal((16, 4096)))
         * 1e-3).astype(np.float32)
    b = rng.standard_normal((4096, 64)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)

    def err(got):
        return float(np.abs(got - want).max() / np.abs(want).max())

    passes, chain = err(mma_product(a, b, 3, 4)), err(mma_product(a, b, 3))
    nearest = err(mma_product(a, b, 3, rz=False))
    assert passes <= 2e-6 and nearest <= 2e-6
    assert chain > 10 * passes, (chain, passes)


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
