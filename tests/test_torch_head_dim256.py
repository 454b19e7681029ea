"""PyTorch port, head dim 256 (the JAX package's library flash kernel, kernel
6, `eraxvif5tts_tpu/ops/attention.py:38`, which it sends d in (64, 128, 256)
at `:202`): the port's attention wrappers (their plain versions, which CPU
tensors take; the d = 256 kernels run on the card) against kernel 6 itself,
run on this CPU in TPU interpret mode
(`jax.experimental.pallas.tpu.force_tpu_interpret_mode`); the launch
geometry of the d = 256 kernels; the DiT, the UNetT and the MMDiT at 2 heads
of 256 against the JAX models (its XLA path on the CPU); a YAML's
``dim_head: 256`` through both packages' loaders and a 4 x 256 checkpoint
through both converters; the rotation outside the attention that both
packages' models take at d = 256.

Kernel 6 expresses padding as segment ids: padded tokens are segment 2, so a
padded query row attends to the padded keys alone, where the port's kernels
(and the JAX serving kernel) let it attend to the valid keys; the JAX
package's callers zero those rows (`models/modules.py:431-432`). So the
attention is compared on the valid query rows only, and a training loss is
taken over them.

Sizes: b = 2, h = 2, n = 128 and 256, one sample with 37 keys masked. The
models at dim 256, depth 2, n = 32. Tolerances, in units of each tensor's
scale unless said otherwise: fp32 attention 1e-5 (the same algorithm, sums
in other orders), bf16 attention 1e-2 (both round P to bf16 before the PV
product, at one bf16 ulp of 2^-8 a value), training attention 5e-5 absolute
(the JAX test's own bound for its kernels against their dense oracle), keep
masks bit for bit, the outside rotation in bf16 bit for bit; the models'
fp32 outputs 1e-5, the loss and gradients 1e-4 (as
`tests/test_torch_head_dim.py`). One interpret-mode call of kernel 6 takes
about a second here, its forward and backward about three.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from eraxvif5tts_tpu import configs as jconfigs
from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.ops import train_attention as jta
from eraxvif5tts_tpu.ops.attention import _flash_attention
from eraxvif5tts_tpu.ops.rotary import apply_rotary as j_apply_rotary
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch import configs as tconfigs
from eraxvif5tts_tpu_torch.compression.convert import (
    reference_backbone_state_dict,
    state_dict_from_jax,
)
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models import modules as tmodules
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.ops import attention as tatt
from eraxvif5tts_tpu_torch.ops import serving_attention as tsa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import apply_rotary_heads
from test_torch_head_dim import ARCHS, JAX_BACKBONES, PORT_BACKBONES, VOCAB, _batch
from test_torch_mmdit_training import _jax_draws
from test_torch_mmdit_training import _one_torch_thread  # noqa: F401 (autouse here too)
from test_torch_models import close, redraw
from test_torch_training_attention import _key_words

D, H = 256, 2
N, MEL = 32, 16  # the model batch of `test_torch_head_dim._batch`
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _qkv(n, seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, n, H, D)).astype(np.float32) for _ in range(count)]


def _mask(n):
    return np.arange(n)[None, :] < np.array([n, n - 37])[:, None]


# ---- kernel 6 at d = 256 ---------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [128, 256])
def test_serving_attention_at_d256_matches_kernel6_interpret(n, dtype):
    """Kernel 6's serving role (``rope=None``: the JAX models rotate q and k
    outside it at d = 256) against the port's `serving_attention` on the
    same key mask, on the valid query rows."""
    jdt, tdt, rel = DTYPES[dtype]
    q, k, v = _qkv(n, 256 + n)
    mask = _mask(n)
    with pltpu.force_tpu_interpret_mode():
        want = _flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(mask))
        want = np.asarray(want.astype(jnp.float32))
    got = tsa.serving_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                torch.from_numpy(mask.sum(-1).astype(np.int32)))
    assert got.dtype == tdt and torch.isfinite(got).all()
    rows = mask[:, :, None, None]
    close(got.float().numpy() * rows, want * rows, rel, f"d=256 {dtype}")


@pytest.mark.parametrize("n", [128, 256])
def test_train_attention_at_d256_matches_kernel6_interpret(n):
    """Kernel 6's dropout-free training role (``trainable=True``: its
    forward and backward) against the port's `train_attention` at keep = 1,
    fp32: the output on the valid rows and the q / k / v gradients of a loss
    over them; masked keys receive zero dk / dv in both."""
    q, k, v = _qkv(n, 300 + n)
    mask = _mask(n)
    jmask, out_mask = jnp.asarray(mask), jnp.asarray(mask)[:, :, None, None]

    def loss(q, k, v):
        o = _flash_attention(q, k, v, jmask, trainable=True)
        return jnp.sum(jnp.where(out_mask, o, 0.0) ** 2), o

    with pltpu.force_tpu_interpret_mode():
        (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        want = [np.asarray(o)] + [np.asarray(g) for g in grads]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tta.train_attention(tq, tk, tv, key_valid=torch.from_numpy(mask))
    (out * torch.from_numpy(mask)[:, :, None, None]).pow(2).sum().backward()
    got = [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    rows = mask[:, :, None, None]
    np.testing.assert_allclose(got[0] * rows, want[0] * rows, atol=5e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)
    for grads_of in (got, want):
        assert np.abs(grads_of[2][1, n - 37:]).max() == 0.0
        assert np.abs(grads_of[3][1, n - 37:]).max() == 0.0


@pytest.mark.parametrize("n", [128, 256])
def test_keep_mask_at_d256_shapes_bit_identical_to_jax(n):
    """The keep bits the bf16 d = 256 kernels regenerate (a function of
    positions alone) at this file's shapes, every (sample, head), and the
    plain version at dropout 0.1 and d = 256 against the JAX dense oracle's
    output and gradients (the same bits, the same normaliser)."""
    seed = tta.attention_seed(_key_words(11))
    for b_idx in range(2):
        for h_idx in range(H):
            want = jta.dropout_keep_mask(jnp.uint32(seed), b_idx, h_idx, 0, 0, n, n, n, 0.9)
            got = tta.dropout_keep_mask(seed, b_idx, h_idx, 0, 0, n, n, n, 0.9)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, k, v = _qkv(n, 400 + n)
    mask = _mask(n)

    def loss(q, k, v):
        o = jta.dense_reference(q, k, v, key_valid=jnp.asarray(mask), dropout_rate=0.1,
                                seed=int(np.int32(np.uint32(seed))))
        return jnp.sum(jnp.where(jnp.asarray(mask)[:, :, None, None], o, 0.0) ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tta.train_attention(tq, tk, tv, key_valid=torch.from_numpy(mask), dropout_rate=0.1,
                              seed=seed)
    (out * torch.from_numpy(mask)[:, :, None, None]).pow(2).sum().backward()
    rows = mask[:, :, None, None]
    np.testing.assert_allclose(out.detach().numpy() * rows, np.asarray(o) * rows, atol=5e-5)
    for name, t, g in zip(("dq", "dk", "dv"), (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=5e-5, err_msg=name)


# ---- the d = 256 kernels' geometry and domain ----------------------------------------


@pytest.mark.parametrize("n", list(range(64, 6144 + 1, 64)))
def test_d256_geometry_covers_every_row_once_within_the_card(n):
    """The bf16 forward at d = 256 (128 rows a block, two consumer
    warpgroups at 232 registers, a ring of two stages), the backward (64 rows
    a block, both warpgroups on them, 128 of the head's columns each), the
    fp32 forward core (64 rows, 16-key tiles; serving and training) and the
    fp32 dq and dk/dv (64 rows, eight warps in four pairs of 16 rows, 16-row
    streamed tiles, one split stage; dq's pair holding half of dQ's columns
    each, dk/dv's dV and dK): every row or key owned once, every column of
    dq once and every key's dk and dv once, no tile past the sample, shared
    memory within a block's 232,448 bytes and the `setmaxnreg` sum within
    what the launch has."""
    b, h = 2, 4
    fwd = tta.forward_geometry(b, n, h, D)
    assert (fwd["rows"], fwd["stages"], fwd["threads"], fwd["registers"]) == (128, 2, 384,
                                                                              (40, 232))
    assert 128 * 40 + 256 * 232 <= 384 * ((65536 // 384) & ~7)
    covered = np.zeros(n, np.int64)
    for block, groups in enumerate(fwd["warpgroups"]):
        for start, rows in groups:
            assert block * 128 <= start and start + rows <= min((block + 1) * 128, n)
            covered[start:start + rows] += 1
    np.testing.assert_array_equal(covered, 1)
    assert fwd["tensor_map"]["panels"] == (0, 64, 128, 192)
    bwd = tta.backward_geometry(b, n, h, D)
    assert (bwd["rows"], bwd["stages"], bwd["threads"]) == (64, 2, 384)
    assert bwd["grid"] == (n // 64, h, b) and bwd["columns"] == [(0, 128), (128, 128)]
    assert bwd["warpgroups"] == [[(r, 64), (r, 64)] for r in range(0, n, 64)]
    f32 = tsa.forward_geometry_fp32(b, n, h, D)
    assert f32 == tta.forward_geometry_fp32(b, n, h, D)  # the training forward's core
    # the fp32 forward: two sets of four warps over the block's 64 rows, each
    # set one stage of 16-key K and V tiles, Q fp32 in shared memory
    assert (f32["rows"], f32["threads"], f32["warps"], f32["sets"], f32["stages"],
            f32["key_tile"], f32["q_split"]) == (64, 256, 8, 2, 1, 16, False)
    assert f32["blocks"] == [(r, 64) for r in range(0, n, 64)]
    walked = [t for tiles in tta.set_key_tiles(n, n, D) for t in tiles]
    assert sorted(walked) == list(range(n // 16))  # every 16-key tile by one set
    assert tta.set_key_tiles(n, 0, D) == tta.set_key_tiles(n, n, D)
    b32 = tta.backward_geometry_fp32(b, n, h, D)
    assert (b32["rows"], b32["dq_threads"], b32["dkv_threads"], b32["bwd_stages"],
            b32["dq_tile"], b32["dkv_tile"], b32["fixed_tiles"]) == (64, 256, 256, 1, 16, 16, 2)
    assert b32["grid"] == (n // 64, h, b) and b32["blocks"] == [(r, 64) for r in range(0, n, 64)]
    # every (row, column) of dq once: a pair of warps a 16-row group, each
    # half of the head's columns; every key's dk and dv once: a pair a
    # 16-key group, one warp dV, the other dK
    assert len(b32["dq_warps"]) == b32["dq_threads"] // 32 == 8
    owned = np.zeros((n, D), np.int64)
    outputs = np.zeros((n, 2), np.int64)
    for start, rows in b32["blocks"]:
        for first, col0, cols in b32["dq_warps"]:
            owned[start + first:start + first + 16, col0:col0 + cols] += 1
        for first, held in b32["dkv_warps"]:
            for out in held:
                outputs[start + first:start + first + 16, ("dK", "dV").index(out)] += 1
    np.testing.assert_array_equal(owned, 1)
    np.testing.assert_array_equal(outputs, 1)
    # streamed tiles of 16 rows: n / 16 of them a sample, none past its end
    assert n % b32["dq_tile"] == n % b32["dkv_tile"] == 0
    for shared in (fwd["shared_bytes"], bwd["shared_bytes"], f32["shared_bytes"],
                   b32["dq_shared_bytes"], b32["dkv_shared_bytes"]):
        assert shared <= tta.SHARED_LIMIT and tta._per_sm(shared) == 1


def test_d256_shared_bytes_add_up():
    tile = 64 * D * 2  # a [64, 256] bf16 tile: four 128-byte-swizzled panels
    assert tta.forward_geometry(1, 4096, 4, D)["shared_bytes"] == \
        1024 + 2 * tile + 2 * 2 * tile + 8 * (5 * 2 + 2) == 197728
    assert tta.backward_geometry(1, 4096, 4, D)["shared_bytes"] == \
        1024 + 2 * tile + 2 * (2 * tile + 2 * 64 * 4) + 8 * (2 * 2 + 1) == 198696
    row = (D + 4) * 4  # a padded fp32 row
    # the fp32 forward: Q's 64 rows, and two sets' one stage of a 16-key K and
    # V tile, big and small (4 x 16,640 bytes a set)
    assert tsa.forward_geometry_fp32(1, 4096, 4, D)["shared_bytes"] == \
        tta.forward_geometry_fp32(1, 4096, 4, D)["shared_bytes"] == \
        64 * row + 2 * 4 * 16 * row == 199680
    # set 1's O and (m, l) for the merge fit in the two sets' room
    assert 64 * D * 4 + 4 * 32 * 16 <= 2 * 4 * 16 * row
    # fp32 dq (dk/dv): Q's and dO's (K's and V's) 64 rows, a 16-row K and V
    # (Q and dO) tile's big and small parts, the next tile's raw (unpadded):
    # all a block may use. The pairs' slots lie in room a tile no longer
    # needs: dq's scores (two warps' [16, 16] fp32 a pair) in V's parts,
    # dk/dv's P ([16, 16] fp32 a pair) in the raw room
    b32 = tta.backward_geometry_fp32(1, 4096, 4, D)
    assert b32["dq_raw_bytes"] == b32["dkv_raw_bytes"] == 2 * 16 * D * 4 == 32768
    assert b32["dq_shared_bytes"] == b32["dkv_shared_bytes"] == \
        2 * 64 * row + 4 * 16 * row + 32768 == 232448 == tta.SHARED_LIMIT
    assert b32["score_slot_bytes"] == 4 * 2 * 16 * 16 * 4 <= 2 * 16 * row
    assert b32["p_slot_bytes"] == 4 * 16 * 16 * 4 == 4096 <= b32["dkv_raw_bytes"]
    # a padded raw room would not fit: its rows of 256 floats take the rest
    assert b32["dq_shared_bytes"] + 2 * 16 * 4 * 4 > tta.SHARED_LIMIT


def test_d256_domain_refuses_rotary_and_fp32_training():
    """On the kernels' argument checks (no launch: CPU tensors are enough):
    the serving attention takes d = 256 in both dtypes without rotary and
    refuses fused rotary there; the training attention takes d = 256 in
    both dtypes (fp32 training, refused until kernel 6's fp32 backward was
    ported, included) and refuses a d outside (64, 128, 256); the fp32
    training geometry states d = 256; every launcher counts d = 256."""
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(2, 128, 2, D, dtype=dtype)
        tsa._check_cuda_args(q, q, q, None, None)
        with pytest.raises(ValueError, match="fused rotary"):
            tsa._check_cuda_args(q, q, q, None, torch.zeros(128, D))
    lens = torch.full((2,), 128, dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        tta._check_cuda_args(*(torch.zeros(2, 128, 2, D, dtype=dtype),) * 3, lens)
        for bad in (32, 192, 512):
            with pytest.raises(ValueError, match="head dims"):
                tta._check_cuda_args(*(torch.zeros(2, 128, 2, bad, dtype=dtype),) * 3, lens)
    b32 = tta.backward_geometry_fp32(2, 128, 2, D)
    assert b32["dq_tile"] == b32["dkv_tile"] == 16
    with pytest.raises(ValueError, match="head dims"):
        tta.backward_geometry_fp32(2, 128, 2, 192)
    assert tatt.rotary_fused(64) and tatt.rotary_fused(128) and not tatt.rotary_fused(D)
    for fn in (tsa.serving_attention.launches_by_head_dim,
               tsa.serving_attention.launches_fp32_by_head_dim,
               *(f.launches_by_head_dim for f in tta._LAUNCHERS[torch.bfloat16]),
               *(f.launches_by_head_dim for f in tta._LAUNCHERS[torch.float32])):
        assert set(fn) == {64, 128, 256}


# ---- the outside rotation ----------------------------------------------------------


def test_outside_rotation_at_d256_equals_jax_apply_rotary_in_bf16():
    """The rotation both packages' models apply outside the attention at d =
    256 (cos and sin cast to the compute dtype), bf16 bit for bit; and the
    port's `Attention` in eval mode hands the attention rotated q and k with
    ``rope=None`` at d = 256, where at d = 128 it fuses rotary."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 64, H, D)).astype(np.float32)
    rope = np.array(j_rotary_freqs(64, D))
    want = j_apply_rotary(jnp.asarray(x, jnp.bfloat16).swapaxes(1, 2), jnp.asarray(rope))
    want = np.asarray(want.swapaxes(1, 2).astype(jnp.float32))
    got = apply_rotary_heads(torch.from_numpy(x).bfloat16(), torch.from_numpy(rope))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)

    seen = []

    def spy(q, k, v, key_valid=None, rope=None):
        seen.append(rope is None)
        return tatt.dot_product_attention(q, k, v, key_valid=key_valid, rope=rope)

    for d, fused in ((128, True), (D, False)):
        attn = tmodules.Attention(64, heads=H, dim_head=d).eval()
        rope_d = torch.from_numpy(np.array(j_rotary_freqs(64, d)))
        saved, tmodules.dot_product_attention = tmodules.dot_product_attention, spy
        try:
            with torch.no_grad():
                attn(torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32)),
                     rope=rope_d)
        finally:
            tmodules.dot_product_attention = saved
        assert seen.pop() is not fused


# ---- the backbones at 2 heads of 256 -----------------------------------------------

ARCHS_256 = {name: dataclasses.replace(arch, dim_head=D) for name, arch in ARCHS.items()}


@pytest.mark.parametrize("name", list(ARCHS_256))
def test_backbone_at_2x256_serves_and_trains_as_jax(name):
    """The DiT, the UNetT and the MMDiT at 2 heads of 256 (`test_torch_head_dim`'s
    archs, dim 256, depth 2) on the JAX model's weights through
    `state_dict_from_jax`: one serving `run` (eval: q and k rotated outside
    the attention, as the JAX models do at d = 256) with a masked sample and
    a dropped condition, then `CFM.loss` in training mode with the JAX draws
    handed in, and every parameter's gradient through
    `backbone_params_to_torch`."""
    arch = ARCHS_256[name]
    jcfm = JCFM(transformer=JAX_BACKBONES[name](arch=arch, text_num_embeds=VOCAB, mel_dim=MEL))
    params = redraw(jax.eval_shape(jcfm.init_params, jax.random.key(0)), seed=31)
    net = PORT_BACKBONES[name](arch, VOCAB, MEL)
    net.load_state_dict(state_dict_from_jax(params, None, ModelConfig(
        name=f"tiny-{name}", backbone=name, arch=arch))[0], strict=True)
    batch, key = _batch(seed=7), jax.random.key(9)
    rng = np.random.default_rng(8)
    x, cond = (rng.standard_normal((2, N, MEL)).astype(np.float32) for _ in range(2))
    time, drop = np.array([0.4, 0.9], np.float32), np.array([False, True])
    mask = np.arange(N)[None] < batch["lens"][:, None]
    jnet = jcfm.transformer

    def jax_run(p):
        te = jnet.apply({"params": p}, batch["text"], N, drop, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    def jax_loss(p):
        loss, _, pred = jcfm.loss(p, batch["mel"], batch["text"], batch["lens"], key)
        return loss, pred

    want, ((want_loss, want_pred), jgrads) = jax.jit(
        lambda p: (jax_run(p), jax.value_and_grad(jax_loss, has_aux=True)(p)))(params)
    with torch.no_grad():
        te = net.eval().embed_text(torch.from_numpy(batch["text"]).long(), N,
                                   torch.from_numpy(drop))
        got = net.run(torch.from_numpy(x), torch.from_numpy(cond), te, torch.from_numpy(time),
                      torch.from_numpy(drop), lens_to_mask(torch.from_numpy(batch["lens"]), N))
    close(got.numpy(), np.asarray(want), 1e-5, f"{name}.run")

    cfm = CFM(net.train())
    loss, _, pred = cfm.loss(*(torch.from_numpy(batch[k]) for k in ("mel", "text", "lens")),
                             _jax_draws(key))
    loss.backward()
    close(loss.item(), float(want_loss), 1e-4, f"{name} loss")
    close(pred.detach().numpy(), np.asarray(want_pred), 1e-4, f"{name} pred")
    grads = backbone_params_to_torch(jgrads, name, arch.depth, arch.conv_layers,
                                     with_prefix=False)
    params_t = dict(net.named_parameters())
    assert set(params_t) == set(grads)
    for key_name, g in grads.items():
        close(params_t[key_name].grad.numpy(), g, 1e-4, f"{name} grad {key_name}")


# ---- the 4 x 256 configuration -------------------------------------------------------


def test_yaml_dim_head_256_loads_to_equal_configs(tmp_path):
    """`configs/F5TTS_v1_Base.yaml` with ``heads: 4`` and ``dim_head: 256``
    (the flagship's width, inner 1024): both packages' loaders give the same
    config, and the port builds a DiT of 4 heads of 256 from it."""
    text = open("configs/F5TTS_v1_Base.yaml", encoding="utf-8").read()
    assert text.count("    heads: 16\n") == 1
    path = tmp_path / "F5TTS_v1_Base_4x256.yaml"
    path.write_text(text.replace("    heads: 16\n", "    heads: 4\n    dim_head: 256\n"))
    want = jconfigs.load_model_config(str(path))
    got = tconfigs.load_model_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.arch.dim, got.arch.depth, got.arch.heads, got.arch.dim_head) == (1024, 22, 4, D)
    block = build_backbone(dataclasses.replace(got, arch=dataclasses.replace(got.arch, depth=1)),
                           VOCAB).transformer_blocks[0].attn
    assert (block.heads, block.dim_head, block.to_q.weight.shape) == (4, D, (1024, 1024))


def test_4x256_checkpoint_reaches_the_port_through_both_converters(tmp_path):
    """A 4 x 256 `F5TTS_v1_Base` block (dim 1024, one block) on a JAX param
    tree: the JAX package's `backbone_params_to_torch` writes the reference
    checkpoint, the port's reader loads it strict into the port's DiT, and
    its weights equal what the port's `state_dict_from_jax` makes of the
    same tree. Shapes only come from the init; no model runs."""
    arch = ArchConfig(dim=1024, depth=1, heads=4, dim_head=D, ff_mult=2, text_dim=512,
                      conv_layers=4, dropout=0.0)
    jcfm = JCFM(transformer=JDiT(arch=arch, text_num_embeds=VOCAB, mel_dim=100))
    params = redraw(jax.eval_shape(jcfm.init_params, jax.random.key(0)), seed=29, std=0.02)
    path = tmp_path / "model.pt"
    torch.save({f"ema_model.{k}": torch.from_numpy(np.ascontiguousarray(v))
                for k, v in backbone_params_to_torch(params, "DiT", 1, 4).items()}, path)
    net = DiT(arch, VOCAB, 100)
    net.load_state_dict(reference_backbone_state_dict(str(path)), strict=True)
    want = state_dict_from_jax(params, None, ModelConfig(arch=arch))[0]
    got = net.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    attn = net.transformer_blocks[0].attn
    assert (attn.heads, attn.dim_head, tuple(attn.to_q.weight.shape)) == (4, D, (1024, 1024))
