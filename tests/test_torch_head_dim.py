"""PyTorch port, head dim 128 (the JAX package's second Pallas head dim): the
attention wrappers (their plain versions, which CPU tensors take; the d = 128
kernels run on the card) against the JAX Pallas kernels in interpret mode,
the DiT, the UNetT and the MMDiT at 2 heads of 128 against the JAX models, a
YAML's ``dim_head: 128`` through both packages' config loaders, and the
routing of attention by head dim.

Sizes: h = 2, n = 128 and 192 (n % 128 == 64: the JAX train gate sends it to
its dense reference, its serving gate to the one-shot block); the models at
dim 256, depth 2, n = 32. Tolerances, in units of each tensor's scale unless
said otherwise: fp32 attention 1e-5 (the same algorithm, sums in other
orders), bf16 attention 1e-2 (both round P to bf16 before the PV product, at
one bf16 ulp of 2^-8 a value); training attention 5e-5 absolute (the JAX
test's own bound for its kernel against its dense oracle), keep masks bit
for bit; the models' fp32 outputs 1e-5 and the loss and gradients 1e-4 (as
`tests/test_torch_training.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu import configs as jconfigs
from eraxvif5tts_tpu.compression.convert import backbone_params_to_torch
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.mmdit import MMDiT as JMMDiT
from eraxvif5tts_tpu.models.unett import UNetT as JUNetT
from eraxvif5tts_tpu.ops import serving_attention as jsa
from eraxvif5tts_tpu.ops import train_attention as jta
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch import configs as tconfigs
from eraxvif5tts_tpu_torch.compression.convert import (
    reference_backbone_state_dict,
    state_dict_from_jax,
)
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.models.cfm import CFM
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.mmdit import MMDiT
from eraxvif5tts_tpu_torch.models.unett import UNetT
from eraxvif5tts_tpu_torch.ops import attention as tatt
from eraxvif5tts_tpu_torch.ops import serving_attention as tsa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from test_torch_mmdit_training import _jax_draws
from test_torch_mmdit_training import _one_torch_thread  # noqa: F401 (autouse here too)
from test_torch_models import close, redraw
from test_torch_training_attention import _key_words

D, H = 128, 2
# the MMDiT training tests' batch (`_jax_draws` draws x0 at b = 2, n = 32, 16 mels)
MEL, VOCAB, N, NT = 16, 24, 32, 16
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


# ---- kernel 1 ---------------------------------------------------------------


@pytest.mark.parametrize("with_rope", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [128, 192])
def test_serving_attention_at_d128_matches_pallas_interpret(n, dtype, with_rope):
    """Kernel 1's semantics at d = 128: the port's `serving_attention` against
    the JAX kernel in interpret mode, a sample whose keys end inside a tile
    beside one with no valid key, with and without fused rotary."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(n + 3 * with_rope)
    q, k, v = (rng.standard_normal((2, n, H, D)).astype(np.float32) for _ in range(3))
    lens = np.array([n - 37, 0], np.int32)
    rope = np.array(j_rotary_freqs(n, D)) if with_rope else None
    want = jsa.serving_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lens),
                                 rope=None if rope is None else jnp.asarray(rope),
                                 interpret=True)
    got = tsa.serving_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                torch.from_numpy(lens),
                                None if rope is None else torch.from_numpy(rope))
    assert got.dtype == tdt and torch.isfinite(got).all()
    close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rel, f"d=128 {dtype}")


# ---- kernels 4a-4c ---------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n", [128, 192])
def test_train_attention_at_d128_matches_jax(n, rate):
    """Kernels 4a-4c's semantics at d = 128, fp32: output and q / k / v
    gradients against the JAX kernel in interpret mode where its gate admits
    the shape (n % 128 == 0), else against its dense oracle, at dropout 0.1
    (the same position-hash keep bits) and 0, a sample with masked keys."""
    rng = np.random.default_rng(11 + n)
    q, k, v = (rng.standard_normal((2, n, H, D)).astype(np.float32) for _ in range(3))
    lens = np.array([n, n - 37], np.int32)
    mask = np.arange(n)[None, :] < lens[:, None]
    seed = tta.attention_seed(_key_words(7))
    jmask, out_mask = jnp.asarray(mask), jnp.asarray(mask)[:, :, None, None]
    if jta.can_use_train_kernel(n, D, jnp.float32):
        def jax_attention(q, k, v):
            return jta.train_attention(q, k, v, key_valid=jmask, dropout_rate=rate,
                                       dropout_rng=jax.random.key(7), interpret=True)
    else:
        def jax_attention(q, k, v):
            return jta.dense_reference(q, k, v, key_valid=jmask, dropout_rate=rate,
                                       seed=int(np.int32(np.uint32(seed))))

    def loss(q, k, v):
        o = jax_attention(q, k, v)
        return jnp.sum(jnp.where(out_mask, o, 0.0) ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    want = [np.asarray(o)] + [np.asarray(g) for g in grads]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tta.train_attention(tq, tk, tv, key_valid=torch.from_numpy(mask),
                              dropout_rate=rate, seed=seed)
    (out * torch.from_numpy(mask)[:, :, None, None]).pow(2).sum().backward()
    got = [out.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    np.testing.assert_allclose(got[0] * mask[:, :, None, None],
                               want[0] * mask[:, :, None, None], atol=5e-5)
    for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(a, b, atol=5e-5, err_msg=name)
    # masked keys receive zero dk / dv
    assert np.abs(got[2][1, n - 37:]).max() == 0.0 and np.abs(got[3][1, n - 37:]).max() == 0.0


@pytest.mark.parametrize("n", [128, 192])
def test_keep_mask_at_d128_shapes_bit_identical_to_jax(n):
    """The keep bits the d = 128 kernels regenerate (a function of positions,
    not of d) at this file's shapes: every (sample, head) of the batch."""
    seed = tta.attention_seed(_key_words(7))
    for b_idx in range(2):
        for h_idx in range(H):
            want = jta.dropout_keep_mask(jnp.uint32(seed), b_idx, h_idx, 0, 0, n, n, n, 0.9)
            got = tta.dropout_keep_mask(seed, b_idx, h_idx, 0, 0, n, n, n, 0.9)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the backbones at 2 heads of 128 ----------------------------------------------

ARCHS = {
    "DiT": ArchConfig(dim=256, depth=2, heads=H, dim_head=D, ff_mult=2, text_dim=64,
                      conv_layers=1, dropout=0.0),
    "UNetT": ArchConfig(dim=256, depth=2, heads=H, dim_head=D, ff_mult=2, text_dim=None,
                        conv_layers=0, dropout=0.0),
    "MMDiT": ArchConfig(dim=256, depth=2, heads=H, dim_head=D, ff_mult=2, dropout=0.0),
}
JAX_BACKBONES = {"DiT": JDiT, "UNetT": JUNetT, "MMDiT": JMMDiT}
PORT_BACKBONES = {"DiT": DiT, "UNetT": UNetT, "MMDiT": MMDiT}


def _backbone(name):
    """(the JAX CFM, its seeded params, the port's backbone on the same weights)."""
    arch = ARCHS[name]
    jcfm = JCFM(transformer=JAX_BACKBONES[name](arch=arch, text_num_embeds=VOCAB, mel_dim=MEL))
    # every leaf is redrawn: the tree's shapes are all it takes from the init
    params = redraw(jax.eval_shape(jcfm.init_params, jax.random.key(0)), seed=21)
    cfg = ModelConfig(name=f"tiny-{name}", backbone=name, arch=arch)
    net = PORT_BACKBONES[name](arch, VOCAB, MEL)
    net.load_state_dict(state_dict_from_jax(params, None, cfg)[0], strict=True)
    return jcfm, params, net


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    text = np.full((2, NT), -1, np.int32)
    text[0, :10] = rng.integers(0, VOCAB, 10)
    text[1, :4] = rng.integers(0, VOCAB, 4)
    return {"mel": rng.standard_normal((2, N, MEL)).astype(np.float32), "text": text,
            "lens": np.array([N, N - 9], np.int32)}


@pytest.mark.parametrize("name", list(ARCHS))
def test_backbone_at_2x128_serves_and_trains_as_jax(name):
    """The DiT, the UNetT and the MMDiT at 2 heads of 128 (dim 256, depth 2)
    on the JAX model's weights through `state_dict_from_jax`: one serving
    `run` (eval: the serving attention, rotary fused where the backbone fuses
    it) with a masked sample and a dropped condition, then `CFM.loss` in
    training mode (the training attention) with the JAX draws handed in, and
    every parameter's gradient through `backbone_params_to_torch`."""
    jcfm, params, net = _backbone(name)
    batch, key = _batch(seed=3), jax.random.key(5)
    rng = np.random.default_rng(4)
    x, cond = (rng.standard_normal((2, N, MEL)).astype(np.float32) for _ in range(2))
    time, drop = np.array([0.3, 0.8], np.float32), np.array([False, True])
    mask = np.arange(N)[None] < batch["lens"][:, None]
    jnet = jcfm.transformer

    def jax_run(p):
        te = jnet.apply({"params": p}, batch["text"], N, drop, method="embed_text")
        return jnet.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    def jax_loss(p):
        loss, _, pred = jcfm.loss(p, batch["mel"], batch["text"], batch["lens"], key)
        return loss, pred

    # one compilation for the serving run and the loss with its gradient
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
    arch = ARCHS[name]
    grads = backbone_params_to_torch(jgrads, name, arch.depth, arch.conv_layers,
                                     with_prefix=False)
    params_t = dict(net.named_parameters())
    assert set(params_t) == set(grads)
    for key_name, g in grads.items():
        close(params_t[key_name].grad.numpy(), g, 1e-4, f"{name} grad {key_name}")


def test_yaml_dim_head_128_loads_to_equal_configs(tmp_path):
    """`configs/F5TTS_v1_Base.yaml` with ``heads: 8`` and ``dim_head: 128``
    (the flagship's width, inner 1024): both packages' loaders give the same
    config, and the port builds a DiT of 8 heads of 128 from it."""
    text = open("configs/F5TTS_v1_Base.yaml", encoding="utf-8").read()
    assert text.count("    heads: 16\n") == 1
    path = tmp_path / "F5TTS_v1_Base_8x128.yaml"
    path.write_text(text.replace("    heads: 16\n", "    heads: 8\n    dim_head: 128\n"))
    want = jconfigs.load_model_config(str(path))
    got = tconfigs.load_model_config(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.arch.dim, got.arch.depth, got.arch.heads, got.arch.dim_head) == (1024, 22, 8, 128)
    assert dataclasses.asdict(tconfigs.load_yaml_config(str(path))) == \
        dataclasses.asdict(jconfigs.load_yaml_config(str(path)))
    block = build_backbone(dataclasses.replace(got, arch=dataclasses.replace(got.arch, depth=1)),
                           VOCAB).transformer_blocks[0].attn
    assert (block.heads, block.dim_head, block.to_q.weight.shape) == (8, 128, (1024, 1024))


def test_8x128_checkpoint_reaches_the_port_through_both_converters(tmp_path):
    """An 8 x 128 `F5TTS_v1_Base` block (dim 1024, one block: the YAML's
    widths) on a JAX param tree: the JAX package's `backbone_params_to_torch`
    writes the reference checkpoint, the port's reader
    (`reference_backbone_state_dict`) loads it strict into the port's DiT,
    and its weights equal what the port's own `state_dict_from_jax` makes of
    the same tree. Shapes only come from the init; no model runs."""
    arch = ArchConfig(dim=1024, depth=1, heads=8, dim_head=128, ff_mult=2, text_dim=512,
                      conv_layers=4, dropout=0.0)
    jcfm = JCFM(transformer=JDiT(arch=arch, text_num_embeds=VOCAB, mel_dim=100))
    params = redraw(jax.eval_shape(jcfm.init_params, jax.random.key(0)), seed=23, std=0.02)
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
    assert (attn.heads, attn.dim_head, tuple(attn.to_q.weight.shape)) == (8, 128, (1024, 1024))


# ---- routing by head dim --------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
def test_head_dim_route_is_a_function_of_d_and_device(d, device):
    """On the card: the kernels at d in (64, 128) and at d = 256 (the
    library flash kernel's, kernel 6), in every dtype and mode; the plain
    versions at any other d (XLA's attention in the JAX package). On the CPU
    every d takes the wrappers, whose CPU path is the plain version."""
    route = tatt.head_dim_route(d, torch.device(device))
    if device == "cpu" or d in (64, 128, 256):
        assert route == "kernel"
    else:
        assert route == "plain"
    assert tatt.head_dim_route(d, "cpu") == "kernel"


def test_plain_route_runs_the_plain_versions_and_counts_them():
    """What the "plain" route runs (here on CPU tensors): the serving and the
    training attention's plain versions, one count each in
    ``plain_attention.calls``, the same results as the wrappers' CPU path."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
               for _ in range(3))
    mask = lens_to_mask(torch.tensor([64, 40]), 64)
    before = tatt.plain_attention.calls
    served = tatt.plain_attention(tsa.serving_attention_reference, q, k, v, mask.sum(-1))
    trained = tatt.plain_train_attention(q, k, v, key_valid=mask, dropout_rate=0.1, seed=3)
    assert tatt.plain_attention.calls == before + 2
    assert torch.equal(served, tatt.dot_product_attention(q, k, v, key_valid=mask))
    assert torch.equal(trained, tta.train_attention(q, k, v, key_valid=mask, dropout_rate=0.1,
                                                    seed=3))
    assert tatt.plain_attention.calls == before + 2  # the CPU path counts nothing
