"""PyTorch port, model layer: DiT pieces, the whole DiT and Vocos against the
flax modules on the same weights (every JAX leaf redrawn from a seeded
normal, so no zero-initialised AdaLN or output projection hides an error)
converted with `state_dict_from_jax`, and the same numpy inputs.

Tolerances: fp32 1e-5 relative to the output's scale, per module and for
the whole DiT; bf16 a bound stated per test (2e-2 for the DiT, 1e-2 for
Vocos: a few bf16 ulps after two blocks), since the JAX bf16 DiT rounds its unfused FF input at other points
than the fused serving semantics the port follows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models import modules as jm
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.dit import InputEmbedding as JInputEmbedding
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.ops.rotary import rotary_freqs as j_rotary_freqs
from eraxvif5tts_tpu_torch.compression.convert import state_dict_from_jax
from eraxvif5tts_tpu_torch.models.dit import DiT
from eraxvif5tts_tpu_torch.models.vocos import Vocos
from eraxvif5tts_tpu_torch.ops.masks import lens_to_mask
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs

ARCH = ArchConfig(dim=128, depth=2, heads=2, dim_head=64, ff_mult=2, text_dim=32,
                  conv_layers=1, dropout=0.0)
CFG = ModelConfig(name="tiny", arch=ARCH)
VOCAB = 40
MEL = 100


def redraw(tree, seed, std=0.05):
    """Every leaf of a param tree replaced by a seeded normal draw (numpy)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (std * rng.standard_normal(p.shape)).astype(np.float32),
                        tree)


def tiny_jax_dit(compute_dtype=jnp.float32):
    return JDiT(arch=ARCH, text_num_embeds=VOCAB, mel_dim=MEL, compute_dtype=compute_dtype)


def tiny_params(seed=0):
    return redraw(JCFM(transformer=tiny_jax_dit()).init_params(jax.random.key(0)), seed)


def port_dit(params, dtype=torch.float32):
    dit = DiT(ARCH, VOCAB, MEL)
    dit.load_state_dict(state_dict_from_jax(params, None, CFG)[0], strict=True)
    return dit.to(dtype).eval()


def close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, f"{what}: max error {err:.3g} of scale > {rel}"


@pytest.fixture(scope="module")
def params():
    return tiny_params()


def _inputs(n=128, seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, n, MEL)).astype(np.float32)
    cond = rng.standard_normal((2, n, MEL)).astype(np.float32)
    text = np.full((2, 48), -1, np.int32)
    text[0, :40] = rng.integers(0, VOCAB, 40)
    text[1, :12] = rng.integers(0, VOCAB, 12)
    time = np.array([0.3, 0.8], np.float32)
    drop = np.array([False, True])
    lens = np.array([n, n - 38])
    return x, cond, text, time, drop, lens


def test_text_embedding_matches_flax(params):
    _, _, text, _, _, _ = _inputs()
    dit = port_dit(params)
    jd = tiny_jax_dit()
    for drop in (np.array([False, False]), np.array([False, True])):
        want = jax.jit(lambda p, t, d: jd.apply({"params": p}, t, 128, d,
                                                method="embed_text"))(params, text, drop)
        with torch.no_grad():
            got = dit.embed_text(torch.from_numpy(text).long(), 128, torch.from_numpy(drop))
        close(got.numpy(), want, 1e-5, "embed_text")


def test_input_embedding_matches_flax(params):
    x, cond, _, _, drop, lens = _inputs()
    te = np.random.default_rng(5).standard_normal((2, 128, 32)).astype(np.float32)
    mask = np.arange(128)[None] < lens[:, None]
    want = jax.jit(JInputEmbedding(ARCH.dim).apply)(
        {"params": params["input_embed"]}, x, cond, te, drop, mask)
    dit = port_dit(params)
    with torch.no_grad():
        got = dit.input_embed(*(torch.from_numpy(a) for a in (x, cond, te, drop, mask)))
    close(got.numpy(), want, 1e-5, "input_embed")


def test_dit_block_matches_flax(params):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 128, ARCH.dim)).astype(np.float32)
    t = rng.standard_normal((2, ARCH.dim)).astype(np.float32)
    mask = np.arange(128)[None] < np.array([128, 77])[:, None]
    block = jm.DiTBlock(dim=ARCH.dim, heads=ARCH.heads, dim_head=ARCH.dim_head,
                        ff_mult=ARCH.ff_mult, dropout=0.0)
    want = jax.jit(block.apply)({"params": params["block_0"]}, x, t, mask,
                                j_rotary_freqs(128, 64))
    dit = port_dit(params)
    with torch.no_grad():
        got = dit.transformer_blocks[0](torch.from_numpy(x), torch.from_numpy(t),
                                        torch.from_numpy(mask), rotary_freqs(128, 64))
    close(got.numpy(), want, 1e-5, "DiTBlock")


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_dit_run_matches_flax(params, dtype, rel):
    x, cond, text, time, drop, lens = _inputs()
    mask = np.arange(128)[None] < lens[:, None]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jd = tiny_jax_dit(jdt)
    jp = jax.tree.map(lambda p: jnp.asarray(p, jdt), params)

    def jax_run(p, x, cond, text, time, drop, mask):
        te = jd.apply({"params": p}, text, 128, drop, method="embed_text")
        return jd.apply({"params": p}, x, cond, te, time, drop, mask, method="run")

    want = jax.jit(jax_run)(jp, x, cond, text, time, drop, mask)
    dit = port_dit(params, torch.float32 if dtype == "float32" else torch.bfloat16)
    with torch.no_grad():
        te = dit.embed_text(torch.from_numpy(text).long(), 128, torch.from_numpy(drop))
        got = dit.run(torch.from_numpy(x), torch.from_numpy(cond), te,
                      torch.from_numpy(time), torch.from_numpy(drop),
                      lens_to_mask(torch.from_numpy(lens), 128))
    assert got.dtype == torch.float32
    close(got.numpy(), want, rel, f"DiT.run {dtype}")


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_vocos_matches_flax(dtype, rel):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jv = JVocos(dim=64, intermediate_dim=128, num_layers=2, dtype=jdt)
    mel = np.random.default_rng(7).standard_normal((2, MEL, 40)).astype(np.float32)
    vp = redraw(jax.jit(jv.init)(jax.random.key(1), mel)["params"], seed=8, std=0.1)
    want = jax.jit(jv.apply)({"params": vp}, mel)
    tv = Vocos(dim=64, intermediate_dim=128, num_layers=2,
               compute_dtype=torch.float32 if dtype == "float32" else torch.bfloat16)
    tv.load_state_dict(state_dict_from_jax(None, vp, CFG)[1], strict=True)
    with torch.no_grad():
        got = tv(torch.from_numpy(mel))
    assert got.dtype == torch.float32 and got.shape == (2, 39 * 256)
    close(got.numpy(), want, rel, f"Vocos {dtype}")


def test_state_dict_keys_are_the_reference_schema(params):
    """The port's DiT holds exactly the reference torch keys (no extra
    buffers), so a reference checkpoint loads with strict=True."""
    from eraxvif5tts_tpu.compression.convert import dit_rules

    want = {rule[0] for rule in dit_rules(ARCH.depth, ARCH.conv_layers)}
    assert set(DiT(ARCH, VOCAB, MEL).state_dict()) == want
