"""PyTorch port, sampler: `CFM.sample` against the JAX sampler at 4 Euler
steps on the same weights, inputs and noise (the test draws the noise with
`jax.random.normal` and hands it to the port).

Tolerance: fp32, 1e-5 relative to the mel's scale (four DiT calls, CFG
amplifies the branch difference by 1 + cfg_strength).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.cfm import sway_time_grid as j_sway_time_grid
from eraxvif5tts_tpu_torch.models.cfm import CFM, sway_time_grid
from test_torch_models import MEL, VOCAB, close, port_dit, tiny_jax_dit, tiny_params

MAXD = 128


@pytest.fixture(scope="module")
def models():
    params = tiny_params(seed=10)
    return JCFM(transformer=tiny_jax_dit()), params, CFM(port_dit(params))


def _sample_both(models, cond, text, duration, lens, use_cfg, seed=0):
    jcfm, params, cfm = models
    key = jax.random.key(seed)
    want = jcfm.sample(params, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(duration),
                       jnp.asarray(lens), key, steps=4, cfg_strength=2.0,
                       sway_sampling_coef=-1.0, max_duration=MAXD, use_cfg=use_cfg)
    noise = np.array(jax.random.normal(key, (MAXD, MEL), jnp.float32))
    got = cfm.sample(torch.from_numpy(cond), torch.from_numpy(text).long(),
                     torch.from_numpy(duration), torch.from_numpy(lens),
                     noise=torch.from_numpy(noise), steps=4, cfg_strength=2.0,
                     sway_sampling_coef=-1.0, max_duration=MAXD, use_cfg=use_cfg)
    return got.numpy(), np.asarray(want)


def test_sway_time_grid_matches_jax():
    for coef in (-1.0, None):
        np.testing.assert_allclose(sway_time_grid(32, coef).numpy(),
                                   np.asarray(j_sway_time_grid(32, coef)), atol=1e-7)


@pytest.mark.parametrize("use_cfg", [True, False])
def test_cfm_sample_matches_jax(models, use_cfg):
    rng = np.random.default_rng(11)
    cond = rng.standard_normal((2, 40, MEL)).astype(np.float32)
    text = np.full((2, 64), -1, np.int32)
    text[0, :50] = rng.integers(0, VOCAB, 50)
    text[1, :20] = rng.integers(0, VOCAB, 20)
    lens = np.array([40, 25])
    duration = np.array([100, 128])
    got, want = _sample_both(models, cond, text, duration, lens, use_cfg)
    assert got.shape == (2, MAXD, MEL)
    close(got, want, 1e-5, f"CFM.sample cfg={use_cfg}")
    # prompt pasted back, zeros past each duration
    np.testing.assert_array_equal(got[0, :40], cond[0])
    assert np.all(got[0, 100:] == 0) and np.any(got[1, 127] != 0)


def test_empty_text_duration_clamp(models):
    """All -1 text and duration < lens still yields lens + 1 frames."""
    rng = np.random.default_rng(12)
    cond = rng.standard_normal((1, 30, MEL)).astype(np.float32)
    text = np.full((1, 64), -1, np.int32)
    got, want = _sample_both(models, cond, text, np.array([10]), np.array([30]), True)
    close(got, want, 1e-5, "empty-text sample")
    assert np.any(got[0, 30] != 0)
    assert np.all(got[0, 31:] == 0)
