"""PyTorch port, the compression path: the pruner and its CLI against the JAX
package's on the same checkpoints, the pruned checkpoint loading strict into
the port's backbone, and the duration predictor (`models/duration.py`, its
checkpoints across both packages and every historical layout, and the
wrapper's use of it) against the JAX one on the same weights.

The pruner is numpy on both sides: scores, selections, re-indexed tensors,
reports and CLI outputs are held equal, exactly. The duration predictor is
fp32: log-durations within 1e-5 of their scale (the convolutions and the
group norm sum in other orders), predicted frame counts and the wrapper's
durations exactly.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.compression import __main__ as jcli
from eraxvif5tts_tpu.compression import convert as jconvert
from eraxvif5tts_tpu.compression import pruner as jpruner
from eraxvif5tts_tpu.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu.models import duration as jduration
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.text import phoneme as jphoneme
from eraxvif5tts_tpu_torch.compression import __main__ as tcli
from eraxvif5tts_tpu_torch.compression import pruner as tpruner
from eraxvif5tts_tpu_torch.models import duration as tduration
from eraxvif5tts_tpu_torch.text import phoneme as tphoneme

ARCH6 = ArchConfig(dim=64, depth=6, heads=2, dim_head=32, ff_mult=2, text_dim=32,
                   conv_layers=1, dropout=0.0)
MEL = 100
VOCAB = 12


@pytest.fixture(scope="module")
def torch_layout_sd():
    """A 6-block DiT checkpoint in the reference layout, numpy, every leaf
    redrawn (block b's scale grows with b, so that the scores differ)."""
    dit = JDiT(arch=ARCH6, text_num_embeds=VOCAB, mel_dim=MEL)
    params = jax.jit(dit.init)(
        jax.random.key(0), jnp.zeros((1, 8, MEL)), jnp.zeros((1, 8, MEL)),
        jnp.zeros((1, 4), jnp.int32), jnp.zeros((1,)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: (rng.standard_normal(p.shape)
                         * (0.02 + 0.01 * int(str(path[0].key).split("_")[-1])
                            if str(path[0].key).startswith("block_") else 0.05)
                         ).astype(np.float32), params)
    return jconvert.dit_params_to_torch(params, depth=6, conv_layers=1)


def _same_sd(got, want):
    assert list(got) == list(want)
    for key in got:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


# ---------------------------------------------------------------------------
# the pruner


def test_importance_scores_and_selection_equal_the_jax_pruners(torch_layout_sd):
    got, got_fb = tpruner.block_importance_scores(torch_layout_sd)
    want, want_fb = jpruner.block_importance_scores(torch_layout_sd)
    assert got == want and got_fb == want_fb is False and len(got) == 6
    for target, manual in ((4, None), (5, None), (3, None), (3, [0, 3, 5])):
        keep = tpruner.select_blocks_to_keep(got, 6, target, manual)
        assert keep == jpruner.select_blocks_to_keep(want, 6, target, manual)
        assert len(keep) == target and (manual is not None or set(keep) >= {0, 1, 4, 5}
                                        or target < 4)
    # degenerate weights: the position prior
    flat = {k: np.ones_like(v) for k, v in torch_layout_sd.items()}
    got, got_fb = tpruner.block_importance_scores(flat)
    assert (got, got_fb) == jpruner.block_importance_scores(flat) and got_fb
    with pytest.raises(ValueError, match="no transformer blocks"):
        tpruner.block_importance_scores({"transformer.proj_out.weight": np.ones((2, 2))})


def test_prune_state_dict_reindexes_as_the_jax_pruner(torch_layout_sd):
    got = tpruner.prune_state_dict(torch_layout_sd, [0, 1, 4, 5])
    _same_sd(got, jpruner.prune_state_dict(torch_layout_sd, [0, 1, 4, 5]))
    np.testing.assert_array_equal(got["transformer.transformer_blocks.2.attn.to_q.weight"],
                                  torch_layout_sd["transformer.transformer_blocks.4.attn.to_q.weight"])


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_prune_checkpoint_report_and_strict_load(tmp_path, torch_layout_sd, suffix):
    src = str(tmp_path / f"model{suffix}")
    tpruner.save_state_dict(torch_layout_sd, src)
    reports = {}
    for name, mod in (("port", tpruner), ("jax", jpruner)):
        out = str(tmp_path / f"{name}_pruned{suffix}")
        report = mod.prune_checkpoint(src, out, target_layers=4)
        with open(out + ".prune_report.json", encoding="utf-8") as f:
            reports[name] = (report, json.load(f), out)
    (got, got_json, got_path), (want, want_json, want_path) = reports["port"], reports["jax"]
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got_json == want_json
    assert got_json["original_num_transformer_blocks"] == 6 and len(got.blocks_to_keep) == 4
    _same_sd(tpruner.load_state_dict(got_path), jpruner.load_state_dict(want_path))
    # strict into the port's DiT, with the configuration read off the checkpoint
    assert tpruner.test_pruned_model(got_path) and jpruner.test_pruned_model(got_path)
    cfg = tpruner.pruned_model_config(tpruner.load_state_dict(got_path))
    assert (cfg.arch.depth, cfg.arch.dim, cfg.arch.heads * cfg.arch.dim_head, cfg.arch.ff_mult,
            cfg.arch.text_dim, cfg.arch.conv_layers, cfg.mel_spec.n_mel_channels) == (
        4, 64, 64, 2, 32, 1, MEL)
    broken = dict(tpruner.load_state_dict(got_path))
    del broken["transformer.transformer_blocks.3.ff.ff.2.bias"]
    tpruner.save_state_dict(broken, str(tmp_path / f"broken{suffix}"))
    with pytest.raises(RuntimeError, match="Missing key"):
        tpruner.test_pruned_model(str(tmp_path / f"broken{suffix}"))
    tpruner.save_state_dict({"transformer.proj_out.weight": np.ones((2, 2), np.float32)},
                            str(tmp_path / f"empty{suffix}"))
    assert tpruner.test_pruned_model(str(tmp_path / f"empty{suffix}")) is False


def test_embedding_and_inspection_tools_equal_the_jax_pruners(tmp_path, torch_layout_sd):
    pt = str(tmp_path / "m.pt")
    torch.save({"ema_model." + k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in torch_layout_sd.items()} | {"step": torch.tensor(3)}, pt)
    for name, mod in (("port", tpruner), ("jax", jpruner)):
        assert mod.convert_pt_to_safetensors(pt, str(tmp_path / f"{name}.safetensors")) == len(
            torch_layout_sd)
        mod.reset_training_counters(pt, str(tmp_path / f"{name}_reset.pt"))
    _same_sd(tpruner.load_state_dict(str(tmp_path / "port.safetensors")),
             jpruner.load_state_dict(str(tmp_path / "jax.safetensors")))
    _same_sd(tpruner.load_state_dict(str(tmp_path / "port_reset.pt")),
             jpruner.load_state_dict(str(tmp_path / "jax_reset.pt")))
    assert tpruner.get_embedding_size(pt) == jpruner.get_embedding_size(pt) == VOCAB + 1
    assert tpruner.inspect_checkpoint(pt, 5) == jpruner.inspect_checkpoint(pt, 5)
    _same_sd(tpruner.expand_text_embedding(torch_layout_sd, 20, seed=4),
             jpruner.expand_text_embedding(torch_layout_sd, 20, seed=4))


CLI_CASES = {
    "prune": ["prune", "{pt}", "{out}.pt", "--target-layers", "4"],
    "prune_manual_raw": ["prune", "{pt}", "{out}.pt", "--manual-blocks", "0,2,5",
                         "--target-layers", "3", "--no-ema", "--skip-test"],
    "convert": ["convert", "{pt}", "{out}.safetensors"],
    "inspect": ["inspect", "{pt}", "--max-keys", "3"],
    "embedding_size": ["embedding-size", "{pt}"],
    "expand_embedding": ["expand-embedding", "{pt}", "{out}.pt", "--vocab-size", "20"],
    "reset_epoch": ["reset-epoch", "{pt}", "{out}.pt"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_compression_cli_equals_the_jax_cli(tmp_path, torch_layout_sd, capsys, case):
    """`python -m eraxvif5tts_tpu_torch.compression <subcommand>`: the same
    exit code, the same standard output (paths aside) and the same files as
    the JAX package's CLI."""
    pt = str(tmp_path / "m.pt")
    torch.save({"ema_model." + k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in torch_layout_sd.items()}
               | {"model." + k: torch.from_numpy(np.ascontiguousarray(v)) * 2
                  for k, v in torch_layout_sd.items()}, pt)
    outputs = {}
    for name, cli in (("port", tcli), ("jax", jcli)):
        out = str(tmp_path / name)
        argv = [a.format(pt=pt, out=out) for a in CLI_CASES[case]]
        rc = cli.main(argv)
        outputs[name] = (rc, capsys.readouterr().out.replace(out, "OUT"), out)
    (rc, text, out), (want_rc, want_text, want_out) = outputs["port"], outputs["jax"]
    assert rc == want_rc == 0 and text == want_text and text
    for ext in (".pt", ".safetensors", ".pt.prune_report.json"):
        if (tmp_path / f"port{ext}").exists():
            if ext.endswith(".json"):
                assert (tmp_path / f"port{ext}").read_text() == (tmp_path / f"jax{ext}").read_text()
            else:
                _same_sd(tpruner.load_state_dict(out + ext), jpruner.load_state_dict(want_out + ext))


# ---------------------------------------------------------------------------
# the duration predictor


DUR_VOCAB = tduration.predictor_vocab_size(VOCAB)


@pytest.fixture(scope="module")
def dur_params():
    """JAX predictor parameters (d 16, filter 16), every leaf redrawn; the
    projection's bias at log 6: about six frames a phoneme."""
    model = jduration.DurationPredictor(vocab_size=DUR_VOCAB, d_model=16, d_filter=16)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(model.init)(jax.random.key(5), ids, ids > 0)["params"]
    rng = np.random.default_rng(6)
    params = jax.tree.map(lambda p: (0.3 * rng.standard_normal(p.shape)).astype(np.float32),
                          params)
    params["proj"]["bias"] = np.full((1,), np.log(6.0), np.float32)
    return model, params


def _ids():
    ids = np.array([[3, 1, 7, 13, 2, 0, 0], [5, 9, 11, 4, 0, 0, 0]], np.int32)
    return ids, ids > 0


def test_duration_predictor_matches_jax(dur_params):
    jmodel, params = dur_params
    model = tduration.DurationPredictor(DUR_VOCAB, d_model=16, d_filter=16)
    model.load_state_dict(tduration.duration_state_dict_from_jax(params), strict=True)
    assert model.text_embed.weight.shape == (DUR_VOCAB + 1, 16)
    assert model.norm_1.eps == 1e-6
    ids, mask = _ids()
    for m in (mask, None):
        want = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids, m))
        got = model(torch.from_numpy(ids).long(),
                    None if m is None else torch.from_numpy(m)).detach().numpy()
        scale = np.abs(want).max()
        assert scale > 0.5 and np.abs(got - want).max() <= 1e-5 * scale
    # an id outside the table: NaN in both; a negative id from the table's end
    for bad in (DUR_VOCAB, DUR_VOCAB + 7, -3):
        ids_bad = ids.copy()
        ids_bad[0, 1] = bad
        want = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids_bad, None))
        got = model(torch.from_numpy(ids_bad).long()).detach().numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[0]).all() == (bad >= DUR_VOCAB) and np.isfinite(got[1]).all()
        fin = np.isfinite(want)
        assert np.abs(got[fin] - want[fin]).max() <= 1e-5 * np.abs(want[fin]).max()


def _phoneme_map():
    return {c: i + 1 for i, c in enumerate("abcdefghi.")}


def test_phoneme_copy_equals_the_original():
    assert tphoneme.phonemize("ab c.d") == jphoneme.phonemize("ab c.d")
    for grow in (True, False):
        got, want = tphoneme.PhonemeMap(_phoneme_map()), jphoneme.PhonemeMap(_phoneme_map())
        assert (tphoneme.phoneme_to_indices(list("axbz"), got, grow=grow)
                == jphoneme.phoneme_to_indices(list("axbz"), want, grow=grow))
        assert dict(got) == dict(want)
    assert (tphoneme.text_to_phoneme_indices("hi ab.", _phoneme_map())
            == jphoneme.text_to_phoneme_indices("hi ab.", _phoneme_map()))
    for mod in (tphoneme, jphoneme):
        with pytest.raises(ValueError, match="embedding table only holds ids <= 10"):
            mod.phoneme_to_indices(["new"], mod.PhonemeMap(_phoneme_map(), max_index=10))


def _legacy_layouts(ref: dict) -> dict:
    """Every historical layout the JAX loader accepts, from a reference one
    (the embedding unshifted where the layout is)."""
    t = {k: v.clone() for k, v in ref.items()}
    unshifted = t["text_embed.weight"][1:]
    return {
        "reference": dict(t),
        "conv_layers": {"embedding.weight": unshifted,
                        **{f"conv_layers.{i}.{j}.{p}": t[f"{n}_{i + 1}.{p}"]
                           for i in range(2) for j, n in ((0, "conv"), (2, "norm"))
                           for p in ("weight", "bias")},
                        "proj.weight": t["proj.weight"], "proj.bias": t["proj.bias"]},
        "convs_norms": {"embed.weight": unshifted,
                        **{f"convs.{i}.conv.{p}": t[f"conv_{i + 1}.{p}"]
                           for i in range(2) for p in ("weight", "bias")},
                        **{f"norms.{i}.{p}": t[f"norm_{i + 1}.{p}"]
                           for i in range(2) for p in ("weight", "bias")},
                        "out_proj.weight": t["proj.weight"], "out_proj.bias": t["proj.bias"]},
        "nested": {"model_state_dict": dict(t)},
    }


@pytest.mark.parametrize("layout", ["reference", "conv_layers", "convs_norms", "nested"])
def test_duration_checkpoints_cross_both_packages(tmp_path, dur_params, layout):
    """The port's `save_duration_predictor` file loads in the JAX package and
    the JAX package's in the port, each historical layout in both; every
    load predicts the same log-durations and frame counts."""
    jmodel, params = dur_params
    phoneme_map = _phoneme_map()
    ids, mask = _ids()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids, mask))
    text = "abc, de figh. ab"
    want_frames = jduration.predict_duration_frames(jmodel, params, phoneme_map, text)
    assert want_frames > 20

    # JAX -> port
    jpath = str(tmp_path / "jax.pt")
    jduration.save_duration_predictor(jpath, params, phoneme_map)
    model, got_map = tduration.load_duration_predictor(jpath, device="cpu")
    assert got_map == phoneme_map and not model.training
    ref = dict(model.state_dict())
    # the layout under test, written as the JAX loader reads it
    path = str(tmp_path / f"{layout}.pt")
    torch.save({"duration_predictor": _legacy_layouts(ref)[layout], "phoneme_map": phoneme_map},
               path)
    for loaded in (tduration.load_duration_predictor(path, device="cpu")[0],):
        got = loaded(torch.from_numpy(ids).long(), torch.from_numpy(mask)).detach().numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        assert tduration.predict_duration_frames(loaded, phoneme_map, text) == want_frames
    jm, jp, jmap = jduration.load_duration_predictor(path)
    assert jmap == phoneme_map
    np.testing.assert_allclose(np.asarray(jax.jit(jm.apply)({"params": jp}, ids, mask)), want,
                               rtol=0, atol=1e-6)

    # port -> JAX
    ppath = str(tmp_path / "port.pt")
    tduration.save_duration_predictor(ppath, model, phoneme_map, update=3)
    jm, jp, jmap = jduration.load_duration_predictor(ppath)
    assert jmap == phoneme_map and torch.load(ppath, weights_only=False)["update"] == 3
    assert jduration.predict_duration_frames(jm, jp, phoneme_map, text) == want_frames
    assert tduration.predict_duration_frames(model, phoneme_map, text) == want_frames
    assert tduration.predict_duration_frames(model, phoneme_map, "xyz") == 0 == (
        jduration.predict_duration_frames(jm, jp, phoneme_map, "xyz"))


def test_linear_projection_layout_loads_in_the_port(tmp_path, dur_params):
    """The legacy ``linear.weight [1, d]`` projection: the port reads it as the
    ``[1, d, 1]`` convolution. The JAX loader turns it into a ``[d, 1, 1]``
    kernel that flax refuses (a fault of the reference, ROADMAP.md queue 3),
    so the port is held to the reference layout's predictions instead."""
    jmodel, params = dur_params
    ids, mask = _ids()
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, ids, mask))
    ref = tduration.duration_state_dict_from_jax(params)
    legacy = {k: v for k, v in ref.items() if not k.startswith("proj.")}
    legacy.update({"linear.weight": ref["proj.weight"][:, :, 0], "linear.bias": ref["proj.bias"]})
    path = str(tmp_path / "linear.pt")
    torch.save(legacy, path)
    model, _ = tduration.load_duration_predictor(path, device="cpu")
    got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    jm, jp, _ = jduration.load_duration_predictor(path)
    assert jp["proj"]["kernel"].shape == (16, 1, 1)
    with pytest.raises(Exception, match="expected to generate shape"):
        jax.jit(jm.apply)({"params": jp}, ids, mask)


def test_out_of_table_phoneme_ids_raise_in_both(dur_params):
    jmodel, params = dur_params
    model = tduration.DurationPredictor(DUR_VOCAB, d_model=16, d_filter=16)
    model.load_state_dict(tduration.duration_state_dict_from_jax(params))
    bad_map = {"a": 1, "b": DUR_VOCAB + 2}
    with pytest.raises(ValueError, match="cannot convert float NaN"):
        jduration.predict_duration_frames(jmodel, params, bad_map, "ab")
    with pytest.raises(ValueError, match="outside the duration predictor's table"):
        tduration.predict_duration_frames(model, bad_map, "ab")


# ---------------------------------------------------------------------------
# the wrappers' durations


def test_wrapper_durations_with_the_predictor_match_jax(tmp_path, dur_params, monkeypatch):
    """`generate` (chunk by chunk) and `generate_batch` with the duration
    predictor on: the port wrapper picks the JAX wrapper's durations, the
    sampler is not run (both wrappers' sampling steps are stubbed), and
    ``fix_duration`` still wins; with the option off, or for a text with no
    phoneme in the map, the byte-ratio duration."""
    from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
    from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper

    _, params = dur_params
    path = str(tmp_path / "dur.pt")
    jduration.save_duration_predictor(path, params, _phoneme_map())
    vocab = {c: i for i, c in enumerate(" abcdefghi.,")}
    arch = dataclasses.replace(ARCH6, depth=1)
    kw = dict(model_cfg=ModelConfig(name="tiny", arch=arch), vocab_char_map=vocab, nfe_step=1,
              compute_dtype="float32", duration_buckets=(256, 512, 1024), text_buckets=(128,),
              duration_predictor_ckpt=path)
    seen = {"jax": [], "port": []}

    def j_step(self, params_, vparams, cond, text, duration, lens, key, rms, **static):
        seen["jax"].append([int(d) for d in np.asarray(duration)])
        shape = (text.shape[0], (static["max_duration"] - static["vocode_start"]) * 256)
        return jnp.ones(shape, jnp.int16) * 100, jnp.zeros((text.shape[0], 4, MEL))

    def t_step(self, cond, text, duration, lens, noise, rms, **static):
        seen["port"].append([int(d) for d in duration])
        shape = (text.shape[0], (static["max_duration"] - static["vocode_start"]) * 256)
        return torch.full(shape, 100, dtype=torch.int16), torch.zeros(text.shape[0], 4, MEL)

    monkeypatch.setattr(JWrapper, "_dispatch_sample_vocode", j_step)
    monkeypatch.setattr(F5TTSWrapper, "_sample_vocode", t_step)
    t = np.arange(int(24000 * 1.5)) / 24000
    audio = (0.2 * np.sin(2 * np.pi * 190 * t)).astype(np.float32)
    text = ("abc def, ghi abc. " * 6).strip()
    durations = {True: [], False: []}
    for use in (True, False):
        jw = JWrapper(use_duration_predictor=use, **kw)
        tw = F5TTSWrapper(use_duration_predictor=use, device="cpu", **kw)
        assert tw.phoneme_map == jw.phoneme_map == _phoneme_map()
        jref = jw.preprocess_reference(ref_audio=audio, ref_sample_rate=24000, ref_text="hi abc")
        tref = tw.preprocess_reference(ref_audio=audio, ref_sample_rate=24000, ref_text="hi abc")
        for call in (lambda w, r: w.generate(text, ref=r, use_pinyin=False),
                     lambda w, r: w.generate(text, ref=r, use_pinyin=False, fix_duration=4.0),
                     lambda w, r: w.generate("xyz, zz", ref=r, use_pinyin=False),
                     lambda w, r: w.generate_batch(["abc def.", "gh, ab cd ef gh.", "zz"],
                                                   ref=r, use_pinyin=False)):
            seen["jax"].clear(), seen["port"].clear()
            call(jw, jref)
            call(tw, tref)
            assert seen["port"] == seen["jax"] and seen["port"]
            durations[use].append(seen["port"][:])
        if use:
            frames = tduration.predict_duration_frames(tw.duration_predictor, tw.phoneme_map,
                                                       "abc def.")
            assert frames > 0 and tw._duration_for(tref, "abc def.", 1.0, None) == (
                tref.n_frames + frames)
    with_predictor, byte_ratio = durations[True], durations[False]
    # the predictor set the phoneme texts' durations; fix_duration and the
    # text with no phoneme in the map did not use it
    assert with_predictor[0] != byte_ratio[0] and with_predictor[3] != byte_ratio[3]
    assert with_predictor[1:3] == byte_ratio[1:3]
