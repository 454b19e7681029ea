"""PyTorch port, the mesh layer (`parallel/mesh.py`) and the multi-device
entry points: the sharding rules against the JAX package's, the multi-host
epoch slice against the JAX function's, the wrapper's ``generate_batch`` on
a data and on a model mesh, and ``train_main`` / ``finetune_main`` in a
two-process group. The ranks are real gloo processes on the CPU
(`tests/torch_mesh_workers.py`, which import no JAX); the JAX side runs here
on the virtual 8-device CPU mesh.

Tolerances: the rules and the batches exactly; the wrapper's PCM within
``atol = 2e-2`` of the one-device port's and of the JAX mesh wrapper's
(`tests/test_multichip.py`'s bound for its mesh wrapper against one device).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eraxvif5tts_tpu.configs import ArchConfig as JArchConfig
from eraxvif5tts_tpu.configs import MelSpecConfig as JMelSpecConfig
from eraxvif5tts_tpu.configs import ModelConfig as JModelConfig
from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.cfm import CFM as JCFM
from eraxvif5tts_tpu.models.dit import DiT as JDiT
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.parallel.mesh import make_mesh as j_make_mesh
from eraxvif5tts_tpu.parallel.mesh import param_sharding_rules as j_rules
from eraxvif5tts_tpu.training import cli as jcli
from eraxvif5tts_tpu.training import dataset as jds
from eraxvif5tts_tpu_torch.compression.convert import (
    _t_linear,
    dit_rules,
    mmdit_rules,
    unett_rules,
)
from eraxvif5tts_tpu_torch.configs import ArchConfig, ModelConfig
from eraxvif5tts_tpu_torch.models import build_backbone
from eraxvif5tts_tpu_torch.parallel.mesh import param_sharding_rules, shard_dim
from eraxvif5tts_tpu_torch.training import cli
from eraxvif5tts_tpu_torch.training import dataset as tds
from test_torch_models import redraw
import torch_mesh_workers as wk

MODELS = [
    ("DiT", dit_rules(2, 1, qk_norm=True, long_skip=True), dict(qk_norm="rms_norm",
                                                                long_skip_connection=True)),
    ("UNetT", unett_rules(2, 0, qk_norm=True), dict(qk_norm="rms_norm", conv_layers=0)),
    ("MMDiT", mmdit_rules(2, qk_norm=True), dict(qk_norm="rms_norm")),
]


@pytest.mark.parametrize("backbone,rules,arch_kw", MODELS, ids=[m[0] for m in MODELS])
def test_sharding_rules_equal_jax_through_the_key_map(backbone, rules, arch_kw):
    """(a) Every parameter of a tiny DiT, UNetT and MMDiT: the port's spec of
    its torch name is the JAX spec of its flax path, transposed where the
    map transposes (a torch Linear weight is [out, in]: JAX's
    column-parallel P(None, "model") is the port's dim 0)."""
    arch = ArchConfig(**{**dataclasses.asdict(wk.ARCH), **arch_kw})
    model = build_backbone(ModelConfig(name="tiny", backbone=backbone, arch=arch), 8)
    by_name = {key: (path, fwd) for key, path, fwd, _ in rules}
    names = dict(model.named_parameters())
    assert set(names) <= set(by_name), set(names) - set(by_name)
    split = 0
    for name, p in names.items():
        path, fwd = by_name[name]
        want = tuple(j_rules("/".join(path)))
        got = param_sharding_rules(name)
        assert got == (tuple(reversed(want)) if fwd is _t_linear else want), (name, got, want)
        split += got != ()
        dim = shard_dim(name, p.shape, 2)
        assert dim == (got.index("model") if got else None), name
    # JAX splits the DiT's q / k / v, to_out and FF, the MMDiT's audio-stream
    # attention only, and no UNetT leaf (its paths are attn_N/..., ff_N/...)
    assert split == {"DiT": 2 * 10, "UNetT": 0, "MMDiT": 2 * 7}[backbone]


def test_multihost_epoch_batches_match_jax_with_injected_ranks():
    """(g) Each rank's batches of an epoch (rank and world injected, as
    `tests/test_multichip.py:171`): equal counts, the tail trimmed, fixed
    shapes, and the same arrays as the JAX function's."""
    vocab = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz0123456789")}

    def dataset(mod):
        rng = np.random.default_rng(0)
        rows = [mod.Sample(text="sample %d" % i, duration_frames=16 + i,
                           mel=rng.standard_normal((16 + i, 8)).astype(np.float32))
                for i in range(10)]

        class Tiny:
            def __len__(self):
                return len(rows)

            def __getitem__(self, i):
                return rows[i]

            def frame_length(self, i):
                return rows[i].mel.shape[0]

        return Tiny()

    jmesh = j_make_mesh(n_model=1)
    got_all = []
    for pc in (2, 3):
        counts = set()
        for pi in range(pc):
            ds, jdsx = dataset(tds), dataset(jds)
            sampler = tds.DynamicBatchSampler([ds.frame_length(i) for i in range(10)], 64,
                                              max_samples=2, random_seed=0)
            jsampler = jds.DynamicBatchSampler([jdsx.frame_length(i) for i in range(10)], 64,
                                               max_samples=2, random_seed=0)
            got = list(cli.multihost_epoch_batches(ds, sampler, vocab, 0, None,
                                                   process_index=pi, process_count=pc))
            want = list(jcli.multihost_epoch_batches(jdsx, jsampler, vocab, 0, jmesh,
                                                     process_index=pi, process_count=pc))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    np.testing.assert_array_equal(g[k], np.asarray(w[k]))
                assert g["mel"].shape[1] == tds.TRAIN_FRAME_BUCKETS[-1]
                assert g["text"].shape[1] == tds.TRAIN_TEXT_BUCKETS[-1]
            counts.add(len(got))
            got_all.append(got)
        assert len(counts) == 1  # every rank the same number
    assert not np.array_equal(got_all[0][0]["lens"], got_all[1][0]["lens"])


VOCAB = {c: i for i, c in enumerate(" abcdefghijklmnopqrstuvwxyz.,!?")}


def test_multihost_ranks_grow_one_phoneme_map(tmp_path):
    """With ``--multihost`` each data rank collates other rows: the loader
    group shares each round's phonemes, so both ranks of a group of two
    hold the map one process grows over the same batches (the epoch's
    first four, the fifth trimmed), and a phoneme has one id everywhere.
    Without the sharing the ranks' maps differ (the control)."""
    from eraxvif5tts_tpu_torch.text.phoneme import PhonemeMap

    outs = wk.spawn("phoneme_case", 2, str(tmp_path), {"vocab": VOCAB})
    dataset, sampler = wk.phoneme_dataset()
    one = PhonemeMap(max_index=64)
    sampler.set_epoch(0)
    usable = (len(sampler) // 2) * 2
    for i, batch in enumerate(cli.epoch_batches(dataset, sampler, VOCAB, 0, phoneme_map=one)):
        if i + 1 == usable:
            break
    assert outs[0]["map"] == outs[1]["map"] == dict(one)
    for out in outs:
        assert len(out["phoneme"]) == usable // 2
    alone = []
    for pi in range(2):
        own = PhonemeMap(max_index=64)
        dataset, sampler = wk.phoneme_dataset()
        list(cli.multihost_epoch_batches(dataset, sampler, VOCAB, 0, None, phoneme_map=own,
                                         process_index=pi, process_count=2))
        alone.append(dict(own))
    assert alone[0] != alone[1]


# ---------------------------------------------------------------------------
# the wrapper on a mesh

WRAPPER_ARCH = dict(dataclasses.asdict(wk.ARCH))
TEXTS = ["one test sentence.", "two test sentences.", "a third one."]


@pytest.fixture(scope="module")
def wrapper_inputs():
    sr = 24000
    t = np.arange(sr // 4) / sr
    jcfg = JModelConfig(name="tiny", arch=JArchConfig(**WRAPPER_ARCH), mel_spec=JMelSpecConfig())
    params = redraw(JCFM(transformer=JDiT(arch=jcfg.arch, text_num_embeds=len(VOCAB),
                                          mel_dim=100)).init_params(jax.random.key(0)), 30)
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, 100, 8)))
                     ["params"], seed=31, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    noise = {n: np.array(jax.random.normal(jax.random.key(0), (n, 100), jnp.float32))
             for n in (64, 128)}
    return dict(arch=WRAPPER_ARCH, vocab=VOCAB, params=params, vparams=vparams,
                noise=noise, texts=TEXTS, jcfg=jcfg,
                ref_wav=(0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32))


def test_generate_batch_on_data_and_model_meshes(wrapper_inputs, tmp_path):
    """(h) ``generate_batch`` of three texts on a data-2 mesh (padded to 4,
    each rank sampling its rows) returns on every rank the one-device port's
    PCM and the JAX mesh wrapper's; on a model-2 mesh (one head a rank,
    eager step) it stays within 3e-4 relative L2 of one device."""
    import torch

    inputs = {k: v for k, v in wrapper_inputs.items() if k != "jcfg"}
    inputs["noise"] = {n: torch.from_numpy(v) for n, v in inputs["noise"].items()}
    outs = wk.spawn("wrapper_cases", 2, str(tmp_path), inputs)
    one = wk.build_wrapper(inputs).generate_batch(TEXTS, seed=0, use_pinyin=False)

    jw = JWrapper(model_cfg=wrapper_inputs["jcfg"], vocab_char_map=VOCAB, nfe_step=2,
                  params=wrapper_inputs["params"], vocoder_params=wrapper_inputs["vparams"],
                  compute_dtype="float32", duration_buckets=(64, 128), text_buckets=(64,),
                  mesh=j_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2]))
    jw.preprocess_reference(ref_audio=wrapper_inputs["ref_wav"], ref_sample_rate=24000,
                            ref_text="hello there")
    want = jw.generate_batch(TEXTS, seed=0, use_pinyin=False)
    for out in outs:
        assert out["data_heads"] == 2 and out["model_heads"] == 1
        for name in ("data", "model"):
            assert len(out[name]) == 3
            for got, single, jax_wave in zip(out[name], one, want):
                assert got.shape == single.shape == jax_wave.shape
                assert np.isfinite(got).all()
                np.testing.assert_allclose(got, single, atol=2e-2)
                if name == "data":
                    np.testing.assert_allclose(got, jax_wave, atol=2e-2)
    # the data mesh's rows are the one-device batch's rows, and the model
    # mesh's sums reassociate only: both far tighter than the bound (they
    # read <= 3.9e-5 relative L2, a bias added on both model ranks 2.4e-3)
    for name in ("data", "model"):
        for g, s in zip(outs[0][name], one):
            assert np.linalg.norm(g - s) <= 3e-4 * np.linalg.norm(s), name


# ---------------------------------------------------------------------------
# the training CLIs in a group of two

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)


def test_train_and_finetune_clis_in_a_two_process_group(tmp_path):
    """(i) ``train_main --n-model 2`` (one head a rank), ``finetune_main
    --zero1`` (the moments partitioned) and ``finetune_main`` with the
    duration-predictor curriculum at ``--n-model 2`` and with
    ``--multihost`` each run two updates in a group of two on a tiny
    prepared dataset."""
    pytest.importorskip("datasets")
    from eraxvif5tts_tpu_torch.audio.io import write_wav
    from eraxvif5tts_tpu_torch.training.prepare import prepare_csv_wavs

    src = tmp_path / "src"
    (src / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(0)
    lines = []
    for i, text in enumerate(["hello there", "a cat sat.", "big dogs run", "why not"]):
        wav = (0.1 * rng.standard_normal(int(24000 * (0.4 + 0.1 * i)))).astype(np.float32)
        write_wav(str(src / "wavs" / f"{i}.wav"), wav, 24000)
        lines.append(f"wavs/{i}.wav|{text}")
    (src / "metadata.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    data = tmp_path / "data"
    prepare_csv_wavs(str(src), str(data / "tiny_char"), use_pinyin=False)
    arch = ", ".join(f"{k}: {v}" for k, v in TINY.items())
    yaml = tmp_path / "tiny.yaml"
    yaml.write_text(f"""
datasets: {{name: tiny, batch_size_per_gpu: 300, batch_size_type: frame, max_samples: 2}}
optim: {{epochs: 1, learning_rate: 1.0e-4, num_warmup_updates: 1}}
model: {{name: tiny, tokenizer: char, arch: {{{arch}}}}}
ckpts: {{logger: null, log_samples: false, save_per_updates: 100, last_per_updates: 0,
        save_dir: {tmp_path / "train"}}}
""", encoding="utf-8")
    def finetune(name, *extra):
        return ["--dataset_name", "tiny", "--tokenizer", "char", "--data-dir", str(data),
                "--batch_size_per_gpu", "300", "--max_samples", "2", "--epochs", "1",
                "--num_warmup_updates", "1", "--save_per_updates", "100",
                "--last_per_updates", "0", "--logger", "none", "--from-scratch",
                "--checkpoint_dir", str(tmp_path / name), "--device", "cpu", *extra]

    # the curriculum: one update of the focus phase, then the full phase
    curriculum = ("--use_duration_predictor", "--duration_focus_updates", "1")
    outs = wk.spawn("cli_cases", 2, str(tmp_path / "ranks"), {"arch": TINY, "entries": [
        ("train", "train", [str(yaml), "--data-dir", str(data), "--device", "cpu",
                            "--n-model", "2"]),
        ("finetune", "finetune", finetune("finetune", "--zero1")),
        ("curriculum_tp", "finetune", finetune("curriculum_tp", *curriculum, "--n-model", "2")),
        ("curriculum_dp", "finetune", finetune("curriculum_dp", *curriculum, "--multihost",
                                               "--epochs", "2"))]})
    for out in outs:
        assert all(out[name]["step"] >= 2 and out[name]["finite"] for name in out)
        assert out["train"]["heads"] == out["curriculum_tp"]["heads"] == 1
        assert out["finetune"]["heads"] == out["curriculum_dp"]["heads"] == 2
        assert out["finetune"]["moments_1d"] and not out["train"]["moments_1d"]
        assert out["curriculum_tp"]["predictor"] and out["curriculum_dp"]["predictor"]
        assert not out["finetune"]["predictor"]
    for name in outs[0]:
        assert (tmp_path / name / "model_last").is_dir()
    for name in ("curriculum_tp", "curriculum_dp"):
        assert (tmp_path / name / "duration_predictor_last.pt").is_file()


# ---------------------------------------------------------------------------
# the global coordinates of the dropout on a rank's block


def test_plain_attention_and_hash_dropout_at_offsets_equal_the_whole():
    """A rank's block at its offsets keeps the whole tensor's bits: the plain
    training attention (rows 1-2 of 3, heads 2-3 of 4; output and q / k / v
    gradients, the kernels' CPU version) and the position-hash dropout
    (rows and columns of a [b, n, c] block). Without the offsets the masks
    differ."""
    import torch

    from eraxvif5tts_tpu_torch.ops import train_attention as ta
    from eraxvif5tts_tpu_torch.ops.dropout import hash_dropout

    g = torch.Generator().manual_seed(3)
    whole = [torch.randn((3, 64, 4, 32), generator=g) for _ in range(4)]
    lens = torch.tensor([64, 40, 64])

    def grads(t, lens_t, b0, h0):
        args = [x.clone().requires_grad_() for x in t[:3]]
        out = ta.train_attention_reference(*args, lens_t, 0.1, 9, b0, h0)
        return [out.detach(), *torch.autograd.grad(out, args, t[3])]

    full = grads(whole, lens, 0, 0)
    block = [t[1:3, :, 2:4] for t in whole]
    for w, p in zip(full, grads(block, lens[1:3], 1, 2)):
        assert torch.equal(w[1:3, :, 2:4], p)
    assert not torch.equal(full[0][1:3, :, 2:4], grads(block, lens[1:3], 0, 0)[0])

    x = torch.randn((4, 8, 12), generator=g)
    full = hash_dropout(x, 0.3, (5, 6))
    got = hash_dropout(x[2:, :, 6:], 0.3, (5, 6), batch_offset=2, col_offset=6, cols=12)
    assert torch.equal(got, full[2:, :, 6:])
    assert not torch.equal(hash_dropout(x[2:, :, 6:], 0.3, (5, 6)), full[2:, :, 6:])
