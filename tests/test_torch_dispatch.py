"""PyTorch port: the wrapper's single dispatch per chunk and its chunk
pipeline, against the JAX wrapper on the same weights (the tiny DiT and
Vocos of `tests/test_torch_slice.py`).

- The fused step's dispatch keys: after the same `warmup`, `generate` and
  `generate_batch` calls, the port has seen as many distinct keys as the JAX
  wrapper's `_sample_vocode_jit` holds executables.
- `generate` keeps at most three chunks in flight before it fetches one;
  its wave equals the JAX `generate`'s within 4 / 32767 (the sampler noise is
  the JAX draw, handed to the port), as in `tests/test_torch_slice.py`.
- Two references of one length but different mel and RMS go through one key
  and each equals its own eager step bit for bit (a baked input would give
  the second the first's); the rescaled one matches the JAX step within 4 LSB.
- `tools/bench.py --smoke --device cpu` prints one JSON line with the keys of
  `bench.py`'s line.
- Under a capture the kernels' wrappers record their launches for the
  replays and hold the cached tensors the graph reads.
- On the card, `tests/test_torch_cuda.py::test_graph_replay_equals_the_eager_step`
  (`cuda` marker, skipped here).
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.infer.wrapper import F5TTSWrapper as JWrapper
from eraxvif5tts_tpu.models.vocos import Vocos as JVocos
from eraxvif5tts_tpu.text.chunk import chunk_text
from eraxvif5tts_tpu_torch.infer import wrapper as twrapper
from eraxvif5tts_tpu_torch.infer.wrapper import F5TTSWrapper
from eraxvif5tts_tpu_torch.tools import bench as tbench
from test_torch_models import MEL, redraw, tiny_params
from test_torch_slice import BUCKETS, CFG, PCM_LSB, REF_TEXT, SR, VOCAB, _ref_audio

REPO_ROOT = Path(__file__).resolve().parents[1]
NFE = 2
LONG_TEXT = ("the lamp turned. the sea was calm. no ship passed the point. the boat comes "
             "soon. the keeper wrote a line. then the dawn came.")


@pytest.fixture(scope="module")
def weights():
    vparams = redraw(jax.jit(JVocos().init)(jax.random.key(1), jnp.zeros((1, MEL, 8)))
                     ["params"], seed=21, std=0.05)
    vparams["head_out"]["bias"] += 2.0  # log-magnitude ~2: a signal well above 1 LSB
    return tiny_params(seed=20), vparams


def _pair(weights, **kwargs):
    """A fresh JAX wrapper and port wrapper on the same weights, and their
    references of the same clip."""
    params, vparams = weights
    common = dict(model_cfg=CFG, vocab_char_map=VOCAB, nfe_step=NFE, params=params,
                  vocoder_params=vparams, compute_dtype="float32", **BUCKETS, **kwargs)
    jw, tw = JWrapper(**common), F5TTSWrapper(device="cpu", **common)
    refs = [w.preprocess_reference(ref_audio=_ref_audio(), ref_sample_rate=SR,
                                   ref_text=REF_TEXT) for w in (jw, tw)]
    return jw, refs[0], tw, refs[1]


@pytest.fixture(scope="module")
def one_thread():
    """Torch on one intra-op thread: beside the other test workers its pool
    on every core makes tiny tensors many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_noise(seed: int, draws: list):
    """`F5TTSWrapper._draw_noise` drawing the JAX `generate`'s noise:
    ``fold_in(key(seed), chunk)``, one draw a chunk."""
    def draw(self, generator, n_frames):
        key = jax.random.fold_in(jax.random.key(seed), len(draws))
        draws.append(n_frames)
        return torch.from_numpy(np.array(jax.random.normal(key, (n_frames, MEL), jnp.float32)))

    return draw


def test_dispatch_keys_match_the_jax_jit_cache(weights, one_thread):
    jw, jref, tw, tref = _pair(weights)
    calls = (
        lambda w, r: w.warmup(r, buckets=(128,)),
        # a fixed 1.2 s: the warmed (128, 64) pair again, then a new step count
        lambda w, r: w.generate("a short line.", ref=r, seed=1, fix_duration=1.2,
                                use_pinyin=False),
        lambda w, r: w.generate("a short line.", ref=r, seed=1, fix_duration=1.2,
                                nfe_step=1, use_pinyin=False),
        lambda w, r: w.generate_batch(["one two.", "three four five."], ref=r, seed=2,
                                      use_pinyin=False),
    )
    sizes = []
    for call in calls:
        call(jw, jref)
        call(tw, tref)
        sizes.append((len(tw.dispatch_keys), jw._sample_vocode_jit._cache_size()))
    assert [port for port, _ in sizes] == [jax_ for _, jax_ in sizes] == [1, 1, 2, 3]
    assert tw._graphs == {} and tw.graph_replays == 0  # the CPU captures nothing


def test_generate_keeps_three_chunks_in_flight_and_matches_jax(weights, one_thread,
                                                               monkeypatch):
    jw, jref, tw, tref = _pair(weights)
    seed, draws = 5, []
    monkeypatch.setattr(F5TTSWrapper, "_draw_noise", jax_noise(seed, draws))
    fetch, dispatch = F5TTSWrapper._fetch_async, F5TTSWrapper._dispatch_sample_vocode
    fetched, synced, in_flight = [0], [0], []

    class Arrival:
        def synchronize(self):
            synced[0] += 1

    def fetch_async(self, *tensors):
        fetched[0] += 1
        return (*fetch(self, *tensors)[:-1], Arrival())

    def counted(self, *args, **kwargs):
        in_flight.append(fetched[0] - synced[0])  # dispatched, not yet read by the host
        return dispatch(self, *args, **kwargs)

    monkeypatch.setattr(F5TTSWrapper, "_fetch_async", fetch_async)
    monkeypatch.setattr(F5TTSWrapper, "_dispatch_sample_vocode", counted)
    want = jw.generate(LONG_TEXT, ref=jref, seed=seed, use_pinyin=False)
    got = tw.generate(LONG_TEXT, ref=tref, seed=seed, use_pinyin=False)
    max_chars, hard = tw._max_chars_for(tref)
    chunks = len(chunk_text(LONG_TEXT, max_chars=max_chars, hard_max=hard))
    assert len(draws) == len(in_flight) == chunks >= 5
    assert in_flight == [min(i, 3) for i in range(chunks)]  # three queued, then one out a chunk
    assert synced[0] == fetched[0] == chunks
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= PCM_LSB / 32767.0


def test_references_of_one_shape_share_a_key_and_keep_their_own_inputs(weights, one_thread):
    jw, jref, tw, tref = _pair(weights)
    # the same clip at a quarter of the level: rescaled to the target RMS, so
    # its mel and its rms_scale differ while its length does not
    quiet = [w.preprocess_reference(ref_audio=0.25 * _ref_audio(), ref_sample_rate=SR,
                                    ref_text=REF_TEXT) for w in (jw, tw)]
    assert quiet[1].n_frames == tref.n_frames and quiet[1].rms < tw.target_rms < tref.rms
    assert not torch.equal(quiet[1].mel, tref.mel)
    rng = np.random.default_rng(22)
    text = np.full((1, 64), -1, np.int64)
    text[0, :55] = rng.integers(0, len(VOCAB), 55)
    n_ref, bucket, duration = tref.n_frames, 128, 120
    vstart = n_ref - twrapper.VOCODE_MARGIN_FRAMES
    static = dict(steps=NFE, cfg_strength=2.0, sway=-1.0, max_duration=bucket,
                  vocode_start=vstart, gen_start=n_ref - vstart)
    key = jax.random.key(23)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (bucket, MEL), jnp.float32)))
    pcms = []
    for ref in (tref, quiet[1]):
        args = (ref.mel, torch.from_numpy(text), torch.tensor([duration]), torch.tensor([n_ref]),
                noise, tw._rms_scale(ref))
        got_pcm, got_mel = tw._dispatch_sample_vocode(*args, **static)
        want_pcm, want_mel = tw._sample_vocode(*args, **static)
        assert torch.equal(got_pcm, want_pcm) and torch.equal(got_mel, want_mel)
        pcms.append(got_pcm)
    assert len(tw.dispatch_keys) == 1
    assert float(tw._rms_scale(quiet[1])) == pytest.approx(quiet[1].rms / tw.target_rms)
    assert (pcms[1].abs().max() < pcms[0].abs().max()) and not torch.equal(*pcms)
    want, _ = jw._sample_vocode_jit(
        jw.params, jw.vocoder_params, quiet[0].mel, jnp.asarray(text.astype(np.int32)),
        jnp.asarray([duration]), jnp.asarray([n_ref]), key,
        jnp.asarray(quiet[0].rms / jw.target_rms, jnp.float32), **static)
    diff = np.abs(pcms[1].numpy().astype(np.int32) - np.asarray(want).astype(np.int32))
    assert np.abs(np.asarray(want)).max() > 300 and diff.max() <= PCM_LSB


def test_bench_smoke_prints_bench_py_line(one_thread, capsys):
    assert tbench.main(["--smoke", "--device", "cpu", "--iters", "2", "--nfe", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    # the keys of the JSON object bench.py prints, read from its source
    tree = ast.parse((REPO_ROOT / "bench.py").read_text())
    printed = [node.args[0] for node in ast.walk(tree) if isinstance(node, ast.Call)
               and getattr(node.func, "attr", None) == "dumps"]
    assert len(printed) == 1 and isinstance(printed[0], ast.Dict)
    assert list(line) == [k.value for k in printed[0].keys]
    assert line["metric"] == "rtf_nfe4" and line["unit"] == "x_realtime"
    # both are rounded to 3 decimals from the unrounded rate: within 5.25e-4
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 20.0,
                                                                       abs=6e-4)
    assert not any(earlier.startswith("{") for earlier in lines[:-1])


def test_capture_defers_launch_counts_to_replays_and_holds_cached_tensors():
    """Under `_cuda.capture` a kernel wrapper's count goes to the capture's
    record (a capture launches nothing), `add_launches` adds the record once
    a replay, and `hold` keeps what a graph reads from a host cache; outside
    a capture counts go to the counters and nothing is held."""
    from eraxvif5tts_tpu_torch.ops import _cuda

    def kernel():
        pass

    kernel.launches, kernel.launches_by_mode = 0, {"a": 0, "b": 0}
    table = torch.zeros(3)
    with _cuda.capture() as record:
        for _ in range(4):
            _cuda.count(kernel, "launches", ("launches_by_mode", "a"))
        _cuda.hold(table, None)
    assert (kernel.launches, kernel.launches_by_mode) == (0, {"a": 0, "b": 0})
    assert record.launches == {(kernel, "launches"): 4, (kernel, ("launches_by_mode", "a")): 4}
    assert len(record.held) == 1 and record.held[0] is table
    for _ in range(2):
        _cuda.add_launches(record.launches)
    _cuda.count(kernel, "launches", ("launches_by_mode", "b"))
    _cuda.hold(table)  # no capture under way: nothing to hold it for
    assert (kernel.launches, kernel.launches_by_mode) == (9, {"a": 8, "b": 1})
    assert len(record.held) == 1
