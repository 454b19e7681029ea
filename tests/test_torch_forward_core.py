"""PyTorch port, the forward-attention core that the training forward and the
serving attention share (`csrc/flash_forward.cuh`): what of it is plain
Python beside the wrappers, at both head dims the kernels are built for (64
and 128). The launch geometry for every n of the serving attention's domain,
64 to 6144 (the MMDiT's joint sequence; training stops at 4096) (each row
owned by one warpgroup, the last block's warpgroups without rows where n is
no multiple of a block's rows, the shared-memory sum within the card's limit,
the registers ``setmaxnreg`` asks within what the launch has, the tensor map
and its panels), the swizzled tile map through which the kernel rotates a
tile in place (a bijection that keeps every interleaved pair together), the
rotating threads' cover of a tile, and the cache of cos / sin tables in the
serving wrapper (one pair per angle table, the same output as without it,
the CPU path untouched). The key tiles the core walks (128 keys at d = 128,
64 at d = 64 and 256: the last may hang over n and is the only one whose
keys are tested) are stated by `forward_key_tiles`; its schedule, an online
softmax over those tiles in float64 with a sample's logits at scale 0 where
it has no valid key, is held to the JAX package's dense attention. The
kernels themselves run on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eraxvif5tts_tpu.ops import train_attention as jta

from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
@pytest.mark.parametrize("n", list(range(64, 6144 + 1, 64)))
def test_forward_geometry_covers_every_row_once_within_the_card(n, d):
    b, h = 3, 16
    geo = tta.forward_geometry(b, n, h, d)
    rows = {64: 192, 128: 128}[d]
    per_block = rows // 64  # consumer warpgroups a block
    # K / V tiles of 64 keys at d = 64, 128 at d = 128: a full sample walks
    # every key once, the last tile hanging over n by n % 128 there, and that
    # tile alone tests its keys
    keys = {64: 64, 128: 128}[d]
    assert geo["key_tile"] == keys and geo["overlap"] == (d == 128)
    tiles = tta.forward_key_tiles(n, n, d)
    assert [(first, size) for first, size, _ in tiles] == [(k, keys) for k in range(0, n, keys)]
    assert tiles[-1][0] + keys - n == -n % keys
    assert [masked for _, _, masked in tiles] == [False] * (len(tiles) - 1) + [True]
    assert tta.forward_key_tiles(n, 0, d) == tiles  # no valid key: every key below n
    assert geo["grid"] == (len(geo["warpgroups"]), h, b) == (-(-n // rows), h, b)
    assert geo["threads"] == 128 * (geo["rows"] // geo["tile"] + 1)
    # setmaxnreg: the producer's warpgroup and the consumers' within what the
    # launch has (65,536 registers over the block's threads, a multiple of 8)
    producer, consumer = geo["registers"]
    launch = (65536 // geo["threads"]) & ~7
    assert 128 * producer + (geo["threads"] - 128) * consumer <= geo["threads"] * launch
    covered = np.zeros(n, np.int64)
    for block, groups in enumerate(geo["warpgroups"]):
        assert 1 <= len(groups) <= geo["rows"] // geo["tile"]
        for start, rows in groups:
            assert rows == geo["tile"] and start % geo["tile"] == 0
            assert block * geo["rows"] <= start and start + rows <= (block + 1) * geo["rows"]
            assert start + rows <= n
            covered[start:start + rows] += 1
    np.testing.assert_array_equal(covered, 1)
    # rows go out in units of 64: the last block has the warpgroups whose rows
    # lie inside the sample, every other block all of them
    assert len(geo["warpgroups"][-1]) == (n // 64 - 1) % per_block + 1
    assert all(len(wg) == per_block for wg in geo["warpgroups"][:-1])
    assert geo["stages"] >= 2 and geo["shared_bytes"] <= tta.SHARED_LIMIT
    tm = geo["tensor_map"]
    # a [64, d] tile is d / 64 boxes of 64 columns (128 bytes, the widest the
    # 128-byte swizzle takes), one after the other in shared memory
    assert tm["dims"] == (d, h, n, b) and tm["box"] == (64, 1, geo["tile"], 1)
    assert tm["panels"] == tuple(range(0, d, 64))
    assert tm["strides"] == (2 * d, h * 2 * d, n * h * 2 * d)
    assert all(stride % 16 == 0 for stride in tm["strides"])
    assert tm == tta.backward_geometry(b, n, h, d)["tensor_map"]


@pytest.mark.parametrize("d, shared, own, ring", [(64, 91312, 24576, 65536),
                                                  (128, 230536, 32768, 196608)])
def test_forward_geometry_shared_bytes_add_up(d, shared, own, ring):
    geo = tta.forward_geometry(1, 4096, 16, d)
    tile = geo["tile"] * d * 2
    assert (geo["rows"] // geo["tile"]) * tile == own   # the block's Q tiles
    # a K and a V tile of key_tile keys a stage (at d = 128 three stages of
    # [128, 128] tiles, each panel 128 rows: two TMA boxes)
    assert geo["stages"] * 2 * geo["key_tile"] * d * 2 == ring
    # full and empty for K and for V apart, K's rotated one; q, q_ready
    barriers = 8 * (5 * geo["stages"] + 2)
    assert geo["shared_bytes"] == 1024 + own + ring + barriers == shared
    # every tile (and each of its panels) starts on a 1024-byte boundary
    # (eight rows: one swizzle atom)
    assert own % 1024 == 0 and tile % 1024 == 0 and (64 * 128) % 1024 == 0


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
def test_swizzled_offset_is_a_bijection_that_keeps_pairs_together(d):
    offsets = np.array([[tta.swizzled_offset(r, c, d) for c in range(d)] for r in range(64)])
    # every bf16 element of the 64 d * 2-byte tile exactly once
    assert sorted(offsets.ravel().tolist()) == list(range(0, 64 * d * 2, 2))
    # panel p (columns 64 p ..) is the p-th 8192 bytes
    assert np.array_equal(offsets // 8192, np.broadcast_to(np.arange(d) // 64, (64, d)))
    offsets = offsets % 8192
    # a row stays in its own 128 bytes of a panel; its 16-byte chunks are
    # permuted by row % 8
    assert np.array_equal(offsets // 128, np.repeat(np.arange(64)[:, None], d, axis=1))
    chunk = (offsets % 128) // 16
    assert np.array_equal(chunk, (np.arange(d)[None, :] % 64 // 8) ^ (np.arange(64)[:, None] % 8))
    # an interleaved pair (2 i, 2 i + 1) is 4 contiguous, 4-byte aligned bytes
    assert np.array_equal(offsets[:, 1::2], offsets[:, 0::2] + 2)
    assert not (offsets[:, 0::2] % 4).any()
    # eight consecutive columns from a multiple of 8 are one contiguous chunk
    per_row = d // 8
    assert np.array_equal(
        offsets.reshape(64, per_row, 8) - offsets.reshape(64, per_row, 8)[:, :, :1],
        np.broadcast_to(2 * np.arange(8), (64, per_row, 8)))


@pytest.mark.parametrize("d, least, most", [(64, 5, 6), (128, 10, 11)])
def test_rotating_threads_cover_a_tile_once(d, least, most):
    per_row = d // 8
    taken = np.zeros((64, per_row), np.int64)
    for rid in range(tta.FWD_ROTATORS):
        chunks = tta.rotator_chunks(rid, d)
        assert least <= len(chunks) <= most
        for row, chunk in chunks:
            taken[row, chunk] += 1
    np.testing.assert_array_equal(taken, 1)
    # a warp's 32 threads take 32 consecutive chunks: whole table rows
    first = [tta.rotator_chunks(rid, d)[0] for rid in range(32)]
    assert first == [(i // per_row, i % per_row) for i in range(32)]


def _fe_rounding() -> str:
    """This thread's floating-point rounding mode, as libm's ``fegetround``
    reports it (for the report below; "unknown" where libm cannot be read)."""
    try:
        import ctypes
        import ctypes.util

        mode = ctypes.CDLL(ctypes.util.find_library("m")).fegetround()
    except (OSError, AttributeError, TypeError):
        return "unknown"
    return {0: "to nearest", 0x400: "downward", 0x800: "upward",
            0xC00: "toward zero"}.get(mode, hex(mode))


@contextlib.contextmanager
def _one_thread():
    """torch's CPU ops on this thread alone. Its ``cos`` runs in chunks of
    2048 elements across the OpenMP threads, and once gave a [64, 64] table
    whose second chunk (rows 32-63, a pool thread's) was 1.5e-4 off float64
    while a fresh call was exact: the 34-element miss that the report below
    named. On one thread every table comes from the same thread's call."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _files_run_before(request) -> list[str]:
    """The test files of which this process (an xdist worker, or the single
    pytest process) has run a test before this one. pytest sets a test's
    ``_request`` to False once it has run (`_pytest/runner.py`)."""
    ran = []
    for item in request.session.items:
        if item is request.node:
            continue
        name = item.nodeid.split("::")[0]
        if getattr(item, "_request", None) is False and name not in ran:
            ran.append(name)
    return ran


def _rotation_miss_report(request, x, rope, cos, sin, mirror32, got, want) -> str:
    """What a failing run of the rotation mirror must say about itself: the
    elements that differ with both sides' fp32 values before the bf16
    rounding, whether the tables the mirror used are what ``rope`` gives
    now, and the process's state (threads, CPU capability, rounding mode,
    the test files this worker ran before)."""
    plain32 = sa._rotate(x.float()[None, :, None, :], rope)[0, :, 0].numpy()
    fresh_cos, fresh_sin = rope.cos(), rope.sin()
    exact = np.asarray(rope, np.float64)
    rows, cols = np.nonzero(got != want)
    worker = getattr(request.config, "workerinput", {}).get("workerid", "main")
    lines = [f"{len(rows)} of {got.size} elements differ, in rows {rows.min()}-{rows.max()}; "
             "the first:"]
    for r, c in list(zip(rows, cols))[:8]:
        lines.append(f"  ({r}, {c}): mirror fp32 {mirror32[r, c]!r} -> {got[r, c]!r}, "
                     f"plain fp32 {plain32[r, c]!r} -> {want[r, c]!r}, "
                     f"cos {cos[r, c]!r} sin {sin[r, c]!r}")
    lines += [
        f"fp32 values equal before rounding: {np.array_equal(mirror32, plain32)} "
        f"(max |diff| {np.abs(mirror32 - plain32).max():.3e})",
        f"a fresh rope.cos() / rope.sin() equals the mirror's tables: "
        f"{np.array_equal(fresh_cos.numpy(), cos)} / {np.array_equal(fresh_sin.numpy(), sin)}; "
        f"the mirror's tables against float64: "
        f"{np.abs(cos - np.cos(exact)).max():.3e} / {np.abs(sin - np.sin(exact)).max():.3e}",
        f"torch threads {torch.get_num_threads()}, interop {torch.get_num_interop_threads()}, "
        f"CPU capability {torch.backends.cpu.get_cpu_capability()}, rounding "
        f"{_fe_rounding()}, default dtype {torch.get_default_dtype()}",
        f"module state: FWD_ROTATORS {tta.FWD_ROTATORS}, TILE {tta.TILE}, "
        f"swizzled_offset from {tta.swizzled_offset.__module__}, "
        f"_rotate from {sa._rotate.__module__}",
        f"worker {worker} ran before: {', '.join(_files_run_before(request)) or 'nothing'}",
    ]
    return "\n".join(lines)


@pytest.mark.parametrize("d", tta.HEAD_DIMS)
def test_rotating_a_swizzled_tile_in_place_is_the_plain_rotary(d, request):
    """The kernel's rotation, mirrored in numpy on a ``[64, d]`` tile laid
    out as TMA writes it (d / 64 swizzled panels): chunk by chunk through the
    swizzled map with the table entries of the chunk's logical (row,
    column), against the plain version's rotary on the row-major tile, both
    sides' tables computed on one thread (:func:`_one_thread`). On a miss
    the assertion says what both sides computed and in what state the
    process was (`_rotation_miss_report`)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, d)).astype(np.float32)).bfloat16()
    rope = rotary_freqs(256, d)[128:192]  # the tile of rows 128..191
    with _one_thread():
        cos, sin = rope.float().cos().numpy(), rope.float().sin().numpy()
        want = sa._rotate(x[None, :, None, :], rope)[0, :, 0].float().numpy()
    tile = np.zeros(64 * d, np.float32)  # one slot per 2 bytes
    for r in range(64):
        for c in range(d):
            tile[tta.swizzled_offset(r, c, d) // 2] = float(x[r, c])
    mirror32 = np.full((64, d), np.nan, np.float32)  # the mirror's fp32 values, row-major
    for rid in range(tta.FWD_ROTATORS):
        for row, chunk in tta.rotator_chunks(rid, d):
            at = tta.swizzled_offset(row, 8 * chunk, d) // 2
            v = tile[at:at + 8].copy()
            c8, s8 = cos[row, 8 * chunk:8 * chunk + 8], sin[row, 8 * chunk:8 * chunk + 8]
            y = np.empty(8, np.float32)
            y[0::2] = (v[0::2] * c8[0::2]).astype(np.float32) + (-v[1::2] * s8[0::2])
            y[1::2] = (v[1::2] * c8[1::2]).astype(np.float32) + (v[0::2] * s8[1::2])
            mirror32[row, 8 * chunk:8 * chunk + 8] = y
            tile[at:at + 8] = torch.from_numpy(y).bfloat16().float().numpy()
    got = np.array([[tile[tta.swizzled_offset(r, c, d) // 2] for c in range(d)]
                    for r in range(64)])
    report = ("" if np.array_equal(got, want) else
              _rotation_miss_report(request, x, rope, cos, sin, mirror32, got, want))
    np.testing.assert_array_equal(got, want, err_msg=report)


def test_rope_tables_are_made_once_per_angle_table():
    sa._TABLES.clear()
    rope = rotary_freqs(128, 64)
    cos, sin = sa.rope_tables(rope)
    assert cos.dtype == sin.dtype == torch.float32 and cos.is_contiguous()
    assert torch.equal(cos, rope.float().cos()) and torch.equal(sin, rope.float().sin())
    again = sa.rope_tables(rope)
    assert again[0] is cos and again[1] is sin and len(sa._TABLES) == 1
    # an equal table that is another tensor gets its own entry, and the cache
    # holds the angle table, so its identity cannot pass on to another
    other = rope.clone()
    assert sa.rope_tables(other)[0] is not cos and len(sa._TABLES) == 2
    assert sa._TABLES[id(rope)][0] is rope
    for _ in range(3 * sa._CACHE_SIZE):
        sa.rope_tables(rotary_freqs(64, 64))
    assert len(sa._TABLES) == sa._CACHE_SIZE
    sa._TABLES.clear()


def test_full_lens_vector_is_kept_per_shape():
    sa._FULL_LENS.clear()
    dev = torch.device("cpu")
    lens = sa._full_lens(3, 256, dev)
    assert lens.dtype == torch.int32 and lens.tolist() == [256, 256, 256]
    assert sa._full_lens(3, 256, dev) is lens and sa._full_lens(2, 256, dev) is not lens
    sa._FULL_LENS.clear()


def test_cpu_path_takes_the_plain_version_and_no_cache():
    sa._TABLES.clear()
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 2, 64)).astype(np.float32))
               for _ in range(3))
    rope, lens = rotary_freqs(64, 64), torch.tensor([64, 40])
    before = sa.serving_attention.launches
    got = sa.serving_attention(q, k, v, lens, rope)
    assert torch.equal(got, sa.serving_attention_reference(q, k, v, lens, rope))
    assert len(sa._TABLES) == 0 and sa.serving_attention.launches == before
    # the tables the kernel reads give the plain version's rotary bit for bit
    cos, sin = sa.rope_tables(rope)
    x32 = q.float()
    rot = torch.stack((-x32[..., 1::2], x32[..., 0::2]), -1).flatten(-2)
    assert torch.equal(x32 * cos[None, :, None, :] + rot * sin[None, :, None, :],
                       sa._rotate(q, rope))
    sa._TABLES.clear()


def _walk_key_tiles(q, k, v, length, d):
    """The forward core's walk for one head of one sample, in float64:
    ``forward_key_tiles``' tiles of K and V (rows past n read as zeros, as
    TMA fills a tile that hangs over n), an online softmax with base-2
    exponentials and the scale folded into the exponent (0 for a sample with
    no valid key, whose every logit is then 0), a masked tile's keys at or
    past the limit at -1e30 with weight 0; returns (O, LSE)."""
    n = q.shape[0]
    scale = 1.0 / math.sqrt(d)
    c = scale * math.log2(math.e) if length > 0 else 0.0
    lim = min(length, n) if length > 0 else n
    m = np.full(n, -1e30)
    l = np.zeros(n)
    o = np.zeros((n, d))
    for first, keys, masked in tta.forward_key_tiles(n, length, d):
        kt, vt = np.zeros((keys, d)), np.zeros((keys, d))
        inside = min(keys, n - first)
        kt[:inside], vt[:inside] = k[first:first + inside], v[first:first + inside]
        s = q @ kt.T
        valid = np.arange(first, first + keys) < lim
        if masked:
            s = np.where(valid[None], s, -1e30)
        m_new = np.maximum(m, s.max(axis=1))
        corr = np.exp2((m - m_new) * c)
        p = np.exp2(s * c - (m_new * c)[:, None])
        if masked:
            p = np.where(valid[None], p, 0.0)
        l = l * corr + p.sum(axis=1)
        o = o * corr[:, None] + p @ vt
        m = m_new
    return o / l[:, None], m * c * math.log(2.0) + np.log(l)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("n", [192, 320])
def test_forward_key_tile_schedule_in_float64_is_the_jax_attention(n, d):
    """The key-tile schedule of the forward core at d = 128 (128-key tiles:
    n = 192 and 320 end half-way through the last, which hangs 64 keys over
    n) and d = 256 (64-key tiles), walked in float64 (`_walk_key_tiles`) for
    samples whose keys end inside a tile, stop in the first tile, fill the
    sample, and have none, against the JAX package's dense attention
    (`dense_reference`, fp32 on the CPU) within 1e-5 of the output's scale,
    and its LSE against the log sum exp of the masked logits (log n for a
    sample with no valid key) within 1e-12."""
    h = 2
    lens = [n - 37, 70, n, 0]
    rng = np.random.default_rng(n + d)
    q, k, v = (rng.standard_normal((len(lens), n, h, d)) for _ in range(3))
    valid = np.arange(n)[None] < np.array(lens)[:, None]
    want = np.asarray(jta.dense_reference(*(jnp.asarray(x, jnp.float32) for x in (q, k, v)),
                                          key_valid=jnp.asarray(valid)), np.float64)
    for bi, length in enumerate(lens):
        for hi in range(h):
            out, lse = _walk_key_tiles(q[bi, :, hi], k[bi, :, hi], v[bi, :, hi], length, d)
            np.testing.assert_allclose(out, want[bi, :, hi], rtol=0,
                                       atol=1e-5 * np.abs(want).max())
            s = q[bi, :, hi] @ k[bi, :, hi].T / math.sqrt(d)
            if length > 0:
                s = s[:, :length]
            else:
                s = np.zeros_like(s)  # every key, logit 0: log n
            top = s.max(axis=1)
            exact = top + np.log(np.exp(s - top[:, None]).sum(axis=1))
            np.testing.assert_allclose(lse, exact, rtol=0, atol=1e-12)


@pytest.mark.parametrize("keep", [0.9, 0.5, 1e-4, 1.0])
def test_keep_bit_compare_without_the_last_shift_is_exact(keep):
    """`csrc/dropout_hash.cuh` `keep_bit_folded` tests the murmur3
    finaliser's last step y = x ^ (x >> 16) against the threshold as
    (x ^ (threshold >> 16)) < threshold: y keeps x's high half, so the two
    compares differ only where that half equals the threshold's, and there
    both low halves are x's xor the same 16 bits. Every x whose high half is
    the threshold's, and a seeded million others, give the same bit as
    `fmix32` then the compare."""
    threshold = tta.keep_threshold(keep)
    rng = np.random.default_rng(int(keep * 1e4))
    x = np.concatenate([rng.integers(0, 2**32, 1_000_000, dtype=np.uint64),
                        (threshold >> 16 << 16) + np.arange(2**16, dtype=np.uint64)])
    want = (x ^ (x >> 16)) < threshold
    np.testing.assert_array_equal((x ^ (threshold >> 16)) < threshold, want)
