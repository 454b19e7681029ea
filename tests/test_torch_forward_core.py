"""PyTorch port, the forward-attention core that the training forward and the
serving attention share (`csrc/flash_forward.cuh`): what of it is plain
Python beside the wrappers. The launch geometry for every n of the serving
attention's domain, 64 to 6144 (the MMDiT's joint sequence; training stops
at 4096) (each row owned by one warpgroup, the last block's warpgroups without rows
where n is no multiple of 192, the shared-memory sum within the card's limit, the tensor
map), the swizzled tile map through which the kernel rotates a tile in place
(a bijection that keeps every interleaved pair together), the rotating
threads' cover of a tile, and the cache of cos / sin tables in the serving
wrapper (one pair per angle table, the same output as without it, the CPU
path untouched). The kernels themselves run on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu_torch.ops import serving_attention as sa
from eraxvif5tts_tpu_torch.ops import train_attention as tta
from eraxvif5tts_tpu_torch.ops.rotary import rotary_freqs


@pytest.mark.parametrize("n", list(range(64, 6144 + 1, 64)))
def test_forward_geometry_covers_every_row_once_within_the_card(n):
    b, h = 3, 16
    geo = tta.forward_geometry(b, n, h)
    assert geo["grid"] == (len(geo["warpgroups"]), h, b) == (-(-n // 192), h, b)
    assert geo["threads"] == 128 * (geo["rows"] // geo["tile"] + 1)
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
    # lie inside the sample (one for n % 192 == 64, two for 128), every other
    # block all three
    assert len(geo["warpgroups"][-1]) == (n // 64 - 1) % 3 + 1
    assert all(len(groups) == 3 for groups in geo["warpgroups"][:-1])
    assert geo["stages"] >= 2 and geo["shared_bytes"] <= tta.SHARED_LIMIT
    tm = geo["tensor_map"]
    assert tm["dims"] == (64, h, n, b) and tm["box"] == (64, 1, geo["tile"], 1)
    assert tm["strides"] == (128, h * 128, n * h * 128)
    assert all(stride % 16 == 0 for stride in tm["strides"])
    assert tm == tta.backward_geometry(b, n, h)["tensor_map"]


def test_forward_geometry_shared_bytes_add_up():
    geo = tta.forward_geometry(1, 4096, 16)
    tile = geo["tile"] * 64 * 2
    own = (geo["rows"] // geo["tile"]) * tile           # the block's Q tiles
    ring = geo["stages"] * 2 * tile                     # a K and a V tile a stage
    barriers = 8 * (3 * geo["stages"] + 2)              # full, empty, ready; q, q_ready
    assert geo["shared_bytes"] == 1024 + own + ring + barriers == 91248
    assert (own, ring) == (24576, 65536)
    # every tile starts on a 1024-byte boundary (eight rows: one swizzle atom)
    assert own % 1024 == 0 and tile % 1024 == 0


def test_swizzled_offset_is_a_bijection_that_keeps_pairs_together():
    offsets = np.array([[tta.swizzled_offset(r, c) for c in range(64)] for r in range(64)])
    # every bf16 element of the 8192-byte tile exactly once
    assert sorted(offsets.ravel().tolist()) == list(range(0, 64 * 64 * 2, 2))
    # a row stays in its own 128 bytes; its 16-byte chunks are permuted by row % 8
    assert np.array_equal(offsets // 128, np.repeat(np.arange(64)[:, None], 64, axis=1))
    chunk = (offsets % 128) // 16
    assert np.array_equal(chunk, (np.arange(64)[None, :] // 8) ^ (np.arange(64)[:, None] % 8))
    # an interleaved pair (2 i, 2 i + 1) is 4 contiguous, 4-byte aligned bytes
    assert np.array_equal(offsets[:, 1::2], offsets[:, 0::2] + 2)
    assert not (offsets[:, 0::2] % 4).any()
    # eight consecutive columns from a multiple of 8 are one contiguous chunk
    assert np.array_equal(offsets.reshape(64, 8, 8) - offsets.reshape(64, 8, 8)[:, :, :1],
                          np.broadcast_to(2 * np.arange(8), (64, 8, 8)))


def test_rotating_threads_cover_a_tile_once():
    taken = np.zeros((64, 8), np.int64)
    for rid in range(tta.FWD_ROTATORS):
        chunks = tta.rotator_chunks(rid)
        assert 5 <= len(chunks) <= 6
        for row, chunk in chunks:
            taken[row, chunk] += 1
    np.testing.assert_array_equal(taken, 1)
    # a warp's 32 threads take 32 consecutive chunks: four whole table rows
    first = [tta.rotator_chunks(rid)[0] for rid in range(32)]
    assert first == [(i // 8, i % 8) for i in range(32)]


def test_rotating_a_swizzled_tile_in_place_is_the_plain_rotary():
    """The kernel's rotation, mirrored in numpy on a tile laid out as TMA
    writes it: chunk by chunk through the swizzled map with the table entries
    of the chunk's logical (row, column), against the plain version's rotary
    on the row-major tile."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)).bfloat16()
    rope = rotary_freqs(256, 64)[128:192]  # the tile of rows 128..191
    cos, sin = rope.float().cos().numpy(), rope.float().sin().numpy()
    want = sa._rotate(x[None, :, None, :], rope)[0, :, 0].float().numpy()
    tile = np.zeros(64 * 64, np.float32)  # one slot per 2 bytes
    for r in range(64):
        for c in range(64):
            tile[tta.swizzled_offset(r, c) // 2] = float(x[r, c])
    for rid in range(tta.FWD_ROTATORS):
        for row, chunk in tta.rotator_chunks(rid):
            at = tta.swizzled_offset(row, 8 * chunk) // 2
            v = tile[at:at + 8].copy()
            c8, s8 = cos[row, 8 * chunk:8 * chunk + 8], sin[row, 8 * chunk:8 * chunk + 8]
            y = np.empty(8, np.float32)
            y[0::2] = (v[0::2] * c8[0::2]).astype(np.float32) + (-v[1::2] * s8[0::2])
            y[1::2] = (v[1::2] * c8[1::2]).astype(np.float32) + (v[0::2] * s8[1::2])
            tile[at:at + 8] = torch.from_numpy(y).bfloat16().float().numpy()
    got = np.array([[tile[tta.swizzled_offset(r, c) // 2] for c in range(64)]
                    for r in range(64)])
    np.testing.assert_array_equal(got, want)


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
