"""The GEMM core of the port's fused projections (`csrc/wgmma_gemm.cuh`), as
far as a CPU can hold it: the launch geometry that `ops/fused_matmul.py`
states in Python (tiles, the persistent blocks' walk, shared memory, tensor
maps), numpy mirrors of the address and fragment maps its threads use (the
swizzled-tile-to-A-fragment read of the normalising path, the accumulator
fragment and the quad exchange of the epilogue), the wrappers' domain checks,
and the CPU path. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from eraxvif5tts_tpu_torch.ops import fused_matmul as fm
from eraxvif5tts_tpu_torch.ops import train_attention as tta

# every (K, N) a preset gives kernel 2 (dim, dim * ff_mult) and kernel 3
# (dim * ff_mult, dim): configs/*.yaml, dim 768 / 1024, ff_mult 2 / 4
KERNEL2_SHAPES = [(768, 1536), (768, 3072), (1024, 2048), (1024, 4096)]
KERNEL3_SHAPES = [(1536, 768), (3072, 768), (2048, 1024), (4096, 1024)]
ROWS = list(range(1, 261)) + [767, 768, 1088, 4096]


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("k,n", KERNEL2_SHAPES + KERNEL3_SHAPES + [(64, 128), (128, 384)])
def test_gemm_geometry_owns_every_output_tile_once(b, k, n):
    for m in ROWS:
        geo = fm.gemm_geometry(b, m, k, n)
        rows, cols = geo["tile"]
        assert rows == 128 and cols == 128 * geo["nacc"] and n % cols == 0
        tiles = geo["tiles"]
        # each (column panel, batch row, row tile) once: a tile has one batch
        # row, the row tiles cover [0, m) and only the last hangs over it
        assert len(set(tiles)) == len(tiles)
        tiles_m = -(-m // rows)
        assert set(tiles) == {(ni, bi, mi) for ni in range(n // cols) for bi in range(b)
                              for mi in range(tiles_m)}
        assert (tiles_m - 1) * rows < m <= tiles_m * rows
        # one weight panel's tiles are neighbours in the walk
        assert [t[0] for t in tiles] == sorted(t[0] for t in tiles)
        # the persistent blocks partition the walk, none idle, none beyond the card
        grid = geo["grid"]
        assert 1 <= grid <= fm.SMS and grid == min(len(tiles), fm.SMS)
        walked = [t for block in range(grid) for t in tiles[block::grid]]
        assert sorted(walked) == sorted(tiles)
        assert geo["waves"] == max(len(tiles[block::grid]) for block in range(grid))
        # the warpgroups split the tile's rows
        assert geo["warpgroups"] == [(0, 64), (64, 64)]
        assert geo["threads"] == 128 * (len(geo["warpgroups"]) + 1)
        assert geo["shared_bytes"] <= fm.SMEM_LIMIT


@pytest.mark.parametrize("b,m,k,n", [(2, 767, 1024, 2048), (16, 768, 1024, 4096),
                                     (3, 1, 768, 1536), (2, 1088, 2048, 1024)])
def test_gemm_tensor_maps_match_the_tensors(b, m, k, n):
    geo = fm.gemm_geometry(b, m, k, n)
    a = torch.empty((b, m, k), dtype=torch.bfloat16, device="meta")
    w = torch.empty((n, k), dtype=torch.bfloat16, device="meta")
    for tensor, tmap in ((a, geo["a_map"]), (w, geo["w_map"])):
        # innermost dimension first; strides in bytes, the innermost's left out
        assert tmap["dims"] == tuple(reversed(tensor.shape))
        assert tmap["strides"] == tuple(2 * s for s in reversed(tensor.stride()[:-1]))
        assert all(s % 16 == 0 for s in tmap["strides"])
        assert tmap["box"][0] * 2 == 128  # one swizzled row
        assert all(1 <= edge <= 256 for edge in tmap["box"])
    # M is a dimension of its own and a box is one batch row deep: a tile that
    # hangs over M reads zeros, never the next batch row
    assert geo["a_map"]["dims"][1] == m and geo["a_map"]["box"] == (64, 128, 1)
    # a stage is A's box and two of W's; the ring, the two scale / shift
    # buffers and the barriers add up to the shared bytes
    stage = 2 * (np.prod(geo["a_map"]["box"]) + 2 * np.prod(geo["w_map"]["box"]))
    assert stage == 49152 and stage % 1024 == 0
    assert geo["shared_bytes"] == (1024 + geo["stages"] * stage + 2 * 2 * fm.GEMM_MAX_NORM_K * 2
                                   + (2 * geo["stages"] + 4) * 8)
    assert geo["stages"] >= 3 and geo["k_tile"] == 64


@pytest.mark.parametrize("b,m,n,nacc,waves", [
    (2, 768, 2048, 2, 1),     # 96 tiles of 128 x 256: one wave on 73 % of the SMs
    (2, 1088, 2048, 1, 3),    # 288 tiles of 128 x 128: 3 waves, not 2 of twice the width
    (16, 768, 2048, 2, 6),    # 768 tiles: 5.8 waves
    (2, 768, 4096, 1, 3),     # 384 narrow tiles: 3 waves against 2 x 2
    (16, 768, 4096, 2, 12),
    (2, 1088, 1024, 2, 1),    # kernel 3 at the DiT's FF output: 72 tiles
    (1, 1, 384, 1, 1),        # N no multiple of 256
])
def test_gemm_tile_width_follows_the_waves(b, m, n, nacc, waves):
    geo = fm.gemm_geometry(b, m, 1024, n)
    assert (geo["nacc"], geo["waves"]) == (nacc, waves)
    # never more wave-columns than the other width would take
    other = 3 - nacc
    if n % (128 * other) == 0:
        cost = lambda a: -(-(b * -(-m // 128) * (n // (128 * a))) // fm.SMS) * a
        assert cost(nacc) <= cost(other)


@pytest.mark.parametrize("k,n", [(96, 128), (64, 192), (0, 128), (64, 0)])
def test_gemm_geometry_refuses_shapes_outside_the_domain(k, n):
    with pytest.raises(ValueError):
        fm.gemm_geometry(2, 16, k, n)


def test_swizzled_offset_is_a_bijection_over_an_a_tile():
    # the map the attention tiles use, over the 128 rows of a stage's A tile
    assert fm.swizzled_offset is tta.swizzled_offset
    offsets = {fm.swizzled_offset(r, c) for r in range(128) for c in range(64)}
    assert len(offsets) == 128 * 64 and max(offsets) == 128 * 128 - 2


def _swizzled_tile(rows: int) -> np.ndarray:
    """A [rows, 64] tile as TMA writes it, as 16-bit words: element (r, c)
    holds r * 64 + c."""
    words = np.full(rows * 64, -1, dtype=np.int64)
    for r in range(rows):
        for c in range(64):
            words[fm.swizzled_offset(r, c) // 2] = r * 64 + c
    assert (words >= 0).all()
    return words


def test_a_fragment_read_is_a_bijection_onto_the_tile():
    """`ldmatrix.x4` through the swizzled addresses hands every thread the
    wgmma A fragment of its rows, and the warpgroup reads each element of its
    [64, 64] x tile exactly once a stage."""
    words = _swizzled_tile(64)
    seen = np.zeros((64, 64), dtype=int)
    for warp in range(4):
        for kk in range(4):
            addresses = [fm.a_fragment_reads(warp, lane, kk)[0] for lane in range(32)]
            assert all(a % 16 == 0 and 0 <= a < 64 * 128 for a in addresses)
            assert len(set(addresses)) == 32
            for j in range(4):  # the eight rows of a matrix lie in eight different bank groups
                assert len({(a // 16) % 8 for a in addresses[8 * j:8 * j + 8]}) == 8
            for lane in range(32):
                g, t = divmod(lane, 4)
                received = fm.a_fragment_reads(warp, lane, kk)[1]
                # the wgmma A fragment: (g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
                assert received == [(16 * warp + g, 16 * kk + 2 * t),
                                    (16 * warp + g + 8, 16 * kk + 2 * t),
                                    (16 * warp + g, 16 * kk + 2 * t + 8),
                                    (16 * warp + g + 8, 16 * kk + 2 * t + 8)]
                for j, (row, col) in enumerate(received):
                    # what the hardware delivers: row lane // 4 of matrix j, whose
                    # address lane 8 j + lane // 4 gave, the pair at byte 4 (lane % 4)
                    at = addresses[8 * j + lane // 4] + 4 * t
                    assert list(words[at // 2:at // 2 + 2]) == [row * 64 + col, row * 64 + col + 1]
                    seen[row, col:col + 2] += 1
    assert (seen == 1).all()


def test_accumulator_fragment_is_a_bijection():
    seen = np.zeros((64, 128), dtype=int)
    for warp in range(4):
        for lane in range(32):
            for i in range(64):
                seen[fm.accumulator_element(warp, lane, i)] += 1
    assert (seen == 1).all()


def test_quad_exchange_hands_each_lane_one_column_group():
    values = [[(t, c) for c in range(4)] for t in range(4)]
    assert fm.quad_transpose(values) == [[(i, t) for i in range(4)] for t in range(4)]


@pytest.mark.parametrize("nacc", [1, 2])
def test_epilogue_stores_every_element_once_in_16_byte_rows(nacc):
    """The epilogue's walk over a tile, mirrored: each thread's registers are
    exchanged inside its quad, and every (row, column) of the 128 x 128 nacc
    tile is stored exactly once, 8 neighbouring columns a store."""
    seen = np.zeros((128, 128 * nacc), dtype=int)
    for group, (row0, rows) in enumerate(fm.gemm_geometry(2, 768, 1024, 256 * nacc)["warpgroups"]):
        assert rows == 64 and row0 == 64 * group
        for acc in range(nacc):
            for warp in range(4):
                # registers of the warp's lanes, named by the element they hold
                regs = [[fm.accumulator_element(warp, lane, i) for i in range(64)]
                        for lane in range(32)]
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    chunks = fm.epilogue_chunks(warp, lane)
                    assert len(chunks) == 8
                    for row, col0, sources in chunks:
                        cb, r = col0 // 32, (row - 16 * warp) // 8
                        assert col0 % 8 == 0 and col0 == 32 * cb + 8 * t
                        # the kernel's loop: for e, gather q[c], exchange, v[2 i + e] = q[i]
                        v = [None] * 8
                        for e in range(2):
                            quad = [[regs[4 * g + lane_t][4 * (4 * cb + c) + 2 * r + e]
                                     for c in range(4)] for lane_t in range(4)]
                            for i, value in enumerate(fm.quad_transpose(quad)[t]):
                                v[2 * i + e] = value
                        assert v == [(row, col0 + j) for j in range(8)]
                        assert v == [regs[src_lane][src_reg] for src_lane, src_reg in sources]
                        seen[row0 + row, 128 * acc + col0:128 * acc + col0 + 8] += 1
    assert (seen == 1).all()


def _ln_args(b=2, m=5, k=128, n=256, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    make = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return [make(b, m, k), 0.1 * make(b, k), 0.1 * make(b, k), make(n, k) / 8, 0.1 * make(n)]


def _gate_args(b=2, m=5, k=128, n=256, dtype=torch.bfloat16, seed=1):
    rng = np.random.default_rng(seed)
    make = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return [make(b, m, k), make(n, k) / 8, 0.1 * make(n), make(b, n), make(b, m, n),
            torch.tensor([m, m - 2][:b], dtype=torch.int32)]


def _break_ln(case: str):
    args = _ln_args()
    if case == "K=96":
        args = _ln_args(k=96)
    elif case == "N=192":
        args = _ln_args(n=192)
    elif case == "K=4096":
        args = _ln_args(k=4096, n=128)
    elif case == "fp32":
        args = _ln_args(dtype=torch.float32)
    elif case == "non-contiguous x":
        args[0] = _ln_args(m=10)[0][:, ::2]
    elif case == "misaligned x":
        args[0] = torch.zeros(2 * 5 * 128 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 128)
    elif case == "misaligned weight":
        args[3] = torch.zeros(256 * 128 + 1, dtype=torch.bfloat16)[1:].view(256, 128)
    elif case == "scale of another batch":
        args[1] = args[1][:1]
    elif case == "no rows":
        args[0] = args[0][:, :0]
    return args


@pytest.mark.parametrize("case", ["K=96", "N=192", "K=4096", "fp32", "non-contiguous x",
                                  "misaligned x", "misaligned weight",
                                  "scale of another batch", "no rows"])
def test_ln_mod_matmul_domain_check_raises_and_counts_nothing(case):
    before = (fm.ln_mod_matmul.launches, dict(fm.ln_mod_matmul.launches_by_norm))
    with pytest.raises((ValueError, TypeError)):
        fm._check_cuda_args(*_break_ln(case), "gelu_tanh", "ln", 1e-6)
    assert (fm.ln_mod_matmul.launches, fm.ln_mod_matmul.launches_by_norm) == before


@pytest.mark.parametrize("activation,norm,eps", [("relu", "ln", 1e-6), ("gelu_tanh", "layer", 1e-6),
                                                 ("gelu_tanh", "rms", 0.0)])
def test_ln_mod_matmul_domain_check_refuses_unknown_modes(activation, norm, eps):
    with pytest.raises(ValueError):
        fm._check_cuda_args(*_ln_args(), activation, norm, eps)


def test_ln_mod_matmul_domain_check_accepts_the_presets_shapes():
    for k, n in KERNEL2_SHAPES:
        fm._check_cuda_args(*_ln_args(m=3, k=k, n=n), "gelu_tanh", "ln", 1e-6)
        fm._check_cuda_args(*_ln_args(m=3, k=k, n=n), None, "rms", 1e-12)
    for k, n in KERNEL3_SHAPES:
        args = _gate_args(m=3, k=k, n=n)
        fm._check_gate_res_args(*args, True)
        fm._check_gate_res_args(*args[:5], None, False)


def _break_gate(case: str):
    args = _gate_args()
    if case == "K=96":
        args = _gate_args(k=96)
    elif case == "N=192":
        args = _gate_args(n=192)
    elif case == "fp32":
        args = _gate_args(dtype=torch.float32)
    elif case == "non-contiguous h":
        args[0] = _gate_args(m=10)[0][:, ::2]
    elif case == "misaligned res":
        args[4] = torch.zeros(2 * 5 * 256 + 1, dtype=torch.bfloat16)[1:].view(2, 5, 256)
    elif case == "lens missing":
        args[5] = None
    elif case == "lens int64":
        args[5] = args[5].long()
    return args


@pytest.mark.parametrize("case", ["K=96", "N=192", "fp32", "non-contiguous h", "misaligned res",
                                  "lens missing", "lens int64"])
def test_matmul_gate_res_domain_check_raises_and_counts_nothing(case):
    before = fm.matmul_gate_res.launches
    with pytest.raises((ValueError, TypeError)):
        fm._check_gate_res_args(*_break_gate(case), True)
    assert fm.matmul_gate_res.launches == before


@pytest.mark.parametrize("norm", ["ln", "rms"])
@pytest.mark.parametrize("activation", ["gelu_tanh", None])
def test_ln_mod_matmul_on_cpu_is_the_plain_version_bit_for_bit(norm, activation):
    args = _ln_args(m=7, seed=3)
    before = fm.ln_mod_matmul.launches
    got = fm.ln_mod_matmul(*args, activation=activation, norm=norm)
    assert torch.equal(got, fm.ln_mod_matmul_reference(*args, activation=activation, norm=norm))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 7, 256)
    assert fm.ln_mod_matmul.launches == before


def test_rms_mode_all_zero_row_is_the_activation_of_the_bias():
    args = _ln_args(m=4, seed=5)
    args[0][1, 2] = 0.0
    args[2] = torch.zeros_like(args[2])
    got = fm.ln_mod_matmul(*args, norm="rms")
    want = torch.nn.functional.gelu(args[4].float(), approximate="tanh").bfloat16()
    assert torch.equal(got[1, 2], want)


@pytest.mark.parametrize("mask_rows", [True, False])
def test_matmul_gate_res_on_cpu_is_the_plain_version_bit_for_bit(mask_rows):
    args = _gate_args(m=6, seed=4)
    before = fm.matmul_gate_res.launches
    got = fm.matmul_gate_res(*args, mask_rows)
    assert torch.equal(got, fm.matmul_gate_res_reference(*args, mask_rows))
    if mask_rows:  # rows at or past lens are the residual
        assert torch.equal(got[1, 4:], args[4][1, 4:])
    assert fm.matmul_gate_res.launches == before
