"""The float32 head-dim-512 backward on a cluster of four blocks
(flash_bwd_d512_sm90.cu's emox_flash_bwd_d512_f32) and the cluster forward
above head dim 512 (flash_fwd_wide.cu's cluster_fwd_kernel), on the CPU.

Neither kernel runs here; what they rely on is checked:

  * the launch plans (`bwd_d512_plan(half=128, parts=2, cluster=4)`,
    `wide_plan`'s "fwd"): every query row (forward, dq) and key (dk, dv),
    each head-dim column, owned by exactly one block; a block's shared
    memory within the H100's 227 KB; the cluster at most the portable 8 and
    dividing grid x;
  * the order of the partial sums: the four ranks' two rounds of the pair's
    exchange, and the cluster forward's rank-ordered sum over its slots,
    give the same bits of S in every rank;
  * a numpy twin of the split backward at d 512 (the four 128-column
    partials combined as the kernels combine them) against fp64, within the
    float32 bar;
  * stand-in C entries with the new signatures, which read the tensors at
    the pointers they are given, check the split scratch and the lse
    padding, write the split as the split launch does and compute with the
    kernels' decomposition, through the port's wrappers against the
    reference's Pallas kernels in interpret mode: float32 d 300 and 512
    (forward and gradients) and d 576 and 640 (forward), ragged.
"""

from __future__ import annotations

import contextlib
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from emox.ops import attention as jattn
from emox_torch import ops
from emox_torch.ops import attention as tattn
from emox_torch.ops import build
from tests.test_torch_f32_sm90 import H100_HELD, _parts, _product, _view
from tests.test_torch_ops import BF16_TOL, j, rel, t

SMEM_PER_BLOCK = 232448  # bytes a block may have on the H100 (227 KB)
MAX_CLUSTER = 8  # the portable cluster size
SMS = 132  # the H100 SXM's SMs, which the wrappers read from the card
F32_BAR = 2e-4  # float32 against the reference: of the largest output value (chip_smoke.py's bar)
LOG2E = math.log2(math.e)
SLICE = 128  # head-dim columns a block owns in both kernels


def _owned(grid, per_tile: int, rows: int, n: int, h: int, length: int, d: int) -> np.ndarray:
    """How many blocks own each (sample, head, row, column) of an
    [n, h, length, d] output: block (x, y, z) owns rows
    [rows (x // per_tile), + rows) below length and columns
    [128 (x % per_tile), + 128) below d."""
    gx, gy, gz = grid
    assert (gy, gz) == (h, n) and gx % per_tile == 0
    count = np.zeros((n, h, length, d), np.int32)
    for x in range(gx):
        r0, c0 = rows * (x // per_tile), SLICE * (x % per_tile)
        count[:, :, r0:min(r0 + rows, length), c0:min(c0 + SLICE, d)] += 1
    return count


# ---- the launch plans ---------------------------------------------------------------------
BWD_SHAPES = [(1, 1, 1024, 1024), (2, 1, 2304, 2304), (2, 2, 1000, 2100), (2, 2, 70, 45)]


@pytest.mark.parametrize("n,h,lq,lk", BWD_SHAPES, ids=["f32-step-1024", "2x2304", "ragged-1000", "ragged-70"])
def test_f32_d512_backward_plan_covers_every_row_and_column_once(n, h, lq, lk):
    """The float32 d-512 backward's dq and dk/dv launches at the float32
    stage-5 step's shape (one 256^2 image), at N 2 x 2304 and ragged: a
    cluster of four blocks of 128 columns a 64-row tile, every query row
    (dq) and key (dk, dv) and each of the 512 columns written by exactly
    one block, grid x a multiple of the cluster, shared memory within 227 KB
    (two barriers a block more than the float32 pair at half width); the
    64-row query tiles never read past lse's padding to 64 rows."""
    plan = tattn.bwd_d512_plan(n, h, lq, lk, half=128, parts=2, cluster=4)
    assert plan["cluster"] == 4 <= MAX_CLUSTER and plan["half"] * plan["cluster"] == 512 and plan["parts"] == 2
    pair = tattn.bwd_d512_plan(n, h, lq, lk, half=128, parts=2)
    for name, length in (("dq", lq), ("dkv", lk)):
        launch = plan[name]
        assert launch["smem"] <= SMEM_PER_BLOCK and launch["smem"] - pair[name]["smem"] == 16, name
        assert (_owned(launch["grid"], 4, launch["rows"], n, h, length, 512) == 1).all(), name
    lq_pad = -(-lq // 64) * 64
    assert lq_pad % plan["dkv"]["tile"] == 0


FWD_SHAPES = [(1, 1, 1024, 1024, 640), (1, 1, 4096, 4096, 640), (2, 1, 2304, 2304, 576),
              (2, 2, 1000, 2100, 1024), (1, 2, 70, 45, 576), (1, 1, 1000, 1100, 768), (1, 1, 130, 64, 2304)]


def _forward_writes(fwd, n, h, lq, d) -> np.ndarray:
    """How many blocks of the forward write each (sample, head, row, column):
    block x of rank r = x % cluster owns rows [64 (x // cluster), + 64) and
    columns [cols (r % slices), + cols), and writes them if its key part
    r // slices is 0."""
    gx, gy, gz = fwd["grid"]
    per, slices, cols = fwd["cluster"], fwd["slices"], fwd["slice_cols"]
    if per == 1:  # the slice kernel: a block per (row tile, slice)
        per = slices
    assert (gy, gz) == (h, n) and gx % per == 0
    count = np.zeros((n, h, lq, d), np.int32)
    for x in range(gx):
        r = x % per
        if r // slices == 0:
            r0, c0 = fwd["rows"] * (x // per), cols * (r % slices)
            count[:, :, r0:min(r0 + fwd["rows"], lq), c0:min(c0 + cols, d)] += 1
    return count


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("n,h,lq,lk,d", FWD_SHAPES, ids=["d640-f32-step", "d640-4096", "d576-2x2304",
                                                        "d1024-ragged", "d576-small", "d768-split", "d2304"])
def test_wide_forward_plan_fits_and_covers_every_row_and_column_once(n, h, lq, lk, d, parts):
    """wide_plan's forward: a cluster per 64-row tile of the fewest slices
    (2 to 8) whose width (bf16 4 or 5 64-column chunks, float32 3 or 4)
    fits with the deepest (K, V) rings; the keys split in two parts where
    the doubled grid still fits one wave of 132 SMs (the float32 step's
    N 1 x 1024 at d 640: 3 slices of 256 columns, 2 key parts, 96 blocks;
    bf16 at N 1 x 4096: 2 slices of 320, 128 blocks, each warpgroup taking
    whole tiles wherever that fits); above the cluster's
    reach (d 2304) the slice kernel. Every query row and each head-dim column
    written by exactly one block (key part 0's), the cluster at most 8 and
    dividing grid x, shared memory within 227 KB, the float32 scratch as
    wide as the slices."""
    plan = tattn.wide_plan(n, h, lq, lk, d, parts, SMS)
    fwd = plan["fwd"]
    assert fwd["grid"][0] % fwd["cluster"] == 0 and fwd["smem"] <= SMEM_PER_BLOCK
    assert fwd["cluster"] <= MAX_CLUSTER and fwd["width"] == fwd["slices"] * fwd["slice_cols"] >= d
    assert (_forward_writes(fwd, n, h, lq, d) == 1).all()
    if d == 2304:
        assert fwd["cluster"] == 1 and fwd["slice_cols"] == SLICE
        return
    ch, pp = fwd["slice_cols"] // 64, fwd["whole_tiles"]
    rings = [(2, 2), (1, 2), (2, 1), (1, 1)]
    assert ch in ((4, 5) if parts == 1 else (3, 4)) and fwd["cluster"] == fwd["slices"] * fwd["key_parts"]
    assert fwd["smem"] == tattn._cluster_fwd_smem(parts, ch, fwd["slices"], *fwd["stages"], pp)
    deeper = rings[:rings.index(fwd["stages"])]
    assert all(tattn._cluster_fwd_smem(parts, ch, fwd["slices"], *o, pp) > SMEM_PER_BLOCK for o in deeper)
    assert pp == 0 if parts == 2 else pp == 1 or all(
        tattn._cluster_fwd_smem(parts, ch, fwd["slices"], *o, 1) > SMEM_PER_BLOCK for o in rings if o[1] == 2)
    assert not pp or fwd["stages"][1] == 2
    if fwd["key_parts"] == 2:  # the rings hold warpgroup 1's O and the other part's at the end
        assert sum(fwd["stages"]) * parts >= 4 and fwd["grid"][0] * h * n <= 132
    want = {(640, 1, 1024): (3, 256, 2), (640, 1, 4096): (2, 320, 1)}.get((d, n, lq))
    if want and parts == 2 - (lq == 4096):
        assert (fwd["slices"], fwd["slice_cols"], fwd["key_parts"]) == want


def _cluster_fwd_fits(parts, d, key_tiles, cs, ch, ck, kst, vst, pp) -> bool:
    """flash_fwd_wide.cu's cluster_fwd_fits: the plans the kernel takes."""
    chunks, lo = -(-d // 64), 4 if parts == 1 else 3
    return (2 <= cs and ck in (1, 2) and cs * ck <= MAX_CLUSTER and lo <= ch <= lo + 1
            and cs * ch >= chunks > (cs - 1) * ch and 0 <= pp <= (parts == 1) and not (pp and vst < 2)
            and kst in (1, 2) and vst in (1, 2) and not (ck == 2 and ((kst + vst) * parts < 4 or key_tiles < 2))
            and tattn._cluster_fwd_smem(parts, ch, cs, kst, vst, pp) <= SMEM_PER_BLOCK)


PLAN_GRIDS = [(1, 1, 1024, 1024), (1, 1, 4096, 4096), (2, 1, 2304, 2304), (1, 2, 70, 45), (1, 1, 64, 64)]


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("n,h,lq,lk", PLAN_GRIDS, ids=["1024", "4096", "2x2304", "ragged", "one-tile"])
def test_every_cluster_plan_is_one_the_kernel_takes(n, h, lq, lk, parts):
    """The wrapper hands the kernel wide_plan's forward (cluster_fwd_args),
    which the kernel only checks: at every head dim above 512 (multiples
    of 8) the plan is the slice kernel's (cs 0) or passes the kernel's
    check, and the float32 scratch is as wide as the kernel's w."""
    for d in range(520, 2400, 8):
        fwd = tattn.wide_plan(n, h, lq, lk, d, parts, SMS)["fwd"]
        args = tattn.cluster_fwd_args(fwd)
        if fwd["cluster"] == 1:
            assert args == (0,) * 6 and fwd["width"] == -(-d // SLICE) * SLICE, d
            continue
        assert _cluster_fwd_fits(parts, d, -(-lk // 64), *args), (d, args)
        assert fwd["width"] == args[0] * 64 * args[1] and fwd["cluster"] == args[0] * args[2], d


def test_issued_bound_counts_the_cluster_forwards_products():
    """chip_smoke.py's issued products of the wide forward: the cluster's S
    once and P v over the slices' width, three bf16 products each in
    float32 (N 1 x 1024, d 640: 3 slices of 256 columns), one in bf16
    (N 1 x 4096: 2 slices of 320); the slice kernel 2 (d / 128 + 1)
    units (d 2304)."""
    unit = lambda l: 2.0 * l * l
    flops = lambda *a: chip_smoke._issued_flops("flash_fwd_wide", *a, sms=SMS)
    assert flops(torch.float32, 1, 1, 1024, 1024, 640) == unit(1024) * 2 * 768 * 3
    assert flops(torch.bfloat16, 1, 1, 4096, 4096, 640) == unit(4096) * 2 * 640
    assert flops(torch.bfloat16, 1, 1, 256, 256, 2304) == unit(256) * (18 * 2304 + 2304)


ROUTE_DIMS = [(1, 2240, True), (1, 2304, False), (2, 1152, True), (2, 1216, False)]


@pytest.mark.parametrize("parts,d,cluster", ROUTE_DIMS, ids=[f"p{p}-d{d}" for p, d, _ in ROUTE_DIMS])
def test_wide_forward_route_by_head_dim(parts, d, cluster):
    """The forward's route by shape: the cluster kernel up to d 2240 in bf16
    and 1152 in float32, the slice kernel above (as _fwd_views states)."""
    fwd = tattn.wide_plan(1, 1, 1000, 1000, d, parts, SMS)["fwd"]
    assert (fwd["cluster"] > 1) == cluster


def _cluster_bwd_fits(parts, d, q_tiles, k_tiles, cs, half, stages, dq_parts, dkv_parts) -> bool:
    """flash_bwd_wide_sm90.cu's cluster_bwd_fits (the plans the kernels take),
    and the instance's shared memory within 227 KB (checked where it is
    compiled)."""
    inst = ((192, 2), (256, 2), (320, 1)) if parts == 1 else ((128, 2), (192, 1))
    if (half, stages) not in inst or cs not in (2, 4, 8) or cs * half < d:
        return False
    for split, streamed in ((dq_parts, k_tiles), (dkv_parts, q_tiles)):
        if split not in (1, 2) or cs * split > MAX_CLUSTER or (split == 2 and streamed < 2):
            return False
    return max(tattn._bwd_cluster_smem(half, parts, stages, 0)) <= SMEM_PER_BLOCK


def _splits(cs: int, q_tiles: int, k_tiles: int, h: int, n: int) -> bool:
    """The plan's rule for two parts of the streamed dimension: dq's and
    dk/dv's clusters run side by side, so in two parts (clusters of 2 cs
    blocks, each half the work) they take fewer waves of what the H100 holds
    at once than in one (a tie keeps one part: the merge costs)."""
    if 2 * cs > MAX_CLUSTER:
        return False
    clusters = (q_tiles + k_tiles) * h * n
    return -(-clusters // H100_HELD[2 * cs]) / 2 < -(-clusters // H100_HELD[cs])


BWD_DIMS = [576, 600, 640, 768, 1024, 1280, 2048, 2304]
BWD_GRIDS = [(1, 1, 1024, 1024), (1, 1, 4096, 4096), (2, 2, 1000, 2100), (1, 2, 70, 45), (1, 1, 64, 64)]
BWD_REACH = {1: 2048, 2: 1536}  # the widest head dim of a cluster plan: eight slices of 256 / 192


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("n,h,lq,lk", BWD_GRIDS, ids=["f32-step-1024", "4096", "ragged-2x1000", "ragged-70",
                                                       "one-tile"])
@pytest.mark.parametrize("d", BWD_DIMS)
def test_wide_backward_plan_fits_and_covers_every_row_and_column_once(n, h, lq, lk, d, parts):
    """wide_plan's backward: within the clusters' reach (bf16 2048, float32
    1536) the first cluster of BWD_CLUSTERS whose slices cover d, a plan the
    kernels' check takes; the streamed dimension in two parts where both
    parts have tiles and the two kernels' clusters, side by side, take
    fewer waves of what the H100 holds at once (the float32 step's N 1 x 1024
    at d 640: four slices of 192 in two parts, 2 x 128 blocks in 1.5 waves
    against 2; bf16 at N 1 x 4096: a pair of 320, one part, 2 x 128 blocks);
    beyond the reach the slice kernels. Every query row (dq) and key (dk,
    dv) and each head-dim column written by exactly one block (of part 0),
    the cluster at most 8 and dividing grid x, shared memory within 227 KB,
    the float32 scratch as wide as the slices."""
    plan = tattn.wide_plan(n, h, lq, lk, d, parts, SMS, lambda half, stages, cluster: H100_HELD[cluster])
    args = tattn.cluster_bwd_args(plan)
    q_tiles, k_tiles = -(-lq // 64), -(-lk // 64)
    for name, length, streamed in (("dq", lq, k_tiles), ("dkv", lk, q_tiles)):
        launch = plan[name]
        assert launch["grid"][0] % launch["cluster"] == 0 and launch["cluster"] <= MAX_CLUSTER, name
        assert launch["smem"] <= SMEM_PER_BLOCK and launch["width"] == launch["slices"] * launch["slice_cols"] >= d
        assert (_forward_writes(launch, n, h, length, d) == 1).all(), name
        if args:
            split = launch["stream_parts"] == 2
            assert split == (streamed >= 2 and _splits(launch["slices"], q_tiles, k_tiles, h, n)), name
            assert launch["smem"] == tattn._bwd_cluster_smem(launch["slice_cols"], parts, launch["stages"], 0)[
                name == "dkv"]
    if d > BWD_REACH[parts]:
        assert args == () and plan["dq"]["cluster"] == 1 and plan["dq"]["width"] == -(-d // SLICE) * SLICE
        return
    assert _cluster_bwd_fits(parts, d, q_tiles, k_tiles, *args), args
    cs, half, stages = args[:3]
    first = next(c for c in tattn.BWD_CLUSTERS[parts] if c[0] * c[1] >= d)
    assert (cs, half, stages) == first and plan["dq"]["width"] == plan["dkv"]["width"] == cs * half
    want = {(2, 640, 1024): (4, 192, 1, 2, 2), (1, 640, 4096): (2, 320, 1, 1, 1), (1, 640, 70): (2, 320, 1, 1, 2),
            (2, 640, 70): (4, 192, 1, 1, 2)}.get((parts, d, lq))
    if want:
        assert args == want


@pytest.mark.parametrize("parts", [1, 2], ids=["bf16", "float32"])
@pytest.mark.parametrize("n,h,lq,lk", PLAN_GRIDS, ids=["1024", "4096", "2x2304", "ragged", "one-tile"])
def test_every_backward_plan_is_one_the_kernel_takes(n, h, lq, lk, parts):
    """The wrapper hands emox_flash_bwd_wide_sm90 wide_plan's backward
    (cluster_bwd_args), which the kernel only checks: at every head dim
    above 512 (multiples of 8) up to the reach it passes the kernel's check;
    past it the slice kernels take the head dim (no plan)."""
    for d in range(520, 2400, 8):
        plan = tattn.wide_plan(n, h, lq, lk, d, parts, SMS, lambda half, stages, cluster: H100_HELD[cluster])
        args = tattn.cluster_bwd_args(plan)
        assert bool(args) == (d <= BWD_REACH[parts]), d
        if args:
            assert _cluster_bwd_fits(parts, d, -(-lq // 64), -(-lk // 64), *args), (d, args)
            assert plan["dq"]["width"] == args[0] * args[1], d


def test_issued_bound_counts_the_cluster_backwards_products():
    """chip_smoke.py's issued products of the cluster backward: S and dP
    once in each kernel, 7 units over the slices' width, three bf16 products
    each in float32: at N 1 x 1024, d 640, four slices of 192 (768
    columns), 0.0342 ms at 989 TFLOP/s; bf16 at N 1 x 4096, a pair of 320;
    the slice kernels 2 (4 d / 128 + 3) units (d 2304)."""
    unit = lambda l: 2.0 * l * l
    flops = lambda *a: chip_smoke._issued_flops("flash_bwd_wide", *a, sms=SMS)
    assert flops(torch.float32, 1, 1, 1024, 1024, 640) == unit(1024) * 7 * 768 * 3
    assert round(flops(torch.float32, 1, 1, 1024, 1024, 640) / 989e12 * 1e3, 4) == 0.0342
    assert flops(torch.bfloat16, 1, 1, 4096, 4096, 640) == unit(4096) * 7 * 640
    assert flops(torch.bfloat16, 1, 1, 256, 256, 2304) == unit(256) * (2 * 18 * 2304 * 2 + 3 * 2304)


# ---- the order of the partial sums ------------------------------------------------------------
def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def _slice_partials(q: np.ndarray, k: np.ndarray, slices: int):
    """The fp32 partials of q k^T over each block's 128 columns."""
    return [q[:, SLICE * r:SLICE * (r + 1)] @ k[:, SLICE * r:SLICE * (r + 1)].T for r in range(slices)]


def _fp32_bound(q, k, s):
    full = q.astype(np.float64) @ k.T.astype(np.float64)
    bound = q.shape[1] * np.finfo(np.float32).eps * (np.abs(q).astype(np.float64) @ np.abs(k).T.astype(np.float64))
    return (np.abs(s - full) <= bound).all()


def test_four_ranks_two_rounds_give_the_same_bits_in_every_rank():
    """A numpy twin of the float32 d-512 backward's exchange: rank r adds
    its partner's partial to its own (round 1: p_r + p_{r^1}), then the far
    pair's round-1 sum (round 2, from rank r ^ 2, which computed
    p_{r^2} + p_{r^3}). Every rank ends with the same bits: rank 0 holds
    (p0 + p1) + (p2 + p3), rank 3 (p3 + p2) + (p1 + p0), equal because IEEE
    addition is commutative; the dk/dv kernel's warpgroup 1, which reads
    P^T back as 0 + slot, keeps them. Within fp32 rounding of the fp64
    product."""
    rng = np.random.default_rng(4)
    q, k = (_bf16(rng.standard_normal((64, 512)).astype(np.float32) * 3) for _ in range(2))
    p = _slice_partials(q, k, 4)
    round1 = [p[r] + p[r ^ 1] for r in range(4)]
    held = [round1[r] + round1[r ^ 2] for r in range(4)]
    assert all(x.dtype == np.float32 for x in held)
    for r in range(1, 4):
        assert np.array_equal(held[r].view(np.uint32), held[0].view(np.uint32)), r
    assert np.array_equal((np.float32(0) + held[1]).view(np.uint32), held[0].view(np.uint32))
    assert _fp32_bound(q, k, held[0])


@pytest.mark.parametrize("cluster", [5, 8])
def test_cluster_forward_sums_in_rank_order_in_every_rank(cluster):
    """A numpy twin of the cluster forward's exchange at C blocks: block x
    writes its partial into its own slot x, then bulk-copies it into slot x
    of every other block; every block then adds its slots in rank order,
    p_0 + p_1 + ... + p_{C-1}. Every slot of every block is written once,
    by the right block, and every block holds the same bits, within fp32
    rounding of the full product."""
    rng = np.random.default_rng(cluster)
    d = SLICE * cluster
    q, k = (_bf16(rng.standard_normal((64, d)).astype(np.float32)) for _ in range(2))
    p = _slice_partials(q, k, cluster)
    slots = [[None] * cluster for _ in range(cluster)]
    for x in range(cluster):
        for r in range(cluster):  # r == x: its own slot, the source of the copies
            assert slots[r][x] is None
            slots[r][x] = p[x]
    held = []
    for rank in range(cluster):
        acc = slots[rank][0]
        for r in range(1, cluster):
            acc = acc + slots[rank][r]
        held.append(acc)
    for rank in range(cluster):
        assert np.array_equal(held[rank].view(np.uint32), held[0].view(np.uint32)), rank
    assert _fp32_bound(q, k, held[0])


def test_eight_ranks_three_rounds_give_the_same_bits_in_every_rank():
    """The cluster backward's exchange at eight slices (of 192 columns, d up
    to 1536): rank r adds the partial of rank r ^ 1, then the sum held by
    rank r ^ 2, then that of rank r ^ 4 (three rounds, each into the same
    slot). Every rank ends with the bits of
    ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)), within fp32 rounding
    of the fp64 product."""
    rng = np.random.default_rng(8)
    cols = 192
    q, k = (_bf16(rng.standard_normal((64, 8 * cols)).astype(np.float32) * 3) for _ in range(2))
    p = [q[:, cols * r:cols * (r + 1)] @ k[:, cols * r:cols * (r + 1)].T for r in range(8)]
    held = list(p)
    for rnd in range(3):
        held = [held[x] + held[x ^ (1 << rnd)] for x in range(8)]
    tree = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]))
    assert all(x.dtype == np.float32 for x in held)
    for r in range(8):
        assert np.array_equal(held[r].view(np.uint32), tree.view(np.uint32)), r
    assert _fp32_bound(q, k, tree)


def test_split_merge_gives_the_same_bits_whichever_part_merges():
    """The two parts of the streamed dimension (here dq's keys): each part's
    two warpgroups accumulate dS K over their keys of its 64-key tiles
    (warpgroup w keys 32w..32w+31), warpgroup 1's sum is added to warpgroup
    0's, and part 1's result to part 0's. Merging part 0 into part 1 gives
    the same bits (a + b == b + a), within fp32 rounding of fp64."""
    rng = np.random.default_rng(11)
    lk, cols = 5 * 64 + 17, 192
    ds = _bf16(rng.standard_normal((64, lk)).astype(np.float32))
    k = _bf16(rng.standard_normal((lk, cols)).astype(np.float32))
    tiles = -(-lk // 64)
    per = -(-tiles // 2)

    def part(t0, t1):
        acc = [np.zeros((64, cols), np.float32) for _ in range(2)]
        for j in range(t0, t1):
            for w in range(2):
                keys = slice(64 * j + 32 * w, min(64 * j + 32 * w + 32, lk))
                acc[w] = acc[w] + ds[:, keys] @ k[keys]
        return acc[0] + acc[1]

    a, b = part(0, per), part(per, tiles)
    assert a.dtype == b.dtype == np.float32
    assert np.array_equal((a + b).view(np.uint32), (b + a).view(np.uint32))
    full = ds.astype(np.float64) @ k.astype(np.float64)
    bound = lk * np.finfo(np.float32).eps * (np.abs(ds).astype(np.float64) @ np.abs(k).astype(np.float64))
    assert (np.abs(a + b - full) <= bound).all()


# ---- the split backward at d 512 ------------------------------------------------------------
def _split(x: np.ndarray):
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _f32(a, b):
    """a b over the two parts: a_hi b_hi + a_hi b_lo + a_lo b_hi, fp32."""
    return (a[0] @ b[0] + a[0] @ b[1] + a[1] @ b[0]).astype(np.float32)


def _cluster4(a, b):
    """a b^T over the head dim as the four blocks sum it (the two rounds)."""
    p = [_f32([x[:, SLICE * r:SLICE * (r + 1)] for x in a], [x[:, SLICE * r:SLICE * (r + 1)].T for x in b])
         for r in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


@pytest.mark.parametrize("lk", [1024, 1000], ids=["aligned", "ragged"])
def test_f32_split_backward_meets_the_float32_bar(lk):
    """A numpy twin of the float32 d-512 backward at L 1024 against fp64:
    S and dP from the four ranks' partials on the two-part split, P from the
    forward's lse (base 2, as the kernels), dS = P (dP - delta), P and dS
    split as the register operand; dq, dk and dv within 2e-4 of their
    largest value."""
    rng = np.random.default_rng(lk)
    L, d = 1024, 512
    q = rng.standard_normal((L, d)).astype(np.float32)
    k, v = (rng.standard_normal((lk, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((L, d)).astype(np.float32)
    scale = d ** -0.5
    q64, k64, v64, g64 = (x.astype(np.float64) for x in (q, k, v, g))
    s64 = q64 @ k64.T * scale
    lse64 = np.log(np.exp(s64 - s64.max(axis=1, keepdims=True)).sum(axis=1)) + s64.max(axis=1)
    p64 = np.exp(s64 - lse64[:, None])
    o64 = p64 @ v64
    delta = (g64 * o64).sum(axis=1)
    ds64 = p64 * (g64 @ v64.T - delta[:, None])
    truth = {"dq": ds64 @ k64 * scale, "dk": ds64.T @ q64 * scale, "dv": p64.T @ g64}

    qp, kp, vp, gp = (_split(x) for x in (q, k, v, g))
    lse, dl = lse64.astype(np.float32), delta.astype(np.float32)
    p = np.exp2(_cluster4(qp, kp) * np.float32(scale * LOG2E) - lse[:, None] * np.float32(LOG2E)).astype(np.float32)
    ds = (p * (_cluster4(gp, vp) - dl[:, None])).astype(np.float32)
    got = {"dq": _f32(_split(ds), kp) * np.float32(scale), "dk": _f32(_split(ds.T), qp) * np.float32(scale),
           "dv": _f32(_split(p.T), gp)}
    for name, want in truth.items():
        assert np.abs(got[name] - want).max() <= F32_BAR * np.abs(want).max(), name


def _butterfly(a, b, slices: int, cols: int):
    """a b^T over the head dim as a cluster of `slices` blocks of `cols`
    columns sums it (log2(slices) rounds, rank 0's order), on float32 parts."""
    p = [_f32([x[:, cols * r:cols * (r + 1)] for x in a], [x[:, cols * r:cols * (r + 1)].T for x in b])
         for r in range(slices)]
    for rnd in range(int(math.log2(slices))):
        p = [p[x] + p[x ^ (1 << rnd)] for x in range(slices)]
    return p[0]


@pytest.mark.parametrize("lk", [1024, 1000], ids=["aligned", "ragged"])
def test_f32_cluster_backward_at_d640_meets_the_float32_bar(lk):
    """A numpy twin of the float32 cluster backward at d 640 (the width-640
    VAE's stage-5 step, L 1024) against fp64: q, k, v and dO split into
    parts zero-padded to 768 columns, S and dP from four 192-column slices'
    partials summed in two butterfly rounds, P from the forward's lse (base
    2), dS = P (dP - delta), P and dS split in registers as the A operand;
    each kernel's streamed tiles in two parts, their sums added; dq, dk and
    dv within 2e-4 of their largest value."""
    rng = np.random.default_rng(lk + 640)
    L, d, w = 1024, 640, 768
    q = rng.standard_normal((L, d)).astype(np.float32)
    k, v = (rng.standard_normal((lk, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((L, d)).astype(np.float32)
    scale = d ** -0.5
    q64, k64, v64, g64 = (x.astype(np.float64) for x in (q, k, v, g))
    s64 = q64 @ k64.T * scale
    lse64 = np.log(np.exp(s64 - s64.max(axis=1, keepdims=True)).sum(axis=1)) + s64.max(axis=1)
    p64 = np.exp(s64 - lse64[:, None])
    delta = (g64 * (p64 @ v64)).sum(axis=1)
    ds64 = p64 * (g64 @ v64.T - delta[:, None])
    truth = {"dq": ds64 @ k64 * scale, "dk": ds64.T @ q64 * scale, "dv": p64.T @ g64}

    pad = lambda x: np.pad(x, ((0, 0), (0, w - d)))
    qp, kp, vp, gp = (_split(pad(x)) for x in (q, k, v, g))
    lse, dl = lse64.astype(np.float32), delta.astype(np.float32)
    p = np.exp2(_butterfly(qp, kp, 4, 192) * np.float32(scale * LOG2E) - lse[:, None] * np.float32(LOG2E))
    p = p.astype(np.float32)
    ds = (p * (_butterfly(gp, vp, 4, 192) - dl[:, None])).astype(np.float32)

    def halves(a, b, n):
        """a b over n rows of the depth, in two parts of 64-row tiles, summed."""
        cut = -(-(-(-n // 64)) // 2) * 64
        return _f32(_split(a[:, :cut]), [x[:cut] for x in b]) + _f32(_split(a[:, cut:]), [x[cut:] for x in b])

    got = {"dq": halves(ds, kp, lk) * np.float32(scale), "dk": halves(ds.T, qp, L) * np.float32(scale),
           "dv": halves(p.T, gp, L)}
    for name, want in truth.items():
        assert np.abs(got[name][:, :d] - want).max() <= F32_BAR * np.abs(want).max(), name
        assert not got[name][:, d:].any(), name


# ---- stand-in C entries through the wrappers ------------------------------------------------
def _cluster_forward(qp, kp, vp, fwd: dict, scale: float):
    """The cluster forward's arithmetic on [B, H, L, w] parts (w the plan's
    width): S summed over the slices' partials in slice order, each key
    part's softmax in base 2 with P rounded to the operand parts, the parts
    merged as split-K flash attention does; lse in base e."""
    cols = fwd["slice_cols"]
    sl = lambda xs, r: [x[..., cols * r:cols * (r + 1)] for x in xs]
    s = None
    for r in range(fwd["slices"]):
        part = _product(sl(qp, r), [x.transpose(-1, -2) for x in sl(kp, r)])
        s = part if s is None else s + part
    s = s * (scale * LOG2E)
    lk = s.shape[-1]
    tiles = -(-lk // 64)
    per = -(-tiles // fwd["key_parts"]) * 64
    o = m = l = None
    for k0 in range(0, lk, per):
        sk = s[..., k0:k0 + per]
        mk = sk.amax(dim=-1, keepdim=True)
        p = torch.exp2(sk - mk)
        ok, lk_ = _product(_parts(p, len(qp)), [x[..., k0:k0 + per, :] for x in vp]), p.sum(dim=-1, keepdim=True)
        if o is None:
            o, m, l = ok, mk, lk_
        else:
            mm = torch.maximum(m, mk)
            o = o * torch.exp2(m - mm) + ok * torch.exp2(mk - mm)
            l = l * torch.exp2(m - mm) + lk_ * torch.exp2(mk - mm)
            m = mm
    return o / l, (m[..., 0] + torch.log2(l[..., 0])) * math.log(2)


def _split_forward(qp, kp, vp, scale: float):
    """flash_fwd_d512_f32's arithmetic: the pair's two 256-column partials."""
    cols = lambda xs, c0: [x[..., c0:c0 + 256] for x in xs]
    s = sum(_product(cols(qp, c0), [x.transpose(-1, -2) for x in cols(kp, c0)]) for c0 in (0, 256))
    s = s * (scale * LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return _product(_parts(p, 2), vp) / l, (m[..., 0] + torch.log2(l[..., 0])) * math.log(2)


def _cluster4_t(a, b):
    """a b^T over 512 columns as the four blocks sum it, on [B, H, L, 512] parts."""
    cols = lambda xs, r: [x[..., SLICE * r:SLICE * (r + 1)] for x in xs]
    p = [_product(cols(a, r), [x.transpose(-1, -2) for x in cols(b, r)]) for r in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def _butterfly_t(a, b, slices: int, cols: int):
    """a b^T over the head dim as a cluster of `slices` blocks of `cols`
    columns sums it (butterfly rounds), on [B, H, L, w] parts."""
    sl = lambda xs, r: [x[..., cols * r:cols * (r + 1)] for x in xs]
    p = [_product(sl(a, r), [x.transpose(-1, -2) for x in sl(b, r)]) for r in range(slices)]
    for rnd in range(int(math.log2(slices))):
        p = [p[x] + p[x ^ (1 << rnd)] for x in range(slices)]
    return p[0]


@pytest.fixture
def entries(monkeypatch):
    """build.kernel hands out stand-in C entries for the d-512 float32 pair,
    the wide forward and the cluster backward; `_split_scratch` records what
    it allocates; the plans read 132 SMs. Yields the calls."""
    calls, scratch = [], []
    real_scratch = tattn._split_scratch

    def recording_scratch(w, *tensors):
        out = real_scratch(w, *tensors)
        scratch.extend(out)
        return out

    def operand(ptr, st, b, h, length, d, dtype):
        return _view(ptr, (b, h, length, d), (st[0], st[1], st[2], 1), dtype)

    def split_into(x, ptr, w):
        """The split launch: x's parts into the scratch the wrapper allocated
        ([B, H, L, 2w] bf16, hi | lo, zero past d)."""
        b, h, length, d = x.shape
        assert d <= w and any(s.data_ptr() == ptr and s.shape == (b, h, length, 2 * w) for s in scratch), (ptr, w)
        buf = _view(ptr, (b, h, length, 2 * w), (h * length * 2 * w, length * 2 * w, 2 * w, 1), torch.bfloat16)
        hi, lo = _parts(x, 2)
        buf.zero_()
        buf[..., :d] = hi.to(torch.bfloat16)
        buf[..., w:w + d] = lo.to(torch.bfloat16)
        return buf[..., :w].float(), buf[..., w:].float()

    def write_forward(o, lse, st, b, h, lq, d, dt, out, lse_v):
        _view(o, (b, h, lq, d), (st[9], st[10], st[11], 1), dt).copy_(out[..., :d])
        _view(lse, (b, h, lq), (st[12], st[13], st[14]), torch.float32).copy_(lse_v)

    def fwd_d512_f32(q, k, v, o, lse, st, b, h, lq, lk, scale, q2, k2, v2, stream):
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, 512, torch.float32)
              for i, (p, n) in enumerate(((q, lq), (k, lk), (v, lk)))]
        qp, kp, vp = (split_into(x, p, 512) for x, p in zip(xs, (q2, k2, v2)))
        write_forward(o, lse, st, b, h, lq, 512, torch.float32, *_split_forward(qp, kp, vp, scale))
        calls.append("fwd_d512_f32")
        return 0

    def fwd_wide(q, k, v, o, lse, st, b, h, lq, lk, d, scale, dtype, cs, ch, ck, kst, vst, pp, q2, k2, v2, stream):
        """The kernel's arithmetic on the plan it is handed, which must be
        one the kernel's check takes."""
        assert _cluster_fwd_fits(2 - dtype, d, -(-lk // 64), cs, ch, ck, kst, vst, pp)
        fwd = {"slices": cs, "slice_cols": 64 * ch, "key_parts": ck, "width": cs * 64 * ch}
        dt = torch.bfloat16 if dtype == 1 else torch.float32
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, d, dt) for i, (p, n) in enumerate(((q, lq), (k, lk), (v, lk)))]
        w = fwd["width"]
        if dtype == 0:
            parts = [split_into(x, p, w) for x, p in zip(xs, (q2, k2, v2))]
        else:
            assert q2 is None and k2 is None and v2 is None
            parts = [(torch.nn.functional.pad(x.float(), (0, w - d)),) for x in xs]  # TMA's zero fill past d
        write_forward(o, lse, st, b, h, lq, d, dt, *_cluster_forward(*parts, fwd, scale))
        calls.append(("fwd_wide", dt, d))
        return 0

    def bwd_d512_f32(q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, scale, q2, k2, v2, do2, stream):
        assert lq_pad % 64 == 0 and lq <= lq_pad < lq + 64 and (dk is None) == (dv is None)
        lens = (lq, lk, lk, lq)
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, 512, torch.float32)
              for i, (p, n) in enumerate(zip((q, k, v, g), lens))]
        qp, kp, vp, gp = (split_into(x, p, 512) for x, p in zip(xs, (q2, k2, v2, do2)))
        flat = lambda p: _view(p, (b, h, lq_pad), (h * lq_pad, lq_pad, 1), torch.float32)
        lse_v, delta_v = flat(lse), flat(delta)
        assert torch.isposinf(lse_v[..., lq:]).all() and not delta_v[..., lq:].any()
        tr = lambda xp: [x.transpose(-1, -2) for x in xp]
        p = torch.exp2(_cluster4_t(qp, kp) * (scale * LOG2E) - lse_v[..., :lq, None] * LOG2E)
        ds = p * (_cluster4_t(gp, vp) - delta_v[..., :lq, None])
        grads = (_product(_parts(ds, 2), kp) * scale, _product(_parts(ds.transpose(-1, -2), 2), qp) * scale,
                 _product(_parts(p.transpose(-1, -2), 2), gp))
        for i, (ptr, grad) in enumerate(zip((dq, dk, dv), grads)):
            if ptr is not None:
                n = lq if i == 0 else lk
                _view(ptr, (b, h, n, 512), tuple(st[12 + 3 * i:15 + 3 * i]) + (1,), torch.float32).copy_(grad)
        calls.append(("bwd_d512_f32", dq is not None, dk is not None))
        return 0

    def bwd_wide_sm90(q, k, v, g, lse, delta, dq, dk, dv, st, b, h, lq, lk, lq_pad, d, scale, dtype, cs, half,
                      stages, dq_parts, dkv_parts, q2, k2, v2, do2, stream):
        """The cluster backward's arithmetic on the plan it is handed, which
        must be one the kernels' check takes: the slices' S and dP partials
        summed in butterfly rounds, P and dS rounded to the operand parts,
        each kernel's streamed tiles in its parts, the parts' sums added."""
        assert _cluster_bwd_fits(2 - dtype, d, -(-lq // 64), -(-lk // 64), cs, half, stages, dq_parts, dkv_parts)
        assert lq_pad % 64 == 0 and lq <= lq_pad < lq + 64 and (dk is None) == (dv is None)
        dt = torch.bfloat16 if dtype == 1 else torch.float32
        xs = [operand(p, st[3 * i:3 * i + 3], b, h, n, d, dt)
              for i, (p, n) in enumerate(zip((q, k, v, g), (lq, lk, lk, lq)))]
        w = cs * half
        if dtype == 0:
            qp, kp, vp, gp = (split_into(x, p, w) for x, p in zip(xs, (q2, k2, v2, do2)))
        else:
            assert q2 is None and k2 is None and v2 is None and do2 is None
            qp, kp, vp, gp = ((torch.nn.functional.pad(x.float(), (0, w - d)),) for x in xs)  # TMA's zero fill
        flat = lambda p: _view(p, (b, h, lq_pad), (h * lq_pad, lq_pad, 1), torch.float32)
        lse_v, delta_v = flat(lse), flat(delta)
        assert torch.isposinf(lse_v[..., lq:]).all() and not delta_v[..., lq:].any()
        p = torch.exp2(_butterfly_t(qp, kp, cs, half) * (scale * LOG2E) - lse_v[..., :lq, None] * LOG2E)
        ds = p * (_butterfly_t(gp, vp, cs, half) - delta_v[..., :lq, None])

        def streamed(a, bp, n, split):
            """a b over the n rows of the depth, in `split` parts of 64-row tiles, summed in part order."""
            cut = -(-(-(-n // 64)) // split) * 64
            out = None
            for r0 in range(0, n, cut):
                part = _product(_parts(a[..., r0:r0 + cut], len(qp)), [x[..., r0:r0 + cut, :] for x in bp])
                out = part if out is None else out + part
            return out

        grads = (streamed(ds, kp, lk, dq_parts) * scale, streamed(ds.transpose(-1, -2), qp, lq, dkv_parts) * scale,
                 streamed(p.transpose(-1, -2), gp, lq, dkv_parts))
        for i, (ptr, grad) in enumerate(zip((dq, dk, dv), grads)):
            if ptr is not None:
                n = lq if i == 0 else lk
                _view(ptr, (b, h, n, d), tuple(st[12 + 3 * i:15 + 3 * i]) + (1,), dt).copy_(grad[..., :d])
        calls.append(("bwd_wide_sm90", dt, d, dq is not None, dk is not None, (cs, half, stages, dq_parts, dkv_parts)))
        return 0

    c_entries = {"emox_flash_fwd_d512_f32": fwd_d512_f32, "emox_flash_fwd_wide": fwd_wide,
                 "emox_flash_bwd_d512_f32": bwd_d512_f32, "emox_flash_bwd_wide_sm90": bwd_wide_sm90}

    def kernel(name, fn_name=""):
        fn_name = fn_name or next(iter(build.KERNELS[name]))
        assert fn_name in c_entries and fn_name in build.KERNELS[name], (name, fn_name)
        assert len(build.KERNELS[name][fn_name]) == c_entries[fn_name].__code__.co_argcount
        return c_entries[fn_name]

    monkeypatch.setattr(build, "kernel", kernel)
    monkeypatch.setattr(tattn, "_split_scratch", recording_scratch)
    monkeypatch.setattr(tattn, "_on_card_or_cpu", lambda name, x: True)
    monkeypatch.setattr(tattn, "_stream", lambda x: 0)
    monkeypatch.setattr(tattn, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(tattn, "_clusters_held", lambda index, parts, half, stages, cluster: H100_HELD[cluster])
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    yield calls
    ops.reset_launch_counts()


F32_CASES = [("packed", 512), ("strided", 300), ("packed", 640), ("strided", 576)]


@pytest.mark.parametrize("layout,d", F32_CASES, ids=[f"{a}-d{b}" for a, b in F32_CASES])
def test_stand_in_entries_match_the_reference(entries, layout, d):
    """float32 through the port's wrappers on their card path, the C
    entries replaced by stand-ins that compute with the kernels'
    decomposition from the split they write: at d 300 (padded to 512) and
    512 the forward and the gradients of q, k and v (flash_fwd_d512_f32,
    then flash_bwd_d512_f32 on the cluster of four), at d 576 and 640 the
    cluster forward (its keys split in two parts); ragged Lq 70
    and Lk 130 against 64-row tiles. Each
    against the reference's kernels and gradients in interpret mode, within
    2e-4 of its largest value; lse within 1e-3."""
    rng = np.random.default_rng(d)
    heads, lq, lk = 2, 70, 130
    if layout == "packed":
        n = 1
        q, k, v, g = (rng.standard_normal((n, l, heads * d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention_nlc(a, b, c, heads, interpret=True)
        port = lambda a, b, c: tattn.flash_attention_nlc(a, b, c, heads, return_lse=True)
        want_lse = tattn.attention_nlc_plain(t(q), t(k), t(v), heads, d ** -0.5)[1]
    else:
        n = 1
        q, k, v, g = (rng.standard_normal((n, heads, l, d)).astype(np.float32) for l in (lq, lk, lk, lq))
        ref = lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True)
        port = lambda a, b, c: tattn.flash_attention(a, b, c, return_lse=True)
        want_lse = tattn.attention_plain(t(q), t(k), t(v), d ** -0.5)[1]
    want = np.asarray(ref(j(q), j(k), j(v)))
    grads = d <= 512
    tq, tk, tv = (t(x).requires_grad_(grads) for x in (q, k, v))
    out, lse = port(tq, tk, tv)
    assert out.shape == tq.shape and np.abs(out.detach().numpy() - want).max() <= F32_BAR * np.abs(want).max()
    assert (lse - want_lse).abs().max() <= 1e-3
    if not grads:
        assert entries == [("fwd_wide", torch.float32, d)]
        assert tattn.wide_plan(n, heads, lq, lk, d, 2, SMS)["fwd"]["key_parts"] == 2
        return
    out.backward(t(g))
    assert entries == ["fwd_d512_f32", ("bwd_d512_f32", True, True)]
    want_grads = jax.grad(lambda a, b, c: jnp.sum(ref(a, b, c) * j(g)), argnums=(0, 1, 2))(j(q), j(k), j(v))
    for name, got, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want_grads):
        w = np.asarray(w)
        assert got.shape == w.shape and np.abs(got.numpy() - w).max() <= F32_BAR * np.abs(w).max(), name


@pytest.mark.parametrize("layout,d", [("packed", 640), ("strided", 576)], ids=["packed-d640", "strided-d576"])
def test_bf16_cluster_forward_stand_in_matches_the_plain_version(entries, layout, d):
    """bf16 at d 576 and 640 reaches the cluster forward on the caller's
    operands (no scratch; the columns past d arrive as zeros), its output
    within two bf16 steps of the plain version, lse within 1e-3."""
    rng = np.random.default_rng(d + 1)
    heads, lq, lk = 2, 70, 130
    if layout == "packed":
        q, k, v = (t(rng.standard_normal((1, l, heads * d)).astype(np.float32), torch.bfloat16) for l in (lq, lk, lk))
        out, lse = tattn.flash_attention_nlc(q, k, v, heads, return_lse=True)
        want, want_lse = tattn.attention_nlc_plain(q, k, v, heads, d ** -0.5)
    else:
        q, k, v = (t(rng.standard_normal((1, heads, l, d)).astype(np.float32), torch.bfloat16) for l in (lq, lk, lk))
        out, lse = tattn.flash_attention(q, k, v, return_lse=True)
        want, want_lse = tattn.attention_plain(q, k, v, d ** -0.5)
    assert entries == [("fwd_wide", torch.bfloat16, d)]
    assert out.dtype == torch.bfloat16 and out.shape == want.shape and rel(out, want.float().numpy()) <= BF16_TOL
    assert (lse - want_lse).abs().max() <= 1e-3


BWD_CASES = [("packed", 640, True), ("packed", 1024, True), ("strided", 576, True), ("packed", 640, False)]


@functools.lru_cache(maxsize=None)
def _reference_grads(layout: str, d: int, dtype: str):
    """Inputs (rounded to dtype) and the reference's gradients of q, k and v
    through its interpret-mode kernels, for the cluster backward's cases."""
    rng = np.random.default_rng(d + 5)
    heads, lq, lk = 2, 70, 130
    shape = (lambda l: (1, l, heads * d)) if layout == "packed" else (lambda l: (1, heads, l, d))
    xs = [t(rng.standard_normal(shape(l)).astype(np.float32), getattr(torch, dtype)).float().numpy()
          for l in (lq, lk, lk, lq)]
    ref = ((lambda a, b, c: jattn.flash_attention_nlc(a, b, c, heads, interpret=True)) if layout == "packed"
           else (lambda a, b, c: jattn.flash_attention(a, b, c, interpret=True)))
    q, k, v, g = xs
    want = jax.grad(lambda a, b, c: jnp.sum(ref(a, b, c) * j(g)), argnums=(0, 1, 2))(j(q), j(k), j(v))
    return xs, [np.asarray(w) for w in want]


@pytest.mark.parametrize("need", ["dq", "dkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,d,split", BWD_CASES, ids=["packed-d640", "packed-d1024", "strided-d576",
                                                           "packed-d640-one-part"])
def test_cluster_backward_stand_in_matches_the_reference(entries, monkeypatch, layout, d, split, dtype, need):
    """Both types through the port's backward wrappers on their card path,
    emox_flash_bwd_wide_sm90 replaced by a stand-in that computes on the
    plan it is handed (checked as the kernel checks it) from the split it
    writes (float32) or the caller's operands zero-padded to the slices
    (bf16): at packed d 640 and 1024 and strided d 576, Lq 70 and Lk 130
    against 64-row tiles, on the H100 (both kernels' streamed tiles in two
    parts) and on a card that holds no doubled cluster (one part); dq only
    and dk/dv only. Each gradient
    against the reference's interpret-mode kernels' (float32: within 2e-4
    of its largest value; bf16: two bf16 steps, relative L2)."""
    held = lambda index, parts, half, stages, cluster: H100_HELD[cluster] if split else 0
    monkeypatch.setattr(tattn, "_clusters_held", held)
    dt = getattr(torch, dtype)
    heads = 2
    (q, k, v, g), want = _reference_grads(layout, d, dtype)
    q, k, v, g = (t(x, dt) for x in (q, k, v, g))
    need_dq, need_dkv = need == "dq", need == "dkv"
    if layout == "packed":
        o, lse = tattn.attention_nlc_plain(q, k, v, heads, d ** -0.5)
        got = tattn.flash_attention_nlc_bwd(q, k, v, o.to(dt), lse, g, heads, need_dq=need_dq, need_dkv=need_dkv)
        b, lq, lk = 1, q.shape[1], k.shape[1]
    else:
        o, lse = tattn.attention_plain(q, k, v, d ** -0.5)
        got = tattn.flash_attention_bwd(q, k, v, o.to(dt), lse, g, need_dq=need_dq, need_dkv=need_dkv)
        b, lq, lk = 1, q.shape[2], k.shape[2]
    plan = tattn.cluster_bwd_args(tattn.card_wide_plan(b, heads, lq, lk, d, dt, 0))
    assert entries == [("bwd_wide_sm90", dt, d, need_dq, need_dkv, plan)]
    assert plan[3:] == ((2, 2) if split and 2 * plan[0] <= MAX_CLUSTER else (1, 1))
    for name, a, w, asked in zip(("dq", "dk", "dv"), got, want, (need_dq, need_dkv, need_dkv)):
        if not asked:
            assert a is None, name
            continue
        assert a.dtype == dt and a.shape == w.shape, name
        if dt == torch.float32:
            assert np.abs(a.numpy() - w).max() <= F32_BAR * np.abs(w).max(), name
        else:
            assert rel(a, w) <= BF16_TOL, name
