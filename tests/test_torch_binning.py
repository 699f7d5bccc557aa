"""The counting binner of svgir_tpu_torch against svgir_tpu: the plain
versions of B1 (per-tile counts + carry snapshots) and B2 (instance slots)
against the Pallas kernels ``compute_counts``/``compute_instances`` (run in
interpret mode on the CPU), and ``bin_instances_counting`` end to end.

Both binners get the same ``Preprocessed`` (JAX's, carried over as numpy),
so every integer output must be exactly equal: no tolerance.  Scenes have
more than one 256-Gaussian chunk and tiles holding more than 128 instances.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.cameras import look_at_camera
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops import binning as jbin
from svgir_tpu.ops import binning_pallas as jbp
from svgir_tpu.ops.preprocess import preprocess as j_preprocess

from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops import binning as tbin
from svgir_tpu_torch.ops import binning_pallas as tbp
from svgir_tpu_torch.ops.preprocess import Preprocessed as TPrep

from tests.torch_kernel_inputs import (INSTANCE_CASES, RECT_CASES,
                                       instance_inputs, instances_from_rects,
                                       synthetic_rects, wide_grid_rects)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops.  Under the parallel test run the CPU is
    oversubscribed, and an op split over torch's thread pool waits for
    descheduled threads (a stage-2 loop took 42 s on 8 threads against 6 s
    on one beside six busy processes); one thread for the module, its
    module-scoped fixtures included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GC = 256


def _prep(seed, n, w, h, tile, scale):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = jnp.asarray(d * rng.uniform(0.5, 1.0, (n, 1)), jnp.float32)
    # surfels facing the camera (normal -z): most pass the culls
    quats = jnp.tile(jnp.array([[0.0, 1.0, 0.0, 0.0]]), (n, 1))
    scales = jnp.asarray(np.exp(rng.normal(0, 0.5, (n, 3))) * scale,
                         jnp.float32)
    cam = look_at_camera(eye=[0, 0, -3], target=[0, 0, 0], up=[0, -1, 0],
                         fovx=math.pi / 3, fovy=math.pi / 3, width=w,
                         height=h)
    cfg = JCfg(tile=tile, max_instances=1 << 14)
    p = j_preprocess(means, scales, quats, cam.world_view, cam.full_proj,
                     cam.camera_center, width=w, height=h,
                     tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                     focal_x=cam.focal_x, focal_y=cam.focal_y,
                     colors=jnp.zeros((n, 3)), cfg=cfg)
    return p


def _to_torch(p):
    return TPrep(*(torch.as_tensor(np.asarray(x)) for x in p))


CASES = {
    # tile 16 on a square image; tile 32 on a non-square one
    "tile16_128x128": dict(seed=0, n=600, w=128, h=128, tile=16, scale=0.12),
    "tile32_96x160": dict(seed=1, n=700, w=96, h=160, tile=32, scale=0.10),
}


def _sorted_rects(p):
    """The JAX binner's depth sort, padded to whole Gaussian chunks."""
    n = p.valid.shape[0]
    v = p.valid
    key = jnp.where(v, p.depth, jnp.inf)
    ids = jnp.where(v, jnp.arange(n, dtype=jnp.int32), -1)
    z = jnp.zeros((), jnp.int32)
    _, x0, y0, x1, y1, order = jax.lax.sort(
        (key, jnp.where(v, p.rect_min[:, 0], z),
         jnp.where(v, p.rect_min[:, 1], z), jnp.where(v, p.rect_max[:, 0], z),
         jnp.where(v, p.rect_max[:, 1], z), ids), num_keys=1, is_stable=True)
    npad = (-n) % GC
    pad = lambda a: jnp.concatenate([a, jnp.zeros((npad,), a.dtype)])
    return [pad(a) for a in (x0, y0, x1, y1, order)]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    c = CASES[request.param]
    p = _prep(c["seed"], c["n"], c["w"], c["h"], c["tile"], c["scale"])
    gx = -(-c["w"] // c["tile"])
    gy = -(-c["h"] // c["tile"])
    return dict(c, prep=p, gx=gx, gy=gy, rects=_sorted_rects(p))


def test_counts_plain_matches_pallas(case):
    x0, y0, x1, y1, _ = case["rects"]
    gx, gy = case["gx"], case["gy"]
    js, jpc, jtot, jcarry = jbp.compute_counts(
        x0, y0, x1, y1, grid_x=gx, grid_y=gy, chunk=128, gauss_chunk=GC,
        interpret=True)
    tr = [torch.as_tensor(np.asarray(a)) for a in (x0, y0, x1, y1)]
    ts, tpc, ttot, tcarry = tbp.compute_counts(*tr, grid_x=gx, grid_y=gy,
                                               chunk=128, gauss_chunk=GC)
    assert tcarry.shape[0] > 1                  # several Gaussian chunks
    assert int(tpc.max()) > 128                 # a tile with > 1 chunk
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    assert int(ttot) == int(jtot)
    np.testing.assert_array_equal(tcarry.numpy(),
                                  np.asarray(jcarry)[:, :gx * gy])


def test_counts_plain_on_a_grid_past_shared_memory():
    """Tile 16 over 4,096 x 4,096 pixels: a 256 x 256 grid whose difference
    array (257 * 257 * 4 = 264,196 bytes) exceeds a block's shared memory,
    so the CUDA kernel counts it in bands.  Counts and carry of 512 rects
    (full-grid, out-of-grid and small ones) equal a direct count."""
    gx = gy = 256
    assert 4 * (gx + 1) * (gy + 1) > 232_448
    rects = wide_grid_rects(gx, gy)
    x0, y0, x1, y1 = rects
    tc, tcarry = tbp.counts_plain(*(torch.as_tensor(a) for a in rects),
                                  grid_x=gx, grid_y=gy, gauss_chunk=GC)
    tx, ty = np.arange(gx * gy) % gx, np.arange(gx * gy) // gx
    cover = ((tx >= x0[:, None]) & (tx < x1[:, None])
             & (ty >= y0[:, None]) & (ty < y1[:, None]))
    np.testing.assert_array_equal(tc.numpy(), cover.sum(0))
    per_chunk = cover.reshape(-1, GC, gx * gy).sum(1)
    np.testing.assert_array_equal(tcarry.numpy(),
                                  np.cumsum(per_chunk, 0) - per_chunk)


@pytest.mark.parametrize("name", sorted(RECT_CASES))
def test_counts_plain_matches_pallas_on_synthetic_rects(name):
    """Full-grid, zero-area, inverted, edge-ending and out-of-grid rects,
    padding, a single chunk, tile 16 on a non-square grid: counts and
    carry equal to the Pallas kernel's, and the counts to a direct count
    of each tile's covering rects."""
    (x0, y0, x1, y1), (gx, gy) = synthetic_rects(name)
    assert ((x0 == 0) & (y0 == 0) & (x1 == gx) & (y1 == gy)).any()
    assert ((x1 == x0) & (y1 > y0)).any() and ((x1 < x0) & (y1 < y0)).any()
    assert ((x0 > 0) & (x1 == gx) & (y1 == gy)).any() and (x0 < 0).any()
    js, jpc, jtot, jcarry = jbp.compute_counts(
        *(jnp.asarray(a) for a in (x0, y0, x1, y1)), grid_x=gx, grid_y=gy,
        chunk=128, gauss_chunk=GC, interpret=True)
    ts, tpc, ttot, tcarry = tbp.compute_counts(
        *(torch.as_tensor(a) for a in (x0, y0, x1, y1)), grid_x=gx,
        grid_y=gy, chunk=128, gauss_chunk=GC)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpc.numpy(), np.asarray(jpc))
    assert int(ttot) == int(jtot)
    np.testing.assert_array_equal(tcarry.numpy(),
                                  np.asarray(jcarry)[:, :gx * gy])
    tx, ty = np.arange(gx * gy) % gx, np.arange(gx * gy) // gx
    cover = ((tx >= x0[:, None]) & (tx < x1[:, None])
             & (ty >= y0[:, None]) & (ty < y1[:, None]))
    counts = cover.sum(0)
    np.testing.assert_array_equal(tpc.numpy(), -(-counts // 128) * 128)
    per_chunk = cover.reshape(-1, GC, gx * gy).sum(1)
    np.testing.assert_array_equal(tcarry.numpy(),
                                  np.cumsum(per_chunk, 0) - per_chunk)


def test_instances_plain_matches_pallas(case):
    x0, y0, x1, y1, order = case["rects"]
    gx, gy = case["gx"], case["gy"]
    m = 1 << 13
    touched = (x1 - x0) * (y1 - y0)
    offsets = jnp.cumsum(touched) - touched
    total_raw = int(offsets[-1] + touched[-1])
    assert total_raw < m
    tile_start, _, _, carry = jbp.compute_counts(
        x0, y0, x1, y1, grid_x=gx, grid_y=gy, chunk=128, gauss_chunk=GC,
        interpret=True)
    # the JAX kernel's table layout: padded (ty, tx) planes in f32
    inst_block = 512
    firsts = jnp.clip(jnp.searchsorted(
        offsets, jnp.arange(0, m, inst_block, dtype=jnp.int32),
        side="right") - 1, 0, offsets.shape[0] - 1)
    wstart = ((firsts // GC) * GC).astype(jnp.int32)
    tbl = carry[:, :gx * gy] + tile_start[None, :]
    nct = tbl.shape[0]
    table = jnp.zeros((nct, -(-gy // 8) * 8, -(-gx // 128) * 128),
                      jnp.float32).at[:, :gy, :gx].set(
        tbl.reshape(nct, gy, gx).astype(jnp.float32))
    jslot, jgid, _ = jbp.compute_instances(
        x0, y0, x1, y1, offsets, order, wstart, table, m=m, grid_x=gx,
        gauss_chunk=GC, inst_block=inst_block, interpret=True)

    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    tslot, tgid = tbp.compute_instances(
        t(x0), t(y0), t(x1), t(y1), t(offsets), t(order), t(tbl),
        torch.tensor(total_raw, dtype=torch.int32), m=m, grid_x=gx,
        gauss_chunk=GC)
    np.testing.assert_array_equal(tslot.numpy()[:total_raw],
                                  np.asarray(jslot)[:total_raw])
    np.testing.assert_array_equal(tgid.numpy()[:total_raw],
                                  np.asarray(jgid)[:total_raw])
    assert (tslot.numpy()[total_raw:] == m).all()
    assert (tgid.numpy()[total_raw:] == -1).all()


def _pallas_instances(inp, m, inst_block=512):
    """JAX ``compute_instances`` (interpret mode) on ``instance_inputs``'
    arrays, for instances [0, m) (m rounded up to whole blocks): the table
    laid out as its padded (ty, tx) planes in f32, each block's window
    starting at the chunk of its first instance's Gaussian."""
    gx, gy = inp["grid_x"], inp["grid_y"]
    x0, y0, x1, y1, offsets, order = (jnp.asarray(inp[k]) for k in (
        "x0", "y0", "x1", "y1", "offsets", "order"))
    m = -(-m // inst_block) * inst_block
    firsts = jnp.clip(jnp.searchsorted(
        offsets, jnp.arange(0, m, inst_block, dtype=jnp.int32),
        side="right") - 1, 0, offsets.shape[0] - 1)
    wstart = ((firsts // GC) * GC).astype(jnp.int32)
    nct = inp["table"].shape[0]
    table = np.zeros((nct, -(-gy // 8) * 8, -(-gx // 128) * 128), np.float32)
    table[:, :gy, :gx] = inp["table"].reshape(nct, gy, gx)
    slot, gid, _ = jbp.compute_instances(
        x0, y0, x1, y1, offsets, order, wstart, jnp.asarray(table), m=m,
        grid_x=gx, gauss_chunk=GC, inst_block=inst_block, interpret=True)
    return np.asarray(slot), np.asarray(gid)


# the instances held against JAX on the wide grids: its interpret-mode
# table lookup costs a [GYp, GXp] plane per instance
B2_PALLAS_M = {"wide_256x256": 4096, "wide_60000x3": 2048}


@pytest.mark.parametrize("name", list(INSTANCE_CASES)
                         + [f"synthetic_{n}" for n in sorted(RECT_CASES)])
def test_instances_plain_matches_pallas_on_edge_cases(name):
    """B2's edge cases (``tests/torch_kernel_inputs.instance_inputs``: a
    chunk whose rects all cover one tile, a chunk of empty and inverted
    rects, a last chunk ending in padding, m past and below total_raw, a
    tile-16 grid, grids past a block's shared memory) and the synthetic
    rects of B1's cases clipped to their grids: slots and gids equal to
    the Pallas kernel's; past total_raw slot m and gid -1."""
    if name.startswith("synthetic_"):
        rects, (gx, gy) = synthetic_rects(name[len("synthetic_"):])
        inp = instances_from_rects(rects, gx, gy)
    else:
        inp = instance_inputs(name)
    m, total_raw = B2_PALLAS_M.get(name, inp["m"]), inp["total_raw"]
    t = {k: torch.as_tensor(inp[k]) for k in (
        "x0", "y0", "x1", "y1", "offsets", "order", "table")}
    tslot, tgid = tbp.compute_instances(
        t["x0"], t["y0"], t["x1"], t["y1"], t["offsets"], t["order"],
        t["table"], torch.tensor(total_raw, dtype=torch.int32), m=m,
        grid_x=inp["grid_x"], gauss_chunk=GC)
    jslot, jgid = _pallas_instances(inp, m)
    live = min(total_raw, m)
    np.testing.assert_array_equal(tslot.numpy()[:live], jslot[:live])
    np.testing.assert_array_equal(tgid.numpy()[:live], jgid[:live])
    assert (tslot.numpy()[live:] == m).all()
    assert (tgid.numpy()[live:] == -1).all()
    assert name != "edges_overflow" or m < total_raw
    if name == "edges":
        assert m > total_raw
        assert (np.diff(inp["offsets"][2 * GC:3 * GC]) == 0).all()
        # the 256 Gaussians of chunk 1 all cover tile (12, 7): ranks 0..255
        t_id = 7 * 25 + 12
        g = np.searchsorted(inp["offsets"], np.arange(total_raw),
                            side="right") - 1
        k = np.arange(total_raw) - inp["offsets"][g]
        w = np.maximum(inp["x1"][g] - inp["x0"][g], 1)
        tile = (inp["y0"][g] + k // w) * 25 + inp["x0"][g] + k % w
        at = (g // GC == 1) & (tile == t_id)
        np.testing.assert_array_equal(
            np.sort(tslot.numpy()[:total_raw][at] - inp["table"][1, t_id]),
            np.arange(GC))


@pytest.mark.parametrize("cap", [1 << 15, 1 << 9])
def test_bin_instances_counting_exact(case, cap):
    """End to end, with a roomy cap and with one that overflows."""
    w, h, tile = case["w"], case["h"], case["tile"]
    jp = case["prep"]
    jr = jbin.bin_instances_counting(jp, width=w, height=h,
                                     cfg=JCfg(tile=tile, max_instances=cap),
                                     interpret=True)
    tr = tbin.bin_instances_counting(_to_torch(jp), width=w, height=h,
                                     cfg=TCfg(tile=tile, max_instances=cap))
    for f in ("gaussian_id", "inst_valid", "tile_start", "tile_count",
              "num_instances", "overflow", "order"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)), err_msg=f)
    assert bool(tr.overflow) == (cap == 1 << 9)
