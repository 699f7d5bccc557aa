"""svgir_tpu_torch.ops.grid_tracer and the grid march B8's plain version
(ops/march_pallas.py) on the CPU, against svgir_tpu.ops.grid_tracer and
svgir_tpu.ops.march_pallas, and against the port's brute-force tracer.

* Grid build: both packages built from the same (JAX) geometry pick the
  same resolution and give equal cell counts, big-surfel ids, block
  starts and block tables (the JAX table read in its candidate-major
  layout, the port's in its field-major one), and the cell lists read
  from the port's table equal JAX's ``cell_ids``.
* Grid march: the port's march against the JAX XLA visit path
  (``SVGIR_MARCH_PALLAS`` unset, ROADMAP C-2) on well-conditioned surfels
  (a sphere, and the mixed-scale and wide scenes below with z scale half
  the in-plane one), and against the port's brute tracer on the thin scenes of
  tests/test_grid_tracer.py, tests/test_guards.py and
  tests/test_march_pallas.py (see tests/test_torch_tracing.py for why the
  thin scenes are held within the port).
* One visit: ``march_visit_plain`` against ``_test_candidates`` +
  ``bitonic_topk_small`` and against the Pallas kernel in interpret mode,
  with a running-hit carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.ops import grid_tracer as JGT
from svgir_tpu.ops import tracing as JTR
from svgir_tpu.utils.transforms import normal_to_rotation as j_n2r
from svgir_tpu.utils.transforms import normalize as j_normalize

from svgir_tpu_torch import kernels
from svgir_tpu_torch.kernels import march as KM
from svgir_tpu_torch.ops import grid_tracer as TGT
from svgir_tpu_torch.ops import march_pallas as TMP
from svgir_tpu_torch.ops import tracing as TTR

from test_torch_tracing import (assert_hits_equal, geometries, rays,
                                sphere_scene)


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



def port_geo(jgeo):
    return TTR.SurfelGeometry(*[torch.as_tensor(np.array(x)) for x in jgeo])


# ---- scenes of the JAX tests (thin surfels), as JAX geometry ------------

def grid_scene():
    """tests/test_grid_tracer.py::_scene."""
    n = 300
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(0), (n, 3)))
    scales = jnp.full((n, 3), 0.08).at[:, 2].set(1e-9)
    opac = jax.random.uniform(jax.random.PRNGKey(1), (n,), minval=0.3,
                              maxval=0.9)
    return JTR.build_surfel_geometry(dirs * 0.5, scales, j_n2r(-dirs), opac)


def mixed_scene(z=None):
    """tests/test_grid_tracer.py::test_mixed_scale_scene_uses_big_partition:
    small surfels, six big ones and a giant.  ``z`` sets the third scale
    as a fraction of the first (default: thin, 1e-9)."""
    n = 300
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(0), (n, 3)))
    scale = jnp.full((n,), 0.01).at[:6].set(0.22).at[6].set(0.8)
    scales = jnp.stack([scale, scale, jnp.full((n,), 1e-9)
                        if z is None else z * scale], axis=1)
    opac = jax.random.uniform(jax.random.PRNGKey(1), (n,), minval=0.3,
                              maxval=0.9)
    return JTR.build_surfel_geometry(dirs * 0.5, scales, j_n2r(-dirs), opac)


def wide_scene(z=None):
    """tests/test_guards.py::test_grid_t_max_derived_from_scene_extent:
    radius 5, rays fly ~17 units between shells.  ``z`` as in
    ``mixed_scene``."""
    n = 120
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(5), (n, 3)))
    scales = jnp.full((n, 3), 0.8).at[:, 2].set(1e-9 if z is None
                                                  else 0.8 * z)
    opac = jax.random.uniform(jax.random.PRNGKey(6), (n,), minval=0.3,
                              maxval=0.9)
    return JTR.build_surfel_geometry(dirs * 5.0, scales, j_n2r(-dirs), opac)


def march_scene(n=4000, seed=3, z=0.0):
    """tests/test_march_pallas.py::_scene (random orientations, scales in
    [0.005, 0.02]); ``z`` sets the third scale as a fraction of the first."""
    k = jax.random.split(jax.random.PRNGKey(seed), 6)
    dirs = j_normalize(jax.random.normal(k[0], (n, 3)))
    pts = dirs * (0.6 + 0.4 * jax.random.uniform(k[1], (n, 1)))
    scales = 0.005 + 0.015 * jax.random.uniform(k[2], (n, 3))
    scales = scales.at[:, 2].set(z * scales[:, 0])
    quats = j_normalize(jax.random.normal(k[3], (n, 4)))
    opac = 0.2 + 0.7 * jax.random.uniform(k[4], (n,))
    return JTR.build_surfel_geometry(pts, scales, quats, opac)


SCENES = {"grid": grid_scene, "mixed": mixed_scene, "wide": wide_scene,
          "march": lambda: march_scene(n=1500, seed=5)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_auto_res_matches_jax(name):
    jgeo = SCENES[name]()
    assert TGT.auto_res(port_geo(jgeo)) == JGT.auto_res(jgeo)


def _assert_grids_equal(jg, tg):
    assert (tg.res, tg.cell_cap, tg.overflow) == \
        (jg.res, jg.cell_cap, bool(jg.overflow))
    for f in ("cell_count", "big_ids", "block_start", "lo", "inv_cell"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    # JAX candidate-major [B, BLK, 32] vs port field-major [B, 32, BLK]
    jb = np.asarray(jg.block_geo).reshape(-1, JGT._TRACE_BLOCK, 32)
    tb = tg.block_geo.numpy().reshape(-1, 32, TGT.BLK).transpose(0, 2, 1)
    np.testing.assert_array_equal(tb[..., TGT.ID_LANE], jb[..., 26])
    np.testing.assert_array_equal(tb, jb)
    # the port keeps no [C, cap] lists: read each cell's list from its
    # blocks' id lane and hold it to JAX's cell_ids
    cnt = np.minimum(tg.cell_count.numpy(), tg.cell_cap)
    slot = np.arange(tg.cell_cap)
    ok = slot[None] < cnt[:, None]
    row = np.where(ok, tg.block_start.numpy()[:, None] + slot // TGT.BLK, 0)
    ids = np.where(ok, tb[row, slot % TGT.BLK, TGT.ID_LANE], -1)
    np.testing.assert_array_equal(ids, np.asarray(jg.cell_ids))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_grid_auto_matches_jax(name, monkeypatch):
    monkeypatch.delenv("SVGIR_MARCH_PALLAS", raising=False)
    jgeo = SCENES[name]()
    res = 64 if name == "mixed" else JGT.auto_res(jgeo)
    jg = JGT.build_grid_auto(jgeo, res=res)
    tg = TGT.build_grid_auto(port_geo(jgeo), res=res)
    _assert_grids_equal(jg, tg)
    if name == "mixed":
        assert tg.big_ids.shape[0] >= 7


def test_build_grid_clipped_cap_matches_jax(monkeypatch):
    """An explicit cap below the largest cell count clips the lists and
    flags the overflow (tests/test_grid_tracer.py::test_cell_cap_auto_grow)
    ; the exact cap from build_grid_auto grows past it."""
    monkeypatch.delenv("SVGIR_MARCH_PALLAS", raising=False)
    jgeo = grid_scene()
    res = JGT.auto_res(jgeo)
    jg = JGT.build_grid(jgeo, res=res, cell_cap=2, max_cells_per_gauss=128)
    tg = TGT.build_grid(port_geo(jgeo), res=res, cell_cap=2, span_cap=128)
    _assert_grids_equal(jg, tg)
    assert tg.overflow
    grown = TGT.build_grid_auto(port_geo(jgeo), res=res, span_cap=128)
    assert not grown.overflow and grown.cell_cap > 2


def test_count_visit_blocks_matches_jax():
    jgeo = march_scene(n=1500, seed=5)
    jg = JGT.build_grid_auto(jgeo)
    tg = TGT.build_grid_auto(port_geo(jgeo))
    o, d = rays(200, seed=2, spread=0.05)
    n_steps = JGT._concrete_n_steps(jg, 4.0)
    assert TGT._concrete_n_steps(tg, 4.0) == n_steps
    assert TGT._run_kmax(tg) == JGT._run_kmax(jg)
    cj = JGT.count_visit_blocks(jg, jnp.asarray(o), jnp.asarray(d),
                                t_max=4.0, n_steps=n_steps)
    ct = TGT.count_visit_blocks(tg, torch.as_tensor(o), torch.as_tensor(d),
                                t_max=4.0, n_steps=n_steps)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(ct.max()) > 1


@pytest.mark.parametrize("k", [8, 16])
def test_grid_march_matches_jax_xla_path(k, monkeypatch):
    """Well-conditioned surfels: the port's grid march (plain visit) ==
    the JAX package's XLA visit path, and == the port's brute tracer."""
    monkeypatch.delenv("SVGIR_MARCH_PALLAS", raising=False)
    scene = sphere_scene(n=400, seed=11)
    jgeo, tgeo = geometries(scene)
    jg = JGT.build_grid_auto(jgeo, res=JGT.auto_res(jgeo))
    tg = TGT.build_grid_auto(tgeo, res=TGT.auto_res(tgeo))
    o, d = rays(96, seed=12)
    hj = JGT.nearest_hits_grid(jgeo, jg, jnp.asarray(o), jnp.asarray(d),
                               t_max=2.0, k=k)
    ht = TGT.nearest_hits_grid(tgeo, tg, torch.as_tensor(o),
                               torch.as_tensor(d), t_max=2.0, k=k)
    assert assert_hits_equal(hj, ht) > 96 * 3
    hb = TTR.nearest_hits(tgeo, torch.as_tensor(o), torch.as_tensor(d), k=k)
    assert_hits_equal({x: v.numpy() for x, v in hb.items()}, ht, tol=0.0)


def wide_rays(means, n=64, seed=4):
    """Rays from the wide scene's shell, inward (jittered)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, means.shape[0], n)
    o = means[src] * 0.999
    d = -o / np.linalg.norm(o, axis=1, keepdims=True)
    d = (d + 0.3 * rng.standard_normal(d.shape)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", ["mixed", "wide"])
def test_grid_march_matches_jax_xla_path_on_big_and_wide_scenes(
        name, monkeypatch):
    """Well-conditioned versions (z scale half the in-plane one) of the
    mixed-scale scene, whose big surfels go through ``_merge_big``, and of
    the wide scene, marched over the extent-derived range of the bake
    (``radiance._march_extent``): the port's grid march == the JAX XLA
    visit path, and == the port's brute tracer."""
    from svgir_tpu_torch.models.radiance import _march_extent

    monkeypatch.delenv("SVGIR_MARCH_PALLAS", raising=False)
    jgeo = (mixed_scene if name == "mixed" else wide_scene)(z=0.5)
    tgeo = port_geo(jgeo)
    res = 64 if name == "mixed" else JGT.auto_res(jgeo)
    jg = JGT.build_grid_auto(jgeo, res=res)
    tg = TGT.build_grid_auto(tgeo, res=res)
    if name == "mixed":
        o, d = rays(64, seed=2)
        t_max, k = 3.0, 8
    else:
        o, d = wide_rays(tgeo.means.numpy())
        t_max, k = _march_extent(tgeo.means, tgeo.scales), 8
        assert t_max > 15.0
    hj = JGT.nearest_hits_grid(jgeo, jg, jnp.asarray(o), jnp.asarray(d),
                               t_max=t_max, k=k)
    ht = TGT.nearest_hits_grid(tgeo, tg, torch.as_tensor(o),
                               torch.as_tensor(d), t_max=t_max, k=k)
    n = assert_hits_equal(hj, ht)
    hb = TTR.nearest_hits(tgeo, torch.as_tensor(o), torch.as_tensor(d), k=k)
    assert_hits_equal({x: v.numpy() for x, v in hb.items()}, ht, tol=0.0)
    fin = torch.isfinite(ht["t"])
    if name == "mixed":         # the big surfels are hit
        assert tg.big_ids.shape[0] >= 7
        assert bool(torch.isin(ht["idx"][fin], tg.big_ids).any())
    else:                       # hits past a fixed 2.0 range
        assert int((ht["t"][fin] > 2.0).sum()) > 20
    assert n > 20


@pytest.mark.parametrize("name,t_max,k", [("grid", 2.0, 8),
                                          ("mixed", 3.0, 8),
                                          ("wide", 20.0, 8),
                                          ("march", 4.0, 16)])
def test_grid_march_matches_brute_on_thin_scenes(name, t_max, k):
    """The port's grid march == its brute tracer, hit for hit, where the
    surfels are thin and the power is rounding noise."""
    tgeo = port_geo(SCENES[name]())
    res = 64 if name == "mixed" else TGT.auto_res(tgeo)
    grid = TGT.build_grid_auto(tgeo, res=res)
    if name == "wide":          # rays from the shell, inward
        o, d = wide_rays(tgeo.means.numpy())
    elif name == "march":       # tests/test_march_pallas.py's rays
        o, d = rays(400, seed=2, spread=0.05)
    else:
        o, d = rays(64, seed=2)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    hg = TGT.nearest_hits_grid(tgeo, grid, o, d, t_max=t_max, k=k)
    hb = TTR.nearest_hits(tgeo, o, d, k=k)
    n = assert_hits_equal({x: v.numpy() for x, v in hb.items()}, hg,
                          tol=0.0)
    assert n > 20


def _visit_inputs(r=256, k=8):
    """Block rows of the thick march scene's field-major table with a ray
    aimed at the front of a surfel of each, and a running carry of finite
    hits."""
    jgeo = march_scene(n=1500, seed=5, z=0.5)
    tg = TGT.build_grid_auto(port_geo(jgeo))
    rng = np.random.default_rng(0)
    nrows = tg.block_geo.shape[0] - 1
    rows = rng.integers(0, nrows, r)
    g = tg.block_geo[torch.as_tensor(rows)]                 # [R, 32*BLK]
    g3 = g.reshape(r, 32, TGT.BLK)
    slot = torch.as_tensor(rng.integers(0, TGT.BLK, r))
    slot = torch.where(g3[torch.arange(r), TGT.ID_LANE, slot] >= 0, slot,
                       torch.zeros_like(slot))              # a real surfel
    target = g3[torch.arange(r), 0:3, slot]
    normal = g3[torch.arange(r), 21:24, slot]
    jitter = torch.as_tensor(rng.standard_normal((r, 3)).astype(np.float32))
    o = target + 0.3 * normal + 0.05 * jitter
    d = target - o + 0.003 * jitter.roll(1, 1)
    d = d / d.norm(dim=1, keepdim=True)
    # carry: sorted finite t on a random prefix of the slots, ids >= 5000
    nfin = rng.integers(0, k + 1, r)
    ct = np.sort(rng.uniform(0.3, 1.2, (r, k)).astype(np.float32), 1)
    ct[np.arange(k)[None] >= nfin[:, None]] = np.inf
    ci = np.where(np.isfinite(ct), 5000 + np.arange(r * k).reshape(r, k),
                  -1).astype(np.int32)
    return jgeo, g, o, d, torch.as_tensor(ct), torch.as_tensor(ci)


def test_march_visit_plain_matches_jax_single_visit(monkeypatch):
    """One visit with a carry: the port's plain visit == ``_test_candidates``
    + ``bitonic_topk_small`` (finite slots) and == ``march_test_merge`` in
    interpret mode (every slot, inf/-1 padding included)."""
    from svgir_tpu.ops.march_pallas import march_test_merge

    k = 8
    jgeo, g, o, d, ct, ci = _visit_inputs(k=k)
    r = g.shape[0]
    t_lo = torch.zeros(r)
    t_hi = torch.full((r,), 4.0)
    tt, ti = TMP.march_visit_plain(g, o, d, t_lo, t_hi, ct, ci, k=k)

    gj, oj, dj = jnp.asarray(g.numpy()), jnp.asarray(o.numpy()), \
        jnp.asarray(d.numpy())
    lo_j, hi_j = jnp.zeros((r,)), jnp.full((r,), 4.0)
    g3 = gj.reshape(r, 32, TGT.BLK).transpose(0, 2, 1)
    cand = JGT._test_candidates(jgeo, None, oj, dj, lo_j, hi_j, geo_rows=g3)
    mt, mi = JGT.bitonic_topk_small(
        jnp.concatenate([jnp.asarray(ct.numpy()), cand["t"]], 1),
        jnp.concatenate([jnp.asarray(ci.numpy()),
                         jnp.where(cand["ok"], cand["idx"], -1)], 1), k)
    n_new = int(np.asarray(cand["ok"]).sum())
    assert n_new > r // 2                     # the visit finds hits
    assert int((ti.numpy() < 5000).sum()) > 0 and \
        int((ti.numpy() >= 5000).sum()) > 0   # merged with the carry
    assert_hits_equal({"t": mt, "idx": mi}, {"t": tt, "idx": ti}, tol=1e-6)

    monkeypatch.setenv("SVGIR_MARCH_PALLAS", "1")
    kt, ki = march_test_merge(gj, oj, dj, lo_j, hi_j,
                              jnp.asarray(ct.numpy()),
                              jnp.asarray(ci.numpy()), blk=TGT.BLK, k=k,
                              interpret=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ki))
    np.testing.assert_allclose(tt.numpy(), np.asarray(kt), atol=1e-6)


def test_march_visit_plain_breaks_ties_in_slot_order():
    """Equal t keep slot order: the running hits first, then candidates in
    row order (``lax.top_k`` on -t, the kernel's contract)."""
    _, g, o, d, _, _ = _visit_inputs(r=64, k=4)
    t0, i0 = TMP.march_visit_plain(g, o, d, torch.zeros(()),
                                   torch.full((), 4.0),
                                   torch.full((64, 4), float("inf")),
                                   torch.full((64, 4), -1,
                                              dtype=torch.int32), k=4)
    fin = torch.isfinite(t0[:, 0])
    carry_t = t0[:, :1].expand(-1, 4).clone()
    carry_i = torch.full((64, 4), 9999, dtype=torch.int32)
    t1, i1 = TMP.march_visit_plain(g, o, d, torch.zeros(()),
                                   torch.full((), 4.0), carry_t, carry_i,
                                   k=4)
    # four carried copies of the nearest t come before the candidate's own
    assert bool(fin.any())
    assert bool((i1[fin] == 9999).all())
    assert torch.equal(t1[fin], carry_t[fin])


def test_march_dispatch_runs_the_plain_version_on_the_cpu():
    tgeo = port_geo(march_scene(n=1500, seed=5))
    grid = TGT.build_grid_auto(tgeo)
    o, d = (torch.as_tensor(x) for x in rays(32, seed=3))
    kernels.reset_launches()
    t, i = TMP.march(grid, o, d, t_max=4.0, k=8,
                     n_steps=TGT._concrete_n_steps(grid, 4.0),
                     kmax=TGT._run_kmax(grid))
    tp, ip = TMP.march_plain(grid, o, d, t_max=4.0, k=8,
                             n_steps=TGT._concrete_n_steps(grid, 4.0),
                             kmax=TGT._run_kmax(grid))
    assert torch.equal(t, tp) and torch.equal(i, ip)
    assert kernels.launches()["march"] == 0
    assert bool((i[~torch.isfinite(t)] == -1).all())


@pytest.mark.parametrize("kw,match", [(dict(k=8), "CUDA"),
                                      (dict(k=129), "1 to 128")])
def test_march_wrapper_refuses_what_the_kernel_does_not_take(kw, match):
    tgeo = port_geo(grid_scene())
    grid = TGT.build_grid_auto(tgeo)
    o, d = (torch.as_tensor(x) for x in rays(8))
    with pytest.raises(ValueError, match=match):
        KM.march(grid.block_geo, grid.block_start, grid.cell_count, o, d,
                 lo=grid.lo, inv_cell=grid.inv_cell, res=grid.res,
                 dt=TGT.grid_dt(grid), t_max=2.0, n_steps=8, kmax=2,
                 cap=grid.cell_cap, **kw)
