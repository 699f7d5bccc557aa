"""The port's radiance bake on the CPU: ``bake_radiance`` (grid and brute
branches) and ``bake_radiance_compact`` against svgir_tpu on the same
azimuth draws, and the port's grid bake against its brute bake on the JAX
package's thin-surfel scenes.  ``train_stage2`` without a bake is held to
the JAX loop in tests/test_torch_stage2_training.py.

Scenes for the comparison with JAX are well-conditioned and keep their
normals more than 60 degrees from -z (see ``sphere_scene`` in
tests/test_torch_tracing.py for both reasons): there the incident
directions agree within 2e-6, hit_idx is equal and radiance, visibility
and uv agree within 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.models.radiance import bake_radiance as j_bake
from svgir_tpu.train import trainer as jtrainer
from svgir_tpu.utils.transforms import normal_to_rotation as j_n2r
from svgir_tpu.utils.transforms import normalize as j_normalize

from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.models.radiance import bake_radiance as t_bake
from svgir_tpu_torch.train import trainer as ttrainer

from test_torch_tracing import sphere_scene


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


TOL = 1e-5
FIELDS = ("radiance", "visibility", "uv", "incident_dirs", "incident_areas",
          "incident_qxy")


def _shs(n, seed=7):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((n, 16, 3))).astype(np.float32)


def assert_bakes_equal(bj, bt, tol=TOL):
    np.testing.assert_array_equal(bt["hit_idx"].numpy(),
                                  np.asarray(bj["hit_idx"]))
    for k in FIELDS:
        if k in bj:
            np.testing.assert_allclose(bt[k].numpy(), np.asarray(bj[k]),
                                       atol=tol, err_msg=k)
    assert float(bt["exhausted_frac"]) == pytest.approx(
        float(bj["exhausted_frac"]), abs=1e-7)


@pytest.mark.parametrize("use_grid", [False, True], ids=["brute", "grid"])
def test_bake_radiance_matches_jax(use_grid):
    scene = sphere_scene(n=260, seed=21, radius=0.25, scale=0.08,
                         pole_gap=0.5)
    n, s = len(scene[0]), 8
    shs = _shs(n)
    key = jax.random.PRNGKey(8)
    bj = j_bake(*map(jnp.asarray, scene), jnp.asarray(shs), sample_num=s,
                key=key, k_hits=8, ray_chunk=512, use_grid=use_grid)
    az = torch.as_tensor(np.array(jax.random.uniform(key, (n, 1))))
    bt = t_bake(*map(torch.as_tensor, scene), torch.as_tensor(shs),
                sample_num=s, azimuth=az, k_hits=8, ray_chunk=700,
                use_grid=use_grid)
    assert_bakes_equal(bj, bt)
    hits = bt["hit_idx"].numpy()
    assert (hits >= 0).mean() > 0.2 and (bt["visibility"] < 1).any()
    assert bt["incident_qxy"].shape == (n, s, 2)


def _thin_bake_scene(name):
    """tests/test_grid_tracer.py::test_full_bake_grid_matches_brute and
    tests/test_guards.py::test_grid_t_max_derived_from_scene_extent."""
    n, key, radius, scale = {"full": (200, 5, 0.5, 0.08),
                             "wide": (120, 5, 5.0, 0.8)}[name]
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(key), (n, 3)))
    scales = jnp.full((n, 3), scale).at[:, 2].set(1e-9)
    opac = jax.random.uniform(jax.random.PRNGKey(6), (n,), minval=0.3,
                              maxval=0.9)
    shs = 0.3 * jax.random.normal(jax.random.PRNGKey(7), (n, 16, 3))
    return [torch.as_tensor(np.array(x)) for x in
            (dirs * radius, scales, j_n2r(-dirs), opac, shs)]


def test_port_grid_bake_equals_its_brute_bake_on_a_thin_scene():
    """Where the power is rounding noise the port's two branches share one
    order of evaluation and agree exactly."""
    scene = _thin_bake_scene("full")
    g = torch.Generator().manual_seed(8)
    az = torch.rand(scene[0].shape[0], 1, generator=g)
    kw = dict(sample_num=8, azimuth=az, k_hits=8)
    brute = t_bake(*scene, use_grid=False, **kw)
    grid = t_bake(*scene, use_grid=True, **kw)
    assert torch.equal(grid["hit_idx"], brute["hit_idx"])
    assert int((grid["hit_idx"] >= 0).sum()) > 20
    for k in ("radiance", "visibility", "uv"):
        torch.testing.assert_close(grid[k], brute[k], atol=1e-6, rtol=0)


def test_march_range_covers_a_wide_scene():
    """A scene ten times larger than a fixed 2.0 march range: the bake's
    range comes from the surfels' extent (diagonal + 3 sigma at each end),
    and over it the grid finds the brute tracer's hits, most of them past
    2.0 (the bake's own rays, from the surfel centres)."""
    from svgir_tpu_torch.models import radiance as RAD
    from svgir_tpu_torch.ops import grid_tracer as TGT
    from svgir_tpu_torch.ops import tracing as TTR
    from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling

    means, scales, quats, opac, _ = _thin_bake_scene("wide")
    t_max = RAD._march_extent(means, scales)
    span = means.max(0).values - means.min(0).values
    assert t_max == pytest.approx(float(span.norm()) + 6 * 0.8, rel=1e-6)
    geo = TTR.build_surfel_geometry(means, scales, quats, opac)
    dirs, _ = fibonacci_sphere_sampling(geo.normal, 6)
    o = means.repeat_interleave(6, 0)
    d = dirs.reshape(-1, 3)
    grid = TGT.build_grid_auto(geo, res=TGT.auto_res(geo))
    hg = TGT.nearest_hits_grid(geo, grid, o, d, t_max=t_max, k=8)
    hb = TTR.nearest_hits(geo, o, d, k=8)
    fin = torch.isfinite(hb["t"])
    assert torch.equal(fin, torch.isfinite(hg["t"]))
    assert torch.equal(hg["idx"][fin], hb["idx"][fin])
    assert torch.equal(hg["t"][fin], hb["t"][fin])
    assert int((hb["t"][fin] > 2.0).sum()) > int(fin.sum()) // 2 > 20


def _compact_params(pole_gap=0.5):
    """A stage-1 state of 150 surfels on a sphere (inward normals) in 192
    capacity rows, 22 of them dead, as numpy."""
    rng = np.random.default_rng(31)
    d = rng.standard_normal((400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[d[:, 2] < 1 - pole_gap][:150]
    st = TG.init_from_points(d * 0.3, rng.random((150, 3)).astype(np.float32),
                             normals=-d, capacity=192, rotation_init="normal",
                             device="cpu")
    p = TG.params_to_numpy(st["params"])
    p["opacity"] = np.where(np.arange(192)[:, None] < 150,
                            rng.normal(size=(192, 1)) + 1.0,
                            -10.0).astype(np.float32)
    p["shs_rest"] = (0.2 * rng.normal(size=p["shs_rest"].shape)).astype(
        np.float32)
    alive = np.arange(192) < 150
    alive[rng.choice(150, 22, replace=False)] = False
    return p, alive


def test_bake_radiance_compact_matches_jax():
    """Alive rows baked, dead rows filled, hit ids mapped to capacity
    rows."""
    p, alive = _compact_params()
    key = jax.random.PRNGKey(3)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    bj = jtrainer.bake_radiance_compact(jp, jnp.asarray(alive), sample_num=8,
                                        key=key, k_hits=8)
    n_alive = int(alive.sum())
    az = torch.as_tensor(np.array(jax.random.uniform(key, (n_alive, 1))))
    bt = ttrainer.bake_radiance_compact(
        TG.params_from_jax(p, device="cpu"), torch.as_tensor(alive),
        sample_num=8, azimuth=az, k_hits=8)
    assert_bakes_equal(bj, bt)
    hit = bt["hit_idx"].numpy()
    assert (hit >= 0).sum() > 50
    assert alive[hit[hit >= 0]].all()          # hits are alive rows
    dead = ~alive
    assert (hit[dead] == -1).all()
    assert (bt["visibility"].numpy()[dead] == 1).all()
    # the dead rows' equirect coordinates are those of their (zero) dirs
    from svgir_tpu_torch.models.lights import equirect_grid_coords
    qx, qy = equirect_grid_coords(bt["incident_dirs"])
    assert torch.equal(bt["incident_qxy"], torch.stack([qx, qy], -1))


def test_bake_radiance_compact_rebakes_exhausted_rays(capsys, monkeypatch):
    """Concentric shells of big opaque surfels exhaust a 2-hit list: the
    bake warns and runs again with k doubled (tests/test_guards.py::
    test_bake_exhausted_auto_raises_k_hits); the result is the bake at
    the final k."""
    rng = np.random.default_rng(2)
    pts = []
    for r in (0.2, 0.35, 0.5, 0.65, 0.8, 0.95):
        d = rng.standard_normal((40, 3)).astype(np.float32)
        pts.append(d / np.linalg.norm(d, axis=1, keepdims=True) * r)
    pts = np.concatenate(pts)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    st = TG.init_from_points(pts, np.full_like(pts, 0.5), normals=nrm,
                             capacity=240, rotation_init="normal",
                             device="cpu")
    p = dict(st["params"])
    p["scaling"] = torch.full_like(p["scaling"], math.log(0.3))
    p["scaling"][:, 2] = -20.0
    p["opacity"] = torch.full_like(p["opacity"], 3.0)
    az = torch.rand(240, 1, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(ttrainer, "MAX_K_HITS", 32)
    bake = ttrainer.bake_radiance_compact(p, st["alive"], sample_num=8,
                                          azimuth=az, k_hits=2)
    out = capsys.readouterr().out
    assert "exhausted the 2-hit list; re-baking with k_hits=4" in out, out
    assert float(bake["exhausted_frac"]) <= 0.01 or "max reached" in out
    assert bake["radiance"].shape == (240, 8, 3)
    final_k = 2
    while f"re-baking with k_hits={final_k * 2}" in out:
        final_k *= 2
    monkeypatch.setattr(ttrainer, "MAX_K_HITS", final_k)
    again = ttrainer.bake_radiance_compact(p, st["alive"], sample_num=8,
                                           azimuth=az, k_hits=final_k)
    assert torch.equal(again["hit_idx"], bake["hit_idx"])
