"""The port's visibility tracers and ``finetune_visibility`` on the CPU,
against svgir_tpu.

* ``tracing.trace_visibility`` (brute force: the max-density point along
  the ray, no ellipse test) and ``grid_tracer.trace_visibility_grid``
  (``_test_candidates``' acceptance: plane hit, ellipse, alpha >= 1/255,
  the step's span) are different functions in the reference; each is held
  to its JAX twin: visibility within 1e-5 and contribute equal.
* Visibility is exp(sum log(1 - alpha)) set to 0 below 0.9, so a T near
  0.9 flips between 0 and ~0.9 with the last bits of the sum.  Only rays
  whose JAX T (the reference's own pair terms, summed here) lies at least
  1e-3 clear of 0.9 are compared, and they must be nearly all of them.
  In ``finetune_visibility`` a surfel's SH moves with its own rays' targets
  only, so the surfels compared are those whose rays were clear in every
  iteration.
* Thin surfels (z scale ~0) make the power float32 noise that XLA's fused
  multiply-adds round otherwise (ROADMAP hazard 1): on the thin scene of
  tests/test_grid_tracer.py only visibility is compared with JAX (every
  ray is occluded there), and the port's grid is held to the port's
  brute tracer as the JAX test holds its own (1e-5).
* ``finetune_visibility``: 6 iterations with JAX's draws against JAX
  (brute and grid), and the occluder fit of
  tests/test_finetune_visibility.py on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.models import gaussians as JG
from svgir_tpu.ops import grid_tracer as JGT
from svgir_tpu.ops import tracing as JTR
from svgir_tpu.utils.transforms import normalize as j_normalize

from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.ops import grid_tracer as TGT
from svgir_tpu_torch.ops import tracing as TTR
from svgir_tpu_torch.utils.sh import eval_sh
from svgir_tpu_torch.utils.transforms import normal_to_rotation

from test_torch_grid_tracer import grid_scene, port_geo
from test_torch_tracing import geometries, rays, sphere_scene, unit

TOL = 1e-5
CLEAR = 1e-3          # a compared ray's T lies this far from the 0.9 cut


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_t_brute(geo, o, d):
    """T of the JAX brute tracer: its own pair terms and mask, summed."""
    terms = JTR._pair_terms(geo, o, d, slice(None))
    ok = (geo.valid[None] & (geo.opacity[None] >= JTR.ALPHA_MIN)
          & (jnp.sum(geo.normal[None] * d[:, None], -1) <= 0)
          & (terms["t"] >= 0.01) & (terms["power"] <= 0))
    a = jnp.where(ok, terms["alpha"], 0.0)
    return np.exp(np.asarray(jnp.sum(jnp.log1p(-jnp.minimum(
        a, JTR.ALPHA_MAX)), 1), np.float64))


def jax_t_grid(geo, o, d, t_hi):
    """T of the JAX grid tracer: ``_test_candidates`` over every surfel in
    [0.01, t_hi) (the grid lists every surfel a step's span can accept)."""
    r, n = o.shape[0], geo.means.shape[0]
    ids = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (r, n))
    cand = JGT._test_candidates(geo, ids, o, d, jnp.full((r,), 0.01),
                                jnp.full((r,), t_hi))
    ok = (cand["valid"] & (cand["opacity"] >= JTR.ALPHA_MIN)
          & jnp.isfinite(cand["t"]))
    a = jnp.where(ok, jnp.minimum(cand["alpha"], JTR.ALPHA_MAX), 0.0)
    return np.exp(np.asarray(jnp.sum(jnp.log1p(-a), 1), np.float64))


def clear_of_cut(t_ref):
    return np.abs(t_ref - 0.9) >= CLEAR


def grids(jgeo, tgeo):
    """(JAX grid, port grid, n_steps, dt) at the reference's resolution."""
    res = JGT.auto_res(jgeo)
    jg = JGT.build_grid_auto(jgeo, res=res)
    tg = TGT.build_grid_auto(tgeo, res=res)
    return jg, tg, res


def compare(vj, vt, *, rows=slice(None), counts=True):
    np.testing.assert_allclose(vt["visibility"].numpy()[rows],
                               np.asarray(vj["visibility"])[rows], atol=TOL)
    if counts:
        np.testing.assert_array_equal(vt["contribute"].numpy()[rows],
                                      np.asarray(vj["contribute"])[rows])


# ---- tests/test_tracing.py's walls, brute tracer ------------------------

def wall(z, opacity=0.8, scale=0.5):
    """A flat surfel at (0, 0, z) facing -z, as numpy."""
    return (np.array([[0.0, 0.0, z]], np.float32),
            np.array([[scale, scale, 1e-9]], np.float32),
            np.array([[0.0, 1.0, 0.0, 0.0]], np.float32),
            np.array([opacity], np.float32))


@pytest.mark.parametrize("scene,o,d,want", [
    (wall(1.0, opacity=0.05), [0, 0, 0.05], [0, 0, 1.0], 0.95),
    (wall(1.0, opacity=0.8), [0, 0, 0.05], [0, 0, 1.0], 0.0),
    (wall(-1.0, opacity=0.9), [0, 0, -0.05], [0, 0, -1.0], 1.0),
    (wall(1.0, opacity=0.9, scale=0.1), [5.0, 5.0, 0], [0, 0, 1.0], 1.0)],
    ids=["single_blocker", "opaque_blocker", "backface", "miss"])
def test_walls_brute_matches_jax(scene, o, d, want):
    jg, tg = geometries(scene)
    o, d = np.array([o], np.float32), np.array([d], np.float32)
    vj = JTR.trace_visibility(jg, jnp.asarray(o), jnp.asarray(d))
    vt = TTR.trace_visibility(tg, torch.as_tensor(o), torch.as_tensor(d))
    assert abs(float(vt["visibility"][0, 0]) - want) < 1e-5
    assert clear_of_cut(jax_t_brute(jg, jnp.asarray(o), jnp.asarray(d)))[0]
    compare(vj, vt)


# ---- sphere scenes, both tracers ----------------------------------------

def faint_sphere():
    """Well-conditioned surfels (z scale half the in-plane one) facing the
    centre, faint enough (opacity 0.004-0.06) that rays from near the
    centre keep T on both sides of 0.9."""
    means, scales, quats, _ = sphere_scene(n=300, seed=2, scale=0.08)
    opac = np.random.default_rng(5).uniform(0.004, 0.06, 300)
    return means, scales, quats, opac.astype(np.float32)


@pytest.mark.parametrize("tracer", ["brute", "grid"])
@pytest.mark.parametrize("scene", ["faint", "thin"])
def test_visibility_matches_jax(tracer, scene):
    if scene == "faint":
        jg, tg = geometries(faint_sphere(), valid=np.arange(300) % 9 != 4)
    else:
        jg = grid_scene()
        tg = port_geo(jg)
    o, d = rays(256, seed=7)
    o = o + 0.05 * d
    oj, dj = jnp.asarray(o), jnp.asarray(d)
    ot, dt_ = torch.as_tensor(o), torch.as_tensor(d)
    if tracer == "brute":
        t_ref = jax_t_brute(jg, oj, dj)
        vj = JTR.trace_visibility(jg, oj, dj)
        vt = TTR.trace_visibility(tg, ot, dt_, chunk=128)
    else:
        jgrid, tgrid, res = grids(jg, tg)
        n_steps = JGT._concrete_n_steps(jgrid, 2.0)
        assert TGT._concrete_n_steps(tgrid, 2.0) == n_steps
        step = float(TGT.grid_dt(tgrid))
        t_ref = jax_t_grid(jg, oj, dj, min(2.0, n_steps * step))
        vj = JGT.trace_visibility_grid(jg, jgrid, oj, dj, t_max=2.0,
                                       n_steps=n_steps)
        vt = TGT.trace_visibility_grid(tg, tgrid, ot, dt_, t_max=2.0,
                                       n_steps=n_steps)
    rows = clear_of_cut(t_ref)
    assert rows.mean() > 0.95, rows.mean()
    seen = np.asarray(vj["visibility"])[rows, 0] > 0
    if scene == "faint":
        assert 30 < seen.sum() < 220, seen.sum()   # both sides of the cut
    compare(vj, vt, rows=rows, counts=scene == "faint")


def test_port_grid_matches_port_brute_on_the_thin_scene():
    """tests/test_grid_tracer.py::test_grid_matches_brute's visibility
    assertion, within the port."""
    tg = port_geo(grid_scene())
    res = TGT.auto_res(tg)
    grid = TGT.build_grid(tg, res=res, cell_cap=128, span_cap=128)
    assert not grid.overflow
    o, d = rays(64, seed=3)
    vb = TTR.trace_visibility(tg, torch.as_tensor(o + 0.05 * d),
                              torch.as_tensor(d))
    vg = TGT.trace_visibility_grid(tg, grid, torch.as_tensor(o + 0.05 * d),
                                   torch.as_tensor(d), n_steps=4 * res)
    np.testing.assert_allclose(vg["visibility"].numpy(),
                               vb["visibility"].numpy(), atol=TOL)


def test_count_occupied_steps_matches_jax():
    jg, tg = geometries(sphere_scene(n=300, seed=1))
    jgrid, tgrid, res = grids(jg, tg)
    o, d = rays(128, seed=8)
    cj = JGT.count_occupied_steps(jgrid, jnp.asarray(o), jnp.asarray(d),
                                  t_max=2.0, n_steps=3 * res)
    ct = TGT.count_occupied_steps(tgrid, torch.as_tensor(o),
                                  torch.as_tensor(d), t_max=2.0,
                                  n_steps=3 * res)
    assert int(np.asarray(cj).min()) > 0
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


# ---- finetune_visibility ------------------------------------------------

def finetune_state(n=160, cap=176, seed=11):
    """A PBR state of surfels on a sphere facing the centre (scales as
    ``init_from_points`` makes them: isotropic), opacity in [0.3, 0.9],
    some visibility SH, ``cap - n`` dead rows; as JAX and port states."""
    rng = np.random.default_rng(seed)
    dirs = unit(rng, cap)
    state = G.upgrade_to_pbr(G.init_from_points(
        torch.as_tensor(dirs * 0.5), torch.full((cap, 3), 0.5),
        normals=torch.as_tensor(-dirs), capacity=cap,
        rotation_init="normal", device="cpu"))
    p = state["params"]
    p["scaling"] = torch.full((cap, 3), float(np.log(0.06)))
    p["opacity"] = torch.as_tensor(np.log(1 / rng.uniform(0.3, 0.9, (cap, 1))
                                          - 1).astype(np.float32)) * -1
    p["visibility_dc"] = torch.as_tensor(
        0.1 * rng.standard_normal((cap, 1, 1)).astype(np.float32))
    p["visibility_rest"] = torch.as_tensor(
        0.05 * rng.standard_normal((cap, 15, 1)).astype(np.float32))
    state["alive"] = torch.arange(cap) < n
    jstate = {"params": {k: jnp.asarray(v.numpy()) for k, v in p.items()},
              "alive": jnp.asarray(state["alive"].numpy())}
    return state, jstate


def jax_draws(key, iterations, n):
    """The raw normal draws of the JAX loop, iteration by iteration."""
    out = []
    for _ in range(iterations):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (n, 3))))
    return np.stack(out)


@pytest.mark.parametrize("use_grid", [False, True], ids=["brute", "grid"])
def test_finetune_visibility_matches_jax(use_grid):
    iters = 6
    state, jstate = finetune_state()
    cap = state["alive"].shape[0]
    draws = jax_draws(jax.random.PRNGKey(3), iters, cap)

    # the surfels whose target T was clear of the cut in every iteration
    jp = jstate["params"]
    geo = JTR.build_surfel_geometry(
        jp["xyz"], JG.get_scaling(jp), JG.get_rotation(jp),
        jnp.where(jstate["alive"], JG.get_opacity(jp)[:, 0], 0.0),
        valid=jstate["alive"])
    nrm = JG.get_geo_normal(jp)
    if use_grid:
        jgrid = JGT.build_grid_auto(geo, res=JGT.auto_res(geo))
        diag = float(np.linalg.norm(np.asarray(jp["xyz"]).max(0)
                                    - np.asarray(jp["xyz"]).min(0))) + 1e-3
        n_steps = JGT._concrete_n_steps(jgrid, diag)
        t_hi = min(diag, n_steps * float(np.min(
            1.0 / np.asarray(jgrid.inv_cell))) * 0.5)
    rows = np.ones(cap, bool)
    for raw in draws:
        d = j_normalize(jnp.asarray(raw))
        d = jnp.where(jnp.sum(d * nrm, -1, keepdims=True) < 0, -d, d)
        o = jp["xyz"] + 0.05 * d
        t = jax_t_grid(geo, o, d, t_hi) if use_grid else \
            jax_t_brute(geo, o, d)
        rows &= clear_of_cut(t)
    assert rows.mean() > 0.95, rows.mean()

    out_j = JG.finetune_visibility(jstate, iterations=iters, lr=1e-2,
                                   key=jax.random.PRNGKey(3),
                                   use_grid=use_grid)
    out_t = G.finetune_visibility(state, iterations=iters, lr=1e-2,
                                  directions=torch.as_tensor(draws),
                                  use_grid=use_grid)
    for k in ("visibility_dc", "visibility_rest"):
        np.testing.assert_allclose(out_t["params"][k].numpy()[rows],
                                   np.asarray(out_j["params"][k])[rows],
                                   atol=2e-5, err_msg=k)
        assert not np.allclose(out_t["params"][k].numpy(),
                               state["params"][k].numpy())
    for k in ("xyz", "scaling", "opacity"):
        assert out_t["params"][k] is state["params"][k]


def test_finetune_visibility_fits_occlusion():
    """tests/test_finetune_visibility.py on the port: base points under an
    opaque ceiling learn to see darkness upward, and the fit generalises
    to fresh directions (held-out L1 < 0.15)."""
    n_base = 48
    rng = np.random.default_rng(0)
    base = np.concatenate([rng.uniform(-0.5, 0.5, (n_base, 2)),
                           np.zeros((n_base, 1))], 1)
    pts = torch.as_tensor(np.concatenate([base, [[0.0, 0.0, 1.0]]])
                          .astype(np.float32))
    normals = torch.as_tensor(np.concatenate(
        [np.repeat([[0.0, 0.0, 1.0]], n_base, 0), [[0.0, 0.0, -1.0]]])
        .astype(np.float32))
    n = n_base + 1
    state = G.upgrade_to_pbr(G.init_from_points(
        pts, torch.full((n, 3), 0.5), normals=normals, capacity=n,
        rotation_init="normal", device="cpu"))
    quats = normal_to_rotation(normals)
    quats[-1] = torch.tensor([0.0, 1.0, 0.0, 0.0])   # pi about x: -z
    scales = torch.cat([torch.full((n_base, 2), 0.05),
                        torch.zeros(n_base, 1)], 1)
    scales = torch.cat([scales, torch.tensor([[3.0, 3.0, 0.0]])])
    opac = torch.full((n,), 0.995)
    p = state["params"]
    p["scaling"] = torch.log(torch.clamp(scales, min=1e-7))
    p["rotation"] = quats
    p["opacity"] = torch.log(opac / (1 - opac))[:, None]

    out = G.finetune_visibility(state, iterations=150, lr=3e-2,
                                generator=torch.Generator().manual_seed(1),
                                use_grid=False)
    sh = torch.cat([out["params"]["visibility_dc"],
                    out["params"]["visibility_rest"]], 1).transpose(1, 2)
    up = torch.tensor([[0.0, 0.0, 1.0]]).expand(n, 3)
    pred_up = torch.clamp(eval_sh(3, sh, up) + 0.5, 0, 1)
    assert float(pred_up[:-1].mean()) < 0.3, float(pred_up[:-1].mean())

    g = torch.Generator().manual_seed(99)
    d = torch.randn(n, 3, generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d = torch.where((d * normals).sum(-1, keepdim=True) < 0, -d, d)
    geo = TTR.build_surfel_geometry(out["params"]["xyz"], scales, quats,
                                    opac)
    tr = TTR.trace_visibility(geo, out["params"]["xyz"] + 0.05 * d, d)
    pred = torch.clamp(eval_sh(3, sh, d) + 0.5, 0, 1)
    l1 = float((pred - tr["visibility"]).abs().mean())
    assert l1 < 0.15, l1
    for k in ("xyz", "scaling", "opacity"):
        assert torch.equal(out["params"][k], state["params"][k])
