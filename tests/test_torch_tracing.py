"""svgir_tpu_torch.ops.tracing against svgir_tpu.ops.tracing on the CPU:
the surfel geometry, the hit test with the reference's uv swap, the brute
K-nearest-hit tracer and the radiance march.

Inputs come from numpy seeds and go to both packages.  Hits are compared
on finite slots: idx equal, t / alpha / uv within 1e-5.

Scenes.  For thin surfels (z scale ~0) the hit test's power is float32
rounding noise (ROADMAP C-1), and XLA on the CPU contracts its products
and sums into fused multiply-adds while the port rounds each operation:
on the thin scene of tests/test_grid_tracer.py only 252 of the JAX
package's 427 hits survive a separately rounded evaluation.  So the
packages are held to each other on well-conditioned surfels (z scale half
the in-plane scale, as after ``init_from_points``, whose scales are
isotropic), and the thin scenes are held within the port (grid march
against brute force, tests/test_torch_grid_tracer.py and
tests/test_torch_bake.py), where one order of evaluation serves both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.ops import tracing as JTR
from svgir_tpu.utils.transforms import normal_to_rotation as j_n2r

from svgir_tpu_torch.ops import tracing as TTR


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


def unit(rng, n):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def sphere_scene(n=300, seed=0, radius=0.5, scale=0.08, z_frac=0.5,
                 pole_gap=None):
    """Surfels on a sphere facing its centre, opacity in [0.3, 0.9], as
    numpy float32 (means, scales, quats, opacity).  ``pole_gap`` drops
    surfels whose normal lies within acos(1 - pole_gap) of -z, where
    ``rotation_between_z`` divides by 1 + n_z: there the packages' 6e-7
    rotation difference grows to 3e-5 in the incident directions."""
    rng = np.random.default_rng(seed)
    dirs = unit(rng, n)
    if pole_gap is not None:
        dirs = dirs[dirs[:, 2] < 1 - pole_gap]      # normal = -dirs
    quats = np.array(j_n2r(jnp.asarray(-dirs)), np.float32)
    m = len(dirs)
    scales = np.full((m, 3), scale, np.float32)
    scales[:, 2] = scale * z_frac
    opac = rng.uniform(0.3, 0.9, m).astype(np.float32)
    return (dirs * radius).astype(np.float32), scales, quats, opac


def rays(n=64, seed=1, spread=0.02):
    rng = np.random.default_rng(seed)
    return (spread * rng.standard_normal((n, 3))).astype(np.float32), \
        unit(rng, n)


def geometries(scene, valid=None):
    """(JAX geometry, port geometry) of numpy (means, scales, quats,
    opacity)."""
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.as_tensor(valid)
    return (JTR.build_surfel_geometry(*map(jnp.asarray, scene), valid=jv),
            TTR.build_surfel_geometry(*map(torch.as_tensor, scene),
                                      valid=tv))


def assert_hits_equal(hj, ht, tol=TOL):
    """Finite slots equal in idx, t / alpha / uv within ``tol``."""
    tj = np.asarray(hj["t"])
    fin = np.isfinite(tj)
    np.testing.assert_array_equal(fin, torch.isfinite(ht["t"]).numpy())
    np.testing.assert_array_equal(np.asarray(hj["idx"])[fin],
                                  ht["idx"].numpy()[fin])
    for k in ("t", "alpha", "uv"):
        if k in hj and k in ht:
            np.testing.assert_allclose(ht[k].numpy()[fin],
                                       np.asarray(hj[k])[fin], atol=tol,
                                       err_msg=k)
    return int(fin.sum())


@pytest.mark.parametrize("z_frac", [0.5, 1e-8], ids=["thick", "thin"])
def test_build_surfel_geometry_matches_jax(z_frac):
    scene = sphere_scene(n=200, z_frac=z_frac)
    valid = np.arange(200) % 7 != 3
    jg, tg = geometries(scene, valid)
    for f in ("means", "scales", "opacity", "valid"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    for f in ("rot", "normal"):
        np.testing.assert_allclose(getattr(tg, f).numpy(),
                                   np.asarray(getattr(jg, f)), atol=1e-6)
    # up to 1e12 on thin surfels (1/s clamped at 1e6): relative per surfel
    ic_j = np.asarray(jg.inv_cov, np.float64)
    err = np.abs(tg.inv_cov.numpy() - ic_j).max(1) / np.abs(ic_j).max(1)
    assert err.max() < 1e-5, err.max()


def test_ellipse_uv_matches_jax_including_the_swap():
    """The plane hit, the ellipse metric and the uv with the reference's
    u < v swap (intersect_test.slang:94-150)."""
    scene = sphere_scene(n=40, seed=3)
    jg, tg = geometries(scene)
    o, d = rays(16, seed=4)
    uv_j, dis_j, t_j = JTR._ellipse_uv(jg, jnp.asarray(o), jnp.asarray(d),
                                       None)
    t_t, dis_t, _, _, _, u, v = TTR.surfel_test(
        tg.means, tg.normal, tg.rot, tg.scales, tg.inv_cov, tg.opacity,
        torch.as_tensor(o)[:, None], torch.as_tensor(d)[:, None])
    uv_t = TTR.swapped_uv(u, v)
    assert bool((u < v).any()) and bool((u > v).any())
    # grazing rays (|n.d| small) put the plane hit far away, where the
    # packages' 6e-7 difference in the normal is amplified
    ahead = np.abs(np.asarray(t_j)) < 5
    np.testing.assert_allclose(t_t.numpy()[ahead], np.asarray(t_j)[ahead],
                               rtol=1e-5, atol=1e-5)
    near = np.asarray(dis_j) < 100        # far off the ellipse dis is huge
    np.testing.assert_allclose(dis_t.numpy()[near], np.asarray(dis_j)[near],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=TOL)


@pytest.mark.parametrize("self_hit", [False, True], ids=["plain", "self"])
def test_nearest_hits_matches_jax(self_hit):
    scene = sphere_scene()
    jg, tg = geometries(scene)
    o, d = rays()
    si = np.arange(64, dtype=np.int32) * 3 if self_hit else None
    hj = JTR.nearest_hits(jg, jnp.asarray(o), jnp.asarray(d),
                          None if si is None else jnp.asarray(si), k=8)
    ht = TTR.nearest_hits(tg, torch.as_tensor(o), torch.as_tensor(d),
                          None if si is None else torch.as_tensor(si),
                          chunk=128, k=8)
    assert assert_hits_equal(hj, ht) > 300
    if self_hit:
        assert not (ht["idx"].numpy() == si[:, None]).any()


def _walls(z, opacity, scale=0.5):
    """Flat surfels at (0, 0, z_i) facing -z (tests/test_tracing.py)."""
    n = len(z)
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = z
    quats = np.tile(np.array([[0.0, 1, 0, 0]], np.float32), (n, 1))
    scales = np.tile(np.array([[scale, scale, 1e-9]], np.float32), (n, 1))
    return means, scales, quats, np.asarray(opacity, np.float32)


@pytest.mark.parametrize("case", [
    # windows [0.042, 0.2], then [t+0.01, t+0.2]: .1 and .15 composite,
    # the gap to .5 stops the march
    dict(z=[0.1, 0.15, 0.5], op=[0.5, 0.6, 0.7], o=[0.01, 0, 0], self=-5),
    # a wall at 0.02 < 0.042 is skipped
    dict(z=[0.02, 0.1], op=[0.9, 0.5], o=[0, 0, 0], self=-5),
    # the source surfel is the nearest hit: the march stops
    dict(z=[0.1, 0.3], op=[0.5, 0.5], o=[0, 0, 0], self=0),
    # saturation: T <= 0.001 ends the march, T < 0.2 clears visibility
    dict(z=[0.06, 0.1, 0.14, 0.18], op=[0.99, 0.99, 0.99, 0.9],
         o=[0.02, -0.01, 0], self=-5),
], ids=["windows", "skip_near", "self_hit", "saturate"])
def test_radiance_march_matches_jax_on_walls(case):
    scene = _walls(case["z"], case["op"])
    n = len(case["z"])
    jg, tg = geometries(scene)
    rng = np.random.default_rng(5)
    shs = (0.5 * rng.standard_normal((n, 16, 3))).astype(np.float32)
    o = np.array([case["o"]], np.float32)
    d = np.array([[0.0, 0, 1.0]], np.float32)
    si = np.array([case["self"]], np.int32)
    hj = JTR.nearest_hits(jg, jnp.asarray(o), jnp.asarray(d), k=4)
    ht = TTR.nearest_hits(tg, torch.as_tensor(o), torch.as_tensor(d), k=4)
    assert_hits_equal(hj, ht)
    rj = JTR.radiance_march(hj, jnp.asarray(si), jnp.asarray(shs),
                            jnp.asarray(scene[0]), jnp.asarray(o))
    rt = TTR.radiance_march(ht, torch.as_tensor(si), torch.as_tensor(shs),
                            torch.as_tensor(scene[0]), torch.as_tensor(o))
    _assert_march_equal(rj, rt)


def _assert_march_equal(rj, rt):
    for k in ("first_hit", "exhausted"):
        np.testing.assert_array_equal(rt[k].numpy(), np.asarray(rj[k]), k)
    for k in ("radiance", "visibility", "first_uv"):
        np.testing.assert_allclose(rt[k].numpy(), np.asarray(rj[k]),
                                   atol=TOL, err_msg=k)


def test_radiance_march_matches_jax_on_jax_hits():
    """The march alone, on the JAX package's own hit lists of a sphere
    scene (inward rays from surfels, some exhausting k = 4)."""
    scene = sphere_scene(n=120, seed=6, scale=0.15)
    means = scene[0]
    jg, _ = geometries(scene)
    rng = np.random.default_rng(7)
    src = rng.integers(0, len(means), 256).astype(np.int32)
    o = means[src]
    d = unit(rng, 256)
    d = np.where((d * -o).sum(1, keepdims=True) < 0, -d, d)   # inward
    hj = JTR.nearest_hits(jg, jnp.asarray(o), jnp.asarray(d), k=4)
    ht = {k: torch.as_tensor(np.array(v)) for k, v in hj.items()}
    shs = (0.5 * rng.standard_normal((len(means), 16, 3))).astype(np.float32)
    rj = JTR.radiance_march(hj, jnp.asarray(src), jnp.asarray(shs),
                            jnp.asarray(means), jnp.asarray(o))
    rt = TTR.radiance_march(ht, torch.as_tensor(src), torch.as_tensor(shs),
                            torch.as_tensor(means), torch.as_tensor(o))
    _assert_march_equal(rj, rt)
    assert int(rt["exhausted"].sum()) > 0 and int((rt["first_hit"] >= 0).sum())
