"""The parallel paths of svgir_tpu_torch (``parallel/{comm,dp,gshard}.py``)
on gloo ranks against svgir_tpu's on its 8-device CPU mesh, each
collective's written-out backward against the single-device gradient, and
``render_svgss``'s ``mean2d_offset``.

The ranks run in spawned processes (``tests/torch_parallel_ranks.py``,
which imports no JAX) that join through a ``file://`` store under the
module's temporary directory.  One session of 8 ranks runs every 8-rank
case's job (one spawn for them all: each rank takes about 3 s to start)
while the JAX side computes in this process on conftest's 8 virtual
devices, in interpret mode as ``tests/test_parallel.py`` runs it; a second
session of 2 ranks holds uneven bands to the port's own single-device
render.  Inputs come from ``tests/scenes.py`` and the JAX package's
initializers and travel as numpy arrays.

Tolerances (float32 on the CPU in both packages):
- sharded images: color, opacity, feature and vfeature 1e-4, depth 1e-3,
  weights 1e-4 plus 1e-5 relative (sums over up to ~100 pixels, in
  another order: on the balanced-rows scene a weight of ~90 differs by
  1.4e-4, 2e-6 relative; tests/test_torch_rasterizer.py holds the
  single-device weights to 1e-5 plus 1e-5 relative), against JAX's
  sharded render and the port's own single-device render at strip 0 (the
  tile-major blend, as the sharded path blends);
- the collectives: 1e-6;
- gradients with respect to the means: 5e-4 of the largest element of
  JAX's single-device gradient;
- the DP steps: Adam's first moment (linear in the averaged gradient) 5e-4
  of its largest element; loss and psnr 1e-5 relative; parameters within
  lr where the gradient is below 1e-6 of its largest (Adam's first step
  moves them by lr * sign(g), and a sign may differ) and 1e-5 relative
  elsewhere; the summed densification statistics: denom and max_radii2d
  equal, the weight sums 1e-5 of their largest, the screen-gradient norms
  5e-4 of theirs, as gradients.  The stage-2 step holds the env map and
  the base colour so; its other groups' moments 2.5e-3, as
  tests/test_torch_svgss.py holds the single-device step's gradients
  (hazard 8: on this scene the reference's float32 xyz gradient lies
  1.3e-3 of its largest from the port's).  Every rank's
  parameters, moments and statistics are bit-equal to rank 0's.
- the sharded bake: hit_idx equal, radiance 1e-5;
- ``render_svgss(mean2d_offset=...)``: the image 1e-5, the offset
  gradient 5e-4 of its largest, the loss 2e-5 relative (its surface term
  compares the normals with the depth's finite-difference normal).

Reference gaps these tests allow for (ROADMAP hazards): the azimuth draws
are JAX's, passed to the port (4); only rows of real instances are
compared, never buffers the reference leaves unwritten (5); summation
orders differ between gloo's ring and XLA's all-reduce, hence tolerances
where the reference is not bit-stable (6, 7); the DP path sums
``max_radii2d`` over the views where single-view steps take the max, in
both packages, and the test holds the port to that sum (11).
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.models import gaussians as JG
from svgir_tpu.models import lights as JLT
from svgir_tpu.ops.rasterizer import rasterize as j_rasterize
from svgir_tpu.parallel import dp as jdp
from svgir_tpu.parallel import gshard as jgs
from svgir_tpu.render.svgss import render_svgss as j_render_svgss
from svgir_tpu.train import optim as joptim
from svgir_tpu.train.trainer import strip_meta
from svgir_tpu.utils.transforms import normalize as j_normalize

from svgir_tpu_torch.config import OptimizationConfig as TOpt
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.parallel import gshard as tgs
from svgir_tpu_torch.render.svgss import render_svgss as t_render_svgss

from tests import torch_parallel_ranks as ranks
from tests.scenes import default_camera, sphere_scene
from test_torch_tracing import sphere_scene as tracing_sphere

MAX_INST = 1 << 14
CFG = JCfg(max_instances=MAX_INST)
BG = np.array([0.1, 0.2, 0.3], np.float32)
IMG_FIELDS = ("color", "opacity", "feature", "vfeature", "depth", "weights")
IMG_TOL = {"depth": 1e-3}
XYZ_LR = 1e-4
STAGE1 = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
          "opacity")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops in this process (the svgss case); one thread
    for the module, as the other port test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cam_spec(width, height):
    return dict(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                fov=math.pi / 3, width=width, height=height)


def scene_arrays(sc, bg=BG, means=None):
    out = {k: np.asarray(sc[k]) for k in ("means", "scales", "quats",
                                          "opacity", "colors")}
    for k in ("features", "vfeatures"):
        if sc[k] is not None:
            out[k] = np.asarray(sc[k])
    if means is not None:
        out["means"] = np.asarray(means)
    out["bg"] = np.asarray(bg, np.float32)
    return out


def prefixed(prefix, arrays):
    return {f"{prefix}{k}": v for k, v in arrays.items()}


# ---- inputs shared by both packages -------------------------------------

@functools.lru_cache(maxsize=None)
def image_scene():
    return sphere_scene(jax.random.PRNGKey(0), n=128, s_feat=2, vs_feat=8)


@functools.lru_cache(maxsize=None)
def grad_scene():
    return sphere_scene(jax.random.PRNGKey(1), n=64)


@functools.lru_cache(maxsize=None)
def skewed_scene():
    """tests/test_parallel.py's balanced-rows scene: skewed downward so the
    bottom tile rows carry most instances; 128 x 256 at tile 16."""
    sc = sphere_scene(jax.random.PRNGKey(0), n=256, s_feat=2, vs_feat=8)
    means = sc["means"].at[:, 1].add(-0.45 * jnp.abs(sc["means"][:, 0]) - 0.3)
    return sc, means


@functools.lru_cache(maxsize=None)
def ring_cameras():
    """The JAX DP tests' 8 cameras, with their random target images."""
    from svgir_tpu.cameras import look_at_camera
    cams, images = [], []
    for i, s in enumerate(ranks.ring_specs()):
        img = np.asarray(jax.random.uniform(jax.random.PRNGKey(i),
                                            (3, 32, 32)))
        images.append(img)
        cam = look_at_camera(eye=s["eye"], target=s["target"], up=s["up"],
                             fovx=s["fov"], fovy=s["fov"], width=32,
                             height=32)
        cams.append(dataclasses.replace(
            strip_meta(cam), image=jnp.asarray(img),
            image_mask=jnp.ones((1, 32, 32))))
    return cams, np.stack(images)


def dp1_state():
    n = 64
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(0), (n, 3)))
    return JG.init_from_points(dirs, jnp.full((n, 3), 0.6), normals=dirs,
                               capacity=n, rotation_init="normal")


def dp2_state():
    n = 64
    dirs = j_normalize(jax.random.normal(jax.random.PRNGKey(3), (n, 3)))
    state = JG.init_from_points(dirs * 0.8, jnp.full((n, 3), 0.6),
                                normals=dirs, capacity=n,
                                rotation_init="normal")
    return JG.upgrade_to_pbr(state)


def state_arrays(state):
    p = jax.device_get(state["params"])
    return {**prefixed("p_", {k: np.asarray(v) for k, v in p.items()}),
            "alive": np.asarray(state["alive"])}


BAKE_KEY = 5
ENV_KEY = 6
INWARD_KEY = 8


@functools.lru_cache(maxsize=None)
def inward_scene():
    """tests/test_torch_bake.py's well-conditioned surfels facing the centre
    of a small sphere (hazard 1: thin surfels make the hit test's rounding
    differ), whose hemisphere rays hit: (means, scales, quats, opacity,
    shs) as numpy, and JAX's azimuth draws."""
    scene = tracing_sphere(n=260, seed=21, radius=0.25, scale=0.08,
                           pole_gap=0.5)
    n = len(scene[0]) // 8 * 8      # JAX's sharded reshape needs D | N
    scene = tuple(x[:n] for x in scene)
    shs = (0.3 * np.random.default_rng(7).standard_normal((n, 16, 3))
           ).astype(np.float32)
    az = np.asarray(jax.random.uniform(jax.random.PRNGKey(INWARD_KEY),
                                       (n, 1)))
    return scene + (shs,), az


def env_state():
    return JLT.direct_light_map_init(jax.random.PRNGKey(ENV_KEY), h=8,
                                     light_init=JOpt().light_init)


@pytest.fixture(scope="module")
def skew():
    sc, means = skewed_scene()
    cfg = JCfg(max_instances=MAX_INST, tile=16)
    cam = default_camera(128, 256)
    hist = jgs.row_instance_histogram(means, sc["scales"], sc["quats"],
                                      sc["opacity"], cam, cfg=cfg)
    starts = jgs.balanced_row_starts(hist, 8)
    return dict(sc=sc, means=means, cfg=cfg, cam=cam, hist=np.asarray(hist),
                starts=starts)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory, skew):
    """One session of 8 gloo ranks running every 8-rank case's job; started
    before the JAX side computes."""
    _, images = ring_cameras()
    env = env_state()
    n2 = 64
    arrays = {
        **prefixed("img/", scene_arrays(image_scene())),
        **prefixed("grad/", scene_arrays(grad_scene(),
                                         bg=np.zeros(3, np.float32))),
        **prefixed("skew/", scene_arrays(skew["sc"], means=skew["means"])),
        **prefixed("dp1/", {**state_arrays(dp1_state()), "images": images}),
        **prefixed("dp2/", {
            **state_arrays(dp2_state()), "images": images,
            "azimuth": np.asarray(jax.random.uniform(
                jax.random.PRNGKey(BAKE_KEY), (n2, 1))),
            "env": np.asarray(env["params"]["env"]),
            "env_m": np.asarray(env["opt"]["m"]["env"]),
            "env_v": np.asarray(env["opt"]["v"]["env"])}),
    }
    inward, inward_az = inward_scene()
    arrays.update(prefixed("inward/", {
        **dict(zip(("means", "scales", "quats", "opacity", "shs"), inward)),
        "azimuth": inward_az}))
    jobs = [
        ("inward", dict(kind="bake", prefix="inward/", samples=8)),
        ("img", dict(kind="gshard", prefix="img/", camera=cam_spec(64, 64),
                     max_instances=MAX_INST, tile=32, single=True,
                     variants=[{}, {"cap": 16}, {"cap": 2}])),
        ("grad", dict(kind="gshard", prefix="grad/",
                      camera=cam_spec(32, 32), max_instances=MAX_INST,
                      tile=32, grad=True, variants=[{}, {"cap": 8}])),
        ("skew", dict(kind="gshard", prefix="skew/",
                      camera=cam_spec(128, 256), max_instances=MAX_INST,
                      tile=16, variants=[
                          {"row_starts": list(skew["starts"])},
                          {"row_starts": list(skew["starts"]), "cap": 64}])),
        ("dp1", dict(kind="dp1", prefix="dp1/", cameras=ranks.ring_specs(),
                     max_instances=MAX_INST, iteration=1.0, xyz_lr=XYZ_LR)),
        ("dp2", dict(kind="bake_dp2", prefix="dp2/",
                     cameras=ranks.ring_specs(), max_instances=MAX_INST,
                     samples=8, iteration=1.0, xyz_lr=XYZ_LR)),
        ("comm", dict(kind="comm")),
        ("boot", dict(kind="bootstrap")),
    ]
    session = ranks.start(8, tmp_path_factory.mktemp("ranks8"), jobs, arrays)
    return _Lazy(session)


class _Lazy:
    def __init__(self, session):
        self.session, self._res = session, None

    def __call__(self, job):
        if self._res is None:
            self._res = self.session.results()
        return [r[job] for r in self._res]


def mesh8(axis):
    return jdp.make_mesh(8, axis=axis)


def assert_image(t, j, tag=""):
    for f in IMG_FIELDS:
        jf = np.asarray(getattr(j, f)) if not isinstance(j, dict) else j[f]
        np.testing.assert_allclose(t[f"{tag}{f}"], jf,
                                   atol=IMG_TOL.get(f, 1e-4),
                                   rtol=1e-5 if f == "weights" else 0,
                                   err_msg=f"{tag}{f}")


def assert_replicas(outs, keys=None):
    for r, o in enumerate(outs[1:], 1):
        for k in keys or o:
            assert np.array_equal(o[k], outs[0][k]), f"rank {r}: {k}"


# ---- gshard: the image --------------------------------------------------

@pytest.fixture(scope="module")
def jax_image():
    sc = image_scene()
    cam = default_camera(64, 64)
    out = {}
    for tag, cap in (("allgather", None), ("exchange", 16)):
        b = jgs.rasterize_sharded(
            mesh8("gauss"), "gauss", sc["means"], sc["scales"], sc["quats"],
            sc["opacity"], cam, jnp.asarray(BG), colors=sc["colors"],
            features=sc["features"], vfeatures=sc["vfeatures"], cfg=CFG,
            exchange_cap=cap, interpret=True)
        assert not bool(b.overflow)
        out[tag] = b
    return out


@pytest.mark.parametrize("variant", ["allgather", "exchange"])
def test_gshard_image_matches_jax(ranks8, jax_image, variant):
    outs = ranks8("img")
    tag = {"allgather": "v0_", "exchange": "v1_"}[variant]
    assert not outs[0][f"{tag}overflow"]
    assert_image(outs[0], jax_image[variant], tag)
    assert_replicas(outs, [f"{tag}{f}" for f in IMG_FIELDS])


@pytest.mark.parametrize("variant", ["allgather", "exchange"])
def test_gshard_image_matches_port_single_device(ranks8, variant):
    o = ranks8("img")[0]
    tag = {"allgather": "v0_", "exchange": "v1_"}[variant]
    single = {f: o[f"single_{f}"] for f in IMG_FIELDS}
    assert_image(o, single, tag)
    np.testing.assert_array_equal(o[f"{tag}radii"], o["single_radii"])
    np.testing.assert_array_equal(o[f"{tag}n_contrib"], o["single_n_contrib"])


def test_gshard_exchange_budget_overflow_flags(ranks8):
    """Cap 2 is below what a rank sends a band: flagged, not a crash."""
    assert all(bool(o["v2_overflow"]) for o in ranks8("img"))


# ---- gshard: gradients --------------------------------------------------

@pytest.fixture(scope="module")
def jax_grad():
    sc = grad_scene()
    cam = default_camera(32, 32)

    def loss(means):
        b = j_rasterize(means, sc["scales"], sc["quats"], sc["opacity"],
                        cam, jnp.zeros(3), colors=sc["colors"], cfg=CFG,
                        interpret=True)
        return jnp.square(b.color).sum()

    return np.asarray(jax.jit(jax.grad(loss))(sc["means"]))


@pytest.mark.parametrize("variant", ["allgather", "exchange"])
def test_gshard_gradients_match_jax_single_device(ranks8, jax_grad, variant):
    """The gradient of sum(color**2) with respect to the means: every rank
    holds the single-device gradient (not D times it: the gather of the
    image keeps the rank's own band of the cotangent)."""
    outs = ranks8("grad")
    key = {"allgather": "v0_dmeans", "exchange": "v1_dmeans"}[variant]
    scale = np.abs(jax_grad).max() + 1e-8
    np.testing.assert_allclose(outs[0][key] / scale, jax_grad / scale,
                               atol=5e-4)
    assert_replicas(outs, [key])


# ---- gshard: balanced rows ---------------------------------------------

def _port_scene(sc, means):
    return [torch.as_tensor(np.array(x)) for x in
            (means, sc["scales"], sc["quats"], sc["opacity"])]


def _port_cam(width, height):
    return ranks.camera(cam_spec(width, height))


def test_balanced_rows_histogram_and_starts(skew):
    tcfg = TCfg(max_instances=MAX_INST, tile=16)
    hist = tgs.row_instance_histogram(
        *_port_scene(skew["sc"], skew["means"]), _port_cam(128, 256),
        cfg=tcfg).numpy()
    np.testing.assert_array_equal(hist, skew["hist"])
    starts = tgs.balanced_row_starts(torch.as_tensor(hist), 8)
    assert starts == skew["starts"]
    assert starts[0] == 0 and starts[-1] == 16 and len(starts) == 9
    # the DP on synthetic histograms, fewer rows than ranks included
    rng = np.random.default_rng(0)
    for rows, d in ((16, 8), (25, 2), (5, 8), (40, 3)):
        h = rng.integers(0, 1000, rows)
        assert tgs.balanced_row_starts(h, d) == \
            jgs.balanced_row_starts(jnp.asarray(h), d)


def test_balanced_rows_instance_stats(skew):
    tcfg = TCfg(max_instances=MAX_INST, tile=16)
    tsc = _port_scene(skew["sc"], skew["means"])
    jsc = (skew["means"], skew["sc"]["scales"], skew["sc"]["quats"],
           skew["sc"]["opacity"])
    even = tuple(range(0, 17, 2))
    for starts in (skew["starts"], even):
        t = tgs.instance_stats(*tsc, _port_cam(128, 256), starts, cfg=tcfg)
        j = jgs.instance_stats(*jsc, skew["cam"], starts, cfg=skew["cfg"])
        assert t == pytest.approx(j)
    bal = tgs.instance_stats(*tsc, _port_cam(128, 256), skew["starts"],
                             cfg=tcfg)
    ev = tgs.instance_stats(*tsc, _port_cam(128, 256), even, cfg=tcfg)
    assert bal["imbalance"] <= ev["imbalance"] + 1e-6


@pytest.fixture(scope="module")
def jax_skew(skew):
    sc = skew["sc"]
    out = {}
    for tag, cap in (("v0_", None), ("v1_", 64)):
        b = jgs.rasterize_sharded(
            mesh8("gauss"), "gauss", skew["means"], sc["scales"],
            sc["quats"], sc["opacity"], skew["cam"], jnp.asarray(BG),
            colors=sc["colors"], features=sc["features"],
            vfeatures=sc["vfeatures"], cfg=skew["cfg"], exchange_cap=cap,
            row_starts=skew["starts"], interpret=True)
        assert not bool(b.overflow)
        out[tag] = b
    return out


@pytest.mark.parametrize("cap", [None, 64], ids=["allgather", "cap64"])
def test_balanced_rows_image_matches_jax(ranks8, jax_skew, cap):
    outs = ranks8("skew")
    tag = "v0_" if cap is None else "v1_"
    assert not outs[0][f"{tag}overflow"]
    assert_image(outs[0], jax_skew[tag], tag)
    assert_replicas(outs, [f"{tag}{f}" for f in IMG_FIELDS])


# ---- DP stage 1 ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_dp1():
    state = dp1_state()
    cams, _ = ring_cameras()
    opt = JOpt()
    step = jdp.make_dp_train_step(mesh8("data"), opt, CFG, jnp.zeros(3),
                                  lrs=joptim.group_lrs(opt, 1.0, False))
    new, ost, metrics = step(state, joptim.adam_init(state["params"]),
                             jdp.stack_cameras(cams), jnp.float32(1),
                             jnp.float32(XYZ_LR))
    return dict(old=jax.device_get(state["params"]),
                new=jax.device_get(new), ost=jax.device_get(ost),
                metrics=jax.device_get(metrics),
                lrs={**joptim.group_lrs(opt, 1.0, False), "xyz": XYZ_LR})


def _rel(a, b, tol):
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=tol)


def _params_match(t_new, j_new, j_m, lr):
    """Where |g| (hence |m|) is below 1e-6 of its largest, within lr; else
    1e-5 relative."""
    j_new, j_m = np.asarray(j_new), np.asarray(j_m)
    small = np.abs(j_m) < 1e-6 * np.abs(j_m).max()
    d = np.abs(t_new - j_new)
    assert (d[small] <= lr * (1 + 1e-5)).all()
    np.testing.assert_allclose(t_new[~small], j_new[~small], rtol=1e-5,
                               atol=1e-7)


def test_dp_step_loss_and_psnr(ranks8, jax_dp1):
    o = ranks8("dp1")[0]
    for k in ("loss", "psnr"):
        assert float(o[k]) == pytest.approx(
            float(jax_dp1["metrics"][k]), rel=1e-5), k


@pytest.mark.parametrize("name", STAGE1)
def test_dp_step_moment_and_params(ranks8, jax_dp1, name):
    o = ranks8("dp1")[0]
    j_m = jax_dp1["ost"]["m"][name]
    _rel(o[f"m_{name}"], j_m, 5e-4)
    _params_match(o[f"p_{name}"], jax_dp1["new"]["params"][name], j_m,
                  jax_dp1["lrs"][name])


def test_dp_step_summed_densification_stats(ranks8, jax_dp1):
    """The per-view deltas summed over the ranks, max_radii2d included
    (hazard 11: the sum of the views' radii, as the reference computes)."""
    o = ranks8("dp1")[0]
    js = jax_dp1["new"]["stats"]
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(o[f"s_{k}"], np.asarray(js[k]))
    # the norms of the screen-offset gradients, held as gradients are
    _rel(o["s_xyz_gradient_accum"], js["xyz_gradient_accum"], 5e-4)
    _rel(o["s_weights_accum"], js["weights_accum"], 1e-5)
    assert np.asarray(js["max_radii2d"]).max() > 0


def test_dp_step_replicas_bit_equal(ranks8):
    assert_replicas(ranks8("dp1"))


# ---- the sharded bake and DP stage 2 ------------------------------------

@pytest.fixture(scope="module")
def jax_dp2():
    state = dp2_state()
    p = dict(state["params"])
    bake = jdp.bake_radiance_sharded(
        mesh8("data"), "data", p["xyz"], JG.get_scaling(p),
        JG.get_rotation(p), JG.get_opacity(p)[:, 0], JG.get_shs(p),
        sample_num=8, key=jax.random.PRNGKey(BAKE_KEY))
    p["radiances"] = jnp.array(bake["radiance"])
    p["radiance_ratio"] = jnp.ones(())
    state = {**state, "params": p}
    static = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    cams, _ = ring_cameras()
    opt = JOpt()
    env = env_state()
    step = jdp.make_dp_svgss_train_step(
        mesh8("data"), opt, CFG, jnp.zeros(3),
        lrs=joptim.group_lrs(opt, 1.0, use_pbr=True))
    new, ost, env_new, metrics = step(
        state, joptim.adam_init(p), env, static, jdp.stack_cameras(cams),
        jnp.float32(1), jnp.float32(XYZ_LR), jnp.float32(opt.radiance_lr))
    return dict(bake=jax.device_get(bake), old=jax.device_get(p),
                env0=np.asarray(env["params"]["env"]),
                new=jax.device_get(new), ost=jax.device_get(ost),
                env=jax.device_get(env_new), metrics=jax.device_get(metrics),
                alive=np.asarray(state["alive"]),
                static=jax.device_get(static))


def test_sharded_bake_matches_jax(ranks8, jax_dp2):
    outs = ranks8("dp2")
    o, jb = outs[0], jax_dp2["bake"]
    np.testing.assert_array_equal(o["bake_hit_idx"], np.asarray(jb["hit_idx"]))
    # (the incident directions of normals near -z differ by 2e-5: see
    # tests/test_torch_bake.py; the case below keeps its normals clear)
    for k in ("radiance", "visibility", "uv"):
        np.testing.assert_allclose(o[f"bake_{k}"], np.asarray(jb[k]),
                                   atol=1e-5, err_msg=k)
    assert_replicas(outs, [k for k in o if k.startswith("bake_")])


def test_sharded_bake_with_hits_matches_jax(ranks8):
    """The same on surfels whose rays hit (the ring scene's face outward:
    none of its rays hits)."""
    scene, _ = inward_scene()
    jb = jax.device_get(jdp.bake_radiance_sharded(
        mesh8("data"), "data", *map(jnp.asarray, scene), sample_num=8,
        key=jax.random.PRNGKey(INWARD_KEY)))
    outs = ranks8("inward")
    o = outs[0]
    np.testing.assert_array_equal(o["bake_hit_idx"], np.asarray(jb["hit_idx"]))
    assert (o["bake_hit_idx"] >= 0).mean() > 0.2
    for k in ("radiance", "visibility", "uv", "incident_dirs"):
        np.testing.assert_allclose(o[f"bake_{k}"], np.asarray(jb[k]),
                                   atol=1e-5, err_msg=k)
    assert float(o["bake_exhausted_frac"]) == pytest.approx(
        float(jb["exhausted_frac"]), abs=1e-7)
    assert_replicas(outs)


def test_dp_svgss_step_matches_jax(ranks8, jax_dp2):
    o = ranks8("dp2")[0]
    j = jax_dp2
    for k in ("loss", "psnr"):
        assert float(o[k]) == pytest.approx(float(j["metrics"][k]),
                                            rel=1e-5), k
    # the env map and the base colour moved through the averaged gradients
    assert np.abs(o["env"] - j["env0"]).max() > 0
    assert np.abs(o["p_base_color"] - np.asarray(
        j["old"]["base_color"])).max() > 0
    _rel(o["env_m"], j["env"]["opt"]["m"]["env"], 5e-4)
    _params_match(o["env"], j["env"]["params"]["env"],
                  j["env"]["opt"]["m"]["env"], JOpt().env_lr)
    lrs = {**joptim.group_lrs(JOpt(), 1.0, use_pbr=True), "xyz": XYZ_LR,
           "radiances": JOpt().radiance_lr}
    for name in ("base_color", "roughness", "xyz", "opacity"):
        j_m = j["ost"]["m"][name]
        _rel(o[f"m_{name}"], j_m, 5e-4 if name == "base_color" else 2.5e-3)
        _params_match(o[f"p_{name}"], j["new"]["params"][name], j_m,
                      lrs[name])


def test_dp_svgss_step_replicas_bit_equal(ranks8):
    assert_replicas(ranks8("dp2"))


# ---- render_svgss's mean2d_offset ---------------------------------------

def test_render_svgss_mean2d_offset_matches_jax(jax_dp2):
    """The screen-offset gradient of the stage-2 loss on camera 0 of the
    ring, on JAX's bake, against JAX's."""
    j = jax_dp2
    alive, cam = j["alive"], ring_cameras()[0][0]
    static = {k: jnp.asarray(v) for k, v in j["static"].items()}
    jparams = {k: jnp.asarray(v) for k, v in j["old"].items()}
    cap = alive.shape[0]
    opt = JOpt()
    env = env_state()

    def jloss(off):
        r = j_render_svgss(cam, jparams, jnp.zeros(3), bake=static,
                           env_params=env["params"], opt=opt, iteration=1.0,
                           is_training=True, alive=jnp.asarray(alive),
                           mean2d_offset=off, cfg=CFG)
        return r["loss"], r["render"]

    (jl, jimg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.zeros((cap, 2)))
    params = TG.params_from_jax(j["old"], device="cpu")
    bake = {k: torch.as_tensor(np.array(v)) for k, v in j["static"].items()}
    tcam = ranks.camera(ranks.ring_specs()[0], ring_cameras()[1][0])
    off = torch.zeros(cap, 2, requires_grad=True)
    r = t_render_svgss(tcam, params, torch.zeros(3), bake=bake,
                       env_params={"env": torch.as_tensor(
                           np.asarray(env["params"]["env"]))},
                       opt=TOpt(), iteration=1.0, is_training=True,
                       alive=torch.as_tensor(alive),
                       mean2d_offset=off, mono=None,
                       cfg=TCfg(max_instances=MAX_INST))
    (tg,) = torch.autograd.grad(r["loss"], off)
    np.testing.assert_allclose(r["render"].detach().numpy(),
                               np.asarray(jimg), atol=1e-5)
    assert np.abs(np.asarray(jg)).max() > 0
    _rel(tg.numpy(), jg, 5e-4)
    # the loss's surface term compares the normals with the depth's
    # finite-difference normal, 1e-3 apart between the packages here (the
    # pseudo-normal: 5e-3 in tests/test_torch_svgss.py); weighted 0.02
    assert float(r["loss"].detach()) == pytest.approx(float(jl), rel=2e-5)


# ---- the collectives ----------------------------------------------------

def _expected_comm(case, world):
    """(y, dx) of every rank for sum(w * op(x)), from the cases' numpy
    inputs: the single-device function and its gradient (each replicated
    loss counted once)."""
    xs, ws = zip(*(ranks.comm_inputs(case, r, world) for r in range(world)))
    k = xs[0].shape[0] // world
    chunk = [slice(r * k, (r + 1) * k) for r in range(world)]
    cat = np.concatenate
    if case == "all_gather_sum":
        y = [cat(xs)] * world
        dx = [sum(ws[s][r * len(xs[0]):(r + 1) * len(xs[0])]
                  for s in range(world)) for r in range(world)]
    elif case == "all_gather_own":
        y = [cat(xs)] * world
        dx = [ws[0][r * len(xs[0]):(r + 1) * len(xs[0])]
              for r in range(world)]
    elif case in ("all_reduce_sum", "all_reduce_mean"):
        div = world if case == "all_reduce_mean" else 1
        y = [sum(xs) / div] * world
        dx = [ws[0] / div] * world
    elif case == "all_reduce_max":
        m = np.max(xs, 0)
        held = [(x == m).astype(np.float32) for x in xs]
        y = [m] * world
        dx = [ws[0] * h / sum(held) for h in held]
    elif case == "all_to_all":
        y = [cat([xs[s][chunk[r]] for s in range(world)])
             for r in range(world)]
        dx = [cat([ws[d][chunk[r]] for d in range(world)])
              for r in range(world)]
    elif case == "reduce_scatter":
        y = [sum(x[chunk[r]] for x in xs) for r in range(world)]
        dx = [cat(ws)] * world
    else:                                                    # shard
        y = [xs[0][chunk[r]] for r in range(world)]
        dx = [cat(ws)] * world
    return y, dx


@pytest.mark.parametrize("case", ranks.COMM_CASES)
def test_collective_forward_and_backward(ranks8, case):
    """Each collective of parallel/comm.py at 8 ranks: its output, and the
    gradient its written-out backward gives, against the single-device
    function (``all_gather(backward="own")`` keeps the rank's slice of a
    replicated cotangent where ``"sum"`` would give 8 times it)."""
    outs = ranks8("comm")
    y, dx = _expected_comm(case, 8)
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{case}_y"], y[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(o[f"{case}_dx"], dx[r], rtol=1e-6,
                                   atol=1e-6, err_msg=f"rank {r}")


# ---- bootstrap ----------------------------------------------------------

def test_init_distributed_and_global_mesh(ranks8):
    """At 8 ranks: init_distributed is idempotent, make_global_mesh gives
    ("data",) of 8 and {"data": -1, "tile": 4} 2 x 4, and axes that do not
    tile the ranks raise ValueError."""
    for r, o in enumerate(ranks8("boot")):
        assert int(o["rank"]) == int(o["again"]) == r
        assert tuple(o["m1_names"]) == ("data",)
        assert tuple(o["m1_shape"]) == (8,)
        assert tuple(o["m2_names"]) == ("data", "tile")
        assert tuple(o["m2_shape"]) == (2, 4)
        assert bool(o["refused"])


# ---- 2 ranks, uneven bands ----------------------------------------------

def test_two_ranks_uneven_bands_match_single_device(tmp_path):
    """The world size is not baked in: 2 ranks, uneven balanced bands (a
    grid of 5 tile rows), both variants, image and gradient against the
    port's own single-device render."""
    sc, means = skewed_scene()
    arrays = scene_arrays(sc, means=means)
    tcfg = TCfg(max_instances=MAX_INST, tile=16)
    hist = tgs.row_instance_histogram(*_port_scene(sc, means),
                                      _port_cam(96, 80), cfg=tcfg)
    starts = tgs.balanced_row_starts(hist, 2)
    assert starts[1] - starts[0] != starts[2] - starts[1]
    jobs = [("uneven", dict(kind="gshard", camera=cam_spec(96, 80),
                            max_instances=MAX_INST, tile=16, single=True,
                            grad=True, variants=[
                                {"row_starts": list(starts)},
                                {"row_starts": list(starts), "cap": 256}]))]
    outs = ranks.start(2, tmp_path, jobs, arrays).results()
    o = outs[0]["uneven"]
    single = {f: o[f"single_{f}"] for f in IMG_FIELDS}
    scale = np.abs(o["single_dmeans"]).max()
    for tag in ("v0_", "v1_"):
        assert not o[f"{tag}overflow"]
        assert_image(o, single, tag)
        np.testing.assert_allclose(o[f"{tag}dmeans"] / scale,
                                   o["single_dmeans"] / scale, atol=5e-4)
    assert_replicas([x["uneven"] for x in outs])
