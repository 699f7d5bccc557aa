"""The tile-major paths of svgir_tpu_torch's ``rasterize`` (``strip=0`` with
the counting binner, and the sort binner) against svgir_tpu's ``rasterize``
with the same ``RasterConfig`` (Pallas blend in interpret mode), against
the port's own strip path, and the port's dense oracle ``render_dense``
against svgir_tpu's and against the port's tiled paths.

The loss is ``tests/test_strip_layout.py``'s (colour against a cosine
pattern, squared vertex features, depth, opacity, squared weights), taken
with respect to opacity, vertex features and means.  Tolerances:
- images 2e-5 absolute, as ``tests/test_torch_rasterizer.py`` (the vertex
  channels, summed over many instances in another order, differ by up to
  1.3e-5), depth 1e-4 relative (it divides by 1 - T), weights 1e-5;
  n_contrib, radii and overflow exact;
- gradients against the reference: 2e-4 of each gradient's largest
  magnitude, as ``tests/test_torch_rasterizer.py`` (ROADMAP C-8's 2.5e-3
  is not needed on these scenes);
- the port's strip 0 and sort paths against its strip 8 path: 1e-5 (the
  same plain chunk math, re-laid);
- dense against tiled (port): the reference's own tiled-vs-dense
  tolerances (``tests/test_rasterizer.py``: images 2e-5, depth and weights
  1e-3); port dense against JAX dense: 1e-5, depth 1e-4 relative.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.cameras import look_at_camera as j_look_at
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops.dense_ref import render_dense as j_render_dense
from svgir_tpu.ops.preprocess import preprocess as j_preprocess
from svgir_tpu.ops.rasterizer import rasterize as j_rasterize

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops.dense_ref import render_dense as t_render_dense
from svgir_tpu_torch.ops.preprocess import Preprocessed as TPrep
from svgir_tpu_torch.ops.rasterizer import rasterize as t_rasterize

from tests.scenes import sphere_scene
from tests.test_tile_sizes import _scene


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


FIELDS = ("color", "normal", "opacity", "feature", "vfeature", "final_t")
SCENES = {
    # tests/test_strip_layout.py's scene (4 features, CV = 2), chunk 32
    "strip_layout": dict(w=48, h=40, chunk=32, mi=1 << 13, dist=3.0),
    # opaque splats filling a close view: three chunks per tile, every
    # tile saturated after one or two, so the tiles exit early
    "opaque": dict(w=32, h=32, chunk=32, mi=1 << 13, dist=1.6),
}
# both paths on the strip-layout scene; strip 0 on the opaque one (the
# sort path's blend is the same B5/B6, held on early exits by
# tests/test_torch_blend_tiles.py)
CASES = {"strip_layout_strip0": ("strip_layout", "strip0"),
         "strip_layout_sort": ("strip_layout", "sort"),
         "opaque_strip0": ("opaque", "strip0")}


@functools.lru_cache(maxsize=None)
def _scene_arrays(scene):
    if scene == "strip_layout":
        means, scales, quats, op, cols, vf = _scene()
        feats = jax.random.uniform(jax.random.PRNGKey(3), (means.shape[0], 4))
    else:
        sc = sphere_scene(jax.random.PRNGKey(9), n=400, scale=0.4,
                          opacity_range=(0.7, 0.95), s_feat=2, vs_feat=4)
        means, scales, quats, op, cols, feats, vf = (
            sc[k] for k in ("means", "scales", "quats", "opacity", "colors",
                            "features", "vfeatures"))
    return {k: np.asarray(v, np.float32) for k, v in dict(
        means=means, scales=scales, quats=quats, opacity=op, colors=cols,
        features=feats, vfeatures=vf).items()}


def _cams(w, h, dist=3.0):
    kw = dict(eye=[0, 0, -dist], target=[0, 0, 0], up=[0, -1, 0],
              fovx=math.pi / 3, fovy=math.pi / 3, width=w, height=h)
    return j_look_at(**kw), t_look_at(**kw, device="cpu")


def _cfg(scene, path, cls):
    s = SCENES[scene]
    cfg = cls(max_instances=s["mi"], chunk=s["chunk"], tile=16)
    return dataclasses.replace(cfg, **({"strip": 0} if path == "strip0"
                                       else {"strip": 0, "binner": "sort"}
                                       if path == "sort" else {}))


def _loss(r, xp):
    mod = xp.cos(xp.arange(r.color.size if xp is jnp else r.color.numel(),
                           dtype=xp.float32)).reshape(r.color.shape)
    return (xp.sum(r.color * mod) + xp.sum(r.vfeature ** 2)
            + xp.sum(r.depth) + 0.3 * xp.sum(r.opacity)
            + xp.sum(r.weights ** 2))


def _run_jax(scene, path):
    a = {k: jnp.asarray(v) for k, v in _scene_arrays(scene).items()}
    s = SCENES[scene]
    cam, _ = _cams(s["w"], s["h"], s["dist"])
    cfg = _cfg(scene, path, JCfg)

    def run(means, op, vf):
        r = j_rasterize(means, a["scales"], a["quats"], op, cam, jnp.zeros(3),
                        colors=a["colors"], features=a["features"],
                        vfeatures=vf, cfg=cfg, interpret=True)
        return _loss(r, jnp), r

    (_, r), g = jax.jit(jax.value_and_grad(run, argnums=(0, 1, 2),
                                           has_aux=True))(
        a["means"], a["opacity"], a["vfeatures"])
    return r, dict(means=g[0], opacity=g[1], vfeatures=g[2])


def _run_torch(scene, path):
    a = {k: torch.as_tensor(v) for k, v in _scene_arrays(scene).items()}
    s = SCENES[scene]
    _, cam = _cams(s["w"], s["h"], s["dist"])
    args = {k: a[k].clone().requires_grad_(True)
            for k in ("means", "opacity", "vfeatures")}
    r = t_rasterize(args["means"], a["scales"], a["quats"], args["opacity"],
                    cam, torch.zeros(3), colors=a["colors"],
                    features=a["features"], vfeatures=args["vfeatures"],
                    cfg=_cfg(scene, path, TCfg))
    g = torch.autograd.grad(_loss(r, torch), list(args.values()))
    return r, dict(zip(args, g))


@functools.lru_cache(maxsize=None)
def _rendered(case):
    scene, path = CASES[case]
    return _run_jax(scene, path), _run_torch(scene, path)


@functools.lru_cache(maxsize=None)
def _port_strip8(scene):
    return _run_torch(scene, "strip8")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_buffers(tb, ref, *, atol, depth_rtol, weights_atol, what):
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(tb, f)), _np(getattr(ref, f)),
                                   atol=atol, err_msg=f"{what}: {f}")
    np.testing.assert_allclose(_np(tb.depth), _np(ref.depth), rtol=depth_rtol,
                               atol=depth_rtol, err_msg=f"{what}: depth")
    np.testing.assert_allclose(_np(tb.weights), _np(ref.weights),
                               atol=weights_atol, rtol=weights_atol,
                               err_msg=f"{what}: weights")


@pytest.mark.parametrize("case", sorted(CASES))
def test_buffers_match_reference(case):
    (jb, _), (tb, _) = _rendered(case)
    assert not bool(jb.overflow) and not bool(tb.overflow)
    _assert_buffers(tb, jb, atol=2e-5, depth_rtol=1e-4, weights_atol=1e-5,
                    what=case)
    np.testing.assert_array_equal(_np(tb.n_contrib), _np(jb.n_contrib))
    np.testing.assert_array_equal(_np(tb.radii), _np(jb.radii))
    if case.startswith("opaque"):
        assert float(_np(tb.final_t).min()) < 1e-4     # saturated pixels


@pytest.mark.parametrize("case,arg", [(c, a) for c in sorted(CASES)
                                      for a in ("means", "opacity",
                                                "vfeatures")])
def test_gradients_match_reference(case, arg):
    (_, jg), (_, tg) = _rendered(case)
    a, b = _np(tg[arg]), _np(jg[arg])
    scale = max(np.abs(b).max(), 1e-12)
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-4,
                               err_msg=f"{case}: d{arg}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_major_paths_match_strip_path(case):
    """What tests/test_strip_layout.py means to hold: the per-tile
    (strip 0) and sort-binner paths against the strip path."""
    scene, _ = CASES[case]
    (tb, tg) = _rendered(case)[1]
    sb, sg = _port_strip8(scene)
    _assert_buffers(tb, sb, atol=1e-5, depth_rtol=1e-5, weights_atol=1e-5,
                    what=case)
    np.testing.assert_array_equal(_np(tb.n_contrib), _np(sb.n_contrib))
    for k in sg:
        scale = max(float(sg[k].abs().max()), 1e-12)
        np.testing.assert_allclose(_np(tg[k]) / scale, _np(sg[k]) / scale,
                                   atol=1e-5, err_msg=f"{case}: d{k}")


DENSE = {"strip_layout": dict(w=48, h=32, scene="strip_layout"),
         "sphere": dict(w=48, h=32, scene="sphere")}


@functools.lru_cache(maxsize=None)
def _dense_inputs(name):
    d = DENSE[name]
    if d["scene"] == "strip_layout":
        a = _scene_arrays("strip_layout")
    else:
        sc = sphere_scene(jax.random.PRNGKey(1), n=60, s_feat=5, vs_feat=8)
        a = {k: np.asarray(sc[k], np.float32) for k in
             ("means", "scales", "quats", "opacity", "colors", "features",
              "vfeatures")}
    jcam, tcam = _cams(d["w"], d["h"])
    cfg = JCfg(tile=16)
    jp = j_preprocess(*(jnp.asarray(a[k]) for k in ("means", "scales",
                                                    "quats")),
                      jcam.world_view, jcam.full_proj, jcam.camera_center,
                      width=d["w"], height=d["h"], tanfovx=jcam.tanfovx,
                      tanfovy=jcam.tanfovy, focal_x=jcam.focal_x,
                      focal_y=jcam.focal_y, colors=jnp.asarray(a["colors"]),
                      cfg=cfg)
    return a, jp, tcam


@pytest.mark.parametrize("name", sorted(DENSE))
def test_render_dense_matches_reference(name):
    a, jp, _ = _dense_inputs(name)
    d = DENSE[name]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jb = j_render_dense(jp, jnp.asarray(a["opacity"]),
                        jnp.asarray(a["features"]),
                        jnp.asarray(a["vfeatures"]), jnp.asarray(bg),
                        width=d["w"], height=d["h"], cfg=JCfg(tile=16))
    tb = t_render_dense(TPrep(*(torch.tensor(np.asarray(x)) for x in jp)),
                        torch.as_tensor(a["opacity"]),
                        torch.as_tensor(a["features"]),
                        torch.as_tensor(a["vfeatures"]), torch.as_tensor(bg),
                        width=d["w"], height=d["h"], cfg=TCfg(tile=16))
    _assert_buffers(tb, jb, atol=1e-5, depth_rtol=1e-4, weights_atol=1e-5,
                    what=name)
    np.testing.assert_array_equal(_np(tb.n_contrib), _np(jb.n_contrib))
    assert float(_np(tb.opacity).max()) > 0.5


@pytest.mark.parametrize("name,path", [(n, p) for n in sorted(DENSE)
                                       for p in ("strip8", "strip0",
                                                 "sort")])
def test_tiled_paths_match_port_dense(name, path):
    a, jp, tcam = _dense_inputs(name)
    d = DENSE[name]
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = _cfg("strip_layout", path, TCfg)
    with torch.no_grad():
        tiled = t_rasterize(t["means"], t["scales"], t["quats"], t["opacity"],
                            tcam, bg, colors=t["colors"],
                            features=t["features"], vfeatures=t["vfeatures"],
                            cfg=cfg)
        dense = t_render_dense(TPrep(*(torch.tensor(np.asarray(x))
                                       for x in jp)),
                               t["opacity"], t["features"], t["vfeatures"],
                               bg, width=d["w"], height=d["h"], cfg=cfg)
    assert not bool(tiled.overflow)
    for f in FIELDS:
        np.testing.assert_allclose(_np(getattr(tiled, f)),
                                   _np(getattr(dense, f)), atol=2e-5,
                                   err_msg=f"{name}/{path}: {f}")
    np.testing.assert_allclose(_np(tiled.depth), _np(dense.depth), atol=1e-3)
    np.testing.assert_allclose(_np(tiled.weights), _np(dense.weights),
                               atol=1e-3)
    np.testing.assert_array_equal(_np(tiled.n_contrib), _np(dense.n_contrib))
