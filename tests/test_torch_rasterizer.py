"""svgir_tpu_torch.ops.rasterizer.rasterize against svgir_tpu's rasterize
(strip path, Pallas blend in interpret mode): images and gradients, on the
cases of tests/test_rasterizer.py.

Each case renders the same seeded scene through both packages on the CPU
and differentiates one loss that touches every buffer (color, depth,
normal, features, vertex features, opacity, weights) with respect to every
input, ``mean2d_offset`` included.  Tolerances:
- images: 2e-5 absolute (the reference's own tiled-vs-dense tolerance),
  depth 1e-4 relative (it divides by 1 - T);
- n_contrib: exact;
- gradients: 2e-4 of each gradient's largest magnitude (the reference's
  tolerance for its hand-written VJP against autodiff).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops.rasterizer import rasterize as j_rasterize

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops.rasterizer import rasterize as t_rasterize

from tests.scenes import default_camera, sphere_scene


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


ARGS = ("means", "scales", "quats", "opacity", "colors", "features",
        "vfeatures", "offset")
CASES = {
    "features_and_vertex_features": dict(key=1, n=60, w=48, h=48, s=5, vs=8,
                                         scale=0.08, opac=(0.3, 0.95),
                                         bg=(0.0, 0.0, 0.0), mi=1 << 14),
    "nonsquare_color_only": dict(key=2, n=50, w=72, h=40, s=0, vs=0,
                                 scale=0.08, opac=(0.3, 0.95),
                                 bg=(1.0, 1.0, 1.0), mi=1 << 14),
    "opaque_early_exit_multichunk": dict(key=9, n=600, w=32, h=32, s=0, vs=0,
                                         scale=0.5, opac=(0.90, 0.99),
                                         bg=(0.2, 0.3, 0.4), mi=1 << 13),
}


def _loss_terms(color, depth, normal, feature, vfeature, opacity, weights,
                tgt, xp):
    return (xp.abs(color - tgt).mean() + depth.mean() + 0.3 * normal.sum()
            + 0.2 * feature.sum() + 0.1 * vfeature.sum()
            + 0.05 * opacity.mean() + 1e-3 * weights.sum())


def _scene(c):
    sc = sphere_scene(jax.random.PRNGKey(c["key"]), n=c["n"], scale=c["scale"],
                      opacity_range=c["opac"], s_feat=c["s"],
                      vs_feat=c["vs"])
    n = c["n"]
    out = {k: np.asarray(sc[k]) for k in ARGS[:5]}
    out["features"] = np.asarray(sc["features"]) if c["s"] else None
    out["vfeatures"] = np.asarray(sc["vfeatures"]) if c["vs"] else None
    out["offset"] = np.zeros((n, 2), np.float32)
    return out


def _run_jax(c, sc, tgt):
    cam = default_camera(c["w"], c["h"])
    cfg = JCfg(max_instances=c["mi"], chunk=128)
    bg = jnp.asarray(c["bg"], jnp.float32)
    names = [k for k in ARGS if sc[k] is not None]

    @jax.jit
    def f(*vals):
        def loss(*vals):
            kw = dict(zip(names, vals))
            b = j_rasterize(kw["means"], kw["scales"], kw["quats"],
                            kw["opacity"], cam, bg, colors=kw["colors"],
                            features=kw.get("features"),
                            vfeatures=kw.get("vfeatures"),
                            mean2d_offset=kw["offset"], cfg=cfg,
                            interpret=True)
            return _loss_terms(b.color, b.depth, b.normal, b.feature,
                               b.vfeature, b.opacity, b.weights, tgt,
                               jnp), b
        return jax.value_and_grad(loss, argnums=tuple(range(len(vals))),
                                  has_aux=True)(*vals)

    (lv, b), g = f(*(jnp.asarray(sc[k]) for k in names))
    return b, dict(zip(names, g))


def _run_torch(c, sc, tgt):
    cam = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                    fovx=np.pi / 3, fovy=np.pi / 3, width=c["w"],
                    height=c["h"], device="cpu")
    cfg = TCfg(max_instances=c["mi"], chunk=128)
    names = [k for k in ARGS if sc[k] is not None]
    args = {k: torch.as_tensor(sc[k]).requires_grad_(True) for k in names}
    b = t_rasterize(args["means"], args["scales"], args["quats"],
                    args["opacity"], cam, torch.tensor(c["bg"]),
                    colors=args["colors"],
                    features=args.get("features"),
                    vfeatures=args.get("vfeatures"),
                    mean2d_offset=args["offset"], cfg=cfg)
    loss = _loss_terms(b.color, b.depth, b.normal, b.feature, b.vfeature,
                       b.opacity, b.weights, torch.as_tensor(tgt), torch)
    g = torch.autograd.grad(loss, [args[k] for k in names])
    return b, dict(zip(names, g))


@functools.lru_cache(maxsize=None)
def _rendered(name):
    c = CASES[name]
    sc = _scene(c)
    tgt = np.random.default_rng(c["key"]).random(
        (3, c["h"], c["w"])).astype(np.float32)
    return name, _run_jax(c, sc, tgt), _run_torch(c, sc, tgt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_images_match(name):
    name, (jb, _), (tb, _) = _rendered(name)
    assert not bool(jb.overflow) and not bool(tb.overflow)
    for f in ("color", "opacity", "normal", "feature", "vfeature",
              "final_t"):
        np.testing.assert_allclose(getattr(tb, f).detach().numpy(),
                                   np.asarray(getattr(jb, f)), atol=2e-5,
                                   err_msg=f"{name}: {f}")
    np.testing.assert_allclose(tb.depth.detach().numpy(), np.asarray(jb.depth),
                               rtol=1e-4, atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(tb.n_contrib.numpy(),
                                  np.asarray(jb.n_contrib))
    np.testing.assert_array_equal(tb.radii.numpy(), np.asarray(jb.radii))


@pytest.mark.parametrize("name", sorted(CASES))
def test_weights_match(name):
    name, (jb, _), (tb, _) = _rendered(name)
    np.testing.assert_allclose(tb.weights.detach().numpy(),
                               np.asarray(jb.weights), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,arg", [
    (name, arg) for name in sorted(CASES) for arg in ARGS
    if (arg != "features" or CASES[name]["s"])
    and (arg != "vfeatures" or CASES[name]["vs"])])
def test_gradients_match(name, arg):
    name, (_, jg), (_, tg) = _rendered(name)
    a, b = tg[arg].numpy(), np.asarray(jg[arg])
    scale = max(np.abs(b).max(), 1e-3)
    np.testing.assert_allclose(a / scale, b / scale, atol=2e-4,
                               err_msg=f"{name}: d{arg}")
    if arg == "offset":
        assert np.abs(a).max() > 0


def test_weights_grad_false_leaves_other_gradients():
    """weights_grad=False (the stage-1 setting) changes no gradient of a
    loss that does not read the weights."""
    c = CASES["features_and_vertex_features"]
    sc = _scene(c)
    cam = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                    fovx=np.pi / 3, fovy=np.pi / 3, width=32, height=32,
                    device="cpu")
    out = []
    for wgrad in (True, False):
        args = [torch.as_tensor(sc[k]).requires_grad_(True)
                for k in ("means", "opacity", "vfeatures")]
        b = t_rasterize(args[0], torch.as_tensor(sc["scales"]),
                        torch.as_tensor(sc["quats"]), args[1], cam,
                        torch.zeros(3), colors=torch.as_tensor(sc["colors"]),
                        vfeatures=args[2], cfg=TCfg(max_instances=1 << 14),
                        weights_grad=wgrad)
        loss = b.color.mean() + b.depth.mean() + 0.1 * b.vfeature.sum()
        out.append(torch.autograd.grad(loss, args))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
