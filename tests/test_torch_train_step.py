"""One stage-1 train step of svgir_tpu_torch against svgir_tpu's, on a
tests/scenes.py scene carried across by ``params_from_jax``; plus model
initialization, the step loop's guard on densification, and the package's
isolation from JAX.

Tolerances (float32 on the CPU in both packages):
- loss, image and the loss terms: 1e-5;
- per-parameter gradients: 2.5e-3 of each gradient's largest magnitude
  against the reference.  On this scene the reference's float32 gradient of
  one surfel's position and rotation lies 2e-3 of the largest gradient away
  from a float64 evaluation of the same math, while the port's lies within
  1e-4 of it; the port's float32 gradients are therefore also held to 1e-4
  of their float64 evaluation;
- Adam moments m (0.1 g) and v (1e-3 g^2): 2.5e-3 and 5e-3 relative, as
  the gradients;
- post-Adam parameters: 1e-7 absolute where the gradient is above 1e-3 of
  its largest magnitude (there Adam's first step moves every parameter by
  exactly lr * sign(g)); elsewhere the step may differ by at most 2 lr,
  since a near-zero gradient may flip sign between two summation orders;
- densification statistics: denom and max radii exact, the screen-gradient
  norm as the gradients, the weight sums 1e-5.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.models import gaussians as JG
from svgir_tpu.render.stage1 import render_stage1 as j_render_stage1
from svgir_tpu.train import optim as joptim
from svgir_tpu.train import trainer as jtrainer

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import OptimizationConfig as TOpt
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.render.stage1 import render_stage1 as t_render_stage1
from svgir_tpu_torch.train import optim as toptim
from svgir_tpu_torch.train import trainer as ttrainer

from tests.scenes import default_camera, sphere_scene

W = H = 48
ITER = 1000.0        # SH degree 1 active
XYZ_LR = 1.6e-4
PARAMS = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
          "opacity")


def _inputs():
    sc = sphere_scene(jax.random.PRNGKey(3), n=200)
    pts, cols = np.asarray(sc["means"]), np.asarray(sc["colors"])
    img = np.random.default_rng(3).random((3, H, W)).astype(np.float32)
    return pts, cols, img


@pytest.fixture(scope="module")
def stepped():
    pts, cols, img = _inputs()
    jstate = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                                 normals=jnp.asarray(pts), capacity=256,
                                 rotation_init="normal")
    jcam = dataclasses.replace(default_camera(W, H), image=img,
                               image_mask=np.ones((1, H, W), np.float32))
    jopt, jcfg = JOpt(), JCfg(max_instances=1 << 14)
    bg = jnp.zeros(3)

    def jloss(p):
        r = j_render_stage1(jcam, p, bg, opt=jopt, iteration=ITER,
                            is_training=True, alive=jstate["alive"], cfg=jcfg)
        return r["loss"], r["render"]

    (jl, jimg), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jstate["params"])
    jstep = jtrainer.make_train_step(jopt, jcfg, bg,
                                     lrs=joptim.group_lrs(jopt, 1.0, False))
    jnew, jost, jtb = jstep(jstate, joptim.adam_init(jstate["params"]), jcam,
                            jnp.float32(ITER), jnp.float32(XYZ_LR))

    np_params = jax.device_get(jstate["params"])
    params = TG.params_from_jax(np_params, device="cpu")
    tstate = {"params": params,
              "alive": torch.as_tensor(np.asarray(jstate["alive"])),
              "stats": TG.init_stats(256, device="cpu")}
    tcam = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                     fovx=np.pi / 3, fovy=np.pi / 3, width=W, height=H,
                     image=img, device="cpu")
    topt, tcfg = TOpt(), TCfg(max_instances=1 << 14)
    tbg = torch.zeros(3)

    def port_grads(dtype):
        cam = dataclasses.replace(tcam, **{
            f: getattr(tcam, f).to(dtype) for f in
            ("world_view", "full_proj", "camera_center", "prcppoint", "image",
             "image_mask")})
        p = {k: v.to(dtype).requires_grad_(True) for k, v in params.items()}
        r = t_render_stage1(cam, p, tbg.to(dtype), opt=topt, iteration=ITER,
                            is_training=True, alive=tstate["alive"],
                            cfg=tcfg)
        g = torch.autograd.grad(r["loss"], [p[k] for k in PARAMS],
                                allow_unused=True)
        return r, {k: torch.zeros_like(p[k]) if v is None else v
                   for k, v in zip(PARAMS, g)}

    r, tg = port_grads(torch.float32)
    _, tg64 = port_grads(torch.float64)
    tstep = ttrainer.make_train_step(topt, tcfg, tbg,
                                     lrs=toptim.group_lrs(topt, 1.0),
                                     device="cpu")
    tnew, tost, ttb = tstep(tstate, toptim.adam_init(params), tcam, ITER,
                            XYZ_LR)
    return dict(
        j=dict(loss=float(jl), img=np.asarray(jimg), grads=jax.device_get(jg),
               new=jax.device_get(jnew), ost=jax.device_get(jost),
               tb=jax.device_get(jtb)),
        t=dict(loss=float(r["loss"].detach()), img=r["render"].detach().numpy(),
               grads=tg, grads64=tg64, new=tnew, ost=tost, tb=ttb))


def test_loss_and_image_match(stepped):
    j, t = stepped["j"], stepped["t"]
    assert t["loss"] == pytest.approx(j["loss"], abs=1e-5)
    np.testing.assert_allclose(t["img"], j["img"], atol=1e-5)
    for k in ("l1", "ssim", "psnr", "loss_mask", "loss_surface", "loss"):
        assert float(t["tb"][k]) == pytest.approx(float(j["tb"][k]),
                                                  abs=1e-5), k
    assert not bool(t["tb"]["overflow"]) and not bool(j["tb"]["overflow"])
    assert int(t["tb"]["n_visible"]) == int(j["tb"]["n_visible"])


def _rel(a, b, tol):
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=tol)


@pytest.mark.parametrize("name", PARAMS)
def test_param_gradients_match(stepped, name):
    j, t = stepped["j"], stepped["t"]
    _rel(t["grads"][name].numpy(), j["grads"][name], 2.5e-3)


@pytest.mark.parametrize("name", PARAMS)
def test_param_gradients_match_float64(stepped, name):
    t = stepped["t"]
    _rel(t["grads"][name].numpy(), t["grads64"][name].numpy(), 1e-4)


@pytest.mark.parametrize("name", PARAMS)
def test_adam_moments_and_params_match(stepped, name):
    j, t = stepped["j"], stepped["t"]
    _rel(t["ost"]["m"][name].numpy(), j["ost"]["m"][name], 2.5e-3)
    _rel(t["ost"]["v"][name].numpy(), j["ost"]["v"][name], 5e-3)
    assert t["ost"]["step"] == int(j["ost"]["step"]) == 1
    lr = XYZ_LR if name == "xyz" else toptim.group_lrs(TOpt(), 1.0)[name]
    g = np.asarray(j["grads"][name])
    strong = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
    a = t["new"]["params"][name].numpy()
    b = np.asarray(j["new"]["params"][name])
    np.testing.assert_allclose(a[strong], b[strong], atol=1e-7, rtol=1e-6)
    assert np.abs(a - b).max() <= 2 * lr * (1 + 1e-5)


def test_densification_stats_match(stepped):
    js, ts = stepped["j"]["new"]["stats"], stepped["t"]["new"]["stats"]
    for k in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]),
                                      err_msg=k)
    _rel(ts["xyz_gradient_accum"].numpy(), js["xyz_gradient_accum"], 2.5e-3)
    _rel(ts["weights_accum"].numpy(), js["weights_accum"], 1e-5)


def test_init_from_points_matches():
    """Including the 3-NN scale initialization (computed, not injected)."""
    pts, cols, _ = _inputs()
    js = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                             normals=jnp.asarray(pts), capacity=256,
                             rotation_init="normal")
    ts = TG.init_from_points(pts, cols, normals=pts, capacity=256,
                             rotation_init="normal", device="cpu")
    for k in PARAMS:
        np.testing.assert_allclose(ts["params"][k].numpy(),
                                   np.asarray(js["params"][k]), atol=2e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(ts["alive"].numpy(), np.asarray(js["alive"]))
    back = TG.params_to_numpy(TG.params_from_jax(
        jax.device_get(js["params"]), device="cpu"))
    for k in PARAMS:
        np.testing.assert_array_equal(back[k], np.asarray(js["params"][k]))


def test_train_stage1_runs_then_refuses_to_skip_densification():
    pts, cols, img = _inputs()
    state = TG.init_from_points(pts, cols, normals=pts, capacity=256,
                                rotation_init="normal", device="cpu")
    cam = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                    fovx=np.pi / 3, fovy=np.pi / 3, width=32, height=32,
                    image=img[:, :32, :32], device="cpu")
    opt = TOpt(densify_from_iter=2, densification_interval=3)
    cfg = TCfg(max_instances=1 << 14)
    st, _, hist = ttrainer.train_stage1(state, [cam], opt, raster_cfg=cfg,
                                        iterations=2, log_every=1,
                                        device="cpu")
    assert [h["iter"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert not torch.equal(st["params"]["xyz"], state["params"]["xyz"])
    with pytest.raises(NotImplementedError):
        ttrainer.train_stage1(state, [cam], opt, raster_cfg=cfg,
                              iterations=3, log_every=1, device="cpu")


def test_port_imports_neither_jax_nor_svgir_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import svgir_tpu_torch\n"
        "for m in pkgutil.walk_packages(svgir_tpu_torch.__path__,"
        " 'svgir_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'svgir_tpu' or m.startswith('svgir_tpu.')]\n"
        "assert not bad, bad\n"
        "stage2 = ['render.svgss', 'models.lights', 'models.radiance',"
        " 'ops.shading', 'ops.env_lookup_pallas', 'kernels.env_lookup']\n"
        "missing = [m for m in stage2 if 'svgir_tpu_torch.' + m"
        " not in sys.modules]\n"
        "assert not missing, missing\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

