"""eval_nvs's default scale 4 on surfels fitted at scale 1, port against
svgir_tpu on the CPU.

A model fitted at 800x800 has surfels of about a pixel there; eval_nvs
renders it at 200x200, where their own screen footprint falls under the
rasterizer's fixed +0.3 px^2 low-pass dilation (``_ewa_cov2d``), so the
dilation sets their size and they cover more than their share of each
pixel.  This holds the port to the reference in that regime: a sphere of
small surfels rendered at 64x64 and, through each package's
``camera_at_scale``, at 16x16, scored against the 64x64 render
area-resampled to 16x16 (as eval_nvs scores a view against its
area-resampled image).  Tolerances: images 1e-5, PSNR 1e-3 dB.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.cameras import camera_at_scale as j_camera_at_scale
from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.eval import metrics as JM
from svgir_tpu.models import gaussians as JG
from svgir_tpu.render.stage1 import render_stage1 as j_render_stage1

from svgir_tpu_torch.cameras import camera_at_scale as t_camera_at_scale
from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import OptimizationConfig as TOpt
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.eval import metrics as TM
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.ops import preprocess as TP
from svgir_tpu_torch.render.stage1 import render_stage1 as t_render_stage1

from tests.scenes import default_camera, sphere_scene

W = 64
SCALE = 4
N = 2000
DILATION = 0.3          # px^2, the rasterizer's low-pass variance


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_render(cam, params, alive):
    return j_render_stage1(cam, params, jnp.zeros(3), opt=JOpt(),
                           is_training=False, alive=alive,
                           cfg=JCfg(max_instances=1 << 14))


def _t_render(cam, params, alive):
    return t_render_stage1(cam, params, torch.zeros(3), opt=TOpt(),
                           is_training=False, alive=alive,
                           cfg=TCfg(max_instances=1 << 14))


@pytest.fixture(scope="module")
def rendered():
    sc = sphere_scene(jax.random.PRNGKey(5), n=N)
    pts, cols = np.asarray(sc["means"]), np.asarray(sc["colors"])
    jstate = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                                 normals=jnp.asarray(pts), capacity=N,
                                 rotation_init="normal")
    # opaque surfels, as a fitted surface has
    jparams = dict(jstate["params"], opacity=jnp.full(
        (N, 1), math.log(0.9 / 0.1), jnp.float32))
    jalive = jstate["alive"]
    tparams = TG.params_from_jax(jax.device_get(jparams), device="cpu")
    talive = torch.as_tensor(np.array(jalive))

    fine = _j_render(default_camera(W, W), jparams, jalive)
    gt = np.clip(np.asarray(fine["render"]), 0, 1)
    jcam = j_camera_at_scale(
        dataclasses.replace(default_camera(W, W), image=gt), SCALE)
    tcam1 = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0],
                      up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                      width=W, height=W, image=gt, device="cpu")
    tcam = t_camera_at_scale(tcam1, SCALE)

    own = []            # each render's alive surfels in front
    orig = TP._ewa_cov2d

    def record(p_view, *args):
        out = orig(p_view, *args)
        rows = talive & (p_view[:, 2] > 0.2)
        own.append(torch.maximum(out[:, 0], out[:, 2])[rows] - DILATION)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "_ewa_cov2d", record)
        t_fine = _t_render(tcam1, tparams, talive)
        t_small = _t_render(tcam, tparams, talive)
    j_small = _j_render(jcam, jparams, jalive)
    return dict(fine=(np.asarray(fine["render"]), t_fine["render"].numpy()),
                small=(np.asarray(j_small["render"]),
                       t_small["render"].numpy()),
                jcam=jcam, tcam=tcam, own=own)


def test_scale4_images_match_jax(rendered):
    for key in ("fine", "small"):
        j, t = rendered[key]
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=key)
    small = rendered["small"][1]
    assert small.shape == (3, W // SCALE, W // SCALE)
    assert float((small.sum(0) > 0.05).mean()) > 0.2      # the sphere shows
    np.testing.assert_allclose(rendered["tcam"].image.numpy(),
                               np.asarray(rendered["jcam"].image),
                               atol=1e-6, rtol=0)


def test_scale4_psnr_matches_jax(rendered):
    j, t = rendered["small"]
    jp = JM.psnr(jnp.clip(j, 0, 1), rendered["jcam"].image)
    tp = TM.psnr(torch.clamp(torch.as_tensor(t), 0, 1),
                 rendered["tcam"].image)
    assert math.isfinite(tp) and abs(tp - jp) < 1e-3, (tp, jp)


def test_scale4_footprints_under_the_dilation(rendered):
    """The regime of the recipe's eval: at scale 1 the surfels' own
    footprints are above the dilation, at scale 4 under it."""
    assert len(rendered["own"]) == 2
    fine, small = rendered["own"]
    assert float((fine < DILATION).float().mean()) < 0.1
    assert float((small < DILATION).float().mean()) > 0.9
