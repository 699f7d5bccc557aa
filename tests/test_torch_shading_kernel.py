"""Stage 2's training shading (``svgir_tpu_torch.ops.shading.shade_train``,
the kernel pair of ``csrc/shading.cu`` on the card) on the CPU.

* ``shade_train`` on CPU tensors: ``rendering_equation4``'s pbr and
  diffuse light and autograd's gradients through it, bit for bit, and no
  kernel launch (``tests/test_torch_svgss.py`` holds that route to
  ``svgir_tpu`` in float64); a tensor on any other device is refused.
* ``render_svgss(is_training=True)`` through ``shade_train`` against the
  same step through ``rendering_equation4``: the loss within 1e-6
  relative and every gradient within 2e-5 of its largest magnitude.
* ``shade_train`` refuses a gradient on the bake's visibility, directions
  or areas; the kernel wrappers refuse CPU tensors.
* On a CUDA device (marked ``card``, skipped here): the kernels against
  ``rendering_equation4`` in float64 and autograd's gradients through it,
  on the rows of ``tests/torch_kernel_inputs.shade_rows`` (random, and
  built to meet the clamps' bounds), no further than 1.9 times the same
  evaluation's in float32 on the card (or 1e-6 of each output's largest
  magnitude).  On the card, without JAX: ``python -m pytest --noconftest
  -o addopts= -p no:cacheprovider tests/test_torch_shading_kernel.py -m
  card``.

Imports no JAX: its card test runs on a machine without it.
"""

import dataclasses
import math

import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.kernels import shading as KS
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.ops import shading as SH
from svgir_tpu_torch.render import svgss
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize

# by its own name, not as ``tests.torch_kernel_inputs``: another ``tests``
# package installed on the card's machine takes that name
from torch_kernel_inputs import SHADE_INPUTS, SHADE_S, shade_rows

S = SHADE_S
NAMES, BAKE = SHADE_INPUTS[:6], SHADE_INPUTS[6:]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread for the module under the parallel
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/shading.cu "
                    "run only there")
    return torch.device("cuda:0")


def _args(x):
    return [x[k] for k in SHADE_INPUTS]


def _autograd(x, d_pbr, d_dl):
    """pbr, diffuse light and the six gradients through
    rendering_equation4."""
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in x.items()}
    pbr, extra = SH.rendering_equation4(
        leaves["base_color"], leaves["roughness"], leaves["normals"],
        leaves["viewdirs"], leaves["radiance"], None, leaves["visibility"],
        leaves["incident_dirs"], leaves["incident_areas"],
        env_radiance=leaves["env_radiance"])
    dl = extra["diffuse_light"]
    grads = torch.autograd.grad((pbr * d_pbr).sum() + (dl * d_dl).sum(),
                                [leaves[k] for k in NAMES])
    return pbr.detach(), dl.detach(), grads


def test_function_takes_the_plain_version_on_the_cpu():
    """shade_train on CPU tensors: rendering_equation4's values and
    autograd's gradients through it, bit for bit, and no kernel launch."""
    x, d_pbr, d_dl = shade_rows(True)
    x = {k: v.float() for k, v in x.items()}
    d_pbr, d_dl = d_pbr.float(), d_dl.float()
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in x.items()}
    kernels.reset_launches()
    pbr, dl = SH.shade_train(*_args(leaves))
    grads = torch.autograd.grad((pbr * d_pbr).sum() + (dl * d_dl).sum(),
                                [leaves[k] for k in NAMES])
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
    want = _autograd(x, d_pbr, d_dl)
    for a, b in zip((pbr.detach(), dl.detach()) + grads,
                    (want[0], want[1]) + want[2]):
        assert torch.equal(a, b)


def test_shade_train_refuses_a_device_that_is_neither_cpu_nor_cuda():
    x, _, _ = shade_rows(False)
    meta = [v.float().to("meta") for v in _args(x)]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="meta"):
        SH.shade_train(*meta)
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}


@pytest.mark.parametrize("name", BAKE)
def test_function_refuses_a_gradient_on_the_bake(name):
    x, _, _ = shade_rows(False)
    x = {k: v.float() for k, v in x.items()}
    x[name] = x[name].clone().requires_grad_(True)
    with pytest.raises(ValueError, match=name):
        SH.shade_train(*_args(x))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, d_pbr, d_dl = shade_rows(False)
    args = [v.float() for v in _args(x)]
    with pytest.raises(ValueError, match="CUDA"):
        KS.shading_forward(*args)
    with pytest.raises(ValueError, match="CUDA"):
        KS.shading_backward(*args, d_pbr.float(), d_dl.float())


# ---------------------------------------------------------------------------
# the training render through shade_train against rendering_equation4
# ---------------------------------------------------------------------------

ALIVE, CAP, RES = 40, 48, 32
CFG = RasterConfig(max_instances=1 << 13)


def _stage2_scene():
    """A sphere of 40 alive surfels in 48 rows facing out, upgraded to PBR
    with random materials, a synthetic bake (S = 8), an 8x16 env and one
    32 x 32 view; the recipe's optional losses on, the light losses
    among them (they read the diffuse light)."""
    g = torch.Generator().manual_seed(3)
    dirs = normalize(torch.randn(ALIVE, 3, generator=g))
    state = G.upgrade_to_pbr(G.init_from_points(
        dirs, torch.full((ALIVE, 3), 0.6), normals=dirs, capacity=CAP,
        rotation_init="normal", device="cpu"))
    params = dict(state["params"])
    for k, scale in (("base_color", 0.5), ("roughness", 0.5),
                     ("normal", 0.1)):
        params[k] = scale * torch.randn(params[k].shape, generator=g)
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(CAP, 3, generator=g)), S)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {"radiance": torch.rand(CAP, S, 3, generator=g),
            "visibility": (torch.rand(CAP, S, 1, generator=g) > 0.3).float(),
            "incident_dirs": inc, "incident_areas": areas,
            "incident_qxy": torch.stack([qx, qy], -1),
            "hit_idx": torch.randint(-1, CAP, (CAP, S), generator=g),
            "uv": torch.rand(CAP, S, 2, generator=g)}
    params["radiances"] = bake["radiance"].clone()
    params["radiance_ratio"] = torch.ones(())
    env = LT.direct_light_map_init(8, generator=g, device="cpu")
    cam = look_at_camera(eye=[0.4, 0.3, -3.0], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=RES, height=RES, device="cpu")
    cam = dataclasses.replace(
        cam, image=torch.rand(3, RES, RES, generator=g),
        image_mask=torch.ones(1, RES, RES))
    opt = OptimizationConfig(
        lambda_base_color_smooth=0.1, lambda_roughness_smooth=0.05,
        lambda_env_smooth=0.02, lambda_normal_smooth=0.02,
        lambda_light_smooth=1.0, lambda_light=0.02,
        lambda_mask_entropy=0.01)
    return params, state["alive"], bake, env, cam, opt


def _loss_and_grads(params, alive, bake, env, cam, opt):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    env_leaf = env["params"]["env"].detach().clone().requires_grad_(True)
    res = svgss.render_svgss(cam, leaves, torch.zeros(3), bake=bake,
                             env_params={"env": env_leaf}, opt=opt,
                             iteration=1.0, is_training=True, alive=alive,
                             cfg=CFG)
    keys = sorted(leaves)
    grads = torch.autograd.grad(res["loss"], [leaves[k] for k in keys]
                                + [env_leaf], allow_unused=True)
    out = dict(zip(keys + ["env"], grads))
    return res["loss"].detach(), res["diffuse_light"].detach(), out


def test_training_render_matches_the_rendering_equation4_path(monkeypatch):
    sc = _stage2_scene()
    loss, dl, grads = _loss_and_grads(*sc)

    def through_rendering_equation4(bc, rough, nrm, vd, rad, env_rad, vis,
                                    dirs, areas):
        pbr, extra = SH.rendering_equation4(bc, rough, nrm, vd, rad, None,
                                            vis, dirs, areas,
                                            env_radiance=env_rad)
        return pbr, extra["diffuse_light"]

    monkeypatch.setattr(svgss, "shade_train", through_rendering_equation4)
    ref_loss, ref_dl, ref_grads = _loss_and_grads(*sc)
    assert abs(float(loss - ref_loss)) <= 1e-6 * abs(float(ref_loss))
    torch.testing.assert_close(dl, ref_dl, rtol=0, atol=1e-5)
    moved = 0
    for k, ref in ref_grads.items():
        got = grads[k]
        if ref is None:
            assert got is None, k
            continue
        scale = float(ref.abs().max())
        if scale == 0:
            assert float(got.abs().max()) == 0, k
            continue
        moved += 1
        err = float((got - ref).abs().max()) / scale
        assert err < 2e-5, (k, err)
    # the shading's inputs all take a gradient through the step
    for k in ("base_color", "roughness", "normal", "xyz", "radiance_ratio",
              "env"):
        assert grads[k] is not None and float(grads[k].abs().max()) > 0, k
    assert moved >= 10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_kernels_match_the_plain_version(card, edges):
    """The kernels' pbr, diffuse light and six gradients against
    rendering_equation4 in float64 and autograd's gradients through it,
    each within 1.9 times the distance of the same evaluation in float32 on
    the card from it, or 1e-6 of the output's largest magnitude; one launch
    of each.  (Until the float32 yardstick was autograd's, it was the
    kernels' hand-derived mirror, held at 2x; autograd's lies up to 1.03x
    as far from float64 on these rows, so 1.9 keeps every bar.)"""
    x, d_pbr, d_dl = shade_rows(edges)
    pbr64, dl64, g64 = _autograd(x, d_pbr, d_dl)
    ref = (pbr64, dl64) + g64
    xc = {k: v.float().to(card) for k, v in x.items()}
    gp, gd = d_pbr.float().to(card), d_dl.float().to(card)
    pbr32, dl32, g32 = _autograd(xc, gp, gd)
    f32 = (pbr32, dl32) + g32
    kernels.reset_launches()
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in xc.items()}
    pbr, dl = SH.shade_train(*_args(leaves))
    grads = torch.autograd.grad((pbr * gp).sum() + (dl * gd).sum(),
                                [leaves[k] for k in NAMES])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shading_forward"] == 1
    assert kernels.LAUNCHES["shading_backward"] == 1
    got = (pbr.detach(), dl.detach()) + grads
    for name, k, r, p in zip(("pbr", "diffuse_light") + NAMES, got, ref,
                             f32):
        scale = float(r.abs().max())
        e_k = float((k.double().cpu() - r).abs().max()) / scale
        e_p = float((p.double().cpu() - r).abs().max()) / scale
        assert e_k <= max(1.9 * e_p, 1e-6), (name, e_k, e_p)
