"""svgir_tpu_torch foundations against svgir_tpu: config defaults,
transforms, spherical harmonics, camera matrices.

The same numpy inputs (seeded) go through both packages on the CPU.
Tolerances: float32 elementwise math in both, so 1e-6 absolute on O(1)
values unless stated.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from svgir_tpu import config as jcfg
from svgir_tpu import cameras as jcams
from svgir_tpu.utils import sh as jsh
from svgir_tpu.utils import transforms as jtr

from svgir_tpu_torch import cameras as tcams
from svgir_tpu_torch import config as tcfg
from svgir_tpu_torch.utils import sh as tsh
from svgir_tpu_torch.utils import transforms as ttr


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


RNG = np.random.default_rng(1234)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


@pytest.mark.parametrize("name", ["ModelConfig", "OptimizationConfig",
                                  "RasterConfig", "PipelineConfig"])
def test_config_fields_and_defaults_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
    assert jf == tf


def test_quaternion_transforms_match():
    q = RNG.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(ttr.normalize(_t(q)).numpy(),
                               np.asarray(jtr.normalize(q)), atol=1e-6)
    R = ttr.quat_to_rotmat(_t(q)).numpy()
    np.testing.assert_allclose(R, np.asarray(jtr.quat_to_rotmat(q)), atol=1e-6)
    np.testing.assert_allclose(ttr.rotmat_to_quat(_t(R)).numpy(),
                               np.asarray(jtr.rotmat_to_quat(R)), atol=1e-5)


def test_normal_to_rotation_and_inverse_sigmoid_match():
    nrm = RNG.normal(size=(64, 3)).astype(np.float32)
    nrm[0] = [0.0, 0.0, 1.0]          # the x-helper branch
    np.testing.assert_allclose(ttr.normal_to_rotation(_t(nrm)).numpy(),
                               np.asarray(jtr.normal_to_rotation(nrm)),
                               atol=1e-5)
    x = RNG.uniform(0.01, 0.99, size=(32,)).astype(np.float32)
    np.testing.assert_allclose(ttr.inverse_sigmoid(_t(x)).numpy(),
                               np.asarray(jtr.inverse_sigmoid(x)), rtol=1e-6)


@pytest.mark.parametrize("delay", [0, 500])
def test_expon_lr_schedule_matches(delay):
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=delay,
              lr_delay_mult=0.01, max_steps=30_000)
    jf, tf = jtr.get_expon_lr_fn(**kw), ttr.get_expon_lr_fn(**kw)
    for step in (-1, 0, 1, 250, 1000, 29_999, 30_000, 40_000):
        assert tf(step) == pytest.approx(jf(step), rel=1e-12)


@pytest.mark.parametrize("active", [None, 0, 1, 2, 3])
def test_sh_to_rgb_clamped_matches(active):
    sh = RNG.normal(size=(40, 3, 16)).astype(np.float32) * 0.3
    dirs = RNG.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    jout = jsh.sh_to_rgb_clamped(3, sh, dirs, active_degree=active)
    tout = tsh.sh_to_rgb_clamped(3, _t(sh), _t(dirs), active_degree=active)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6)


def test_sh_basis_degree4_and_rgb_roundtrip_match():
    dirs = RNG.normal(size=(40, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_allclose(tsh.eval_sh_basis(4, _t(dirs)).numpy(),
                               np.asarray(jsh.eval_sh_basis(4, dirs)),
                               atol=1e-6)
    rgb = RNG.random((10, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(_t(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(rgb)), atol=1e-6)


@pytest.mark.parametrize("w,h", [(64, 64), (72, 40)])
def test_look_at_camera_matches(w, h):
    kw = dict(eye=[0.5, 0.4, -2.6], target=[0, 0, 0], up=[0, -1, 0],
              fovx=math.pi / 3, fovy=math.pi / 4, width=w, height=h)
    jc = jcams.look_at_camera(**kw)
    tc = tcams.look_at_camera(**kw, device="cpu")
    for f in ("world_view", "full_proj", "camera_center", "prcppoint"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    for f in ("tanfovx", "tanfovy", "focal_x", "focal_y", "width", "height"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.device.type == "cpu"


def test_make_camera_with_image_and_center_shift():
    R = np.eye(3, dtype=np.float32)
    T = np.array([0.1, -0.2, 3.0], np.float32)
    img = RNG.random((3, 24, 32)).astype(np.float32)
    kw = dict(R=R, T=T, fovx=1.0, fovy=0.8, width=32, height=24, fx=30.0,
              fy=28.0, cx=15.0, cy=12.5, image=img)
    jc = jcams.make_camera(**kw)
    tc = tcams.make_camera(**kw, device="cpu")
    np.testing.assert_array_equal(tc.full_proj.numpy(),
                                  np.asarray(jc.full_proj))
    np.testing.assert_array_equal(tc.image.numpy(), img)
    np.testing.assert_array_equal(tc.image_mask.numpy(),
                                  np.asarray(jc.image_mask))


def _images(seed, c=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    return (rng.random((c, h, w)).astype(np.float32),
            rng.random((c, h, w)).astype(np.float32))


def test_image_losses_match():
    """l1, SSIM (float32 both sides), PSNR, mask entropy, edge-aware."""
    from svgir_tpu.utils import losses as jl
    from svgir_tpu_torch.utils import losses as tl
    a, b = _images(5)
    for name in ("l1_loss", "ssim", "psnr", "first_order_edge_aware_loss"):
        jv = float(getattr(jl, name)(a, b))
        tv = float(getattr(tl, name)(_t(a), _t(b)))
        assert tv == pytest.approx(jv, rel=1e-5, abs=1e-6), name
    o, m = a[:1], (b[:1] > 0.5).astype(np.float32)
    assert float(tl.mask_entropy_loss(_t(o), _t(m))) == pytest.approx(
        float(jl.mask_entropy_loss(o, m)), rel=1e-5)


def test_cos_loss_matches():
    from svgir_tpu.utils import losses as jl
    from svgir_tpu_torch.utils import losses as tl
    a, b = _images(6)
    a, b = a - 0.5, b - 0.5
    w = (a[:1] > 0).astype(np.float32)
    assert float(tl.cos_loss(_t(a), _t(b), weight=_t(w))) == pytest.approx(
        float(jl.cos_loss(a, b, weight=w)), rel=1e-5)


def test_depth2normal_and_normal2curv_match():
    from svgir_tpu.utils import image as jim
    from svgir_tpu_torch.utils import image as tim
    rng = np.random.default_rng(7)
    depth = (2.0 + rng.random((1, 24, 32))).astype(np.float32)
    mask = (rng.random((1, 24, 32)) > 0.2).astype(np.float32)
    kw = dict(eye=[0.5, 0.4, -2.6], target=[0, 0, 0], up=[0, -1, 0],
              fovx=math.pi / 3, fovy=math.pi / 4, width=32, height=24)
    jn = jim.depth2normal(depth, mask, jcams.look_at_camera(**kw))
    tn = tim.depth2normal(_t(depth), _t(mask),
                          tcams.look_at_camera(**kw, device="cpu"))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    np.testing.assert_allclose(tim.normal2curv(tn, _t(mask)).numpy(),
                               np.asarray(jim.normal2curv(jn, mask)),
                               atol=1e-5)
