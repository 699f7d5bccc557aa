"""svgir_tpu_torch's stage-1 loop fits a synthetic scene on the CPU.

The port's counterpart of ``test_stage1_fits_synthetic_scene`` in
tests/test_training.py, with its densification cadence.  Port only: the
two packages draw different split noise, so the runs are not step for step
comparable (tests/test_torch_train_step.py holds the loops to each other
with the noise injected)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.render.stage1 import render_view_stage1
from svgir_tpu_torch.train.trainer import train_stage1
from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """The loop's larger ops gain from a second thread, but under the
    parallel test run a full pool waits for descheduled threads: beside six
    busy processes this test took 298 s on 8 threads, 41 s on 2 and 62 s on
    one (24 s on 8 alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_train_stage1_fits_synthetic_scene():
    """60 opaque surfels seen by a ring of six 64x64 cameras, refit from
    jittered positions and grey colors over 120 steps that densify at 40
    and 80: the mean PSNR over all cameras must rise by more than 1 dB,
    and densification must leave at least the 60 surfels alive."""
    cfg = RasterConfig(max_instances=1 << 14)
    rng = np.random.default_rng(0)
    n = 60
    dirs = normalize(torch.as_tensor(rng.normal(size=(n, 3)),
                                     dtype=torch.float32))
    scales = torch.full((n, 3), 0.25)
    scales[:, 2] = 0.0
    colors = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 3)),
                             dtype=torch.float32)
    cams = []
    for i in range(6):
        a = 2 * math.pi * i / 6
        cam = look_at_camera(eye=[3 * math.sin(a), 0.5, -3 * math.cos(a)],
                             target=[0, 0, 0], up=[0, -1, 0],
                             fovx=math.pi / 3, fovy=math.pi / 3, width=64,
                             height=64, device="cpu")
        with torch.no_grad():
            b = rasterize(dirs, scales, normal_to_rotation(dirs),
                          torch.full((n,), 0.95), cam, torch.zeros(3),
                          colors=colors, cfg=cfg)
        cams.append(dataclasses.replace(cam, image=b.color.clamp(0, 1),
                                        image_mask=torch.ones(1, 64, 64)))
    init = dirs + 0.1 * torch.as_tensor(rng.normal(size=(n, 3)),
                                        dtype=torch.float32)
    state = G.init_from_points(init, torch.full((n, 3), 0.5), capacity=4096,
                               device="cpu")

    def mean_psnr(st):
        vals = []
        with torch.no_grad():
            for cam in cams:
                r = render_view_stage1(cam, st["params"], torch.zeros(3),
                                       alive=st["alive"], cfg=cfg)
                mse = ((r["render"].clamp(0, 1) - cam.image) ** 2).mean()
                vals.append(float(-10 * torch.log10(mse)))
        return np.mean(vals)

    psnr0 = mean_psnr(state)
    opt = OptimizationConfig(iterations=120, densify_from_iter=30,
                             densify_until_iter=100,
                             densification_interval=40,
                             opacity_reset_interval=10_000,
                             position_lr_max_steps=120)
    state, _, history = train_stage1(
        state, cams, opt, bg=(0, 0, 0), raster_cfg=cfg, iterations=120,
        log_every=20, device="cpu")
    assert np.isfinite([h["loss"] for h in history]).all()
    psnr1 = mean_psnr(state)
    assert psnr1 > psnr0 + 1.0, f"no progress: {psnr0} -> {psnr1}"
    assert history[-1]["n_alive"] >= 60
    assert torch.isfinite(state["params"]["xyz"]).all()
