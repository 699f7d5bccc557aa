"""svgir_tpu_torch's stage-2 loop on the CPU: ``train_stage2`` with a given
(synthetic) radiance bake fits a tiny scene, and refuses what it does not
implement yet.

The port's counterpart of ``test_stage2_trains`` in
tests/test_stage2_training.py, without the bake (``bake_radiance`` is not
ported yet): the bake's buffers are made as ``bench_stage2.py`` makes
them.  Port only, so no tolerance against the reference: the loss must
fall and every state must stay finite.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.train.trainer import train_stage2
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize

CFG = RasterConfig(max_instances=1 << 14)
N, S, RES = 50, 8, 32


def _setup():
    """A PBR-upgraded sphere of surfels, four cameras whose images are the
    scene's own stage-1 renders, and a synthetic bake."""
    g = torch.Generator().manual_seed(0)
    dirs = normalize(torch.randn(N, 3, generator=g))
    state = G.upgrade_to_pbr(G.init_from_points(
        dirs, torch.full((N, 3), 0.6), normals=dirs, capacity=N,
        rotation_init="normal", device="cpu"))
    p = state["params"]
    bg = torch.zeros(3)
    cams = []
    for i in range(4):
        a = 2 * math.pi * i / 4
        cam = look_at_camera(eye=[3 * math.sin(a), 0.4, -3 * math.cos(a)],
                             target=[0, 0, 0], up=[0, -1, 0],
                             fovx=math.pi / 3, fovy=math.pi / 3, width=RES,
                             height=RES, device="cpu")
        with torch.no_grad():
            img = rasterize(p["xyz"], G.get_scaling(p), G.get_rotation(p),
                            G.get_opacity(p)[:, 0], cam, bg,
                            shs=G.get_shs(p), cfg=CFG).color.clamp(0, 1)
        cams.append(dataclasses.replace(cam, image=img,
                                        image_mask=torch.ones(1, RES, RES)))
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(N, S, 3, generator=g)[:, 0]), S)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {
        "radiance": torch.rand(N, S, 3, generator=g),
        "visibility": (torch.rand(N, S, 1, generator=g) > 0.3).float(),
        "incident_dirs": inc, "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": torch.randint(-1, N, (N, S), generator=g),
        "uv": torch.rand(N, S, 2, generator=g),
    }
    return state, cams, bake


def test_train_stage2_fits_with_a_given_bake():
    state, cams, bake = _setup()
    opt = OptimizationConfig(lambda_base_color_smooth=0.1,
                             lambda_roughness_smooth=0.05,
                             lambda_env_smooth=0.02)
    st, ost, env, bake_out, hist = train_stage2(
        state, cams, opt, bake=bake, raster_cfg=CFG, sample_num=S,
        env_resolution=8, first_iter=0, iterations=12, log_every=3,
        device="cpu")
    losses = [h["loss"] for h in hist]
    assert [h["iter"] for h in hist] == [3, 6, 9, 12]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert ost["step"] == 12 and env["opt"]["step"] == 12
    assert env["params"]["env"].shape == (8, 16, 3)
    for k, v in list(st["params"].items()) + [("env", env["params"]["env"])]:
        assert bool(torch.isfinite(v).all()), k
    # radiances were initialized from the bake; the env map moved
    assert torch.equal(st["params"]["radiances"], bake["radiance"])
    assert float(env["opt"]["m"]["env"].abs().max()) > 0
    assert "exhausted_frac" not in bake_out


@pytest.mark.parametrize("first,rates", [(998, [1e-4, 1e-4, 0.0]),
                                         (31_000, [0.0, 0.0, 0.0])])
def test_train_stage2_zeroes_the_radiance_lr_after_a_thousand(
        monkeypatch, first, rates):
    """train.py:211-214: the radiance learning rate drops to zero after the
    first iteration that is a multiple of 1000, and stays zero when a run
    resumes past 31,000."""
    from svgir_tpu_torch.train import trainer
    state, cams, bake = _setup()
    seen, make = [], trainer.make_svgss_train_step

    def recording(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            seen.append(args[-1])
            return step(*args)
        return run
    monkeypatch.setattr(trainer, "make_svgss_train_step", recording)
    train_stage2(state, cams[:1], OptimizationConfig(radiance_lr=1e-4),
                 bake=bake, raster_cfg=CFG, sample_num=S, env_resolution=8,
                 first_iter=first, iterations=first + 3, log_every=1,
                 device="cpu")
    assert seen == rates


@pytest.mark.parametrize("kw", [dict(bake=None), dict(checkpoint_interval=5),
                                dict(test_interval=5), dict(vis_interval=5)],
                         ids=["no_bake", "checkpoint", "test", "vis"])
def test_train_stage2_refuses_what_is_not_ported(kw):
    state, cams, bake = _setup()
    args = dict(bake=bake, raster_cfg=CFG, sample_num=S, first_iter=0,
                iterations=2, device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError,
                       match="bake_radiance" if "bake" in kw else "interval"):
        train_stage2(state, cams, OptimizationConfig(), **args)


def test_train_stage2_grows_the_instance_cap_on_overflow(monkeypatch):
    from svgir_tpu_torch.train import trainer
    state, cams, bake = _setup()
    caps, make = [], trainer.make_svgss_train_step

    def recording(opt, cfg, *a, **kw):
        caps.append(cfg.max_instances)
        return make(opt, cfg, *a, **kw)
    monkeypatch.setattr(trainer, "make_svgss_train_step", recording)
    cam = look_at_camera(eye=[0, 0.4, -3], target=[0, 0, 0], up=[0, -1, 0],
                         fovx=math.pi / 3, fovy=math.pi / 3, width=96,
                         height=96, image=np.zeros((3, 96, 96)), device="cpu")
    _, _, _, _, hist = train_stage2(
        state, [cam], OptimizationConfig(), bake=bake,
        raster_cfg=RasterConfig(max_instances=256), sample_num=S,
        env_resolution=8, first_iter=0, iterations=2, log_every=1,
        device="cpu")
    assert hist[0].get("overflow") == 1.0
    assert caps[:2] == [256, 512]
