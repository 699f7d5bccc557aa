"""svgir_tpu_torch's stage-2 loop on the CPU: ``train_stage2`` with a given
(synthetic) radiance bake fits a tiny scene, runs its periodic checkpoints
and test PSNR and refuses the one periodic task it does not implement yet;
without a bake it bakes first and trains like the JAX loop.

``test_train_stage2_fits_with_a_given_bake`` is the port's counterpart of
``test_stage2_trains`` in tests/test_stage2_training.py, with the bake's
buffers made as ``bench_stage2.py`` makes them: port only, the loss must
fall and every state must stay finite.
``test_train_stage2_bakes_and_trains_like_jax`` holds the loop with its
own bake to ``svgir_tpu``'s on the same azimuth draws.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.cameras import look_at_camera as j_look_at
from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.models import gaussians as JG
from svgir_tpu.train import optim as joptim
from svgir_tpu.train import trainer as jtrainer

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.train import optim as toptim
from svgir_tpu_torch.train import trainer as ttrainer
from svgir_tpu_torch.train.trainer import train_stage2
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize


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


@pytest.mark.parametrize("kw", [dict(checkpoint_interval=5),
                                dict(test_interval=5), dict(vis_interval=5)],
                         ids=["checkpoint", "test", "vis"])
def test_train_stage2_refuses_what_is_not_ported(kw, tmp_path):
    """Every periodic task runs now (the name is kept from when the
    training visualisation was refused): the checkpoints (with the env
    map and the bake), the test PSNR, and the training visualisation, which
    writes the iteration's view beside its ground truth into
    ``visualize/iter_<iter>.png``."""
    state, cams, bake = _setup()
    args = dict(bake=bake, raster_cfg=CFG, sample_num=S, first_iter=0,
                iterations=2, log_every=10, device="cpu",
                out_dir=str(tmp_path))
    args.update({k: v // 5 for k, v in kw.items()})   # every iteration
    if "vis_interval" in kw:
        import cv2
        train_stage2(state, cams, OptimizationConfig(), **args)
        for it in (1, 2):
            img = cv2.imread(str(tmp_path / "visualize"
                                 / f"iter_{it:06d}.png"))
            # ground truth, render, pbr, base colour, roughness, local
            # lights, visibility, normal, pseudo-normal, depth, opacity
            assert img.shape == (RES, 11 * RES, 3), img.shape
            assert img.std() > 0
        return
    if "test_interval" in kw:
        args["test_cameras"] = cams
    _, _, env, bake_out, hist = train_stage2(state, cams,
                                             OptimizationConfig(), **args)
    assert [h["iter"] for h in hist] == [1, 2]
    if "test_interval" in kw:
        # the views are the start state's own renders: inf at first
        assert all(h["test_psnr"] > 20 for h in hist)
        return
    from svgir_tpu_torch.train import checkpoint as CK
    it, tree = CK.load_checkpoint(str(tmp_path / "chkpnt2.npz"), "cpu")
    assert it == 2 and hist[-1]["checkpoint"] == 2.0
    assert torch.equal(tree["env"]["params"]["env"], env["params"]["env"])
    for k, v in bake_out.items():
        assert torch.equal(tree["extra"][k], v), k
    assert (tmp_path / "chkpnt1.npz").exists()


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


W = H = 32         # the JAX-parity scene's image


def _stage2_scene():
    """A PBR state of 160 surfels on a sphere of radius 0.35 facing its
    centre (normals more than 60 degrees from -z), its target image and env
    map, as numpy.  The camera sits inside, looking down -z: the surfels
    fill its view, so no pixel's depth normal is formed from the near-zero
    opacity of an edge, where depth2normal turns float32 rounding into a
    2e-3 relative difference of the surface loss between the packages."""
    rng = np.random.default_rng(41)
    d = rng.standard_normal((600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d[d[:, 2] < 0.5][:160]
    st = G.upgrade_to_pbr(G.init_from_points(
        d * 0.35, rng.random((160, 3)).astype(np.float32), normals=-d,
        capacity=192, rotation_init="normal", device="cpu"))
    p = G.params_to_numpy(st["params"])
    p["opacity"] = np.where(np.arange(192)[:, None] < 160,
                            rng.normal(size=(192, 1)) + 1.0,
                            -10.0).astype(np.float32)
    p["scaling"] = (p["scaling"] + 0.4).astype(np.float32)
    p["base_color"] = (0.5 * rng.normal(size=(192, 12))).astype(np.float32)
    p["roughness"] = (0.5 * rng.normal(size=(192, 4))).astype(np.float32)
    env = (0.5 * rng.normal(size=(8, 16, 3)) + 1.0).astype(np.float32)
    img = rng.random((3, H, W)).astype(np.float32)
    return p, st["alive"].numpy(), env, img


CAM = dict(eye=[0.01, 0.02, 0.0], target=[0.0, 0.0, -1.0], up=[0, -1, 0],
           fovx=math.pi / 3, fovy=math.pi / 3, width=W, height=H)


def test_train_stage2_bakes_and_trains_like_jax():
    """``train_stage2(bake=None)``: three steps from the port's own bake
    against the JAX loop with ``bake_key``, the port given the same
    azimuth draws; the env map is given to both."""
    p, alive, env, img = _stage2_scene()
    key = jax.random.PRNGKey(9)
    kw = dict(sample_num=8, env_resolution=8, first_iter=0, iterations=3,
              log_every=1)
    jcam = dataclasses.replace(j_look_at(**CAM), image=jnp.asarray(img),
                               image_mask=jnp.ones((1, H, W)))
    jstate = {"params": {k: jnp.asarray(v) for k, v in p.items()},
              "alive": jnp.asarray(alive),
              "stats": JG.init_stats(alive.shape[0])}
    jenv = {"params": {"env": jnp.asarray(env)}}
    jenv["opt"] = joptim.adam_init(jenv["params"])
    _, _, _, jbake, jhist = jtrainer.train_stage2(
        jstate, [jcam], JOpt(), raster_cfg=JCfg(max_instances=1 << 14),
        bake_key=key, env_state=jenv, **kw)

    tcam = look_at_camera(**CAM, image=img, device="cpu")
    tstate = {"params": G.params_from_jax(p, device="cpu"),
              "alive": torch.as_tensor(alive),
              "stats": G.init_stats(alive.shape[0], device="cpu")}
    tenv = {"params": {"env": torch.as_tensor(env)}}
    tenv["opt"] = toptim.adam_init(tenv["params"])
    az = torch.as_tensor(np.array(jax.random.uniform(key,
                                                     (int(alive.sum()), 1))))
    _, _, _, tbake, thist = ttrainer.train_stage2(
        tstate, [tcam], OptimizationConfig(),
        raster_cfg=RasterConfig(max_instances=1 << 14), bake_azimuth=az,
        env_state=tenv, device="cpu", **kw)

    np.testing.assert_array_equal(tbake["hit_idx"].numpy(),
                                  np.asarray(jbake["hit_idx"]))
    assert int((tbake["hit_idx"] >= 0).sum()) > 0
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5,
                               atol=1e-5)
