"""Densification of svgir_tpu_torch against svgir_tpu's on the CPU.

``densify_and_prune`` is fed the split noise the JAX function draws from
its key (``jax.random.normal(jax.random.split(key, 2)[i], (cap, 3))``), so
both packages place the same children.  The report's counts and the alive
masks must be equal; parameters and Adam moments agree within 1e-6
(absolute and relative: the two packages' exp, log and rotation round
differently in the last place).  ``reset_opacity`` and ``grow_capacity``
are held to the same tolerance.

The loop-level tests are the port's twins of tests/test_guards.py's
capacity-overflow growth and tests/test_training.py's checkpoint resume
(port against port, so the resume is held to 1e-6 with alive masks equal).
"""

import dataclasses
import math
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.models import gaussians as JG

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.ops.rasterizer import rasterize
from svgir_tpu_torch.train import checkpoint as CK
from svgir_tpu_torch.train.trainer import train_stage1
from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize

TOL = 1e-6
CFG = RasterConfig(max_instances=1 << 14)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small tensor ops.  Under the parallel test run
    the CPU is oversubscribed, and an op split over torch's thread pool
    waits for descheduled threads each time (the resume test took 170 s
    there against 4 s alone); one thread a module avoids that."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moments(params, rng):
    return {k: np.asarray(rng.random(np.shape(v)), np.float32)
            for k, v in params.items()}


def _case(name):
    """(state, opt_state, key, kwargs) as numpy / JAX values."""
    if name == "clone":       # test_training.py::test_densify_and_prune_shapes
        state = JG.init_from_points(
            jax.random.normal(jax.random.PRNGKey(0), (50, 3)),
            jnp.ones((50, 3)) * 0.5, capacity=256)
        st = jax.tree_util.tree_map(np.array, state)
        st["stats"]["xyz_gradient_accum"][:10] = 1.0
        st["stats"]["denom"][:50] = 1.0
        st["stats"]["weights_accum"][:50] = 1.0
        kw = dict(max_grad=0.5, min_opacity=0.005, extent=10000.0,
                  max_screen_size=None)
    elif name == "split":     # test_split_replaces_large_points
        state = JG.init_from_points(
            jax.random.normal(jax.random.PRNGKey(0), (20, 3)),
            jnp.ones((20, 3)) * 0.5, capacity=128)
        st = jax.tree_util.tree_map(np.array, state)
        st["params"]["scaling"][0] = np.log(5.0)
        st["stats"]["xyz_gradient_accum"][0] = 1.0
        st["stats"]["denom"][:20] = 1.0
        st["stats"]["weights_accum"][:20] = 1.0
        kw = dict(max_grad=0.5, min_opacity=0.005, extent=0.001,
                  max_screen_size=None)
    else:                     # clones, splits, both prunes, the size gate,
        rng = np.random.default_rng(7)    # and more demand than free slots
        n, cap = 50, 64
        state = JG.init_from_points(
            jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
            jnp.asarray(rng.random((n, 3)), jnp.float32), capacity=cap,
            normals=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
            rotation_init="normal")
        st = jax.tree_util.tree_map(np.array, state)
        p, s = st["params"], st["stats"]
        row_scale = rng.choice([0.004, 0.02, 0.5, 2.0], n,
                               p=[0.35, 0.25, 0.3, 0.1])
        p["scaling"][:n] = np.log(row_scale[:, None]
                                  * rng.uniform(0.5, 1.0, (n, 3)))
        p["opacity"][:n, 0] = rng.choice([-8.0, 0.0, 2.0], n)
        p["rotation"][:n] = rng.normal(size=(n, 4))
        s["xyz_gradient_accum"][:n, 0] = rng.choice([0.0, 0.3, 2.0], n,
                                                    p=[0.1, 0.1, 0.8])
        s["denom"][:n, 0] = rng.choice([0.0, 1.0, 3.0], n, p=[0.1, 0.6, 0.3])
        s["weights_accum"][:n, 0] = rng.choice([1e-7, 0.5], n, p=[0.2, 0.8])
        s["max_radii2d"][:n] = rng.choice([5.0, 30.0], n, p=[0.8, 0.2])
        kw = dict(max_grad=0.25, min_opacity=0.005, extent=10.0,
                  max_screen_size=20.0)
    rng = np.random.default_rng(1)
    opt = {"m": _moments(st["params"], rng), "v": _moments(st["params"], rng),
           "step": np.int32(3)}
    return st, opt, jax.random.PRNGKey(11), kw


def _to_torch(st, opt):
    tstate = {"params": TG.params_from_jax(st["params"], device="cpu"),
              "alive": torch.as_tensor(st["alive"]),
              "stats": TG.params_from_jax(st["stats"], device="cpu")}
    topt = {"m": TG.params_from_jax(opt["m"], device="cpu"),
            "v": TG.params_from_jax(opt["v"], device="cpu"),
            "step": int(opt["step"])}
    return tstate, topt


def jax_split_noise(key, cap):
    """The draws of svgir_tpu's densify_and_prune for ``key``."""
    keys = jax.random.split(key, 2)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.normal(k, (cap, 3))) for k in keys]))


def _close(a, b, what):
    np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=what)


def _same_state(t_state, t_opt, j_state, j_opt):
    np.testing.assert_array_equal(t_state["alive"].numpy(),
                                  np.asarray(j_state["alive"]))
    for k in j_state["params"]:
        _close(t_state["params"][k].numpy(), np.asarray(j_state["params"][k]),
               f"param {k}")
        for mom in ("m", "v"):
            _close(t_opt[mom][k].numpy(), np.asarray(j_opt[mom][k]),
                   f"moment {mom} of {k}")
    for k in j_state["stats"]:
        _close(t_state["stats"][k].numpy(), np.asarray(j_state["stats"][k]),
               f"stat {k}")


@pytest.mark.parametrize("name", ["clone", "split", "seeded"])
def test_densify_and_prune_matches_jax(name):
    st, opt, key, kw = _case(name)
    cap = st["alive"].shape[0]
    j_state, j_opt, j_rep = jax.jit(partial(JG.densify_and_prune, **kw))(
        jax.tree_util.tree_map(jnp.asarray, st),
        jax.tree_util.tree_map(jnp.asarray, opt), key)
    t_state, t_opt = _to_torch(st, opt)
    n0 = int(t_state["alive"].sum())
    t_state2, t_opt2, t_rep = TG.densify_and_prune(
        t_state, t_opt, jax_split_noise(key, cap), **kw)
    for k in ("n_clone", "n_split", "n_prune", "n_alive",
              "out_of_capacity"):
        assert int(t_rep[k]) == int(j_rep[k]), (k, t_rep[k], j_rep[k])
    _same_state(t_state2, t_opt2, j_state, j_opt)
    if name == "seeded":      # every kind of event happened
        assert int(t_rep["n_clone"]) > 0 and int(t_rep["n_split"]) > 0
        assert bool(t_rep["out_of_capacity"])
        ts, tp = t_state["stats"], t_state["params"]
        for why in (TG.get_opacity(tp)[:, 0] < kw["min_opacity"],
                    ts["weights_accum"][:, 0] < 1e-5,
                    ts["max_radii2d"] > kw["max_screen_size"],
                    TG.get_scaling(tp).max(1).values > 0.1 * kw["extent"]):
            assert bool((why & t_state["alive"]).any())
    else:
        assert int(t_rep["n_alive"]) == {"clone": 60, "split": 21}[name]
        assert int(t_rep["n_alive"]) > n0 - int(t_rep["n_prune"])

    # reset_opacity and grow_capacity on the densified states
    jp, jo = JG.reset_opacity(j_state["params"], j_opt)
    tp, to = TG.reset_opacity(t_state2["params"], t_opt2)
    _close(tp["opacity"].numpy(), np.asarray(jp["opacity"]), "reset opacity")
    assert not bool(to["m"]["opacity"].any()) and \
        not bool(to["v"]["opacity"].any())
    jg, jgo = JG.grow_capacity(j_state, j_opt, 2 * cap)
    tg, tgo = TG.grow_capacity(t_state2, t_opt2, 2 * cap)
    assert tg["alive"].shape[0] == 2 * cap
    _same_state(tg, tgo, jg, jgo)


def _ring_scene(n, res, k, seed=0):
    """Surfels on the unit sphere seen by ``k`` cameras on a ring, their
    images rendered by the port; a jittered grey start state."""
    rng = np.random.default_rng(seed)
    dirs = normalize(torch.as_tensor(rng.normal(size=(n, 3)),
                                     dtype=torch.float32))
    scales = torch.full((n, 3), 0.25)
    scales[:, 2] = 0.0
    colors = torch.as_tensor(rng.uniform(0.2, 1.0, (n, 3)),
                             dtype=torch.float32)
    cams = []
    for i in range(k):
        a = 2 * math.pi * i / k
        cam = look_at_camera(eye=[3 * math.sin(a), 0.5, -3 * math.cos(a)],
                             target=[0, 0, 0], up=[0, -1, 0],
                             fovx=math.pi / 3, fovy=math.pi / 3, width=res,
                             height=res, device="cpu")
        with torch.no_grad():
            b = rasterize(dirs, scales, normal_to_rotation(dirs),
                          torch.full((n,), 0.95), cam, torch.zeros(3),
                          colors=colors, cfg=CFG)
        cams.append(dataclasses.replace(cam, image=b.color.clamp(0, 1),
                                        image_mask=torch.ones(1, res, res)))
    init = dirs + 0.05 * torch.as_tensor(rng.normal(size=(n, 3)),
                                         dtype=torch.float32)
    return init, cams


def test_densify_capacity_overflow_warns_and_grows(capsys):
    """The twin of tests/test_guards.py's: capacity 64 with 50 alive stays
    under the 85% pre-grow, and a zero gradient threshold splits every
    surfel (100 children for 14 free slots): the loop warns and doubles
    the capacity."""
    init, cams = _ring_scene(50, 32, 3)
    state = TG.init_from_points(init, torch.full((50, 3), 0.5), capacity=64,
                                device="cpu")
    opt = OptimizationConfig(
        iterations=6, densify_from_iter=1, densify_until_iter=100,
        densification_interval=4, densify_grad_threshold=0.0,
        opacity_reset_interval=10_000, position_lr_max_steps=6)
    state, _, _ = train_stage1(state, cams, opt, raster_cfg=CFG,
                               iterations=6, log_every=100, seed=3,
                               device="cpu")
    out = capsys.readouterr().out
    assert "densify out of capacity" in out
    assert state["alive"].shape[0] == 128


def test_densify_pregrows_a_nearly_full_capacity(capsys):
    """56 alive in a capacity of 64 (past 85%): the loop doubles the
    capacity before it densifies, so nothing runs out of room."""
    init, cams = _ring_scene(56, 32, 3)
    state = TG.init_from_points(init, torch.full((56, 3), 0.5), capacity=64,
                                device="cpu")
    opt = OptimizationConfig(
        iterations=4, densify_from_iter=1, densification_interval=4,
        opacity_reset_interval=10_000, position_lr_max_steps=4)
    state, _, _ = train_stage1(state, cams, opt, raster_cfg=CFG,
                               iterations=4, log_every=100, device="cpu")
    assert state["alive"].shape[0] == 128
    assert "out of capacity" not in capsys.readouterr().out


@pytest.mark.parametrize("iterations", [2, 4])
def test_densify_acts_past_densify_from_iter_on_its_interval(iterations):
    """With a zero gradient threshold every surfel clones or splits at a
    densify; none happens at densify_from_iter itself (2), one at 4."""
    init, cams = _ring_scene(20, 32, 2)
    state = TG.init_from_points(init, torch.full((20, 3), 0.5), capacity=64,
                                device="cpu")
    opt = OptimizationConfig(
        iterations=iterations, densify_from_iter=2, densification_interval=2,
        densify_grad_threshold=0.0, opacity_reset_interval=10_000,
        position_lr_max_steps=iterations)
    _, _, hist = train_stage1(state, cams, opt, raster_cfg=CFG,
                              iterations=iterations, log_every=1,
                              device="cpu")
    assert [h["n_alive"] for h in hist][1] == 20
    assert (hist[-1]["n_alive"] != 20) == (iterations == 4)


@pytest.mark.parametrize("white", [False, True])
def test_white_background_resets_opacity_at_densify_from_iter(white):
    """train.py:209-210: on white-background scenes the opacity is also
    reset once at densify_from_iter; on black ones only on its interval."""
    init, cams = _ring_scene(20, 32, 2)
    state = TG.init_from_points(init, torch.full((20, 3), 0.5), capacity=64,
                                device="cpu")
    opt = OptimizationConfig(
        iterations=2, densify_from_iter=2, densification_interval=1000,
        opacity_reset_interval=10_000, position_lr_max_steps=2)
    state, ost, _ = train_stage1(state, cams, opt, raster_cfg=CFG,
                                 iterations=2, log_every=100, device="cpu",
                                 white_background=white)
    top = float(TG.get_opacity(state["params"])[state["alive"]].max())
    assert (top <= 0.01 * (1 + 1e-6)) == white, top
    assert bool(ost["m"]["opacity"].any()) != white


def test_checkpoint_resume_reproduces_uninterrupted_run(tmp_path):
    """A run checkpointed at iteration 8 and resumed to 16 matches the
    uninterrupted 16-iteration run (camera schedule, split draws and Adam
    moments survive the restart); it densifies at 4, 8 and 12.  The
    uninterrupted run also logs the periodic test PSNR."""
    init, cams = _ring_scene(40, 32, 3)

    def fresh_state():
        return TG.init_from_points(init, torch.full((40, 3), 0.5),
                                   capacity=256, device="cpu")

    opt = OptimizationConfig(
        iterations=16, densify_from_iter=3, densify_until_iter=14,
        densification_interval=4, densify_grad_threshold=2e-4,
        opacity_reset_interval=10_000, position_lr_max_steps=16)
    kw = dict(raster_cfg=CFG, log_every=16, seed=3, device="cpu")
    state_a, opt_a, hist_a = train_stage1(fresh_state(), cams, opt,
                                          iterations=16, test_cameras=cams,
                                          test_interval=8, **kw)
    # the periodic test PSNR over the (here: training) views
    assert [h["iter"] for h in hist_a] == [8, 16]
    assert all(np.isfinite(h["test_psnr"]) and h["test_psnr"] > 5
               for h in hist_a)
    out = str(tmp_path)
    train_stage1(fresh_state(), cams, opt, iterations=8, out_dir=out,
                 checkpoint_interval=8, **kw)
    it0, tree = CK.load_checkpoint(os.path.join(out, "chkpnt8.npz"),
                                   device="cpu")
    assert it0 == 8
    state_b, opt_b, hist_b = train_stage1(
        tree["state"], cams, opt, first_iter=8, iterations=16,
        opt_state=tree["opt"], **kw)
    assert hist_a[-1]["n_alive"] == hist_b[-1]["n_alive"] != 40
    np.testing.assert_array_equal(state_a["alive"].numpy(),
                                  state_b["alive"].numpy())
    for k in state_a["params"]:
        np.testing.assert_allclose(state_a["params"][k].numpy(),
                                   state_b["params"][k].numpy(), atol=1e-6,
                                   err_msg=f"param {k} diverged across resume")
    assert opt_a["step"] == opt_b["step"] == 16
