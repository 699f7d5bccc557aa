"""The port's evaluation and viewing commands on the CPU, against
svgir_tpu's library calls on the same checkpoints.

The scene is tests/test_data.py's 3-frame 32 x 32 Blender layout; the
model (made with the port and saved with its ``save_checkpoint`` and
``save_model_ply``, no training) is a visible shell of 48 surfels of
radius 0.5 facing out and a shell of 40 of radius 0.1 facing in (their
hemisphere rays meet within the march's first 0.2 window), in a capacity
of 128 with dead rows, upgraded to PBR with random materials.

* ``cli.eval_nvs`` at ``--eval_scale 1``: ``-t render`` on a stage-1
  checkpoint and ``-t render_relight`` on a stage-2 one with its bake,
  each view's PNG within one 8-bit level of JAX's ``render_stage1`` /
  ``render_svgss`` on the same checkpoint and cameras, ``metrics.json``
  PSNRs within 1e-3 dB of JAX's images scored by svgir_tpu's metrics.
  Without a bake in the checkpoint the CLI bakes once at k 16: its bake
  on the alive rows equals JAX's ``bake_radiance(valid=alive)`` (hit
  indices equal; radiance, visibility, uv and directions within 2e-5 of
  the largest value: the march's SH sums differ by XLA's fused
  multiply-adds, 1.1e-5 of the largest radiance at one sample here),
  and its PNGs JAX's render on JAX's bake.  The default scale 4 runs too.
* ``cli.relighting`` in its three config forms: a config directory
  composing the PLY twice (identity, and a rotation, a translation of
  2.5 and a scale of 0.8) with a 2-frame trajectory and per-frame light
  rotations, whose ``pbr_env`` frames are within one level of JAX's
  composition, bake and render (the same float HDR given to both,
  ROADMAP hazard 10); a JSON list; a ``.ply`` with ``--rotate_light``.
* ``cli.normal_eval``: ``get_mae`` equals the reference's on random
  PNG-decoded normals; on its own frames the CLI's MAE is that of
  arccos at a float32 dot product of 1 (below 0.05 degrees).
* ``cli.gui --headless``: the orbit frames are written.
"""

import json
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.data.readers import load_scene as j_load_scene
from svgir_tpu.eval import metrics as JM
from svgir_tpu.eval.relighting import rebake_radiance_for_light as j_rebake
from svgir_tpu.models import gaussians as JG
from svgir_tpu.models import lights as JLT
from svgir_tpu.models import radiance as JRAD
from svgir_tpu.render.stage1 import render_stage1 as j_render_stage1
from svgir_tpu.render.svgss import render_svgss as j_render_svgss
from svgir_tpu.train import checkpoint as JCK
from svgir_tpu.train.trainer import strip_meta as j_strip_meta

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.cli import eval_nvs, gui, normal_eval, relighting
from svgir_tpu_torch.eval.relighting import bake_hemisphere
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.models import lights as TLT
from svgir_tpu_torch.train import checkpoint as CK
from svgir_tpu_torch.train import optim

from tests.test_data import _write_blender_scene

CAP, S, RES = 128, 4, 32
CPU = ["--max_instances", "4096", "--device", "cpu"]
LEVEL = 1.0 / 255 + 1e-6           # one 8-bit level


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shell(rng, n, radius, inward):
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d * radius, (-d if inward else d)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The scene, the stage-1 checkpoint, the stage-2 checkpoints with and
    without a bake, the stage-2 PLY and a float HDR."""
    root = tmp_path_factory.mktemp("evalcli")
    scene = str(root / "scene")
    _write_blender_scene(scene, n_frames=3, res=RES)
    rng = np.random.default_rng(11)
    (pa, na), (pb, nb) = _shell(rng, 48, 0.5, False), _shell(rng, 40, 0.1,
                                                              True)
    pts = np.concatenate([pa, pb, np.zeros((CAP - 88, 3), np.float32)])
    nrm = np.concatenate([na, nb, np.tile([[0, 0, 1.0]], (CAP - 88, 1))])
    st = TG.init_from_points(pts, rng.random((CAP, 3)).astype(np.float32),
                             normals=nrm.astype(np.float32), capacity=CAP,
                             rotation_init="normal", device="cpu")
    p = st["params"]
    p["scaling"] = torch.tensor(np.log(np.where(
        np.arange(CAP)[:, None] < 48, 0.14, 0.03)).repeat(3, 1)
        .astype(np.float32))
    p["opacity"] = torch.tensor(rng.normal(1.5, 1.0, (CAP, 1))
                                .astype(np.float32))
    p["shs_rest"] = torch.tensor(0.2 * rng.standard_normal((CAP, 15, 3))
                                 .astype(np.float32))
    alive = torch.tensor(np.arange(CAP) < 88)
    alive[[5, 60]] = False
    st["alive"] = alive
    s1 = str(root / "s1.npz")
    CK.save_checkpoint(s1, 10, st, optim.adam_init(p))

    st2 = TG.upgrade_to_pbr(st)
    p2 = st2["params"]
    for k, sd in (("base_color", 0.5), ("roughness", 0.5), ("normal", 0.1)):
        p2[k] = torch.tensor(sd * rng.standard_normal(tuple(p2[k].shape))
                             .astype(np.float32))
    with torch.no_grad():
        bake = bake_hemisphere(p2, alive, sample_num=S)
    assert 0.05 < float((bake["hit_idx"][alive] >= 0).float().mean()) < 0.95
    p2["radiances"] = bake["radiance"].clone()
    p2["radiance_ratio"] = torch.tensor(1.2)
    env = TLT.direct_light_map_init(16, 0.5, generator=torch.Generator()
                                    .manual_seed(2), device="cpu")
    s2, s2_nobake = str(root / "s2.npz"), str(root / "s2_nobake.npz")
    CK.save_checkpoint(s2, 12, st2, optim.adam_init(p2), env=env, extra=bake)
    CK.save_checkpoint(s2_nobake, 12, st2, optim.adam_init(p2), env=env)
    ply = str(root / "pc.ply")
    CK.save_model_ply(ply, p2, alive, use_pbr=True)
    hdr = str(root / "sky.hdr")
    img = (0.2 + rng.random((16, 32, 3))).astype(np.float32)
    img[3:6, 10:14] = 6.0
    assert cv2.imwrite(hdr, np.ascontiguousarray(img[..., ::-1]))
    return dict(root=root, scene=scene, s1=s1, s2=s2, s2_nobake=s2_nobake,
                ply=ply, hdr=hdr)


def _png(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img[..., ::-1].astype(np.float32) / 255


def _quantised(img):
    """JAX's image written as the CLIs write it (clip, x255, truncate)."""
    arr = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
    return (arr * 255).astype(np.uint8).astype(np.float32) / 255


def _jax_tree(path):
    _, tree = JCK.load_checkpoint(path)
    return tree


def _jax_renders(files, tree, render):
    cams = j_load_scene(files["scene"], eval_split=True).train_cameras
    fn = jax.jit(render)
    p, alive = tree["state"]["params"], tree["state"]["alive"]
    return cams, [fn(p, alive, j_strip_meta(c)) for c in cams]


def _check_nvs(out, cams, renders):
    with open(os.path.join(out, "eval", "train", "metrics.json")) as f:
        m = json.load(f)
    psnr = np.mean([JM.psnr(jnp.clip(r["render"], 0, 1), c.image)
                    for r, c in zip(renders, cams)])
    assert m["n_views"] == 3 and abs(m["psnr"] - psnr) < 1e-3, (m, psnr)
    for i, r in enumerate(renders):
        got = _png(os.path.join(out, "eval", "train", "renders",
                                f"{i:05d}.png"))
        np.testing.assert_allclose(got, _quantised(r["render"]),
                                   atol=LEVEL, rtol=0)
    return m


def test_eval_nvs_stage1_matches_jax(files, tmp_path):
    out = str(tmp_path / "s1")
    res = eval_nvs.main(["-s", files["scene"], "-m", out, "-c", files["s1"],
                         "--eval_scale", "1"] + CPU)
    cfg = JCfg(max_instances=4096)
    cams, renders = _jax_renders(files, _jax_tree(files["s1"]), lambda p, a, c:
                                 j_render_stage1(c, p, jnp.zeros(3),
                                                 opt=JOpt(),
                                                 is_training=False, alive=a,
                                                 cfg=cfg))
    assert float(np.mean([(np.asarray(r["opacity"]) > 0.5).mean()
                          for r in renders])) > 0.02
    assert _check_nvs(out, cams, renders) == res["train"]
    # the recipe's default scale 4: 8 x 8 views
    out4 = str(tmp_path / "s1_4")
    eval_nvs.main(["-s", files["scene"], "-m", out4, "-c", files["s1"]]
                  + CPU)
    assert _png(os.path.join(out4, "eval", "train", "renders",
                             "00002.png")).shape == (8, 8, 3)


def _svgss(cfg, bake, env):
    def render(p, a, c):
        return j_render_svgss(c, p, jnp.zeros(3), bake=bake,
                              env_params=env, opt=JOpt(), is_training=False,
                              alive=a, cfg=cfg)
    return render


@pytest.mark.parametrize("with_bake", [True, False],
                         ids=["checkpoint_bake", "bakes_once"])
def test_eval_nvs_stage2_matches_jax(files, tmp_path, monkeypatch,
                                     with_bake):
    baked = []
    real = eval_nvs.bake_once

    def rec(*a, **kw):
        baked.append(real(*a, **kw))
        return baked[-1]
    monkeypatch.setattr(eval_nvs, "bake_once", rec)
    out = str(tmp_path / "s2")
    ck = files["s2"] if with_bake else files["s2_nobake"]
    res = eval_nvs.main(["-s", files["scene"], "-m", out, "-c", ck, "-t",
                         "render_relight", "--sample_num", str(S),
                         "--eval_scale", "1"] + CPU)
    tree = _jax_tree(ck)
    if with_bake:
        assert not baked
        bake = tree["extra"]
    else:
        (t_bake,) = baked
        p, alive = tree["state"]["params"], tree["state"]["alive"]
        bake = JRAD.bake_radiance(
            p["xyz"], JG.get_scaling(p), JG.get_rotation(p),
            JG.get_opacity(p)[:, 0], JG.get_shs(p), sample_num=S,
            valid=alive)
        a = np.asarray(alive)
        hits = np.asarray(bake["hit_idx"])[a]
        assert (hits >= 0).any()
        np.testing.assert_array_equal(t_bake["hit_idx"].numpy()[a], hits)
        for k in ("radiance", "visibility", "uv", "incident_dirs",
                  "incident_areas"):
            want = np.asarray(bake[k])[a]
            np.testing.assert_allclose(
                t_bake[k].numpy()[a], want, rtol=0, err_msg=k,
                atol=2e-5 * max(1.0, float(np.abs(want).max())))
        bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    cams, renders = _jax_renders(files, tree, _svgss(
        JCfg(max_instances=4096), bake, tree["env"]["params"]))
    assert _check_nvs(out, cams, renders) == res["train"]


def _write_config(root, ply, res=RES):
    """A config directory composing ``ply`` twice, with a 2-frame
    trajectory and a light rotation per frame."""
    os.makedirs(root, exist_ok=True)
    a = 0.6
    tf = np.eye(4)
    tf[:3, :3] = 0.8 * np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                                 [-math.sin(a), 0, math.cos(a)]])
    tf[:3, 3] = [2.5, 0.0, 0.0]
    with open(os.path.join(root, "transform.json"), "w") as f:
        json.dump({"a": {"path": ply, "transform": np.eye(4).ravel()
                         .tolist()},
                   "b": {"path": ply, "transform": tf.ravel().tolist()}}, f)
    traj, lights = {}, {}
    for i, eye in enumerate(([1.25, 0.3, -4.0], [1.25, -0.5, 4.2])):
        cam = t_look_at(eye=eye, target=[1.25, 0, 0], up=[0, -1, 0],
                        fovx=0.69, fovy=0.69, width=res, height=res,
                        device="cpu")
        traj[str(i)] = cam.world_view.numpy().ravel().tolist()
        lights[str(i)] = relighting.rotation_z(0.9 * i).ravel().tolist()
    with open(os.path.join(root, "trajectory.json"), "w") as f:
        json.dump({"camera": {"width": res, "height": res, "fov": 40},
                   "trajectory": traj}, f)
    with open(os.path.join(root, "light_transform.json"), "w") as f:
        json.dump({"transform": lights}, f)
    return tf


def _jax_relit(files, cfg_dir, tf):
    """JAX's composition, bake and relit renders of the config directory's
    two frames (its bake through the brute tracer, which gives the grid's
    hits, on the same float HDR)."""
    from svgir_tpu.cameras import make_camera
    st_a = JCK.load_model_ply(files["ply"])
    st_b = {**st_a, "params": JG.apply_transform(st_a["params"],
                                                 jnp.asarray(tf, jnp.float32))}
    state = JG.concatenate_models([st_a, st_b])
    p, alive = state["params"], state["alive"]
    hdr = TLT.load_hdr(files["hdr"])
    env0 = JLT.env_light_init(hdr, transform=np.eye(3, dtype=np.float32))
    bake = JRAD.bake_radiance(p["xyz"], JG.get_scaling(p), JG.get_rotation(p),
                              JG.get_opacity(p)[:, 0], JG.get_shs(p),
                              sample_num=S, valid=alive, use_grid=False)
    bake, rad = j_rebake(p, alive, env0, sample_num=S, bake=bake)
    p = {**p, "radiances": rad, "radiance_ratio": jnp.ones(())}
    bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    traj = json.load(open(os.path.join(cfg_dir, "trajectory.json")))
    lights = json.load(open(os.path.join(cfg_dir, "light_transform.json")))
    cfg = JCfg(max_instances=4096)

    @jax.jit
    def render(p, alive, bake, env, cam):
        return j_render_svgss(
            cam, p, jnp.zeros(3), bake=bake, env_params=None,
            env_fn=lambda d: JLT.env_light_direct(env, d), opt=JOpt(),
            is_training=False, alive=alive, cfg=cfg)

    out = {}
    for fid, vals in traj["trajectory"].items():
        w2c = np.array(vals, np.float32).reshape(4, 4)
        cam = make_camera(w2c[:3, :3].T, w2c[:3, 3], 0.6911112070083618,
                          0.6911112070083618, RES, RES)
        env = JLT.env_light_init(hdr, transform=np.array(
            lights["transform"][fid], np.float32).reshape(3, 3))
        out[fid] = render(p, alive, bake, env, j_strip_meta(cam))
    return out, state


def test_relighting_config_dir_matches_jax(files, tmp_path, monkeypatch):
    cfg_dir = str(tmp_path / "cfg")
    tf = _write_config(cfg_dir, files["ply"])
    composed = []
    real = relighting.compose
    monkeypatch.setattr(relighting, "compose", lambda *a, **kw: (
        composed.append(real(*a, **kw)) or composed[-1]))
    out = str(tmp_path / "rl")
    relighting.main(["--config", cfg_dir, "--hdr", files["hdr"], "--output",
                     out, "--sample_num", str(S), "--capture_list",
                     "pbr_env,normal,roughness"] + CPU)
    want, j_state = _jax_relit(files, cfg_dir, tf)
    (st,) = composed
    n = int(st["alive"].sum())
    np.testing.assert_array_equal(st["alive"].numpy(),
                                  np.asarray(j_state["alive"]))
    for k in ("xyz", "rotation", "scaling"):
        np.testing.assert_allclose(st["params"][k].numpy()[:n],
                                   np.asarray(j_state["params"][k])[:n],
                                   atol=1e-5, rtol=0, err_msg=k)
    covered = 0.0
    for fid, r in want.items():
        covered += float((np.asarray(r["opacity"]) > 0.5).mean())
        got = _png(os.path.join(out, "pbr_env", f"frame_{fid}.png"))
        np.testing.assert_allclose(got, _quantised(r["pbr_env"]),
                                   atol=LEVEL, rtol=0)
        for ct in ("normal", "roughness"):
            assert os.path.exists(os.path.join(out, ct, f"frame_{fid}.png"))
    assert covered > 0.02
    for ct in ("pbr_env", "normal", "roughness"):
        assert os.path.exists(os.path.join(out, f"{ct}.mp4"))


def test_relighting_json_list_and_ply_forms(files, tmp_path, capsys):
    lst = str(tmp_path / "scenes.json")
    tf = np.eye(4)
    tf[:3, 3] = [0.3, 0, 0]
    with open(lst, "w") as f:
        json.dump([{"path": files["ply"]},
                   {"path": files["ply"], "transform": tf.ravel().tolist()}],
                  f)
    orbit = ["--sample_num", str(S), "--frames", "2", "--resolution", "16"]
    relighting.main(["--config", lst, "--hdr", files["hdr"], "--output",
                     str(tmp_path / "a")] + orbit + CPU)
    relighting.main(["--config", files["ply"], "--hdr", files["hdr"],
                     "--output", str(tmp_path / "b"), "--rotate_light",
                     "--capture_list", "pbr_env,visibility"] + orbit + CPU)
    for d, cts in (("a", ("pbr_env",)), ("b", ("pbr_env", "visibility"))):
        for ct in cts:
            for i in range(2):
                assert _png(tmp_path / d / ct / f"frame_{i}.png").shape == \
                    (16, 16, 3)
    # --rotate_light turns the light by half a turn at the second of two
    # frames and not at the first
    relighting.main(["--config", files["ply"], "--hdr", files["hdr"],
                     "--output", str(tmp_path / "c"), "--capture_list",
                     "pbr_env"] + orbit + CPU)
    turned, fixed = ([_png(tmp_path / d / "pbr_env" / f"frame_{i}.png")
                      for i in range(2)] for d in ("b", "c"))
    np.testing.assert_array_equal(turned[0], fixed[0])
    assert not np.array_equal(turned[1], fixed[1])
    with pytest.raises(SystemExit, match="unknown capture type"):
        relighting.main(["--config", files["ply"], "--hdr", files["hdr"],
                         "--output", str(tmp_path / "c"), "--capture_list",
                         "nothing"] + orbit + CPU)


def test_normal_eval_matches_the_reference(tmp_path):
    import normal_eval as j_normal_eval

    rng = np.random.default_rng(5)
    for d in ("pred", "gt"):
        os.makedirs(tmp_path / d)
        for i in range(2):
            img = rng.integers(0, 256, (12, 10, 3), dtype=np.uint8)
            cv2.imwrite(str(tmp_path / d / f"{i}.png"), img)
    for i in range(2):
        pred = normal_eval.read_rgb(str(tmp_path / "pred" / f"{i}.png"))
        gt = normal_eval.read_rgb(str(tmp_path / "gt" / f"{i}.png"))
        assert normal_eval.get_mae(pred, gt) == j_normal_eval.get_mae(pred,
                                                                      gt)
    mae = normal_eval.main(["--pred_dir", str(tmp_path / "pred"),
                            "--gt_dir", str(tmp_path / "gt")])
    assert 10 < mae < 120
    assert normal_eval.main(["--pred_dir", str(tmp_path / "gt"), "--gt_dir",
                             str(tmp_path / "gt")]) < 0.05


def test_gui_headless_writes_frames(files, tmp_path):
    out = str(tmp_path / "gui")
    gui.main(["-c", files["s2"], "--headless", "--frames", "2",
              "--resolution", "16", "--sample_num", str(S), "--buffer",
              "normal", "--output", out] + CPU)
    gui.main(["-c", files["s1"], "-t", "render", "--headless", "--frames",
              "1", "--resolution", "16", "--buffer", "depth", "--output",
              str(tmp_path / "gui1")] + CPU)
    assert sorted(os.listdir(out)) == ["0000.png", "0001.png"]
    assert _png(os.path.join(out, "0001.png")).shape == (16, 16, 3)
    assert os.path.exists(tmp_path / "gui1" / "0000.png")
