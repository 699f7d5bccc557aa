"""The port's training CLI (``python -m svgir_tpu_torch.cli.train``) and
its instance-cap probe, on the CPU.

``main(..., "--device", "cpu")`` trains a 3-frame 32 x 32 Blender scene
(tests/test_data.py's writer, with a 300-point cloud as tests/test_cli.py
gives it): stage 1, a resume of stage 1 from its mid-run checkpoint that
must end where the uninterrupted run ended (1e-6, alive masks equal), and
stage 2 from the stage-1 checkpoint; ``--save_training_vis``, ``--eval``
and ``--finetune_visibility`` with their outputs, and the relighting CLI
on a stage-2 checkpoint.  The parser must offer every flag of the
repository's ``train.py`` with the same default.  The probe is held to
svgir_tpu's ``snug_instance_cap``: both count the same instances.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.train.cap_probe import snug_instance_cap as j_snug

from svgir_tpu_torch.cli import train as cli
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.data.ply import store_pointcloud
from svgir_tpu_torch.data.readers import load_scene
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.train import cap_probe as t_cap_probe
from svgir_tpu_torch.train import checkpoint as CK
from svgir_tpu_torch.train import trainer
from svgir_tpu_torch.train.cap_probe import snug_instance_cap as t_snug

from tests.test_data import _write_blender_scene


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


def test_parser_has_every_flag_of_train_py():
    import train as jax_cli
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_cli.build_parser()._actions}
    assert set(ours) - set(theirs) == {"device", "profile_steps",
                                       "profile_dir"}
    assert ours["device"].default == "cuda"
    assert ours["profile_steps"].default is None
    assert ours["profile_dir"].default is None
    for dest, a in theirs.items():
        b = ours[dest]
        assert (b.option_strings, b.default, b.type, b.choices) == \
            (a.option_strings, a.default, a.type, a.choices), dest


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli") / "scene")
    _write_blender_scene(root, n_frames=3, res=32)
    rng = np.random.default_rng(1)
    xyz = rng.random((300, 3)) * 2.0 - 1.0
    nrm = rng.standard_normal((300, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    store_pointcloud(os.path.join(root, "points3d.ply"), xyz,
                     rng.random((300, 3)) * 255, nrm)
    return root


STAGE1 = ["--iterations", "8", "--position_lr_max_steps", "8",
          "--densify_from_iter", "2", "--densification_interval", "3",
          "--opacity_reset_interval", "7", "--checkpoint_interval", "4",
          "--max_instances", "4096", "--device", "cpu", "--quiet"]


def _log(out):
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_tensorboard_logger_writes_scalars(tmp_path):
    cb = trainer.tensorboard_logger(str(tmp_path / "tb"))
    cb({"iter": 3, "loss": 0.5, "psnr": 20.0, "name": "skipped"})
    cb.writer.close()
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tmp_path / "tb"))


def test_train_cli_stages_and_resume(scene, tmp_path, monkeypatch):
    # the TensorBoard callback is held by its own test above: here it is
    # absent, as where torch.utils.tensorboard does not import, which
    # spares each run the import (TensorFlow's, where it is installed)
    monkeypatch.setattr(trainer, "tensorboard_logger", lambda _: None)
    out = str(tmp_path / "out")
    cli.main(["-s", scene, "-m", out] + STAGE1)
    for name in ("cfg_args.json", "cameras.json", "chkpnt4.npz",
                 "chkpnt8.npz", "point_cloud.ply"):
        assert os.path.exists(os.path.join(out, name)), name
    log = _log(out)
    assert [e["iter"] for e in log] == [4, 8]
    assert all(np.isfinite(e["loss"]) for e in log)
    assert log[-1]["n_alive"] != 300         # densified and pruned

    # stage 1 resumed from its checkpoint at 4 ends where the run ended
    out_r = str(tmp_path / "resumed")
    cli.main(["-s", scene, "-m", out_r, "-c",
              os.path.join(out, "chkpnt4.npz")] + STAGE1)
    _, a = CK.load_checkpoint(os.path.join(out, "chkpnt8.npz"), "cpu")
    _, b = CK.load_checkpoint(os.path.join(out_r, "chkpnt8.npz"), "cpu")
    assert torch.equal(a["state"]["alive"], b["state"]["alive"])
    for k in a["state"]["params"]:
        np.testing.assert_allclose(b["state"]["params"][k].numpy(),
                                   a["state"]["params"][k].numpy(),
                                   atol=1e-6, err_msg=k)
    assert a["opt"]["step"] == b["opt"]["step"] == 8

    # stage 2 from the stage-1 checkpoint (upgrade_to_pbr), a checkpoint
    # with the env map and the bake in the middle
    out2 = str(tmp_path / "out2")
    cli.main(["-s", scene, "-m", out2, "-t", "render_relight",
              "-c", os.path.join(out, "chkpnt8.npz"), "--iterations", "12",
              "--sample_num", "4", "--env_resolution", "16",
              "--position_lr_max_steps", "12", "--checkpoint_interval", "10",
              "--max_instances", "4096", "--device", "cpu", "--quiet"])
    for name in ("chkpnt10.npz", "chkpnt12.npz", "point_cloud.ply"):
        assert os.path.exists(os.path.join(out2, name)), name
    log2 = _log(out2)
    assert [e["iter"] for e in log2] == [10, 12]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["psnr_pbr"])
               for e in log2)
    it, tree = CK.load_checkpoint(os.path.join(out2, "chkpnt12.npz"), "cpu")
    assert it == 12 and tree["env"]["params"]["env"].shape == (16, 32, 3)
    assert tree["extra"]["radiance"].shape[1:] == (4, 3)
    assert "base_color" in tree["state"]["params"]


@pytest.mark.parametrize("flags", [
    ["--save_training_vis"],
    ["-t", "render_relight", "--finetune_visibility"],
    ["--eval"]])
def test_train_cli_refuses_what_is_not_ported(scene, tmp_path, flags,
                                              monkeypatch):
    """The three flags the CLI once refused (the name is kept from then)
    now run and write their outputs: the training visualisation PNGs; the
    visibility fine-tuning before stage 2 (called with its default 1,000
    iterations and a generator seeded with --seed + 7; run here for 20),
    whose stage-2 checkpoint the relighting CLI then evaluates under an
    HDR light; the end-of-run test render with its metrics."""
    import cv2
    from svgir_tpu_torch.cli import eval_relighting as cli_relight
    monkeypatch.setattr(trainer, "tensorboard_logger", lambda _: None)
    out = str(tmp_path / "out")
    if flags == ["--save_training_vis"]:
        cli.main(["-s", scene, "-m", out] + STAGE1 + flags
                 + ["--save_training_vis_iteration", "4"])
        for it in (4, 8):
            img = cv2.imread(os.path.join(out, "visualize",
                                          f"iter_{it:06d}.png"))
            # ground truth, render, normal, pseudo-normal, depth, opacity
            assert img.shape == (32, 6 * 32, 3), img.shape
        return
    if flags == ["--eval"]:    # a test split for --eval to render
        with open(os.path.join(scene, "transforms_train.json")) as f:
            frames = json.load(f)
        with open(os.path.join(scene, "transforms_test.json"), "w") as f:
            json.dump(frames, f)
        try:
            cli.main(["-s", scene, "-m", out] + STAGE1 + flags)
        finally:
            os.remove(os.path.join(scene, "transforms_test.json"))
        with open(os.path.join(out, "eval", "metrics.json")) as f:
            m = json.load(f)
        assert m["n_views"] == 3 and np.isfinite(m["psnr"])
        assert m["ssim"] > 0 and "unavailable" in m["lpips"]
        assert os.path.exists(os.path.join(out, "metric_eval.txt"))
        for name in ("00002.png", "00002_depth.png", "00002_normal.png"):
            assert os.path.exists(os.path.join(out, "eval", "renders", name))
        return

    # stage 1, then stage 2 with --finetune_visibility
    cli.main(["-s", scene, "-m", out] + STAGE1)
    calls, finetune = [], TG.finetune_visibility

    def recording(state, **kw):
        new = finetune(state, **{**kw, "iterations": 20})
        calls.append((kw, state["params"], new["params"]))
        return new
    monkeypatch.setattr(TG, "finetune_visibility", recording)
    out2 = str(tmp_path / "out2")
    cli.main(["-s", scene, "-m", out2, "-c", os.path.join(out, "chkpnt8.npz"),
              "--iterations", "10", "--sample_num", "4", "--env_resolution",
              "16", "--position_lr_max_steps", "10", "--max_instances",
              "4096", "--device", "cpu", "--quiet"] + flags)
    (kw, before, after), = calls
    assert "iterations" not in kw and kw["generator"].initial_seed() == 7
    assert not torch.equal(after["visibility_rest"], before["visibility_rest"])

    # the relighting CLI on that stage-2 checkpoint, under a written HDR
    hdr = str(tmp_path / "sky.hdr")
    sky = np.ones((16, 32, 3), np.float32)
    sky[:8] *= np.array([2.0, 1.5, 1.0], np.float32)
    assert cv2.imwrite(hdr, sky[..., ::-1].copy())
    res = cli_relight.main(["-s", scene, "-m", out2, "-c",
                            os.path.join(out2, "chkpnt10.npz"), "--hdr", hdr,
                            "--sample_num", "4", "--max_instances", "4096",
                            "--device", "cpu"])
    with open(os.path.join(out2, "eval_relight", "sky", "metrics.json")) as f:
        m = json.load(f)
    assert m == res["sky"] and m["n_views"] == 3
    assert np.isfinite(m["pbr_psnr"]) and "unavailable" in m["pbr_lpips"]
    assert os.path.exists(os.path.join(out2, "eval_relight", "sky",
                                       "00002_pbr.png"))


def test_snug_instance_cap_matches_jax(scene, monkeypatch):
    sc = load_scene(scene, white_background=False, eval_split=False)
    ts = TG.init_from_points(sc.points, sc.colors, normals=sc.normals,
                             capacity=512, morton_order=True, device="cpu")
    ts["alive"][250:300] = False             # dead rows bin nothing
    js = {"params": {k: jnp.asarray(v.numpy())
                     for k, v in ts["params"].items()},
          "alive": jnp.asarray(ts["alive"].numpy())}
    from svgir_tpu.data.readers import load_scene as j_load
    jcams = j_load(scene, white_background=False, eval_split=False) \
        .train_cameras
    monkeypatch.setattr(t_cap_probe, "PROBE_CAP", 1 << 14)
    monkeypatch.setattr(t_cap_probe, "QUANTUM", 256)
    for tile in (16, 32):
        t = t_snug(ts["params"], sc.train_cameras, TCfg(tile=tile),
                   alive=ts["alive"])
        j = j_snug(js["params"], jcams, JCfg(tile=tile), alive=js["alive"],
                   probe_cap=1 << 14, quantum=256)
        assert t == j > 256, (tile, t, j)
