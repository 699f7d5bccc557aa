"""The port's recipe layer on the CPU: the scene generator
(``cli/make_synth_dataset.py``), the two-stage schedule
(``cli/full_schedule.py``) and the recipe scripts
(``svgir_tpu_torch/script/*.sh``).

* The generator against ``tools/make_synth_dataset.py`` itself (run in a
  subprocess on the CPU at 32 x 32, 3 + 1 views, 200 GT surfels, S = 4),
  the port given the tool's draws from ``jax.random.PRNGKey(0)`` split as
  the tool splits it: the JSON cameras within 1e-6, every PNG channel
  within 2/255 (the pbr images agree to 2e-4 before rounding to 8 bits, so
  a value near a rounding edge may land one step apart: the test states
  the share of such pixels).
* The round trip: the port's reader gives back ``ring_cameras`` and the
  rendered images (masked over black, to 8 bits), and it reads the
  JAX-written scene as ``svgir_tpu.data.readers.load_scene`` does.
* The scripts: each command of ``svgir_tpu_torch/script/<name>.sh``
  carries the flags of ``script/<name>.sh``, and the port's parsers take
  them (parse only).
* The schedule on the 3-frame 32 x 32 scene, a few iterations: the newest
  checkpoint by iteration, the refusal to start stage 2 from an incomplete
  stage 1, the clean start without ``--resume``, stage 2 resumed from its
  own newest checkpoint, and both evaluations written.  Stage-1 resume
  equivalence is held by tests/test_torch_cli.py.
"""

import importlib.util
import json
import os
import shlex
import shutil
import subprocess
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from svgir_tpu.data import readers as JR

from svgir_tpu_torch.cli import eval_nvs, eval_relighting, full_schedule
from svgir_tpu_torch.cli import make_synth_dataset as MS
from svgir_tpu_torch.cli import relighting, train
from svgir_tpu_torch.data import readers as TR
from svgir_tpu_torch.data.ply import store_pointcloud
from svgir_tpu_torch.eval.standin import ring_cameras

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, VIEWS, TEST_VIEWS, N_GT, S = 32, 3, 1, 200, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The JAX tool's scene (a subprocess on the CPU) and the port's, made
    from the same draws; the port's rendered cameras."""
    root = tmp_path_factory.mktemp("recipe")
    jax_dir, port_dir = str(root / "jax"), str(root / "port")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "make_synth_dataset.py"),
         "--out", jax_dir, "--res", str(RES), "--views", str(VIEWS),
         "--test-views", str(TEST_VIEWS), "--n-gt", str(N_GT),
         "--sample-num", str(S)], check=True, env=env, cwd=ROOT,
        capture_output=True, timeout=300)
    # the tool's draws: PRNGKey(seed) split into the model's, the env's and
    # the bake's keys (ROADMAP hazard 4: the port takes draws, not keys)
    k_model, k_env, k_bake = jax.random.split(jax.random.PRNGKey(0), 3)
    k1, k2 = jax.random.split(k_env)
    # the tool's 2^20 instance slots hold the scene as 4,096 do: the images
    # are the same, and the plain binner on the CPU takes seconds a view
    # at 2^20
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MS, "MAX_INSTANCES", 4096)
        rendered = MS.make_dataset(
            port_dir, res=RES, views=VIEWS, test_views=TEST_VIEWS,
            n_gt=N_GT, sample_num=S, device="cpu", verbose=False,
            dirs_draw=_np(jax.random.normal(
                jax.random.split(k_model, 4)[0], (N_GT, 3))),
            env_base_draw=_np(jax.random.uniform(k1, (4, 8, 3))),
            env_az_draw=_np(jax.random.uniform(k2, ())),
            bake_az_draw=_np(jax.random.uniform(k_bake, (N_GT, 1))))
    return jax_dir, port_dir, rendered


def _png(path):
    return cv2.imread(path, cv2.IMREAD_UNCHANGED)


def test_generator_matches_jax_tool(scenes):
    jax_dir, port_dir, _ = scenes
    n_px, n_one = 0, 0
    for split, n in (("train", VIEWS), ("test", TEST_VIEWS)):
        with open(os.path.join(jax_dir, f"transforms_{split}.json")) as f:
            want = json.load(f)
        with open(os.path.join(port_dir, f"transforms_{split}.json")) as f:
            got = json.load(f)
        assert abs(got["camera_angle_x"] - want["camera_angle_x"]) < 1e-6
        assert [fr["file_path"] for fr in got["frames"]] == \
            [fr["file_path"] for fr in want["frames"]] == \
            [f"./{split}/r_{i}" for i in range(n)]
        for fg, fw in zip(got["frames"], want["frames"]):
            np.testing.assert_allclose(fg["transform_matrix"],
                                       fw["transform_matrix"], atol=1e-6)
        for i in range(n):
            a = _png(os.path.join(jax_dir, split, f"r_{i}.png"))
            b = _png(os.path.join(port_dir, split, f"r_{i}.png"))
            assert a.shape == b.shape == (RES, RES, 4)
            diff = np.abs(a.astype(int) - b.astype(int))
            assert diff.max() <= 2, (split, i, diff.max())
            # the alpha channel (opacity > 0.3) is a decision, not a value
            np.testing.assert_array_equal(a[..., 3], b[..., 3])
            n_px += diff[..., :3].size
            n_one += int((diff[..., :3] == 1).sum())
            assert (a[..., 3] == 255).mean() > 0.03      # the sphere shows
    # stated: the share of channel values one 8-bit step apart
    print(f"generator vs tool: {n_one} of {n_px} channel values "
          f"({n_one / n_px:.4%}) differ by 1/255, none by more than 2/255")
    assert n_one <= 0.01 * n_px


def test_reader_round_trip(scenes):
    _, port_dir, rendered = scenes
    scene = TR.load_scene(port_dir, white_background=False, eval_split=True)
    assert len(scene.train_cameras) == VIEWS
    assert len(scene.test_cameras) == TEST_VIEWS
    want = ring_cameras(VIEWS + TEST_VIEWS, RES, device="cpu")
    for got, ring, ren in zip(scene.train_cameras + scene.test_cameras,
                              want, rendered):
        for k in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       getattr(ring, k).numpy(), atol=1e-6,
                                       err_msg=k)
        assert (got.width, got.height) == (ring.width, ring.height)
        assert abs(got.fovx - ring.fovx) < 1e-6
        assert abs(got.fovy - ring.fovy) < 1e-6
        mask = ren.image_mask.numpy()
        np.testing.assert_array_equal(got.image_mask.numpy(), mask)
        # 8-bit rounding of the colour, then over black through the mask
        np.testing.assert_allclose(got.image.numpy(),
                                   ren.image.numpy() * mask,
                                   atol=0.5 / 255 + 1e-6)


def test_port_reader_reads_the_tool_scene_as_jax(scenes):
    jax_dir = scenes[0]
    got = TR.load_scene(jax_dir, white_background=False, eval_split=True)
    want = JR.load_scene(jax_dir, white_background=False, eval_split=True)
    assert abs(got.cameras_extent - want.cameras_extent) < 1e-5
    np.testing.assert_allclose(got.points, np.asarray(want.points),
                               atol=1e-6)
    for split in ("train_cameras", "test_cameras"):
        gs, ws = getattr(got, split), getattr(want, split)
        assert len(gs) == len(ws) > 0
        for g, w in zip(gs, ws):
            for k in ("world_view", "full_proj", "camera_center", "image",
                      "image_mask"):
                np.testing.assert_allclose(getattr(g, k).numpy(),
                                           _np(getattr(w, k)), atol=1e-6,
                                           err_msg=k)
            assert g.image_name == w.image_name


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

SCRIPTS = ("run_tensoir", "run_syn4", "run_dtc", "relighting")
ROOT_CLIS = {"train.py": "train", "eval_nvs.py": "eval_nvs",
             "eval_relighting.py": "eval_relighting",
             "relighting.py": "relighting"}
PARSERS = {"train": train.build_parser, "eval_nvs": eval_nvs.build_parser,
           "eval_relighting": eval_relighting.build_parser,
           "relighting": relighting.build_parser}


def _root_cli(name):
    """The repository's root script ``name`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_root_{name[:-3]}", os.path.join(ROOT, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _commands(path):
    """(program, arguments) of each ``python`` command of a script, its
    continuation lines joined; ``python -m svgir_tpu_torch.cli.<name>``
    and ``python <name>.py`` both give <name>."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        toks = shlex.split(line.strip(), comments=True)
        if not toks or toks[0] != "python":
            continue
        if toks[1] == "-m":
            assert toks[2].startswith("svgir_tpu_torch.cli."), toks[2]
            out.append((toks[2].rsplit(".", 1)[1], toks[3:]))
        else:
            out.append((ROOT_CLIS[toks[1]], toks[2:]))
    return out


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_match_the_reference_scripts(name):
    want = _commands(os.path.join(ROOT, "script", f"{name}.sh"))
    got = _commands(os.path.join(ROOT, "svgir_tpu_torch", "script",
                                 f"{name}.sh"))
    assert len(want) > 0 and got == want
    with open(os.path.join(ROOT, "svgir_tpu_torch", "script",
                           f"{name}.sh")) as f:
        text = f.read()
    assert "python train.py" not in text and "jax" not in text.lower()
    for prog, args in got:
        try:
            PARSERS[prog]().parse_args(args)
        except SystemExit:
            # refused only where the reference's own parser refuses too
            # (script/run_dtc.sh runs eval_relighting.py without the --hdr
            # both require); its main stops at the parse
            ref = _root_cli(f"{prog}.py")
            with pytest.raises(SystemExit) as e:
                ref.main(args)
            assert e.value.code == 2, (prog, args)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

def _tiny_scene(src, dst):
    """The port's 3 + 1 view scene with a 300-point points3d.ply (without
    one the reader bootstraps 100,000 points)."""
    shutil.copytree(src, dst)
    rng = np.random.default_rng(0)
    d = rng.standard_normal((300, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    store_pointcloud(os.path.join(dst, "points3d.ply"), d.astype(np.float32),
                     np.full((300, 3), 128.0), d)


def _args(scene, run, s1, s2, *extra):
    """The schedule's flags, then trainer flags that size the run down."""
    return ["--scene", scene, "--run", run, "--s1_iters", str(s1),
            "--s2_iters", str(s2), "--device", "cpu", *extra,
            "--checkpoint_interval", "2", "--test_interval", "0",
            "--sample_num", "4", "--env_resolution", "8",
            "--max_instances", "4096"]


def test_latest_checkpoint_by_iteration(tmp_path):
    assert full_schedule.latest_checkpoint(str(tmp_path / "none")) is None
    for name in ("chkpnt2.npz", "chkpnt10.npz", "chkpnt9.npz",
                 "chkpnt11.npz.tmp", "point_cloud.ply"):
        (tmp_path / name).write_bytes(b"")
    assert full_schedule.latest_checkpoint(str(tmp_path)) == (
        10, str(tmp_path / "chkpnt10.npz"))


def test_full_schedule_resumes_and_refuses(scenes, tmp_path, monkeypatch):
    scene, run = str(tmp_path / "scene"), str(tmp_path / "run")
    _tiny_scene(scenes[1], scene)
    out1, out2 = os.path.join(run, "gss"), os.path.join(run, "render_relight")
    calls = []
    real, real_eval = train.main, eval_nvs.main

    def recording(argv):
        calls.append(argv)
        return real(argv)
    monkeypatch.setattr(train, "main", recording)
    # the evaluations at the trainer's cap: eval_nvs's default 2^20 slots
    # make the plain binner take seconds a view on the CPU
    monkeypatch.setattr(eval_nvs, "main", lambda argv: real_eval(
        argv + ["--max_instances", "4096"]))

    def resumed(argv):
        return argv[argv.index("-c") + 1] if "-c" in argv else None

    # the whole schedule: stage 1 to 4, stage 2 from its chkpnt4 to 6
    summary = full_schedule.main(_args(scene, run, 4, 6))
    assert [resumed(a) for a in calls] == [
        None, os.path.join(out1, "chkpnt4.npz")]
    # the recipe's S = 64, overridden by the flag passed through
    assert "64" in calls[1]
    assert train.build_parser().parse_args(calls[1]).sample_num == 4
    for d, ck in ((out1, ("chkpnt2", "chkpnt4")),
                  (out2, ("chkpnt6",))):
        for c in ck:
            assert os.path.exists(os.path.join(d, c + ".npz"))
        assert os.path.exists(os.path.join(d, "eval", "test",
                                           "metrics.json"))
    assert os.path.exists(os.path.join(out1, "eval", "train",
                                       "metrics.json"))
    assert not os.path.exists(os.path.join(out2, "eval", "train"))
    with open(os.path.join(run, "schedule.json")) as f:
        on_disk = json.load(f)
    assert set(on_disk["parts"]) == {"stage1", "stage2", "eval_stage1",
                                     "eval_stage2"}
    for key in ("eval_stage1", "eval_stage2"):
        assert np.isfinite(summary[key]["test"]["psnr"])
        assert on_disk[key]["test"]["psnr"] == summary[key]["test"]["psnr"]

    # --resume: stage 1 is complete; stage 2 goes on from its own newest
    calls.clear()
    full_schedule.main(_args(scene, run, 4, 8, "--resume"))
    assert [resumed(a) for a in calls] == [os.path.join(out2, "chkpnt6.npz")]
    with open(os.path.join(out2, "train_log.jsonl")) as f:
        iters = [json.loads(line)["iter"] for line in f]
    assert iters[-1] == 8 and 6 in iters
    assert os.path.exists(os.path.join(out2, "chkpnt8.npz"))

    # an incomplete stage 1 (its newest checkpoint lost, the attempt cut
    # short): resumed from the newest left, then stage 2 is refused
    os.remove(os.path.join(out1, "chkpnt4.npz"))
    calls.clear()
    monkeypatch.setattr(train, "main", calls.append)
    with pytest.raises(SystemExit, match="refusing to start stage 2"):
        full_schedule.main(_args(scene, run, 4, 10, "--resume"))
    assert [resumed(a) for a in calls] == [os.path.join(out1, "chkpnt2.npz")]
    assert not os.path.exists(os.path.join(out2, "chkpnt10.npz"))

    # without --resume both output directories start empty: a stale
    # checkpoint never seeds the run
    calls.clear()
    with pytest.raises(SystemExit, match="refusing to start stage 2"):
        full_schedule.main(_args(scene, run, 4, 10))
    assert [resumed(a) for a in calls] == [None]
    assert os.listdir(out1) == [] and os.listdir(out2) == []


# ---------------------------------------------------------------------------
# the binner's overflow between two log lines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [1, 2])
def test_overflow_between_log_lines_is_reported(stage, monkeypatch, capsys):
    """A frame that overflows the instance buffer at a step that writes no
    log line is reported at the next one, and the cap grows: the loops
    read the flag only at log cadence, or-ed over the steps between."""
    from svgir_tpu_torch.cameras import look_at_camera
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.train import trainer

    n, s = 20, 4
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(n, 3, generator=g)
    state = G.init_from_points(pts, torch.full((n, 3), 0.5), capacity=n,
                               device="cpu")
    cam = look_at_camera(eye=[0, 0, -3], target=[0, 0, 0], up=[0, -1, 0],
                         fovx=1.0, fovy=1.0, width=16, height=16,
                         image=np.zeros((3, 16, 16)), device="cpu")
    steps, caps = [0], []

    def tb():
        steps[0] += 1
        z = torch.zeros(())
        return {"psnr": z, "psnr_pbr": z, "loss": z,
                "overflow": torch.tensor(steps[0] == 1)}

    def make1(opt, cfg, *a, **kw):
        caps.append(cfg.max_instances)
        return lambda st, ost, *_: (st, ost, tb())

    def make2(opt, cfg, *a, **kw):
        caps.append(cfg.max_instances)
        return lambda st, ost, env, *_: (st, ost, env, tb())
    cfg = RasterConfig(max_instances=256)
    if stage == 1:
        monkeypatch.setattr(trainer, "make_train_step", make1)
        _, _, hist = trainer.train_stage1(
            state, [cam], OptimizationConfig(), raster_cfg=cfg,
            iterations=4, log_every=2, device="cpu")
    else:
        monkeypatch.setattr(trainer, "make_svgss_train_step", make2)
        inc = torch.randn(n, s, 3, generator=g)
        bake = {"radiance": torch.rand(n, s, 3, generator=g),
                "incident_dirs": inc,
                "incident_qxy": torch.stack(LT.equirect_grid_coords(inc),
                                            -1)}
        _, _, _, _, hist = trainer.train_stage2(
            G.upgrade_to_pbr(state), [cam], OptimizationConfig(), bake=bake,
            raster_cfg=cfg, sample_num=s, env_resolution=8, first_iter=0,
            iterations=4, log_every=2, device="cpu")
    assert [h["iter"] for h in hist] == [2, 4]
    assert hist[0].get("overflow") == 1.0 and "overflow" not in hist[1]
    assert "instance-buffer overflow at or before iter 2" in \
        capsys.readouterr().out
    assert caps[-1] == 512                # the cap doubled once
