"""The port's data layer against svgir_tpu's on the CPU: the PLY codec and
the model PLY (bytes), PNG frames (against imageio), the scene readers
(cameras, images, masks, extent, start cloud), checkpoints across the two
packages, the morton order of ``init_from_points``, ``camera_at_scale``
and camera staging.

Tolerances: cameras are built by the same numpy float32 code in both
packages and must be equal; images are equal, except where a resize takes
another route (the port averages k x k blocks where OpenCV's INTER_AREA
does the same sum in another order: 1e-6).  The model PLY's nx/ny/nz
columns are the geometric normal, which each package computes with its own
float32 rotation math (a few ulp apart), so files of surfels with random
rotations are equal outside those columns and within 2e-6 inside them;
files of axis-aligned surfels (the CLI's identity start) are equal byte
for byte.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.cameras import camera_at_scale as j_at_scale
from svgir_tpu.data import ply as JPLY
from svgir_tpu.data import readers as JR
from svgir_tpu.models import gaussians as JG
from svgir_tpu.train import checkpoint as JCK
from svgir_tpu.train import optim as joptim

from svgir_tpu_torch.cameras import camera_at_scale as t_at_scale
from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.data import ply as TPLY
from svgir_tpu_torch.data import readers as TR
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.train import checkpoint as TCK
from svgir_tpu_torch.train import staging
from svgir_tpu_torch.train.staging import stage_cameras

from tests.test_data import _write_blender_scene, _write_sfm_scene


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



def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["pointcloud", "float_table"])
def test_write_ply_bytes_equal_jax_and_read_back(tmp_path, kind):
    rng = np.random.default_rng(0)
    a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    if kind == "pointcloud":      # float and uchar columns
        xyz, nrm = rng.normal(size=(100, 3)), rng.normal(size=(100, 3))
        rgb = rng.random((100, 3)) * 255
        JPLY.store_pointcloud(a, xyz, rgb, nrm)
        TPLY.store_pointcloud(b, xyz, rgb, nrm)
        cols = {"x": xyz[:, 0].astype(np.float32),
                "red": rgb[:, 0].astype(np.uint8)}
    else:                         # all float32 (JAX's native interleave)
        cols = {f"c{i}": rng.normal(size=257).astype(np.float32)
                for i in range(7)}
        JPLY.write_ply(a, cols)
        TPLY.write_ply(b, cols)
    assert _bytes(a) == _bytes(b)
    back = TPLY.read_ply(b)
    for k, v in cols.items():
        np.testing.assert_array_equal(back[k], v)
    if kind == "pointcloud":
        for x, y in zip(TPLY.fetch_pointcloud(b), JPLY.fetch_pointcloud(a)):
            np.testing.assert_array_equal(x, y)


# ---- images ---------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3, 4])
def test_load_image_rgb_matches_jax(tmp_path, channels):
    """PNG frames read through OpenCV give what the JAX reader's imageio
    gives: grey, RGB and RGBA, 8 bits, / 255."""
    import imageio.v2 as imageio
    rng = np.random.default_rng(channels)
    img = (rng.random((13, 11, channels)) * 256).astype(np.uint8)
    img[4:9] = img[4:9] // 16 * 16          # smooth rows too
    path = str(tmp_path / "f.png")
    imageio.imwrite(path, img[..., 0] if channels == 1 else img)
    got = TR.load_image_rgb(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JR.load_image_rgb(path))


# ---- scene readers ------------------------------------------------------

def _same_camera(t, j, img_tol=0.0):
    assert (t.width, t.height, t.uid, t.image_name) == \
        (j.width, j.height, j.uid, j.image_name)
    assert (t.fovx, t.fovy, t.znear, t.zfar) == (j.fovx, j.fovy, j.znear,
                                                j.zfar)
    for f in ("world_view", "full_proj", "camera_center", "prcppoint"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("image", "image_mask", "mono"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.device.type == "cpu" and a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=img_tol, err_msg=f)


def _same_scene(t, j, img_tol=0.0):
    assert len(t.train_cameras) == len(j.train_cameras)
    assert len(t.test_cameras) == len(j.test_cameras)
    for a, b in zip(t.train_cameras + t.test_cameras,
                    j.train_cameras + j.test_cameras):
        _same_camera(a, b, img_tol)
    assert t.cameras_extent == j.cameras_extent
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    assert os.path.basename(t.ply_path) == os.path.basename(j.ply_path)


@pytest.mark.parametrize("resolution", [-1, 2])
def test_blender_reader_matches_jax(tmp_path, resolution):
    root = str(tmp_path / "scene")
    _write_blender_scene(root, n_frames=3, res=32)
    kw = dict(white_background=True, eval_split=False, resolution=resolution)
    j = JR.load_scene(root, **kw)          # bootstraps and writes the cloud
    os.remove(os.path.join(root, "points3d.ply"))
    t = TR.load_scene(root, **kw)
    assert t.points.shape == (100_000, 3)
    _same_scene(t, j, img_tol=1e-6 if resolution == 2 else 0.0)
    # the stored cloud reads back the same through both packages
    t2, j2 = TR.load_scene(root, **kw), JR.load_scene(root, **kw)
    _same_scene(t2, j2, img_tol=1e-6 if resolution == 2 else 0.0)
    # downscaled cameras (eval scale 4) and cameras.json
    for a, b in zip(t.train_cameras_at(4), j.train_cameras_at(4)):
        _same_camera(a, b, img_tol=1e-6)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(pj)
    os.makedirs(pt)
    with open(JR.dump_cameras_json(pj, j)) as f:
        cj = json.load(f)
    with open(TR.dump_cameras_json(pt, t)) as f:
        assert json.load(f) == cj


def test_sfm_reader_matches_jax(tmp_path):
    _write_sfm_scene(str(tmp_path))
    for kw in (dict(eval_split=True), dict(eval_split=True, resolution=12)):
        _same_scene(TR.load_scene(str(tmp_path), **kw),
                    JR.load_scene(str(tmp_path), **kw), img_tol=1e-6)


def test_camera_at_scale_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((3, 24, 36)).astype(np.float32)
    kw = dict(eye=[0, 0, -3], target=[0, 0, 0], up=[0, -1, 0], fovx=1.0,
              fovy=0.8, width=36, height=24, image=img)
    from svgir_tpu.cameras import look_at_camera as j_look_at
    j, t = j_look_at(**kw), look_at_camera(**kw, device="cpu")
    for scale in (2, 3, 5):     # whole factors, and one OpenCV resizes
        _same_camera(t_at_scale(t, scale), j_at_scale(j, scale),
                     img_tol=1e-6)


# ---- checkpoints, PLY models, morton order --------------------------------

def _jax_state():
    rng = np.random.default_rng(3)
    js = JG.upgrade_to_pbr(JG.init_from_points(
        jnp.asarray(rng.normal(size=(40, 3)), jnp.float32),
        jnp.asarray(rng.random((40, 3)), jnp.float32), capacity=64))
    params = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
              for k, v in js["params"].items()}
    params["radiance_ratio"] = jnp.float32(0.75)
    js = {**js, "params": params}
    ost = joptim.adam_init(params)
    ost = {**ost, "m": {k: v + 0.5 for k, v in ost["m"].items()},
           "step": jnp.int32(17)}
    env = {"params": {"env": jnp.ones((4, 8, 3))},
           "opt": joptim.adam_init({"env": jnp.ones((4, 8, 3))})}
    extra = {"hit_idx": jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
             "uv": jnp.full((3, 4, 2), 0.25)}
    return js, ost, env, extra


def test_checkpoints_cross_between_packages(tmp_path):
    js, jost, jenv, jextra = _jax_state()
    a, b = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JCK.save_checkpoint(a, 123, js, jost, env=jenv, extra=jextra)
    it, tree = TCK.load_checkpoint(a, device="cpu")
    assert it == 123
    assert tree["opt"]["step"] == 17 and tree["env"]["opt"]["step"] == 0
    assert tree["state"]["alive"].dtype == torch.bool
    # the port writes back what it read; JAX reads it key for key
    TCK.save_checkpoint(b, it, tree["state"], tree["opt"], env=tree["env"],
                        extra=tree["extra"])
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    it2, jtree = JCK.load_checkpoint(b)
    assert it2 == 123
    leaves_a = jax.tree_util.tree_leaves_with_path(
        {"state": js, "opt": jost, "env": jenv, "extra": jextra})
    leaves_b = dict(jax.tree_util.tree_leaves_with_path(jtree))
    for path, v in leaves_a:
        np.testing.assert_array_equal(np.asarray(leaves_b[path]),
                                      np.asarray(v))


@pytest.mark.parametrize("pbr", [False, True])
def test_model_ply_matches_jax(tmp_path, pbr):
    js, _, _, _ = _jax_state()
    if not pbr:
        p = {k: js["params"][k] for k in ("xyz", "shs_dc", "shs_rest",
                                         "opacity", "scaling", "rotation")}
        p["normal"] = jnp.zeros((64, 3))
        js = {**js, "params": p}
    tparams = TG.params_from_jax(jax.device_get(js["params"]), device="cpu")
    alive = torch.as_tensor(np.asarray(js["alive"]))
    a, b = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    JCK.save_model_ply(a, js["params"], js["alive"], use_pbr=pbr)
    TCK.save_model_ply(b, tparams, alive, use_pbr=pbr)
    va, vb = JPLY.read_ply(a), TPLY.read_ply(b)
    assert list(va) == list(vb)
    for k in va:
        np.testing.assert_allclose(vb[k], va[k], rtol=0,
                                   atol=2e-6 if k in ("nx", "ny", "nz")
                                   else 0, err_msg=k)
    # axis-aligned surfels: the same bytes
    js["params"]["rotation"] = jnp.zeros((64, 4)).at[:, 0].set(1.0)
    tparams["rotation"] = torch.zeros(64, 4)
    tparams["rotation"][:, 0] = 1.0
    JCK.save_model_ply(a, js["params"], js["alive"], use_pbr=pbr)
    TCK.save_model_ply(b, tparams, alive, use_pbr=pbr)
    assert _bytes(a) == _bytes(b)
    # and each package loads the other's file
    jl, tl = JCK.load_model_ply(b), TCK.load_model_ply(a, device="cpu")
    for k in jl["params"]:
        np.testing.assert_array_equal(tl["params"][k].numpy(),
                                      np.asarray(jl["params"][k]), err_msg=k)
    np.testing.assert_array_equal(tl["alive"].numpy(), np.asarray(jl["alive"]))


def test_init_from_points_morton_order_matches_jax():
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(3000, 3)) * [1.0, 0.2, 3.0]).astype(np.float32)
    cols = rng.random((3000, 3)).astype(np.float32)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    # given distances: the brute 3-NN of the two packages may pick another
    # neighbour at a near tie, which is no part of the order
    d2 = rng.random(3000).astype(np.float32)
    js = JG.init_from_points(jnp.asarray(pts), jnp.asarray(cols),
                             normals=jnp.asarray(nrm),
                             mean_sq_dist=jnp.asarray(d2), morton_order=True)
    ts = TG.init_from_points(pts, cols, normals=nrm, mean_sq_dist=d2,
                             morton_order=True, device="cpu")
    for k in ("xyz", "normal", "shs_dc"):
        np.testing.assert_array_equal(ts["params"][k].numpy(),
                                      np.asarray(js["params"][k]), err_msg=k)
    # log(sqrt(d2)): the packages' float32 log rounds a last place apart
    np.testing.assert_allclose(ts["params"]["scaling"].numpy(),
                               np.asarray(js["params"]["scaling"]), rtol=0,
                               atol=1e-6)
    assert not np.array_equal(ts["params"]["xyz"].numpy()[:3000], pts)


# ---- staging --------------------------------------------------------------

def _cam(img, res=16):
    return look_at_camera(eye=[0, 0, -3], target=[0, 0, 0], up=[0, -1, 0],
                          fovx=1.0, fovy=1.0, width=res, height=res,
                          image=img, device="cpu")


def test_stage_cameras_float32_uint8_and_budget(monkeypatch):
    rng = np.random.default_rng(0)
    lossy = _cam(rng.random((3, 16, 16)).astype(np.float32))
    (out,) = stage_cameras([lossy], device="cpu")
    assert out.image is lossy.image
    # 8-bit data is staged as float32 too, value for value
    img8 = ((np.arange(3 * 256).reshape(3, 16, 16) % 256) / 255.0)
    eight = _cam(img8.astype(np.float32))
    (out,) = stage_cameras([eight], device="cpu")
    assert out.image.dtype == torch.float32
    np.testing.assert_array_equal(out.image.numpy(),
                                  img8.astype(np.float32))
    np.testing.assert_array_equal(out.image_mask.numpy(), 1.0)
    # a device without room for the image-plane tensors: staging raises
    # before it moves anything (image and mask, 4 x 16 x 16 float32)
    wide = dataclasses.replace(eight, image=eight.image.double(),
                               image_mask=eight.image_mask.double())
    monkeypatch.setattr(staging, "_free_bytes", lambda device: 4095)
    with pytest.raises(MemoryError, match="staging 1 cameras needs"):
        stage_cameras([wide], device="cpu")
    monkeypatch.setattr(staging, "_free_bytes", lambda device: 4096)
    (out,) = stage_cameras([wide], device="cpu")
    assert out.image.dtype == torch.float32
