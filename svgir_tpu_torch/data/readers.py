"""Dataset readers and the scene container, the port's own copy of
``svgir_tpu.data.readers`` (reference ``scene/dataset_readers.py`` and
``scene/__init__.py``).

Five layouts: Blender/TensoIR (``transforms_*.json``, RGBA frames composited
over the background, optional monocular-normal ``.npy`` priors),
Synthetic4Relight (Blender plus per-frame albedo), COLMAP (``sparse/0``),
the DTU-style ``inputs/sfm_scene.json`` layout and StanfordORB (EXR
frames); ``load_scene`` picks one from what the directory holds.  Scenes
with no point cloud get the reference's 100,000 random points.  Cameras are
built on the CPU; ``train.staging.stage_cameras`` moves them to the card.

Images are read through OpenCV, which raises ``ImportError`` naming the
file where it is absent; a resize by a whole-number factor averages blocks
in torch, any other needs OpenCV too.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from svgir_tpu_torch.cameras import (Camera, area_resize, camera_at_scale,
                                     make_camera)
from svgir_tpu_torch.data import colmap as CM
from svgir_tpu_torch.data.ply import fetch_pointcloud, store_pointcloud
from svgir_tpu_torch.utils.graphics import focal2fov, fov2focal, rgb_to_srgb
from svgir_tpu_torch.utils.sh import C0

BOOTSTRAP_POINTS = 100_000   # dataset_readers.py:322 (no points3d.ply)


@dataclass
class SceneData:
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray
    cameras_extent: float
    ply_path: str = ""
    # downscaled camera lists, built on first use (the reference Scene
    # holds resolution scales [1, 4, 8], scene/__init__.py:29,90-95)
    _scaled: dict = field(default_factory=dict)

    def train_cameras_at(self, scale: float = 1.0) -> List[Camera]:
        return self._cams_at("train", scale)

    def test_cameras_at(self, scale: float = 1.0) -> List[Camera]:
        return self._cams_at("test", scale)

    def _cams_at(self, split: str, scale: float) -> List[Camera]:
        cams = getattr(self, f"{split}_cameras")
        if scale in (1, 1.0):
            return cams
        key = (split, scale)
        if key not in self._scaled:
            self._scaled[key] = [camera_at_scale(c, scale) for c in cams]
        return self._scaled[key]


def _w2c(cam: Camera) -> np.ndarray:
    return cam.world_view.cpu().numpy()


def _nerfpp_radius(w2cs: List[np.ndarray]) -> float:
    """getNerfppNorm (dataset_readers.py:46-67): 1.1 x the largest distance
    of a camera centre from their mean."""
    centers = np.stack([np.linalg.inv(m)[:3, 3] for m in w2cs])
    center = centers.mean(axis=0)
    return float(np.linalg.norm(centers - center, axis=1).max() * 1.1)


def _cv2(path: str):
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(f"reading {path} needs OpenCV (cv2), which is "
                          "not installed") from exc
    return cv2


def load_image_rgb(path: str) -> np.ndarray:
    """scene/utils.py:40-50: EXR linear -> sRGB; 8-bit images / 255.  A
    grey PNG comes back [H, W], RGB and RGBA ones [H, W, C] (grey + alpha
    comes back as RGBA, as OpenCV expands it)."""
    cv2 = _cv2(path)
    if path.endswith(".exr"):
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"{path}: OpenCV could not read the image")
    if img.ndim == 3:
        code = cv2.COLOR_BGRA2RGBA if img.shape[2] == 4 else cv2.COLOR_BGR2RGB
        img = cv2.cvtColor(img, code)
    if path.endswith(".exr"):
        img = img.astype(np.float32)
        img[..., :3] = rgb_to_srgb(torch.as_tensor(img[..., :3]),
                                   clip=False).numpy()
        return img
    return img.astype(np.float32) / 255.0


def _resolve_resolution(w: int, h: int, resolution: int) -> tuple[int, int]:
    """camera_utils.py:13-34: -1 caps the width at 1600; 1/2/4/8 divide."""
    if resolution in (1, 2, 4, 8):
        return w // resolution, h // resolution
    if resolution == -1:
        if w > 1600:
            scale = w / 1600
            return int(w / scale), int(h / scale)
        return w, h
    scale = w / resolution
    return int(w / scale), int(h / scale)


def _maybe_resize(img: np.ndarray, w: int, h: int,
                  path: str = "an image") -> np.ndarray:
    """INTER_AREA resize of [H, W] or [H, W, C] (``cameras.area_resize``)."""
    if img.shape[1] == w and img.shape[0] == h:
        return img
    t = torch.as_tensor(np.ascontiguousarray(img))
    chw = t[None] if img.ndim == 2 else t.permute(2, 0, 1)
    out = area_resize(chw, w, h, path)
    return (out[0] if img.ndim == 2 else out.permute(1, 2, 0)).numpy()


def read_blender_cameras(path: str, transforms_file: str,
                         white_background: bool, extension: str = ".png",
                         resolution: int = -1,
                         max_cameras: Optional[int] = None) -> List[Camera]:
    """readCamerasFromTransforms (dataset_readers.py:226-307)."""
    cams = []
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    bg = np.array([1.0, 1, 1]) if white_background else np.array([0.0, 0, 0])

    for idx, frame in enumerate(contents["frames"]):
        if max_cameras is not None and idx >= max_cameras:
            break
        fp = frame["file_path"]
        image_path = os.path.join(path, fp + extension) \
            if not fp.endswith(extension) else os.path.join(path, fp)
        image_name = Path(image_path).stem

        c2w = np.array(frame["transform_matrix"])
        c2w[:3, 1:3] *= -1     # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T      # cam -> world rotation (reference convention)
        T = w2c[:3, 3]

        img = load_image_rgb(image_path)
        mask = np.ones_like(img[..., 0])
        if img.shape[-1] == 4:
            mask = img[..., 3]
            img = img[..., :3] * img[..., 3:4] + bg * (1 - img[..., 3:4])

        mono = None
        for cand in (image_path.replace(image_name, "normal")
                     .rsplit(".", 1)[0] + ".npy",
                     image_path.replace(image_name, image_name + "_normal")
                     .rsplit(".", 1)[0] + ".npy"):
            if os.path.exists(cand):
                mono_n = np.load(cand)
                if mono_n.ndim == 3 and mono_n.shape[0] not in (3, 4):
                    mono_n = mono_n.transpose(2, 0, 1)
                mono = np.concatenate(
                    [mono_n[:3], np.zeros_like(mono_n[:1])], axis=0)
                break

        h0, w0 = img.shape[:2]
        w, h = _resolve_resolution(w0, h0, resolution)
        img = _maybe_resize(img, w, h, image_path)
        mask = _maybe_resize(mask, w, h, image_path)
        fovy = focal2fov(fov2focal(fovx, w), h)
        cams.append(make_camera(
            R, T, fovx, fovy, w, h,
            image=np.clip(img, 0, 1).transpose(2, 0, 1).astype(np.float32),
            image_mask=mask[None].astype(np.float32),
            mono=None if mono is None else mono.astype(np.float32),
            uid=idx, image_name=image_name, device="cpu"))
    return cams


def _random_cloud(rng, num_pts: int, lo: float, size: float):
    xyz = rng.random((num_pts, 3)) * size + lo
    shs = rng.random((num_pts, 3)) / 255.0
    normals = rng.standard_normal((num_pts, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return xyz, shs * C0 + 0.5, normals


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, extension: str = ".png",
                       resolution: int = -1,
                       max_cameras: Optional[int] = None) -> SceneData:
    """readNerfSyntheticInfo (dataset_readers.py:307-345), which also covers
    TensoIR-format scenes."""
    train = read_blender_cameras(path, "transforms_train.json",
                                 white_background, extension, resolution,
                                 max_cameras)
    test = []
    if eval_split and os.path.exists(os.path.join(path,
                                                  "transforms_test.json")):
        test = read_blender_cameras(path, "transforms_test.json",
                                    white_background, extension, resolution,
                                    max_cameras)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        xyz, rgb, normals = _random_cloud(np.random.default_rng(0),
                                          BOOTSTRAP_POINTS, -1.3, 2.6)
        try:
            store_pointcloud(ply_path, xyz, rgb * 255, normals)
        except OSError:
            pass
        pts, cols, nrms = (xyz.astype(np.float32), rgb.astype(np.float32),
                           normals.astype(np.float32))
    else:
        pts, cols, nrms = fetch_pointcloud(ply_path)

    extent = _nerfpp_radius([_w2c(c) for c in train])
    return SceneData(train, test, pts, cols, nrms, extent, ply_path)


def read_colmap_scene(path: str, images_dir: str = "images",
                      eval_split: bool = False, llffhold: int = 8,
                      resolution: int = -1,
                      max_cameras: Optional[int] = None) -> SceneData:
    """readColmapSceneInfo (dataset_readers.py:165-225)."""
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        images = CM.read_images_binary(os.path.join(sparse, "images.bin"))
        cameras = CM.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        xyz, rgb = CM.read_points3d_binary(
            os.path.join(sparse, "points3D.bin"))
    else:
        images = CM.read_images_text(os.path.join(sparse, "images.txt"))
        cameras = CM.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        xyz, rgb = CM.read_points3d_text(os.path.join(sparse, "points3D.txt"))

    cams = []
    for idx, (iid, im) in enumerate(sorted(images.items(),
                                           key=lambda kv: kv[1].name)):
        if max_cameras is not None and idx >= max_cameras:
            break
        cam = cameras[im.camera_id]
        R = CM.qvec2rotmat(im.qvec).T
        T = im.tvec
        if cam.model_id == 0 or cam.model_id == 2:   # SIMPLE_PINHOLE/RADIAL
            fx = fy = cam.params[0]
        else:
            fx, fy = cam.params[0], cam.params[1]
        image_path = os.path.join(path, images_dir, im.name)
        img = load_image_rgb(image_path)
        h0, w0 = img.shape[:2]
        w, h = _resolve_resolution(w0, h0, resolution)
        img = _maybe_resize(img, w, h, image_path)
        fovx = focal2fov(fx, cam.width)
        fovy = focal2fov(fy, cam.height)
        cams.append(make_camera(
            R, T, fovx, fovy, w, h,
            image=np.clip(img[..., :3], 0, 1).transpose(2, 0, 1)
            .astype(np.float32),
            image_mask=np.ones((1, h, w), np.float32),
            uid=idx, image_name=im.name, device="cpu"))

    if eval_split:
        train = [c for i, c in enumerate(cams) if i % llffhold != 0]
        test = [c for i, c in enumerate(cams) if i % llffhold == 0]
    else:
        train, test = cams, []

    extent = _nerfpp_radius([_w2c(c) for c in train])
    return SceneData(train, test, xyz.astype(np.float32),
                     (rgb / 255.0).astype(np.float32),
                     np.zeros_like(xyz, np.float32), extent)


def camera_to_json(idx: int, cam: Camera) -> dict:
    """camera_utils.py:87-122 layout (position and rotation are
    camera-to-world, whatever the reference's names say)."""
    c2w = np.linalg.inv(_w2c(cam))
    return {"id": idx, "img_name": cam.image_name,
            "width": int(cam.width), "height": int(cam.height),
            "position": c2w[:3, 3].tolist(),
            "rotation": [r.tolist() for r in c2w[:3, :3]],
            "FoVx": float(cam.fovx), "FoVy": float(cam.fovy)}


def dump_cameras_json(out_dir: str, scene: SceneData) -> str:
    """Scene.__init__'s cameras.json (scene/__init__.py:78-83), which the
    reference viewer reads for its first orbit pose."""
    cams = list(scene.train_cameras) + list(scene.test_cameras)
    path = os.path.join(out_dir, "cameras.json")
    with open(path, "w") as f:
        json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)
    return path


def load_scene(path: str, **kw) -> SceneData:
    """Dataset-type dispatch (scene/__init__.py:46-67)."""
    split_kw = {k: v for k, v in kw.items()
                if k in ("eval_split", "resolution", "max_cameras")}
    if os.path.exists(os.path.join(path, "sparse")):
        kw.pop("white_background", None)
        return read_colmap_scene(path, **kw)
    if os.path.exists(os.path.join(path, "inputs", "sfm_scene.json")):
        return read_sfm_scene(path, **split_kw)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        # Synthetic4Relight ships per-frame *_albedo.png ground truth
        probe = os.path.join(path, "test")
        if os.path.isdir(probe) and any(
                f.endswith("_albedo.png") for f in os.listdir(probe)[:50]):
            return read_synthetic4relight_scene(path, **split_kw)
        return read_blender_scene(path, **kw)
    raise ValueError(f"unrecognized scene layout at {path}")


def read_synthetic4relight_scene(path: str, eval_split: bool = True,
                                 resolution: int = -1,
                                 max_cameras: Optional[int] = None
                                 ) -> SceneData:
    """Synthetic4Relight layout (readNeRFSyntheticInfo2,
    dataset_readers.py:611+): the Blender layout with ``_rgba.png`` frames
    and per-frame ``_albedo.png``, whose paths go to ``albedo_paths`` for
    the relighting eval."""
    scene = read_blender_scene(path, white_background=True,
                               eval_split=eval_split, extension=".png",
                               resolution=resolution, max_cameras=max_cameras)
    albedos = []
    for cam in scene.test_cameras or scene.train_cameras:
        name = cam.image_name
        for suffix in ("_albedo.png", "albedo.png"):
            cand = os.path.join(path, "test" if scene.test_cameras
                                else "train", name.replace("_rgba", "")
                                + suffix)
            if os.path.exists(cand):
                albedos.append(cand)
                break
        else:
            albedos.append(None)
    scene.albedo_paths = albedos     # type: ignore[attr-defined]
    return scene


def make_gt_albedo_fn(scene: SceneData):
    """gt_albedo_fn(idx) -> (albedo [3, H, W], mask [1, H, W]) as numpy
    arrays, or None when the scene has no albedo ground truth."""
    paths = getattr(scene, "albedo_paths", None)
    if not paths or all(p is None for p in paths):
        return None
    cams = scene.test_cameras or scene.train_cameras

    def fn(idx):
        img = load_image_rgb(paths[idx])[..., :3]
        cam = cams[idx]
        img = _maybe_resize(img, cam.width, cam.height, paths[idx])
        return (np.clip(img, 0, 1).transpose(2, 0, 1).astype(np.float32),
                cam.image_mask.cpu().numpy())
    return fn


def read_sfm_scene(path: str, eval_split: bool = True, resolution: int = -1,
                   max_cameras: Optional[int] = None) -> SceneData:
    """The render_relight / DTU layout (readrender_relightInfo and
    loadCamsFromScene, dataset_readers.py:346-460): ``inputs/sfm_scene.json``
    holds a camera track map and a bbox transform that recentres and
    rescales the scene; points come from ``inputs/model/sparse.ply`` through
    the inverse bbox transform; foreground ``pmasks/*.png`` multiply the
    images.  The test split is the images of index 2, 12, 17, 30 and 34 with
    ``eval_split`` (the reference's DTU validation indices).  Cameras carry
    full fx/fy/cx/cy intrinsics."""
    inputs = os.path.join(path, "inputs")
    with open(os.path.join(inputs, "sfm_scene.json")) as f:
        sfm = json.load(f)

    bbox = np.array(sfm["bbox"]["transform"], np.float64).reshape(4, 4)
    bbox[[0, 1, 2], [0, 1, 2]] = bbox[[0, 1, 2], [0, 1, 2]].max() / 2
    bbox_inv = np.linalg.inv(bbox)

    image_list = sfm["image_path"]["file_paths"]
    valid_list = [2, 12, 17, 30, 34] if eval_split else []

    train, test = [], []
    for i, (index, info) in enumerate(sfm["camera_track_map"]["images"]
                                      .items()):
        if max_cameras is not None and i >= max_cameras:
            break
        if info.get("flg") != 2:          # flg == 2 marks a valid camera
            continue
        fx, fy = info["camera"]["intrinsic"]["focal"][:2]
        cx, cy = info["camera"]["intrinsic"]["ppt"][:2]

        extrinsic = np.array(info["camera"]["extrinsic"],
                             np.float64).reshape(4, 4)
        c2w = np.linalg.inv(extrinsic)
        c2w[:3, 3] = (c2w[:4, 3] @ bbox_inv.T)[:3]
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        rel = (image_list[index] if isinstance(image_list, dict)
               else image_list[int(index)])
        image_path = os.path.join(inputs, rel.lstrip("/"))
        image_name = Path(image_path).stem
        img = load_image_rgb(image_path)[..., :3]

        base = os.path.basename(rel)
        mask_path = os.path.join(
            inputs, "pmasks", os.path.splitext(base)[0] + ".png")
        if os.path.exists(mask_path):
            m = load_image_rgb(mask_path)
            m = m[..., 0] if m.ndim == 3 else m
            mask = (m > 0.5).astype(np.float32)
        else:
            mask = np.ones_like(img[..., 0])
        img = img * mask[..., None]

        h0, w0 = img.shape[:2]
        w, h = _resolve_resolution(w0, h0, resolution)
        if (w, h) != (w0, h0):
            img = _maybe_resize(img, w, h, image_path)
            mask = _maybe_resize(mask, w, h, mask_path)
            sx, sy = w / w0, h / h0
            fx, fy, cx, cy = fx * sx, fy * sy, cx * sx, cy * sy
        fovx = focal2fov(fx, w)
        fovy = focal2fov(fy, h)
        cam = make_camera(
            R, T, fovx, fovy, w, h, fx=fx, fy=fy, cx=cx, cy=cy,
            image=np.clip(img, 0, 1).transpose(2, 0, 1).astype(np.float32),
            image_mask=mask[None].astype(np.float32),
            uid=int(index), image_name=image_name, device="cpu")
        (test if int(index) in valid_list else train).append(cam)

    pts, cols, nrms = fetch_pointcloud(
        os.path.join(inputs, "model", "sparse.ply"))
    xyz_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=-1)
    pts = (xyz_h @ bbox_inv.T)[:, :3].astype(np.float32)
    scaled_ply = os.path.join(inputs, "model", "sparse_bbx_scale.ply")
    try:
        store_pointcloud(scaled_ply, pts, cols * 255.0, nrms)
    except OSError:
        scaled_ply = ""
    extent = _nerfpp_radius([_w2c(c) for c in train])
    return SceneData(train, test, pts, cols.astype(np.float32),
                     nrms.astype(np.float32), extent, scaled_ply)


def read_stanford_orb_scene(path: str, white_background: bool = False,
                            eval_split: bool = True,
                            extension: str = ".exr", resolution: int = -1,
                            max_cameras: Optional[int] = None) -> SceneData:
    """StanfordORB layout (readStanfordORBInfo, dataset_readers.py:515-560):
    ``transforms_{train,test}.json`` with EXR frames; the random start cloud
    fills [-0.5, 0.5]^3."""
    train = read_blender_cameras(path, "transforms_train.json",
                                 white_background, extension, resolution,
                                 max_cameras)
    test = []
    if eval_split and os.path.exists(os.path.join(path,
                                                  "transforms_test.json")):
        test = read_blender_cameras(path, "transforms_test.json",
                                    white_background, extension, resolution,
                                    max_cameras)
    xyz, rgb, normals = _random_cloud(np.random.default_rng(0),
                                      BOOTSTRAP_POINTS, -0.5, 1.0)
    extent = _nerfpp_radius([_w2c(c) for c in train])
    return SceneData(train, test, xyz.astype(np.float32),
                     rgb.astype(np.float32), normals.astype(np.float32),
                     extent)
