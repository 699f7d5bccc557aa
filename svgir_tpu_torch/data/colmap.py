"""COLMAP sparse-reconstruction parsers (binary + text), the port's own copy
of ``svgir_tpu.data.colmap``.

The reference's ``scene/colmap_loader.py``: reads cameras.bin/images.bin (or .txt)
and points3D.bin/.txt following the documented COLMAP formats.  Only the
camera models the reference supports are handled: SIMPLE_PINHOLE (0),
PINHOLE (1), SIMPLE_RADIAL (2, treated as pinhole like the reference does).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

CAMERA_MODEL_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5,
                       8: 4, 9: 5, 10: 12}


@dataclass
class ColmapCamera:
    model_id: int
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    qvec: np.ndarray   # (w, x, y, z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cid, model, w, h = _read(f, "<iiQQ")
            n = CAMERA_MODEL_PARAMS[model]
            params = np.array(_read(f, f"<{n}d"))
            out[cid] = ColmapCamera(model, int(w), int(h), params)
    return out


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
            out[iid] = ColmapImage(qvec, tvec, cam_id, name.decode())
    return out


def read_points3d_binary(path: str):
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3))
        for i in range(num):
            _read(f, "<Q")
            xyz[i] = _read(f, "<3d")
            rgb[i] = _read(f, "<3B")
            _read(f, "<d")  # error
            (tl,) = _read(f, "<Q")
            f.read(8 * tl)
    return xyz, rgb


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    models = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2,
              "RADIAL": 3, "OPENCV": 4}
    out = {}
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        tok = line.split()
        out[int(tok[0])] = ColmapCamera(
            models.get(tok[1], 1), int(tok[2]), int(tok[3]),
            np.array([float(x) for x in tok[4:]]))
    return out


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    out = {}
    lines = [l for l in open(path)
             if not l.startswith("#") and l.strip()]
    for i in range(0, len(lines), 2):
        tok = lines[i].split()
        out[int(tok[0])] = ColmapImage(
            np.array([float(x) for x in tok[1:5]]),
            np.array([float(x) for x in tok[5:8]]),
            int(tok[8]), tok[9])
    return out


def read_points3d_text(path: str):
    xyz, rgb = [], []
    for line in open(path):
        if line.startswith("#") or not line.strip():
            continue
        tok = line.split()
        xyz.append([float(x) for x in tok[1:4]])
        rgb.append([float(x) for x in tok[4:7]])
    return np.array(xyz), np.array(rgb)
