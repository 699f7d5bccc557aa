"""Minimal PLY codec (binary little-endian and ascii), numpy only.

The same codec as ``svgir_tpu.data.ply`` (the reference's fetchPly /
storePly, dataset_readers.py:128-163, and the GaussianModel PLY format,
gaussian_model.py:825-1003): float32 vertex properties under the same
column names, so both packages write the same bytes and read each other's
files.
"""

from __future__ import annotations

import io
from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def _ply_type(dt) -> str:
    dt = np.dtype(dt)
    return {("f", 4): "float", ("f", 8): "double", ("u", 1): "uchar",
            ("i", 1): "char", ("i", 2): "short", ("u", 2): "ushort",
            ("i", 4): "int", ("u", 4): "uint"}[(dt.kind, dt.itemsize)]


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element -> dict of column name -> [N] array."""
    with open(path, "rb") as f:
        header: List[bytes] = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header has no end_header")
            header.append(line)
            if line.strip() == b"end_header":
                break
        fmt = None
        count = 0
        props: List[Tuple[str, str]] = []
        in_vertex = False
        for line in header:
            tok = line.strip().split()
            if not tok:
                continue
            if tok[0] == b"format":
                fmt = tok[1].decode()
            elif tok[0] == b"element":
                in_vertex = tok[1] == b"vertex"
                if in_vertex:
                    count = int(tok[2])
            elif tok[0] == b"property" and in_vertex:
                if tok[1] == b"list":
                    raise ValueError(f"{path}: list properties unsupported")
                props.append((tok[2].decode(), _DTYPES[tok[1].decode()]))

        if fmt == "ascii":
            data = np.atleast_2d(np.loadtxt(io.BytesIO(f.read()),
                                            max_rows=count))
            return {name: data[:, i].astype(np.dtype(dt))
                    for i, (name, dt) in enumerate(props)}
        rec = np.dtype([(n, d) for n, d in props])
        arr = np.frombuffer(f.read(rec.itemsize * count), dtype=rec,
                            count=count)
        if fmt == "binary_big_endian":
            arr = arr.byteswap().view(arr.dtype.newbyteorder())
        return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with one 'vertex' element, the
    columns interleaved through a numpy structured array."""
    names = list(columns)
    n = len(next(iter(columns.values())))
    rec = np.dtype([(name, np.asarray(columns[name]).dtype.newbyteorder("<"))
                    for name in names])
    arr = np.empty(n, rec)
    for name in names:
        arr[name] = np.asarray(columns[name])
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in names:
            f.write(f"property {_ply_type(rec[name])} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(arr.tobytes())


def fetch_pointcloud(path: str):
    """fetchPly (dataset_readers.py:128-145): points, colors, normals."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], -1)
        cols = cols.astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in v:
        nrm = np.stack([v["nx"], v["ny"], v["nz"]], -1).astype(np.float32)
    else:
        nrm = np.zeros_like(pts)
    return pts, cols, nrm


def store_pointcloud(path: str, xyz: np.ndarray, rgb: np.ndarray,
                     normals: np.ndarray) -> None:
    """storePly (dataset_readers.py:146-163); rgb in [0, 255]."""
    write_ply(path, {
        "x": xyz[:, 0].astype(np.float32),
        "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": normals[:, 0].astype(np.float32),
        "ny": normals[:, 1].astype(np.float32),
        "nz": normals[:, 2].astype(np.float32),
        "red": rgb[:, 0].astype(np.uint8),
        "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    })
