"""Relighting and scene-composition trajectory renderer, the twin of the
repository's ``relighting.py``:

    python -m svgir_tpu_torch.cli.relighting --config configs/example \\
        --hdr sky.hdr --output relight_out [--capture_list pbr_env,normal]

Composes one or more stage-2 model PLYs (each under its own 4x4
transform), bakes the composed scene once under the unrotated light,
renders a camera trajectory with the light each frame asks for, writes
each requested capture buffer as ``<output>/<capture>/frame_<id>.png``
and one ``<output>/<capture>.mp4`` at 60 fps (OpenCV's ``VideoWriter``;
where it cannot open the file the video is skipped with a message and the
frames stay).

``--config`` takes three forms:

* a config directory (``configs/example/``) holding ``transform.json``
  ({name: {path, transform[16]}}), and optionally ``trajectory.json``
  ({"camera": {width, height, fov}, "trajectory": {id: w2c[16]}}) and
  ``light_transform.json`` ({"transform": {id: rot3x3[9]}});
* a JSON file with a list of {path, transform?} entries;
* a single ``.ply`` path.

Without a trajectory the cameras orbit the origin (``--frames``,
``--radius``, ``--height``, ``--resolution``); without a light transform
the light stays, or turns once about z over the orbit with
``--rotate_light``.  The flags are those of ``relighting.py`` plus
``--device`` (``cuda`` unless asked for ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch

FPS = 60


def orbit_cameras(n_frames, radius, height, fov, res, device="cuda"):
    from svgir_tpu_torch.cameras import look_at_camera
    cams = []
    for i in range(n_frames):
        a = 2 * math.pi * i / n_frames
        eye = [radius * math.sin(a), height, -radius * math.cos(a)]
        cams.append(look_at_camera(eye=eye, target=[0, 0, 0], up=[0, -1, 0],
                                   fovx=fov, fovy=fov, width=res, height=res,
                                   device=device))
    return cams


def trajectory_cameras(traject: dict, device="cuda"):
    """Cameras of a trajectory.json: each entry a row-major w2c 4x4,
    R = w2c[:3, :3].T, T = w2c[:3, 3] (relighting.py:158-165); fovx is the
    reference's fixed 0.6911112070083618 (:151).  Returns (cameras, ids)."""
    from svgir_tpu_torch.cameras import make_camera
    from svgir_tpu_torch.utils.graphics import focal2fov, fov2focal

    H = int(traject["camera"]["height"])
    W = int(traject["camera"]["width"])
    fovx = 0.6911112070083618
    fovy = focal2fov(fov2focal(fovx, W), H)
    cams, ids = [], []
    for idx, vals in traject["trajectory"].items():
        w2c = np.array(vals, np.float32).reshape(4, 4)
        cams.append(make_camera(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy, W, H,
                                device=device))
        ids.append(str(idx))
    return cams, ids


def rotation_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def load_config(cfg: str):
    """-> (scene entries, trajectory dict or None, light dict or None)."""
    if cfg.endswith(".ply"):
        return [{"path": cfg}], None, None
    if os.path.isdir(cfg):                   # a config directory
        with open(os.path.join(cfg, "transform.json")) as f:
            entries = list(json.load(f).values())

        def opt(name):
            p = os.path.join(cfg, f"{name}.json")
            if not os.path.exists(p):
                return None
            with open(p) as f:
                return json.load(f)

        return entries, opt("trajectory"), opt("light_transform")
    with open(cfg) as f:
        return json.load(f), None, None


def compose(entries, device="cuda"):
    """The model PLYs of ``entries``, each moved by its transform, in one
    state (relighting.py scene_composition :28-54)."""
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.train.checkpoint import load_model_ply

    states = []
    for e in entries:
        st = load_model_ply(e["path"], device=device)
        if "transform" in e:
            tf = torch.as_tensor(np.array(e["transform"], np.float32)
                                 .reshape(4, 4), device=device)
            st = {**st, "params": G.apply_transform(st["params"], tf)}
        states.append(st)
    return states[0] if len(states) == 1 else G.concatenate_models(states)


def composite(res, ct: str, bgv: float) -> np.ndarray:
    """The capture ``ct`` of a rendered frame over the background, clipped
    to [0, 1] (relighting.py:174-183), as [C, H, W] numpy."""
    if ct not in res:
        raise SystemExit(f"unknown capture type {ct!r}; available: "
                         f"{sorted(res)}")
    opacity = res["opacity"].detach().cpu().numpy()
    img = res[ct].detach().float().cpu().numpy()
    if ct == "normal":
        img = img * 0.5 + 0.5 + (1 - opacity) * bgv
    elif ct in ("base_color", "roughness", "visibility"):
        img = img + (1 - opacity) * bgv
    return np.clip(img, 0, 1)


def write_videos(output: str, frames: dict) -> None:
    """One ``<capture>.mp4`` per capture at ``FPS``, or the reference's
    skip message where OpenCV cannot open the writer."""
    import cv2

    for ct, fr in frames.items():
        path = os.path.join(output, f"{ct}.mp4")
        h, w = fr[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                                 (w, h))
        if not writer.isOpened():
            print(f"video export skipped (OpenCV cannot write {path} with "
                  "the mp4v codec); frames written", flush=True)
            return
        for f in fr:
            writer.write(np.ascontiguousarray(f[..., ::-1]))   # RGB -> BGR
        writer.release()
        print(f"wrote {path}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="svgir_tpu_torch relighting trajectory renderer")
    parser.add_argument("--config", required=True,
                        help="config dir (transform/trajectory/"
                             "light_transform.json), a JSON list of "
                             "{path, transform?} entries, or a .ply path")
    parser.add_argument("--hdr", required=True)
    parser.add_argument("--output", default="relight_out")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--radius", type=float, default=3.0)
    parser.add_argument("--height", type=float, default=0.5)
    parser.add_argument("--sample_num", type=int, default=64)
    parser.add_argument("--capture_list", default="pbr_env",
                        help="comma-separated buffers to save "
                             "(relighting.py:101: pbr_env, render, normal, "
                             "base_color, roughness, visibility, ...)")
    parser.add_argument("-bg", "--background_color", type=float, default=0.0)
    parser.add_argument("--video", action="store_true", default=True)
    parser.add_argument("--rotate_light", action="store_true",
                        help="rotate the env light one full turn over the "
                             "trajectory (used when no light_transform.json)")
    parser.add_argument("--max_instances", type=int, default=1 << 20)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on")
    return parser


@torch.no_grad()
def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = args.device

    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.eval.nvs import save_image
    from svgir_tpu_torch.eval.relighting import rebake_radiance_for_light
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.render.svgss import render_svgss

    entries, traject, light_dict = load_config(args.config)
    state = compose(entries, device=dev)
    params, alive = state["params"], state["alive"]
    if "base_color" not in params:
        raise SystemExit("relighting requires a stage-2 (PBR) model PLY")

    hdr = LT.load_hdr(args.hdr)
    cfg = RasterConfig(max_instances=args.max_instances)
    capture_list = [s.strip() for s in args.capture_list.split(",")]
    for ct in capture_list:
        os.makedirs(os.path.join(args.output, ct), exist_ok=True)

    if traject is not None:
        cams, frame_ids = trajectory_cameras(traject, device=dev)
    else:
        cams = orbit_cameras(args.frames, args.radius, args.height,
                             math.pi / 3, args.resolution, device=dev)
        frame_ids = [str(i) for i in range(len(cams))]
    bgv = float(args.background_color)
    bg = torch.full((3,), bgv, device=dev)

    env0 = LT.env_light_init(hdr, transform=np.eye(3, dtype=np.float32),
                             device=dev)
    bake, radiances = rebake_radiance_for_light(params, alive, env0,
                                                sample_num=args.sample_num)
    params = {**params, "radiances": radiances,
              "radiance_ratio": torch.ones((), device=dev)}
    bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}

    def render_frame(env_state, cam):
        return render_svgss(cam, params, bg, bake=bake, env_params=None,
                            env_fn=lambda d: LT.env_light_direct(env_state,
                                                                 d),
                            opt=OptimizationConfig(), is_training=False,
                            alive=alive, cfg=cfg)

    frames = {ct: [] for ct in capture_list}
    n = len(cams)
    for i, (fid, cam) in enumerate(zip(frame_ids, cams)):
        if light_dict is not None:     # a 3x3 a frame (relighting.py:166-167)
            rot = np.array(light_dict["transform"][fid],
                           np.float32).reshape(3, 3)
            env = LT.env_light_init(hdr, transform=rot, device=dev)
        elif args.rotate_light:
            env = LT.env_light_init(
                hdr, transform=rotation_z(2 * math.pi * i / n), device=dev)
        else:
            env = env0
        res = render_frame(env, cam)
        for ct in capture_list:
            img = composite(res, ct, bgv)
            save_image(os.path.join(args.output, ct, f"frame_{fid}.png"), img)
            if img.shape[0] == 1:
                img = np.repeat(img, 3, 0)
            frames[ct].append((img[:3].transpose(1, 2, 0)
                               * 255).astype(np.uint8))
        print(f"frame {i + 1}/{n}", flush=True)

    if args.video:
        write_videos(args.output, frames)


if __name__ == "__main__":
    main()
