"""Orbit-camera viewer, the twin of the repository's ``gui.py``:

    python -m svgir_tpu_torch.cli.gui -c out/lego/chkpnt50000.npz \\
        [--buffer normal] [--headless --frames 24 --output gui_frames]

Shows a checkpoint's render buffers (render, pbr, base_color, roughness,
visibility, normal, depth) from a camera that orbits the origin, in a
dearpygui window where dearpygui is installed; with ``--headless``, or
without dearpygui, it writes an orbit of ``--frames`` PNGs instead.  A
stage-2 checkpoint without a bake is baked as the trainer bakes it.
The flags are those of ``gui.py`` plus ``--device`` (``cuda`` unless
asked for ``cpu``).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


class OrbitCamera:
    """gui.py:26-90: azimuth / elevation / radius orbit state."""

    def __init__(self, width, height, fovy=50.0, radius=3.0, device="cuda"):
        self.width, self.height = width, height
        self.fovy = math.radians(fovy)
        self.radius = radius
        self.azimuth = 0.0
        self.elevation = 0.2
        self.center = np.zeros(3)
        self.device = device

    def camera(self):
        from svgir_tpu_torch.cameras import look_at_camera
        eye = self.center + self.radius * np.array([
            math.sin(self.azimuth) * math.cos(self.elevation),
            math.sin(self.elevation),
            -math.cos(self.azimuth) * math.cos(self.elevation)])
        return look_at_camera(eye=eye, target=self.center, up=[0, -1, 0],
                              fovx=self.fovy, fovy=self.fovy,
                              width=self.width, height=self.height,
                              device=self.device)

    def orbit(self, d_az, d_el):
        self.azimuth += d_az
        self.elevation = float(np.clip(self.elevation + d_el, -1.4, 1.4))

    def zoom(self, factor):
        self.radius = float(np.clip(self.radius * factor, 0.1, 100.0))


def build_render_fn(checkpoint, mode, sample_num, max_instances,
                    device="cuda"):
    """render_one(camera) -> the render's buffers: stage 1 for ``render``
    or a stage-1 checkpoint, else stage 2 with the checkpoint's env (a
    white light where it has none) and its bake (else the trainer's)."""
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.train import checkpoint as CK

    cfg = RasterConfig(max_instances=max_instances)
    _, tree = CK.load_checkpoint(checkpoint, device=device)
    state = tree["state"]
    params, alive = state["params"], state["alive"].to(bool)
    bg = torch.zeros(3, device=device)
    opt = OptimizationConfig()

    if mode == "render" or "base_color" not in params:
        from svgir_tpu_torch.render.stage1 import render_stage1

        @torch.no_grad()
        def render_one(cam):
            return render_stage1(cam, params, bg, opt=opt,
                                 is_training=False, alive=alive, cfg=cfg)
        return render_one

    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.render.svgss import render_svgss
    from svgir_tpu_torch.train.trainer import bake_radiance_compact

    bake = tree.get("extra")
    if bake is None:
        with torch.no_grad():
            bake = bake_radiance_compact(params, alive,
                                         sample_num=sample_num)
    bake = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    if "incident_qxy" not in bake:              # a bake saved by svgir_tpu
        bake["incident_qxy"] = torch.stack(
            LT.equirect_grid_coords(bake["incident_dirs"]), -1)
    env = tree.get("env")

    @torch.no_grad()
    def render_one(cam):
        return render_svgss(cam, params, bg, bake=bake,
                            env_params=env["params"] if env else None,
                            env_fn=None if env else torch.ones_like,
                            opt=opt, is_training=False, alive=alive,
                            cfg=cfg)
    return render_one


def buffer_to_rgb(res, buffer):
    """A render buffer as [H, W, 3] numpy in [0, 1]: depth normalised,
    normals mapped from [-1, 1], one channel repeated."""
    img = res[buffer].detach().float().cpu().numpy()
    if buffer == "depth":
        d = img[0]
        rng = d.max() - d.min() + 1e-8
        img = np.stack([(d - d.min()) / rng] * 3)
    elif buffer in ("normal", "pseudo_normal"):
        img = img * 0.5 + 0.5
    elif img.shape[0] == 1:
        img = np.repeat(img, 3, axis=0)
    return np.clip(img.transpose(1, 2, 0), 0, 1)


def run_headless(args, render_one):
    from svgir_tpu_torch.eval.nvs import save_image

    cam = OrbitCamera(args.resolution, args.resolution, radius=args.radius,
                      device=args.device)
    os.makedirs(args.output, exist_ok=True)
    for i in range(args.frames):
        cam.azimuth = 2 * math.pi * i / args.frames
        img = buffer_to_rgb(render_one(cam.camera()), args.buffer)
        save_image(os.path.join(args.output, f"{i:04d}.png"), img)
        print(f"frame {i + 1}/{args.frames}", flush=True)


def run_dearpygui(args, render_one):
    import dearpygui.dearpygui as dpg

    cam = OrbitCamera(args.resolution, args.resolution, radius=args.radius,
                      device=args.device)
    state = {"buffer": args.buffer, "dirty": True}

    dpg.create_context()
    with dpg.texture_registry():
        dpg.add_raw_texture(args.resolution, args.resolution,
                            np.zeros((args.resolution, args.resolution, 4),
                                     np.float32),
                            format=dpg.mvFormat_Float_rgba, tag="tex")
    with dpg.window(tag="main"):
        dpg.add_image("tex")
        dpg.add_combo(["render", "pbr", "base_color", "roughness",
                       "visibility", "normal", "depth"],
                      default_value=args.buffer,
                      callback=lambda s, a: (state.update(buffer=a,
                                                          dirty=True)))

    def on_drag(sender, app_data):
        cam.orbit(app_data[1] * 0.01, app_data[2] * 0.01)
        state["dirty"] = True

    def on_wheel(sender, app_data):
        cam.zoom(0.9 if app_data > 0 else 1.1)
        state["dirty"] = True

    with dpg.handler_registry():
        dpg.add_mouse_drag_handler(callback=on_drag)
        dpg.add_mouse_wheel_handler(callback=on_wheel)

    dpg.create_viewport(title="svgir_tpu_torch viewer",
                        width=args.resolution + 40,
                        height=args.resolution + 80)
    dpg.setup_dearpygui()
    dpg.show_viewport()
    dpg.set_primary_window("main", True)
    while dpg.is_dearpygui_running():
        if state["dirty"]:
            img = buffer_to_rgb(render_one(cam.camera()), state["buffer"])
            rgba = np.concatenate(
                [img, np.ones_like(img[..., :1])], -1).astype(np.float32)
            dpg.set_value("tex", rgba.ravel())
            state["dirty"] = False
        dpg.render_dearpygui_frame()
    dpg.destroy_context()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="svgir_tpu_torch viewer")
    parser.add_argument("-c", "--checkpoint", required=True)
    parser.add_argument("-t", "--type", default="render_relight",
                        choices=["render", "render_relight"])
    parser.add_argument("--buffer", default="render")
    parser.add_argument("--resolution", type=int, default=512)
    parser.add_argument("--radius", type=float, default=3.0)
    parser.add_argument("--sample_num", type=int, default=24)
    parser.add_argument("--max_instances", type=int, default=1 << 19)
    parser.add_argument("--headless", action="store_true")
    parser.add_argument("--output", default="gui_frames")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    render_one = build_render_fn(args.checkpoint, args.type,
                                 args.sample_num, args.max_instances,
                                 device=args.device)
    try:
        if args.headless:
            raise ImportError("headless requested")
        import dearpygui.dearpygui  # noqa: F401
        run_dearpygui(args, render_one)
    except ImportError:
        print("dearpygui unavailable or headless: writing orbit frames")
        run_headless(args, render_one)


if __name__ == "__main__":
    main()
