"""Configuration dataclasses of the training steps.

Field names and defaults are those of ``svgir_tpu.config`` (the reference's
``arguments/__init__.py`` ParamGroups): the defaults are the trained recipe.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OptimizationConfig:
    """Reference: ``arguments/__init__.py:72-142`` (OptimizationParams)."""

    iterations: int = 30_000

    finetune_visibility: bool = False

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    normal_lr: float = 0.01
    sh_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    env_lr: float = 0.025
    env_rest_lr: float = 0.001

    base_color_lr: float = 0.01
    roughness_lr: float = 0.01
    light_lr: float = 0.001
    light_rest_lr: float = 0.0001
    light_init: float = 3.0
    visibility_lr: float = 0.0025
    visibility_rest_lr: float = 0.0025
    radiance_lr: float = 0.0001
    radiance_ratio_lr: float = 0.01

    percent_dense: float = 0.001
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    max_points: int = 1_000_000

    densify_grad_threshold: float = 0.00025
    densify_grad_normal_threshold: float = 2e-9
    normal_densify_from_iter: int = 0

    lambda_depth: float = 0.0
    lambda_depth_smooth: float = 0.0
    lambda_mask_entropy: float = 0.0

    lambda_opacity: float = 0.0
    lambda_opacity_start_iteration: int = 5000
    lambda_surface: float = 0.0

    lambda_normal_render_depth: float = 0.0
    lambda_normal_mvs_depth: float = 0.0
    lambda_normal_smooth: float = 0.0
    lambda_point_entropy: float = 0.0
    lambda_orientation: float = 0.0
    lambda_orientation_from_iter: int = 5000
    lambda_depth_var: float = 0.0
    lambda_scaling: float = 0.0

    lambda_dssim: float = 0.1
    lambda_pbr: float = 1.0
    lambda_radiance: float = 0.05
    lambda_light: float = 0.0
    lambda_base_color: float = 0.0
    lambda_base_color_smooth: float = 0.0
    lambda_roughness_smooth: float = 0.0
    lambda_light_smooth: float = 0.0
    lambda_visibility_smooth: float = 0.0
    lambda_visibility: float = 0.0
    lambda_env_smooth: float = 0.0

    lambda_local_lights_smooth: float = 1.0


@dataclass(frozen=True)
class RasterConfig:
    """Rasterizer feature switches and capacity knobs.

    ``surface / normalize_depth / per_pixel_depth`` mirror the reference's
    runtime ``config`` tensor (``gaussian_model.py:148``).  ``tile`` is the
    pixel block edge (one CUDA thread block per tile, one thread per pixel,
    so ``tile**2`` must be a multiple of 32 and at most 1024).
    ``max_instances`` is the capacity of the (tile, depth)-sorted instance
    buffer; ``chunk`` the number of instances a blend block stages at once
    (it also sets the early-exit granularity).  ``binner`` is
    ``"counting"`` (sort-free, B1/B2) or ``"sort"`` (``bin_instances`` +
    ``pad_to_chunks``, the equivalence oracle).  ``strip > 0`` blends the
    counting binner's runs into image layout (B3/B4); ``strip == 0`` and
    the sort binner blend tile-major (B5/B6) and assemble the image after.
    ``rect_cap`` is accepted for parity with ``svgir_tpu`` and ignored, as
    it is there.
    """

    surface: bool = True
    normalize_depth: bool = True
    per_pixel_depth: bool = True
    tile: int = 32
    max_instances: int = 1 << 21
    chunk: int = 128
    binner: str = "counting"
    rect_cap: int = 16
    strip: int = 8
