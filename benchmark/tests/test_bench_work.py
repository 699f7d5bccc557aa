"""The yardstick's counts against hand counts on scenes small enough to
count: the blend's rows and pairs, the bounds' arithmetic and the env
lookup's."""

import math

import pytest
import torch

import work
from reference.cameras import look_at_camera
from reference.config import RasterConfig
from reference.utils.transforms import inverse_sigmoid, normal_to_rotation


def _scene(points, scale=0.01, opacity=0.9):
    n = len(points)
    xyz = torch.tensor(points, dtype=torch.float32)
    normals = torch.tensor([[0.0, 0.0, 1.0]] * n)      # towards the eye
    params = {
        "xyz": xyz, "scaling": torch.full((n, 3), math.log(scale)),
        "rotation": normal_to_rotation(normals),
        "opacity": inverse_sigmoid(torch.full((n, 1), opacity)),
    }
    return params, torch.ones(n, dtype=torch.bool)


def _camera(res=64):
    return look_at_camera(eye=[0.0, 0.0, 3.0], target=[0.0, 0.0, 0.0],
                          up=[0.0, -1.0, 0.0], fovx=math.pi / 3,
                          fovy=math.pi / 3, width=res, height=res,
                          device="cpu")


CFG = RasterConfig(max_instances=1 << 12)


def test_one_small_surfel_in_one_tile():
    """A surfel a few pixels wide near a tile's centre: one instance, one
    real row of 32 x 32 pairs, and a handful of pixels past the footprint
    test, each of which blends (nothing in front of it)."""
    params, alive = _scene([[-0.3, -0.3, 0.0]])
    wk = work.count_blend(params, alive, _camera(), CFG)
    assert wk["instances"] == 1 and wk["rows"] == 1
    assert wk["pairs"] == 32 * 32
    assert 0 < wk["ok"] < 64 and wk["gated"] == wk["ok"]


def test_two_surfels_in_two_tiles_and_one_outside():
    params, alive = _scene([[-0.3, -0.3, 0.0], [0.3, 0.3, 0.0],
                            [40.0, 0.0, 0.0]])
    wk = work.count_blend(params, alive, _camera(), CFG)
    assert wk["instances"] == 2 and wk["rows"] == 2
    assert wk["pairs"] == 2 * 32 * 32
    alone = work.count_blend(*_scene([[-0.3, -0.3, 0.0]]), _camera(), CFG)
    assert wk["ok"] == 2 * alone["ok"]


def test_dead_rows_count_nothing():
    params, alive = _scene([[-0.3, -0.3, 0.0], [0.3, 0.3, 0.0]])
    alive[1] = False
    wk = work.count_blend(params, alive, _camera(), CFG)
    assert wk["instances"] == 1 and wk["pairs"] == 32 * 32


def test_blend_bounds_by_hand():
    wk = {"rows": 10, "pairs": 10240, "ok": 100, "gated": 50}
    b = work.blend_bounds(wk, ca=14, cv=0, width=64, height=64, tile=32)
    fwd_ops = 10240 * 16 + 100 * 4 + 50 * (4 + 28)
    bwd_ops = 10240 * 16 + 100 * 36 + 50 * (7 + 56)
    assert b["ops"] == fwd_ops + bwd_ops
    rows_b = 4 * 10 * 26
    fwd_b = rows_b + 4 * 16 * 4096 + 12 * 4
    assert b["forward_s"] == pytest.approx(max(fwd_b / 3.35e12,
                                               fwd_ops / 67e12))
    bwd_b = 2 * rows_b + 4 * 16 * 4096 + 8 * 4
    assert b["backward_s"] == pytest.approx(max(bwd_b / 3.35e12,
                                                bwd_ops / 67e12))
    v = work.blend_bounds(wk, ca=13, cv=13, width=64, height=64, tile=32)
    assert v["ops"] == (10240 * 32 + 100 * 40 + 50 * (4 + 26 + 30 + 104)
                        + 50 * (7 + 52 + 84 + 221))


def test_env_bounds_by_hand():
    e = work.env_bounds(1000, 16, 32)
    nb = 4 * (2000 + 3000 + 16 * 32 * 3)
    assert e["ops"] == 1000 * (18 + 27) + 1000 * (18 + 30)
    assert e["forward_s"] == pytest.approx(max(nb / 3.35e12,
                                               1000 * 45 / 67e12))
    assert e["backward_s"] == pytest.approx(max(nb / 3.35e12,
                                                1000 * 48 / 67e12))


def test_step_counts_by_hand():
    assert work.adam_ops(10) == 140
    assert work.ssim_ops(100) == 3 * 100 * 240 * 3
    assert work.ssim_ops(100, 2) == 2 * work.ssim_ops(100)
    assert work.preprocess_ops(7) == 3 * 600 * 7
    assert work.shading_ops(2, 3) == 3 * 120 * 4 * 6
    assert work.consistency_ops(2, 3) == 3 * 60 * 4 * 6
