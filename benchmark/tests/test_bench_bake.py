"""The benchmark's stage-2 bake is laid out as the program's compact bake
(``trainer.bake_radiance_compact``) lays out its own, on a tiny scene:
every row's incident directions, equirect coordinates and areas, the dead
rows' fill (direction 0, hit -1, visibility 1, area 2 pi, radiance and uv
0), and on the alive rows what a miss and a hit hold."""

import math

import torch

from benchlib import load_cell, scene
from svgir_tpu_torch.train.trainer import bake_radiance_compact


def test_bake_matches_the_compact_layout(tiny_root):
    cell = load_cell("syn4_512.s2_sphere_bake", tiny_root)
    cfg, traffic = cell["config"], cell["traffic"]
    seed, dev = 21, torch.device("cpu")
    sur = scene.make_surfels(cfg, seed, dev)
    ours = scene.make_bake(cfg, traffic, sur, seed, dev)
    alive = sur["alive"]
    n = int(alive.sum())
    azimuth = torch.rand(n, 1, generator=scene.generator(seed, 3, dev))
    theirs = bake_radiance_compact(sur["params"], alive,
                                   sample_num=cfg["sample_num"],
                                   azimuth=azimuth)
    s = cfg["sample_num"]
    for key in ("radiance", "visibility", "incident_dirs", "incident_areas",
                "incident_qxy", "hit_idx", "uv"):
        assert ours[key].shape == theirs[key].shape, key
        assert ours[key].dtype == theirs[key].dtype, key
    assert ours["incident_dirs"].shape == (cfg["rows"], s, 3)
    torch.testing.assert_close(ours["incident_dirs"],
                               theirs["incident_dirs"], atol=1e-4, rtol=0)
    torch.testing.assert_close(ours["incident_areas"],
                               theirs["incident_areas"])

    dead = ~alive
    assert int(dead.sum()) == cfg["rows"] - cfg["alive"]
    for b in (ours, theirs):
        assert (b["incident_dirs"][dead] == 0).all()
        assert (b["incident_areas"][dead] == 2 * math.pi).all()
        assert (b["hit_idx"][dead] == -1).all()
        assert (b["visibility"][dead] == 1).all()
        assert (b["radiance"][dead] == 0).all()
        assert (b["uv"][dead] == 0).all()
        # every dead row's queries fall on one equirect texel
        q = b["incident_qxy"][dead].reshape(-1, 2)
        assert (q == q[0]).all()
    torch.testing.assert_close(ours["incident_qxy"][dead],
                               theirs["incident_qxy"][dead], atol=0, rtol=0)

    for b in (ours, theirs):
        hit = b["hit_idx"][alive]
        vis = b["visibility"][alive][..., 0]
        miss = hit < 0
        assert (vis[miss] == 1).all()
        assert (b["radiance"][alive][miss] == 0).all()
        assert (b["uv"][alive][miss] == 0).all()
        assert alive[hit[~miss].long()].all()      # hits land on alive rows
        v = vis[~miss]
        assert ((v == 0) | ((v >= 0.2) & (v <= 1))).all()
    miss = ours["hit_idx"][alive] < 0
    bc = traffic["bake"]
    assert abs(float(miss.float().mean()) - bc["alive_miss_share"]) < 0.01
    a = bc["alive_rows_all_miss_share"]
    ray = (bc["alive_miss_share"] - a) / (1 - a)
    assert abs(float(miss.all(1).float().mean())
               - (a + (1 - a) * ray ** cfg["sample_num"])) < 0.02
