"""The port's relighting evaluation against svgir_tpu on the CPU.

A tiny PBR scene (60 alive surfels in a capacity of 64 on a sphere of
radius 0.1, facing inward so that hemisphere rays meet the far side
within the march's first 0.2 window; parameters from a numpy seed) goes
to both packages.

* ``irradiance_full`` at S = 8 on the reference's own bake (hits present),
  at the default chunking and at 7 pairs a chunk: within 1e-5 of the
  largest value.
* ``eval_relighting`` end to end: the brute bake, two 64 x 64 views, a
  16 x 32 light, the albedo calibration on a synthetic GT albedo, LPIPS
  from random weights.  The re-baked radiances (alive rows) within 1e-5
  relative; ``metrics.json`` with the same keys, PSNRs within 1e-3 dB,
  SSIM and LPIPS within 1e-4, MSEs within 1e-4 relative; the written
  pbr and base-colour PNGs within one 8-bit level.
* The re-bake on a denser, fainter shell where more than 1% of the rays
  use up their 16-hit list: the reference bakes once at k 16 and keeps
  the truncated rays; the port's visibility, bake radiance and
  radiances (alive rows) match it within 1e-5 of the largest value, hit
  indices exactly, uv within 1e-6 of float64 (JAX's within 3e-5).
* The metric functions against ``svgir_tpu.eval.metrics``.
"""

import dataclasses
import json
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.cameras import look_at_camera as j_look_at
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.eval import metrics as JM
from svgir_tpu.eval.relighting import eval_relighting as j_eval_relighting
from svgir_tpu.eval.relighting import rebake_radiance_for_light as j_rebake
from svgir_tpu.models import gaussians as JG
from svgir_tpu.models import lights as JLT
from svgir_tpu.models import radiance as JRAD

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.eval import metrics as TM
from svgir_tpu_torch.eval.relighting import eval_relighting as t_eval_relighting
from svgir_tpu_torch.eval.relighting import rebake_radiance_for_light as t_rebake
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.models import lights as TLT
from svgir_tpu_torch.models import radiance as TRAD
from svgir_tpu_torch.ops import tracing as TTR

from test_lpips import random_weights

N, CAP, S, RES = 60, 64, 8, 64


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(params as numpy, alive, env [16, 32, 3], two views' images and
    normals, GT albedo) from a numpy seed."""
    rng = np.random.default_rng(21)
    dirs = rng.standard_normal((CAP, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    state = TG.upgrade_to_pbr(TG.init_from_points(
        dirs * 0.1, rng.random((CAP, 3)).astype(np.float32),
        normals=-dirs, capacity=CAP, rotation_init="normal", device="cpu"))
    p = TG.params_to_numpy(state["params"])
    p["scaling"] = np.full((CAP, 3), np.log(0.03), np.float32)
    p["opacity"] = (rng.normal(size=(CAP, 1)) + 1.5).astype(np.float32)
    p["base_color"] = (0.5 * rng.normal(size=(CAP, 12))).astype(np.float32)
    p["roughness"] = (0.5 * rng.normal(size=(CAP, 4))).astype(np.float32)
    p["normal"] = (0.1 * rng.normal(size=(CAP, 12))).astype(np.float32)
    alive = np.arange(CAP) < N
    env = (np.abs(rng.normal(size=(16, 32, 3))) + 0.1).astype(np.float32)
    views = []
    for i in range(2):
        nrm = rng.normal(size=(3, RES, RES)).astype(np.float32)
        views.append((rng.random((3, RES, RES)).astype(np.float32),
                      nrm / np.linalg.norm(nrm, axis=0, keepdims=True)))
    albedo = (0.3 + 0.4 * rng.random((3, RES, RES))).astype(np.float32)
    mask = (rng.random((1, RES, RES)) > 0.2).astype(np.float32)
    return p, alive, env, views, (albedo, mask)


def eyes():
    return [[0.45 * math.sin(a), 0.07, -0.45 * math.cos(a)]
            for a in (0.0, 1.3)]


def test_irradiance_full_matches_jax(scene, monkeypatch):
    p, alive, env, _, _ = scene
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    bake = JRAD.bake_radiance(
        jp["xyz"], JG.get_scaling(jp), JG.get_rotation(jp),
        JG.get_opacity(jp)[:, 0], JG.get_shs(jp), sample_num=S,
        valid=jnp.asarray(alive), use_grid=False)
    hits = np.asarray(bake["hit_idx"]) >= 0
    assert 0.2 < hits.mean() < 0.95, hits.mean()
    js = JLT.env_light_init(env)
    env_term = JLT.env_light_direct(js, bake["incident_dirs"]) \
        * bake["incident_areas"]
    albedo = JG.get_base_color(jp).reshape(CAP, 3, 4).transpose(0, 2, 1)
    args = (JG.get_shading_normal(jp), albedo, JG.get_roughness(jp)[:, 0])
    want = np.asarray(JRAD.irradiance_full(bake, env_term, *args))
    tb = {k: torch.as_tensor(np.array(v)) for k, v in bake.items()}
    targs = [torch.as_tensor(np.array(a)) for a in (env_term,) + args]
    scale = np.abs(want).max()
    assert scale > 0 and (want[~hits] == 0).all()
    for budget in (TRAD.IRRADIANCE_BUDGET, 4 * (9 * S + 25 + 96 * S) * 7):
        monkeypatch.setattr(TRAD, "IRRADIANCE_BUDGET", budget)
        got = TRAD.irradiance_full(tb, *targs).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * scale)
        assert (got[~hits] == 0).all()


@pytest.fixture(scope="module")
def relit(scene, tmp_path_factory):
    """eval_relighting in both packages on the same scene, light and views;
    (JAX summary, port summary, JAX dir, port dir, JAX and port radiances
    of the re-bake)."""
    p, alive, env, views, (albedo, mask) = scene
    tmp = tmp_path_factory.mktemp("relight")
    weights = os.path.join(tmp, "lpips_vgg.npz")
    np.savez(weights, **random_weights(4))
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")

    kw = dict(fovx=math.pi / 3, fovy=math.pi / 3, width=RES, height=RES)
    jcams = [j_look_at(eye=e, target=[0, 0, 0], up=[0, -1, 0], **kw)
             for e in eyes()]
    jcams = [dataclasses.replace(c, image=jnp.asarray(img),
                                 image_mask=jnp.asarray(mask),
                                 normal=jnp.asarray(nrm))
             for c, (img, nrm) in zip(jcams, views)]
    tcams = [t_look_at(eye=e, target=[0, 0, 0], up=[0, -1, 0], image=img,
                       image_mask=mask, normal=nrm, device="cpu", **kw)
             for e, (img, nrm) in zip(eyes(), views)]

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = JLT.env_light_init(env)
    jsum = j_eval_relighting(
        jdir, jp, jnp.asarray(alive), js, jcams, sample_num=S,
        raster_cfg=JCfg(max_instances=1 << 14),
        gt_albedo_fn=lambda i: (jnp.asarray(albedo), jnp.asarray(mask)),
        lpips_weights=weights)
    _, jrad = jax.device_get(j_rebake(jp, jnp.asarray(alive), js,
                                      sample_num=S))

    tp = TG.params_from_jax(p, device="cpu")
    ts = TLT.env_light_from_jax(jax.device_get(js), device="cpu")
    tsum = t_eval_relighting(
        tdir, tp, torch.as_tensor(alive), ts, tcams, sample_num=S,
        raster_cfg=TCfg(max_instances=1 << 14),
        gt_albedo_fn=lambda i: (albedo, mask), lpips_weights=weights)
    _, trad = t_rebake(tp, torch.as_tensor(alive), ts, sample_num=S)
    return jsum, tsum, jdir, tdir, np.asarray(jrad), trad.numpy()


def test_eval_relighting_matches_jax(relit):
    jsum, tsum, jdir, tdir, jrad, trad = relit
    scale = np.abs(jrad[:N]).max()
    assert scale > 0
    np.testing.assert_allclose(trad[:N], jrad[:N], atol=1e-5 * scale)
    assert sorted(tsum) == sorted(jsum)
    assert tsum["n_views"] == jsum["n_views"] == 2
    for k, v in jsum.items():
        if k == "n_views":
            continue
        tol = 1e-3 if k.endswith("psnr") else (
            1e-4 * abs(v) if k.endswith("mse") else 1e-4)
        assert abs(tsum[k] - v) <= tol, (k, tsum[k], v)
    with open(os.path.join(tdir, "env", "metrics.json")) as f:
        assert json.load(f) == tsum
    for idx in range(2):
        for key in ("pbr", "base_color", "visibility", "local_lights"):
            f = f"{idx:05d}_{key}.png"
            a = cv2.imread(os.path.join(jdir, "env", f)).astype(int)
            b = cv2.imread(os.path.join(tdir, "env", f)).astype(int)
            assert np.abs(a - b).max() <= 1, (f, np.abs(a - b).max())
            if key == "pbr":
                assert a.std() > 1


def test_rebake_matches_jax_when_rays_exhaust():
    n, cap = 120, 128
    rng = np.random.default_rng(5)
    dirs = rng.standard_normal((cap, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    state = TG.upgrade_to_pbr(TG.init_from_points(
        dirs * 0.1, rng.random((cap, 3)).astype(np.float32),
        normals=-dirs, capacity=cap, rotation_init="normal", device="cpu"))
    p = TG.params_to_numpy(state["params"])
    p["scaling"] = np.full((cap, 3), np.log(0.03), np.float32)
    p["opacity"] = (0.3 * rng.normal(size=(cap, 1)) - 3.0).astype(np.float32)
    p["base_color"] = (0.5 * rng.normal(size=(cap, 12))).astype(np.float32)
    p["roughness"] = (0.5 * rng.normal(size=(cap, 4))).astype(np.float32)
    alive = np.arange(cap) < n
    env = (np.abs(rng.normal(size=(16, 32, 3))) + 0.1).astype(np.float32)

    js = JLT.env_light_init(env)
    jbake, jrad = jax.device_get(j_rebake(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), js,
        sample_num=S))
    tp = TG.params_from_jax(p, device="cpu")
    tbake, trad = t_rebake(tp, torch.as_tensor(alive),
                           TLT.env_light_from_jax(js, device="cpu"),
                           sample_num=S)
    assert float(jbake["exhausted_frac"]) > 0.01
    assert float(tbake["exhausted_frac"]) > 0.01       # the k = 16 pass
    hit = tbake["hit_idx"][:n]
    np.testing.assert_array_equal(hit.numpy(),
                                  np.asarray(jbake["hit_idx"])[:n])
    for key in ("visibility", "radiance"):
        want = np.asarray(jbake[key])[:n]
        np.testing.assert_allclose(tbake[key][:n].numpy(), want,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=key)
    # uv: the port within 1e-6 of a float64 evaluation of the same hits;
    # JAX's float32 plane hit (XLA fuses multiply-adds) lies up to 1.9e-5
    # from it here, so JAX is held to 3e-5
    g64 = TTR.build_surfel_geometry(
        tp["xyz"].double(), TG.get_scaling(tp).double(),
        TG.get_rotation(tp).double(), TG.get_opacity(tp)[:, 0].double())
    r, c = torch.nonzero(hit >= 0, as_tuple=True)
    h = hit[r, c].long()
    out = TTR.surfel_test(
        *(f[h][:, None] for f in (g64.means, g64.normal, g64.rot, g64.scales,
                                  g64.inv_cov, g64.opacity)),
        tp["xyz"][r].double()[:, None],
        tbake["incident_dirs"][r, c].double()[:, None])
    uv64 = TTR.swapped_uv(out[5], out[6])[:, 0].numpy()
    np.testing.assert_allclose(tbake["uv"][r, c].numpy(), uv64, atol=1e-6)
    np.testing.assert_allclose(tbake["uv"][:n].numpy(),
                               np.asarray(jbake["uv"])[:n], atol=3e-5)
    scale = np.abs(jrad[:n]).max()
    assert scale > 0
    np.testing.assert_allclose(trad[:n].numpy(), jrad[:n], atol=1e-5 * scale)


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.random((3, 24, 24)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1) \
        .astype(np.float32)
    for f in ("psnr", "ssim", "mse"):
        assert abs(getattr(TM, f)(torch.as_tensor(a), b)
                   - getattr(JM, f)(a, b)) < 1e-5, f
    assert TM.image_metrics(a, b).keys() == JM.image_metrics(a, b).keys()
    n1 = rng.standard_normal((3, 8, 8)).astype(np.float32)
    n2 = rng.standard_normal((3, 8, 8)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=0)
    n2 /= np.linalg.norm(n2, axis=0)
    m = (rng.random((1, 8, 8)) > 0.5).astype(np.float32)
    for mask in (None, m):
        assert abs(TM.normal_mae_deg(n1, n2, mask)
                   - JM.normal_mae_deg(n1, n2, mask)) < 1e-4
    # LPIPS: the resolution order, and a loud note when there is no file
    missing = str(tmp_path / "none.npz")
    ok, note = TM.lpips_status(missing)
    assert not ok and missing in note and TM.lpips(a, b, missing) is None
    assert TM.lpips_status(missing) == JM.lpips_status(missing)
    assert TM.lpips_weights_path("x.npz") == "x.npz"
