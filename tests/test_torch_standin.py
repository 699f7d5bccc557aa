"""The pieces of the port's stand-in harness (``eval/standin.py``) against
svgir_tpu's on the CPU, with JAX's random draws passed to the port, and
the port's profiling helpers on the CPU.

* ``make_gt_model`` (150 surfels): every parameter within 1e-5, ``alive``
  equal; ``make_env``: the map and its lookup copy within 1e-5;
  ``ring_cameras``: the matrices within 1e-6.
* ``render_gt_views`` on two 24 x 24 views at S = 4 with the bake's
  spiral draws of JAX's key: the pbr images within 2e-4
  (tests/test_torch_svgss.py's eval tolerance), the masks equal.
* ``run_standin_parity`` itself runs on the card (``chip_smoke.py``
  phase 31); here a few iterations of it run end to end with finite
  numbers.
* ``utils/profiling``: ``trace`` writes its Chrome trace with the
  spans in it, and the span registry records only inside it.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.eval import standin as JS

from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.eval import standin as TS
from svgir_tpu_torch.utils import profiling as P

N_GT, RES, S = 150, 24, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.fixture(scope="module")
def gt():
    """Both packages' GT model and env from one JAX key, the port given
    JAX's draws."""
    key = jax.random.PRNGKey(3)
    k_model, k_env = jax.random.split(key)
    j_state = JS.make_gt_model(k_model, n=N_GT)
    j_env = JS.make_env(k_env, bright=2.5)
    dirs = jax.random.normal(jax.random.split(k_model, 4)[0], (N_GT, 3))
    k1, k2 = jax.random.split(k_env)
    t_state = TS.make_gt_model(n=N_GT, dirs_draw=_np(dirs), device="cpu")
    t_env = TS.make_env(bright=2.5, base_draw=_np(jax.random.uniform(
        k1, (4, 8, 3))), az_draw=_np(jax.random.uniform(k2, ())),
        device="cpu")
    return j_state, j_env, t_state, t_env


def test_gt_model_and_env_match_jax(gt):
    j_state, j_env, t_state, t_env = gt
    np.testing.assert_array_equal(t_state["alive"].numpy(),
                                  _np(j_state["alive"]))
    assert set(t_state["params"]) == set(j_state["params"])
    for k, v in j_state["params"].items():
        np.testing.assert_allclose(t_state["params"][k].numpy(), _np(v),
                                   atol=1e-5, rtol=0, err_msg=k)
    for k in ("envmap", "lookup"):
        np.testing.assert_allclose(t_env[k].numpy(), _np(j_env[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert t_env["transform"] is None and j_env["transform"] is None


def test_ring_cameras_match_jax():
    for jc, tc in zip(JS.ring_cameras(5, RES), TS.ring_cameras(5, RES,
                                                              device="cpu")):
        for k in ("world_view", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(tc, k).numpy(),
                                       _np(getattr(jc, k)), atol=1e-6)
        assert (tc.width, tc.height, tc.fovx) == (jc.width, jc.height,
                                                  jc.fovx)


def test_render_gt_views_match_jax(gt):
    j_state, j_env, t_state, t_env = gt
    key = jax.random.PRNGKey(7)
    az = _np(jax.random.uniform(key, (N_GT, 1)))
    want = JS.render_gt_views(j_state, j_env, JS.ring_cameras(2, RES),
                              sample_num=S, cfg=JCfg(max_instances=1 << 12),
                              key=key)
    got = TS.render_gt_views(t_state, t_env,
                             TS.ring_cameras(2, RES, device="cpu"),
                             sample_num=S, cfg=TCfg(max_instances=1 << 12),
                             azimuth=torch.tensor(az))
    for jc, tc in zip(want, got):
        assert float(tc.image_mask.mean()) > 0.03
        np.testing.assert_array_equal(tc.image_mask.numpy(),
                                      _np(jc.image_mask))
        np.testing.assert_allclose(tc.image.numpy(), _np(jc.image),
                                   atol=2e-4, rtol=0)


def test_run_standin_parity_runs_end_to_end():
    out = TS.run_standin_parity(
        n_gt=60, n_views=3, res=16, sample_num=4, stage1_iters=6,
        stage2_iters=3, init_points=40, capacity=128,
        cfg=TCfg(max_instances=1 << 12), verbose=False, device="cpu")
    assert set(out) == {"n_alive_after_stage1", "stage1_nvs_psnr",
                        "stage2_pbr_psnr", "relight_psnr", "albedo_psnr"}
    assert all(np.isfinite(v) for v in out.values()), out


def test_profiling_on_the_cpu(tmp_path):
    P.reset()
    with P.span(P.STEP), P.span("svgir.outside"):
        torch.ones(8).sum()
    assert P.summary()["spans"] == {}
    with P.trace(str(tmp_path / "prof")) as prof:
        with P.span(P.STEP):
            with P.span("svgir.matmul"):
                torch.ones(32, 32) @ torch.ones(32, 32)
            P.count("host_syncs", 2)
    assert prof.key_averages()
    assert {"svgir.step", "svgir.matmul"} <= {e.name for e in prof.events()}
    s = P.summary()
    assert s["steps"] == 1 and set(s["spans"]) == {"svgir.step",
                                                    "svgir.matmul"}
    assert s["spans"]["svgir.matmul"]["host_ms"] > 0
    assert s["spans"]["svgir.matmul"]["device_ms"] is None
    assert s["counters"]["host_syncs"] == {
        "total": 2, "in_steps": 2, "by_span": {"svgir.step": 2}}
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"svgir.step", "svgir.matmul"} <= names
    P.reset()
    assert os.path.exists(tmp_path / "prof" / "trace.json")
