"""The port's debug SH ray tracer (``eval/render_sh.render_sh_image``) on
the CPU.

* The brute tracer against svgir_tpu's at 32 x 32 on
  tests/test_render_sh.py's sphere (160 surfels with all three scales
  non-zero: the hit test is well conditioned, ROADMAP hazard 1): ``hit``
  equal, ``render`` and ``visibility`` within 1e-5, ``t`` within 1e-5
  where finite and infinite where JAX's is; the background on misses.
* The port's grid tracer (its march the plain version of B8) against its
  own brute tracer, rays padded into several chunks: ``hit`` equal,
  ``render`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.eval.render_sh import render_sh_image as j_render_sh
from svgir_tpu.utils.sh import rgb_to_sh

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.eval.render_sh import render_sh_image as t_render_sh

from tests.scenes import default_camera, sphere_scene

RES = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    sc = jax.device_get(sphere_scene(jax.random.PRNGKey(0), n=160,
                                     opacity_range=(0.85, 0.95)))
    # degree-0 SH carrying the scene colours: eval_sh + 0.5 == colours
    shs = np.zeros((160, 16, 3), np.float32)
    shs[:, 0] = np.asarray(rgb_to_sh(jnp.asarray(sc["colors"])))
    args = [np.asarray(sc[k], np.float32)
            for k in ("means", "scales", "quats", "opacity")] + [shs]
    return args


def _port_camera():
    cam = default_camera(RES, RES)
    return t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                     fovx=cam.fovx, fovy=cam.fovy, width=RES, height=RES,
                     device="cpu")


def test_brute_matches_jax(scene):
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    want = j_render_sh(*[jnp.asarray(a) for a in scene],
                       default_camera(RES, RES), use_grid=False,
                       ray_chunk=1024, bg=jnp.asarray(bg))
    got = t_render_sh(*[torch.tensor(a) for a in scene], _port_camera(),
                      use_grid=False, ray_chunk=1024, bg=torch.tensor(bg))
    hit = np.asarray(want["hit"])
    assert 0.1 < (hit >= 0).mean() < 0.9
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    for k in ("render", "visibility"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    t_j, t_t = np.asarray(want["t"]), got["t"].numpy()
    np.testing.assert_array_equal(np.isinf(t_t), np.isinf(t_j))
    fin = np.isfinite(t_j)
    np.testing.assert_allclose(t_t[fin], t_j[fin], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["render"].numpy()[:, hit < 0],
                                  np.repeat(bg[:, None], (hit < 0).sum(), 1))


def test_grid_matches_its_brute(scene):
    args = [torch.tensor(a) for a in scene]
    brute = t_render_sh(*args, _port_camera(), use_grid=False,
                        ray_chunk=384)
    grid = t_render_sh(*args, _port_camera(), use_grid=True, ray_chunk=384)
    assert bool((brute["hit"] >= 0).any())
    assert torch.equal(grid["hit"], brute["hit"])
    np.testing.assert_allclose(grid["render"].numpy(),
                               brute["render"].numpy(), atol=1e-5, rtol=0)
