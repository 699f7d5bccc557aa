"""The port's scene-composition and small helper functions against
svgir_tpu on the CPU, on the same inputs from a numpy seed.

* ``quat_multiply``, ``build_cov3d`` (surface on and off) and
  ``cov3d_matrix``: within 1e-6 of the largest value (the covariance is a
  sum of three products, which XLA fuses into multiply-adds).
* ``apply_transform`` under a scaled, rotated and translated 4x4, on a
  stage-1 model ([N, 3] normals) and a stage-2 one ([N, 12] offsets):
  every parameter within 1e-5.
* ``concatenate_models`` of two models with dead rows: params and
  ``alive`` equal.
* ``knn`` with ``n_valid`` (indices equal, distances within 1e-5) and
  ``knn_regularization_loss`` (1e-6); ``sh_to_rgb``, ``normal2rgb`` and
  ``first_order_loss`` (1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.models import gaussians as JG
from svgir_tpu.ops.knn import knn as j_knn
from svgir_tpu.utils import image as JI
from svgir_tpu.utils import losses as JL
from svgir_tpu.utils import sh as JSH
from svgir_tpu.utils import transforms as JT

from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.ops.knn import knn as t_knn
from svgir_tpu_torch.utils import image as TI
from svgir_tpu_torch.utils import losses as TL
from svgir_tpu_torch.utils import sh as TSH
from svgir_tpu_torch.utils import transforms as TT


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops.  Under the parallel test run the CPU is
    oversubscribed, and an op split over torch's thread pool waits for
    descheduled threads (a stage-2 loop took 42 s on 8 threads against 6 s
    on one beside six busy processes); one thread for the module, its
    module-scoped fixtures included."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N, CAP = 40, 48


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _close_rel(got, want, tol):
    """Within ``tol`` of the largest magnitude of ``want``."""
    want = np.asarray(want)
    _close(got, want, tol * max(float(np.abs(want).max()), 1.0))


def test_quaternion_and_covariance_helpers():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(7, 4)).astype(np.float32)
    q2 = rng.normal(size=(7, 4)).astype(np.float32)
    _close(TT.quat_multiply(torch.tensor(q1), torch.tensor(q2)),
           JT.quat_multiply(jnp.asarray(q1), jnp.asarray(q2)), 1e-6)
    scale = np.exp(rng.normal(size=(7, 3))).astype(np.float32) * 0.3
    for surface in (True, False):
        want = JT.build_cov3d(jnp.asarray(scale), jnp.asarray(q1),
                              scale_modifier=1.5, surface=surface)
        got = TT.build_cov3d(torch.tensor(scale), torch.tensor(q1),
                             scale_modifier=1.5, surface=surface)
        _close_rel(got, want, 1e-6)
        _close_rel(TT.cov3d_matrix(got), JT.cov3d_matrix(want), 1e-6)
    # the surfel's covariance has no extent along its normal
    cov = TT.cov3d_matrix(TT.build_cov3d(torch.tensor(scale),
                                         torch.tensor(q1)))
    n = TT.quat_to_rotmat(torch.tensor(q1))[:, :, 2]
    assert float((cov @ n[..., None]).abs().max()) < 1e-6


def _state(rng, pbr):
    d = rng.normal(size=(CAP, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    st = TG.init_from_points(d, rng.random((CAP, 3)).astype(np.float32),
                             normals=d, capacity=CAP, rotation_init="normal",
                             device="cpu")
    if pbr:
        st = TG.upgrade_to_pbr(st)
    p = TG.params_to_numpy(st["params"])
    for k in p:
        p[k] = (p[k] + 0.1 * rng.normal(size=p[k].shape)).astype(np.float32)
    if pbr:
        p["radiances"] = rng.random((CAP, 4, 3)).astype(np.float32)
        p["radiance_ratio"] = np.float32(1.3)
    alive = np.arange(CAP) < N
    alive[[3, 17]] = False
    return p, alive


def _transform():
    a = 0.7
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    rot = rot @ np.array([[1, 0, 0], [0, np.cos(0.4), -np.sin(0.4)],
                          [0, np.sin(0.4), np.cos(0.4)]], np.float32)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = 0.8 * rot
    tf[:3, 3] = [2.5, -0.3, 0.7]
    return tf


@pytest.mark.parametrize("pbr", [False, True], ids=["normal_n3",
                                                    "normal_n12"])
def test_apply_transform_matches_jax(pbr):
    p, _ = _state(np.random.default_rng(1), pbr)
    tf = _transform()
    want = JG.apply_transform({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(tf))
    got = TG.apply_transform({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(tf))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-5)
    assert got["normal"].shape[-1] == (12 if pbr else 3)


def test_concatenate_models_matches_jax():
    rng = np.random.default_rng(2)
    (pa, aa), (pb, ab) = _state(rng, True), _state(rng, True)
    pb["radiance_ratio"] = np.float32(0.5)
    j_states = [{"params": {k: jnp.asarray(v) for k, v in p.items()},
                 "alive": jnp.asarray(a)} for p, a in ((pa, aa), (pb, ab))]
    t_states = [{"params": {k: torch.tensor(v) for k, v in p.items()},
                 "alive": torch.tensor(a)} for p, a in ((pa, aa), (pb, ab))]
    want = JG.concatenate_models(j_states)
    got = TG.concatenate_models(t_states)
    np.testing.assert_array_equal(got["alive"].numpy(),
                                  np.asarray(want["alive"]))
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(want["params"][k]),
                                      err_msg=k)
    assert set(got["stats"]) == set(want["stats"])
    assert got["alive"].shape[0] == 4096 and int(got["alive"].sum()) == \
        2 * (N - 2)


def test_knn_and_regularizer_match_jax():
    p, _ = _state(np.random.default_rng(3), True)
    pts = p["xyz"]
    for n_valid in (None, 30):
        jd, ji = j_knn(jnp.asarray(pts), k=5, n_valid=n_valid)
        td, ti = t_knn(torch.tensor(pts), k=5, n_valid=n_valid)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        _close(td, jd, 1e-5)
    alive = np.arange(CAP) < 30
    want = JG.knn_regularization_loss(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(alive), k=8)
    got = TG.knn_regularization_loss(
        {k: torch.tensor(v) for k, v in p.items()}, torch.tensor(alive), k=8)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


def test_small_helpers_match_jax():
    rng = np.random.default_rng(4)
    sh = rng.normal(size=(9, 16, 3)).astype(np.float32)
    _close(TSH.sh_to_rgb(torch.tensor(sh)), JSH.sh_to_rgb(jnp.asarray(sh)),
           1e-6)
    nrm = rng.normal(size=(3, 12, 10)).astype(np.float32)
    mask = (rng.random((1, 12, 10)) > 0.3).astype(np.float32)
    _close(TI.normal2rgb(torch.tensor(nrm), torch.tensor(mask)),
           JI.normal2rgb(jnp.asarray(nrm), jnp.asarray(mask)), 1e-6)
    img = rng.random((3, 12, 10)).astype(np.float32)
    _close(TL.first_order_loss(torch.tensor(img)),
           JL.first_order_loss(jnp.asarray(img)), 1e-6)
