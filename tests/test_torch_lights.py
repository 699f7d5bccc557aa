"""The port's lights against svgir_tpu.models.lights on the CPU.

* EnvLight (the fixed HDR light of relighting): ``env_light_init``'s
  lookup copy, ``env_light_direct`` and ``env_light_direct_qxy``, with and
  without a direction transform, from the same float array.
* The resize of ``jax.image.resize(..., "linear")`` (antialiased when it
  downsamples): a 1024 x 2048 map to 32 x 64 (factor 32), a non-integer
  factor, a map smaller than 32 x 64, within 2e-6 of the largest value
  (the contraction order differs); the 2x bilinear upsample of the
  DirectLightMap with its Adam moments likewise.
* The SG / SH / gamma lights with the JAX parameters carried across
  (1e-6 relative).
* ``load_hdr`` on a ``.hdr`` and a ``.png`` the test writes: the ``.hdr``
  against the written values within RGBE's precision (2^-7 of a pixel's
  largest channel; the JAX ``load_hdr`` reads ``.hdr`` through imageio,
  which clips it to 8 bits: ROADMAP hazard 10), the ``.png`` against JAX.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgir_tpu.models import lights as JL

from svgir_tpu_torch.models import lights as TL


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


RESIZE_TOL = 2e-6


def rand_dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def rotation(seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


@pytest.mark.parametrize("transform", [False, True],
                         ids=["fixed", "rotated"])
def test_env_light_matches_jax(transform):
    env = (4 * np.random.default_rng(0).random((64, 128, 3))) \
        .astype(np.float32)
    tr = rotation(1) if transform else None
    sj = JL.env_light_init(env, scale=1.5, transform=tr)
    st = TL.env_light_init(env, scale=1.5, transform=tr, device="cpu")
    np.testing.assert_array_equal(st["envmap"].numpy(),
                                  np.asarray(sj["envmap"]))
    np.testing.assert_allclose(st["lookup"].numpy(), np.asarray(sj["lookup"]),
                               atol=RESIZE_TOL * 6)
    dirs = rand_dirs(2000, 2)
    # the JAX state carried across: the lookups alone
    st = TL.env_light_from_jax(jax.device_get(sj), device="cpu")
    np.testing.assert_array_equal(st["lookup"].numpy(),
                                  np.asarray(sj["lookup"]))
    lj = np.asarray(JL.env_light_direct(sj, jnp.asarray(dirs)))
    lt = TL.env_light_direct(st, torch.as_tensor(dirs)).numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-5)
    if not transform:
        qx, qy = JL.equirect_grid_coords(jnp.asarray(dirs))
        qj = np.asarray(JL.env_light_direct_qxy(sj, qx, qy))
        qt = TL.env_light_direct_qxy(st, torch.as_tensor(np.array(qx)),
                                     torch.as_tensor(np.array(qy))).numpy()
        np.testing.assert_allclose(qt, qj, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(qt, lt, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1024, 2048), (100, 250), (16, 24)],
                         ids=["factor32", "non_integer", "smaller"])
def test_resize_matches_jax(shape):
    env = (4 * np.random.default_rng(3).random(shape + (3,))) \
        .astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(env), (32, 64, 3),
                                       "linear"))
    got = TL.env_light_init(env, device="cpu")["lookup"].numpy()
    assert got.shape == (32, 64, 3)
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL * 4)


def test_direct_light_map_upsample_matches_jax():
    sj = JL.direct_light_map_init(jax.random.PRNGKey(0), h=16)
    rng = np.random.default_rng(4)
    sj["opt"]["m"]["env"] = jnp.asarray(
        rng.standard_normal((16, 32, 3)).astype(np.float32))
    sj["opt"]["v"]["env"] = jnp.asarray(
        rng.random((16, 32, 3)).astype(np.float32))
    sj["opt"]["step"] = 7
    st = TL.env_state_from_jax(jax.device_get(sj), device="cpu")
    uj = JL.direct_light_map_upsample(sj)
    ut = TL.direct_light_map_upsample(st)
    assert ut["opt"]["step"] == 7
    for got, want in ((ut["params"]["env"], uj["params"]["env"]),
                      (ut["opt"]["m"]["env"], uj["opt"]["m"]["env"]),
                      (ut["opt"]["v"]["env"], uj["opt"]["v"]["env"])):
        assert got.shape == (32, 64, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=RESIZE_TOL * 4)


def test_sg_sh_gamma_lights_match_jax():
    dirs = rand_dirs(500, 5)
    sg = jax.device_get(JL.direct_light_sg_init(jax.random.PRNGKey(1)))
    tsg = TL.params_from_jax(sg["params"], device="cpu")
    np.testing.assert_allclose(
        TL.direct_light_sg(tsg, torch.as_tensor(dirs)).numpy(),
        np.asarray(JL.direct_light_sg(sg["params"], jnp.asarray(dirs))),
        rtol=1e-6, atol=1e-6)
    sh = jax.device_get(JL.direct_light_sh_init(jax.random.PRNGKey(2)))
    tsh = TL.params_from_jax(sh["params"], device="cpu")
    out = TL.direct_light_sh(tsh, torch.as_tensor(dirs)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(JL.direct_light_sh(sh["params"], jnp.asarray(dirs))),
        rtol=1e-6, atol=1e-6)
    assert (out == 0).any() and (out > 0).any()
    img = np.random.default_rng(6).random((3, 8, 8)).astype(np.float32)
    img[0, 0, 0] = 0.0                       # clamped at 1e-8
    g = {"gamma": np.array([0.7], np.float32)}
    for params in (None, g):
        np.testing.assert_allclose(
            TL.gamma_correct(torch.as_tensor(img), None if params is None
                             else TL.params_from_jax(params, "cpu")).numpy(),
            np.asarray(JL.gamma_correct(jnp.asarray(img), params)),
            rtol=1e-6, atol=1e-7)
    # the port's inits draw from a generator: shapes and ranges
    gen = torch.Generator().manual_seed(0)
    p = TL.direct_light_sg_init(16, generator=gen, device="cpu")["params"]
    assert p["sg_axis"].shape == (16, 3) and torch.allclose(
        torch.linalg.norm(p["sg_axis"], dim=-1), torch.ones(16))
    assert 0 <= float(p["sg_sharpness"].min()) and \
        float(p["sg_sharpness"].max()) < 2
    s = TL.direct_light_sh_init(3, generator=gen, device="cpu")
    assert s["params"]["sh"].shape == (3, 16) and s["deg"] == 3


@pytest.mark.parametrize("ext", [".hdr", ".png"])
def test_load_hdr_reads_what_was_written(tmp_path, ext):
    import cv2
    rng = np.random.default_rng(7)
    path = os.path.join(tmp_path, "light" + ext)
    if ext == ".hdr":
        rgb = (4 * rng.random((16, 32, 3))).astype(np.float32)
        assert cv2.imwrite(path, rgb[..., ::-1].copy())
        got = TL.load_hdr(path)
        assert got.dtype == np.float32 and got.shape == (16, 32, 3)
        tol = rgb.max(-1, keepdims=True) * 2.0 ** -7
        assert (np.abs(got - rgb) <= tol).all(), np.abs(got - rgb).max()
    else:
        rgb8 = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
        assert cv2.imwrite(path, rgb8[..., ::-1].copy())
        got = TL.load_hdr(path)
        np.testing.assert_allclose(got, JL.load_hdr(path), rtol=1e-6,
                                   atol=1e-7)
        assert got.max() <= 1.0 and got.min() >= 0.0
