"""Kernel B7 (the env-map lookup) of svgir_tpu_torch against svgir_tpu: the
plain PyTorch version of the forward and of the env gradient against the
Pallas kernel run in interpret mode (``bilinear_lookup_pallas``) and the
XLA formulation (``lights._bilinear_lookup``), plus the wrapper's checks.

M = 20,000 queries span two 16,384-query blocks of the Pallas kernel; the
coordinates include exactly 0, exactly W-1 / H-1 and points outside the
range on both sides.  Tolerances (float32 on the CPU in both packages):
forward 1e-6 absolute (env values below 3, a few ulp); d_env 1e-5 of its
largest magnitude (the sums over the queries run in another order).
``direct_light`` from directions: 2e-5 absolute.  The two libraries'
arccos differ by an ulp (2.4e-7 in the grid coordinate, 3.7e-6 of a pixel
at H = 32), which the env's slope (a few units per pixel) and the factor
2 turn into up to 1e-5 (measured); from the grid coordinates, 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.models import lights as JLT
from svgir_tpu.ops.env_lookup_pallas import bilinear_lookup_pallas

from svgir_tpu_torch import kernels
from svgir_tpu_torch.kernels import env_lookup as K
from svgir_tpu_torch.models import lights as TLT
from svgir_tpu_torch.ops import env_lookup_pallas as P

from tests.torch_kernel_inputs import env_lookup_inputs

M = 20_000
SHAPES = [(16, 32, 3), (32, 64, 3)]


def _inputs(h, w, c, seed=0):
    return env_lookup_inputs(h, w, c, M, seed)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def case(request):
    h, w, c = request.param
    env, u, v, g = _inputs(h, w, c)
    out_p = np.asarray(bilinear_lookup_pallas(jnp.asarray(env), u, v, True))
    denv_p = np.asarray(jax.grad(
        lambda e: jnp.sum(bilinear_lookup_pallas(e, u, v, True) * g))(
            jnp.asarray(env)))
    out_x = np.asarray(JLT._bilinear_lookup(jnp.asarray(env), u, v))
    denv_x = np.asarray(jax.grad(
        lambda e: jnp.sum(JLT._bilinear_lookup(e, u, v) * g))(
            jnp.asarray(env)))
    return dict(env=env, u=u, v=v, g=g, out_p=out_p, denv_p=denv_p,
                out_x=out_x, denv_x=denv_x)


def _rel(a, b, tol):
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol)


def test_plain_forward_matches_pallas_and_xla(case):
    out = P.env_lookup_forward_plain(_t(case["env"]), _t(case["u"]),
                                     _t(case["v"])).numpy()
    np.testing.assert_allclose(out, case["out_p"], atol=1e-6)
    np.testing.assert_allclose(out, case["out_x"], atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("m", [37, 1_027, 20_003])
def test_plain_forward_matches_pallas_and_xla_at_edges(shape, m):
    """M smaller than one block of the CUDA forward (512 threads x 4
    queries), M not a multiple of 4, and a ragged second block of the
    Pallas kernel; coordinates at exactly 0, W-1 and H-1, below 0 and past
    the edge."""
    env, u, v, _ = env_lookup_inputs(*shape, m=m, seed=m)
    h, w, _ = shape
    assert (u == 0).any() and (u == w - 1).any() and (v == h - 1).any()
    assert (u < 0).any() and (u > w - 1).any() and (v < 0).any() and \
        (v > h - 1).any()
    out = P.env_lookup_forward_plain(_t(env), _t(u), _t(v)).numpy()
    out_p = np.asarray(bilinear_lookup_pallas(jnp.asarray(env), u, v, True))
    out_x = np.asarray(JLT._bilinear_lookup(jnp.asarray(env), u, v))
    assert out.shape == (m, shape[2])
    np.testing.assert_allclose(out, out_p, atol=1e-6)
    np.testing.assert_allclose(out, out_x, atol=1e-6)


def test_plain_backward_matches_pallas_and_xla(case):
    h, w, _ = case["env"].shape
    d = P.env_lookup_backward_plain(_t(case["u"]), _t(case["v"]),
                                    _t(case["g"]), h=h, w=w).numpy()
    _rel(d, case["denv_p"], 1e-5)
    _rel(d, case["denv_x"], 1e-5)


def test_plain_matches_pallas_on_an_env_past_shared_memory():
    """A 128 x 256 x 3 env (the reference's default H = 128; 393,216 bytes,
    past a block's shared memory, so the CUDA kernels read it in place and
    add the gradient with atomics): the plain forward and backward against
    the Pallas kernel, at the tolerances above."""
    env, u, v, g = _inputs(128, 256, 3)
    assert env.nbytes > 232_448
    out = P.env_lookup_forward_plain(_t(env), _t(u), _t(v)).numpy()
    out_p = np.asarray(bilinear_lookup_pallas(jnp.asarray(env), u, v, True))
    np.testing.assert_allclose(out, out_p, atol=1e-6)
    d = P.env_lookup_backward_plain(_t(u), _t(v), _t(g), h=128,
                                    w=256).numpy()
    denv_p = np.asarray(jax.grad(
        lambda e: jnp.sum(bilinear_lookup_pallas(e, u, v, True) * g))(
            jnp.asarray(env)))
    _rel(d, denv_p, 1e-5)


def test_autograd_reaches_the_env_only(case):
    env = _t(case["env"]).requires_grad_(True)
    u = _t(case["u"]).requires_grad_(True)
    v = _t(case["v"]).requires_grad_(True)
    kernels.reset_launches()
    out = TLT._bilinear_lookup(env, u, v)
    d_env, d_u, d_v = torch.autograd.grad((out * _t(case["g"])).sum(),
                                          [env, u, v], allow_unused=True)
    assert d_u is None and d_v is None
    np.testing.assert_allclose(out.detach().numpy(), case["out_p"], atol=1e-6)
    _rel(d_env.numpy(), case["denv_p"], 1e-5)
    assert kernels.launches()["env_lookup_forward"] == 0      # CPU: plain


def test_lookup_keeps_the_query_shape():
    env, u, v, _ = _inputs(16, 32, 3)
    out = TLT._bilinear_lookup(_t(env), _t(u).reshape(100, 200),
                               _t(v).reshape(100, 200))
    flat = P.env_lookup_forward_plain(_t(env), _t(u), _t(v))
    assert out.shape == (100, 200, 3)
    assert torch.equal(out.reshape(-1, 3), flat)


@pytest.mark.parametrize("h,w", [(16, 32), (32, 64)])
def test_direct_light_matches(h, w):
    """softplus x 2 lookup at unit directions, by direction and by the
    precomputed grid coordinates."""
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(h, w, 3)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs[0] = [0.0, 0.0, 1.0]
    dirs[1] = [0.0, 0.0, -1.0]
    jq = [np.asarray(x) for x in JLT.equirect_grid_coords(jnp.asarray(dirs))]
    tq = [x.numpy() for x in TLT.equirect_grid_coords(_t(dirs))]
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jp = {"env": jnp.asarray(raw)}
    tp = {"env": _t(raw)}
    np.testing.assert_allclose(TLT.direct_light(tp, _t(dirs)).numpy(),
                               np.asarray(JLT.direct_light(jp, dirs)),
                               atol=2e-5)
    np.testing.assert_allclose(
        TLT.direct_light_qxy(tp, _t(jq[0]), _t(jq[1])).numpy(),
        np.asarray(JLT.direct_light_qxy(jp, jq[0], jq[1])), atol=1e-6)
    np.testing.assert_allclose(TLT.env_activated(tp).numpy(),
                               np.asarray(JLT.env_activated(jp)), atol=1e-6)


def test_env_state_carries_across_and_steps_like_jax():
    rng = np.random.default_rng(5)
    env = rng.normal(size=(8, 16, 3)).astype(np.float32)
    g = rng.normal(size=(8, 16, 3)).astype(np.float32)
    jstate = {"params": {"env": jnp.asarray(env)},
              "opt": jax.tree.map(jnp.asarray, {
                  "m": {"env": 0.1 * g}, "v": {"env": 0.01 * g * g},
                  "step": np.int32(3)})}
    tstate = TLT.env_state_from_jax(jax.device_get(jstate), device="cpu")
    assert tstate["opt"]["step"] == 3
    jnew = JLT.direct_light_map_step(jstate, {"env": jnp.asarray(g)}, 0.025)
    tnew = TLT.direct_light_map_step(tstate, {"env": _t(g)}, 0.025)
    np.testing.assert_allclose(tnew["params"]["env"].numpy(),
                               np.asarray(jnew["params"]["env"]), atol=1e-6)
    np.testing.assert_allclose(tnew["opt"]["v"]["env"].numpy(),
                               np.asarray(jnew["opt"]["v"]["env"]),
                               rtol=1e-6, atol=1e-12)
    assert tnew["opt"]["step"] == int(jnew["opt"]["step"]) == 4
    init = TLT.direct_light_map_init(
        8, 3.0, generator=torch.Generator().manual_seed(0), device="cpu")
    e = init["params"]["env"]
    assert e.shape == (8, 16, 3) and 0 <= float(e.min()) and \
        float(e.max()) < 3.0
    assert float(init["opt"]["m"]["env"].abs().max()) == 0.0


def test_wrappers_refuse_what_the_kernel_does_not_take():
    u = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        K.env_lookup_forward(torch.zeros(16, 32, 3), u, u)
    with pytest.raises(ValueError, match="CUDA"):
        K.env_lookup_backward(u, u, torch.zeros(8, 3), h=16, w=32)
    # an env past a block's shared memory is taken (read in place, added
    # with atomics): the call goes on to the device check
    with pytest.raises(ValueError, match="CUDA"):
        K.env_lookup_forward(torch.zeros(128, 256, 3), u, u)
    with pytest.raises(ValueError, match="CUDA"):
        K.env_lookup_backward(u, u, torch.zeros(8, 3), h=128, w=256)
    with pytest.raises(ValueError, match="H >= 2"):
        K.env_lookup_forward(torch.zeros(1, 32, 3), u, u)
    with pytest.raises(ValueError, match="unsupported device"):
        P.env_lookup_forward(torch.zeros(16, 32, 3, device="meta"), u, u)
