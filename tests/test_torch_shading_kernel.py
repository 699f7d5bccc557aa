"""Stage 2's training shading (``svgir_tpu_torch.ops.shading.shade_train``,
the kernel pair of ``csrc/shading.cu`` on the card) on the CPU.

* Its plain version (``shade_train_forward_plain`` /
  ``shade_train_backward_plain``, the kernels' arithmetic and hand-derived
  backward) against autograd through ``rendering_equation4``, in float64,
  on seeded random rows (N = 64, S = 8) and on rows built to meet the
  edges: all-zero cotangents, roughness 0.09 and 0.99, vertices with
  N.V < 0, env values above 64 and below 0, and samples exactly on the
  clamps' bounds (env 0 and 64, N.L of the transport 0, GGX's N.L, N.V,
  N.H at 1e-6 and 1, V.H at 1, the denominator at 4 pi).  Both compute
  the same float64 expressions, so they agree to a few ulp.
* ``render_svgss(is_training=True)`` through ``shade_train`` against the
  same step through ``rendering_equation4``: the loss within 1e-6
  relative and every gradient within 2e-5 of its largest magnitude, float32
  rounding (the two sum over S and over the vertices in other orders; on
  this scene they lie 2.2e-6 apart at most, the loss equal).
* ``shade_train`` refuses a gradient on the bake's visibility, directions
  or areas; the kernel wrappers refuse CPU tensors.
* On a CUDA device (marked ``card``, skipped here): the kernels against the
  plain version in float64 on the same rows, no further than twice the
  float32 plain version (or 1e-6 of each output's largest magnitude).  On
  the card, without JAX: ``python -m pytest --noconftest -o addopts= -p
  no:cacheprovider tests/test_torch_shading_kernel.py -m card``.

Imports no JAX: its card test runs on a machine without it.
"""

import dataclasses
import math

import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.kernels import shading as KS
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.ops import shading as SH
from svgir_tpu_torch.render import svgss
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize

N, S = 64, 8
NAMES = ("base_color", "roughness", "normals", "viewdirs", "radiance",
         "env_radiance")
BAKE = ("visibility", "incident_dirs", "incident_areas")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread for the module under the parallel
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels of csrc/shading.cu "
                    "run only there")
    return torch.device("cuda:0")


def _unit(g, *shape):
    return normalize(torch.randn(*shape, 3, generator=g, dtype=torch.float64))


def _inputs(edges: bool, seed: int = 0):
    """(the nine inputs of shade_train by name, d_pbr, d_diffuse_light) in
    float64.  Random rows: base colour and roughness in get_base_color's
    and get_roughness's ranges, unit normals (half of them facing away
    from the view), env values in [-4, 80], visibility 0 or 1.  With
    ``edges``, rows 0-7 are built to meet the edges listed in the module
    docstring."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, dtype=torch.float64)

    x = {"base_color": rand(N, 12) * 0.77 + 0.03,
         "roughness": rand(N, 4) * 0.9 + 0.09,
         "normals": _unit(g, N, 4), "viewdirs": _unit(g, N),
         "radiance": rand(N, S, 3) * 2, "env_radiance": rand(N, S, 3) * 84 - 4,
         "visibility": (rand(N, S, 1) > 0.3).double(),
         "incident_dirs": _unit(g, N, S),
         "incident_areas": torch.full((N, S, 1), 4 * math.pi / S,
                                      dtype=torch.float64)}
    d_pbr = torch.randn(N, 12, generator=g, dtype=torch.float64)
    d_dl = torch.randn(N, 12, generator=g, dtype=torch.float64)
    if not edges:
        return x, d_pbr, d_dl

    def vec(*v):
        return torch.tensor(v, dtype=torch.float64)

    z, e = (0.0, 0.0, 1.0), 1e-6
    # |(e, 0, side)|^2 rounds to 1 + 2^-52, whose square root rounds to 1:
    # normalize leaves the vector as it is, its x exactly 1e-6
    side = math.nextafter(math.sqrt(1 - e * e), 2.0)
    # rows 0-1: no cotangent (dead rows)
    d_pbr[:2] = 0
    d_dl[:2] = 0
    # row 2: the roughness's ends; row 3: every vertex facing away
    x["roughness"][2] = vec(0.09, 0.99, 0.09, 0.99)
    x["normals"][3] = -x["viewdirs"][3].expand(4, 3) + 0.1 * _unit(g, 4)
    # row 4: env values on the clamp's bounds and past them
    x["env_radiance"][4, :4] = vec(
        (0.0, 64.0, 80.0), (64.0, 0.0, -1.0), (100.0, 64.0, 0.0),
        (0.0, 0.0, 64.0))
    # row 5: V = N = L at sample 0 and roughness 1: GGX's N.L, N.V, N.H,
    # V.H at 1 and the denominator at 4 pi; sample 1 perpendicular to the
    # normals, the transport's N.L at 0
    x["viewdirs"][5] = vec(*z)
    x["normals"][5] = vec(*z)
    x["roughness"][5] = 1.0
    x["incident_dirs"][5, 0] = vec(*z)
    x["incident_dirs"][5, 1] = vec(1.0, 0.0, 0.0)
    # row 6: V = L along x, unit normals with x = 1e-6: GGX's N.L, N.V
    # and N.H at 1e-6
    x["viewdirs"][6] = vec(1.0, 0.0, 0.0)
    x["normals"][6] = vec(e, 0.0, side)
    x["incident_dirs"][6, 0] = vec(1.0, 0.0, 0.0)
    # row 7: roughness 0.09 at a specular peak, the denominator far below
    # its lower bound; other samples around it
    x["viewdirs"][7] = vec(*z)
    x["normals"][7] = vec(*z)
    x["roughness"][7] = 0.09
    x["incident_dirs"][7, 0] = vec(*z)
    return x, d_pbr, d_dl


def _args(x):
    return [x[k] for k in NAMES + BAKE]


def _autograd(x, d_pbr, d_dl):
    """pbr, diffuse light and the six gradients through
    rendering_equation4."""
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in x.items()}
    pbr, extra = SH.rendering_equation4(
        leaves["base_color"], leaves["roughness"], leaves["normals"],
        leaves["viewdirs"], leaves["radiance"], None, leaves["visibility"],
        leaves["incident_dirs"], leaves["incident_areas"],
        env_radiance=leaves["env_radiance"])
    dl = extra["diffuse_light"]
    grads = torch.autograd.grad((pbr * d_pbr).sum() + (dl * d_dl).sum(),
                                [leaves[k] for k in NAMES])
    return pbr.detach(), dl.detach(), grads


def _edges_met(x):
    """Which clamp bounds the inputs meet exactly, by the plain version's
    own terms."""
    q = SH._row_terms(x["roughness"], x["normals"], x["viewdirs"])
    t = SH._tap_terms(q, x["normals"], x["incident_dirs"])
    env = x["env_radiance"]
    return {
        "env 0": bool((env == 0).any()), "env 64": bool((env == 64).any()),
        "env above 64": bool((env > 64).any()),
        "transport N.L 0": bool((t["ndi_raw"] == 0).any()),
        "N.L 1e-6": bool((t["nol_raw"] == 1e-6).any()),
        "N.L 1": bool((t["nol_raw"] == 1).any()),
        "N.V 1e-6": bool((q["nov_raw"] == 1e-6).any()),
        "N.V 1": bool((q["nov_raw"] == 1).any()),
        "N.H 1e-6": bool((t["noh_raw"] == 1e-6).any()),
        "N.H 1": bool((t["noh_raw"] == 1).any()),
        "V.H 1": bool((t["voh_raw"] == 1).any()),
        "denominator 4 pi": bool((t["p"] == SH._FOUR_PI).any()),
        "denominator below 1e-6": bool((t["p"] < 1e-6).any()),
        "N.V < 0 before the flip": bool((q["sg"] < 0).any()),
    }


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_plain_version_matches_autograd_in_float64(edges):
    x, d_pbr, d_dl = _inputs(edges)
    if edges:
        met = _edges_met(x)
        assert all(met.values()), [k for k, v in met.items() if not v]
    pbr, dl, grads = _autograd(x, d_pbr, d_dl)
    ppbr, pdl = SH.shade_train_forward_plain(*_args(x))
    pgrads = SH.shade_train_backward_plain(*_args(x), d_pbr, d_dl)
    for name, a, b in zip(("pbr", "diffuse_light") + NAMES,
                          (ppbr, pdl) + pgrads, (pbr, dl) + grads):
        assert a.shape == b.shape and a.dtype == torch.float64, name
        scale = float(b.abs().max())
        assert scale > 0, name
        err = float((a - b).abs().max()) / scale
        assert err < 1e-13, (name, err)
    # the rows with no cotangent get exact zeros
    zero_rows = (d_pbr == 0).all(1) & (d_dl == 0).all(1)
    assert int(zero_rows.sum()) == (2 if edges else 0)
    for gr in pgrads:
        assert bool((gr[zero_rows] == 0).all())


def test_plain_version_runs_in_chunks(monkeypatch):
    """Chunks of rows give each row's values (PyTorch's sums over S may
    take another order at another shape: a few ulp)."""
    x, d_pbr, d_dl = _inputs(True, seed=1)
    whole = (SH.shade_train_forward_plain(*_args(x)),
             SH.shade_train_backward_plain(*_args(x), d_pbr, d_dl))
    monkeypatch.setattr(SH, "SHADE_CHUNK_PAIRS", 5 * S)
    assert len(SH._chunks(N, S)) == 13
    chunked = (SH.shade_train_forward_plain(*_args(x)),
               SH.shade_train_backward_plain(*_args(x), d_pbr, d_dl))
    for a, b in zip(whole[0] + whole[1], chunked[0] + chunked[1]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-14 * float(b.abs().max()))


def test_function_takes_the_plain_version_on_the_cpu():
    """shade_train on CPU tensors: the plain version's values and
    gradients, and no kernel launch."""
    x, d_pbr, d_dl = _inputs(True)
    x = {k: v.float() for k, v in x.items()}
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in x.items()}
    kernels.reset_launches()
    pbr, dl = SH.shade_train(*_args(leaves))
    grads = torch.autograd.grad((pbr * d_pbr.float()).sum()
                                + (dl * d_dl.float()).sum(),
                                [leaves[k] for k in NAMES])
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
    ppbr, pdl = SH.shade_train_forward_plain(*_args(x))
    pgrads = SH.shade_train_backward_plain(*_args(x), d_pbr.float(),
                                           d_dl.float())
    for a, b in zip((pbr, dl) + grads, (ppbr, pdl) + pgrads):
        assert torch.equal(a.detach(), b)


@pytest.mark.parametrize("name", BAKE)
def test_function_refuses_a_gradient_on_the_bake(name):
    x, _, _ = _inputs(False)
    x = {k: v.float() for k, v in x.items()}
    x[name] = x[name].clone().requires_grad_(True)
    with pytest.raises(ValueError, match=name):
        SH.shade_train(*_args(x))


def test_kernel_wrappers_refuse_cpu_tensors():
    x, d_pbr, d_dl = _inputs(False)
    args = [v.float() for v in _args(x)]
    with pytest.raises(ValueError, match="CUDA"):
        KS.shading_forward(*args)
    with pytest.raises(ValueError, match="CUDA"):
        KS.shading_backward(*args, d_pbr.float(), d_dl.float())


# ---------------------------------------------------------------------------
# the training render through shade_train against rendering_equation4
# ---------------------------------------------------------------------------

ALIVE, CAP, RES = 40, 48, 32
CFG = RasterConfig(max_instances=1 << 13)


def _stage2_scene():
    """A sphere of 40 alive surfels in 48 rows facing out, upgraded to PBR
    with random materials, a synthetic bake (S = 8), an 8x16 env and one
    32 x 32 view; the recipe's optional losses on, the light losses
    among them (they read the diffuse light)."""
    g = torch.Generator().manual_seed(3)
    dirs = normalize(torch.randn(ALIVE, 3, generator=g))
    state = G.upgrade_to_pbr(G.init_from_points(
        dirs, torch.full((ALIVE, 3), 0.6), normals=dirs, capacity=CAP,
        rotation_init="normal", device="cpu"))
    params = dict(state["params"])
    for k, scale in (("base_color", 0.5), ("roughness", 0.5),
                     ("normal", 0.1)):
        params[k] = scale * torch.randn(params[k].shape, generator=g)
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(CAP, 3, generator=g)), S)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {"radiance": torch.rand(CAP, S, 3, generator=g),
            "visibility": (torch.rand(CAP, S, 1, generator=g) > 0.3).float(),
            "incident_dirs": inc, "incident_areas": areas,
            "incident_qxy": torch.stack([qx, qy], -1),
            "hit_idx": torch.randint(-1, CAP, (CAP, S), generator=g),
            "uv": torch.rand(CAP, S, 2, generator=g)}
    params["radiances"] = bake["radiance"].clone()
    params["radiance_ratio"] = torch.ones(())
    env = LT.direct_light_map_init(8, generator=g, device="cpu")
    cam = look_at_camera(eye=[0.4, 0.3, -3.0], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=RES, height=RES, device="cpu")
    cam = dataclasses.replace(
        cam, image=torch.rand(3, RES, RES, generator=g),
        image_mask=torch.ones(1, RES, RES))
    opt = OptimizationConfig(
        lambda_base_color_smooth=0.1, lambda_roughness_smooth=0.05,
        lambda_env_smooth=0.02, lambda_normal_smooth=0.02,
        lambda_light_smooth=1.0, lambda_light=0.02,
        lambda_mask_entropy=0.01)
    return params, state["alive"], bake, env, cam, opt


def _loss_and_grads(params, alive, bake, env, cam, opt):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    env_leaf = env["params"]["env"].detach().clone().requires_grad_(True)
    res = svgss.render_svgss(cam, leaves, torch.zeros(3), bake=bake,
                             env_params={"env": env_leaf}, opt=opt,
                             iteration=1.0, is_training=True, alive=alive,
                             cfg=CFG)
    keys = sorted(leaves)
    grads = torch.autograd.grad(res["loss"], [leaves[k] for k in keys]
                                + [env_leaf], allow_unused=True)
    out = dict(zip(keys + ["env"], grads))
    return res["loss"].detach(), res["diffuse_light"].detach(), out


def test_training_render_matches_the_rendering_equation4_path(monkeypatch):
    sc = _stage2_scene()
    loss, dl, grads = _loss_and_grads(*sc)

    def through_rendering_equation4(bc, rough, nrm, vd, rad, env_rad, vis,
                                    dirs, areas):
        pbr, extra = SH.rendering_equation4(bc, rough, nrm, vd, rad, None,
                                            vis, dirs, areas,
                                            env_radiance=env_rad)
        return pbr, extra["diffuse_light"]

    monkeypatch.setattr(svgss, "shade_train", through_rendering_equation4)
    ref_loss, ref_dl, ref_grads = _loss_and_grads(*sc)
    assert abs(float(loss - ref_loss)) <= 1e-6 * abs(float(ref_loss))
    torch.testing.assert_close(dl, ref_dl, rtol=0, atol=1e-5)
    moved = 0
    for k, ref in ref_grads.items():
        got = grads[k]
        if ref is None:
            assert got is None, k
            continue
        scale = float(ref.abs().max())
        if scale == 0:
            assert float(got.abs().max()) == 0, k
            continue
        moved += 1
        err = float((got - ref).abs().max()) / scale
        assert err < 2e-5, (k, err)
    # the shading's inputs all take a gradient through the step
    for k in ("base_color", "roughness", "normal", "xyz", "radiance_ratio",
              "env"):
        assert grads[k] is not None and float(grads[k].abs().max()) > 0, k
    assert moved >= 10


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_kernels_match_the_plain_version(card, edges):
    """The kernels' pbr, diffuse light and six gradients against the plain
    version in float64, each within twice the distance of the float32
    plain version on the card (the same rsqrt and exp2 as the kernels) from
    it, or 1e-6 of the output's largest magnitude; one launch of each."""
    x, d_pbr, d_dl = _inputs(edges)
    ref = SH.shade_train_forward_plain(*_args(x)) + \
        SH.shade_train_backward_plain(*_args(x), d_pbr, d_dl)
    xc = {k: v.float().to(card) for k, v in x.items()}
    gp, gd = d_pbr.float().to(card), d_dl.float().to(card)
    f32 = SH.shade_train_forward_plain(*_args(xc)) + \
        SH.shade_train_backward_plain(*_args(xc), gp, gd)
    kernels.reset_launches()
    leaves = {k: v.clone().requires_grad_(k in NAMES) for k, v in xc.items()}
    pbr, dl = SH.shade_train(*_args(leaves))
    grads = torch.autograd.grad((pbr * gp).sum() + (dl * gd).sum(),
                                [leaves[k] for k in NAMES])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shading_forward"] == 1
    assert kernels.LAUNCHES["shading_backward"] == 1
    got = (pbr.detach(), dl.detach()) + grads
    for name, k, r, p in zip(("pbr", "diffuse_light") + NAMES, got, ref,
                             f32):
        scale = float(r.abs().max())
        e_k = float((k.double().cpu() - r).abs().max()) / scale
        e_p = float((p.double().cpu() - r).abs().max()) / scale
        assert e_k <= max(2 * e_p, 1e-6), (name, e_k, e_p)
