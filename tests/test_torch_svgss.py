"""The stage-2 (render_relight) slice of svgir_tpu_torch against svgir_tpu:
per-vertex shading, the radiance-consistency loss, the forward render in
both modes and one joint Gaussian + env-map train step.

The scene (48 alive surfels in a capacity of 64, 40x40 camera), its PBR
parameters and a synthetic radiance bake (S = 8; values as in
``bench_stage2.py``) are made with numpy from a seed and carried to both
packages.  Tolerances (float32 on the CPU in both):
- shading terms 2e-5 absolute (values below 4; GGX's clamped denominator
  amplifies one-ulp differences of the normalizations), their gradients
  1e-4 of each gradient's largest magnitude for the same reason;
- images 2e-4 absolute (``direct`` and ``indirect``, shown divided by
  the opacity, 4e-4), depth 5e-4 relative, the pseudo-normal 5e-3.  The
  vertex channels are divided by the opacity and pass through sRGB, the
  depth is divided by 1 - T and the pseudo-normal takes its finite
  differences: on this scene both packages' float32 images lie up to 1e-4
  (pbr), 2.5e-4 (direct), 3.6e-4 relative (depth) and 2e-3 (pseudo-normal)
  from a float64 evaluation of the same math, and within 2e-5, 4e-5,
  1e-4 and 4e-4 of each other;
- loss and every ``tb`` term 1e-5;
- per-group gradients, the env's included, 2.5e-3 of each gradient's
  largest magnitude, as for the stage-1 step (ROADMAP C-8); the consistency
  loss alone (no rasterizer) 1e-5;
- Adam moments 2.5e-3 (m) and 5e-3 (v) relative, post-Adam parameters
  1e-7 where the gradient is above 1e-3 of its largest magnitude (the
  first step moves them by exactly lr * sign(g)) and within 2 lr
  elsewhere.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.config import OptimizationConfig as JOpt
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.models import gaussians as JG
from svgir_tpu.models import lights as JLT
from svgir_tpu.models import radiance as JRAD
from svgir_tpu.ops import shading as JSH
from svgir_tpu.render.svgss import render_view_svgss as j_render_view
from svgir_tpu.train import optim as joptim
from svgir_tpu.train import trainer as jtrainer
from svgir_tpu.utils import graphics as JGR

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import OptimizationConfig as TOpt
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.models import gaussians as TG
from svgir_tpu_torch.models import lights as TLT
from svgir_tpu_torch.models import radiance as TRAD
from svgir_tpu_torch.ops import shading as TSH
from svgir_tpu_torch.render.svgss import render_svgss as t_render_svgss
from svgir_tpu_torch.render.svgss import render_view_svgss as t_render_view
from svgir_tpu_torch.train import optim as toptim
from svgir_tpu_torch.train import trainer as ttrainer
from svgir_tpu_torch.utils import graphics as TGR
from svgir_tpu_torch.utils.transforms import normalize

from tests.scenes import default_camera
from tests.torch_kernel_inputs import SHADE_INPUTS, shade_rows


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


W = H = 40
N, CAP, S = 48, 64, 8
XYZ_LR, RAD_LR, ITER = 1e-5, 1e-4, 100.0
GROUPS = ("xyz", "normal", "shs_dc", "shs_rest", "scaling", "rotation",
          "opacity", "base_color", "roughness", "incidents_dc",
          "incidents_rest", "visibility_dc", "visibility_rest", "radiances",
          "radiance_ratio")
# the smoothness terms switch on every optional stage-2 loss of the recipe
OPT_KW = dict(lambda_base_color_smooth=0.1, lambda_roughness_smooth=0.05,
              lambda_env_smooth=0.02, lambda_normal_smooth=0.02,
              lambda_light_smooth=0.01, lambda_light=0.01,
              lambda_mask_entropy=0.01)


def _t(x):
    return torch.as_tensor(np.array(x))


def _scene():
    """(state as numpy, bake as numpy, env as numpy, target image).  The
    stage-1 state comes from the port's ``init_from_points`` and
    ``upgrade_to_pbr`` (each held to the reference elsewhere)."""
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(N, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = dirs * (0.8 + 0.2 * rng.random((N, 1))).astype(np.float32)
    cols = rng.random((N, 3)).astype(np.float32)
    state = TG.upgrade_to_pbr(TG.init_from_points(
        pts, cols, normals=dirs, capacity=CAP, rotation_init="normal",
        device="cpu"))
    p = TG.params_to_numpy(state["params"])
    p["opacity"] = np.where(np.arange(CAP)[:, None] < N,
                            rng.normal(size=(CAP, 1)) + 0.5,
                            -10.0).astype(np.float32)
    p["scaling"] = (p["scaling"] + 0.4).astype(np.float32)
    p["base_color"] = (0.5 * rng.normal(size=(CAP, 12))).astype(np.float32)
    p["roughness"] = (0.5 * rng.normal(size=(CAP, 4))).astype(np.float32)
    p["normal"] = (0.1 * rng.normal(size=(CAP, 12))).astype(np.float32)

    nrm = rng.normal(size=(CAP, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dirs_s, areas, qx, qy = jax.jit(_fib_qxy, static_argnums=1)(
        jnp.asarray(nrm), S)
    bake = {
        "radiance": rng.random((CAP, S, 3)).astype(np.float32),
        "visibility": (rng.random((CAP, S, 1)) > 0.3).astype(np.float32),
        "incident_dirs": np.asarray(dirs_s),
        "incident_areas": np.asarray(areas),
        "incident_qxy": np.stack([np.asarray(qx), np.asarray(qy)], -1),
        "hit_idx": rng.integers(-1, N, (CAP, S)).astype(np.int32),
        "uv": rng.random((CAP, S, 2)).astype(np.float32),
    }
    p["radiances"] = bake["radiance"].copy()
    p["radiance_ratio"] = np.float32(0.9)
    env = (0.5 * rng.normal(size=(16, 32, 3)) + 1.0).astype(np.float32)
    img = rng.random((3, H, W)).astype(np.float32)
    state = {"params": p, "alive": state["alive"].numpy(),
             "stats": TG.params_to_numpy(state["stats"])}
    return state, bake, env, img


def _fib_qxy(nrm, s):
    dirs, areas = JGR.fibonacci_sphere_sampling(nrm, s)
    return (dirs, areas) + JLT.equirect_grid_coords(dirs)


def _jax_side(state, bake, env, img):
    cam = dataclasses.replace(default_camera(W, H), image=jnp.asarray(img),
                              image_mask=jnp.ones((1, H, W)))
    jb = jax.tree.map(jnp.asarray, bake)
    jp = jax.tree.map(jnp.asarray, state["params"])
    return cam, jb, jp, {"env": jnp.asarray(env)}


def _port_side(state, bake, env, img):
    cam = t_look_at(eye=[0.3, 0.2, -3.0], target=[0, 0, 0], up=[0, -1, 0],
                    fovx=math.pi / 3, fovy=math.pi / 3, width=W, height=H,
                    image=img, device="cpu")
    tb = {k: _t(v) for k, v in bake.items()}
    tp = TG.params_from_jax(state["params"], device="cpu")
    alive = _t(np.asarray(state["alive"]))
    return cam, tb, tp, {"env": _t(env)}, alive


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def stepped(scene):
    """One JAX and one port stage-2 train step from the same state; the
    gradients are read back from Adam's first moment (m = 0.1 g)."""
    state, bake, env, img = scene
    jcam, jb, jp, jenv = _jax_side(*scene)
    jopt, jcfg = JOpt(**OPT_KW), JCfg(max_instances=1 << 14)
    jstate = {"params": jp, "alive": jnp.asarray(state["alive"]),
              "stats": jax.tree.map(jnp.asarray, state["stats"])}
    jenv_state = {"params": jenv, "opt": joptim.adam_init(jenv)}
    jstep = jtrainer.make_svgss_train_step(
        jopt, jcfg, jnp.zeros(3), lrs=joptim.group_lrs(jopt, 1.0, True))
    jnew, jost, jenv_new, jtb = jax.device_get(jstep(
        jstate, joptim.adam_init(jp), jenv_state, jb, jcam,
        jnp.float32(ITER), jnp.float32(XYZ_LR), jnp.float32(RAD_LR)))

    tcam, tb, tp, tenv, alive = _port_side(*scene)
    topt, tcfg = TOpt(**OPT_KW), TCfg(max_instances=1 << 14)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    e = tenv["env"].clone().requires_grad_(True)
    r = t_render_svgss(tcam, p, torch.zeros(3), bake=tb, env_params={"env": e},
                       opt=topt, iteration=ITER, is_training=True, alive=alive,
                       cfg=tcfg)
    grads = torch.autograd.grad(r["loss"], [p[k] for k in GROUPS] + [e],
                                allow_unused=True)
    tg = {k: (torch.zeros_like(x) if g is None else g).numpy()
          for k, x, g in zip(GROUPS + ("env",), [p[k] for k in GROUPS] + [e],
                             grads)}
    tstep = ttrainer.make_svgss_train_step(
        topt, tcfg, torch.zeros(3), lrs=toptim.group_lrs(topt, 1.0, True),
        device="cpu")
    tstate = {"params": tp, "alive": alive,
              "stats": TG.init_stats(CAP, device="cpu")}
    tenv_state = {"params": tenv, "opt": toptim.adam_init(tenv)}
    tnew, tost, tenv_new, ttb = tstep(tstate, toptim.adam_init(tp),
                                      tenv_state, tb, tcam, ITER, XYZ_LR,
                                      RAD_LR)
    jg = {k: np.asarray(jost["m"][k]) / 0.1 for k in GROUPS}
    jg["env"] = np.asarray(jenv_new["opt"]["m"]["env"]) / 0.1
    return dict(j=dict(new=jnew, ost=jost, env=jenv_new, tb=jtb, grads=jg),
                t=dict(new=tnew, ost=tost, env=tenv_new, tb=ttb, grads=tg,
                       loss=float(r["loss"])))


def _rel(a, b, tol, msg=""):
    b = np.asarray(b)
    scale = max(np.abs(b).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# shading and the consistency loss
# ---------------------------------------------------------------------------

def _shading_inputs(n=33, s=8):
    rng = np.random.default_rng(0)

    def unit(*shape):
        x = rng.normal(size=shape + (3,)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)
    return dict(
        base_color=rng.uniform(0.1, 0.8, (n, 12)).astype(np.float32),
        roughness=rng.uniform(0.1, 0.99, (n, 4)).astype(np.float32),
        normals=unit(n, 4), viewdirs=unit(n), radiance=rng.uniform(
            0, 2, (n, s, 3)).astype(np.float32),
        visibility=rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
        incident_dirs=unit(n, s),
        incident_areas=np.full((n, s, 1), 2 * math.pi, np.float32),
        env_radiance=rng.uniform(0, 80, (n, s, 3)).astype(np.float32))


def test_ggx_specular4_matches():
    x = _shading_inputs()
    j = jax.jit(JSH.ggx_specular4)(x["normals"], x["viewdirs"],
                                   x["incident_dirs"], x["roughness"])
    t = TSH.ggx_specular4(_t(x["normals"]), _t(x["viewdirs"]),
                          _t(x["incident_dirs"]), _t(x["roughness"]))
    assert t.shape == (33, 8, 4, 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-5)


def test_rendering_equation4_matches_with_gradients():
    x = _shading_inputs()
    names = ("base_color", "roughness", "normals", "radiance",
             "env_radiance")
    cot = np.random.default_rng(1).normal(size=(33, 12)).astype(np.float32)

    def jfn(*args):
        a = dict(x, **dict(zip(names, args)))
        pbr, extra = JSH.rendering_equation4(
            a["base_color"], a["roughness"], a["normals"], a["viewdirs"],
            a["radiance"], None, a["visibility"], a["incident_dirs"],
            a["incident_areas"], env_radiance=a["env_radiance"])
        return (pbr * cot).sum(), (pbr, extra)

    (_, (jpbr, jextra)), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=tuple(range(5)), has_aux=True))(
            *(jnp.asarray(x[k]) for k in names))
    targs = {k: _t(v).requires_grad_(k in names) for k, v in x.items()}
    tpbr, textra = TSH.rendering_equation4(
        targs["base_color"], targs["roughness"], targs["normals"],
        targs["viewdirs"], targs["radiance"], None, targs["visibility"],
        targs["incident_dirs"], targs["incident_areas"],
        env_radiance=targs["env_radiance"])
    tg = torch.autograd.grad((tpbr * _t(cot)).sum(),
                             [targs[k] for k in names])
    np.testing.assert_allclose(tpbr.detach().numpy(), np.asarray(jpbr),
                               atol=2e-5)
    for k in ("diffuse_light", "specular", "direct", "indirect",
              "incident_lights", "global_incident_lights"):
        np.testing.assert_allclose(textra[k].detach().numpy(),
                                   np.asarray(jextra[k]), atol=2e-5,
                                   err_msg=k)
    for k, a, b in zip(names, tg, jg):
        _rel(a.numpy(), b, 1e-4, k)


# rows of shade_rows(edges=True) with an input exactly on a clamp's bound:
# there jnp.clip splits the gradient, torch.clamp passes it whole
# (ROADMAP hazard 14)
SHADE_TIE_ROWS = (4, 5, 6)


def _shade_edges_met(x):
    """Which clamp bounds the edge rows meet exactly, from the raw dot
    products rendering_equation4 clamps, formed as it forms them."""
    v = normalize(x["viewdirs"])[:, None]                   # [N, 1, 3]
    lt = normalize(x["incident_dirs"])[:, :, None]          # [N, S, 1, 3]
    h = normalize((lt + v[:, None]) / 2.0)                  # [N, S, 1, 3]
    nn = normalize(x["normals"])                            # [N, 4, 3]
    flip = torch.sign((v * nn).sum(-1))                     # [N, 4]
    nf = nn * flip[..., None]
    nol = (nf[:, None] * lt).sum(-1)                        # [N, S, 4]
    nov = (nf * v).sum(-1)                                  # [N, 4]
    noh = (nf[:, None] * h).sum(-1)                         # [N, S, 4]
    voh = (v[:, None] * h).sum(-1)                          # [N, S, 1]
    ndi = (x["normals"][:, None]
           * x["incident_dirs"][:, :, None]).sum(-1)        # [N, S, 4]
    rough = x["roughness"][:, None]                         # [N, 1, 4]
    alpha2 = (rough * rough) ** 2
    k = (rough * rough + 2 * rough + 1.0) / 8.0
    nom0 = noh.clamp(1e-6, 1) ** 2 * (alpha2 - 1) + 1
    nom1 = nov.clamp(1e-6, 1)[:, None] * (1 - k) + k
    nom2 = nol.clamp(1e-6, 1) * (1 - k) + k
    den = 4 * math.pi * nom0 * nom0 * nom1 * nom2
    env = x["env_radiance"]
    return {
        "env 0": bool((env == 0).any()), "env 64": bool((env == 64).any()),
        "env above 64": bool((env > 64).any()),
        "transport N.L 0": bool((ndi == 0).any()),
        "N.L 1e-6": bool((nol == 1e-6).any()),
        "N.L 1": bool((nol == 1).any()),
        "N.V 1e-6": bool((nov == 1e-6).any()),
        "N.V 1": bool((nov == 1).any()),
        "N.H 1e-6": bool((noh == 1e-6).any()),
        "N.H 1": bool((noh == 1).any()),
        "V.H 1": bool((voh == 1).any()),
        "denominator 4 pi": bool((den == 4 * math.pi).any()),
        "denominator below 1e-6": bool((den < 1e-6).any()),
        "N.V < 0 before the flip": bool((flip < 0).any()),
    }


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
def test_shade_train_matches_jax_in_float64(edges):
    """shade_train on CPU tensors (rendering_equation4 under autograd)
    against svgir_tpu's rendering_equation4 and its VJP, both in float64,
    on tests/torch_kernel_inputs.shade_rows: pbr and diffuse light within
    1e-13 of each one's largest magnitude on every row, the six gradients
    within 1e-12 on every row but SHADE_TIE_ROWS of the edge set, where
    they part as hazard 14 says."""
    x, d_pbr, d_dl = shade_rows(edges)
    if edges:
        met = _shade_edges_met(x)
        assert all(met.values()), [k for k, v in met.items() if not v]
    names = SHADE_INPUTS[:6]
    leaves = {k: v.clone().requires_grad_(k in names) for k, v in x.items()}
    pbr, dl = TSH.shade_train(*(leaves[k] for k in SHADE_INPUTS))
    grads = torch.autograd.grad((pbr * d_pbr).sum() + (dl * d_dl).sum(),
                                [leaves[k] for k in names])

    with jax.enable_x64(True):
        jx = {k: jnp.asarray(v.numpy()) for k, v in x.items()}

        def jfn(bc, rough, nrm, vd, rad, env_rad):
            p, extra = JSH.rendering_equation4(
                bc, rough, nrm, vd, rad, None, jx["visibility"],
                jx["incident_dirs"], jx["incident_areas"],
                env_radiance=env_rad)
            return p, extra["diffuse_light"]

        (jpbr, jdl), vjp = jax.vjp(jfn, *(jx[k] for k in names))
        jgrads = vjp((jnp.asarray(d_pbr.numpy()), jnp.asarray(d_dl.numpy())))
        jpbr, jdl = np.asarray(jpbr), np.asarray(jdl)
        jgrads = [np.asarray(g) for g in jgrads]
    assert jpbr.dtype == np.float64 and jgrads[0].dtype == np.float64
    for name, a, b in (("pbr", pbr, jpbr), ("diffuse_light", dl, jdl)):
        err = np.abs(a.detach().numpy() - b).max() / np.abs(b).max()
        assert err < 1e-13, (name, err)
    rows = np.ones(x["roughness"].shape[0], bool)
    if edges:
        rows[list(SHADE_TIE_ROWS)] = False
    tie_gap = 0.0
    for name, a, b in zip(names, grads, jgrads):
        scale = np.abs(b).max()
        assert a.shape == b.shape and scale > 0, name
        gap = np.abs(a.numpy() - b) / scale
        assert gap[rows].max() < 1e-12, (name, gap[rows].max())
        tie_gap = max(tie_gap, gap[~rows].max(initial=0.0))
    # the ties are real: the excluded rows part
    assert (tie_gap > 1e-6) == edges, tie_gap


def test_radiance_consistency_loss_matches(scene):
    state, bake, env, img = scene
    jcam, jb, jp, jenv = _jax_side(*scene)
    tcam, tb, tp, tenv, alive = _port_side(*scene)
    names = ("xyz", "rotation", "normal", "base_color", "roughness",
             "radiances", "radiance_ratio")

    def jloss(p, e):
        return JRAD.radiance_consistency_loss(
            p, jb, jcam.camera_center, lambda d: JLT.direct_light(e, d),
            alive=state["alive"],
            env_radiance=JLT.direct_light_qxy(
                e, jb["incident_qxy"][..., 0], jb["incident_qxy"][..., 1]))

    jl, (jgp, jge) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jenv)
    p = {k: v.clone().requires_grad_(k in names) for k, v in tp.items()}
    e = {"env": tenv["env"].clone().requires_grad_(True)}
    tl = TRAD.radiance_consistency_loss(
        p, tb, tcam.camera_center, lambda d: TLT.direct_light(e, d),
        alive=alive, env_radiance=TLT.direct_light_qxy(
            e, tb["incident_qxy"][..., 0], tb["incident_qxy"][..., 1]))
    tg = torch.autograd.grad(tl, [p[k] for k in names] + [e["env"]],
                             allow_unused=True)
    assert float(tl) == pytest.approx(float(jl), abs=1e-6)
    for k, g in zip(names, tg[:-1]):
        g = torch.zeros_like(p[k]) if g is None else g
        _rel(g.numpy(), jgp[k], 1e-5, k)
    _rel(tg[-1].numpy(), jge["env"], 1e-5, "env")
    # get_radiances detaches: the radiances themselves get no gradient
    assert float(np.abs(np.asarray(jgp["radiances"])).max()) == 0.0
    assert tg[names.index("radiances")] is None or \
        float(tg[names.index("radiances")].abs().max()) == 0.0


def test_consistency_picks_the_same_samples(scene):
    """Each package's argmax over (reflected view . dir) * occlusion, the
    consistency loss's sample choice, picks the same sample on this seed,
    whose best two scores lie clearly apart."""
    from svgir_tpu.utils.transforms import normalize as jnorm
    from svgir_tpu_torch.utils.transforms import normalize as tnorm
    jcam, jb, jp, _ = _jax_side(*scene)
    tcam, tb, tp, _, _ = _port_side(*scene)

    def score(G, norm, p, b, center):
        geo = G.get_geo_normal(p)
        vd = norm(p["xyz"] - center[None])
        refl = 2 * (geo * vd).sum(-1, keepdims=True) * geo + vd
        return (b["incident_dirs"] * refl[:, None]).sum(-1) * (
            1 - b["visibility"][..., 0])

    js = np.asarray(jax.jit(lambda p, b, c: score(JG, jnorm, p, b, c))(
        jp, jb, jcam.camera_center))
    ts = score(TG, tnorm, tp, tb, tcam.camera_center).numpy()
    np.testing.assert_array_equal(np.argmax(ts, -1), np.argmax(js, -1))
    top2 = np.sort(js, axis=-1)[:, -2:]
    has = js.max(-1) > 0
    assert (top2[has, 1] - top2[has, 0]).min() > 1e-4


def _one_bounce_inputs(bake, seed=5):
    """irradiance_sample's inputs besides the bake: one sample a surfel,
    env terms, unit vertex normals, albedo and roughness in the getters'
    ranges, as numpy."""
    n, s = bake["hit_idx"].shape
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(n, 4, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return dict(sample_idx=rng.integers(0, s, n),
                env_term=rng.uniform(0, 3, (n, s, 3)).astype(np.float32),
                normals=nrm,
                albedo=rng.uniform(0.03, 0.8, (n, 4, 3)).astype(np.float32),
                roughness=rng.uniform(0.09, 0.99, n).astype(np.float32))


def _one_bounce_grads(bake, x, cot, fn=None):
    """(irr, d_env_term, d_albedo, d_roughness) of ``fn`` (default
    ``irradiance_sample``) on CPU tensors for the cotangent ``cot``."""
    leaves = [_t(x[k]).requires_grad_(True)
              for k in ("env_term", "albedo", "roughness")]
    sidx = _t(x["sample_idx"])
    if fn is None:
        irr = TRAD.irradiance_sample(sidx, bake, leaves[0], _t(x["normals"]),
                                     leaves[1], leaves[2])
    else:
        irr = fn(sidx, bake, leaves[0], _t(x["normals"]), leaves[1],
                 leaves[2])
    return (irr.detach(), *torch.autograd.grad(irr, leaves, _t(cot)))


def test_consistency_misses_and_dead_rows_send_no_gradient(scene,
                                                           monkeypatch):
    """What the card's one-bounce kernel skips sends nothing on the plain
    path: the gradients into env_term, albedo and roughness from surfels
    whose hit is < 0 are exactly 0, zeroing their cotangent changes no bit
    of the gradients, and the loss's alive mask gives the dead surfels
    (some of them with a hit here) a cotangent of exactly 0."""
    tcam, tb, tp, tenv, alive = _port_side(*scene)
    n, s = tb["hit_idx"].shape
    # the scene's rays rarely miss: make 40% of them miss
    rng = np.random.default_rng(7)
    tb = dict(tb, hit_idx=torch.where(_t(rng.random((n, s)) < 0.4), -1,
                                      tb["hit_idx"]))
    x = _one_bounce_inputs(tb)
    hit = tb["hit_idx"][torch.arange(n), _t(x["sample_idx"])]
    miss = (hit < 0).numpy()
    assert miss.any() and not miss.all()
    cot = rng.normal(size=(n, 3)).astype(np.float32)
    only_miss = np.where(miss[:, None], cot, 0).astype(np.float32)
    for g in _one_bounce_grads(tb, x, only_miss)[1:]:
        assert float(g.abs().max()) == 0.0
    full = _one_bounce_grads(tb, x, cot)
    kept = _one_bounce_grads(tb, x, np.where(miss[:, None], 0, cot).astype(
        np.float32))
    for a, b in zip(full, kept):
        assert torch.equal(a, b)
    assert float(full[0][torch.as_tensor(miss)].abs().max()) == 0.0

    seen = {}
    plain = TRAD.irradiance_sample

    def spy(*args):
        seen["irr"] = out = plain(*args)
        out.retain_grad()
        return out
    monkeypatch.setattr(TRAD, "irradiance_sample", spy)
    names = ("base_color", "roughness")
    p = {k: v.clone().requires_grad_(k in names) for k, v in tp.items()}
    e = {"env": tenv["env"].clone().requires_grad_(True)}
    TRAD.radiance_consistency_loss(
        p, tb, tcam.camera_center, lambda d: TLT.direct_light(e, d),
        alive=alive, env_radiance=TLT.direct_light_qxy(
            e, tb["incident_qxy"][..., 0], tb["incident_qxy"][..., 1])
    ).backward()
    g = seen["irr"].grad
    dead = ~alive
    assert bool(dead.any()) and bool((tb["hit_idx"][dead] >= 0).any())
    assert float(g[dead].abs().max()) == 0.0
    assert float(g[alive].abs().max()) > 0.0


def test_irradiance_sample_takes_the_plain_version_on_the_cpu(scene):
    """On CPU tensors ``irradiance_sample`` runs the plain version
    (``_hit_table`` + ``_irradiance_from_table``), bit for bit, launches no
    kernel, and agrees with svgir_tpu's within 1e-5."""
    from svgir_tpu_torch import kernels
    _, jb, _, _ = _jax_side(*scene)
    _, tb, _, _, _ = _port_side(*scene)
    n, s = tb["hit_idx"].shape
    x = _one_bounce_inputs(tb, seed=8)
    cot = np.random.default_rng(9).normal(size=(n, 3)).astype(np.float32)

    def table_path(sidx, bake, env_term, normals, albedo, rough):
        gidx = torch.arange(n)
        table = TRAD._hit_table(bake, env_term, normals, albedo, rough)
        return TRAD._irradiance_from_table(
            table, bake["incident_dirs"][gidx, sidx],
            bake["hit_idx"][gidx, sidx], s)

    kernels.reset_launches()
    got = _one_bounce_grads(tb, x, cot)
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
    want = _one_bounce_grads(tb, x, cot, table_path)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert float(got[0].abs().max()) > 0.0

    def jfn(env_term, albedo, rough):
        irr = JRAD.irradiance_sample(jnp.asarray(x["sample_idx"]), jb,
                                     env_term, jnp.asarray(x["normals"]),
                                     albedo, rough)
        return (irr * cot).sum(), irr

    (_, jirr), jg = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x[k]) for k in ("env_term", "albedo", "roughness")))
    _rel(got[0].numpy(), jirr, 1e-5, "irr")
    for k, a, b in zip(("env_term", "albedo", "roughness"), got[1:], jg):
        _rel(a.numpy(), b, 1e-5, k)


def test_fibonacci_sampling_and_srgb_match():
    rng = np.random.default_rng(2)
    nrm = rng.normal(size=(50, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[0] = [0.0, 0.0, -1.0]                      # the -identity branch
    key = jax.random.PRNGKey(7)
    az = np.asarray(jax.random.uniform(key, (50, 1)))
    for jkey, taz in ((None, None), (key, _t(az))):
        jd, ja = jax.jit(JGR.fibonacci_sphere_sampling, static_argnums=1)(
            jnp.asarray(nrm), 12, jkey)
        td, ta = TGR.fibonacci_sphere_sampling(_t(nrm), 12, taz)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-6)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    x = rng.uniform(-0.2, 1.3, (3, 16, 16)).astype(np.float32)
    x[0, 0, :4] = [0.0, 0.0031308, 0.04045, 1.0]
    np.testing.assert_allclose(TGR.rgb_to_srgb(_t(x)).numpy(),
                               np.asarray(JGR.rgb_to_srgb(x)), atol=1e-6)
    np.testing.assert_allclose(TGR.rgb_to_srgb(_t(x), clip=False).numpy(),
                               np.asarray(JGR.rgb_to_srgb(x, clip=False)),
                               atol=1e-6)
    y = np.abs(x)
    np.testing.assert_allclose(TGR.srgb_to_rgb(_t(y)).numpy(),
                               np.asarray(JGR.srgb_to_rgb(y)), atol=1e-6)


def test_stage2_losses_and_camera_directions_match():
    from svgir_tpu import cameras as jcams
    from svgir_tpu.utils import losses as jl
    from svgir_tpu_torch.utils import losses as tl
    rng = np.random.default_rng(3)
    a, b, r = (rng.random((3, 24, 32)).astype(np.float32) for _ in range(3))
    for x, y in zip(tl.ssim_pair(_t(a), _t(b), _t(r)), jl.ssim_pair(a, b, r)):
        assert float(x) == pytest.approx(float(y), rel=1e-5, abs=1e-6)
    for name in ("second_order_edge_aware_loss", "mse_loss"):
        assert float(getattr(tl, name)(_t(a), _t(b))) == pytest.approx(
            float(getattr(jl, name)(a, b)), rel=1e-5, abs=1e-7), name
    assert float(tl.tv_loss(_t(a))) == pytest.approx(float(jl.tv_loss(a)),
                                                     rel=1e-5)
    np.testing.assert_allclose(tl.spatial_gradient(_t(a), 2).numpy(),
                               np.asarray(jl.spatial_gradient(a, 2)),
                               atol=1e-6)
    kw = dict(eye=[0.5, 0.4, -2.6], target=[0, 0, 0], up=[0, -1, 0],
              fovx=math.pi / 3, fovy=math.pi / 4, width=32, height=24)
    np.testing.assert_allclose(
        t_look_at(**kw, device="cpu").world_directions().numpy(),
        np.asarray(jcams.look_at_camera(**kw).world_directions()), atol=1e-6)


def test_pbr_model_functions_match(scene):
    state, _, _, _ = scene
    jp = jax.tree.map(jnp.asarray, state["params"])
    tp = TG.params_from_jax(state["params"], device="cpu")
    assert tp["radiance_ratio"].shape == ()
    for name in ("get_shading_normal", "get_base_color", "get_roughness",
                 "get_radiances"):
        np.testing.assert_allclose(getattr(TG, name)(tp).numpy(),
                                   np.asarray(getattr(JG, name)(jp)),
                                   atol=1e-6, err_msg=name)
    jup = JG.upgrade_to_pbr(JG.init_from_points(
        jnp.zeros((4, 3)), jnp.zeros((4, 3)), capacity=8,
        mean_sq_dist=jnp.ones(4)))
    tup = TG.upgrade_to_pbr(TG.init_from_points(
        np.zeros((4, 3)), np.zeros((4, 3)), capacity=8,
        mean_sq_dist=np.ones(4), device="cpu"))
    assert sorted(tup["params"]) == sorted(jup["params"])
    for k, v in tup["params"].items():
        assert tuple(v.shape) == jup["params"][k].shape, k
    back = TG.params_to_numpy(tp)
    assert back["radiance_ratio"].shape == () and \
        float(back["radiance_ratio"]) == pytest.approx(0.9)
    assert toptim.group_lrs(TOpt(), 2.0, use_pbr=True) == \
        joptim.group_lrs(JOpt(), 2.0, True)
    assert toptim.group_lrs(TOpt(), 2.0) == joptim.group_lrs(JOpt(), 2.0,
                                                             False)


# ---------------------------------------------------------------------------
# the forward render, image by image
# ---------------------------------------------------------------------------

TRAIN_KEYS = ("render", "depth", "opacity", "pbr", "base_color", "roughness",
              "diffuse", "local_lights", "visibility", "normal",
              "pseudo_normal")
EVAL_KEYS = ("render", "depth", "opacity", "pbr", "base_color", "roughness",
             "lights", "local_lights", "visibility", "direct", "indirect",
             "normal", "render_env", "pbr_env", "env_only")


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_render_view_svgss_matches(scene, training):
    state, bake, env, img = scene
    jcam, jb, jp, jenv = _jax_side(*scene)
    tcam, tb, tp, tenv, alive = _port_side(*scene)
    jcfg, tcfg = JCfg(max_instances=1 << 14), TCfg(max_instances=1 << 14)
    jr = jax.jit(lambda p, e: j_render_view(
        jcam, p, jb, e, jnp.zeros(3), is_training=training,
        alive=state["alive"], cfg=jcfg))(jp, jenv)
    with torch.no_grad():
        tr = t_render_view(tcam, tp, tb, tenv, torch.zeros(3),
                           is_training=training, alive=alive, cfg=tcfg)
    assert not bool(tr["overflow"]) and not bool(jr["overflow"])
    assert float(tr["opacity"].max()) > 0.5
    for k in (TRAIN_KEYS if training else EVAL_KEYS):
        a, b = tr[k].numpy(), np.asarray(jr[k])
        assert a.shape == b.shape, k
        if k == "depth":
            np.testing.assert_allclose(a, b, rtol=5e-4, err_msg=k)
        elif k == "pseudo_normal":
            np.testing.assert_allclose(a, b, atol=5e-3, err_msg=k)
        else:
            f = 2 if k in ("direct", "indirect") else 1
            np.testing.assert_allclose(a, b, atol=f * 2e-4, err_msg=k)
    np.testing.assert_allclose(tr["env"].numpy(), np.asarray(jr["env"]),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def test_step_loss_and_terms_match(stepped):
    j, t = stepped["j"], stepped["t"]
    assert t["loss"] == pytest.approx(float(j["tb"]["loss"]), abs=1e-5)
    assert sorted(t["tb"]) == sorted(j["tb"])
    for k in j["tb"]:
        assert float(t["tb"][k]) == pytest.approx(float(j["tb"][k]),
                                                  abs=1e-5), k
    assert not bool(t["tb"]["overflow"])


@pytest.mark.parametrize("name", GROUPS + ("env",))
def test_step_gradients_match(stepped, name):
    j, t = stepped["j"], stepped["t"]
    _rel(t["grads"][name], j["grads"][name], 2.5e-3, name)


@pytest.mark.parametrize("name", GROUPS + ("env",))
def test_step_adam_moments_and_params_match(stepped, name):
    j, t = stepped["j"], stepped["t"]
    if name == "env":
        jo, to = j["env"]["opt"], t["env"]["opt"]
        jnew, tnew = j["env"]["params"], t["env"]["params"]
        lr = TOpt(**OPT_KW).env_lr
    else:
        jo, to = j["ost"], t["ost"]
        jnew, tnew = j["new"]["params"], t["new"]["params"]
        lr = {**toptim.group_lrs(TOpt(**OPT_KW), 1.0, True), "xyz": XYZ_LR,
              "radiances": RAD_LR}[name]
    _rel(to["m"][name].numpy(), jo["m"][name], 2.5e-3, name)
    _rel(to["v"][name].numpy(), jo["v"][name], 5e-3, name)
    assert to["step"] == int(jo["step"]) == 1
    g = np.asarray(j["grads"][name])
    strong = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
    a, b = tnew[name].numpy(), np.asarray(jnew[name])
    np.testing.assert_allclose(a[strong], b[strong], atol=1e-7, rtol=1e-6)
    assert np.abs(a - b).max() <= 2 * lr * (1 + 1e-5)


def test_step_reaches_the_env_and_the_ratio(stepped):
    """The env map and the radiance ratio train through the PBR loss; the
    groups no loss reads keep zero moments."""
    t = stepped["t"]
    assert np.abs(t["grads"]["env"]).max() > 0
    assert abs(float(t["grads"]["radiance_ratio"])) > 0
    for k in ("incidents_dc", "incidents_rest", "visibility_dc",
              "visibility_rest", "radiances"):
        assert float(t["ost"]["m"][k].abs().max()) == 0.0, k
