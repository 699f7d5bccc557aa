"""svgir_tpu_torch.ops.preprocess against svgir_tpu.ops.preprocess: every
``Preprocessed`` field and the vector-Jacobian product.

``test_preprocess_matches_jax_in_float64`` runs both in float64 on
``tests/torch_kernel_inputs``' preprocess rows (every branch the kernel
pair P1 templates, random rows and rows built to meet the edges): integer
fields equal, float fields and gradients within 1e-12 of each one's
largest magnitude, the SH gradient on the row whose rgb sits exactly on
the clamp at 0 twice JAX's (ROADMAP hazard 14).  The tests below it run
float32 inputs.

Inputs are seeded numpy arrays fed to both packages on the CPU.  Integer
fields (valid, radius, rects, tiles_touched) must be equal.  Float fields
are held to 1e-5 relative (float32 math in a different association order
through the matrix products), except the local-homography map ``jinv``:
it differences rays offset by 1/1000 of a pixel unit, which cancels about
three digits, so it is held to 2e-4 of its largest magnitude.  The VJP is held to 1e-4 of each gradient's
largest magnitude, for the same reason, amplified by the divisions of the
EWA and local-homography chains.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.cameras import look_at_camera as j_look_at
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops.preprocess import preprocess as j_preprocess

from svgir_tpu_torch.cameras import look_at_camera as t_look_at
from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops.preprocess import Preprocessed
from svgir_tpu_torch.ops.preprocess import preprocess as t_preprocess
from svgir_tpu_torch.utils import sh as sh_utils

from tests.torch_kernel_inputs import (PREP_CASE_IDS, PREP_CASES,
                                       PREP_EDGE_ROWS, prep_camera,
                                       prep_cotangents, prep_kw, prep_rows)


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


INT_FIELDS = ("valid", "radius", "rect_min", "rect_max", "tiles_touched")
FLOAT_FIELDS = ("mean2d", "depth", "conic", "normal_view", "jinv", "lam",
                "rgb", "view_cos")


def _scene(seed, n=200):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = (d * rng.uniform(0.6, 1.2, (n, 1))).astype(np.float32)
    # half the quats face the camera-ish, the rest random: both culls fire
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.6, (n, 3))).astype(np.float32)
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    return dict(means=means, quats=quats, scales=scales, shs=shs)


def _j(sc):
    return {k: jnp.asarray(v) for k, v in sc.items()}


def _cams(w, h):
    kw = dict(eye=[0.5, 0.4, -2.6], target=[0, 0, 0], up=[0, -1, 0],
              fovx=math.pi / 3, fovy=math.pi / 3, width=w, height=h)
    return j_look_at(**kw), t_look_at(**kw, device="cpu")


def _kw(cam, cfg_kw, active):
    return dict(width=cam.width, height=cam.height, tanfovx=cam.tanfovx,
                tanfovy=cam.tanfovy, focal_x=cam.focal_x,
                focal_y=cam.focal_y, sh_degree=3, active_sh_degree=active)


CASES = {
    "tile32_full_sh": (dict(), 64, 64, None),
    "tile16_nonsquare_ramp": (dict(tile=16), 72, 40, 1.0),
    "no_surface": (dict(surface=False), 48, 48, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_preprocess_fields_match(case):
    cfg_kw, w, h, active = CASES[case]
    sc = _scene(7)
    jc, tc = _cams(w, h)
    js = _j(sc)
    jp = j_preprocess(js["means"], js["scales"], js["quats"], jc.world_view,
                      jc.full_proj, jc.camera_center, shs=js["shs"],
                      cfg=JCfg(**cfg_kw), **_kw(jc, cfg_kw, active))
    tp = t_preprocess(*(torch.as_tensor(sc[k]) for k in
                        ("means", "scales", "quats")),
                      tc.world_view, tc.full_proj, tc.camera_center,
                      shs=torch.as_tensor(sc["shs"]), cfg=TCfg(**cfg_kw),
                      **_kw(tc, cfg_kw, active))
    assert int(np.asarray(jp.valid).sum()) > 0
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    valid = np.asarray(jp.valid)
    for f in FLOAT_FIELDS:
        a = getattr(tp, f).detach().numpy()[valid]
        b = np.asarray(getattr(jp, f))[valid]
        if f == "jinv":
            np.testing.assert_allclose(a, b, atol=2e-4 * np.abs(b).max(),
                                       err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f)


def test_preprocess_vjp_matches():
    sc = _scene(11, n=120)
    jc, tc = _cams(64, 64)
    rng = np.random.default_rng(3)
    js = _j(sc)
    jp = j_preprocess(js["means"], js["scales"], js["quats"], jc.world_view,
                      jc.full_proj, jc.camera_center, shs=js["shs"],
                      **_kw(jc, {}, None))
    cot = {f: rng.normal(size=getattr(jp, f).shape).astype(np.float32)
           for f in FLOAT_FIELDS}

    def j_loss(means, scales, quats, shs):
        p = j_preprocess(means, scales, quats, jc.world_view, jc.full_proj,
                         jc.camera_center, shs=shs, **_kw(jc, {}, None))
        v = p.valid.astype(jnp.float32)
        return sum(jnp.sum(getattr(p, f) * cot[f]
                           * v.reshape((-1,) + (1,) * (cot[f].ndim - 1)))
                   for f in FLOAT_FIELDS)

    jg = jax.grad(j_loss, argnums=(0, 1, 2, 3))(
        js["means"], js["scales"], js["quats"], js["shs"])

    args = [torch.as_tensor(sc[k]).requires_grad_(True)
            for k in ("means", "scales", "quats", "shs")]
    p = t_preprocess(*args[:3], tc.world_view, tc.full_proj,
                     tc.camera_center, shs=args[3], **_kw(tc, {}, None))
    v = p.valid.float()
    loss = sum((getattr(p, f) * torch.as_tensor(cot[f])
                * v.reshape((-1,) + (1,) * (cot[f].ndim - 1))).sum()
               for f in FLOAT_FIELDS)
    tg = torch.autograd.grad(loss, args)
    for name, a, b in zip(("means", "scales", "quats", "shs"), tg, jg):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-4,
                                   err_msg=name)


def _edges_met(out, cam, means, shs):
    """Each edge row of ``prep_rows(edges=True)`` meets its edge (float64
    outputs under the axis camera)."""
    out = Preprocessed(*(t.detach() for t in out))
    r = {name: k for k, name in enumerate(PREP_EDGE_ROWS)}
    pv = means + torch.tensor([0.0, 0.0, 3.0], dtype=torch.float64)
    px, py = out.mean2d[:, 0], out.mean2d[:, 1]
    lim = 1.3 * cam.tanfovx
    d0 = torch.stack([pv[:, 0] / pv[:, 2] + 1e-3, pv[:, 1] / pv[:, 2],
                      torch.ones_like(pv[:, 0])], -1)
    mod0 = d0.norm(dim=-1)
    graze = ((d0 / mod0[:, None]) * out.normal_view).sum(-1) / mod0
    dirs = means - cam.camera_center.to(torch.float64)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    v = sh_utils.eval_sh(0, shs.transpose(-1, -2)[..., :1], dirs) + 0.5
    return {
        "behind": bool(out.depth[r["behind"]] < 0),
        "outside": bool(px[r["outside"]] >= 1.2 * cam.width),
        "view_cos": abs(float(out.view_cos[r["view_cos"]]) + 0.01) < 1e-12,
        "grazing": abs(abs(float(graze[r["grazing"]])) - 0.01) < 1e-12,
        "tz0": float(out.depth[r["tz0"]]) == 0.0,
        "tx_past": float(pv[r["tx_past"], 0] / pv[r["tx_past"], 2]) > lim,
        "ty_past": float(-pv[r["ty_past"], 1] / pv[r["ty_past"], 2]) > lim,
        "rgb_at_0": float(v[r["rgb_clamp"], 0]) == 0.0
        and float(v[r["rgb_clamp"], 1]) < 0,
        "a_valid_row": bool(out.valid[r["plain"]]),
        "in_frame": bool(py[r["plain"]] > 0),
    }


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("case", PREP_CASES, ids=PREP_CASE_IDS)
def test_preprocess_matches_jax_in_float64(case, edges):
    _, cfg_kw, kind, degree, _, _, none = case
    cam = prep_camera(edges)
    rows = prep_rows(edges, degree)
    kw = prep_kw(cam, case)
    # the leaves: means, scales, quats and the colour source, if any
    n_src = {"sh": 1, "colors": 1, "none": 0}[kind]
    src = rows[3] if kind == "sh" else rows[4]
    leaves = [t.clone().requires_grad_(True) for t in rows[:3]
              + (src,) * n_src]

    def source(ts):
        return {"shs": ts[3]} if kind == "sh" else \
            {"colors": ts[3]} if kind == "colors" else {}

    cams = [t.double() for t in (cam.world_view, cam.full_proj,
                                 cam.camera_center)]
    out = t_preprocess(*leaves[:3], *cams, **source(leaves), **kw)
    if edges and kind == "sh":
        met = _edges_met(out, cam, rows[0], rows[3])
        assert all(met.values()), [k for k, v in met.items() if not v]
    cots, _ = prep_cotangents(out, edges, none=none)
    loss = sum((getattr(out, f) * c).sum()
               for f, c in zip(FLOAT_FIELDS, cots) if c is not None)
    grads = torch.autograd.grad(loss, leaves)

    with jax.enable_x64(True):
        jcams = [jnp.asarray(t.numpy()) for t in cams]
        jcot = {f: jnp.asarray(c.numpy())
                for f, c in zip(FLOAT_FIELDS, cots) if c is not None}
        jkw = dict(kw, cfg=JCfg(**cfg_kw))

        def jfn(*a):
            return j_preprocess(*a[:3], *jcams, **source(a), **jkw)

        def jloss(*a):
            p = jfn(*a)
            return sum(jnp.sum(getattr(p, f) * c) for f, c in jcot.items())

        jargs = [jnp.asarray(t.detach().numpy()) for t in leaves]
        jout = jfn(*jargs)
        jgrads = jax.grad(jloss, argnums=tuple(range(len(jargs))))(*jargs)
        jout = {f: np.asarray(getattr(jout, f)) for f in Preprocessed._fields}
        jgrads = [np.asarray(g) for g in jgrads]

    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(), jout[f],
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        a, b = getattr(out, f).detach().numpy(), jout[f]
        assert b.dtype == np.float64, f
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
        assert err < 1e-12, (f, err)
    names = ("d_means3d", "d_scales", "d_quats", "d_" + kind)
    for name, a, b in zip(names, grads, jgrads):
        a = a.numpy()
        if edges and kind == "sh":
            # rgb's red on the clamp at 0: torch.clamp passes the whole
            # gradient, jnp.maximum half of it
            r = PREP_EDGE_ROWS.index("rgb_clamp")
            if name == "d_sh":
                np.testing.assert_array_equal(a[r, :, 0] == 0,
                                              b[r, :, 0] == 0)
                b = b.copy()
                b[r, :, 0] *= 2
        scale = np.abs(b).max()
        assert scale > 0 or name == "d_sh" and case[4] == -1.0, name
        err = np.abs(a - b).max() / max(scale, 1e-300)
        assert err < 1e-12, (name, err)
