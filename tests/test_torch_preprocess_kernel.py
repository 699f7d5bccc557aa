"""The rasterizer's preprocess as one autograd Function
(``svgir_tpu_torch.ops.preprocess.preprocess``, the kernel pair P1 of
``csrc/preprocess.cu`` on the card) on the CPU.

* Its plain backward (``preprocess_backward_plain``, the hand-derived
  backward as the kernel computes it) against autograd through
  ``preprocess_forward_plain``, in float64, on seeded random rows (N = 256,
  a rotated camera) and on rows built to meet the edges (an axis-aligned
  camera, so that p_view is exact): behind the camera, outside the 1.2x
  frustum, view_cos at -0.01, a grazing ray at the 0.01 threshold,
  p_view z exactly 0, x and y past 1.3 tan(fov / 2), rgb exactly at the
  clamp at 0 and below it, all-zero cotangents.  Over every branch the
  kernel templates: surface on and off, per-pixel depth on and off, SH
  degrees 0-4 with active degrees below them, ``colors``, no colour
  source, scale_modifier 1 and 0.5, and cotangents autograd passes as
  None.  Both compute the same float64 expressions: a few ulp.
* ``preprocess`` on CPU tensors: ``preprocess_forward_plain``'s outputs
  bit for bit, ``preprocess_backward_plain``'s gradients, no kernel
  launch.  A camera tensor that asks for a gradient is refused; the
  kernel wrappers refuse CPU tensors.
* On a CUDA device (marked ``card``, skipped here): P1 against the plain
  forward in float64 and autograd's gradients through it, on the same
  rows (rounded to float32): every float output and gradient within twice
  the float32 plain version's distance from them on the card, or 1e-6 of
  its largest magnitude; the integer outputs of the random rows equal to
  the float32 plain version's; one launch of each kernel.  ``preprocess``
  refuses CUDA tensors that are not float32.  On the card, without JAX: ``python -m pytest
  --noconftest -o addopts= -p no:cacheprovider
  tests/test_torch_preprocess_kernel.py -m card``.

Imports no JAX: its card test runs on a machine without it.
"""

import math

import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.kernels import preprocess as KP
from svgir_tpu_torch.ops import preprocess as P
from svgir_tpu_torch.utils import sh as sh_utils
from svgir_tpu_torch.utils.transforms import normal_to_rotation

N = 256
W_, H_ = 64, 48
F64 = torch.float64


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
        pytest.skip("needs a CUDA device: the kernels of csrc/preprocess.cu "
                    "run only there")
    return torch.device("cuda:0")


def _camera(edges: bool):
    eye = [0.0, 0.0, -3.0] if edges else [0.5, 0.4, -2.6]
    return look_at_camera(eye=eye, target=[0, 0, 0], up=[0, -1, 0],
                          fovx=math.pi / 3, fovy=math.pi / 3, width=W_,
                          height=H_, device="cpu")


def _unit(v):
    return v / v.norm()


def _facing(n_view):
    """A w-first quaternion whose rotation's third column is ``n_view`` (the
    axis camera's rotation is the identity)."""
    return normal_to_rotation(n_view[None])[0]


EDGE_ROWS = ("behind", "outside", "view_cos", "grazing", "tz0", "tx_past",
             "ty_past", "rgb_clamp", "zero_cot_a", "zero_cot_b", "plain")


def _edge_geometry():
    """(means, quats) of the edge rows under the axis camera (p_view = m +
    (0, 0, 3), W = I)."""
    t = torch.tensor([0.0, 0.0, 3.0], dtype=F64)
    pv = {"behind": [0.1, 0.1, -0.5], "outside": [4.0, 0.0, 3.0],
          "view_cos": [0.1, 0.05, 3.0], "grazing": [0.2, -0.1, 2.5],
          "tz0": [0.3, 0.2, 0.0], "tx_past": [2.0, 0.1, 1.0],
          "ty_past": [0.1, -2.0, 1.0], "rgb_clamp": [0.05, 0.0, 2.0],
          "zero_cot_a": [0.0, 0.1, 2.5], "zero_cot_b": [-0.1, 0.0, 2.8],
          "plain": [0.05, 0.02, 3.0]}
    means, quats = [], []
    for name in EDGE_ROWS:
        p = torch.tensor(pv[name], dtype=F64)
        if name == "view_cos":
            # n . p = -0.01
            u = _unit(torch.linalg.cross(p, torch.tensor([0.0, 1, 0],
                                                         dtype=F64)))
            a = -0.01 / float(p @ p)
            n = a * p + math.sqrt(1 - a * a * float(p @ p)) * u
        elif name == "grazing":
            # |(dir0 . n) / mod0| = 0.01 for the ray offset in x
            d0 = torch.tensor([p[0] / p[2] + 1e-3, p[1] / p[2], 1.0],
                              dtype=F64)
            mod0 = float(d0.norm())
            dir0 = d0 / mod0
            u = _unit(torch.linalg.cross(dir0, torch.tensor([0.0, 1, 0],
                                                            dtype=F64)))
            n = -0.01 * mod0 * dir0 + math.sqrt(1 - (0.01 * mod0) ** 2) * u
        else:
            n = _unit(torch.tensor([0.1, -0.2, -1.0], dtype=F64))
        means.append(p - t)
        quats.append(_facing(n) * 1.7)
    return torch.stack(means), torch.stack(quats)


def _dc_at(value: float) -> float:
    """A DC coefficient c with fl(c * C0) == value, in float64."""
    c = value / sh_utils.C0
    for _ in range(64):
        got = c * sh_utils.C0
        if got == value:
            return c
        c = math.nextafter(c, math.inf if got < value else -math.inf)
    raise AssertionError("no DC coefficient meets the value")


def _rows(edges: bool, degree: int, seed: int = 0):
    """(means, scales, quats, shs [N, K, 3] at K = (degree + 1)^2, colors)
    in float64."""
    g = torch.Generator().manual_seed(seed)
    k = (degree + 1) ** 2
    if edges:
        means, quats = _edge_geometry()
        n = means.shape[0]
    else:
        n = N
        d = torch.randn(n, 3, generator=g, dtype=F64)
        means = d / d.norm(dim=-1, keepdim=True) \
            * (0.6 + 0.6 * torch.rand(n, 1, generator=g, dtype=F64))
        quats = torch.randn(n, 4, generator=g, dtype=F64)
    scales = torch.exp(-3 + 0.6 * torch.randn(n, 3, generator=g, dtype=F64))
    shs = 0.3 * torch.randn(n, k, 3, generator=g, dtype=F64)
    colors = torch.rand(n, 3, generator=g, dtype=F64)
    if edges:
        r = EDGE_ROWS.index("rgb_clamp")
        shs[r] = 0
        shs[r, 0] = torch.tensor([_dc_at(-0.5), -0.7 / sh_utils.C0,
                                  0.4 / sh_utils.C0], dtype=F64)
    return means, scales, quats, shs, colors


def _cotangents(out, edges: bool, seed: int = 1, none=()):
    """Random cotangents of the float fields, zero on the zero_cot rows
    (and on the first rows of the random set); None for ``none``."""
    g = torch.Generator().manual_seed(seed)
    zero = [EDGE_ROWS.index("zero_cot_a"), EDGE_ROWS.index("zero_cot_b")] \
        if edges else [0, 1, 2]
    cots = []
    for f in P.FLOAT_FIELDS:
        if f in none:
            cots.append(None)
            continue
        x = getattr(out, f)
        c = torch.randn(x.shape, generator=g, dtype=x.dtype)
        c[zero] = 0
        cots.append(c)
    return cots, zero


# (name, cfg, colour source, SH degree, active SH degree, scale_modifier,
#  fields whose cotangent is None)
CASES = [
    ("sh3", {}, "sh", 3, None, 1.0, ()),
    ("sh3_active1_half_scale", {}, "sh", 3, 1.0, 0.5, ()),
    ("sh2_active0", {}, "sh", 2, 0.0, 1.0, ()),
    ("sh1_active_none", {}, "sh", 1, -1.0, 1.0, ()),
    ("sh0", {}, "sh", 0, None, 0.5, ()),
    ("sh4_active2", {}, "sh", 4, 2.5, 1.0, ()),
    ("colors", {}, "colors", 3, None, 1.0, ()),
    ("no_colour", {}, "none", 3, None, 1.0, ("rgb",)),
    ("no_surface", dict(surface=False), "sh", 3, None, 1.0, ()),
    ("no_surface_half_scale", dict(surface=False), "sh", 2, None, 0.5, ()),
    ("no_per_pixel_depth", dict(per_pixel_depth=False), "sh", 3, 2.0, 1.0,
     ()),
    ("none_cotangents", {}, "sh", 3, None, 1.0,
     ("view_cos", "normal_view", "depth")),
]
CASE_IDS = [c[0] for c in CASES]


def _kw(cam, case):
    _, cfg, _, degree, active, mod, _ = case
    return dict(width=cam.width, height=cam.height, tanfovx=cam.tanfovx,
                tanfovy=cam.tanfovy, focal_x=cam.focal_x, focal_y=cam.focal_y,
                sh_degree=degree, active_sh_degree=active,
                scale_modifier=mod, cfg=RasterConfig(**cfg))


def _camera_tensors(cam, dtype, device="cpu"):
    return [t.to(dtype=dtype, device=device) for t in (
        cam.world_view, cam.full_proj, cam.camera_center)]


def _source(case, shs, colors):
    kind = case[2]
    return dict(shs=shs if kind == "sh" else None,
                colors=colors if kind == "colors" else None)


def _edges_met(out, cam, means, shs):
    """Each edge row meets its edge (float64 outputs under the axis
    camera)."""
    out = P.Preprocessed(*(t.detach() for t in out))
    r = {name: k for k, name in enumerate(EDGE_ROWS)}
    pv = means + torch.tensor([0.0, 0.0, 3.0], dtype=F64)
    px, py = out.mean2d[:, 0], out.mean2d[:, 1]
    lim = 1.3 * cam.tanfovx
    d0 = torch.stack([pv[:, 0] / pv[:, 2] + 1e-3, pv[:, 1] / pv[:, 2],
                      torch.ones_like(pv[:, 0])], -1)
    mod0 = d0.norm(dim=-1)
    graze = ((d0 / mod0[:, None]) * out.normal_view).sum(-1) / mod0
    dirs = means - cam.camera_center.to(F64)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    v = sh_utils.eval_sh(0, shs.transpose(-1, -2)[..., :1], dirs) + 0.5
    return {
        "behind": bool(out.depth[r["behind"]] < 0),
        "outside": bool(px[r["outside"]] >= 1.2 * W_),
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
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_backward_matches_autograd_in_float64(case, edges):
    cam = _camera(edges)
    means, scales, quats, shs, colors = _rows(edges, case[3])
    wv, fp, cp = _camera_tensors(cam, F64)
    kw = _kw(cam, case)
    leaves = [t.clone().requires_grad_(True)
              for t in (means, scales, quats, shs, colors)]
    out = P.preprocess_forward_plain(*leaves[:3], wv, fp, cp,
                                     **_source(case, *leaves[3:]), **kw)
    if edges and case[2] == "sh":
        met = _edges_met(out, cam, means, shs)
        assert all(met.values()), [k for k, v in met.items() if not v]
    cots, zero = _cotangents(out, edges, none=case[6])
    loss = sum((getattr(out, f) * c).sum()
               for f, c in zip(P.FLOAT_FIELDS, cots) if c is not None)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = P.preprocess_backward_plain(means, scales, quats, wv, fp, cp, cots,
                                      **_source(case, shs, colors), **kw)
    names = ("d_means3d", "d_scales", "d_quats", "d_shs", "d_colors")
    for name, a, b in zip(names, got, want):
        if a is None:
            assert b is None, name
            continue
        b = torch.zeros_like(a) if b is None else b
        assert a.shape == b.shape and a.dtype == F64, name
        scale = float(b.abs().max())
        # every band masked: no SH gradient
        assert scale > 0 or name == "d_shs" and case[4] == -1.0, name
        err = float((a - b).abs().max()) / max(scale, 1e-300)
        assert err < 1e-12, (name, err)
        # the rows with no cotangent get exact zeros
        assert bool((a[zero] == 0).all()), name
    assert (got[3] is None) == (case[2] != "sh")
    assert (got[4] is None) == (case[2] != "colors")


@pytest.mark.parametrize("case", [CASES[0], CASES[6], CASES[7], CASES[11]],
                         ids=["sh3", "colors", "no_colour", "none_cotangents"])
def test_function_takes_the_plain_version_on_the_cpu(case):
    """preprocess on CPU float32 tensors: the plain forward bit for bit, the
    plain backward's gradients bit for bit, and no kernel launch."""
    cam = _camera(False)
    rows = [t.float() for t in _rows(False, case[3])]
    wv, fp, cp = cam.world_view, cam.full_proj, cam.camera_center
    kw = _kw(cam, case)
    want = P.preprocess_forward_plain(*rows[:3], wv, fp, cp,
                                      **_source(case, *rows[3:]), **kw)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in rows]
    got = P.preprocess(*leaves[:3], wv, fp, cp, **_source(case, *leaves[3:]),
                       **kw)
    for f in P.Preprocessed._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a.detach(), b), f
    cots, _ = _cotangents(want, False, none=case[6])
    loss = sum((getattr(got, f) * c.float()).sum()
               for f, c in zip(P.FLOAT_FIELDS, cots) if c is not None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    plain = P.preprocess_backward_plain(
        *rows[:3], wv, fp, cp,
        [None if c is None else c.float() for c in cots],
        **_source(case, *rows[3:]), **kw)
    for a, b in zip(grads, plain):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}


@pytest.mark.parametrize("name", ["world_view", "full_proj", "campos"])
def test_a_camera_gradient_is_refused(name):
    cam = _camera(False)
    means, scales, quats, shs, _ = (t.float() for t in _rows(False, 3))
    cams = dict(zip(("world_view", "full_proj", "campos"),
                    _camera_tensors(cam, torch.float32)))
    cams[name] = cams[name].clone().requires_grad_(True)
    with pytest.raises(ValueError, match=name):
        P.preprocess(means, scales, quats, cams["world_view"],
                     cams["full_proj"], cams["campos"], shs=shs,
                     **_kw(cam, CASES[0]))


def test_kernel_wrappers_refuse_cpu_tensors():
    cam = _camera(False)
    means, scales, quats, shs, _ = (t.float() for t in _rows(False, 3))
    wv, fp, cp = cam.world_view, cam.full_proj, cam.camera_center
    kw = P._kernel_kw(_kw(cam, CASES[0]), shs, None)
    with pytest.raises(ValueError, match="CUDA"):
        KP.preprocess_forward(means, scales, quats, wv, fp, cp, shs, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        KP.preprocess_backward(means, scales, quats, wv, fp, cp, shs,
                               [None] * 8, **kw)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernels_match_the_plain_version(card, case, edges):
    """P1's outputs and gradients against the plain forward in float64 and
    autograd's gradients through it, on the same (float32) rows: within
    twice the float32 plain version's distance from them on the card, or
    1e-6 of the largest magnitude; the random rows' integer outputs equal
    to the float32 plain version's; one launch of each kernel."""
    cam = _camera(edges)
    rows = [t.float() for t in _rows(edges, case[3])]
    kw = _kw(cam, case)
    wv, fp, cp = _camera_tensors(cam, F64)
    leaves64 = [t.double().requires_grad_(True) for t in rows]
    ref = P.preprocess_forward_plain(*leaves64[:3], wv, fp, cp,
                                     **_source(case, *leaves64[3:]), **kw)
    cots, _ = _cotangents(ref, edges, none=case[6])
    cots = [None if c is None else c.float().double() for c in cots]
    ref_loss = sum((getattr(ref, f) * c).sum()
                   for f, c in zip(P.FLOAT_FIELDS, cots) if c is not None)
    ref_g = torch.autograd.grad(ref_loss, leaves64, allow_unused=True)
    ref = P.Preprocessed(*(t.detach() for t in ref))

    rc = [t.to(card) for t in rows]
    wvc, fpc, cpc = _camera_tensors(cam, torch.float32, card)
    cc = [None if c is None else c.float().to(card) for c in cots]
    f32 = P.preprocess_forward_plain(*rc[:3], wvc, fpc, cpc,
                                     **_source(case, *rc[3:]), **kw)
    f32_g = P.preprocess_backward_plain(*rc[:3], wvc, fpc, cpc, cc,
                                        **_source(case, *rc[3:]), **kw)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in rc]
    got = P.preprocess(*leaves[:3], wvc, fpc, cpc,
                       **_source(case, *leaves[3:]), **kw)
    loss = sum((getattr(got, f) * c).sum()
               for f, c in zip(P.FLOAT_FIELDS, cc) if c is not None)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["preprocess_forward"] == 1
    assert kernels.LAUNCHES["preprocess_backward"] == 1

    def near(name, k, r, p):
        scale = max(float(r.abs().max()), 1e-30)
        e_k = float((k.double().cpu() - r).abs().max()) / scale
        e_p = float((p.double().cpu() - r).abs().max()) / scale
        assert e_k <= max(2 * e_p, 1e-6), (name, e_k, e_p)

    for f in P.FLOAT_FIELDS:
        near(f, getattr(got, f).detach(), getattr(ref, f), getattr(f32, f))
    if not edges:
        for f in P.INT_FIELDS:
            assert torch.equal(getattr(got, f), getattr(f32, f)), f
    for name, k, r, p in zip(("d_means3d", "d_scales", "d_quats", "d_shs",
                              "d_colors"), grads, ref_g, f32_g):
        assert (k is None) == (p is None), name
        if k is not None:
            near(name, k, torch.zeros_like(p.cpu(), dtype=F64)
                 if r is None else r, p)


@pytest.mark.card
def test_preprocess_refuses_cuda_tensors_that_are_not_float32(card):
    """A CUDA tensor of another dtype goes to P1's wrappers, which refuse
    it: no plain route on the card."""
    cam = _camera(False)
    rows = [t.double().to(card) for t in _rows(False, 3)]
    kw = _kw(cam, CASES[0])
    for dtype in (F64, torch.float32):
        wv, fp, cp = _camera_tensors(cam, dtype, card)
        kernels.reset_launches()
        with pytest.raises(ValueError, match="float32"):
            P.preprocess(*rows[:3], wv, fp, cp, shs=rows[3], **kw)
        assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
