"""The rasterizer's preprocess (``svgir_tpu_torch.ops.preprocess.preprocess``,
the kernel pair P1 of ``csrc/preprocess.cu`` on the card) on the CPU.

* ``preprocess`` on CPU tensors: ``preprocess_forward_plain``'s outputs
  bit for bit, autograd's gradients through it bit for bit, no kernel
  launch (``tests/test_torch_preprocess.py`` holds that route to
  ``svgir_tpu`` in float64).  A camera tensor that asks for a gradient is
  refused; the kernel wrappers refuse CPU tensors.
* On a CUDA device (marked ``card``, skipped here): P1 against the plain
  forward in float64 and autograd's gradients through it, on the rows of
  ``tests/torch_kernel_inputs.py`` (``PREP_CASES``, every branch the
  kernel templates, on random rows and on rows built to meet the edges;
  rounded to float32): every float output and gradient within 1.5 times
  the float32 plain forward's and autograd's distance from them on the
  card, or 1e-6 of its largest magnitude; the integer outputs of the random rows
  equal to the float32 plain version's; one launch of each kernel.
  ``preprocess`` refuses CUDA tensors that are not float32.  On the card,
  without JAX: ``python -m pytest --noconftest -o addopts= -p
  no:cacheprovider tests/test_torch_preprocess_kernel.py -m card``.

Imports no JAX: its card test runs on a machine without it.
"""

import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.kernels import preprocess as KP
from svgir_tpu_torch.ops import preprocess as P

# by its own name, not as ``tests.torch_kernel_inputs``: another ``tests``
# package installed on the card's machine takes that name
from torch_kernel_inputs import (PREP_CASE_IDS, PREP_CASES, prep_camera,
                                 prep_cotangents, prep_kw, prep_rows)

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


def _camera_tensors(cam, dtype, device="cpu"):
    return [t.to(dtype=dtype, device=device) for t in (
        cam.world_view, cam.full_proj, cam.camera_center)]


def _source(case, shs, colors):
    kind = case[2]
    return dict(shs=shs if kind == "sh" else None,
                colors=colors if kind == "colors" else None)


def _loss(out, cots):
    return sum((getattr(out, f) * c).sum()
               for f, c in zip(P.FLOAT_FIELDS, cots) if c is not None)


@pytest.mark.parametrize(
    "case", [PREP_CASES[0], PREP_CASES[6], PREP_CASES[7], PREP_CASES[11]],
    ids=["sh3", "colors", "no_colour", "none_cotangents"])
def test_function_takes_the_plain_version_on_the_cpu(case):
    """preprocess on CPU float32 tensors: the plain forward bit for bit,
    autograd's gradients through it bit for bit, and no kernel launch."""
    cam = prep_camera(False)
    rows = [t.float() for t in prep_rows(False, case[3])]
    wv, fp, cp = cam.world_view, cam.full_proj, cam.camera_center
    kw = prep_kw(cam, case)
    plain = [t.clone().requires_grad_(True) for t in rows]
    want = P.preprocess_forward_plain(*plain[:3], wv, fp, cp,
                                      **_source(case, *plain[3:]), **kw)
    cots, _ = prep_cotangents(want, False, none=case[6])
    cots = [None if c is None else c.float() for c in cots]
    want_g = torch.autograd.grad(_loss(want, cots), plain, allow_unused=True)
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in rows]
    got = P.preprocess(*leaves[:3], wv, fp, cp, **_source(case, *leaves[3:]),
                       **kw)
    for f in P.Preprocessed._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a.detach(), b.detach()), f
    grads = torch.autograd.grad(_loss(got, cots), leaves, allow_unused=True)
    for a, b in zip(grads, want_g):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}


@pytest.mark.parametrize("name", ["world_view", "full_proj", "campos"])
def test_a_camera_gradient_is_refused(name):
    cam = prep_camera(False)
    means, scales, quats, shs, _ = (t.float() for t in prep_rows(False, 3))
    cams = dict(zip(("world_view", "full_proj", "campos"),
                    _camera_tensors(cam, torch.float32)))
    cams[name] = cams[name].clone().requires_grad_(True)
    with pytest.raises(ValueError, match=name):
        P.preprocess(means, scales, quats, cams["world_view"],
                     cams["full_proj"], cams["campos"], shs=shs,
                     **prep_kw(cam, PREP_CASES[0]))


def test_kernel_wrappers_refuse_cpu_tensors():
    cam = prep_camera(False)
    means, scales, quats, shs, _ = (t.float() for t in prep_rows(False, 3))
    wv, fp, cp = cam.world_view, cam.full_proj, cam.camera_center
    kw = P._kernel_kw(prep_kw(cam, PREP_CASES[0]), shs, None)
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
@pytest.mark.parametrize("case", PREP_CASES, ids=PREP_CASE_IDS)
def test_kernels_match_the_plain_version(card, case, edges):
    """P1's outputs and gradients against the plain forward in float64 and
    autograd's gradients through it, on the same (float32) rows: within
    1.5 times the distance of the float32 plain forward and autograd's
    gradients through it on the card from them, or 1e-6 of the largest
    magnitude; the random rows' integer outputs equal to the float32 plain
    version's; one launch of each kernel.  (Until the float32 yardstick was
    autograd's, it was the kernels' hand-derived mirror, held at 2x;
    autograd's lies up to 1.27x as far from float64 on these rows where
    the bar is above its floor, so 1.5 keeps every bar.)"""
    cam = prep_camera(edges)
    rows = [t.float() for t in prep_rows(edges, case[3])]
    kw = prep_kw(cam, case)
    wv, fp, cp = _camera_tensors(cam, F64)
    leaves64 = [t.double().requires_grad_(True) for t in rows]
    ref = P.preprocess_forward_plain(*leaves64[:3], wv, fp, cp,
                                     **_source(case, *leaves64[3:]), **kw)
    cots, _ = prep_cotangents(ref, edges, none=case[6])
    cots = [None if c is None else c.float().double() for c in cots]
    ref_g = torch.autograd.grad(_loss(ref, cots), leaves64, allow_unused=True)
    ref = P.Preprocessed(*(t.detach() for t in ref))

    rc = [t.to(card) for t in rows]
    wvc, fpc, cpc = _camera_tensors(cam, torch.float32, card)
    cc = [None if c is None else c.float().to(card) for c in cots]
    leaves32 = [t.clone().requires_grad_(True) for t in rc]
    f32 = P.preprocess_forward_plain(*leaves32[:3], wvc, fpc, cpc,
                                     **_source(case, *leaves32[3:]), **kw)
    f32_g = torch.autograd.grad(_loss(f32, cc), leaves32, allow_unused=True)
    f32 = P.Preprocessed(*(t.detach() for t in f32))
    kernels.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in rc]
    got = P.preprocess(*leaves[:3], wvc, fpc, cpc,
                       **_source(case, *leaves[3:]), **kw)
    grads = torch.autograd.grad(_loss(got, cc), leaves, allow_unused=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["preprocess_forward"] == 1
    assert kernels.LAUNCHES["preprocess_backward"] == 1

    def near(name, k, r, p):
        scale = max(float(r.abs().max()), 1e-30)
        e_k = float((k.double().cpu() - r).abs().max()) / scale
        e_p = float((p.double().cpu() - r).abs().max()) / scale
        assert e_k <= max(1.5 * e_p, 1e-6), (name, e_k, e_p)

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
    cam = prep_camera(False)
    rows = [t.double().to(card) for t in prep_rows(False, 3)]
    kw = prep_kw(cam, PREP_CASES[0])
    for dtype in (F64, torch.float32):
        wv, fp, cp = _camera_tensors(cam, dtype, card)
        kernels.reset_launches()
        with pytest.raises(ValueError, match="float32"):
            P.preprocess(*rows[:3], wv, fp, cp, shs=rows[3], **kw)
        assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
