"""The per-Gaussian row sums of the rasterizer's custom-gradient boundary
(``ops/rasterizer.py`` ``_gaussian_rows`` and ``_gaussian_weights``; on the
card the kernel R1 of ``csrc/gaussian_rows.cu``).

* On the CPU both take ``index_add_`` over the instances' Gaussian ids, as
  before the lists existed, bit for bit, and launch nothing; the sum over
  the per-Gaussian instance lists in list order (R1's algorithm, here in
  numpy) equals it bit for bit, on the synthetic lists of
  ``tests/torch_kernel_inputs.gaussian_rows_inputs`` (``test_torch_binning``
  and ``test_torch_sort_binner`` hold it on the binners' own lists).
* R1's wrapper refuses CPU tensors and what the kernel does not take
  (``test_torch_kernels``).
* On a CUDA device (marked ``card``, skipped here): R1 against
  ``index_add_`` on the CPU, bit for bit, at K = 1, 21 and 77 on the
  recipe's size, with dropped entries and on empty lists, and the same on
  two launches; a stage-1 and a stage-2 render's gradients through R1
  against the same through ``index_add_`` on the card (float32 atomics)
  within float32 rounding.  On the card, without JAX: ``python -m pytest
  --noconftest -o addopts= -p no:cacheprovider
  tests/test_torch_gaussian_rows.py -m card``.

Imports no JAX: its card tests run on a machine without it.
"""

import math

import numpy as np
import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import RasterConfig
from svgir_tpu_torch.kernels import gaussian_rows as KR
from svgir_tpu_torch.ops import rasterizer as R
from svgir_tpu_torch.utils.transforms import normal_to_rotation, normalize

# by its own name, not as ``tests.torch_kernel_inputs``: another ``tests``
# package installed on the card's machine takes that name
from torch_kernel_inputs import (ROWS_CASES, gaussian_rows_inputs,
                                 list_entries, list_gaussian_id, list_sums)

CPU_ROWS = 3000


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
        pytest.skip("needs a CUDA device: the kernel of "
                    "csrc/gaussian_rows.cu runs only there")
    return torch.device("cuda:0")


def index_add(d_inst, gid, n):
    """The route before the lists: ``index_add_`` over the instances'
    Gaussian ids, padding slots into row n."""
    idx = torch.where(gid >= 0, gid, n).long()
    out = d_inst.new_zeros(n + 1, d_inst.shape[1])
    out.index_add_(0, idx, d_inst)
    return out


def _inputs(name, n=None, seed=0):
    d, lists, slot = gaussian_rows_inputs(name, seed=seed, n=n)
    gid = list_gaussian_id(lists, slot, d.shape[0])
    return (torch.from_numpy(d), torch.from_numpy(lists),
            torch.from_numpy(slot), torch.from_numpy(gid))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_cpu_route_is_index_add_and_equals_the_list_sums(name):
    """``_gaussian_rows`` and ``_gaussian_weights`` on CPU tensors: the old
    ``index_add_`` bit for bit, no launch; R1's sum over the lists equals
    it bit for bit on every Gaussian's row."""
    d, lists, slot, gid = _inputs(name, n=CPU_ROWS)
    n = lists.shape[0]
    idx = torch.where(gid >= 0, gid, n).long()
    kernels.reset_launches()
    rows = R._gaussian_rows(d, idx, (lists, slot), n)
    weights = R._gaussian_weights(d[:, 0].contiguous(), idx, (lists, slot), n)
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}
    assert torch.equal(_bits(rows), _bits(index_add(d, gid, n)))
    assert torch.equal(_bits(weights),
                       _bits(index_add(d[:, :1], gid, n)[:n, 0]))
    sums = torch.from_numpy(list_sums(d.numpy(), lists.numpy(),
                                      slot.numpy()))
    assert torch.equal(_bits(sums[:n]), _bits(rows[:n]))
    assert not bool(sums[n].any())
    if name == "empty":
        assert not bool(rows[:n].any())
    if name == "k77_dropped":
        # the inputs drop raw instances past R and slots past M
        kept = list_entries(lists.numpy(), slot.numpy(), d.shape[0])[0].size
        assert kept < int(lists[:, 1].sum())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("name", sorted(ROWS_CASES))
def test_kernel_equals_index_add_on_the_cpu(card, name):
    """R1 at the recipe's size against ``index_add_`` on the CPU, bit for
    bit on every Gaussian's row, row N zero; two launches bit-equal."""
    d, lists, slot, gid = _inputs(name)
    n = lists.shape[0]
    want = index_add(d, gid, n)[:n]
    args = [t.to(card) for t in (d, lists, slot)]
    kernels.reset_launches()
    got = KR.gaussian_rows(*args)
    again = KR.gaussian_rows(*args)
    torch.cuda.synchronize()
    assert kernels.launches()["gaussian_rows"] == 2
    assert got.shape == (n + 1, d.shape[1])
    assert torch.equal(_bits(got), _bits(again))
    got = got.cpu()
    assert not bool(got[n].any())
    assert torch.equal(_bits(got[:n]), _bits(want))


def _scene(dev, stage, n=4000, res=96, seed=4):
    """Surfels on a sphere before a close camera (as ``chip_smoke.py``'s
    small scene), at stage 1's widths (CA 9, K 21) or stage 2's (4
    features and 13 vertex features: CA 13, CV 13, K 77)."""
    g = torch.Generator().manual_seed(seed)
    dirs = normalize(torch.randn(n, 3, generator=g))
    sc = dict(means=dirs.clone(), quats=normal_to_rotation(dirs),
              scales=torch.exp(torch.randn(n, 3, generator=g) * 0.3) * 0.12,
              opacity=0.2 + 0.6 * torch.rand(n, generator=g),
              colors=torch.rand(n, 3, generator=g))
    if stage == 2:
        sc["features"] = torch.rand(n, 4, generator=g)
        sc["vfeatures"] = torch.rand(n, 52, generator=g)
    cam = look_at_camera(eye=[0.3, 0.2, -1.8], target=[0, 0, 0],
                         up=[0, -1, 0], fovx=math.pi / 3, fovy=math.pi / 3,
                         width=res, height=res, device=dev)
    return {k: v.to(dev) for k, v in sc.items()}, cam


def _render(sc, cam, stage, dev, seed=5):
    """The render's outputs (the weight sums last in stage 1) and the
    gradients of a random linear loss of them."""
    leaves = {k: v.clone().requires_grad_(True) for k, v in sc.items()}
    bufs = R.rasterize(
        leaves["means"], leaves["scales"], leaves["quats"],
        leaves["opacity"], cam, torch.zeros(3, device=dev),
        colors=leaves["colors"], features=leaves.get("features"),
        vfeatures=leaves.get("vfeatures"),
        cfg=RasterConfig(max_instances=1 << 17),
        weights_grad=stage == 1, need_weights=stage == 1)
    assert not bool(bufs.overflow)
    outs = [bufs.color, bufs.normal, bufs.depth, bufs.opacity]
    outs += [bufs.weights] if stage == 1 else [bufs.feature, bufs.vfeature]
    g = torch.Generator().manual_seed(seed)
    loss = sum((o * torch.randn(o.shape, generator=g).to(dev)).sum()
               for o in outs)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return [o.detach() for o in outs], dict(zip(names, grads))


@pytest.mark.card
@pytest.mark.parametrize("stage", [1, 2])
def test_render_gradients_through_the_kernel_match_index_add(card, stage,
                                                             monkeypatch):
    """A stage-1 render (the weight sums and their cotangent: K 1 and 21)
    and a stage-2 render (K 77) through R1 against the same through
    ``index_add_`` on the card, whose float32 atomics add in a varying
    order: the image outputs bit-equal, the weight sums and every gradient
    within 1e-5 of its largest magnitude."""
    sc, cam = _scene(card, stage)
    kernels.reset_launches()
    outs, grads = _render(sc, cam, stage, card)
    torch.cuda.synchronize()
    assert kernels.launches()["gaussian_rows"] == (2 if stage == 1 else 1)

    def rows(d_inst, idx, lists, n):
        out = d_inst.new_zeros(n + 1, d_inst.shape[1])
        return out.index_add_(0, idx, d_inst)

    def weights(wsum, idx, lists, n):
        return rows(wsum[:, None], idx, lists, n)[:n, 0]
    monkeypatch.setattr(R, "_gaussian_rows", rows)
    monkeypatch.setattr(R, "_gaussian_weights", weights)
    kernels.reset_launches()
    outs_a, grads_a = _render(sc, cam, stage, card)
    torch.cuda.synchronize()
    assert kernels.launches()["gaussian_rows"] == 0
    images = len(outs) - (stage == 1)
    for a, b in zip(outs[:images], outs_a[:images]):
        assert torch.equal(a, b)
    pairs = list(zip(outs[images:], outs_a[images:])) + [
        (grads[k], grads_a[k]) for k in sorted(grads)]
    for got, want in pairs:
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= 1e-5 * scale
