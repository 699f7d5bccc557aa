"""The CUDA kernel wrappers of svgir_tpu_torch without a card: they refuse
what the kernels do not take, the ``ops`` dispatch sends CPU tensors to
the plain versions (and counts no launch), and the build fails loudly
where there is no nvcc.  The kernels themselves are checked against their
plain versions on the card by ``chip_smoke.py``.
"""

import pytest
import torch

from svgir_tpu_torch import kernels
from svgir_tpu_torch.kernels import binning as KB
from svgir_tpu_torch.kernels import blend as KBL
from svgir_tpu_torch.kernels import build
from svgir_tpu_torch.ops import binning_pallas, blend_pallas_strip


def _rects(ns=256):
    g = torch.Generator().manual_seed(0)
    x0 = torch.randint(0, 3, (ns,), generator=g, dtype=torch.int32)
    y0 = torch.randint(0, 3, (ns,), generator=g, dtype=torch.int32)
    return x0, y0, x0 + 1, y0 + 2


def test_binning_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        KB.counts(*_rects(), grid_x=4, grid_y=4, gauss_chunk=256)
    x0, y0, x1, y1 = _rects()
    z = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KB.instances(x0, y0, x1, y1, z, z, torch.zeros(1, 16, dtype=torch.int32),
                     torch.tensor(0, dtype=torch.int32), m=512, grid_x=4,
                     gauss_chunk=256)
    with pytest.raises(ValueError, match="multiple"):
        KB.counts(*(a[:100] for a in _rects()), grid_x=4, grid_y=4,
                  gauss_chunk=256)


@pytest.mark.parametrize("kw,match", [
    (dict(ca=14, cv=0, tile=32, kr=26), "CUDA"),
    (dict(ca=14, cv=0, tile=32, kr=27), "columns"),
    (dict(ca=40, cv=1, tile=32, kr=56), "channel bounds"),
    (dict(ca=14, cv=0, tile=12, kr=26), "multiple of 32"),
])
def test_blend_wrappers_refuse_bad_inputs(kw, match):
    slab = torch.zeros(128, kw["kr"])
    t = torch.zeros(4, dtype=torch.int32)
    args = dict(ca=kw["ca"], cv=kw["cv"], grid_x=2, grid_y=2, tile=kw["tile"],
                chunk=128)
    with pytest.raises(ValueError, match=match):
        KBL.blend_forward(slab, t, t, **args)
    img = torch.zeros(kw["ca"] + kw["cv"] + 2, 2 * kw["tile"], 2 * kw["tile"])
    with pytest.raises(ValueError, match=match):
        KBL.blend_backward(slab, t, t, img, img[0], None, **args)


def test_cpu_dispatch_runs_plain_versions_without_launches():
    kernels.reset_launches()
    ts, pc, total, carry = binning_pallas.compute_counts(
        *_rects(), grid_x=4, grid_y=4, chunk=128)
    _, carry_p = binning_pallas.counts_plain(*_rects(), grid_x=4,
                                                  grid_y=4)
    assert torch.equal(carry, carry_p)
    assert int(total) == int(pc.sum())
    slab = torch.zeros(128, 26)
    slab[:, 5] = 0.5                       # opacity; everything at (0, 0)
    slab[:, 2] = slab[:, 4] = 0.01
    t0 = torch.tensor([0, 128, 128, 128], dtype=torch.int32)
    tc = torch.tensor([128, 0, 0, 0], dtype=torch.int32)
    img, eff, wsum = blend_pallas_strip.blend_forward(
        slab, t0, tc, ca=14, cv=0, grid_x=2, grid_y=2, tile=16, chunk=128)
    assert eff.tolist() == [1, 0, 0, 0]
    assert img.shape == (16, 32, 32) and float(wsum.sum()) > 0
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}


def test_plain_forward_counts_the_work_of_its_inputs():
    """The blend's work counts (used for the kernels' bounds) cover only the
    real rows of processed chunks; blended pairs are exactly n_contrib."""
    g = torch.Generator().manual_seed(3)
    tile, chunk, gx, gy = 16, 128, 2, 2
    slab = torch.zeros(4 * chunk, 26)
    real = torch.rand(4 * chunk, generator=g) < 0.7       # the rest: padding
    n = int(real.sum())
    slab[real, 0:2] = torch.rand(n, 2, generator=g) * 2 * tile
    slab[real, 2] = slab[real, 4] = 0.02 + 0.05 * torch.rand(n, generator=g)
    slab[real, 5] = 0.3 + 0.69 * torch.rand(n, generator=g)
    slab[real, 12:] = torch.rand(n, 14, generator=g)
    ts = torch.tensor([0, 256, 384, 512], dtype=torch.int32)
    tc = torch.tensor([256, 128, 128, 0], dtype=torch.int32)
    work = {}
    img, eff, _ = blend_pallas_strip.blend_forward_plain(
        slab, ts, tc, ca=14, cv=0, grid_x=gx, grid_y=gy, tile=tile,
        chunk=chunk, work=work)
    done = [r for t in range(4)
            for r in range(int(ts[t]), int(ts[t]) + int(eff[t]) * chunk)]
    assert int(eff.sum()) >= 3
    assert work["rows"] == int(real[done].sum())
    assert work["pairs"] == work["rows"] * tile * tile
    assert work["gated"] == int(img[15].sum())            # n_contrib
    assert 0 < work["gated"] < work["ok"] < work["pairs"]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert sorted(build._targets()) == ["binning", "blend_backward",
                                        "blend_forward", "env_lookup"]
    assert not (tmp_path / "_build").exists() or \
        not list((tmp_path / "_build").glob("*.so"))


def test_unsupported_device_is_refused():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        binning_pallas.compute_counts(t, t, t, t, grid_x=2, grid_y=2,
                                      chunk=128, gauss_chunk=4)
    with pytest.raises(ValueError, match="unsupported device"):
        blend_pallas_strip.blend_forward(
            torch.zeros(128, 26, device="meta"), t, t, ca=14, cv=0,
            grid_x=2, grid_y=2, tile=16, chunk=128)
