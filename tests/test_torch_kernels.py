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
from svgir_tpu_torch.kernels import cols as KC
from svgir_tpu_torch.kernels import env_lookup as KE
from svgir_tpu_torch.kernels import gaussian_rows as KR
from svgir_tpu_torch.kernels import march as KM
from svgir_tpu_torch.ops import binning_pallas, blend_pallas, blend_pallas_strip


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


@pytest.mark.parametrize("kw,match", [
    (dict(ca=14, cv=0, tile=32, kr=26), "CUDA"),
    (dict(ca=14, cv=0, tile=32, kr=27), "columns"),
    (dict(ca=40, cv=1, tile=32, kr=56), "channel bounds"),
    (dict(ca=14, cv=0, tile=12, kr=26), "multiple of 32"),
])
def test_tile_blend_wrappers_refuse_bad_inputs(kw, match):
    slab = torch.zeros(128, kw["kr"])
    t = torch.zeros(4, dtype=torch.int32)
    args = dict(ca=kw["ca"], cv=kw["cv"], grid_x=2, grid_y=2, tile=kw["tile"],
                chunk=128)
    with pytest.raises(ValueError, match=match):
        KBL.blend_forward_tiles(slab, t, t, **args)
    g_out = torch.zeros(4, kw["ca"] + kw["cv"] + 3, kw["tile"] ** 2)
    with pytest.raises(ValueError, match=match):
        KBL.blend_backward_tiles(slab, t, g_out, g_out[:, :3], None,
                                 **args)


@pytest.mark.parametrize("fn", [KC.pad_cols, KC.slice_cols])
def test_cols_wrappers_refuse_cpu_tensors(fn):
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros(1024, 24), 64 if fn is KC.pad_cols else 16)
    with pytest.raises(ValueError, match="2-D"):
        fn(torch.zeros(1024), 16)


def _march_args(k=16):
    f, i = torch.zeros, torch.int32
    return (f(2, 32 * KM.BLK), f(8, dtype=i), f(8, dtype=i), f(4, 3),
            f(4, 3)), dict(lo=f(3), inv_cell=torch.ones(3), res=2,
                           dt=torch.tensor(0.1), t_max=1.0, n_steps=4,
                           kmax=1, cap=64, k=k)


_u8 = torch.zeros(8)
REFUSALS = {
    "counts_cpu": (lambda: KB.counts(*_rects(), grid_x=4, grid_y=4,
                                     gauss_chunk=256), "CUDA"),
    "counts_ns": (lambda: KB.counts(*(a[:100] for a in _rects()), grid_x=4,
                                    grid_y=4, gauss_chunk=256), "multiple"),
    "counts_empty_grid": (lambda: KB.counts(*_rects(), grid_x=0, grid_y=4,
                                            gauss_chunk=256), "tile grid"),
    # grids and envs past a block's shared memory are taken (by bands, in
    # place): the call goes on to the device check
    "counts_grid_past_smem": (lambda: KB.counts(
        *_rects(), grid_x=300, grid_y=200, gauss_chunk=256), "CUDA"),
    "env_forward_cpu": (lambda: KE.env_lookup_forward(
        torch.zeros(16, 32, 3), _u8, _u8), "CUDA"),
    "env_forward_past_smem": (lambda: KE.env_lookup_forward(
        torch.zeros(128, 256, 3), _u8, _u8), "CUDA"),
    "env_forward_one_row": (lambda: KE.env_lookup_forward(
        torch.zeros(1, 32, 3), _u8, _u8), "H >= 2"),
    "env_backward_cpu": (lambda: KE.env_lookup_backward(
        _u8, _u8, torch.zeros(8, 3), h=16, w=32), "CUDA"),
    "env_backward_past_smem": (lambda: KE.env_lookup_backward(
        _u8, _u8, torch.zeros(8, 3), h=128, w=256), "CUDA"),
    "env_backward_no_channel": (lambda: KE.env_lookup_backward(
        _u8, _u8, torch.zeros(8, 0), h=16, w=32), "C >= 1"),
    "march_cpu": (lambda: KM.march(*_march_args()[0], **_march_args()[1]),
                  "CUDA"),
    "march_k": (lambda: KM.march(*_march_args()[0],
                                 **_march_args(k=KM.MAX_K + 1)[1]),
                "hits per ray"),
    "gaussian_rows_cpu": (lambda: KR.gaussian_rows(
        torch.zeros(8, 21), torch.zeros(4, 2, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32)), "CUDA"),
    "gaussian_rows_no_column": (lambda: KR.gaussian_rows(
        torch.zeros(8, 0), torch.zeros(4, 2, dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32)), "K >= 1"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_wrappers_refuse_cpu_tensors_and_bad_shapes(name):
    """With their C entry points configured once and cached, the wrappers
    of B1, B7, B8 and R1 still refuse CPU tensors and what the kernels do not
    take, before anything is built or launched."""
    call, match = REFUSALS[name]
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        call()
    assert kernels.launches() == {k: 0 for k in kernels.KERNEL_NAMES}


def test_entry_points_are_configured_once(monkeypatch):
    """``build.entry`` loads a library and sets an entry's argument types on
    its first call only; later calls return the same configured function."""
    loads = []

    class Lib:
        def __init__(self):
            self.fn = type("Fn", (), {})()

    def fake_library(stem):
        loads.append(stem)
        return Lib()
    monkeypatch.setattr(build, "library", fake_library)
    build.entry.cache_clear()
    try:
        argtypes = (build.ctypes.c_void_p, build.ctypes.c_int)
        f = build.entry("fake", "fn", argtypes)
        assert build.entry("fake", "fn", argtypes) is f
        assert f.argtypes == list(argtypes) and f.restype is \
            build.ctypes.c_int
        assert loads == ["fake"]
    finally:
        build.entry.cache_clear()


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


def test_cpu_dispatch_of_tile_major_blend_and_cols_launches_nothing():
    """B5/B6/B9 on CPU tensors run their plain versions; the tile-major
    forward carries the chunks processed in its last row."""
    kernels.reset_launches()
    slab = torch.zeros(128, 26)
    slab[:, 5] = 0.5                       # opacity; everything at (0, 0)
    slab[:, 2] = slab[:, 4] = 0.01
    t0 = torch.tensor([0, 128, 128, 128], dtype=torch.int32)
    tc = torch.tensor([128, 0, 0, 0], dtype=torch.int32)
    kw = dict(ca=14, cv=0, grid_x=2, grid_y=2, tile=16, chunk=128)
    out, wsum = blend_pallas.blend_forward(slab, t0, tc, **kw)
    assert out.shape == (4, 17, 256) and float(wsum.sum()) > 0
    assert out[:, 16, 0].tolist() == [1.0, 0.0, 0.0, 0.0]
    d = blend_pallas.blend_backward(slab, t0, torch.ones_like(out),
                                    out[:, 14:].contiguous(), None, **kw)
    assert d.shape == (128, 26) and float(d[:, 5].abs().sum()) > 0
    x = torch.rand(1024, 26)
    assert torch.equal(blend_pallas.slice_cols(
        blend_pallas.pad_cols(x, 128), 26), x)
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
                                        "blend_forward", "cols",
                                        "consistency", "env_lookup",
                                        "gaussian_rows", "launch_floor",
                                        "march", "preprocess", "shading"]
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


@pytest.mark.parametrize("h,w,m,sms,want", [
    # the configuration's default env, the recipe's at S = 24 and S = 64:
    # a copy for each warp of a block, one block an SM
    (16, 32, 1_200_000, 132, dict(parts=1, part_floats=1_536, warps=16,
                                  blocks=132)),
    (32, 64, 1_200_000, 132, dict(parts=1, part_floats=6_144, warps=8,
                                  blocks=132)),
    (32, 64, 3_200_000, 114, dict(parts=1, part_floats=6_144, warps=8,
                                  blocks=114)),
    (16, 32, 37, 132, dict(parts=1, part_floats=1_536, warps=16, blocks=1)),
    # a copy a block: too few copies fit for one a warp
    (64, 128, 1_200_000, 132, dict(parts=1, part_floats=24_576, warps=0,
                                   blocks=264)),
    (64, 128, 37, 132, dict(parts=1, part_floats=24_576, warps=0, blocks=1)),
    # envs past a block's shared memory, in slices
    (128, 256, 1_200_000, 132, dict(parts=2, part_floats=49_152, warps=0,
                                    blocks=132)),
    (256, 512, 5_000, 132, dict(parts=7, part_floats=56_176, warps=0,
                                blocks=35)),
    (256, 512, 1_200_000, 132, dict(parts=7, part_floats=56_176, warps=0,
                                    blocks=126)),
])
def test_env_backward_plan(h, w, m, sms, want):
    """B7's backward sizes what it holds in shared memory and its grid from
    (H, W, C, M, SM count) alone: a copy of d_env (and a byte a texel) a
    warp where a block holds 8 or more, else a copy a block, else slices of
    it, one a block of a group; no more blocks than the SMs hold, nor than
    the queries need."""
    c = 3
    plan = KE.backward_plan(h, w, c, m, sms)
    assert {k: plan[k] for k in want} == want
    parts, pf, blocks = plan["parts"], plan["part_floats"], plan["blocks"]
    assert pf % 4 == 0 and pf * 4 <= build.SMEM_OPT_IN_MAX
    assert (parts - 1) * pf < h * w * c <= parts * pf
    assert blocks % parts == 0 and plan["smem"] <= build.SMEM_OPT_IN_MAX
    if plan["warps"]:
        tags = -(-h * w // 16) * 16          # a byte per texel, 16-aligned
        assert plan["smem"] == plan["warps"] * (pf * 4 + tags)
        assert plan["per_sm"] == 1 and parts == 1
        assert KE.BWD_WARP_COPIES <= plan["warps"] <= KE.BWD_WARPS_MAX
        per_block = plan["warps"] * KE.BWD_WARP_QUERIES
    else:
        assert plan["smem"] == pf * 4
        assert plan["per_sm"] == (2 if parts == 1 else 1)
        per_block = KE.BWD_GRID[0] * KE.BWD_GRID[1]
    assert blocks <= max(plan["per_sm"] * sms, parts)
    assert blocks // parts <= -(-m // per_block)
