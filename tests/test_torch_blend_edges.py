"""The plain versions of the blend kernels B3 (forward) and B4 (backward) of
svgir_tpu_torch against svgir_tpu's strip kernels (Pallas, interpret mode)
on the edge inputs of ``tests/torch_kernel_inputs.blend_edge_inputs``: a
tile with no chunk, a tile that saturates in its first chunk and exits,
padding rows between real rows, alpha clamped at 0.99, bilinear u and v
past their clamps, a chunk of padding only; at the channel widths of the
exact-width kernels (14/0, 13/13, 16/16) and one generic width (3/4), at
tile 16, and the stage-1 width at tile 8 (where the stage-1 backward kernel,
whose 4-pixel lane patches need a side that is a multiple of 16, hands over
to the generic one).
``chip_smoke.py`` holds the CUDA kernels to the plain versions on the same
inputs.  Tolerances as ``tests/test_torch_blend.py``.

Also: the plain versions give one answer per input, whatever ran before
them in the process (ROADMAP C-b).
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.ops import blend_pallas_strip as jstrip
from svgir_tpu.ops import rasterizer as jras

from svgir_tpu_torch.ops import blend_pallas_strip as tstrip
from svgir_tpu_torch.ops.common import ALPHA_MAX, LOG_T_EPS

from tests.torch_kernel_inputs import BLEND_EDGE_CASES, blend_edge_inputs

SPT = 3          # the grid's 3 columns: one strip per tile row, no padding
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_blend(d):
    """JAX strip kernels on the same inputs, outputs in the port's layout."""
    gx, gy, ca, cv, tile = d["grid_x"], d["grid_y"], d["ca"], d["cv"], \
        d["tile"]
    kw = dict(ca=ca, cv=cv, gy=gy, grid_x=gx, spt=SPT, tile=tile,
              chunk=d["chunk"], interpret=True)
    slab128 = np.zeros((d["slab"].shape[0], 128), np.float32)
    slab128[:, :d["slab"].shape[1]] = d["slab"]
    ts = jras._strip_order(jnp.asarray(d["tile_start"]), gy, gx, SPT)
    tc = jras._strip_order(jnp.asarray(d["tile_count"]), gy, gx, SPT)
    img, eff, wsum = jax.jit(lambda s: jstrip.blend_forward_strip(
        s, ts, tc, **kw))(slab128)
    sx = -(-gx // SPT) * SPT
    g_img = np.zeros((d["g_img"].shape[0], gy * tile, sx * tile), np.float32)
    g_img[:, :, :gx * tile] = d["g_img"]
    dslab = jax.jit(lambda s, g, lt, e, gw: jstrip.blend_backward_strip(
        s, ts, tc, g, lt, e, gw, **kw))(
            slab128, g_img, img[ca + cv:ca + cv + 1], eff,
            jnp.asarray(d["g_wsum"])[None])
    eff = np.asarray(eff)[:, 0].reshape(gy, sx)[:, :gx].reshape(-1)
    return dict(img=np.asarray(img)[:, :, :gx * tile],
                eff=eff.astype(np.int32), wsum=np.asarray(wsum)[0],
                dslab=np.asarray(dslab)[:, :d["slab"].shape[1]])


def _torch_blend(d):
    t = torch.as_tensor
    kw = dict(ca=d["ca"], cv=d["cv"], grid_x=d["grid_x"],
              grid_y=d["grid_y"], tile=d["tile"], chunk=d["chunk"])
    img, eff, wsum = tstrip.blend_forward(
        t(d["slab"]), t(d["tile_start"]), t(d["tile_count"]), **kw)
    dslab = tstrip.blend_backward(
        t(d["slab"]), t(d["tile_start"]), eff, t(d["g_img"]),
        img[d["ca"] + d["cv"]], t(d["g_wsum"]), **kw)
    return dict(img=img.numpy(), eff=eff.numpy(), wsum=wsum.numpy(),
                dslab=dslab.numpy())


# (case, tile): every case at tile 16, and the stage-1 case at tile 8
TILE16 = [(n, 16) for n in sorted(BLEND_EDGE_CASES)]
CASES = TILE16 + [("stage1", 8)]


def _case_id(case):
    name, tile = case
    return name if tile == 16 else f"{name}-tile{tile}"


@pytest.fixture(scope="module")
def blended(request):
    name, tile = request.param
    d = blend_edge_inputs(name, tile=tile)
    return name, d, _jax_blend(d), _torch_blend(d)


# the inputs are laid out for tile 16: at tile 8 the same splats cover
# more of each tile, and tiles 2, 4 and 5 saturate in their first chunk
@pytest.mark.parametrize("blended", TILE16, indirect=True, ids=_case_id)
def test_edge_inputs_reach_their_edges(blended):
    """The inputs do what their docstring says: no chunk, an exit after the
    first of three chunks, saturated pixels, padding rows among real ones,
    pairs clamped at alpha 0.99 and u, v past their clamps."""
    name, d, _, t = blended
    nch, tile = d["ca"] + d["cv"], d["tile"]
    assert t["eff"].tolist() == [0, 1, 2, 1, 2, 2]
    lt = t["img"][nch].reshape(2, tile, 3, tile).transpose(0, 2, 1, 3)
    assert (lt[0, 1] < LOG_T_EPS).all()            # tile 1 saturates
    s, ts = d["slab"], d["tile_start"]
    real = (s != 0).any(1)
    rows2 = real[ts[2]:ts[2] + 2 * d["chunk"]]
    live = np.flatnonzero(rows2)
    pad = np.flatnonzero(~rows2)
    assert ((pad > live[0]) & (pad < live[-1])).any()
    assert not real[ts[5] + d["chunk"]:ts[5] + 2 * d["chunk"]].any()
    # pairs of tile 3 whose alpha clamps, of tile 4 whose u, v clamp
    m3 = tstrip._chunk_math(torch.as_tensor(s[None, ts[3]:ts[3] + 128]),
                            *tstrip._pixel_coords(range(3, 4), 3, tile, "cpu"))
    assert bool((m3["ok"] & (m3["alpha"] == ALPHA_MAX)).any())
    m4 = tstrip._chunk_math(torch.as_tensor(s[None, ts[4]:ts[4] + 128]),
                            *tstrip._pixel_coords(range(4, 5), 3, tile, "cpu"))
    for k in ("u_raw", "v_raw"):
        ok = m4["ok"]
        assert bool(((m4[k] < 0.001) & ok).any())
        assert bool(((m4[k] > 0.999) & ok).any())
        assert bool(((m4[k] == 0.5) & ok).any())


@pytest.mark.parametrize("blended", CASES, indirect=True, ids=_case_id)
def test_forward_matches(blended):
    name, d, j, t = blended
    nch = d["ca"] + d["cv"]
    np.testing.assert_array_equal(t["eff"], j["eff"])
    np.testing.assert_allclose(t["img"][:nch], j["img"][:nch], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t["img"][nch + 1], j["img"][nch + 1])
    lt, lj = t["img"][nch], j["img"][nch]
    sat = lj < LOG_T_EPS
    np.testing.assert_allclose(lt[~sat], lj[~sat], atol=1e-5)
    np.testing.assert_allclose(lt[sat], lj[sat], atol=1e-4)
    # weight sums of the rows of processed chunks (the reference's [M] is
    # cut to whole chunks); the port's other rows are zero
    done = _done_rows(d, t["eff"])
    np.testing.assert_allclose(t["wsum"][done], j["wsum"][done], atol=1e-5,
                               rtol=1e-5)
    assert not np.delete(t["wsum"], done).any()


def _done_rows(d, eff):
    """Slab rows of the chunks each tile processed."""
    ts, chunk = d["tile_start"], d["chunk"]
    return np.concatenate([np.arange(ts[k], ts[k] + e * chunk)
                           for k, e in enumerate(eff)])


@pytest.mark.parametrize("blended", CASES, indirect=True, ids=_case_id)
def test_backward_rows_match(blended):
    name, d, j, t = blended
    # rows of the chunks each tile processed (the reference leaves the
    # others unwritten, C-5)
    done = _done_rows(d, t["eff"])
    a, b = t["dslab"][done], j["dslab"][done]
    kinds = {"mean2d": slice(0, 2), "conic": slice(2, 5),
             "opacity": slice(5, 6), "jinv": slice(6, 10),
             "lam": slice(10, 12), "plain": slice(12, 12 + d["ca"]),
             "vertex": slice(12 + d["ca"], None)}
    for kind, sl in kinds.items():
        bb = b[:, sl]
        if bb.size == 0:
            continue
        scale = max(np.abs(bb).max(), 1e-6)
        np.testing.assert_allclose(a[:, sl] / scale, bb / scale, atol=1e-4,
                                   err_msg=f"{name}: {kind}")
    skipped = np.setdiff1d(np.arange(len(t["dslab"])), done)
    assert not t["dslab"][skipped].any()


_FRESH = """
import hashlib, sys
sys.path.insert(0, sys.argv[1])
import torch
from svgir_tpu_torch.ops import blend_pallas_strip as BS
from tests.torch_kernel_inputs import blend_edge_inputs
d = blend_edge_inputs("stage1")
t = {k: torch.as_tensor(v) for k, v in d.items() if hasattr(v, "shape")}
kw = {k: d[k] for k in ("ca", "cv", "grid_x", "grid_y", "tile", "chunk")}
for _ in range(2):
    img, eff, ws = BS.blend_forward_plain(t["slab"], t["tile_start"],
                                          t["tile_count"], **kw)
    ds = BS.blend_backward_plain(t["slab"], t["tile_start"], eff,
                                 t["g_img"], img[14], t["g_wsum"], **kw)
    print(hashlib.sha256(img.numpy().tobytes() + ws.numpy().tobytes()
                         + ds.numpy().tobytes()).hexdigest())
    junk = [torch.empty(int(n)).fill_(1.0) for n in (1e3, 3e5, 7e6)]
"""


def test_plain_blend_gives_one_answer_in_fresh_processes():
    """The plain forward and backward, each run first in a fresh process
    and again after other allocations, in three processes one after the
    other: one answer.  (Before torch.exp was settled, the first call of a
    process gave another answer in about one process in five; the plain blend's module now settles torch.exp when it
    loads.)"""
    env = {**os.environ, "PYTHONPATH": ROOT}
    digests = []
    for _ in range(3):
        out = subprocess.run([sys.executable, "-c", _FRESH, ROOT], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=300, check=True)
        digests += out.stdout.split()
    assert len(digests) == 6 and len(set(digests)) == 1, digests


def test_plain_blend_repeats_in_process():
    """The same plain forward and backward twice in one process, after
    other allocations and at another thread count: equal outputs."""
    d = blend_edge_inputs("stage2")
    t = {k: torch.as_tensor(v) for k, v in d.items() if hasattr(v, "shape")}
    kw = {k: d[k] for k in ("ca", "cv", "grid_x", "grid_y", "tile",
                            "chunk")}
    outs = []
    threads = torch.get_num_threads()
    try:
        for n in (threads, max(1, threads // 2)):
            torch.set_num_threads(n)
            junk = torch.rand(1 << 20)  # noqa: F841
            img, eff, ws = tstrip.blend_forward_plain(
                t["slab"], t["tile_start"], t["tile_count"], **kw)
            ds = tstrip.blend_backward_plain(
                t["slab"], t["tile_start"], eff, t["g_img"], img[26],
                t["g_wsum"], **kw)
            outs.append(hashlib.sha256(
                img.numpy().tobytes() + ws.numpy().tobytes()
                + ds.numpy().tobytes()).hexdigest())
    finally:
        torch.set_num_threads(threads)
    assert outs[0] == outs[1]
