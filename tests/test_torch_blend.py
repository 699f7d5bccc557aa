"""The plain versions of the blend kernels B3 (forward) and B4 (backward)
of svgir_tpu_torch against svgir_tpu's strip kernels
``blend_forward_strip``/``blend_backward_strip`` (Pallas, interpret mode).

Both get the same instance slab, tile ranges and cotangents.  Cases cover
vertex channels (CV > 0), opaque saturation with a multi-chunk early exit,
and the weight-sum cotangent present and absent.  Tolerances:
- n_contrib and the per-tile processed-chunk counts ``eff``: exact;
- channel sums and weight sums: 1e-5 absolute and relative (float32 sums
  summed in another order: the kernels use matrix products, the plain
  version running sums; the affine depth channels reach O(10));
- final logT: 1e-5 on unsaturated pixels and 1e-4 on saturated ones, whose
  logT keeps collecting log(1 - alpha) to the tile's exit chunk (ROADMAP
  C-7);
- d_slab: 1e-4 of each row kind's largest magnitude, compared on valid
  instance rows only (the reference leaves other rows unwritten, C-5).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops import blend_pallas_strip as jstrip
from svgir_tpu.ops import rasterizer as jras
from svgir_tpu.ops.preprocess import preprocess as j_preprocess

from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops import blend_pallas_strip as tstrip
from svgir_tpu_torch.ops.binning import bin_instances_counting
from svgir_tpu_torch.ops.common import LOG_T_EPS
from svgir_tpu_torch.ops.preprocess import Preprocessed as TPrep

from tests.scenes import default_camera, sphere_scene


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


TILE, CHUNK, SPT = 16, 128, 8
CASES = {
    # vertex channels, weight-sum cotangent present
    "vertex_gwsum": dict(seed=4, n=300, w=48, h=40, scale=0.15, dist=3.0,
                         opac=(0.3, 0.9), s=3, vs=8, gwsum=True),
    # splats filling the view, three chunks per tile, each tile saturated
    # after two: early exit; no g_wsum
    "opaque_multichunk": dict(seed=9, n=2000, w=32, h=32, scale=0.25,
                              dist=1.6, opac=(0.2, 0.5), s=0, vs=0,
                              gwsum=False),
}


def _inputs(c):
    scene = sphere_scene(jax.random.PRNGKey(c["seed"]), n=c["n"],
                         scale=c["scale"], opacity_range=c["opac"],
                         s_feat=c["s"], vs_feat=c["vs"])
    cam = default_camera(c["w"], c["h"], dist=c["dist"])
    cfg = JCfg(tile=TILE, max_instances=1 << 13)
    p = j_preprocess(scene["means"], scene["scales"], scene["quats"],
                     cam.world_view, cam.full_proj, cam.camera_center,
                     width=cam.width, height=cam.height, tanfovx=cam.tanfovx,
                     tanfovy=cam.tanfovy, focal_x=cam.focal_x,
                     focal_y=cam.focal_y, colors=scene["colors"], cfg=cfg)
    slab128, ca, cv = jras._pack_slab(p, scene["opacity"], scene["features"],
                                      scene["vfeatures"], cfg)
    kr = 12 + ca + 4 * cv
    slab_g = np.asarray(slab128)[:, :kr]
    binned = bin_instances_counting(
        TPrep(*(torch.as_tensor(np.asarray(x)) for x in p)), width=c["w"],
        height=c["h"], cfg=TCfg(tile=TILE, max_instances=1 << 13))
    assert not bool(binned.overflow)
    gid = binned.gaussian_id.numpy()
    slab = np.concatenate([slab_g, np.zeros((1, kr), np.float32)])[
        np.where(gid >= 0, gid, len(slab_g))]
    gx, gy = -(-c["w"] // TILE), -(-c["h"] // TILE)
    rng = np.random.default_rng(c["seed"])
    g_img = rng.normal(size=(ca + cv + 2, gy * TILE, gx * TILE)).astype(
        np.float32)
    g_wsum = rng.normal(size=(len(gid),)).astype(np.float32) \
        if c["gwsum"] else None
    return dict(slab=slab, ts=binned.tile_start.numpy(),
                tc=binned.tile_count.numpy(), gid=gid, ca=ca, cv=cv, gx=gx,
                gy=gy, g_img=g_img, g_wsum=g_wsum)


def _jax_blend(d):
    """JAX strip kernels on the same inputs, outputs in the port's layout."""
    gx, gy, ca, cv = d["gx"], d["gy"], d["ca"], d["cv"]
    kw = dict(ca=ca, cv=cv, gy=gy, grid_x=gx, spt=SPT, tile=TILE,
              chunk=CHUNK, interpret=True)
    slab128 = np.zeros((d["slab"].shape[0], 128), np.float32)
    slab128[:, :d["slab"].shape[1]] = d["slab"]
    ts = jras._strip_order(jnp.asarray(d["ts"]), gy, gx, SPT)
    tc = jras._strip_order(jnp.asarray(d["tc"]), gy, gx, SPT)
    img, eff, wsum = jax.jit(lambda s: jstrip.blend_forward_strip(
        s, ts, tc, **kw))(slab128)
    sx = -(-gx // SPT) * SPT
    g_img = np.zeros((d["g_img"].shape[0], gy * TILE, sx * TILE), np.float32)
    g_img[:, :, :gx * TILE] = d["g_img"]
    g_wsum = None if d["g_wsum"] is None else jnp.asarray(d["g_wsum"])[None]
    dslab = jax.jit(lambda s, g, lt, e, gw: jstrip.blend_backward_strip(
        s, ts, tc, g, lt, e, gw, **kw))(slab128, g_img, img[ca + cv:ca + cv + 1],
                                        eff, g_wsum)
    eff = np.asarray(eff)[:, 0].reshape(gy, sx)[:, :gx].reshape(-1)
    return dict(img=np.asarray(img)[:, :, :gx * TILE], eff=eff.astype(np.int32),
                wsum=np.asarray(wsum)[0],
                dslab=np.asarray(dslab)[:, :d["slab"].shape[1]])


def _torch_blend(d):
    t = torch.as_tensor
    kw = dict(ca=d["ca"], cv=d["cv"], grid_x=d["gx"], grid_y=d["gy"],
              tile=TILE, chunk=CHUNK)
    img, eff, wsum = tstrip.blend_forward(t(d["slab"]), t(d["ts"]),
                                          t(d["tc"]), **kw)
    dslab = tstrip.blend_backward(
        t(d["slab"]), t(d["ts"]), eff, t(d["g_img"]), img[d["ca"] + d["cv"]],
        None if d["g_wsum"] is None else t(d["g_wsum"]), **kw)
    return dict(img=img.numpy(), eff=eff.numpy(), wsum=wsum.numpy(),
                dslab=dslab.numpy())


@pytest.fixture(scope="module", params=sorted(CASES))
def blended(request):
    d = _inputs(CASES[request.param])
    return request.param, d, _jax_blend(d), _torch_blend(d)


def test_forward_channels_match(blended):
    name, d, j, t = blended
    nch = d["ca"] + d["cv"]
    np.testing.assert_allclose(t["img"][:nch], j["img"][:nch], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(t["img"][nch + 1], j["img"][nch + 1])


def test_forward_logt_and_early_exit_match(blended):
    name, d, j, t = blended
    np.testing.assert_array_equal(t["eff"], j["eff"])
    nch = d["ca"] + d["cv"]
    lt, lj = t["img"][nch], j["img"][nch]
    sat = lj < LOG_T_EPS
    np.testing.assert_allclose(lt[~sat], lj[~sat], atol=1e-5)
    np.testing.assert_allclose(lt[sat], lj[sat], atol=1e-4)
    if name == "opaque_multichunk":
        # some tile exits early, after more than one chunk
        assert (t["eff"] < d["tc"] // CHUNK).any() and t["eff"].max() > 1
        assert sat.any()


def test_forward_weight_sums_match(blended):
    name, d, j, t = blended
    valid = d["gid"] >= 0
    np.testing.assert_allclose(t["wsum"][valid], j["wsum"][valid], atol=1e-5)


def test_backward_rows_match(blended):
    name, d, j, t = blended
    valid = d["gid"] >= 0
    a, b = t["dslab"][valid], j["dslab"][valid]
    kinds = {"mean2d": slice(0, 2), "conic": slice(2, 5), "opacity": 5,
             "jinv": slice(6, 10), "lam": slice(10, 12),
             "plain": slice(12, 12 + d["ca"]),
             "vertex": slice(12 + d["ca"], None)}
    for kind, sl in kinds.items():
        bb = b[:, sl]
        if bb.size == 0:
            continue
        scale = max(np.abs(bb).max(), 1e-6)
        np.testing.assert_allclose(a[:, sl] / scale, bb / scale, atol=1e-4,
                                   err_msg=f"{name}: {kind}")
