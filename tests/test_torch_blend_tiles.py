"""The plain versions of the tile-major blend kernels B5 (forward) and B6
(backward) and of the column copies B9 of svgir_tpu_torch against
svgir_tpu's ``blend_pallas.blend_forward``/``blend_backward`` and
``pad_cols``/``slice_cols`` (Pallas, interpret mode).

Both packages get the same instance slab, tile ranges and cotangents.
Cases: vertex channels with the weight-sum cotangent; opaque saturation
with a multi-chunk early exit and no weight-sum cotangent; chunk 32, where
the reference's weight sums live in 128-lane slots per chunk.  Tolerances
(as ``tests/test_torch_blend.py``):
- n_contrib and the chunks processed per tile: exact;
- channel sums and weight sums: 1e-5 absolute and relative (float32 sums
  in another order: matrix products against running sums);
- final logT: 1e-5 on unsaturated pixels, 1e-4 on saturated ones (ROADMAP
  C-7);
- d_slab: 1e-4 of each row kind's largest magnitude, on valid instance rows
  only (the reference leaves other rows unwritten, C-5);
- B9: exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops import blend_pallas as jbp
from svgir_tpu.ops import rasterizer as jras
from svgir_tpu.ops.preprocess import preprocess as j_preprocess

from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops import blend_pallas as tbp
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


TILE = 16
CASES = {
    # vertex channels, weight-sum cotangent present
    "vertex_gwsum": dict(seed=4, n=300, w=48, h=40, scale=0.15, dist=3.0,
                         opac=(0.3, 0.9), s=3, vs=8, gwsum=True, chunk=128),
    # splats filling the view, three chunks per tile, each tile saturated
    # after two: early exit; no g_wsum
    "opaque_multichunk": dict(seed=9, n=2000, w=32, h=32, scale=0.25,
                              dist=1.6, opac=(0.2, 0.5), s=0, vs=0,
                              gwsum=False, chunk=128),
    # chunk 32: the reference's wsum slots are 128 lanes wide
    "chunk32_vertex": dict(seed=5, n=200, w=32, h=32, scale=0.2, dist=2.5,
                           opac=(0.3, 0.9), s=0, vs=4, gwsum=True, chunk=32),
}


def _inputs(c):
    scene = sphere_scene(jax.random.PRNGKey(c["seed"]), n=c["n"],
                         scale=c["scale"], opacity_range=c["opac"],
                         s_feat=c["s"], vs_feat=c["vs"])
    cam = default_camera(c["w"], c["h"], dist=c["dist"])
    cfg = JCfg(tile=TILE, max_instances=1 << 13, chunk=c["chunk"])
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
        height=c["h"], cfg=TCfg(tile=TILE, max_instances=1 << 13,
                                chunk=c["chunk"]))
    assert not bool(binned.overflow)
    gid = binned.gaussian_id.numpy()
    slab = np.concatenate([slab_g, np.zeros((1, kr), np.float32)])[
        np.where(gid >= 0, gid, len(slab_g))]
    gx, gy = -(-c["w"] // TILE), -(-c["h"] // TILE)
    rng = np.random.default_rng(c["seed"])
    g_out = rng.normal(size=(gx * gy, ca + cv + 3, TILE * TILE)).astype(
        np.float32)
    g_wsum = rng.normal(size=(len(gid),)).astype(np.float32) \
        if c["gwsum"] else None
    return dict(slab=slab, ts=binned.tile_start.numpy(),
                tc=binned.tile_count.numpy(), gid=gid, ca=ca, cv=cv, gx=gx,
                gy=gy, g_out=g_out, g_wsum=g_wsum, chunk=c["chunk"])


def _jax_blend(d):
    """JAX tile-major kernels on the same inputs; wsum re-laid per
    instance by the port's ``wsum_to_instances``."""
    ca, cv, chunk = d["ca"], d["cv"], d["chunk"]
    m = d["slab"].shape[0]
    kw = dict(ca=ca, cv=cv, num_tiles=d["gx"] * d["gy"], grid_x=d["gx"],
              tile=TILE, chunk=chunk, interpret=True)
    slab128 = np.zeros((m, 128), np.float32)
    slab128[:, :d["slab"].shape[1]] = d["slab"]
    ts, tc = jnp.asarray(d["ts"]), jnp.asarray(d["tc"])
    out, wsum = jax.jit(lambda s: jbp.blend_forward(s, ts, tc, **kw))(slab128)
    g_wsum = None if d["g_wsum"] is None else jbp.wsum_from_instances(
        jnp.asarray(d["g_wsum"])[None], chunk)
    dslab = jax.jit(lambda s, g, meta, gw: jbp.blend_backward(
        s, ts, tc, g, meta, gw, **kw))(slab128, d["g_out"],
                                       out[:, ca + cv:ca + cv + 3], g_wsum)
    wsum = tbp.wsum_to_instances(torch.as_tensor(np.asarray(wsum)), m, chunk)
    return dict(out=np.asarray(out), wsum=wsum[0].numpy(),
                dslab=np.asarray(dslab)[:, :d["slab"].shape[1]])


def _torch_blend(d):
    t = torch.as_tensor
    kw = dict(ca=d["ca"], cv=d["cv"], grid_x=d["gx"], grid_y=d["gy"],
              tile=TILE, chunk=d["chunk"])
    out, wsum = tbp.blend_forward(t(d["slab"]), t(d["ts"]), t(d["tc"]), **kw)
    nch = d["ca"] + d["cv"]
    dslab = tbp.blend_backward(
        t(d["slab"]), t(d["ts"]), t(d["g_out"]), out[:, nch:].contiguous(),
        None if d["g_wsum"] is None else t(d["g_wsum"]), **kw)
    return dict(out=out.numpy(), wsum=wsum.numpy(), dslab=dslab.numpy())


@pytest.fixture(scope="module", params=sorted(CASES))
def blended(request):
    d = _inputs(CASES[request.param])
    return request.param, d, _jax_blend(d), _torch_blend(d)


def test_forward_channels_match(blended):
    name, d, j, t = blended
    nch = d["ca"] + d["cv"]
    assert t["out"].shape == j["out"].shape == (d["gx"] * d["gy"], nch + 3,
                                                TILE * TILE)
    np.testing.assert_allclose(t["out"][:, :nch], j["out"][:, :nch],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t["out"][:, nch + 1], j["out"][:, nch + 1])


def test_forward_logt_and_chunks_processed_match(blended):
    name, d, j, t = blended
    nch = d["ca"] + d["cv"]
    np.testing.assert_array_equal(t["out"][:, nch + 2], j["out"][:, nch + 2])
    lt, lj = t["out"][:, nch], j["out"][:, nch]
    sat = lj < LOG_T_EPS
    np.testing.assert_allclose(lt[~sat], lj[~sat], atol=1e-5)
    np.testing.assert_allclose(lt[sat], lj[sat], atol=1e-4)
    eff = t["out"][:, nch + 2, 0]
    if name == "opaque_multichunk":
        # some tile exits early, after more than one chunk
        assert (eff < d["tc"] // d["chunk"]).any() and eff.max() > 1
        assert sat.any()
    else:
        assert eff.max() >= 1


def test_forward_weight_sums_match(blended):
    name, d, j, t = blended
    valid = d["gid"] >= 0
    np.testing.assert_allclose(t["wsum"][valid], j["wsum"][valid], atol=1e-5,
                               rtol=1e-5)
    assert np.abs(t["wsum"]).max() > 0


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


@pytest.mark.parametrize("chunk", [32, 128, 256])
def test_wsum_slot_layout_matches_reference(chunk):
    m = 4 * chunk
    g = np.random.default_rng(chunk).normal(size=(1, m)).astype(np.float32)
    slots = tbp.wsum_from_instances(torch.as_tensor(g), chunk)
    np.testing.assert_array_equal(
        slots.numpy(), np.asarray(jbp.wsum_from_instances(jnp.asarray(g),
                                                          chunk)))
    assert tbp.wsum_slot(chunk) == jbp.wsum_slot(chunk)
    np.testing.assert_array_equal(
        tbp.wsum_to_instances(slots, m, chunk).numpy(), g)


@pytest.mark.parametrize("op,kin,kout", [("pad_cols", 21, 128),
                                         ("pad_cols", 50, 64),
                                         ("slice_cols", 128, 21),
                                         ("slice_cols", 64, 50)])
def test_cols_match_reference(op, kin, kout):
    x = np.random.default_rng(kin).normal(size=(2048, kin)).astype(
        np.float32)
    ref = np.asarray(getattr(jbp, op)(jnp.asarray(x), kout, interpret=True))
    got = getattr(tbp, op)(torch.as_tensor(x), kout)
    assert got.shape == (2048, kout) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cols_keep_the_reference_contract():
    x = torch.zeros(1000, 24)
    assert tbp.pad_cols(x, 24) is x and tbp.slice_cols(x, 24) is x
    with pytest.raises(ValueError, match="multiple of block"):
        tbp.pad_cols(x, 32)
    with pytest.raises(ValueError, match="kin=24, kout=16"):
        tbp.pad_cols(torch.zeros(1024, 24), 16)
    with pytest.raises(ValueError, match="kin=24, kout=32"):
        tbp.slice_cols(torch.zeros(1024, 24), 32)
