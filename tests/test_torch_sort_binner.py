"""The sort binner of svgir_tpu_torch (``bin_instances`` + ``pad_to_chunks``)
against svgir_tpu's, and against the port's own counting binner.

Both packages get the same ``Preprocessed`` (JAX's, carried over as numpy),
so every integer output must be exactly equal: no tolerance.  Cases: tile
16 and tile 32 (chunk 32) scenes with multi-chunk tiles; a scene whose
every Gaussian appears twice, so that depths tie and the sort must keep
duplication order; and the overflow case of
``tests/test_binning_equivalence.py`` (``max_instances=128``).  The JAX
side (preprocess and the reference binner) runs under ``jax.jit``: the
binners compare on one shared ``Preprocessed``, so compiling changes no
comparison, and it is several times quicker than eager dispatch here.
"""

import torch
import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from svgir_tpu.cameras import look_at_camera
from svgir_tpu.config import RasterConfig as JCfg
from svgir_tpu.ops import binning as jbin
from svgir_tpu.ops.preprocess import preprocess as j_preprocess

from svgir_tpu_torch.config import RasterConfig as TCfg
from svgir_tpu_torch.ops import binning as tbin

from tests.test_binning_equivalence import big_splat_scene
from tests.test_torch_binning import _prep as _prep_eager
from tests.test_torch_binning import _to_torch, hold_instance_lists


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


_prep = jax.jit(_prep_eager, static_argnums=tuple(range(6)))


def _doubled(p):
    """Every Gaussian twice: equal depths in every tile it touches."""
    return type(p)(*(jnp.concatenate([x, x]) for x in p))


def _big_splats(w=128, h=128):
    means, scales, quats, _, colors = big_splat_scene(n_small=60)
    cam = look_at_camera(eye=[0, 0, -3], target=[0, 0, 0], up=[0, -1, 0],
                         fovx=math.pi / 3, fovy=math.pi / 3, width=w,
                         height=h)
    return jax.jit(lambda m, s, q, c: j_preprocess(
        m, s, q, cam.world_view, cam.full_proj, cam.camera_center, width=w,
        height=h, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        focal_x=cam.focal_x, focal_y=cam.focal_y, colors=c,
        cfg=JCfg()))(means, scales, quats, colors)


CASES = {
    "tile16_128x128": dict(w=128, h=128, tile=16, chunk=128, cap=1 << 15,
                           prep=lambda: _prep(0, 600, 128, 128, 16, 0.12)),
    "tile32_96x160_chunk32": dict(w=96, h=160, tile=32, chunk=32,
                                  cap=1 << 15,
                                  prep=lambda: _prep(1, 700, 96, 160, 32,
                                                     0.10)),
    "tied_depths": dict(w=64, h=48, tile=16, chunk=32, cap=1 << 13,
                        prep=lambda: _doubled(_prep(2, 150, 64, 48, 16,
                                                    0.15))),
    "overflow_cap128": dict(w=128, h=128, tile=32, chunk=128, cap=128,
                            prep=_big_splats),
}


@functools.lru_cache(maxsize=None)
def _binned(name):
    c = CASES[name]
    jp = c["prep"]()
    kw = dict(width=c["w"], height=c["h"])

    @jax.jit
    def reference(p):
        b = jbin.bin_instances(p, cfg=JCfg(tile=c["tile"],
                                           max_instances=c["cap"]), **kw)
        return b, jbin.pad_to_chunks(b, chunk=c["chunk"],
                                     max_instances=c["cap"])
    jb, jpad = reference(jp)
    tp = _to_torch(jp)
    tcfg = TCfg(tile=c["tile"], chunk=c["chunk"], max_instances=c["cap"])
    tb = tbin.bin_instances(tp, cfg=tcfg, **kw)
    tpad = tbin.pad_to_chunks(tb, chunk=c["chunk"], max_instances=c["cap"])
    return dict(jb=jb, jpad=jpad, tb=tb, tpad=tpad,
                counting=tbin.bin_instances_counting(tp, cfg=tcfg, **kw))


@pytest.fixture(params=sorted(CASES))
def binned(request):
    return request.param, _binned(request.param)


def test_bin_instances_exact(binned):
    name, r = binned
    for f in ("gaussian_id", "tile_id", "inst_valid", "tile_start",
              "tile_end", "num_instances", "overflow"):
        np.testing.assert_array_equal(getattr(r["tb"], f).numpy(),
                                      np.asarray(getattr(r["jb"], f)),
                                      err_msg=f"{name}: {f}")
    assert bool(r["tb"].overflow) == (name == "overflow_cap128")
    if name == "tied_depths":
        # both copies of the tied Gaussians are binned; their order within
        # each tile is held to JAX's stable sort above
        n = r["tb"].gaussian_id.shape[0]
        assert int(r["tb"].num_instances) < n
        gid = r["tb"].gaussian_id.numpy()[:int(r["tb"].num_instances)]
        assert (gid >= 150).any() and (gid < 150).any()


def test_pad_to_chunks_exact(binned):
    name, r = binned
    for f in ("gaussian_id", "inst_valid", "tile_start", "tile_count",
              "num_instances", "overflow"):
        np.testing.assert_array_equal(getattr(r["tpad"], f).numpy(),
                                      np.asarray(getattr(r["jpad"], f)),
                                      err_msg=f"{name}: {f}")
    assert r["tpad"].order is None and r["jpad"].order is None
    tc = r["tpad"].tile_count.numpy()
    assert (tc % CASES[name]["chunk"] == 0).all()


def test_sort_binner_equals_counting_binner(binned):
    """The equivalence oracle: both binners give one chunk-aligned layout
    (where nothing overflows)."""
    name, r = binned
    if name == "overflow_cap128":
        assert bool(r["counting"].overflow) and bool(r["tpad"].overflow)
        return
    for f in ("gaussian_id", "inst_valid", "tile_start", "tile_count",
              "num_instances", "overflow"):
        np.testing.assert_array_equal(getattr(r["tpad"], f).numpy(),
                                      getattr(r["counting"], f).numpy(),
                                      err_msg=f"{name}: {f}")


def test_sort_binner_instance_lists(binned):
    """The sort binner's per-Gaussian instance lists (R1's input) against
    its layout, and (where nothing overflows) the same (Gaussian, slot)
    pairs as the counting binner's."""
    name, r = binned
    cap = CASES[name]["cap"]
    pairs, listed = hold_instance_lists(r["tpad"], cap)
    assert (len(pairs) < listed) == (name == "overflow_cap128")
    if name != "overflow_cap128":
        counting, _ = hold_instance_lists(r["counting"], cap)
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        c_order = np.lexsort((counting[:, 1], counting[:, 0]))
        np.testing.assert_array_equal(pairs[order], counting[c_order])
