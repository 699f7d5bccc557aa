"""The port's spans and counters (``svgir_tpu_torch.utils.profiling``) in
its training steps, on small scenes on the CPU (a sphere of 48 surfels,
32 x 32 views; stage 2 on a synthetic bake, S = 4, an 8x16 env).

* Tracing off: the registry stays empty, no backward mark is made, and
  no ``record_function`` or CUDA event.
* Tracing on, under ``torch.profiler``: every span of the step appears in
  the profiler's events and in ``summary()`` with its parent, each
  ``*.bwd`` opens and closes once a step inside ``svgir.backward``, and
  ``steps`` counts the steps.
* The loss, every gradient and the step's outputs are bit-equal with
  tracing on and off, in both stages.
* The benchmark's metric files that read the registry, loaded by path:
  host readings give values, device readings None on the CPU, and each
  stage's metric None in the other stage.
* ``cli/train.py --profile_steps`` writes ``trace.json`` and
  ``spans.json`` and prints the per-span table; ``svgir.bake`` records
  under the profiler.
* On a CUDA device (marked ``card``, skipped here): a deliberate
  ``.item()`` counts one ``host_syncs`` of its span, the counting
  synchronize one, and a ``.bwd`` span runs on autograd's device thread
  with device ms above 0.  On the card, without JAX: ``python -m pytest
  --noconftest -o addopts= -p no:cacheprovider tests/test_torch_spans.py
  -m card``.

Imports no JAX: its card tests run on a machine without it.
"""

import dataclasses
import importlib.util
import json
import math
import threading
from collections import Counter
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from svgir_tpu_torch.cameras import look_at_camera
from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
from svgir_tpu_torch.models import gaussians as G
from svgir_tpu_torch.models import lights as LT
from svgir_tpu_torch.render.stage1 import render_stage1
from svgir_tpu_torch.render.svgss import render_svgss
from svgir_tpu_torch.train import optim, trainer
from svgir_tpu_torch.utils import profiling as P
from svgir_tpu_torch.utils.graphics import fibonacci_sphere_sampling
from svgir_tpu_torch.utils.transforms import normalize

ROOT = Path(__file__).resolve().parent.parent
CFG = RasterConfig(max_instances=1 << 13)
N, S, RES = 48, 4, 32
STEPS = 2
BG = torch.zeros(3)

# span -> the span it must open in
PARENTS_1 = {
    "svgir.step": None,
    "svgir.render": "svgir.step",
    "svgir.preprocess": "svgir.render",
    "svgir.binning": "svgir.render",
    "svgir.blend": "svgir.render",
    "svgir.losses": "svgir.step",
    "svgir.backward": "svgir.step",
    "svgir.blend.bwd": "svgir.backward",
    "svgir.preprocess.bwd": "svgir.backward",
    "svgir.optimizer": "svgir.step",
    "svgir.stats": "svgir.step",
}
PARENTS_2 = {
    **{k: v for k, v in PARENTS_1.items() if k != "svgir.stats"},
    "svgir.shading": "svgir.render",
    "svgir.consistency": "svgir.losses",
    "svgir.shading.bwd": "svgir.backward",
    "svgir.consistency.bwd": "svgir.backward",
    "svgir.env_lookup.bwd": "svgir.backward",
}
METRICS = {"host_syncs.s1": (1, "host"), "render_host_ms.s1": (1, "host"),
           "losses_host_ms.s1": (1, "host"),
           "backward_host_ms.s1": (1, "host"),
           "optimizer_host_ms.s1": (1, "host"),
           "host_syncs.s2": (2, "host"), "consistency_ms.s2": (2, "device"),
           "shading_ms.s2": (2, "device"), "preprocess_ms.s2": (2, "device")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small tensor ops: one thread a module under the parallel
    run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_registry():
    P.reset()
    yield
    P.reset()


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA events and the sync debug "
                    "mode exist only there")
    return torch.device("cuda:0")


def _scene(stage: int, device="cpu"):
    """(state, cameras, step arguments after the camera, the step, extra
    inputs) of a sphere of surfels facing out."""
    g = torch.Generator().manual_seed(0)
    dirs = normalize(torch.randn(N, 3, generator=g))
    state = G.init_from_points(dirs, torch.full((N, 3), 0.6), normals=dirs,
                               capacity=N, rotation_init="normal",
                               device="cpu")
    cams = []
    for i in range(STEPS):
        a = 2 * math.pi * i / STEPS
        cam = look_at_camera(eye=[3 * math.sin(a), 0.4, -3 * math.cos(a)],
                             target=[0, 0, 0], up=[0, -1, 0],
                             fovx=math.pi / 3, fovy=math.pi / 3, width=RES,
                             height=RES, device=device)
        cams.append(dataclasses.replace(
            cam, image=torch.rand(3, RES, RES, generator=g).to(device),
            image_mask=torch.ones(1, RES, RES, device=device)))
    if stage == 1:
        opt = OptimizationConfig()
        step = trainer.make_train_step(
            opt, CFG, BG, lrs=optim.group_lrs(opt, 1.0), track_stats=True,
            device=device)
        state = _to(state, device)
        return {"stage": 1, "opt": opt, "state": state, "cams": cams,
                "step": step, "opt_state": optim.adam_init(state["params"])}
    opt = OptimizationConfig(lambda_base_color_smooth=0.1,
                             lambda_roughness_smooth=0.05,
                             lambda_env_smooth=0.02)
    state = G.upgrade_to_pbr(state)
    inc, areas = fibonacci_sphere_sampling(
        normalize(torch.randn(N, S, 3, generator=g)[:, 0]), S)
    qx, qy = LT.equirect_grid_coords(inc)
    bake = {
        "radiance": torch.rand(N, S, 3, generator=g),
        "visibility": (torch.rand(N, S, 1, generator=g) > 0.3).float(),
        "incident_dirs": inc, "incident_areas": areas,
        "incident_qxy": torch.stack([qx, qy], -1),
        "hit_idx": torch.randint(-1, N, (N, S), generator=g),
        "uv": torch.rand(N, S, 2, generator=g),
    }
    params = dict(state["params"])
    params["radiances"] = bake["radiance"].clone()
    params["radiance_ratio"] = torch.ones(())
    state = _to({**state, "params": params}, device)
    env = LT.direct_light_map_init(8, generator=g, device="cpu")
    step = trainer.make_svgss_train_step(
        opt, CFG, BG, lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device=device)
    return {"stage": 2, "opt": opt, "state": state, "cams": cams,
            "step": step, "opt_state": optim.adam_init(state["params"]),
            "env": _to(env, device), "bake": _to(bake, device)}


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def _run_step(sc, i: int):
    """One step of the scene's step function on view ``i``: its outputs."""
    cam = sc["cams"][i]
    if sc["stage"] == 1:
        return sc["step"](sc["state"], sc["opt_state"], cam, 1000.0, 1e-4)
    return sc["step"](sc["state"], sc["opt_state"], sc["env"], sc["bake"],
                      cam, 1.0, 1e-4, 1e-3)


def _loss_and_grads(sc, i: int = 0):
    """The step's forward and backward alone, inside a ``svgir.step`` span:
    (loss, the autograd graph's node names, gradients by name)."""
    cam = sc["cams"][i]
    params = {k: v.detach().requires_grad_(True)
              for k, v in sc["state"]["params"].items()}
    alive = sc["state"]["alive"]
    with P.span(P.STEP):
        if sc["stage"] == 1:
            off = torch.zeros(N, 2, requires_grad=True)
            res = render_stage1(cam, params, BG, opt=sc["opt"],
                                iteration=1000.0, is_training=True,
                                alive=alive, mean2d_offset=off, cfg=CFG)
            extra = [off]
        else:
            env = sc["env"]["params"]["env"].detach().requires_grad_(True)
            res = render_svgss(cam, params, BG, bake=sc["bake"],
                               env_params={"env": env}, opt=sc["opt"],
                               iteration=1.0, is_training=True, alive=alive,
                               cfg=CFG)
            extra = [env]
        nodes = _graph_names(res["loss"])
        gp, gx = trainer.loss_grads(res["loss"], params, extra)
    return res["loss"].detach(), nodes, {**gp, "extra": gx[0]}


def _graph_names(t):
    seen, names, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for k, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {}


@pytest.mark.parametrize("stage", [1, 2])
def test_tracing_off_makes_no_span(stage, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("made while no profiler records")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(P, "_Mark", refuse)
    sc = _scene(stage)
    nodes_of = {}
    _run_step(sc, 0)
    _, nodes_of["off"], _ = _loss_and_grads(sc)
    assert P.summary() == {"steps": 0, "spans": {}, "counters": {}}
    monkeypatch.undo()
    (_, nodes_of["on"], _), _ = _traced(lambda: _loss_and_grads(sc))
    assert nodes_of["on"] == nodes_of["off"]      # the marks add no node
    assert "svgir.preprocess.bwd" in P.summary()["spans"]


@pytest.mark.parametrize("stage", [1, 2])
def test_spans_under_the_profiler(stage):
    sc = _scene(stage)
    parents = PARENTS_1 if stage == 1 else PARENTS_2
    _, prof = _traced(lambda: [_run_step(sc, i) for i in range(STEPS)])
    events = {e.name for e in prof.events()}
    assert set(parents) <= events, sorted(set(parents) - events)
    s = P.summary()
    assert s["steps"] == STEPS
    assert s["counters"]["steps"]["total"] == STEPS
    assert set(s["spans"]) == set(parents)
    for name, v in s["spans"].items():
        assert v["calls"] == STEPS, (name, v)
        assert v["host_ms"] > 0 and 0 < v["self_host_ms"] <= v["host_ms"]
        assert v["device_ms"] is None
    recs = P.REGISTRY.records()
    for r in recs:
        parent = recs[r["parent"]]["name"] if r["parent"] is not None \
            else None
        assert parent == parents[r["name"]], r
        assert r["step"] in range(1, STEPS + 1), r
    bwd = Counter((r["name"], r["step"]) for r in recs
                  if r["name"].endswith(".bwd"))
    assert set(bwd.values()) == {1}
    assert {n for n, _ in bwd} == {n for n in parents if n.endswith(".bwd")}
    assert s["counters"].get("host_syncs", {"total": 0})["total"] == 0


@pytest.mark.parametrize("stage", [1, 2])
def test_tracing_changes_no_bit(stage):
    sc = _scene(stage)
    loss0, _, grads0 = _loss_and_grads(sc)
    (loss1, _, grads1), _ = _traced(lambda: _loss_and_grads(sc))
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for k in grads0:
        assert torch.equal(grads0[k], grads1[k]), k
    out0 = _flat(_run_step(sc, 1))
    out1, _ = _traced(lambda: _flat(_run_step(sc, 1)))
    assert out0.keys() == out1.keys() and len(out0) > 10
    for k in out0:
        assert torch.equal(out0[k], out1[k]), k


def _metric(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"spans_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("stage", [1, 2])
def test_metric_files_read_the_registry(stage, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "benchmark"))
    readers = {name: _metric(name) for name in METRICS}
    for name, read in readers.items():        # nothing recorded yet
        assert read({"stage": METRICS[name][0]}) is None, name
    sc = _scene(stage)
    _traced(lambda: [_run_step(sc, i) for i in range(STEPS)])
    for name, read in readers.items():
        own, kind = METRICS[name]
        v = read({"stage": stage})
        if own != stage or kind == "device":
            assert v is None, name
        else:
            assert isinstance(v, float) and v >= 0, (name, v)
            if name.startswith("host_syncs"):
                assert v == 0.0         # the CPU has no device to wait for
            else:
                span = "svgir." + name.split("_host_ms")[0]
                assert v == pytest.approx(
                    P.summary()["spans"][span]["host_ms"] / STEPS), name


def _blender_scene(root: Path, n_frames=3, res=32):
    """A Blender-format scene: RGBA frames around the origin and a
    300-point cloud."""
    from svgir_tpu_torch.data.ply import store_pointcloud

    (root / "train").mkdir(parents=True)
    frames = []
    for i in range(n_frames):
        a = 2 * math.pi * i / n_frames
        c2w = np.eye(4)
        c2w[:3, 3] = [3 * math.sin(a), 0, 3 * math.cos(a)]
        frames.append({"file_path": f"./train/r_{i}",
                       "transform_matrix": c2w.tolist()})
        img = np.zeros((res, res, 4), np.uint8)
        img[8:24, 8:24] = 200
        img[8:24, 8:24, 3] = 255
        cv2.imwrite(str(root / "train" / f"r_{i}.png"), img)
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.8, "frames": frames}))
    rng = np.random.default_rng(1)
    nrm = rng.standard_normal((300, 3))
    store_pointcloud(str(root / "points3d.ply"), rng.random((300, 3)) * 2 - 1,
                     rng.random((300, 3)) * 255,
                     nrm / np.linalg.norm(nrm, axis=-1, keepdims=True))


def test_profile_steps_writes_the_trace_and_the_spans(tmp_path, capsys,
                                                      monkeypatch):
    from svgir_tpu_torch.cli import train as cli

    monkeypatch.setattr(trainer, "tensorboard_logger", lambda _: None)
    _blender_scene(tmp_path / "scene")
    prof_dir = tmp_path / "prof"
    cli.main(["-s", str(tmp_path / "scene"), "-m", str(tmp_path / "out"),
              "--iterations", "4", "--position_lr_max_steps", "4",
              "--max_instances", "4096", "--device", "cpu", "--quiet",
              "--profile_steps", "3:4", "--profile_dir", str(prof_dir)])
    with open(prof_dir / "spans.json") as f:
        written = json.load(f)
    s = written["summary"]
    assert s["steps"] == 2
    assert {"svgir.step", "svgir.render", "svgir.backward",
            "svgir.loop.densify", "svgir.loop.periodic",
            "svgir.loop.log"} <= set(s["spans"])
    assert s["spans"]["svgir.loop.log"]["calls"] == 1      # iteration 4
    assert len(written["spans"]) == sum(v["calls"]
                                        for v in s["spans"].values())
    with open(prof_dir / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"svgir.step", "svgir.blend", "svgir.loop.log"} <= names
    out = capsys.readouterr().out
    assert "host ms" in out and "svgir.step" in out
    with pytest.raises(ValueError):
        P.parse_steps("4:3")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["-s", "x", "--profile_steps", "4"])


def test_the_bake_records_its_span(tmp_path):
    sc = _scene(1)
    with P.trace(str(tmp_path)):
        trainer.bake_radiance_compact(sc["state"]["params"],
                                      sc["state"]["alive"], sample_num=S,
                                      max_k_hits=16)
    s = P.summary()
    assert s["spans"]["svgir.bake"]["calls"] == 1 and s["steps"] == 0
    assert P.REGISTRY.records()[-1]["parent"] is None


@pytest.mark.card
def test_syncs_and_backward_spans_on_the_card(card, monkeypatch):
    x = torch.ones(4, device=card)
    w = torch.randn(1 << 22, device=card, requires_grad=True)
    torch.cuda.synchronize()
    opened_on = {}
    open_span = P.REGISTRY.open

    def recording_open(name, mark=False):
        opened_on[name] = threading.get_ident()
        return open_span(name, mark)

    monkeypatch.setattr(P.REGISTRY, "open", recording_open)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with P.span(P.STEP):
            with P.span("svgir.test.read"):
                x.sum().item()
            with P.span("svgir.test.sync"):
                P.synchronize()
            mark = P.layer("svgir.test.layer")
            y = P.layer_out(mark, torch.sin(w) * 2)
            with P.span("svgir.backward"):
                torch.autograd.grad(y.sum(), w)
        torch.cuda.synchronize()
    assert "svgir.test.layer.bwd" in {e.name for e in prof.events()}
    s = P.summary()
    syncs = s["counters"]["host_syncs"]["by_span"]
    assert syncs == {"svgir.test.read": 1, "svgir.test.sync": 1}, syncs
    bwd = s["spans"]["svgir.test.layer.bwd"]
    assert bwd["calls"] == 1 and bwd["device_ms"] > 0, bwd
    recs = P.REGISTRY.records()
    rec = [r for r in recs if r["name"] == "svgir.test.layer.bwd"][0]
    assert recs[rec["parent"]]["name"] == "svgir.backward"
    # autograd's device thread ran the layer's backward
    assert opened_on["svgir.test.layer.bwd"] != threading.get_ident()
    assert opened_on["svgir.backward"] == threading.get_ident()
    assert torch.cuda.get_sync_debug_mode() == 0
    print(json.dumps(s), flush=True)
