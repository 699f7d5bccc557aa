"""Rank processes for tests/test_torch_parallel.py: gloo ranks on the CPU
that stand in for the JAX tests' 8-device mesh.

This module imports torch, numpy and svgir_tpu_torch only, so a spawned
rank starts without importing JAX.  ``start`` spawns ``world`` ranks with
``torch.multiprocessing`` (the spawn method); they join a process group
through a ``file://`` store in the given directory (no TCP port, so test
files can run side by side), run torch on one thread, run the named jobs
in order on arrays the test saved with numpy, and write each job's
outputs to ``rank<r>.npz``.  A rank that raises writes its traceback to
``rank<r>.err``, and ranks still running after ``TIMEOUT_S`` are
terminated.
"""

from __future__ import annotations

import json
import math
import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

TIMEOUT_S = 240


def start(world: int, tmp, jobs, arrays):
    """Spawn ``world`` ranks that run ``jobs`` ([(name, options)]) on
    ``arrays`` (a dict of numpy arrays; a job with ``"prefix"`` in its
    options sees the arrays whose keys start with it, the prefix cut);
    returns a handle whose ``results()`` waits for them."""
    tmp = str(tmp)
    np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
    with open(os.path.join(tmp, "jobs.json"), "w") as f:
        json.dump(jobs, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(world, r, tmp), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return _Session(procs, tmp)


class _Session:
    def __init__(self, procs, tmp):
        self.procs, self.tmp = procs, tmp

    def results(self):
        """Per rank: {job name: {output: numpy array}}."""
        for p in self.procs:
            p.join(TIMEOUT_S)
        errs = []
        for r, p in enumerate(self.procs):
            if p.is_alive():
                p.terminate()
                p.join(10)
            err = os.path.join(self.tmp, f"rank{r}.err")
            if os.path.exists(err):
                errs.append(f"rank {r}:\n" + open(err).read())
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs:
            raise RuntimeError("\n".join(errs))
        out = []
        for r in range(len(self.procs)):
            with np.load(os.path.join(self.tmp, f"rank{r}.npz")) as z:
                per = {}
                for key in z.files:
                    job, name = key.split("/", 1)
                    per.setdefault(job, {})[name] = z[key]
            out.append(per)
        return out


def _rank_main(world, rank, tmp):
    try:
        torch.set_num_threads(1)
        from svgir_tpu_torch.parallel import dp
        dp.init_distributed(f"file://{os.path.join(tmp, 'store')}", world,
                            rank, device="cpu")
        import torch.distributed as dist
        with np.load(os.path.join(tmp, "inputs.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        with open(os.path.join(tmp, "jobs.json")) as f:
            jobs = json.load(f)
        out = {}
        for name, opts in jobs:
            pre = opts.get("prefix", "")
            sub = {k[len(pre):]: v for k, v in arrays.items()
                   if k.startswith(pre)}
            for k, v in JOBS[opts.get("kind", name)](sub, opts).items():
                out[f"{name}/{k}"] = np.asarray(v)
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---- inputs ---------------------------------------------------------------

def camera(spec, image=None):
    """A port camera from a look-at spec (eye, target, up, fov, width,
    height), on the CPU."""
    from svgir_tpu_torch.cameras import look_at_camera
    return look_at_camera(eye=spec["eye"], target=spec["target"],
                          up=spec["up"], fovx=spec["fov"], fovy=spec["fov"],
                          width=spec["width"], height=spec["height"],
                          image=image, device="cpu")


def ring_specs(n=8, res=32):
    """The JAX DP tests' ring of cameras around the origin."""
    out = []
    for i in range(n):
        a = 2 * math.pi * i / n
        out.append(dict(eye=[3 * math.sin(a), 0.3, -3 * math.cos(a)],
                        target=[0, 0, 0], up=[0, -1, 0], fov=math.pi / 3,
                        width=res, height=res))
    return out


def _t(a, key):
    return torch.as_tensor(a[key]) if key in a else None


def _params(a, prefix="p_"):
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in a.items()
            if k.startswith(prefix)}


def _state(a):
    from svgir_tpu_torch.models import gaussians as G
    params = _params(a)
    cap = params["xyz"].shape[0]
    return {"params": params, "alive": torch.as_tensor(a["alive"]),
            "stats": G.init_stats(cap, device="cpu")}


def _batch(a, specs):
    from svgir_tpu_torch.parallel import dp
    return dp.stack_cameras([camera(s, a["images"][i])
                             for i, s in enumerate(specs)])


def _flat(prefix, d):
    return {f"{prefix}{k}": v.detach() for k, v in d.items()}


# ---- jobs -----------------------------------------------------------------

def job_gshard(a, o):
    """rasterize_sharded on the scene in ``a`` for each variant (exchange
    cap, row starts), with the gradient of sum(color**2) with respect to
    the means where ``grad``; and the port's single-device strip-0
    render."""
    import dataclasses
    from svgir_tpu_torch.config import RasterConfig
    from svgir_tpu_torch.ops.rasterizer import rasterize
    from svgir_tpu_torch.parallel import dp, gshard

    cfg = RasterConfig(max_instances=o["max_instances"], tile=o["tile"])
    cam = camera(o["camera"])
    mesh = dp.make_mesh(o.get("ranks"), axis="gauss", device_type="cpu")
    kw = dict(colors=_t(a, "colors"), features=_t(a, "features"),
              vfeatures=_t(a, "vfeatures"), cfg=cfg)
    geo = [torch.as_tensor(a[k]) for k in ("means", "scales", "quats",
                                          "opacity")]
    bg = torch.as_tensor(a["bg"])
    out = {}

    def record(tag, bufs, means):
        for f in ("color", "opacity", "feature", "vfeature", "depth",
                  "weights", "radii", "overflow", "n_contrib"):
            out[f"{tag}_{f}"] = getattr(bufs, f).detach()
        if o.get("grad"):
            (g,) = torch.autograd.grad(bufs.color.square().sum(), means)
            out[f"{tag}_dmeans"] = g

    for i, v in enumerate(o["variants"]):
        means = geo[0].clone().requires_grad_(o.get("grad", False))
        bufs = gshard.rasterize_sharded(
            mesh, "gauss", means, *geo[1:], cam, bg,
            exchange_cap=v.get("cap"), row_starts=v.get("row_starts"), **kw)
        record(f"v{i}", bufs, means)
    if o.get("single"):
        means = geo[0].clone().requires_grad_(o.get("grad", False))
        kw["cfg"] = dataclasses.replace(cfg, strip=0)
        record("single", rasterize(means, *geo[1:], cam, bg, **kw), means)
    return out


def job_dp1(a, o):
    """One make_dp_train_step step, rank r on camera r."""
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.parallel import dp
    from svgir_tpu_torch.train import optim

    opt = OptimizationConfig()
    state = _state(a)
    mesh = dp.make_mesh(device_type="cpu")
    step = dp.make_dp_train_step(
        mesh, opt, RasterConfig(max_instances=o["max_instances"]),
        torch.zeros(3), lrs=optim.group_lrs(opt, 1.0), device="cpu")
    new, ost, metrics = step(state, optim.adam_init(state["params"]),
                             _batch(a, o["cameras"]), o["iteration"],
                             o["xyz_lr"])
    return {**_flat("p_", new["params"]), **_flat("m_", ost["m"]),
            **_flat("v_", ost["v"]), **_flat("s_", new["stats"]),
            "loss": metrics["loss"], "psnr": metrics["psnr"]}


def job_bake_dp2(a, o):
    """bake_radiance_sharded over the data axis on the azimuth draws in
    ``a``, then one make_dp_svgss_train_step step on that bake."""
    from svgir_tpu_torch.config import OptimizationConfig, RasterConfig
    from svgir_tpu_torch.models import gaussians as G
    from svgir_tpu_torch.models import lights as LT
    from svgir_tpu_torch.parallel import dp
    from svgir_tpu_torch.train import optim

    state = _state(a)
    p = dict(state["params"])
    mesh = dp.make_mesh(device_type="cpu")
    bake = dp.bake_radiance_sharded(
        mesh, "data", p["xyz"], G.get_scaling(p), G.get_rotation(p),
        G.get_opacity(p)[:, 0], G.get_shs(p), sample_num=o["samples"],
        azimuth=torch.as_tensor(a["azimuth"]))
    p["radiances"] = bake["radiance"].clone()
    p["radiance_ratio"] = torch.ones(())
    state = {**state, "params": p}
    static = {k: v for k, v in bake.items() if k != "exhausted_frac"}
    opt = OptimizationConfig()
    env = LT.env_state_from_jax({
        "params": {"env": a["env"]},
        "opt": {"m": {"env": a["env_m"]}, "v": {"env": a["env_v"]},
                "step": 0}}, device="cpu")
    step = dp.make_dp_svgss_train_step(
        mesh, opt, RasterConfig(max_instances=o["max_instances"]),
        torch.zeros(3), lrs=optim.group_lrs(opt, 1.0, use_pbr=True),
        device="cpu")
    new, ost, env_new, metrics = step(
        state, optim.adam_init(p), env, static, _batch(a, o["cameras"]),
        o["iteration"], o["xyz_lr"], opt.radiance_lr)
    return {**_flat("bake_", bake), **_flat("p_", new["params"]),
            **_flat("m_", ost["m"]), **_flat("v_", ost["v"]),
            "env": env_new["params"]["env"],
            "env_m": env_new["opt"]["m"]["env"],
            "loss": metrics["loss"], "psnr": metrics["psnr"]}


def job_bake(a, o):
    """bake_radiance_sharded over the data axis on the surfels and azimuth
    draws in ``a``."""
    from svgir_tpu_torch.parallel import dp

    bake = dp.bake_radiance_sharded(
        dp.make_mesh(device_type="cpu"), "data",
        *[torch.as_tensor(a[k]) for k in ("means", "scales", "quats",
                                          "opacity", "shs")],
        sample_num=o["samples"], azimuth=torch.as_tensor(a["azimuth"]))
    return _flat("bake_", bake)


COMM_CASES = ("all_gather_sum", "all_gather_own", "all_reduce_sum",
              "all_reduce_mean", "all_reduce_max", "all_to_all",
              "reduce_scatter", "shard")


def comm_inputs(case, rank, world, k=3):
    """Rank ``rank``'s input x and loss weights w of a collective's case
    (numpy, from seeds; the test rebuilds every rank's).  Each loss is
    sum(w * op(x)); w is the same on every rank where the case's output is
    replicated (the rank's own slice, the reductions), else the rank's
    own."""
    shared = case in ("all_gather_own", "all_reduce_sum", "all_reduce_mean",
                      "all_reduce_max")
    rng = np.random.default_rng(COMM_CASES.index(case) * 100 + rank)
    rows = world * world * k if case == "shard" else world * k
    x = rng.standard_normal((rows, 2)).astype(np.float32)
    if case == "shard":          # a replicated input
        x = np.random.default_rng(99).standard_normal((rows, 2)).astype(
            np.float32)
    if case == "all_reduce_max":  # a tie between every rank on row 0
        x[0] = 1.5
    out_rows = {"all_gather_sum": world * rows, "all_gather_own":
                world * rows, "reduce_scatter": rows // world,
                "shard": rows // world}.get(case, rows)
    wr = np.random.default_rng(7 if shared else 1000 + rank)
    return x, wr.standard_normal((out_rows, 2)).astype(np.float32)


def job_comm(a, o):
    """Every collective of parallel/comm.py forward and backward on the
    inputs of ``comm_inputs``."""
    import torch.distributed as dist
    from svgir_tpu_torch.parallel import comm

    rank, world = dist.get_rank(), dist.get_world_size()
    ops = {"all_gather_sum": lambda x: comm.all_gather(x),
           "all_gather_own": lambda x: comm.all_gather(x, backward="own"),
           "all_reduce_sum": lambda x: comm.all_reduce(x, "sum"),
           "all_reduce_mean": lambda x: comm.all_reduce(x, "mean"),
           "all_reduce_max": lambda x: comm.all_reduce(x, "max"),
           "all_to_all": comm.all_to_all,
           "reduce_scatter": comm.reduce_scatter, "shard": comm.shard}
    out = {}
    for case in COMM_CASES:
        x, w = (torch.as_tensor(v) for v in comm_inputs(case, rank, world))
        x.requires_grad_(True)
        y = ops[case](x)
        (g,) = torch.autograd.grad((w * y).sum(), x)
        out[f"{case}_y"], out[f"{case}_dx"] = y.detach(), g
    return out


def job_bootstrap(a, o):
    """init_distributed again (idempotent) and make_global_mesh's axes."""
    import torch.distributed as dist
    from svgir_tpu_torch.parallel import dp

    again = dp.init_distributed(device="cpu")
    m1 = dp.make_global_mesh(device_type="cpu")
    m2 = dp.make_global_mesh({"data": -1, "tile": 4}, device_type="cpu")
    try:
        dp.make_global_mesh({"data": 3}, device_type="cpu")
        refused = False
    except ValueError:
        refused = True
    return {"rank": dist.get_rank(), "again": again,
            "m1_names": np.array(m1.mesh_dim_names),
            "m1_shape": np.array(m1.shape),
            "m2_names": np.array(m2.mesh_dim_names),
            "m2_shape": np.array(m2.shape), "refused": refused}


JOBS = {"gshard": job_gshard, "dp1": job_dp1, "bake": job_bake,
        "bake_dp2": job_bake_dp2, "comm": job_comm,
        "bootstrap": job_bootstrap}
