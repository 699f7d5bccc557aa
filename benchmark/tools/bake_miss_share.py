"""Measure what the stage-2 bake of a trained stage-1 checkpoint holds, for
the bake that traffic ``s2_sphere_bake`` lays out.

    python3 benchmark/tools/bake_miss_share.py --checkpoint RUN/chkpnt3000.npz

Loads the checkpoint, bakes it with the program's
``trainer.bake_radiance_compact`` at S = 64 (the spirals turned by draws
from ``--seed``, as ``train_stage2`` turns them) and prints one JSON line:
the rows, the alive rows, the dead rows, the alive rows' share of rays
that miss (hit -1), the share of hit rays whose visibility is 0, the share
of alive rows whose every ray misses, the exhausted share and the bake's
seconds.  Runs on a CUDA device; a stage-1 checkpoint of the recipe comes
from ``svgir_tpu_torch.cli.train`` (see ``benchmark/README.md``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--sample_num", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from svgir_tpu_torch.train.checkpoint import load_checkpoint
    from svgir_tpu_torch.train.trainer import bake_radiance_compact

    it, tree = load_checkpoint(args.checkpoint, device=args.device)
    params, alive = tree["state"]["params"], tree["state"]["alive"]
    n_alive = int(alive.sum())
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    azimuth = torch.rand(n_alive, 1, generator=gen, device=args.device)
    t0 = time.time()
    bake = bake_radiance_compact(params, alive, sample_num=args.sample_num,
                                 azimuth=azimuth)
    if args.device != "cpu":
        torch.cuda.synchronize()
    secs = time.time() - t0
    hit = bake["hit_idx"][alive]
    vis = bake["visibility"][alive][..., 0]
    hits = hit >= 0
    out = {
        "checkpoint_iteration": it, "rows": int(alive.shape[0]),
        "alive": n_alive, "dead": int(alive.shape[0]) - n_alive,
        "sample_num": args.sample_num,
        "alive_miss_share": float((~hits).float().mean()),
        "hit_blocked_share": float((vis[hits] == 0).float().mean()),
        "hit_visibility_mean": float(vis[hits].mean()),
        "alive_rows_all_miss_share": float((~hits).all(1).float().mean()),
        "exhausted_share": float(bake["exhausted_frac"]),
        "bake_s": secs,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
