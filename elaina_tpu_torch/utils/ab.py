"""A/B of two checkouts of the port on one card, in turns.

    python -m elaina_tpu_torch.utils.ab --tree parent=<dir> \\
        --tree change=<dir> \\
        --order parent,change,change,parent,parent,change [--out <file>]

Each tree is a checkout of the repository, for example ``git archive`` of
a commit unpacked into a directory that ``.gitignore`` lists.  At every
turn of ``--order`` the named tree runs, each in a process of its own:

1. lobed_u (``utils/scenes.write_scene``, 32 spp) and neumann3d_u
   (``configs/neumann3d_u.json`` as shipped, 64 spp) through
   ``python -m elaina_tpu_torch run``: walk_steps / duration of
   ``result.json``.  A tree's first turn starts on a cold ``_build/``;
2. its K1 ``compact_lanes``, K3 ``fetch_colors`` and K5 ``fetch_colors3``
   on the same seeded inputs at the main paths' shapes (K1 and K3 on
   1024^2 lanes with lobed_u's 187,567 set and 72,062 in-shell, K1 and K5
   on 65,536 lanes with neumann3d_u's 3,876 and 304), each color table
   made by the tree's own ``color_rows_from``: call ms and device ms as
   ``utils/timing.py`` takes them.

The trees share one grid cache, so only the first run of a scene builds
its grids (before the solve's clock in both trees).  One JSON line per
turn, then the medians per tree; ``--out`` also writes them to a file.
The card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# the main paths' shapes (PERF.md): lanes, set lanes, in-shell lanes, prims
LOBED = (1048576, 187567, 72062, 65536)
NEUMANN3D = (65536, 3876, 304, 768)
SPP_2D, SPP_3D = 32, 64


def _kernel_times() -> dict:
    """K1, K3 and K5 of the tree in the working directory, on seeded
    inputs (run as a file there: ``timing`` is this file's neighbour)."""
    sys.path.insert(0, os.getcwd())
    import torch
    from timing import cuda_ms, device_ms

    from elaina_tpu_torch.geometry.grid import color_rows_from
    from elaina_tpu_torch.ops import resolve as R

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def pick(n, k):
        """A mask of n lanes with exactly k set, at seeded places."""
        m = torch.zeros(n, dtype=torch.bool, device=dev)
        m[torch.randperm(n, generator=gen, device=dev)[:k]] = True
        return m

    out = {}
    for label, (n, n_set, n_ins, P), nc in (("2d", LOBED, 2),
                                            ("3d", NEUMANN3D, 3)):
        mask = pick(n, n_set)
        ins = pick(n, n_ins)
        n_verts = P + 1
        idx = (torch.arange(P, device=dev)[:, None]
               + torch.arange(nc, device=dev)[None, :]) % n_verts
        colors = torch.rand((n_verts, 2, 3), generator=gen, device=dev)
        rows = color_rows_from(colors, idx)
        cfi = torch.where(ins, torch.randint(0, 2 * P, (n,), generator=gen,
                                             device=dev), 0).to(torch.int32)
        fetch = R.fetch_colors if nc == 2 else R.fetch_colors3
        for name, fn in ((f"compact_lanes_{label}",
                          lambda m=mask, n=n: R.compact_lanes(m, n)),
                         (fetch.__name__,
                          lambda i=ins, c=cfi, r=rows, f=fetch: f(i, c, r))):
            d_ms, host_us, hidden = device_ms(fn)
            out[name] = {"ms": cuda_ms(fn), "device_ms": d_ms,
                         "host_us": host_us, "hidden": hidden}
    return out


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _run(cmd: list, tree: str, env: dict) -> str:
    """Run ``cmd`` in ``tree``; its stdout, or raise with its stderr."""
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd} in {tree} exited {proc.returncode}:\n"
                           f"{proc.stderr[-4000:]}")
    return proc.stdout


def _run_scene(tree: str, conf: str, env: dict) -> dict:
    _run([sys.executable, "-m", "elaina_tpu_torch", "run", conf, "--device",
          "cuda"], tree, env)
    with open(conf) as f:
        c = json.load(f)
    with open(os.path.join(c["base_path"], c["exp_name"],
                           "result.json")) as f:
        r = json.load(f)
    return {"walk_steps": r["walk_steps"], "duration_ms": r["duration"],
            "walk_steps_s": r["walk_steps"] / (r["duration"] / 1e3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m elaina_tpu_torch.utils.ab")
    ap.add_argument("--tree", action="append", required=True,
                    help="name=directory of a checkout")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one per turn")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    trees = {k: os.path.abspath(v) for k, v in trees.items()}
    order = args.order.split(",")
    here = os.path.dirname(os.path.abspath(__file__))
    from . import scenes

    lines = [_card()]
    print(lines[0], flush=True)
    turns = []
    with tempfile.TemporaryDirectory() as root:
        env = dict(os.environ, ELAINA_CACHE_DIR=os.path.join(root, "cache"))
        confs = {"lobed_u": scenes.write_scene(root, SPP_2D),
                 "neumann3d_u": scenes.write_config_copy(root, "neumann3d_u",
                                                         SPP_3D)}
        for i, name in enumerate(order):
            t0 = time.time()
            turn = {"turn": i, "tree": name}
            for scene, conf in confs.items():   # first: a cold _build/
                turn[scene] = _run_scene(trees[name], conf, env)
            out = _run([sys.executable, os.path.join(here, "ab.py"),
                        "--kernels"], trees[name], env)
            turn["kernels"] = json.loads(out.strip().splitlines()[-1])
            turn["seconds"] = time.time() - t0
            turns.append(turn)
            lines.append(json.dumps(turn))
            print(lines[-1], flush=True)
    summary = {}
    for name in trees:
        mine = [t for t in turns if t["tree"] == name]
        summary[name] = {
            scene: statistics.median(t[scene]["walk_steps_s"] for t in mine)
            for scene in confs}
        for k in mine[0]["kernels"]:
            for key in ("ms", "device_ms", "host_us"):
                summary[name][f"{k}_{key}"] = statistics.median(
                    t["kernels"][k][key] for t in mine)
    lines.append(json.dumps({"medians": summary}))
    print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--kernels"]:
        print(json.dumps(_kernel_times()))
    else:
        sys.exit(main())
