"""CLI: ``python -m elaina_tpu_torch run <conf.json> [--device {cuda,cpu}]
[--devices N]``.

The run takes the card unless ``--device cpu`` asks for the CPU; with no
visible card a CUDA run raises.  ``--devices N`` (default
``ELAINA_DEVICES``, else 1) runs N ranks, the lanes sharded over them:
under ``torchrun`` (``RANK`` set) this process is one of them; otherwise
it spawns N processes (the ``spawn`` start method) that meet through a
file in a temporary directory, rank i on ``cuda:i`` (NCCL; fewer visible
cards than N raises before any spawn) or on the CPU (gloo).
"""

import argparse
import os
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] not in ("-h", "--help", "run"):
        argv = ["run"] + argv
    parser = argparse.ArgumentParser(prog="python -m elaina_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run an experiment config")
    run.add_argument("conf")
    run.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    run.add_argument("--devices", type=int, default=None,
                     help="ranks to shard the lanes over (default "
                          "ELAINA_DEVICES, else 1)")
    args = parser.parse_args(argv)
    from .exec import env_devices, run_expr, spawn_ranks

    n = args.devices if args.devices is not None else env_devices()
    if n <= 1 or "RANK" in os.environ:
        run_expr(args.conf, device=args.device, devices=n)
    else:
        spawn_ranks(args.conf, args.device, n)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
