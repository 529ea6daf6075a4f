"""CLI: ``python -m elaina_tpu_torch run <conf.json> [--device {cuda,cpu}]``.

The run takes the card unless ``--device cpu`` asks for the CPU; with no
visible card a CUDA run raises.
"""

import argparse
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
    args = parser.parse_args(argv)
    from .exec import run_expr

    run_expr(args.conf, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
