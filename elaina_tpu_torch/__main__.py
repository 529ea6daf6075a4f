"""CLI: ``python -m elaina_tpu_torch run <conf.json>``."""

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) == 1 and argv[0] not in ("-h", "--help", "run"):
        argv = ["run"] + argv
    if len(argv) != 2 or argv[0] != "run":
        print("usage: python -m elaina_tpu_torch run <conf.json>",
              file=sys.stderr)
        return 1
    from .exec import run_expr

    run_expr(argv[1])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
