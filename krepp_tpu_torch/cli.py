"""Command-line interface of the port: `dist` (others not ported yet).

Mirrors krepp_tpu/cli.py's `dist` surface, flags and validation
(ref: src/krepp.cpp:508-800), plus `--device` (default cuda; the host
runs only with --device cpu). The other subcommands of krepp_tpu are
recognised and exit with a message naming the ROADMAP slice that ports
them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

from . import REFERENCE_VERSION, __version__

# subcommand -> where the ROADMAP puts its port
NOT_PORTED = {
    "index": "slice 6 (device winnowing) and the index subcommand",
    "place": "slice 3",
    "inspect": "Queue 1 item 14",
    "sketch": "slice 5",
    "seek": "slice 5",
}


def _invocation() -> str:
    return " ".join(sys.argv)


def build_parser() -> argparse.ArgumentParser:
    # add_help=False frees -h (the reference's --num-positions elsewhere)
    p = argparse.ArgumentParser(
        prog="krepp-tpu-torch", add_help=False,
        description="krepp-tpu-torch: the PyTorch/CUDA port of krepp-tpu.")
    p.add_argument("--help", action="help")
    p.add_argument("--seed", type=int, default=None,
                   help="Random seed for the LSH and other parts that require "
                        "randomness. [0]")
    p.add_argument("--num-threads", type=int, default=1,
                   help="Number of host worker threads for IO/parse. [1]")
    p.add_argument("--trace-dir", default=None,
                   help="Write a torch.profiler trace of the run to this "
                        "directory (chrome trace JSON).")
    p.add_argument("--verbose", action="store_true",
                   help="Print run statistics (engine mode, per-batch "
                        "overflow re-runs) to stderr.")
    sub = p.add_subparsers(dest="cmd", required=True)

    sc = sub.add_parser("dist", add_help=False,
                        help="Estimate distances of queries to genomes in "
                             "an index.")
    sc.add_argument("--help", action="help")
    sc.add_argument("-q", "--query", required=True,
                    help="Query FASTA/FASTQ file.")
    sc.add_argument("-i", "--index-dir", required=True,
                    help="Directory containing the reference index.")
    sc.add_argument("-o", "--output-path", default=None,
                    help="Write output to a file. [stdout]")
    sc.add_argument("--hdist-th", type=int, default=4,
                    help="Maximum Hamming distance for a k-mer to match. [4]")
    sc.add_argument("--chisq", type=float, default=2.706, dest="chisq_value",
                    help="Chi-square value for the distinguishability test. "
                         "[2.706]")
    sc.add_argument("--mesh", default=None,
                    help="Device mesh DATAxSHARD (not ported yet).")
    sc.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; fails without a "
                         "card) or cpu.")
    sm = sc.add_mutually_exclusive_group()
    sm.add_argument("--summarize", dest="summarize", action="store_true",
                    default=False,
                    help="Summarize results into a table of read counts.")
    sm.add_argument("--no-summarize", dest="summarize", action="store_false")
    sc.add_argument("--dist-max", type=float, default=math.nan,
                    help="Maximum distance to report for matching references.")
    mg = sc.add_mutually_exclusive_group()
    mg.add_argument("--multi", dest="multi", action="store_true",
                    default=True)
    mg.add_argument("--no-multi", dest="multi", action="store_false")
    fg = sc.add_mutually_exclusive_group()
    fg.add_argument("--filter", dest="filter", action="store_true",
                    default=False)
    fg.add_argument("--no-filter", dest="filter", action="store_false")

    for name in NOT_PORTED:
        sub.add_parser(name, add_help=False,
                       help="(not ported to krepp_tpu_torch yet)")
    return p


def main(argv=None) -> int:
    print(f"krepp-tpu-torch version: {__version__} "
          f"(reference-compatible: krepp {REFERENCE_VERSION})",
          file=sys.stderr)
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        print(f"`{args.cmd}` is not ported to krepp_tpu_torch yet (ROADMAP "
              f"{NOT_PORTED[args.cmd]}); use `python -m krepp_tpu "
              f"{args.cmd}`.", file=sys.stderr)
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    inv = _invocation()
    t0 = time.time()
    print(f"Invocation: {inv}", file=sys.stderr)
    if not math.isnan(args.dist_max) and not 1e-8 <= args.dist_max <= 0.33:
        raise SystemExit("--dist-max must be in [1e-08, 0.33]")
    trace = contextlib.nullcontext()
    if args.trace_dir:
        import torch

        trace = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.trace_dir))
    with trace:
        cmd_dist(args, inv)
    print(f"Done, elapsed: {time.time() - t0:.2f} sec", file=sys.stderr)
    return 0


def cmd_dist(args, inv):
    from .index.artifact import load_index
    from .query.dist import DistConfig, run_dist

    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded engines are not ported to krepp_tpu_torch "
            "yet (ROADMAP Queue 1, slice 7)")
    di = load_index(args.index_dir)
    cfg = DistConfig(hdist_th=args.hdist_th, chisq_value=args.chisq_value,
                     dist_max=args.dist_max, multi=args.multi,
                     no_filter=not args.filter, summarize=args.summarize)
    stats = {}
    out = open(args.output_path, "w") if args.output_path else sys.stdout
    try:
        n = run_dist(di, args.query, out, inv, cfg, device=args.device,
                     stats=stats)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Total number of sequences queried: {n}", file=sys.stderr)
    if args.verbose:
        print("dist stats: " + json.dumps(stats), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
