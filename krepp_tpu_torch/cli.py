"""Command-line interface of the port: `dist`, `place`, `sketch`, `seek`
and `inspect` (`index` not ported yet).

Mirrors krepp_tpu/cli.py's surfaces, flags and validation (ref:
src/krepp.cpp:508-800), plus `--device` on the commands that run on a
device (default cuda; the host runs only with --device cpu). `index` is
recognised and exits with a message naming the ROADMAP slice that ports
it.
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
    _add_query_opts(sc)
    sc.add_argument("--dist-max", type=float, default=math.nan,
                    help="Maximum distance to report for matching references.")
    _add_multi_filter(sc, filter_def=False)

    sc = sub.add_parser("place", add_help=False,
                        help="Place queries on a tree with respect to an "
                             "index.")
    _add_query_opts(sc)
    sc.add_argument("-t", "--nwk-file", default=None,
                    help="Newick file for the (rooted) placement tree.")
    sc.add_argument("-l", "--lineage-file", default=None,
                    help="GTDB-style taxonomic lineage file.")
    sc.add_argument("--tau", type=int, default=2,
                    help="Highest Hamming distance for placement threshold. "
                         "[2]")
    _add_multi_filter(sc, filter_def=True)
    tab = sc.add_mutually_exclusive_group()
    tab.add_argument("--tabular", dest="tabular", action="store_true",
                     default=False,
                     help="Output per-query placements in TSV. [false]")
    tab.add_argument("--no-tabular", dest="tabular", action="store_false")

    sc = sub.add_parser("inspect", add_help=False,
                        help="Display statistics and information for an "
                             "index.")
    sc.add_argument("--help", action="help")
    sc.add_argument("-i", "--index-dir", required=True)

    sc = sub.add_parser("sketch", add_help=False,
                        help="Create a sketch from k-mers in a single "
                             "FASTA/FASTQ file.")
    sc.add_argument("--help", action="help")
    sc.add_argument("-i", "--input-file", required=True)
    sc.add_argument("-o", "--output-path", required=True,
                    help="Path to store the resulting binary sketch file.")
    _add_lsh_opts(sc, 26, "k-16")

    sc = sub.add_parser("seek", add_help=False,
                        help="Seek query sequences in a sketch and estimate "
                             "distances.")
    sc.add_argument("--help", action="help")
    sc.add_argument("-q", "--query", required=True)
    sc.add_argument("-i", "--sketch-path", required=True)
    sc.add_argument("-o", "--output-path", default=None)
    sc.add_argument("--hdist-th", type=int, default=4,
                    help="Maximum Hamming distance for a k-mer to match. [4]")
    _add_device(sc)

    for name in NOT_PORTED:
        sub.add_parser(name, add_help=False,
                       help="(not ported to krepp_tpu_torch yet)")
    return p


def _add_query_opts(sc):
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
    _add_device(sc)
    sm = sc.add_mutually_exclusive_group()
    sm.add_argument("--summarize", dest="summarize", action="store_true",
                    default=False,
                    help="Summarize results into a table of read counts.")
    sm.add_argument("--no-summarize", dest="summarize", action="store_false")


def _add_device(sc):
    sc.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; fails without a "
                         "card) or cpu.")


def _add_lsh_opts(sc, k_def: int, h_note: str):
    """krepp_tpu's LSH options of `index` and `sketch`."""
    sc.add_argument("-k", "--kmer-len", type=int, default=k_def,
                    help=f"Length of k-mers. [{k_def}]")
    sc.add_argument("-w", "--win-len", type=int, default=None,
                    help="Length of minimizer window (w>=k). [k+6]")
    sc.add_argument("-h", "--num-positions", type=int, default=None,
                    dest="num_positions",
                    help=f"Number of positions for the LSH. [{h_note}]")
    sc.add_argument("-m", "--modulo-lsh", type=int, default=4,
                    help="Modulo value to partition LSH space. [4]")
    sc.add_argument("-r", "--residue-lsh", type=int, default=1,
                    help="A k-mer x will be included only if "
                         "r = LSH(x) mod m. [1]")
    frac = sc.add_mutually_exclusive_group()
    frac.add_argument("--frac", dest="frac", action="store_true",
                      default=True,
                      help="Include k-mers with r <= LSH(x) mod m. [true]")
    frac.add_argument("--no-frac", dest="frac", action="store_false")
    sc.add_argument("--sdust-t", type=int, default=0,
                    help="SDUST threshold (NCBI dustmasker: 20). [0]")
    sc.add_argument("--sdust-w", type=int, default=0,
                    help="SDUST window (NCBI dustmasker: 64). [0]")


def _add_multi_filter(sc, filter_def: bool):
    mg = sc.add_mutually_exclusive_group()
    mg.add_argument("--multi", dest="multi", action="store_true",
                    default=True)
    mg.add_argument("--no-multi", dest="multi", action="store_false")
    fg = sc.add_mutually_exclusive_group()
    fg.add_argument("--filter", dest="filter", action="store_true",
                    default=filter_def)
    fg.add_argument("--no-filter", dest="filter", action="store_false")


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
    dist_max = getattr(args, "dist_max", math.nan)
    if not math.isnan(dist_max) and not 1e-8 <= dist_max <= 0.33:
        raise SystemExit("--dist-max must be in [1e-08, 0.33]")
    trace = contextlib.nullcontext()
    if args.trace_dir:
        import torch

        trace = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.trace_dir))
    commands = {"dist": cmd_dist, "place": cmd_place, "seek": cmd_seek,
                "sketch": cmd_sketch, "inspect": cmd_inspect}
    with trace:
        commands[args.cmd](args, inv)
    print(f"Done, elapsed: {time.time() - t0:.2f} sec", file=sys.stderr)
    return 0


def _refuse_mesh(args):
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded engines are not ported to krepp_tpu_torch "
            "yet (ROADMAP Queue 1, slice 7)")


def cmd_dist(args, inv):
    from .index.artifact import load_index
    from .query.dist import DistConfig, run_dist

    _refuse_mesh(args)
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


def cmd_place(args, inv):
    from .tree.newick import Tree

    from .index.artifact import load_index
    from .query.place import PlaceConfig, run_place

    _refuse_mesh(args)
    di = load_index(args.index_dir)
    qtree = None
    if args.lineage_file:
        with open(args.lineage_file) as f:
            qtree = Tree.parse_lineages(f.read())
    elif args.nwk_file:
        with open(args.nwk_file) as f:
            qtree = Tree.parse(f.read())
    elif not di.wbackbone:
        raise SystemExit(
            "Given index lacks a tree and no backbone tree is provided...")
    if args.hdist_th < args.tau:
        raise SystemExit("The threshold tau must be less than --hdist-th!")
    cfg = PlaceConfig(hdist_th=args.hdist_th, chisq_value=args.chisq_value,
                      tau=args.tau, multi=args.multi,
                      no_filter=not args.filter, summarize=args.summarize,
                      tabular=args.tabular)
    stats = {}
    out = open(args.output_path, "w") if args.output_path else sys.stdout
    try:
        n = run_place(di, args.query, out, inv, cfg, qtree=qtree,
                      device=args.device, stats=stats)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Total number of sequences queried: {n}", file=sys.stderr)
    if args.verbose:
        print("place stats: " + json.dumps(stats), file=sys.stderr)


def cmd_inspect(args, inv):
    from .index.artifact import load_index
    from .inspect import display_info

    display_info(load_index(args.index_dir), sys.stdout)


def cmd_sketch(args, inv):
    from .params import IndexParams, LSHParams, validate_lsh_config

    from .index.artifact import save_sketch_reference
    from .index.build import build_sketch

    k = args.kmer_len
    w = args.win_len if args.win_len is not None else k + 6
    h = args.num_positions if args.num_positions is not None else k - 16
    validate_lsh_config(k, h, w)
    params = IndexParams(lsh=LSHParams.generate(k, h, args.modulo_lsh,
                                                seed=args.seed),
                         w=w, r=args.residue_lsh, frac=args.frac,
                         sdust_t=args.sdust_t, sdust_w=args.sdust_w)
    save_sketch_reference(build_sketch(args.input_file, params),
                          args.output_path)


def cmd_seek(args, inv):
    from .index.artifact import load_sketch_reference
    from .query.seek import run_seek

    sk = load_sketch_reference(args.sketch_path)
    stats = {}
    out = open(args.output_path, "w") if args.output_path else sys.stdout
    try:
        n = run_seek(sk, args.query, out, inv, hdist_th=args.hdist_th,
                     device=args.device, stats=stats)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Total number of sequences queried: {n}", file=sys.stderr)
    if args.verbose:
        print("seek stats: " + json.dumps(stats), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
