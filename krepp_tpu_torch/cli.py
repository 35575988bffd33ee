"""Command-line interface of the port: `index`, `dist`, `place`,
`inspect`, `sketch` and `seek`.

Mirrors krepp_tpu/cli.py's surfaces, flags and validation (ref:
src/krepp.cpp:508-800), plus `--device` on the commands that run on a
device (default cuda; the host runs only with --device cpu). `index` and
`sketch` use theirs on three paths only (sdust masking, the device winnower,
`index --mesh N`); with the native C winnower they run on the host and need
no card. `inspect` runs on the host and takes no `--device`.

`dist` and `place` take `--mesh DATAxSHARD`: the sharded engine over that
many devices (the host repeated with --device cpu). With KREPP_NUM_PROCESSES
or KREPP_COORDINATOR set, `main` first joins a torch.distributed process
group (parallel/boot.py) and the mesh spans every process: each one takes
DATA * SHARD / processes cells, and with -o each writes its slice of every
batch to PATH.rank<r>.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time

from . import REFERENCE_VERSION, __version__


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
                        "directory (chrome trace JSON), and the program's "
                        "own spans and counters to spans.json in it.")
    p.add_argument("--verbose", action="store_true",
                   help="Print run statistics (engine mode, per-batch "
                        "overflow re-runs; with --trace-dir the span "
                        "totals and counters) to stderr.")
    sub = p.add_subparsers(dest="cmd", required=True)

    sc = sub.add_parser("index", add_help=False,
                        help="Build an index from k-mers of reference "
                             "genomes.")
    sc.add_argument("--help", action="help")
    sc.add_argument("-i", "--input-file", required=True,
                    help="TSV file mapping reference IDs to paths.")
    sc.add_argument("-o", "--index-dir", required=True,
                    help="Directory in which the index will be stored.")
    sc.add_argument("-t", "--nwk-file", default=None,
                    help="Newick file for the backbone tree (must be rooted).")
    _add_lsh_opts(sc, 29, "k-16")
    sc.add_argument("--export-reference-format", action="store_true",
                    help="Also write the reference binary artifact files.")
    sc.add_argument("--mesh", type=int, default=0, dest="mesh",
                    help="Winnow genomes data-parallel across this many "
                         "devices (0 = single-device build).")
    sc.add_argument("--partial", action="store_true",
                    help="Write a suffixed partial artifact so independently"
                         " built residues (e.g. -r 0/-r 1 with --no-frac) "
                         "can share one directory and combine at load.")
    _add_device(sc, build=True)

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
    _add_device(sc, build=True)

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
                    help="Device mesh DATAxSHARD for multi-chip querying "
                         "(e.g. 2x4: reads data-parallel over 2, index "
                         "row-sharded over 4). [single device]")
    _add_device(sc)
    sm = sc.add_mutually_exclusive_group()
    sm.add_argument("--summarize", dest="summarize", action="store_true",
                    default=False,
                    help="Summarize results into a table of read counts.")
    sm.add_argument("--no-summarize", dest="summarize", action="store_false")


def _add_device(sc, build: bool = False):
    sc.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; fails without a "
                         "card) or cpu." + (
                        " Used by sdust masking, the device winnower "
                        "(KREPP_DEVICE_WINNOW=1, or w - k + 1 > 4096) and "
                        "--mesh; the C winnower runs on the host and needs "
                        "no card." if build else ""))


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
    args = parser.parse_args(argv)
    if os.environ.get("KREPP_NUM_PROCESSES") or os.environ.get(
            "KREPP_COORDINATOR"):
        # a multi-process run: joins before the first CUDA call
        from .parallel.boot import init_distributed, shutdown_distributed

        init_distributed(device=getattr(args, "device", "cuda"))
        try:
            return _run(args)
        finally:
            shutdown_distributed()
    return _run(args)


def _run(args) -> int:
    inv = _invocation()
    t0 = time.time()
    print(f"Invocation: {inv}", file=sys.stderr)
    dist_max = getattr(args, "dist_max", math.nan)
    if not math.isnan(dist_max) and not 1e-8 <= dist_max <= 0.33:
        raise SystemExit("--dist-max must be in [1e-08, 0.33]")
    trace = contextlib.nullcontext()
    if args.trace_dir:
        import torch

        from .core import trace as spans

        trace = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                args.trace_dir))
        spans.reset()
        spans.enable()
    commands = {"index": cmd_index, "dist": cmd_dist, "place": cmd_place,
                "seek": cmd_seek, "sketch": cmd_sketch,
                "inspect": cmd_inspect}
    try:
        with trace:
            commands[args.cmd](args, inv)
    finally:
        if args.trace_dir:
            spans.disable()
    if args.trace_dir:
        _write_spans(args, spans.snapshot())
    print(f"Done, elapsed: {time.time() - t0:.2f} sec", file=sys.stderr)
    return 0


def _write_spans(args, snap: dict) -> None:
    """--trace-dir: the registry's snapshot to DIR/spans.json; --verbose:
    its span totals and counters to stderr."""
    os.makedirs(args.trace_dir, exist_ok=True)
    with open(os.path.join(args.trace_dir, "spans.json"), "w") as f:
        json.dump(snap, f)
    if args.verbose:
        print("trace: " + json.dumps({"spans": snap["spans"],
                                      "counts": snap["counts"]}),
              file=sys.stderr)


def _mh_context():
    """(rank, number of processes); (0, 1) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _mesh_factory(args):
    """--mesh DATAxSHARD -> engine factory (None without --mesh).

    One process: ShardedQueryEngine over the first DATA * SHARD devices of
    --device. In a process group: MultiHostQueryEngine over the mesh laid
    out in rank order, every process running the same program."""
    if not args.mesh:
        return None
    from .parallel.mesh import parse_mesh

    nd, ns = parse_mesh(args.mesh)

    def factory(dindex, hdist_th):
        from .parallel.mesh import ShardedQueryEngine, make_query_mesh

        if _mh_context()[1] > 1:
            from .parallel.multihost import (MultiHostQueryEngine,
                                             make_global_mesh)

            return MultiHostQueryEngine(
                dindex, make_global_mesh(nd, ns, args.device), hdist_th)
        return ShardedQueryEngine(
            dindex, make_query_mesh(nd, ns, device=args.device), hdist_th)

    return factory


def _mh_output(args, sliceable: bool):
    """Where this process writes: with several processes, -o and a
    sliceable report, each rank writes its read slice to PATH.rank<r>;
    otherwise rank 0 writes everything and the others nothing. Returns
    (path or None for stdout, emit_slice)."""
    rank, nranks = _mh_context()
    if nranks <= 1:
        return args.output_path, None
    if args.output_path and sliceable:
        return f"{args.output_path}.rank{rank}", (rank, nranks)
    return (args.output_path if rank == 0 else os.devnull), None


def _make_params(args):
    from .params import IndexParams, LSHParams, validate_lsh_config

    k = args.kmer_len
    w = args.win_len if args.win_len is not None else k + 6
    h = args.num_positions if args.num_positions is not None else k - 16
    validate_lsh_config(k, h, w)
    return IndexParams(lsh=LSHParams.generate(k, h, args.modulo_lsh,
                                              seed=args.seed),
                       w=w, r=args.residue_lsh, frac=args.frac,
                       sdust_t=args.sdust_t, sdust_w=args.sdust_w)


def cmd_index(args, inv):
    from .index import artifact
    from .index.build import build_index
    from .tree.newick import Tree

    params = _make_params(args)
    input_map = []
    with open(args.input_file) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                if line.strip():
                    raise SystemExit(
                        "Failed to read the reference name to path/URL "
                        "mapping!")
                continue
            input_map.append((parts[0], parts[1]))
    tree = None
    if args.nwk_file:
        with open(args.nwk_file) as f:
            nwk = f.read()
        tree = Tree.parse(nwk)
        tree.nwk_str = nwk
    print("Building the index...", file=sys.stderr)
    if args.mesh:
        from .parallel.build import build_index_sharded, mesh_devices

        if params.sdust_t > 0 and params.sdust_w > 0:
            raise SystemExit(
                "--mesh with --sdust-t/--sdust-w: the sharded build does not "
                "mask (it would write the unmasked index); build with one of "
                "the two")
        built = build_index_sharded(
            input_map, params, tree,
            devices=mesh_devices(args.mesh, args.device))
    else:
        built = build_index(input_map, params, tree,
                            num_threads=max(1, args.num_threads),
                            device=args.device)
    print(f"\nTotal number of k-mers indexed: {built.nkmers}",
          file=sys.stderr)
    artifact.save_native(built, args.index_dir, seed=args.seed or 0,
                         partial=args.partial)
    if args.export_reference_format:
        artifact.save_index_reference(built, args.index_dir,
                                      seed=args.seed or 0)


def cmd_dist(args, inv):
    from .index.artifact import load_index
    from .query.dist import DistConfig, run_dist

    factory = _mesh_factory(args)
    di = load_index(args.index_dir)
    out_path, emit_slice = _mh_output(args, sliceable=not args.summarize)
    cfg = DistConfig(hdist_th=args.hdist_th, chisq_value=args.chisq_value,
                     dist_max=args.dist_max, multi=args.multi,
                     no_filter=not args.filter, summarize=args.summarize,
                     emit_slice=emit_slice)
    stats = {}
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        n = run_dist(di, args.query, out, inv, cfg, engine_factory=factory,
                     device=args.device, stats=stats)
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

    factory = _mesh_factory(args)
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
    out_path, emit_slice = _mh_output(args, sliceable=not args.summarize)
    cfg = PlaceConfig(hdist_th=args.hdist_th, chisq_value=args.chisq_value,
                      tau=args.tau, multi=args.multi,
                      no_filter=not args.filter, summarize=args.summarize,
                      tabular=args.tabular, emit_slice=emit_slice)
    stats = {}
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        n = run_place(di, args.query, out, inv, cfg, qtree=qtree,
                      engine_factory=factory, device=args.device,
                      stats=stats)
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
    from .index.artifact import save_sketch_reference
    from .index.build import build_sketch

    save_sketch_reference(build_sketch(args.input_file, _make_params(args),
                                       device=args.device),
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
