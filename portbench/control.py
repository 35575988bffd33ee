"""The control of the comparison: the plain reference computed in float32
(the precision below the float64 the port computes in), put in the
program's place, against the reference in float64, at a cell's own sizes:

    python3 -m portbench.control --workload <cell> --seeds <n> <n> ...

Prints, for each seed, the widest gap (check.py's number) that the
control reads and the cell's limit. The benchmark's own runs do not run
it; portbench/tests holds it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, harness, reference


def control_gap(w, traffic: dict, seed: int, device) -> float:
    """The widest gap between the float32 reference's report and the
    float64 reference's over the sample drawn from the seed."""
    names, idx = harness.check_sample(w, traffic, seed)
    genomes = torch.from_numpy(w.genomes).to(device)
    args = (traffic["command"], genomes, w.names, w.nwk, w.reads[idx], names,
            w.params)
    want = reference.report(*args, torch.float64)
    got = reference.report(*args, torch.float32)
    return check.widest_gap(got, want, names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    _, cfg, traffic = harness.cell_spec(harness.benchmark(), args.workload)
    for seed in args.seeds:
        w = harness.make_world(cfg, traffic, seed, "cuda")
        gap = control_gap(w, traffic, seed, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_gap": gap,
                          "limit": traffic["check_limit"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
