"""The controls of the comparison that decides ``correct``, at a cell's
own size: the plain reference put in the program's place, with the
configuration's guarantee broken, through the harness's window (one
encode, no warm-up) and its comparison.  Each has to come out not
correct; the benchmark's own runs never run them.

    python3 -m portbench.control --workload CELL --seeds N [N ...] [--controls NAME ...]

Exits 0 when every control on every seed came out not correct."""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench.layout import Layout

# each control: the reference's archive with one guarantee broken
CONTROLS = {
    # every stream at libbz2 level 8 (800 kB blocks): valid bzip2 that
    # decodes to the same text, but not the stated level 9
    "level8": {"level": 8},
    # the metadata without the blocks' bit offsets: a valid archive that
    # readers decode sequentially, but not the stated byte-exact metadata
    "no_offsets": {"offsets": False},
}


def encoder(name: str):
    from portbench.reference import starch

    kw = CONTROLS[name]

    def encode(bed: bytes, sink) -> None:
        sink.write(starch.archive(bed, **kw).data)

    return encode


def run(layout: Layout, cell: str, seed: int, name: str, device: str) -> dict:
    from portbench import run as harness

    line, _ = harness.run_cell(layout, cell, seed, 0.0, False, device=device, t0=time.perf_counter(),
                               encoder=encoder(name), warm_up=False)
    return {"cell": cell, "seed": seed, "control": name, "correct": line["correct"],
            "checks": {k: c["value"] for k, c in line["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="+", default=list(CONTROLS), choices=list(CONTROLS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    layout = Layout()
    caught = True
    for seed in args.seeds:
        for name in args.controls:
            res = run(layout, args.workload, seed, name, args.device)
            caught &= not res["correct"]
            print(json.dumps(res), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
