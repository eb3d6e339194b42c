"""The control of a cell's correctness check: the frozen reference put in
the program's place and computed in the nearest precision below the one
the configuration states (TF32 for f32 with TF32 off), compared with the
f32 reference by the same numbers and limits. A sound check reads the
control as not correct on every seed.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

prints one JSON line per seed: the numbers, and whether they pass the
cell's limits. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def control_numbers(workload: str, seed: int, device, manifest=None):
    """(numbers of the TF32 control against the f32 reference, limits) on
    the images a run of ``workload`` with ``seed`` checks."""
    from benchmark.compare import compare, judge

    manifest = manifest or harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell, cfg, mix, limits = harness.cell_spec(workload, manifest)
    with tempfile.TemporaryDirectory(prefix="bench-control-") as tmp:
        run = harness.Run(workload, cfg, mix, seed, device, tmp)
        traffic = run.generator
        traffic.setup()
        traffic.release()
        run.net = None
        imgs = traffic.reference_images()
        if mix["generator"] == "frames":
            idx = sorted(run.rng_check.choice(len(imgs), size=min(mix["check_frames"], len(imgs)),
                                              replace=False).tolist())
        else:
            idx = list(range(len(imgs)))
        sel = [imgs[i] for i in idx]
        ref = harness.reference_rows(run, sel)
        ctl = harness.reference_rows(run, sel, tf32=True)
        numbers = compare(ctl, ref, [traffic.hws[i] for i in idx])
    return judge(numbers, limits)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        judged = control_numbers(args.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(ok for _, _, ok in judged.values()),
                          "numbers": {k: v for k, (v, _, _) in judged.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
