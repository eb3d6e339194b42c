"""One run of one cell: set-up, the measured window, the traced sub-window
(``--trace 1``), the check against the frozen reference, and the result
line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration file (``configs``), the configuration's family
(``families/<family>.py``) and reference, the traffic mix
(``traffic/<mix>.json``) and its generator (``generators/<generator>.py``), the
cell's correctness limits (``limits/<cell>.json``) and each per-layer
metric's reader (``metrics/<metric>.py``).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
BANNED = {"jax", "jaxlib", "flax", "edgeml_tpu"}


def since_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start / os.sysconf("SC_CLK_TCK")


def log(what: str, t0: float) -> float:
    """Print a phase's seconds on standard error; returns the clock."""
    now = time.perf_counter()
    print(f"phase {what}: {now - t0:.3f} s", file=sys.stderr, flush=True)
    return now


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(name: str, manifest: dict):
    """(workload entry, configuration, mix, limits) of cell ``name``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    cfg = load_json(ROOT, conf["file"])
    mix = load_json(HERE, "traffic", cell["traffic"] + ".json")
    limits = load_json(HERE, "limits", name + ".json")
    return cell, cfg, mix, limits


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Run:
    """The state of one run, handed to the traffic generator and the family."""

    def __init__(self, cell, cfg, mix, seed, device, tmp):
        import torch

        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.device, self.tmp = device, tmp
        s_inputs, s_weights, s_check = np.random.SeedSequence(seed).generate_state(3)
        self.gen_inputs = torch.Generator(device=device).manual_seed(int(s_inputs))
        self.gen_weights = torch.Generator(device=device).manual_seed(int(s_weights))
        self.rng_check = np.random.default_rng(int(s_check))
        self.family = importlib.import_module(f"benchmark.families.{cfg['family']}")
        self.generator = importlib.import_module(
            f"benchmark.generators.{mix['generator']}").Generator(self)
        self.sd = self.net = None

    def make_model(self, calib_images):
        """The seeded state dict (made and calibrated on the reference) and
        the program's model holding it."""
        import torch

        sd = self.family.reference.seeded_state(self.cfg, self.gen_weights, self.device,
                                                calib_images)
        self.net = self.family.program(self.cfg, sd, self.device)
        # the reference's copy waits on the host, out of the program's peak
        self.sd = {k: v.cpu() for k, v in sd.items()}
        del sd
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def device_state(self):
        return {k: v.to(self.device) for k, v in self.sd.items()}


def reference_rows(run, imgs, tf32=False):
    """The reference's rows of ``imgs`` in blocks of the batch that the
    program served them in, TF32 on for a control."""
    from benchmark.reference.common import set_tf32

    set_tf32(tf32)
    sd = run.device_state()
    try:
        out = []
        step = run.generator.ref_block
        for s in range(0, len(imgs), step):
            out += run.family.reference.detect(sd, run.cfg, imgs[s:s + step], run.device)
        return out
    finally:
        set_tf32(False)


def check(run, limits):
    """The comparison of the program's answers with the reference's:
    ({name: (number, limit, passed)}, missing answers)."""
    from benchmark.compare import compare, judge

    idx, prog, missing = run.generator.answers()
    imgs = run.generator.reference_images()
    ref = reference_rows(run, [imgs[i] for i in idx])
    numbers = compare(prog, ref, [run.generator.hws[i] for i in idx])
    return judge(numbers, limits), missing


def read_metric(name: str, ctx):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def main(argv=None, device=None) -> int:
    """One run; prints the result line and returns the exit code. ``device``
    other than None skips the look for a card (the harness's own tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = load_json(ROOT, "BENCHMARK.json")
    cell, cfg, mix, limits = cell_spec(args.workload, manifest)

    import torch

    import edgeml_tpu_torch  # noqa: F401  (the system under test, present before anything runs)
    from edgeml_tpu_torch.utils import profiling

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {n}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    from benchmark.reference.common import set_tf32

    set_tf32(False)
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        run = Run(args.workload, cfg, mix, args.seed, device, tmp)
        traffic = run.generator
        t0 = time.perf_counter()
        traffic.setup()
        if cuda:
            torch.cuda.synchronize()
        setup_s = since_start()
        t0 = log("setup (after imports)", t0)
        # the program's spans record in --trace 1 runs only: over the window,
        # then (as annotations in the profile) over the traced sub-window
        traced, served_traced = None, []
        try:
            profiling.reset()
            profiling.enable(bool(args.trace))
            e2e, spans, served, window_s = traffic.window(args.seconds)
            if cuda:
                torch.cuda.synchronize()
            t0 = log("window", t0)
            window_records = profiling.records()
            profiling.reset()
            if args.trace:
                from benchmark.trace import Traced, summarize

                with Traced() as t:
                    served_traced = traffic.traced()
                t0 = log("traced sub-window", t0)
        finally:
            profiling.enable(False)
            profiling.reset()
        if args.trace:
            traced = summarize(t, tmp)
            t0 = log("trace reduction", t0)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        traffic.release()
        run.net = None
        if cuda:
            torch.cuda.empty_cache()
        found = banned_modules()
        if found:
            print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
            return 4
        checks, missing = check(run, limits)
        t0 = log("reference check", t0)
        metrics = {}
        if args.trace:
            kind = torch.cuda.get_device_name(device) if cuda else "cpu"
            from benchmark.peaks import peak as card_peak

            flops_w, flops_t = run.family.request_flops(
                run.device_state(), cfg, traffic.reference_images(), [served, served_traced], device)
            from benchmark.spans import readings

            ctx = SimpleNamespace(spans=spans, window_s=window_s, flops_window=flops_w,
                                  trace=traced, flops_traced=flops_t,
                                  f32_peak=card_peak(kind, "f32_flops") if cuda else None,
                                  span_records=window_records,
                                  span_readings=readings(window_records, traced["by_span"]))
            for m in manifest["per_layer"]:
                if reports(m, args.workload):
                    v = read_metric(m["name"], ctx)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            t0 = log("per-layer metrics", t0)
        else:
            e2e["setup_s"] = setup_s
            for m in manifest["end_to_end"]:
                if reports(m, args.workload):
                    metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    correct = missing == 0 and all(ok for _, _, ok in checks.values())
    out = {"correct": correct, "attempted": traffic.attempted, "failed": missing,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": cell["chips"], "memory_peak_bytes": peak}}
    if traced is not None:
        out["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        out["breakdown"] = traced["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim, _) in checks.items()}
    print(f"card: {card_power_limit() if cuda else 'cpu'}", file=sys.stderr)
    for k, (v, lim, ok) in checks.items():
        rel = ">=" if k == "ref_rows" else "<="
        print(f"check {k} = {v!r} (limit {rel} {lim!r}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
