"""Frame by frame serving, closed loop, one client: decoded frames handed
to the program one at a time, in a cycle over the seeded images; the next
frame is handed over when the previous one's rows are on the host.

Mix parameters: ``images``, ``shapes``, ``calib_images``, ``warmup_frames``,
``trace_frames``, ``check_frames`` (how many of the served frames, drawn
from the seed, the reference checks).

End-to-end numbers: ``frame_p50_ms`` and ``frame_p95_ms``, the median and
95th percentile over every frame of the window of the time from handing a
frame over to its rows being on the host (``BENCHMARK.json`` picks which it
reports). Span: ``prep``, the seconds of each frame's host preparation (the
configuration family's ``prep``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
from torch.profiler import record_function

from benchmark import images


class Generator:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.served, self.rows = [], []
        self.ref_block = 1

    def setup(self):
        run, mix = self.run, self.mix
        pixels = images.make(run.gen_inputs, mix["images"], mix["shapes"], run.device)
        # the arrays an image decoder hands over: HWC float32 in [0, 1]
        self.frames = [p.astype(np.float32) / 255.0 for p in pixels]
        self.hws = [p.shape[:2] for p in pixels]
        del pixels
        run.make_model(self.frames[:mix["calib_images"]])
        self.next = 0
        self._serve(mix["warmup_frames"], [], [], keep=False)
        self.next = 0

    def _serve(self, count, lat, prep, seconds=None, keep=True):
        """Serve ``count`` frames, or frames until ``seconds`` have elapsed."""
        run = self.run
        n = len(self.frames)
        t_start = time.perf_counter()
        done = 0
        while True:
            i = self.next % n
            t0 = time.perf_counter()
            with record_function("bench.prep"):
                p = run.family.prep(run.cfg, self.frames[i])
            t1 = time.perf_counter()
            rows = run.family.step(run.net, run.cfg, p, run.device)
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            prep.append(t1 - t0)
            if keep:
                self.served.append(i)
                self.rows.append(rows)
            self.next += 1
            done += 1
            if (seconds is None and done >= count) or \
                    (seconds is not None and t2 - t_start >= seconds):
                return t2 - t_start

    def window(self, seconds):
        lat, prep = [], []
        first = len(self.served)
        elapsed = self._serve(None, lat, prep, seconds=seconds)
        ms = np.asarray(lat) * 1e3
        print(f"frames in the window: {len(ms)}", file=sys.stderr)
        self.attempted = len(ms)
        return ({"frame_p50_ms": float(np.percentile(ms, 50)),
                 "frame_p95_ms": float(np.percentile(ms, 95))},
                {"prep": prep}, self.served[first:], elapsed)

    def traced(self):
        first = len(self.served)
        self._serve(self.mix["trace_frames"], [], [])
        return self.served[first:]

    def release(self):
        pass

    def reference_images(self):
        return self.frames

    def answers(self):
        """(image indices, the program's rows for them, missing answers): a
        sample of the served frames drawn from the seed."""
        k = min(self.mix["check_frames"], len(self.served))
        pick = np.sort(self.run.rng_check.choice(len(self.served), size=k, replace=False))
        return [self.served[j] for j in pick], [self.rows[j] for j in pick], 0
