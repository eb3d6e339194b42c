"""Offline serving of an image directory: whole passes of the program's
``run_detection`` over seeded JPEG files, writing one ``.npy`` detection
file per image.

Mix parameters: ``images``, ``shapes``, ``batch_size``, ``jpeg_quality``,
``calib_images`` (the first images whose statistics calibrate the seeded
weights), ``trace_passes``.

End-to-end number: ``serve_img_s``, images whose files were written over
the window's whole time; passes start until the window's seconds have
elapsed, and the window ends when the last pass ends. Span:
``loader_wait``, the seconds ``run_detection`` waited for each prepared
batch (its ``iter_batches`` wrapped in the program's namespace for the run).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from torch.profiler import record_function

from benchmark import images
from benchmark.reference.common import decode_jpeg


class Generator:
    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.waits = []
        self.saved = None
        self.ref_block = self.mix["batch_size"]

    def _wrap_loader(self):
        from edgeml_tpu_torch.models import infer

        orig = infer.iter_batches
        waits = self.waits

        def timed(*args, **kwargs):
            it = orig(*args, **kwargs)
            try:
                while True:
                    t0 = time.perf_counter()
                    with record_function("bench.loader_wait"):
                        try:
                            item = next(it)
                        except StopIteration:
                            return
                    waits.append(time.perf_counter() - t0)
                    yield item
            finally:
                it.close()

        self.saved = (infer, orig)
        infer.iter_batches = timed

    def setup(self):
        run, mix = self.run, self.mix
        n = mix["images"]
        pixels = images.make(run.gen_inputs, n, mix["shapes"], run.device)
        self.img_dir = os.path.join(run.tmp, "images")
        self.paths = images.write_jpegs(pixels, self.img_dir, mix["jpeg_quality"])
        self.hws = [p.shape[:2] for p in pixels]
        del pixels
        calib = [decode_jpeg(p) for p in self.paths[:mix["calib_images"]]]
        run.make_model(calib)
        self._wrap_loader()
        warm = os.path.join(run.tmp, "warm")
        os.makedirs(warm)
        for p in self.paths[:mix["batch_size"]]:
            os.link(p, os.path.join(warm, os.path.basename(p)))
        self._pass(warm, os.path.join(run.tmp, "warm_out"))
        self.out_dir = os.path.join(run.tmp, "out")

    def _pass(self, img_dir, out_dir):
        from edgeml_tpu_torch.models.infer import run_detection

        run = self.run
        run_detection(run.net, img_dir, out_dir, batch_size=self.mix["batch_size"],
                      fmt="npy", device=run.device, **run.family.serve_kwargs(run.cfg))

    def window(self, seconds):
        """Whole passes until ``seconds`` have elapsed. Returns (end-to-end
        numbers, spans, served image indices)."""
        self.waits.clear()
        n = self.mix["images"]
        t0 = time.perf_counter()
        passes = 0
        while True:
            self._pass(self.img_dir, self.out_dir)
            passes += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.attempted = passes * n
        return ({"serve_img_s": passes * n / elapsed}, {"loader_wait": list(self.waits)},
                list(range(n)) * passes, elapsed)

    def traced(self):
        """The traced sub-window: ``trace_passes`` whole passes. Returns the
        served image indices."""
        for _ in range(self.mix["trace_passes"]):
            self._pass(self.img_dir, self.out_dir)
        return list(range(self.mix["images"])) * self.mix["trace_passes"]

    def release(self):
        if self.saved is not None:
            infer, orig = self.saved
            infer.iter_batches = orig
            self.saved = None

    def reference_images(self):
        """Every image as the reference reads it: decoded from its file."""
        with ThreadPoolExecutor(max_workers=8) as pool:
            return list(pool.map(decode_jpeg, self.paths))

    def answers(self):
        """(image indices, the program's rows for them, missing files): the
        files the last pass wrote, every image."""
        rows, missing = [], 0
        for p in self.paths:
            stem = os.path.splitext(os.path.basename(p))[0]
            f = os.path.join(self.out_dir, stem + ".npy")
            if os.path.isfile(f):
                rows.append(np.load(f))
            else:
                rows.append(np.zeros((0, 6), np.float32))
                missing += 1
        return list(range(len(self.paths))), rows, missing
