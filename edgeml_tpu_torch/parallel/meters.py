"""Windowed metric meters: SmoothedValue and MetricLogger.

A host copy of the reference package's ``parallel/meters.py`` (the
torchvision references' meters). Under several processes
``synchronize_between_processes`` sums every meter's (count, total) over
the ranks in float64 (``parallel/mesh.py all_sum``); in one process it is a
no-op.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque

import numpy as np
import torch

from .mesh import all_sum, world_size


class SmoothedValue:
    """Track a series with a smoothing window and global (cross-process)
    count/total statistics."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum count/total across processes (no-op single-process)."""
        if world_size() == 1:
            return
        agg = all_sum(torch.tensor([self.count, self.total],
                                   dtype=torch.float64))
        self.count = int(agg[0])
        self.total = float(agg[1])

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median,
            avg=self.avg,
            global_avg=self.global_avg,
            max=self.max,
            value=self.value,
        )


class MetricLogger:
    """Iteration logger with ETA, the torchvision references' log_every
    loop without its CUDA memory report."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and total:
                eta = datetime.timedelta(
                    seconds=int(iter_time.global_avg * (total - i))
                )
                print(
                    self.delimiter.join(
                        [
                            header,
                            f"[{i}/{total}]",
                            f"eta: {eta}",
                            str(self),
                            f"time: {iter_time}",
                            f"data: {data_time}",
                        ]
                    )
                )
            i += 1
            end = time.time()
        print(
            f"{header} Total time: "
            f"{datetime.timedelta(seconds=int(time.time() - start))}"
        )
