"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``; each defines ``read(ctx)`` and returns a number or None
when it finds nothing to read."""
