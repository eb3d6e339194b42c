"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``; each defines ``read(ctx)`` and returns a number or None
when it finds nothing to read.

``ctx`` (``harness.main``, ``--trace 1`` runs): ``spans`` (the generator's
own host spans over the window), ``window_s``, ``flops_window`` and
``flops_traced`` (model FLOPs of the window's and the traced sub-window's
requests), ``f32_peak`` (None off the card), ``trace``
(``trace.summarize`` of the traced sub-window: ``busy_s``, ``window_s``,
``conv_s``, ``by_span``, ``breakdown``), ``span_records`` (the program's
span records over the window) and ``span_readings``
(``spans.readings`` of those and ``by_span``). A reading that
``spans.readings`` lacks is computed by its reader from ``span_records``
or ``trace["by_span"]``."""
