"""The benchmark of ``edgeml_tpu_torch`` (the PyTorch/CUDA port) on NVIDIA
GPUs: ``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root. ``BENCHMARK.json`` names the cells;
configurations, traffic mixes, correctness limits and per-layer metrics are
files of their own under this folder, found by name."""
