"""Run one benchmark cell of edgeml_tpu_torch on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root. Prints one JSON result line last on standard
output, and the numbers of the correctness check, each beside its limit,
last on standard error. Exits non-zero, printing no result, without the
CUDA devices the cell needs or when JAX or the JAX package was loaded.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# every build and kernel cache at a fixed path inside the checkout (the
# port's own nvcc builds go to edgeml_tpu_torch/_build/, also inside it)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main())
