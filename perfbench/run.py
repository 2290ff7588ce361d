"""The benchmark of the port (``src/repro_torch``) on one NVIDIA H100:

  python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  ``harness/run.py`` says what a run does;
``BENCHMARK.json`` at the root lists the cells.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the run inside the checkout, at fixed
# paths, so that only a checkout's first run builds
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "perfbench")]

from harness.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
