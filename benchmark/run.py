"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of standard
output (``benchmark/harness.py``); exits non-zero, printing no result,
without a CUDA card.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the CPU's share: load from one process with few
# threads, and no idle pool spinning beside the thread that drives the card
os.environ["OMP_NUM_THREADS"] = "1"

# the checkout's root, in place of this folder, heads the import path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
