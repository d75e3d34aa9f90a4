"""One run of one benchmark cell of the PyTorch port on the card:

    python3 benchmark/run.py --workload flagship.live --seed 7 --seconds 30 --trace 0

The last line of standard output is the result (JSON); the numbers the
comparison judged are the last lines of standard error.  Exits non-zero,
with no result, when no card is visible or the run cannot be judged.
"""

import sys
import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    root = str(Path(__file__).resolve().parent.parent)
    # The repo root on the path (for ``benchmark`` and the port), and not
    # this folder, whose modules would shadow the standard library's.
    sys.path[0] = root
    from benchmark.harness import main

    sys.exit(main(started=STARTED))
