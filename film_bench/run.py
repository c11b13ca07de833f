#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch + CUDA port on the card.

  python3 film_bench/run.py --workload pair-1080p --seed 7 --seconds 30 \
      --trace 0

See film_bench/bench.py. Set-up is counted from this process's start.
"""
import time

_STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from film_bench import bench  # noqa: E402

if __name__ == '__main__':
  age = bench.process_age_s()
  started = time.perf_counter() - age if age is not None else _STARTED
  sys.exit(bench.main(sys.argv[1:], started))
