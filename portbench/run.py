#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card(s) of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their metrics and bounds are in
BENCHMARK.json; ``harness.py`` says what a run does. Exits non-zero, and
prints no result, without the card(s) the cell asks for.
"""

import os
import sys
import time

if __name__ == "__main__":
    t_top = time.time()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench import harness

    os.environ.update(harness.run_environment())
    try:
        t_process = harness.process_start_time()
    except (OSError, ValueError, IndexError):
        t_process = t_top
    sys.exit(harness.main(sys.argv[1:], t_process))
