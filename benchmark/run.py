"""The renderer's benchmark: one run of one cell.

    python3 benchmark/run.py --workload cornell.final --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout, on a machine with as many CUDA devices
as the cell asks for.  The cell, its configuration and its traffic mix
are read from `BENCHMARK.json` and the files it names; `harness.py` says
what a run does.  The last line of standard output is the run's result as
one JSON object; the numbers that decide `correct` are also the last lines
of standard error."""
import os
import sys
import time

START = time.perf_counter()   # set-up counts from here

if __name__ == "__main__":
    # the renderer's package sits at the checkout's root
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from harness import main
    sys.exit(main(sys.argv[1:], START))
