"""Runs one cell as run.py does, with the port's span recorder installed over
the profiled units of a traced run (harness/spans.py), from the root of a
checkout:

    python3 benchmark/run_spans.py --workload <name> --seed <n> --seconds <s> --trace 1

The result line is run.py's with `span_metrics` added before `check`: the
readings of the span table (`spans.METRICS`). The span table, the idle time
by span and the attribution of the device time go to standard error. With
`--trace 0` it is run.py.
"""

import sys

import run  # the caches, the environment and sys.path of a benchmark run
from harness import runner, spans

if __name__ == "__main__":
    runner.run = spans.recording_runner(runner.run)
    sys.exit(run.main())
