"""Puts the benchmark's folders and the repository root on sys.path, as
benchmark/run.py does, for the benchmark's tests."""

import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
BENCH_DIR = TESTS.parent
ROOT = BENCH_DIR.parent
for p in (ROOT, BENCH_DIR, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
