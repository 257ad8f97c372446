"""The benchmark's shared code: finding a cell's files, the run loop, seeded
inputs and weights, the reference's checks, traces, FLOPs and rooflines."""
