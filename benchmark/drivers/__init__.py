"""One driver per kind of work a cell's traffic names (`"driver"` in
traffic/<traffic>.json). A driver is a class `Driver(config, traffic,
seed, device)` with:

  setup()              the program's model and state from the seed, and the
                       cell's own shapes warmed; sets `setup_split`
  run_unit(timer)      the next unit of work through the program's entry
                       point; returns the work it did by kind (frames,
                       steps, ...), which the metric readers divide by
  flops_per_work()     model FLOPs per unit of a kind of work
  release()            frees the program's state
  check()              (numbers, answers compared): the sampled outputs
                       against the reference, numbers named as in
                       cells/<cell>.json's limits
"""
