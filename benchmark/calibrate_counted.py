"""calibrate.py for a reconstruct cell whose traffic names a driver built on
drivers/reconstruct.py under another name, such as recon.kitti110's
`reconstruct_counted` (calibrate.py reads a reconstruct cell's readings only
for the driver named "reconstruct"), from the root of a checkout:

    python3 benchmark/calibrate_counted.py --workload recon.kitti110 \
        --seeds 1,2,... [--control-seeds 1,2,3] [--no-windows] [--out FILE]

The arguments and the readings are calibrate.py's, through
drivers/reconstruct.py's driver: its calls are the counted driver's without
the counters, which no reading reads.
"""

import calibrate  # its sys.path, with benchmark/ and the checkout's root
from drivers import reconstruct
from harness import spec

_cell = spec.cell


def reconstruct_cell(*args, **kwargs) -> dict:
    """spec.cell's cell with its traffic's driver "reconstruct"."""
    cell = _cell(*args, **kwargs)
    assert issubclass(spec.driver(cell["traffic"]), reconstruct.Driver), cell["traffic"]["driver"]
    return dict(cell, traffic=dict(cell["traffic"], driver="reconstruct"))


if __name__ == "__main__":
    spec.cell = reconstruct_cell
    calibrate.main()
