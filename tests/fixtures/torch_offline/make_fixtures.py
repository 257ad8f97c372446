"""Writes the JAX package's outputs of the offline tools on the seeded raw
data of geo4d_tpu_torch/tools/offline_check.py (needs the JAX package with
its OpenCV and Pillow; run from the repo root):

    python tests/fixtures/torch_offline/make_fixtures.py

  expected/<case>/   what geo4d_tpu's preparers, habitat crops, .sens export
                     and mesh rasteriser write for each case of
                     offline_check.CASES, seed 0

The raw files are not kept: offline_check.write_raw writes them again from
the seed with the port's encoders (the bytes Pillow and OpenCV write), so
the card, which has neither, reads the inputs the JAX package read here.
chip_smoke.py's `offline` phase and tests/test_torch_preprocess_train.py
hold the port's outputs to these.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))
SEED = 0


def main():
    from geo4d_tpu.data import habitat_prep, preprocess, preprocess_train, sens_reader
    from geo4d_tpu.geometry import raster
    from geo4d_tpu_torch.tools import offline_check as oc

    mods = types.SimpleNamespace(preprocess_train=preprocess_train, habitat_prep=habitat_prep,
                                 sens_reader=sens_reader, raster=raster, preprocess=preprocess)
    out = os.path.join(HERE, "expected")
    shutil.rmtree(out, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        man = oc.write_raw(tmp, SEED)
        for case in oc.CASES:
            oc.run_case(case, tmp, out, man, mods, seed=SEED)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(out) for f in fs)
    print(f"wrote {len(oc.list_tree(out))} files, {size} bytes, under {out}")


if __name__ == "__main__":
    main()
