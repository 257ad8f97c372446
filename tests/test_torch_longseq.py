"""The port's long-sequence run (geo4d_tpu_torch/tools/longseq.py) against
scripts/longseq_proof.py: its windows equal the JAX package's
`sliding_windows` (25 for 110 frames), its copy of `synth_predictions`
equals the script's function (taken from the script's source with `ast`:
importing the script would enable a JAX compile cache), and `run_longseq`
on the tiny preset on the CPU returns every key of the record with finite
values; the CLI prints the record and writes it to --out."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from geo4d_tpu.data.video import sliding_windows as jax_sliding_windows
from geo4d_tpu_torch.models.presets import init_random_, tiny
from geo4d_tpu_torch.pipeline.inference import sliding_windows
from geo4d_tpu_torch.tools import longseq

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("frames", "resolution", "windows", "diffusion_s", "diffusion_warm_s",
        "align_ctor_init_s", "align_run_s", "align_cold_ctor_init_s", "align_cold_run_s",
        "e2e_s", "sec_per_frame", "frames_per_sec", "peak_bytes_diffusion", "peak_bytes_align",
        "device", "note")
TIMES = ("diffusion_s", "diffusion_warm_s", "align_ctor_init_s", "align_run_s",
         "align_cold_ctor_init_s", "align_cold_run_s", "e2e_s", "sec_per_frame",
         "frames_per_sec")


def script_synth_predictions():
    """`synth_predictions` of scripts/longseq_proof.py, executed alone."""
    path = os.path.join(REPO, "scripts", "longseq_proof.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "synth_predictions")
    scope = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), scope)
    return scope["synth_predictions"]


@pytest.mark.parametrize("n", [16, 17, 20, 31, 110])
def test_windows_match_jax(n):
    got = sliding_windows(n, 16, 4)
    np.testing.assert_array_equal(got, jax_sliding_windows(n, 16, 4))
    if n == 110:
        assert got.shape == (25, 16)


@pytest.mark.parametrize("n,hw,seed", [(20, (8, 12), 0), (110, (6, 10), 1)])
def test_synth_predictions_match_the_script(n, hw, seed):
    groups = sliding_windows(n, 16, 4)
    got = longseq.synth_predictions(groups, *hw, seed=seed)
    want = script_synth_predictions()(groups, *hw, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_run_longseq_tiny_on_the_cpu():
    model = init_random_(tiny(temporal_length=16, device="meta"), "cpu", seed=0).eval()
    seen = {}

    def check(preds):
        seen.update({k: tuple(v.shape) for k, v in preds.items()})
        assert all(bool(torch.isfinite(v.float()).all()) for v in preds.values())

    rec = longseq.run_longseq(model, np.zeros((1, 77, 64), np.float32), frames=20, hw=(32, 64),
                              window_batch=5, n_iter=5, device="cpu", check=check)
    assert set(KEYS) <= set(rec)
    assert rec["frames"] == 20 and rec["windows"] == 2 and rec["resolution"] == "64x32"
    assert seen["pts3d"] == (2, 16, 32, 64, 3) and seen["conf"] == (2, 16, 32, 64)
    for k in TIMES:
        assert np.isfinite(rec[k]) and rec[k] > 0, k
    assert rec["e2e_s"] == pytest.approx(rec["diffusion_s"] + rec["align_ctor_init_s"]
                                         + rec["align_run_s"])
    assert rec["peak_bytes_diffusion"] is None and rec["device"] == "cpu"   # no card here
    assert "align_pnp" in rec["align_stage_s"] and "decode" in rec["diffusion_stage_s"]
    assert np.isfinite(rec["align_final_loss"])
    json.dumps(rec)


def test_cli_prints_and_writes_the_record(tmp_path, capsys):
    out = tmp_path / "longseq.json"
    assert longseq.main(["--tiny", "--device", "cpu", "--frames", "16", "--out", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(out.read_text())
    assert printed["windows"] == 1 and printed["resolution"] == "64x32"
