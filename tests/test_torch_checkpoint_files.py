"""The port's checkpoint loader (models/convert.py) on checkpoint files in
the layouts of the reference's infer_geo4d.py, each carrying a non-tensor
entry that `weights_only` unpickling refuses (an argparse.Namespace, as
Lightning's `hyper_parameters` and DeepSpeed's client state hold):

  Lightning  {"state_dict": {...}, "hyper_parameters": Namespace}, with the
             legacy `framestride_embed` keys
  DeepSpeed  {"module": {"_forward_module.<key>": ...}, "client": Namespace}
  vae.ckpt   {"state_dict": {"model.<key>": ...}, "hyper_parameters": Namespace}

Each loads as the JAX package's loader loads it (geo4d_tpu/cli/common.py
`load_torch_checkpoint`: the same warning, then full unpickling; the same
tensors after `strip_prefixes`), and every tower of the tiny preset is
filled bit for bit. A plain tensor checkpoint loads without the warning; a
path that does not exist raises (the JAX package skips it)."""

import argparse

import pytest
import torch

from geo4d_tpu.cli.common import load_torch_checkpoint as jax_load_torch_checkpoint
from geo4d_tpu.models.convert import strip_prefixes as jax_strip_prefixes
from geo4d_tpu_torch.models.convert import (CKPT_PREFIXES, TOWER_MODULES, load_checkpoints,
                                            load_torch_checkpoint, strip_prefixes)
from geo4d_tpu_torch.models.presets import init_random_, tiny

torch.set_num_threads(1)
WARNING = ("not a plain-tensor checkpoint; falling back to full unpickling — only load "
           "trusted files")
HPARAMS = argparse.Namespace(lr=1e-5, base="configs/inference_geo4d.yaml", seed=123)


@pytest.fixture(scope="module")
def source():
    return init_random_(tiny(temporal_length=4, device="meta"), "cpu", seed=4)


def model_state(model):
    """The published model checkpoint's keys: every tower but the pointmap
    VAE under its prefix."""
    return {prefix + k: v.clone() for t, prefix in CKPT_PREFIXES.items()
            for k, v in getattr(model, TOWER_MODULES[t]).state_dict().items()}


def write_layouts(model, d):
    sd = model_state(model)
    legacy = {k.replace("fps_embedding", "framestride_embed"): v for k, v in sd.items()}
    assert any("framestride_embed" in k for k in legacy)
    paths = {"lightning": d / "model_lightning.ckpt", "deepspeed": d / "model_deepspeed.ckpt",
             "vae": d / "vae.ckpt"}
    torch.save({"state_dict": legacy, "hyper_parameters": HPARAMS, "epoch": 3,
                "global_step": 1000}, paths["lightning"])
    torch.save({"module": {f"_forward_module.{k}": v for k, v in sd.items()},
                "client": HPARAMS}, paths["deepspeed"])
    torch.save({"state_dict": {f"model.{k}": v.clone()
                               for k, v in model.pointmap_vae.state_dict().items()},
                "hyper_parameters": HPARAMS}, paths["vae"])
    return paths


@pytest.mark.parametrize("layout", ["lightning", "deepspeed"])
def test_container_checkpoints_load_every_tower(layout, source, tmp_path, capsys):
    paths = write_layouts(source, tmp_path)
    with pytest.raises(Exception):      # what the loader used to do: weights_only refuses it
        torch.load(paths[layout], map_location="cpu", weights_only=True)

    got = init_random_(tiny(temporal_length=4, device="meta"), "cpu", seed=3)
    report = load_checkpoints(got, str(paths[layout]), str(paths["vae"]), verbose=False)
    out = capsys.readouterr().out
    assert out.count(WARNING) == 2, out          # the model checkpoint and vae.ckpt
    assert set(report) == set(TOWER_MODULES)
    want = source.state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("layout", ["lightning", "deepspeed", "vae"])
def test_loader_reads_what_jax_reads(layout, source, tmp_path, capsys):
    path = str(write_layouts(source, tmp_path)[layout])
    got = load_torch_checkpoint(path)
    port_out = capsys.readouterr().out
    want = jax_load_torch_checkpoint(path)
    jax_out = capsys.readouterr().out
    assert port_out == jax_out and f"[ckpt] WARNING: {path} is {WARNING}" in port_out
    got, want = strip_prefixes(got), jax_strip_prefixes(want)
    assert got.keys() == want.keys()
    for k, v in got.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, want[k]), k
        else:
            assert v == want[k], k


def test_plain_checkpoint_loads_without_warning_and_missing_path_raises(source, tmp_path,
                                                                        capsys):
    path = tmp_path / "plain.ckpt"
    torch.save({"state_dict": model_state(source)}, path)
    sd = load_torch_checkpoint(str(path))
    assert capsys.readouterr().out == ""
    assert all(torch.equal(v, sd["state_dict"][k]) for k, v in model_state(source).items())
    with pytest.raises(FileNotFoundError):
        load_torch_checkpoint(str(tmp_path / "missing.ckpt"))
    got = init_random_(tiny(temporal_length=4, device="meta"), "cpu", seed=3)
    with pytest.raises(FileNotFoundError):
        load_checkpoints(got, None, str(tmp_path / "missing_vae.ckpt"), verbose=False)
