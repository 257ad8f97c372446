"""A cell at the port's tiny preset's sizes (float32, on the CPU), for the
benchmark's CPU tests: the drivers, the reference and the checks run as on
the card, with the kernels' plain versions."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
VAE = {"ch": 16, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 1, "z_channels": 4, "embed_dim": 4,
       "in_channels": 3, "out_ch": 3, "double_z": True, "adaptor_ch": 16,
       "adaptor_num_res_blocks": 1, "adaptor_out_ch": 1}
MODEL = {
    "unet": {"in_channels": 20, "out_channels": 16, "model_channels": 32, "num_res_blocks": 1,
             "attention_resolutions": [1, 2], "channel_mult": [1, 2], "num_head_channels": 16,
             "transformer_depth": 1, "context_dim": 64, "temporal_length": 4,
             "temporal_conv": True, "temporal_attention": True, "use_relative_position": False,
             "use_causal_attention": False, "addition_attention": True,
             "image_cross_attention": True, "fs_condition": True, "task_condition": False,
             "default_fs": 24},
    "vae": {"cfg": VAE, "with_adaptor": False},
    "pointmap_vae": {"cfg": VAE, "with_adaptor": True},
    "image_encoder": {"width": 48, "heads": 4, "layers": 2, "patch_size": 14, "image_size": 224},
    "resampler": {"dim": 64, "depth": 1, "dim_head": 16, "heads": 4, "num_queries": 16,
                  "embedding_dim": 48, "output_dim": 64, "ff_mult": 4, "video_length": 4},
    "text_encoder": {"vocab_size": 49408, "width": 64, "heads": 4, "layers": 2,
                     "context_length": 77, "penultimate": True},
}


def _load(path):
    with open(BENCH_DIR / path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    """The named cell of BENCHMARK.json with the tiny model, float32, and
    its traffic cut to a few small frames."""
    bench = _load("../BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    conf_file = {c["name"]: c for c in bench["configs"]}[entry["config"]]["file"]
    config = _load("../" + conf_file)
    model = copy.deepcopy(MODEL)
    model.update(schedule=config["model"]["schedule"], scale_factor=config["model"]["scale_factor"],
                 modality=config["model"]["modality"])
    config = dict(config, model=model, dtype="float32")
    traffic = _load(f"traffic/{entry['traffic']}.json")
    if traffic["driver"] == "reconstruct":
        config["inference"] = dict(config["inference"], window=4, stride=2)
        config["aligner"] = dict(config["aligner"], n_iter=8, depth_traj_start_iter=4)
        traffic = dict(traffic, frames=6, height=32, width=64, videos=2, warm_iters=5)
    else:
        config["training"] = dict(config["training"], temporal_length=4)
        traffic = dict(traffic, frames=4, height=32, width=64, trace_units=2)
    limits = _load(f"cells/{name}.json")["limits"]

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"entry": entry, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": reported(bench["end_to_end"]), "per_layer": reported(bench["per_layer"])}
