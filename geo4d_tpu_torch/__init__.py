"""geo4d_tpu_torch — the PyTorch/CUDA port of geo4d_tpu for one NVIDIA H100.

Same subpackage layout as the JAX package, channels-last activations:
  core/       numpy noise-schedule tables, YAML config and model registry,
              stage timer and span recorder, host C++ library builds
  data/       CLIP tokenizer, frame and video loading (PNG and JPEG read
              and written: no Pillow), evaluation datasets, their
              preparation and Sintel's dynamic masks, the training batch
              sampler, data module and crops, the training-set
              preprocessors, habitat crops and the ScanNet .sens reader
  ops/        kernel gate and loader; GroupNorm, spatial and temporal
              attention and the aligner's objective wrappers, each with
              its plain PyTorch version
  csrc/       the hand-written CUDA kernels (built with nvcc at first use)
              and the host JPEG decoder and encoder (built with g++ at
              first use)
  nn/         basics, attention stack, CLIP text and vision towers, resampler
  models/     UNet3D, AutoencoderKL, GeoDiffusion, presets, checkpoint loader
  sampling/   DDIM
  geometry/   masks, denormalisation, Plücker -> cameras, SE3/Sim3 codecs,
              MoGe focal recovery, RANSAC-PnP, rigid flow and warping,
              OpenCV's camera distortion models, the mesh rasteriser
  evals/      the IRLS scale-shift fit of the aligner's calibration,
              trajectory metrics
  alignment/  group aligner, its initialisation, point-cloud cleanup
  pipeline/   WindowPredictor, align_predictions, reconstruct, results export
  training/   diffusion loss, AdamW + EMA step, batch builders, VAE GAN step
  parallel/   process mesh (torch.distributed), sharded collectives, dry runs
  cli/        the inference, evaluation and training CLIs and their model
              building
  tools/      the aligner profile on the card, the long-sequence run
  viz/        the 4D viewer of a results directory (HTML export and a
              websocket server)

The port imports nothing of JAX, Flax, Optax, OpenCV or Pillow, and nothing of the
JAX package `geo4d_tpu`: the few numpy-only pieces it needs from there
(trajectory metrics, results export, YAML config, tokenizer, frame loading,
the sampler, data module and crops, the offline tools and the viewer)
are its own copies, held equal to the originals by tests/test_torch_*.py.

The top-level names below load their module on first access, so `import
geo4d_tpu_torch` stays free of torch.cuda work.
"""

__version__ = "0.1.0"

_LAZY = {
    "GeoDiffusion": ("geo4d_tpu_torch.models.diffusion", "GeoDiffusion"),
    "UNet3D": ("geo4d_tpu_torch.models.unet3d", "UNet3D"),
    "AutoencoderKL": ("geo4d_tpu_torch.models.autoencoder", "AutoencoderKL"),
    "DiffusionSchedule": ("geo4d_tpu_torch.core.schedules", "DiffusionSchedule"),
    "GroupAligner": ("geo4d_tpu_torch.alignment.optimizer", "GroupAligner"),
    "AlignerConfig": ("geo4d_tpu_torch.alignment.optimizer", "AlignerConfig"),
    "InferenceConfig": ("geo4d_tpu_torch.pipeline.inference", "InferenceConfig"),
    "reconstruct": ("geo4d_tpu_torch.pipeline.inference", "reconstruct"),
    "build_from_yaml": ("geo4d_tpu_torch.core.registry", "build_from_yaml"),
    "flagship": ("geo4d_tpu_torch.models.presets", "flagship"),
    "tiny": ("geo4d_tpu_torch.models.presets", "tiny"),
    "WindowPredictor": ("geo4d_tpu_torch.pipeline.inference", "WindowPredictor"),
    "save_results_dir": ("geo4d_tpu_torch.pipeline.export", "save_results_dir"),
    "DataModule": ("geo4d_tpu_torch.data.loader", "DataModule"),
    "ViewerServer": ("geo4d_tpu_torch.viz.server", "ViewerServer"),
    "init_from_group": ("geo4d_tpu_torch.alignment.init", "init_from_group"),
}


def __getattr__(name):
    """The lazy top-level API of the JAX package's __init__, from the port's
    modules; `init_params` is not ported (init_random_ fills a model)."""
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    if name == "init_params":
        raise AttributeError("module 'geo4d_tpu_torch' has no attribute 'init_params': "
                             "build a model with geo4d_tpu_torch.models.presets and fill it "
                             "with init_random_")
    raise AttributeError(f"module 'geo4d_tpu_torch' has no attribute {name!r}")
