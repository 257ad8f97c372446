"""geo4d_tpu_torch — the PyTorch/CUDA port of geo4d_tpu for one NVIDIA H100.

Same subpackage layout as the JAX package, channels-last activations:
  core/       numpy noise-schedule tables, YAML config and model registry,
              stage timer
  data/       CLIP tokenizer, frame and video loading (PNG, JPEG: no
              Pillow), evaluation datasets, their preparation and Sintel's
              dynamic masks, the training batch sampler, data module and
              crops
  ops/        kernel gate and loader; GroupNorm, spatial and temporal
              attention wrappers, each with its plain PyTorch version
  csrc/       the hand-written CUDA kernels (built with nvcc at first use)
              and the host JPEG decoder (built with g++ at first use)
  nn/         basics, attention stack, CLIP text and vision towers, resampler
  models/     UNet3D, AutoencoderKL, GeoDiffusion, presets, checkpoint loader
  sampling/   DDIM
  geometry/   masks, denormalisation, Plücker -> cameras, SE3/Sim3 codecs,
              MoGe focal recovery, RANSAC-PnP, rigid flow and warping
  evals/      the IRLS scale-shift fit of the aligner's calibration,
              trajectory metrics
  alignment/  group aligner, its initialisation, point-cloud cleanup
  pipeline/   WindowPredictor, align_predictions, reconstruct, results export
  training/   diffusion loss, AdamW + EMA step, batch builders, VAE GAN step
  parallel/   process mesh (torch.distributed), sharded collectives, dry runs
  cli/        the inference, evaluation and training CLIs and their model
              building
  tools/      the aligner profile on the card

The port imports nothing of JAX, Flax, Optax, OpenCV or Pillow, and nothing of the
JAX package `geo4d_tpu`: the few numpy-only pieces it needs from there
(trajectory metrics, results export, YAML config, tokenizer, frame loading,
the sampler, data module and crops)
are its own copies, held equal to the originals by tests/test_torch_*.py.
"""
