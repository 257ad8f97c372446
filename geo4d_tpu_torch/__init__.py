"""geo4d_tpu_torch — the PyTorch/CUDA port of geo4d_tpu for one NVIDIA H100.

Same subpackage layout as the JAX package, channels-last activations:
  core/       numpy noise-schedule tables
  ops/        kernel gate and loader; GroupNorm, spatial and temporal
              attention wrappers, each with its plain PyTorch version
  csrc/       the hand-written CUDA kernels (built with nvcc at first use)
  nn/         basics, attention stack, CLIP vision tower, resampler
  models/     UNet3D, AutoencoderKL, GeoDiffusion, presets, weights bridge
  sampling/   DDIM
  geometry/   masks, denormalisation, Plücker -> cameras
  pipeline/   WindowPredictor (the diffusion stage)
"""
