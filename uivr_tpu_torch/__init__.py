"""uivr_tpu_torch — the PyTorch/CUDA port of ``uivr_tpu``.

The JAX package ``uivr_tpu`` is the reference; this package keeps its module
layout so each counterpart sits at the same path.  It imports ``torch`` and
never ``jax``.  The primal volumetric render runs through a hand-written
CUDA kernel for Hopper (``ops/csrc/volpath_primal.cu``) on ``cuda`` tensors
and through its plain PyTorch twin (``integrators/volpath_flat.py``) on
``cpu`` tensors.

  core/        device selection, counter-based RNG, ray/box math, grids, EXR
  scene/       cameras, emitters, phase functions, medium, scene tuples
  config/      procedural scenes and the scene/integrator registries
  integrators/ the flat (one tracking step per iteration) primal estimator
  ops/         the CUDA kernels, their build, wrappers and launch counters
  render/      full-frame and batched primal rendering
  cli/         ``python -m uivr_tpu_torch.cli.render``
"""

__version__ = "0.1.0"
