"""uivr_tpu_torch — the PyTorch/CUDA port of ``uivr_tpu``.

The JAX package ``uivr_tpu`` is the reference; this package keeps its module
layout so each counterpart sits at the same path.  It imports ``torch`` and
never ``jax``.  On ``cuda`` tensors the primal render, the path-replay
adjoint and the delayed DRT term run through hand-written CUDA kernels for
Hopper (``ops/csrc/``); on ``cpu`` tensors through their plain PyTorch
twins (``integrators/volpath_flat.py``).

  core/        device selection, counter-based RNG, ray/box math, grids, EXR, .vol
  scene/       cameras, emitters, phase functions, medium, gradient accumulators
  config/      procedural scenes and the scene/integrator registries
  tracking/    wavefront-counter tracking loops of the delayed DRT term
  integrators/ the flat (one tracking step per iteration) primal and adjoint
  ops/         the CUDA kernels, their build, wrappers and launch counters
  render/      full-frame rendering and the differentiable batch render op
  opt/         losses, Adam/SGD, schedules, checkpoints, the optimization loop
  utils/       image helpers
  validation/  the finite-difference gradient oracle
  cli/         ``python -m uivr_tpu_torch.cli.render``, ``.cli.reproduce``, ``.cli.fd``
"""

__version__ = "0.1.0"
