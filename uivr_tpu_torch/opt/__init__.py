from . import losses  # noqa: F401
from .checkpoint import load_state, save_state  # noqa: F401
from .loop import (  # noqa: F401
    OptimizationConfig, gather_ref_values, load_checkpoint, load_references,
    render_references, run_optimization, save_checkpoint,
)
from .optimizer import AdamState, adam_init, adam_step, reset_state_like, sgd_step  # noqa: F401
from .schedule import (  # noqa: F401
    Schedule, enforce_valid_params, initial_resolution, learning_rates,
    upsample_iterations, upsample_params,
)
