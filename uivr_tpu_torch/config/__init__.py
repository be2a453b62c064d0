from .scenes import (  # noqa: F401
    SceneBundle, adam_state_from_numpy, bundle_from_numpy, cube_test_grids,
    cube_test_scene, params_from_numpy,
    procedural_sky, procedural_smoke_grids, scene_from_files, smoke_scene,
)
from .registry import (  # noqa: F401
    IntegratorPreset, ScenePreset, add_int_config, add_scene_config,
    add_scene_config_variant, get_int_config, get_scene_config,
    list_int_configs, list_scene_configs,
)
