from .schedule import (
    InterpolationStateList,
    Plan,
    Task,
    normalize_multipliers,
    plan_bisection,
    plan_midpoint,
    plan_timestep,
    plan_window4,
)
from .frames import (
    assert_batch_size,
    pad_size,
    pad_to_multiple,
    postprocess_frames,
    preprocess_frames,
    unpad,
)
from .loop import run_plan, run_plan_pair_cached, run_plan_window4
from .config import get_ckpt_container_path, load_config
