"""Model functions and parameter packing (counterpart of
``clustertracking_tpu/models``)."""
from .registry import MODELS, ModelSpec, get_model, register_model
from .packing import (
    MODE_CODES,
    ParamLayout,
    build_layout,
    default_param_mode,
    param_names_for,
)

__all__ = [
    "MODELS",
    "ModelSpec",
    "get_model",
    "register_model",
    "MODE_CODES",
    "ParamLayout",
    "build_layout",
    "param_names_for",
    "default_param_mode",
]
