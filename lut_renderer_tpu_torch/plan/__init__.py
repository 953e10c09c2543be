from .policy import (
    ColorTags,
    FilterStep,
    RenderSpec,
    StreamcopyFilterError,
    build_render_spec,
    supports_10bit,
    normalize_matrix_name,
)
from .pipeline import Stage, build_pipeline, build_master_params

__all__ = [
    "ColorTags",
    "FilterStep",
    "RenderSpec",
    "StreamcopyFilterError",
    "build_render_spec",
    "supports_10bit",
    "normalize_matrix_name",
    "Stage",
    "build_pipeline",
    "build_master_params",
]
