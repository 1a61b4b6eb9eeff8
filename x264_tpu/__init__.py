"""x264-tpu: an H.264/AVC encoder written in JAX.

A from-scratch re-design of the capabilities of the reference x264 encoder
as batched/wavefront tensor pipelines under JAX/XLA for the
analysis+transform path, vectorized/native host code for the serial
entropy stage, and jax.sharding meshes in place of pthread parallelism.
"""

__version__ = "0.1.0"
X264_TPU_BUILD = 165  # capability parity target: reference X264_BUILD 165

from . import params  # noqa: F401
from .params import (  # noqa: F401
    Params, param_default, param_default_preset, param_parse,
    param_apply_profile, param_apply_fastfirstpass, ParamError,
)
