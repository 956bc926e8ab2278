"""The LM substrate's dense family (``common``, ``layers``, ``transformer``,
``registry``); prefill attention runs on the flash-attention kernel."""
from repro_torch.models.common import (SHAPES, ModelConfig,  # noqa: F401
                                       ShapeSpec, model_flops)
from repro_torch.models.registry import ModelFns, get_model_fns  # noqa: F401
