"""The LM substrate: every family of the JAX package (``common``,
``layers``, ``moe``, ``ssm``, ``transformer``, ``encdec``, ``registry``),
with GQA or MLA attention: training and serving; full-sequence GQA
attention, causal or not, runs on the flash-attention kernel."""
from repro_torch.models.common import (SHAPES, ModelConfig,  # noqa: F401
                                       ShapeSpec, model_flops)
from repro_torch.models.registry import ModelFns, get_model_fns  # noqa: F401
