"""Architecture registry: one uniform interface over the model families
(the JAX package's ``models/registry.py``), for the serving functions.

``get_model_fns(cfg)`` returns the family's ``init_params``, ``prefill``,
``serve_step``, ``init_cache`` and ``forward``.  The port has the dense
family only; the training functions come with the training slice (ROADMAP
§1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models import transformer as TFM
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    prefill: Callable
    serve_step: Callable
    init_cache: Callable
    forward: Callable


def get_model_fns(cfg: ModelConfig) -> ModelFns:
    TFM._dense_only(cfg)
    return ModelFns(init_params=TFM.init_params, prefill=TFM.prefill,
                    serve_step=TFM.serve_step, init_cache=TFM.init_cache,
                    forward=TFM.forward)
