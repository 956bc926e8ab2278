"""Architecture registry: one uniform interface over the model families
(the JAX package's ``models/registry.py``).

``get_model_fns(cfg)`` returns the family's ``init_params``, ``loss_fn``,
``prefill``, ``serve_step``, ``init_cache``, ``cache_logical_axes`` and
``forward``, with ``make_train_step`` and ``init_train_state``;
``batch_specs(cfg, shape)`` returns ``device="meta"`` tensors (the
counterpart of ``ShapeDtypeStruct``) for the inputs of the loss
(``train_*``) or of prefill (``prefill_*``), ``decode_specs`` those of
``serve_step``, ``abstract_train_state`` the state on the meta device, each
with its logical axes (``batch_logical_axes``, ``decode_logical_axes``),
and ``synth_batch`` a concrete seeded batch of the same shapes.  Every
family of the JAX package is here: enc-dec from ``models/encdec.py``, the
others from ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.models import encdec as ENCDEC
from repro_torch.models import transformer as TFM
from repro_torch.models.common import ModelConfig, ShapeSpec
from repro_torch.optim.adamw import AdamWConfig


@dataclasses.dataclass(frozen=True)
class ModelFns:
    init_params: Callable
    loss_fn: Callable
    prefill: Callable
    serve_step: Callable
    init_cache: Callable
    cache_logical_axes: Callable
    forward: Callable

    def make_train_step(self, cfg: ModelConfig, opt_cfg: AdamWConfig,
                        n_micro: int, grad_transform=None, param_view=None):
        return TFM.make_train_step(cfg, opt_cfg, n_micro,
                                   grad_transform=grad_transform,
                                   loss=self.loss_fn, param_view=param_view)

    def init_train_state(self, cfg: ModelConfig, gen=0, device=None):
        return TFM.init_train_state(cfg, gen, device, init=self.init_params)


def get_model_fns(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "encdec":
        return ModelFns(init_params=ENCDEC.init_params,
                        loss_fn=ENCDEC.loss_fn, prefill=ENCDEC.prefill,
                        serve_step=ENCDEC.serve_step,
                        init_cache=ENCDEC.init_cache,
                        cache_logical_axes=ENCDEC.cache_logical_axes,
                        forward=ENCDEC.forward)
    TFM._ported(cfg)
    return ModelFns(init_params=TFM.init_params, loss_fn=TFM.loss_fn,
                    prefill=TFM.prefill, serve_step=TFM.serve_step,
                    init_cache=TFM.init_cache,
                    cache_logical_axes=TFM.cache_logical_axes,
                    forward=TFM.forward)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Inputs of loss/train for ``train_*`` or of prefill for
    ``prefill_*``, as ``device="meta"`` tensors: int32 tokens, an enc-dec
    model's ``frames`` and a VLM's ``patch_embeds`` in the compute dtype, a
    VLM's int32 ``mrope_pos``."""
    get_model_fns(cfg)
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype,
                                                     device="meta")
    specs = {"tokens": meta(B, S)}
    if shape.kind == "train":
        specs["targets"] = meta(B, S)
    if cfg.family == "encdec":
        specs["frames"] = meta(B, cfg.enc_frames, cfg.d_model,
                               dtype=cfg.cdtype())
    if cfg.family == "vlm":
        specs["patch_embeds"] = meta(B, cfg.n_patches, cfg.d_model,
                                     dtype=cfg.cdtype())
        specs["mrope_pos"] = meta(B, S, 3)
    return specs


def batch_logical_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    axes: Dict[str, Any] = {"tokens": ("batch", None)}
    if shape.kind == "train":
        axes["targets"] = ("batch", None)
    if cfg.family == "encdec":
        axes["frames"] = ("batch", None, None)
    if cfg.family == "vlm":
        axes["patch_embeds"] = ("batch", None, None)
        axes["mrope_pos"] = ("batch", None, None)
    return axes


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The inputs of ``serve_step`` as ``device="meta"`` tensors: the cache
    (``init_cache`` at the shape's batch and length), the int32 token [B],
    the int32 0-d ``cache_len`` and a VLM's ``mrope_pos`` [B, 1, 3]."""
    B, S = shape.global_batch, shape.seq_len
    fns = get_model_fns(cfg)
    meta = lambda *s: torch.empty(s, dtype=torch.int32, device="meta")
    out = {"cache": fns.init_cache(cfg, B, S, device="meta"),
           "token": meta(B), "cache_len": meta()}
    if cfg.family == "vlm":
        out["mrope_pos"] = meta(B, 1, 3)
    return out


def decode_logical_axes(cfg: ModelConfig) -> Dict[str, Any]:
    out = {"cache": get_model_fns(cfg).cache_logical_axes(cfg),
           "token": ("batch",), "cache_len": ()}
    if cfg.family == "vlm":
        out["mrope_pos"] = ("batch", None, None)
    return out


def abstract_train_state(cfg: ModelConfig, seed: int = 0):
    """(the train state on ``device="meta"``, its logical-axes tree): no
    allocation.  The state keeps the port's layout (stacked layers as
    lists); ``sharding.stack_layers`` gives the axes' layout."""
    return get_model_fns(cfg).init_train_state(cfg, seed, "meta")


def synth_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                batch_override: Optional[int] = None) -> Dict[str, Any]:
    """Concrete synthetic batch matching batch_specs (numpy: int32 ids and
    positions, fp32 frames and patch embeddings; the JAX package's numbers
    for the same seed, drawn in the same order)."""
    get_model_fns(cfg)
    rng = np.random.default_rng(seed)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    toks = rng.integers(0, cfg.vocab_size, size=(B, S), dtype=np.int32)
    batch: Dict[str, Any] = {"tokens": toks}
    if shape.kind == "train":
        batch["targets"] = np.concatenate(
            [toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, :, None],
                              (B, S, 3))
        batch["mrope_pos"] = np.ascontiguousarray(pos)
    return batch
