"""Batched serving: one prefill, then greedy decode with a KV cache, on the
card (the JAX package's ``launch/serve.py``).

One prefill per admitted batch, then lock-step decode with greedy sampling
and a per-slot stop condition.  Prompts are ragged and padded at the end;
the prefill's K/V are spliced into one ``max_seq`` cache.  Prefill
attention runs on the CUDA flash-attention kernel; decode attention over
the cache is plain PyTorch, as the JAX package computes it outside any
kernel.

    python -m repro_torch.launch.serve --arch qwen3-0.6b           # on the card
    python -m repro_torch.launch.serve --device cpu --arch qwen3-0.6b-smoke

``--device`` says where the model runs (default ``cuda``, which must exist).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model_fns


class BatchServer:
    def __init__(self, cfg: ModelConfig, params, *, max_seq: int = 512,
                 batch: int = 4, device=None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch = batch
        self.device = resolve_device(device)
        self.fns = get_model_fns(cfg)
        self._prefill = lambda p, t: self.fns.prefill(p, cfg, t)
        self._step = lambda p, c, t, l: self.fns.serve_step(p, cfg, c, t, l)

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray], *, max_new: int = 32,
                 eos_id: Optional[int] = None) -> List[np.ndarray]:
        """Greedy-decode a batch of token-id prompts (ragged, padded here)."""
        assert len(prompts) <= self.batch
        B = self.batch
        plen = max(len(p) for p in prompts)
        toks = np.zeros((B, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p

        cache = self.fns.init_cache(self.cfg, B, self.max_seq, self.device)
        logits, pcache = self._prefill(
            self.params, torch.as_tensor(toks, device=self.device).long())
        self._splice(cache, pcache, plen)
        del pcache
        out = [list(p) for p in prompts]
        tok = logits.argmax(-1)
        tok_host = tok.cpu().numpy().astype(np.int32)
        done = np.zeros((B,), bool)
        for t in range(max_new):
            for i in range(len(prompts)):
                if not done[i]:
                    out[i].append(int(tok_host[i]))
                    if eos_id is not None and tok_host[i] == eos_id:
                        done[i] = True
            if done[: len(prompts)].all() or plen + t + 1 >= self.max_seq:
                break
            logits, cache = self._step(self.params, cache, tok, plen + t)
            tok = logits.argmax(-1)
            tok_host = tok.cpu().numpy().astype(np.int32)
        return [np.asarray(o, np.int32) for o in out]

    @staticmethod
    def _splice(cache, pcache, plen):
        """Copy prefill K/V (length plen) into the max_seq decode cache, in
        place."""
        for k, big in cache.items():
            big[:, :, :plen] = pcache[k].to(big.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)

    if args.arch.endswith("-smoke"):
        cfg = smoke_config(args.arch[: -len("-smoke")])
    else:
        cfg = get_config(args.arch)
    if cfg.family == "encdec":
        print("serve.py demo targets decoder-only archs", file=sys.stderr)
        return 2

    dev = resolve_device(args.device)
    fns = get_model_fns(cfg)
    params = fns.init_params(cfg, 0, dev)
    server = BatchServer(cfg, params, batch=args.batch,
                         max_seq=args.max_seq, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    n_tokens = 0
    for wave in range(0, args.requests, args.batch):
        prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 17))
                   .astype(np.int32)
                   for _ in range(min(args.batch, args.requests - wave))]
        outs = server.generate(prompts, max_new=args.max_new)
        n_tokens += sum(len(o) - len(p) for o, p in zip(outs, prompts))
        print(f"[serve] wave {wave // args.batch}: "
              f"{[len(o) for o in outs]} tokens each", flush=True)
    dt = time.perf_counter() - t0
    print(f"[serve] {n_tokens} new tokens in {dt:.2f}s "
          f"({n_tokens / dt:.1f} tok/s on {dev})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
