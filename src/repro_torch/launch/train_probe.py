"""Probes of the training step that no check reads, on the card: the step
time and peak memory under each remat policy, ``adamw_update`` alone over
the model's parameters, and whether an indexed read of the embedding
(``w[tokens]``) gives the same gradient bits in three backward passes
(the model reads it through ``F.embedding``).

    python -m repro_torch.launch.train_probe [--arch qwen3-0.6b] \\
        [--batch 8] [--seq 1024] [--device cpu]

``--arch <id>-smoke`` takes the architecture's smoke configuration (for a
run on the CPU).  Every line ends with the device's name and, on the card, its
power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import TokenStreamSpec, batch_for_step
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TFM
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.tree import tree_map

POLICIES = ("dots", "everything", "nothing")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else torch.cuda.get_device_name(dev)


def remat_policies(cfg, spec, dev, steps: int = 4) -> dict:
    """{policy: step ms (median of the steps after the first two), peak
    GiB (the card only)} over ``steps`` steps from a fresh state."""
    out = {}
    for policy in POLICIES:
        c = cfg.replace(remat_policy=policy)
        state, _ = TFM.init_train_state(c, 0, dev)
        step = TFM.make_train_step(c, AdamWConfig(total_steps=steps,
                                                  warmup_steps=1), 1)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for i in range(steps):
            t0 = time.perf_counter()
            state, m = step(state, batch_for_step(spec, i))
            float(m["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
        out[policy] = dict(step_ms=statistics.median(times[2:]),
                           peak_gib=peak)
        del state
    return out


def adamw_alone(cfg, dev, reps: int = 3) -> float:
    """Median ms of ``adamw_update`` over the model's parameters (gradients
    all 1e-3), each call synchronised."""
    state, _ = TFM.init_train_state(cfg, 0, dev)
    grads = tree_map(lambda p: torch.full_like(p, 1e-3), state["params"])
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        adamw_update(AdamWConfig(), state["params"], grads, state["opt"],
                     state["step"])
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def indexed_embedding_deterministic(cfg, spec, dev, passes: int = 3) -> bool:
    """Whether ``w[tokens]`` (whose backward accumulates by index) gives
    the same gradient bits in ``passes`` backward passes at the batch's
    shape."""
    gen = torch.Generator(device=dev).manual_seed(17)
    tok = torch.as_tensor(batch_for_step(spec, 0)["tokens"], device=dev)
    w = torch.randn((cfg.vocab_padded, cfg.d_model), generator=gen,
                    device=dev) * 0.02
    up = torch.randn((*tok.shape, cfg.d_model), generator=gen,
                     device=dev).to(cfg.cdtype())
    grads = []
    for _ in range(passes):
        x = w.detach().requires_grad_()
        grads.append(torch.autograd.grad(
            x[tok.long()].to(cfg.cdtype()), x, up)[0])
    return all(torch.equal(grads[0], g) for g in grads[1:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="arch id or '<id>-smoke'")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' to run without one")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (smoke_config(args.arch[: -len("-smoke")])
           if args.arch.endswith("-smoke") else get_config(args.arch))
    spec = TokenStreamSpec(vocab_size=cfg.vocab_size, seq_len=args.seq,
                           global_batch=args.batch, seed=0)
    where = f"device: {device_name(dev)}"
    policies = remat_policies(cfg, spec, dev)
    print(f"[probe] {args.arch}, {args.batch} x {args.seq} tokens, step by "
          f"remat policy (median of steps 2-3): " + ", ".join(
              f"{k} {v['step_ms']:.1f} ms" + (
                  "" if v["peak_gib"] is None
                  else f" (peak {v['peak_gib']:.2f} GiB)")
              for k, v in policies.items()) + f"; {where}", flush=True)
    print(f"[probe] adamw_update over the {cfg.param_count():,} parameters "
          f"alone: {adamw_alone(cfg, dev):.1f} ms; {where}", flush=True)
    same = indexed_embedding_deterministic(cfg, spec, dev)
    print(f"[probe] the embedding's gradient through an indexed read "
          f"bit-identical in three passes: {same}; {where}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
