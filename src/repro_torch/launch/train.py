"""Training launcher: data pipeline -> train_step -> checkpoint/restart loop
(the JAX package's ``launch/train.py``), on the card.

Demonstrates the full fault-tolerance loop: periodic async checkpoints,
simulated failure, restart-and-continue (bit-exact, verified by
``tests/test_torch_train.py`` and ``chip_smoke.py``).  Full-sequence
attention runs on the CUDA flash-attention kernel through
``models.layers.FlashAttention``; its backward is the plain recompute.

    python -m repro_torch.launch.train --arch qwen3-0.6b --seq 1024 --steps 12
    python -m repro_torch.launch.train --device cpu --arch qwen3-0.6b-smoke \\
        --steps 20 --seq 64 --ckpt-dir ck --simulate-failure 10
    python -m repro_torch.launch.train --device cpu --arch qwen3-0.6b-smoke \\
        --steps 20 --seq 64 --ckpt-dir ck --resume
    python -m repro_torch.launch.train --device cpu --arch whisper-base-smoke \\
        --steps 4 --seq 32

An enc-dec model (whisper) trains on zero frames, as in the JAX package;
a VLM (qwen2-vl) on text alone.

``--device`` says where the model runs (default ``cuda``, which must
exist).  A simulated failure exits with code 42.  The JAX package's mesh
(``use_mesh``, ``make_host_mesh``) has no meaning on one card and is not
here.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.tokens import TokenStreamSpec, batch_for_step
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FailureInjector, StragglerMonitor
from repro_torch.models.common import ModelConfig
from repro_torch.models.registry import get_model_fns
from repro_torch.models.transformer import params_from_reference, train_state
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig


def example_100m(vocab: int = 8192) -> ModelConfig:
    """~100M-param dense decoder for the end-to-end example run."""
    return ModelConfig(
        name="example-100m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
        d_ff=2048, vocab_size=vocab, qk_norm=True, tie_embeddings=True,
        remat_policy="dots", microbatch_tokens=1 << 30)


def _grad_transform(kind: Optional[str]):
    if kind in (None, "none"):
        return None
    if kind == "bf16":
        return lambda g: compression.decompress_bf16(compression.compress_bf16(g))
    if kind == "int8":
        return lambda g: compression.decompress_int8(compression.compress_int8(g))
    raise ValueError(kind)


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          opt_cfg: Optional[AdamWConfig] = None, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, resume: bool = False,
          fail_at_step: Optional[int] = None, grad_compress: Optional[str] = None,
          seed: int = 0, log_every: int = 10, device=None, params=None):
    """Returns (final state, list of per-step losses).

    ``device``: where the state lives (``None``: the card).  ``params``:
    start from the JAX package's parameter tree (numpy or JAX arrays,
    ``layers`` stacked) instead of the port's seeded init.  Log lines
    carry each step's wall time, from before the step to its loss on the
    host."""
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps,
                                     warmup_steps=max(1, steps // 20))
    dev = resolve_device(device)
    fns = get_model_fns(cfg)
    spec = TokenStreamSpec(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch, seed=seed)
    injector = FailureInjector(fail_at_step)
    monitor = StragglerMonitor(n_workers=1)
    writer = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None

    if params is None:
        state, _ = fns.init_train_state(cfg, seed, dev)
    else:
        state = train_state(params_from_reference(params, dev))
    start_step = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start_step = ckpt.restore(ckpt_dir, state)
        start_step += 1
        print(f"[train] resumed from step {start_step - 1}", flush=True)

    step_fn = fns.make_train_step(
        cfg, opt_cfg, n_micro=1, grad_transform=_grad_transform(grad_compress))

    losses = []
    try:
        for step in range(start_step, steps):
            batch = batch_for_step(spec, step)
            if cfg.family == "encdec":
                batch["frames"] = np.zeros(
                    (global_batch, cfg.enc_frames, cfg.d_model), np.float32)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.record(0, dt)
            losses.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.1f} ms", flush=True)
            if writer and (step + 1) % ckpt_every == 0:
                writer.save(step, state, extra_meta={"arch": cfg.name})
            injector.check(step)  # may raise SimulatedFailure AFTER ckpt
        if writer:
            writer.save(steps - 1, state, extra_meta={"arch": cfg.name})
    finally:
        if writer:
            writer.wait()  # no writer thread outlives the run
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="example-100m",
                    help="arch id, 'example-100m', or '<id>-smoke'")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="raise a simulated node failure at this step")
    ap.add_argument("--grad-compress", choices=["none", "bf16", "int8"],
                    default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)

    if args.arch == "example-100m":
        cfg = example_100m()
    elif args.arch.endswith("-smoke"):
        cfg = smoke_config(args.arch[: -len("-smoke")])
    else:
        cfg = get_config(args.arch)

    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 20))
    try:
        train(cfg, steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq, opt_cfg=opt, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              fail_at_step=args.simulate_failure,
              grad_compress=args.grad_compress, seed=args.seed,
              log_every=args.log_every, device=args.device)
    except FailureInjector.SimulatedFailure as e:
        print(f"[train] {e} — restart with --resume to continue", flush=True)
        return 42
    return 0


if __name__ == "__main__":
    sys.exit(main())
