"""Serve a small model with batched requests: prefill, then lock-step
greedy decode waves with a KV cache (``repro_torch.launch.serve``; prefill
attention runs on the CUDA flash-attention kernel on the card).

    python -m repro_torch.examples.serve_lm
    python -m repro_torch.examples.serve_lm --device cpu --max-new 16

Flags after the defaults below override them.
"""
import sys

from repro_torch.launch.serve import main

DEFAULTS = ["--arch", "qwen3-0.6b-smoke", "--batch", "4", "--requests", "8",
            "--max-new", "24"]

if __name__ == "__main__":
    sys.exit(main([*DEFAULTS, *sys.argv[1:]]))
