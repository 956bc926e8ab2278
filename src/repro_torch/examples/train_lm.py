"""End-to-end training example: a ~100M-param dense LM for a few hundred
steps on the synthetic motif stream, with periodic async checkpoints and a
resumable loop (``repro_torch.launch.train``; attention runs on the CUDA
flash-attention kernel on the card).

    python -m repro_torch.examples.train_lm                 # ~100M, 300 steps
    python -m repro_torch.examples.train_lm --steps 50      # quicker look
    python -m repro_torch.examples.train_lm --device cpu --arch qwen3-0.6b-smoke

The loss must drop well below ln(vocab): the stream has learnable motif
structure.  Try the fault drill (checkpoints go under the temporary
directory unless ``--ckpt-dir`` says otherwise):

    python -m repro_torch.examples.train_lm --steps 100 --simulate-failure 60
    python -m repro_torch.examples.train_lm --steps 100 --resume

Flags after the defaults below override them.
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

DEFAULTS = ["--steps", "300", "--global-batch", "8", "--seq", "256",
            "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                       "repro_torch_train_100m"),
            "--ckpt-every", "100"]

if __name__ == "__main__":
    sys.exit(main([*DEFAULTS, *sys.argv[1:]]))
