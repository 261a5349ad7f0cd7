"""Time seeded model builds: by default ``resnet50`` on the card and
``vgg16`` and ``resnet50`` on the CPU, each right after
``paddle_tpu_torch.seed(0)`` (a build draws its weights then, and nothing
else runs in the timed span).

    python3 build_times.py
    python3 build_times.py --tree .scratch/parent

``--tree DIR`` imports ``paddle_tpu_torch`` from another checkout (an
unpacked ``git archive`` of another commit), so two commits are compared
on one host: run parent, change, change, parent in one command.  Each
line gives the seconds of one build and its parameters; the last is the
card's name and power limit.
"""

import argparse
import gc
import subprocess
import sys
import time
from pathlib import Path

BUILDS = (("resnet50", "cuda"), ("vgg16", "cpu"), ("resnet50", "cpu"))


def card_line():
    """``name, power limit`` as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_build(models, seed, name, device):
    """Seconds of one build of ``name`` on ``device`` after ``seed(0)``,
    and its parameter count."""
    import torch

    ctor = {k.lower(): v for k, v in vars(models).items()
            if callable(v)}[name]
    gc.collect()
    seed(0)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = ctor(device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return seconds, sum(p.numel() for p in model.parameters())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None,
                    help="a checkout whose paddle_tpu_torch to import")
    args = ap.parse_args()
    root = Path(args.tree or Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    import torch

    import paddle_tpu_torch
    from paddle_tpu_torch.vision import models

    if Path(paddle_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {paddle_tpu_torch.__file__}, not "
                         f"{root}'s package")
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False")
    time_build(models, paddle_tpu_torch.seed, "lenet", "cuda")  # warm-up
    for name, device in BUILDS:
        s, n = time_build(models, paddle_tpu_torch.seed, name, device)
        print(f"build_times {root.name}: {name} on {device} {s:.3f} s "
              f"({n} parameters, {s / n * 1e9:.1f} ns a parameter; torch "
              f"{torch.get_num_threads()} threads)", flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
