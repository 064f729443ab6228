"""Train a small LM end to end on the synthetic pipeline, the port's
counterpart of ``examples/train_lm.py``: the model zoo at its reduced
size (4 layers, d_model 256, vocab 512), the train step (attention
through the ``flash_prefill`` kernel and its gradient on the card),
Adam with warmup-cosine and a global-norm clip, and a checkpoint of the
parameters in the reference's tree layout and file format.

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 200]
    PYTHONPATH=src python -m repro_torch.train_lm --device cpu

Runs on the card unless ``--device cpu`` is given; there is no fallback.
Raises unless the loss falls by more than 0.3, as the reference asserts.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMData
from repro_torch.models import Model
from repro_torch.optim import Adam
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serving.steps import make_train_step


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="checkpoints/lm")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Train as ``args`` say and save the checkpoint: the first and last
    steps' losses, the model and the checkpoint's file."""
    dev = resolve_device(args.device)
    cfg = reduced(get_config(args.arch), layers=4, d_model=256, vocab=512)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = Model(cfg, device=dev, generator=gen)
    params = list(model.parameters())
    print(f"arch={cfg.name} params={sum(p.numel() for p in params) / 1e6:.1f}M"
          f" device={dev}")

    opt = Adam(lr=warmup_cosine(3e-3, 20, args.steps), grad_clip=1.0)
    opt_state = opt.init(params)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq, seed=1,
                           branching=8)
    step_fn = make_train_step(model, opt)

    t0 = time.time()
    first = None
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(step, args.batch).items()}
        opt_state, metrics = step_fn(opt_state, batch)
        if step == 0:
            first = float(metrics["loss"])
        if step % max(args.steps // 10, 1) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(metrics['loss']):.4f} "
                  f"({(time.time() - t0):.1f}s)")
    final = float(metrics["loss"])
    path = save_checkpoint(args.ckpt, args.steps,
                           {"params": model.params.tree()})
    print(f"loss {first:.3f} -> {final:.3f} "
          f"({args.steps} steps, {time.time() - t0:.1f}s); "
          f"checkpoint at {args.ckpt}")
    return {"first": first, "final": final, "model": model, "path": path}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    out = run(parse_args(argv))
    if not out["final"] < out["first"] - 0.3:
        raise RuntimeError(f"training failed to reduce loss: "
                           f"{out['first']:.3f} -> {out['final']:.3f}")
    return out


if __name__ == "__main__":
    main()
