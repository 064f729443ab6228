"""Dry run on one card: for every (architecture x run shape), the bytes
the step must hold and the analytic roofline of its time, without
allocating or running the model.  The port's counterpart of
``repro/launch/dryrun.py``, on one H100 (``chips = 1``, ``model_par =
1``, no FSDP).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR

Each pair applies the reference's rule for ``long_500k``: a config that
is not sub-quadratic runs its sliding-window variant.  Its bytes come
from ``meta`` trees (shapes and dtypes, no storage): the parameters in
bfloat16, Adam's two float32 moments to train, the cache (the prefill's
output, the decode's input) and the inputs.  ``fits`` compares their sum
with the card's memory (``torch.cuda.get_device_properties``; the tests
pass ``hbm_bytes``).  The sum leaves out activations and workspace, so a
pair that does not fit cannot run on the card; one that fits may still
not.  The roofline is ``roofline.build`` at bfloat16, the reference's
production precision.

The reference also lowers and compiles each step with XLA and records
``lower_s``, ``compile_s``, XLA's ``cost`` and memory analyses and the
HLO's ``collectives``; those are XLA's and have no counterpart here
(``launch/hlo_analysis.py`` is not ported).  No step is traced either:
the kernels' wrappers take CPU or CUDA tensors only, and the plain scan
steps through every position.

Like every entry point of the port, it raises without a card.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs import (SHAPES, RunShape, get_config, list_archs,
                                 param_count, with_sliding_window_variant)
from repro_torch.launch import roofline as RL
from repro_torch.launch.inputs import cache_specs, input_specs
from repro_torch.models.model import model_shapes

MESH = "h100x1"


def card_bytes() -> int:
    """The card's memory in bytes (raises without a card)."""
    return torch.cuda.get_device_properties(
        resolve_device("cuda")).total_memory


def tree_bytes(tree) -> int:
    """Bytes of a tree of tensors (``numel x element_size`` summed)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def memory_bytes(cfg, shape: RunShape) -> Dict[str, int]:
    """Bytes by part of one step of ``shape``: bfloat16 parameters, Adam's
    two float32 moments (train), the cache (prefill, decode), the
    inputs."""
    train = shape.mode == "train"
    return {
        "params": tree_bytes(model_shapes(cfg, torch.bfloat16)),
        "optimizer": 2 * tree_bytes(model_shapes(cfg, torch.float32))
        if train else 0,
        "cache": 0 if train else tree_bytes(cache_specs(cfg, shape)),
        "inputs": tree_bytes(input_specs(cfg, shape)),
    }


def run_pair(arch: str, shape: Union[str, RunShape], *,
             hbm_bytes: Optional[float] = None) -> Dict[str, Any]:
    """The record of one pair on one card; ``shape`` is a name of
    ``SHAPES`` or a ``RunShape``; ``hbm_bytes`` defaults to the card's
    memory."""
    if hbm_bytes is None:
        hbm_bytes = card_bytes()
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    variant = "baseline"
    if shape.name == "long_500k" and not cfg.subquadratic:
        cfg = with_sliding_window_variant(cfg)
        variant = "swa"
    memory: Dict[str, Any] = memory_bytes(cfg, shape)
    memory["total"] = sum(memory.values())
    memory["hbm"] = hbm_bytes
    memory["fits"] = memory["total"] <= hbm_bytes
    rf = RL.build(arch, shape, MESH, 1, cfg, model_par=1, fsdp=False)
    return {"arch": arch, "shape": shape.name, "mesh": MESH,
            "variant": variant, "chips": 1, "fsdp": False,
            "params": param_count(cfg), "memory": memory,
            "roofline": rf.to_dict(), "status": "ok"}


def summary_line(rec: Dict[str, Any]) -> str:
    """One line of a record: fits, GB by part, the roofline's terms."""
    m, r = rec["memory"], rec["roofline"]
    gb = " ".join(f"{k} {m[k] / 1e9:.3f}" for k in (
        "params", "optimizer", "cache", "inputs", "total"))
    return (f"{rec['arch']} x {rec['shape']} ({rec['variant']}): "
            f"{'fits' if m['fits'] else 'does not fit'} "
            f"{m['hbm'] / 1e9:.2f} GB; GB {gb}; "
            f"compute_s {r['compute_s']:.6g} memory_s {r['memory_s']:.6g} "
            f"bottleneck {r['bottleneck']}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write each pair's record to DIR/<arch>_<shape>_"
                         f"{MESH}.json")
    args = ap.parse_args(argv)
    if args.all:
        pairs = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    hbm = card_bytes()
    outdir = Path(args.out) if args.out else None
    if outdir is not None:
        outdir.mkdir(parents=True, exist_ok=True)
    for arch, shape in pairs:
        rec = run_pair(arch, shape, hbm_bytes=hbm)
        print(f"[dryrun] {summary_line(rec)}", flush=True)
        if outdir is not None:
            (outdir / f"{arch}_{shape}_{MESH}.json").write_text(
                json.dumps(rec, indent=1))
    print(f"done: {len(pairs)} pairs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
