"""Dry run: for every (architecture x run shape), the bytes the step
must hold on each card and the analytic roofline of its time, without
allocating or running the model.  The port's counterpart of
``repro/launch/dryrun.py``, on H100s:

- ``--mesh h100x1`` (the default): one card (``chips = 1``,
  ``model_par = 1``, no FSDP);
- ``--mesh single`` / ``multi``: the reference's production meshes, 16 x
  16 ``(data, model)`` and 2 x 16 x 16 ``(pod, data, model)``, each chip
  an H100, under the reference's rules (:func:`pick_rules`: FSDP when a
  chip's share of the parameters passes ``FSDP_BUDGET_BYTES``,
  sequence-parallel activations for long dense prefills and training).
  Bytes are a chip's shards (``sharding.place.local_shape`` of every
  leaf by its partition spec) against one H100's memory; the roofline
  adds the collective term, from the step's collectives as
  ``sharding.collectives.step_collectives`` counts them.  A pair the port
  cannot run sharded yet (a train step, sequence-parallel rules, a
  context-parallel cache) is recorded with ``"runs": false``, the reason,
  and no collective term.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out DIR

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
import math
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs import (SHAPES, RunShape, get_config, list_archs,
                                 param_count, with_sliding_window_variant)
from repro_torch.launch import roofline as RL
from repro_torch.launch.inputs import (cache_pspecs, cache_specs,
                                       input_pspecs, input_specs)
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.models.model import param_descs
from repro_torch.models.params import local_descs
from repro_torch.sharding import collectives
from repro_torch.sharding.place import local_shape
from repro_torch.sharding.specs import AxisRules

MESH = "h100x1"
MESHES = (MESH, "single", "multi")

# FSDP decision: bytes/chip under pure TP beyond this budget -> shard big
# weights over the data axis too (ZeRO-style storage sharding).
FSDP_BUDGET_BYTES = 8e9


def pick_rules(cfg, mesh, mode: str, seq_len: int = 0) -> AxisRules:
    """The reference's rules for a step of ``mode`` on ``mesh``: FSDP when
    a chip's share of the parameters (bf16, plus float32 moments to
    train) under pure TP passes ``FSDP_BUDGET_BYTES``; sequence-parallel
    activations for long (>= 4096, divisible) prefills and training of
    dense attention-only decoders."""
    rules = AxisRules(mesh=mesh)
    n = param_count(cfg)
    tp = rules.axis_size("model")
    bytes_per_param = 10 if mode == "train" else 2   # bf16 + f32 m/v (train)
    per_chip = n * bytes_per_param / tp
    seq_axis = None
    if (mode in ("prefill", "train") and cfg.moe is None
            and not cfg.has_mamba and cfg.encoder is None
            and seq_len % tp == 0 and seq_len >= 4096):
        seq_axis = "model"
    return AxisRules(mesh=mesh, fsdp=per_chip > FSDP_BUDGET_BYTES,
                     seq_axis=seq_axis)


def card_bytes() -> int:
    """The card's memory in bytes (raises without a card)."""
    return torch.cuda.get_device_properties(
        resolve_device("cuda")).total_memory


def tree_bytes(tree) -> int:
    """Bytes of a tree of tensors (``numel x element_size`` summed)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of one chip's shards of a tree of tensors (the whole tree
    without a mesh)."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v, specs[k], mesh) for k, v in tree.items())
    shape = tree.shape if mesh is None else local_shape(tree.shape, specs,
                                                         mesh)
    return math.prod(shape) * tree.element_size()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def memory_bytes(cfg, shape: RunShape,
                 rules: Optional[AxisRules] = None) -> Dict[str, int]:
    """Bytes by part of one step of ``shape`` on a chip (on the rules'
    mesh, its shards): bfloat16 parameters, Adam's two float32 moments
    (train), the cache (prefill, decode), the inputs."""
    rules = rules or AxisRules()
    train = shape.mode == "train"
    mesh = rules.mesh
    n = sum(math.prod(d.shape) for d in _leaves(
        local_descs(param_descs(cfg, rules), mesh)))
    return {
        "params": 2 * n,
        "optimizer": 8 * n if train else 0,
        "cache": 0 if train else _local_bytes(
            cache_specs(cfg, shape), cache_pspecs(cfg, shape, rules), mesh),
        "inputs": _local_bytes(input_specs(cfg, shape),
                               input_pspecs(cfg, shape, rules), mesh),
    }


def run_pair(arch: str, shape: Union[str, RunShape], *,
             hbm_bytes: Optional[float] = None,
             mesh: str = MESH) -> Dict[str, Any]:
    """The record of one pair on ``mesh`` (a name of ``MESHES``);
    ``shape`` is a name of ``SHAPES`` or a ``RunShape``; ``hbm_bytes``
    defaults to the card's memory."""
    if hbm_bytes is None:
        hbm_bytes = card_bytes()
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = get_config(arch)
    variant = "baseline"
    if shape.name == "long_500k" and not cfg.subquadratic:
        cfg = with_sliding_window_variant(cfg)
        variant = "swa"
    rules = None
    if mesh != MESH:
        rules = pick_rules(cfg, make_production_mesh(
            multi_pod=mesh == "multi"), shape.mode, shape.seq_len)
    memory: Dict[str, Any] = memory_bytes(cfg, shape, rules)
    memory["total"] = sum(memory.values())
    memory["hbm"] = hbm_bytes
    memory["fits"] = memory["total"] <= hbm_bytes
    if rules is None:
        rf = RL.build(arch, shape, MESH, 1, cfg, model_par=1, fsdp=False)
        return {"arch": arch, "shape": shape.name, "mesh": MESH,
                "variant": variant, "chips": 1, "fsdp": False,
                "params": param_count(cfg), "memory": memory,
                "roofline": rf.to_dict(), "status": "ok"}
    chips, model_par = mesh_chips(rules.mesh), rules.axis_size("model")
    try:
        coll = collectives.step_collectives(cfg, shape, rules)
        runs, why = True, None
    except NotImplementedError as e:
        coll, runs, why = None, False, str(e)
    link = 0.0 if coll is None else collectives.link_bytes(coll, rules)
    rf = RL.build(arch, shape, mesh, chips, cfg, model_par=model_par,
                  fsdp=rules.fsdp, collective_bytes=link)
    return {"arch": arch, "shape": shape.name, "mesh": mesh,
            "variant": variant, "chips": chips, "model_par": model_par,
            "fsdp": rules.fsdp, "seq_axis": rules.seq_axis,
            "params": param_count(cfg), "memory": memory, "runs": runs,
            "why_not": why,
            "collectives": None if coll is None else
            collectives.summary(coll, rules),
            "collective_link_bytes": link if runs else None,
            "roofline": rf.to_dict(), "status": "ok"}


def summary_line(rec: Dict[str, Any]) -> str:
    """One line of a record: fits, GB by part, the roofline's terms (and
    on a mesh its rules and whether the port runs it sharded)."""
    m, r = rec["memory"], rec["roofline"]
    gb = " ".join(f"{k} {m[k] / 1e9:.3f}" for k in (
        "params", "optimizer", "cache", "inputs", "total"))
    per = " a chip" if rec["chips"] > 1 else ""
    line = (f"{rec['arch']} x {rec['shape']} ({rec['variant']}): "
            f"{'fits' if m['fits'] else 'does not fit'} "
            f"{m['hbm'] / 1e9:.2f} GB; GB{per} {gb}; "
            f"compute_s {r['compute_s']:.6g} memory_s {r['memory_s']:.6g} "
            f"bottleneck {r['bottleneck']}")
    if rec["mesh"] == MESH:
        return line
    return (f"{line}; {rec['mesh']} {rec['chips']} chips, model "
            f"{rec['model_par']}, fsdp {rec['fsdp']}, seq_axis "
            f"{rec['seq_axis']}; " + (
                f"collective_s {r['collective_s']:.6g}" if rec["runs"] else
                "runs false (no collective term)"))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=MESH, choices=MESHES)
    ap.add_argument("--out", default=None,
                    help="write each pair's record to DIR/<arch>_<shape>_"
                         "<mesh>.json")
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
        rec = run_pair(arch, shape, hbm_bytes=hbm, mesh=args.mesh)
        print(f"[dryrun] {summary_line(rec)}", flush=True)
        if outdir is not None:
            (outdir / f"{arch}_{shape}_{args.mesh}.json").write_text(
                json.dumps(rec, indent=1))
    print(f"done: {len(pairs)} pairs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
