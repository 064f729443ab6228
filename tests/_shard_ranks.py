"""The rank side of ``test_torch_sharded_model.py``: one mesh case's
models run sharded on a rank spawned by ``launch.mesh.spawn`` (gloo on the
CPU).  Imports neither jax nor the JAX package, so a rank process starts
without them."""
from __future__ import annotations

import dataclasses

import torch

import repro_torch.configs as configs
from repro_torch.interop import model_params_from_arrays
from repro_torch.launch.mesh import init_mesh, make_test_mesh
from repro_torch.models import Model, moe
from repro_torch.models.model import cache_shapes
from repro_torch.serving.steps import make_prefill_step
from repro_torch.sharding import collectives
from repro_torch.sharding.specs import AxisRules

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def config(configs_module, arch: str, changes: dict):
    """``reduced(get_config(arch))`` of either package with ``changes``
    (a dict value changes that field's nested config)."""
    cfg = configs_module.reduced(configs_module.get_config(arch))
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in changes.items()})


def run_case(mesh, specs: list) -> list:
    """Each spec's model sharded on this rank: the forward's logits and
    balance loss, whisper's ``encode``, then (where ``decode``) the
    prefill step's logits, cache and collectives, and each decode tick's
    logits and collectives; else the refusal of a cache.  ``spec["mesh"]``
    binds another (data, model) mesh over the same ranks."""
    torch.set_num_threads(1)
    out = []
    for spec in specs:
        m = mesh if spec.get("mesh") is None else init_mesh(
            make_test_mesh(*spec["mesh"]), backend="gloo", device="cpu")
        cfg = config(configs, spec["arch"], spec["changes"])
        rules = AxisRules(mesh=m, fsdp=spec["fsdp"])
        model = Model(cfg, rules, device="cpu", params=model_params_from_arrays(
            cfg, spec["tree"], device="cpu", rules=rules))
        dtype = DTYPES[spec["dtype"]]
        model.to(dtype)
        toks = torch.from_numpy(spec["tokens"])
        kw = {k: torch.from_numpy(v).to(dtype)
              for k, v in spec["inputs"].items()}
        s, c = spec["prompt"], spec["cache_len"]
        res = {"coord": m.coord}
        moe.BODIES.clear()
        with torch.no_grad():
            logits, aux, _ = model(toks[:, :s], **kw)
            res.update(logits=logits, aux=aux)
            if cfg.encoder is not None:
                res["encode"] = model.encode(kw["frames"])
            if spec["decode"]:
                with collectives.tally() as records:
                    res["prefill"], cache = make_prefill_step(model, c)(
                        {"tokens": toks[:, :s], **kw})
                res["prefill_tally"] = records
                res["cache"] = {k: v.clone() for k, v in cache.items()}
                res["ticks"], res["tick_tallies"] = [], []
                for t in range(s, toks.shape[1]):
                    with collectives.tally() as records:
                        lg, cache = model.decode_step(cache, toks[:, t:t + 1])
                    res["ticks"].append(lg)
                    res["tick_tallies"].append(records)
            else:
                res["refused"] = []
                whole = {k: torch.zeros(t.shape, dtype=t.dtype)
                         for k, t in cache_shapes(cfg, toks.shape[0], c,
                                                  dtype=dtype).items()}
                for call in (lambda: model(toks[:, :s], return_cache=True,
                                           cache_len=c, **kw),
                             lambda: model.init_cache(toks.shape[0], c),
                             lambda: model.decode_step(whole, toks[:, :1])):
                    try:
                        call()
                        res["refused"].append(None)
                    except NotImplementedError as e:
                        res["refused"].append(str(e))
        res["bodies"] = dict(moe.BODIES)
        out.append(res)
    return out
