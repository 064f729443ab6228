"""Build the port's state from plain numpy arrays, so the port and another
implementation (the JAX reference in the tests) can start from identical
state.  The functions take arrays only; nothing here imports the other
implementation."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.env import obs_dim
from repro_torch.core.micro_state import LocalityState
from repro_torch.core.micro_torch import DeviceRings
from repro_torch.core.policy import Mlp, PolicyNet
from repro_torch.core.predictor import Predictor
from repro_torch.models.model import param_descs
from repro_torch.models.params import ParamDesc, check_tree, local_descs
from repro_torch.sharding.place import shard_tree
from repro_torch.sim.state import ClusterState

_DTYPES = {"region_ptr": np.int64, "power_price": np.float64,
           "gpu_id": np.int8, "tflops": np.float64, "mem_gb": np.float64,
           "power_w": np.float64, "kind_id": np.int8,
           "capacity": np.float64, "switch_scale": np.float64,
           "state": np.int8, "warm_remaining_s": np.float64,
           "queue_s": np.float64, "util": np.float64,
           "idle_slots": np.int64, "current_model": np.int16,
           "warm_models": np.int16}


def cluster_state_from_arrays(**fields: np.ndarray) -> ClusterState:
    """A port ``ClusterState`` from every ``ClusterState`` field given as
    a numpy array (copied, in the port's dtypes)."""
    names = {f.name for f in dataclasses.fields(ClusterState)}
    if set(fields) != names:
        raise ValueError(f"cluster_state_from_arrays: missing "
                         f"{sorted(names - set(fields))}, unknown "
                         f"{sorted(set(fields) - names)}")
    return ClusterState(**{k: np.array(v, dtype=_DTYPES[k])
                           for k, v in fields.items()})


def rings_from_arrays(mids: np.ndarray, slots: np.ndarray,
                      embeds: np.ndarray, norms: np.ndarray, *,
                      device="cuda") -> DeviceRings:
    """The port's ``DeviceRings`` from stacked (R, S_pad, K[, E]) ring
    arrays."""
    device = resolve_device(device)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return DeviceRings(mids=dev(mids, torch.int32),
                       slots=dev(slots, torch.int32),
                       embeds=dev(embeds, torch.float32),
                       norms=dev(norms, torch.float32))


def locality_state_from_arrays(mids: np.ndarray, slots: np.ndarray,
                               embeds: np.ndarray, norms: np.ndarray,
                               uid: np.ndarray,
                               count: np.ndarray) -> LocalityState:
    """One region's host ``LocalityState`` (the per-region routes' rings)
    from its (S, K[, E]) ring arrays, copied in the port's dtypes.  Host
    arrays only: the ``jax`` route uploads them per call."""
    return LocalityState(
        mids=np.array(mids, dtype=np.int32),
        slots=np.array(slots, dtype=np.int32),
        embeds=np.array(embeds, dtype=np.float32),
        norms=np.array(norms, dtype=np.float32),
        uid=np.array(uid, dtype=np.int64),
        count=np.array(count, dtype=np.int32))


def model_params_from_arrays(cfg, tree, *, device="cuda", rules=None,
                             coord=None) -> dict:
    """The port ``Model``'s parameters from a weight tree given as nested
    dicts of numpy arrays, named and shaped as the reference's
    ``Model.init`` pytree (groups stacked on a leading dim; an MoE
    position's router and (G, E, D, F) expert tensors included): every
    leaf copied to ``device`` as float32.  Raises when a key or a shape
    differs from ``models.model.param_descs(cfg)``.  With ``rules`` on a
    mesh, only the shards of the rank at ``coord`` (default: the bound
    mesh's own) are copied, cut by ``param_descs(cfg, rules)``."""
    device = resolve_device(device)
    descs = param_descs(cfg, rules)
    check_tree(descs, tree)
    mesh = None if rules is None else rules.mesh
    if mesh is not None:
        tree = shard_tree(tree, descs, mesh,
                          mesh.coord if coord is None else coord)
        check_tree(local_descs(descs, mesh), tree)

    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return torch.tensor(np.asarray(t), dtype=torch.float32,
                            device=device)
    return convert(tree)


def _mlp_descs(mlp: Mlp) -> dict:
    """The reference's ``[{"w": (in, out), "b": (out,)}, ...]`` layer list
    of ``mlp``, as descriptors keyed by layer index."""
    return {str(i): {"w": ParamDesc(tuple(layer.weight.shape[::-1])),
                     "b": ParamDesc(tuple(layer.bias.shape))}
            for i, layer in enumerate(mlp.layers)}


def _load_mlp(mlp: Mlp, layers, path: str) -> None:
    """Copy a reference layer list into ``mlp`` (``w`` transposed into
    ``nn.Linear.weight``); raises on a missing key or a wrong shape."""
    if not isinstance(layers, (list, tuple)):
        raise ValueError(f"parameter tree {path or '/'}: a list of layers "
                         f"expected, got {type(layers).__name__}")
    tree = {str(i): layer for i, layer in enumerate(layers)}
    check_tree(_mlp_descs(mlp), tree, path)
    with torch.no_grad():
        for layer, arrays in zip(mlp.layers, layers):
            layer.weight.copy_(torch.tensor(
                np.asarray(arrays["w"], np.float32).T))
            layer.bias.copy_(torch.tensor(
                np.asarray(arrays["b"], np.float32)))


def _mlp_arrays(mlp: Mlp) -> list:
    """``mlp``'s layers as the reference's ``[{"w": (in, out), "b":
    (out,)}, ...]`` list of numpy arrays (``w`` transposed back from
    ``nn.Linear.weight``), copied to the host."""
    return [{"w": layer.weight.detach().cpu().numpy().T.copy(),
             "b": layer.bias.detach().cpu().numpy().copy()}
            for layer in mlp.layers]


def policy_params_to_arrays(net: PolicyNet) -> dict:
    """The reference's ``init_policy`` pytree (``{"policy": [...],
    "value": [...]}``) of ``net``, as numpy arrays: the inverse of
    :func:`policy_params_from_arrays`."""
    return {"policy": _mlp_arrays(net.policy),
            "value": _mlp_arrays(net.value)}


def predictor_params_to_arrays(net: Predictor) -> list:
    """The reference's ``init_predictor`` layer list of ``net``, as numpy
    arrays: the inverse of :func:`predictor_params_from_arrays`."""
    return _mlp_arrays(net)


def policy_params_from_arrays(tree, n_regions: int, *,
                              device="cuda") -> PolicyNet:
    """The port's ``PolicyNet`` from the reference's ``init_policy``
    pytree (``{"policy": [...], "value": [...]}``, each layer ``{"w":
    (in, out), "b": (out,)}``) given as numpy arrays."""
    net = PolicyNet(obs_dim(n_regions), n_regions, resolve_device(device))
    if not isinstance(tree, dict) or set(tree) != {"policy", "value"}:
        raise ValueError(f"parameter tree /: keys "
                         f"{sorted(tree) if isinstance(tree, dict) else tree}"
                         f", expected ['policy', 'value']")
    _load_mlp(net.policy, tree["policy"], "/policy")
    _load_mlp(net.value, tree["value"], "/value")
    return net


def predictor_params_from_arrays(tree, n_regions: int, *,
                                 device="cuda") -> Predictor:
    """The port's ``Predictor`` from the reference's ``init_predictor``
    layer list given as numpy arrays."""
    net = Predictor(n_regions, resolve_device(device))
    _load_mlp(net, tree, "")
    return net
