"""The port's sharding tier against the reference's, in process: the
reference's specs built on ``jax.sharding.AbstractMesh`` (no devices), the
port's on its own abstract ``launch.mesh.Mesh`` of the same axes.

- ``pspecs`` (the port's ``models.model.pspecs``, the reference's
  ``Model.pspecs``) for every architecture on (2, 4), (16, 16) and
  (2, 16, 16), with FSDP off and on and with ``seq_axis="model"``; each
  leaf's ``local_shape`` against ``NamedSharding.shard_shape``;
- ``cache_pspecs`` and the partition-spec half of ``input_specs`` /
  ``cache_specs`` for every ``SHAPES`` entry, the dry run's
  sliding-window variant at ``long_500k`` included;
- ``pick_rules`` for every architecture x shape on both production
  meshes, and the production meshes themselves (``jax.make_mesh`` stood
  in for, so no 512 devices are needed);
- ``P`` against ``PartitionSpec``, ``shard_tree`` / ``gather_tree``,
  ``constrain``, and the two paths the model refuses."""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as RefP

import repro.configs as ref_configs
import repro.launch.mesh as ref_mesh
from repro.launch.inputs import cache_specs as ref_cache_specs
from repro.launch.inputs import input_specs as ref_input_specs
from repro.models import Model as RefModel
from repro.sharding.specs import AxisRules as RefRules
from repro.sharding.specs import batch_axes as ref_batch_axes
from repro.sharding.specs import shard_axis as ref_shard_axis
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import cache_pspecs as input_cache_pspecs
from repro_torch.launch.inputs import input_pspecs
from repro_torch.launch.mesh import (Mesh, make_production_mesh,
                                     make_test_mesh, mesh_chips)
from repro_torch.models import Model
from repro_torch.models.model import (cache_pspecs, check_runnable,
                                      param_descs, pspecs)
from repro_torch.sharding.place import (gather_tree, local_shape,
                                        rank_coords, shard_tree)
from repro_torch.sharding.specs import (AxisRules, P, batch_axes, constrain,
                                        named, shard_axis)
from test_torch_contract import import_reference_dryrun

ref_dryrun = import_reference_dryrun()
ARCHS = ref_configs.ARCH_IDS
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"tp": {}, "fsdp": {"fsdp": True}, "seq": {"seq_axis": "model"}}


def _meshes(name):
    shape, axes = MESHES[name]
    return Mesh(axes, shape), AbstractMesh(shape, axes)


def _rules(mesh_name, rules_name):
    port, ref = _meshes(mesh_name)
    kw = RULES[rules_name]
    return AxisRules(mesh=port, **kw), RefRules(mesh=ref, **kw)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    return {path: tree}


def _same_specs(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])
        assert isinstance(got[k], P) and repr(got[k]) == repr(want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_and_shard_shapes_equal_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for mesh_name in MESHES:
        for rules_name in RULES:
            rules, ref_rules = _rules(mesh_name, rules_name)
            ref = RefModel(ref_cfg, ref_rules)
            _same_specs(pspecs(cfg, rules), ref.pspecs())
            want = _flat(ref.pspecs())
            shapes = _flat(jax.tree.map(lambda s: s.shape, ref.shapes(),
                                        is_leaf=lambda x: hasattr(x, "shape")))
            descs = _flat(param_descs(cfg, rules))
            for k, spec in want.items():
                assert descs[k].shape == shapes[k]
                try:
                    ref_local = NamedSharding(ref_rules.mesh, spec
                                              ).shard_shape(shapes[k])
                except ValueError:
                    with pytest.raises(ValueError):
                        local_shape(shapes[k], descs[k].pspec, rules.mesh)
                    continue
                assert local_shape(shapes[k], descs[k].pspec,
                                   rules.mesh) == tuple(ref_local), k
                assert named(rules, descs[k].pspec).shard_shape(
                    shapes[k]) == tuple(ref_local)


def _shape_cases(arch):
    """(port config, reference config, port shape, reference shape) of
    every ``SHAPES`` entry, the sliding-window variant at long_500k."""
    for name in ref_configs.SHAPES:
        cfgs = (configs.get_config(arch), ref_configs.get_config(arch))
        if name == "long_500k":
            cfgs = tuple(m.with_sliding_window_variant(c)
                         for m, c in zip((configs, ref_configs), cfgs))
        yield (*cfgs, configs.SHAPES[name], ref_configs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_pspecs_equal_reference(arch):
    for mesh_name in MESHES:
        for rules_name in RULES:
            rules, ref_rules = _rules(mesh_name, rules_name)
            for cfg, ref_cfg, shape, ref_shape in _shape_cases(arch):
                ref = RefModel(ref_cfg, ref_rules)
                _same_specs(input_pspecs(cfg, shape, rules),
                            ref_input_specs(ref, ref_shape)[1])
                _same_specs(input_cache_pspecs(cfg, shape, rules),
                            ref_cache_specs(ref, ref_shape)[1])
                for batch, seq in ((3, 100), (32, 4096), (1, 7)):
                    _same_specs(cache_pspecs(cfg, rules, batch, seq),
                                ref.cache_pspecs(batch, seq))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_meshes_and_pick_rules_equal_reference(kind, monkeypatch):
    """The reference's ``make_production_mesh`` with ``jax.make_mesh``
    stood in for by an ``AbstractMesh`` of its arguments."""
    monkeypatch.setattr(ref_mesh.jax, "make_mesh",
                        lambda shape, axes: AbstractMesh(shape, axes))
    ref = ref_mesh.make_production_mesh(multi_pod=kind == "multi")
    port = make_production_mesh(multi_pod=kind == "multi")
    assert (port.axis_names, port.axis_sizes) == (ref.axis_names,
                                                  tuple(ref.axis_sizes))
    assert mesh_chips(port) == math.prod(ref.axis_sizes) == \
        (512 if kind == "multi" else 256)
    assert dryrun.FSDP_BUDGET_BYTES == ref_dryrun.FSDP_BUDGET_BYTES == 8e9
    for arch in ARCHS:
        for cfg, ref_cfg, shape, ref_shape in _shape_cases(arch):
            got = dryrun.pick_rules(cfg, port, shape.mode, shape.seq_len)
            want = ref_dryrun.pick_rules(ref_cfg, ref, ref_shape.mode,
                                         ref_shape.seq_len)
            assert (got.fsdp, got.seq_axis, got.tensor_axis,
                    got.expert_axis, got.data_axes) == (
                want.fsdp, want.seq_axis, want.tensor_axis,
                want.expert_axis, want.data_axes), (arch, shape.name)
            assert batch_axes(got) == ref_batch_axes(want)


def test_test_mesh_and_rules_helpers_equal_reference():
    assert make_test_mesh() == Mesh(("data", "model"), (2, 2))
    for mesh_name in MESHES:
        rules, ref_rules = _rules(mesh_name, "tp")
        for name in ("data", "model", "pod", ("data", "model"),
                     ("pod", "data")):
            assert rules.axis_size(name) == ref_rules.axis_size(name)
            for dim in (1, 2, 12, 16, 48, 257216):
                assert rules.divisible(dim, name) == \
                    ref_rules.divisible(dim, name)
                assert shard_axis(rules, dim, name) == \
                    ref_shard_axis(ref_rules, dim, name)
        assert rules.data_axes == ref_rules.data_axes
        assert batch_axes(rules) == ref_batch_axes(ref_rules)
    assert AxisRules().data_axes == RefRules().data_axes == ("data",)
    assert shard_axis(AxisRules(), 3, "model") == \
        ref_shard_axis(RefRules(), 3, "model") == "model"


def test_partition_spec_prints_and_compares_as_reference():
    for parts in [(), (None,), ("data", None), (("pod", "data"), "model"),
                  (None, None, "model", None)]:
        got, want = P(*parts), RefP(*parts)
        assert repr(got) == repr(want) == str(got)
        assert got == want and want == got and tuple(got) == tuple(want)
        assert P(*parts) == P(*parts)
    import pickle
    assert pickle.loads(pickle.dumps(P("data", None))) == P("data", None)


def test_shard_and_gather_round_trip():
    """Every rank's blocks on a (2, 2, 2) mesh, a tuple entry and Mamba's
    two-part ``in_proj`` included, gathered back whole; a rank's block
    is where ``NamedSharding`` puts it (first axis major)."""
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2))
    x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    for spec in (P(("pod", "data"), None, "model"), P(None, "data"),
                 P("model", None, ("pod", "data", "model")[1:])):
        if any(x.shape[i] % math.prod(mesh.shape[a] for a in (
                (e,) if isinstance(e, str) else e or ()))
               for i, e in enumerate(spec)):
            continue
        shards = [shard_tree({"w": x}, {"w": spec}, mesh, c)
                  for c in rank_coords(mesh)]
        np.testing.assert_array_equal(gather_tree(shards, {"w": spec},
                                                  mesh)["w"], x)
    s = shard_tree({"w": x}, {"w": P(("pod", "data"))}, mesh, (1, 0, 1))
    np.testing.assert_array_equal(s["w"], x[4:6])
    cfg = configs.reduced(configs.get_config("falcon-mamba-7b"))
    rules = AxisRules(mesh=make_test_mesh(1, 2))
    desc = param_descs(cfg, rules)["groups"]["pos0"]["mixer"]["in_proj"]
    assert desc.parts == 2
    w = torch.arange(math.prod(desc.shape), dtype=torch.float32).reshape(
        desc.shape)
    d_in = desc.shape[-1] // 2
    halves = [shard_tree(w, desc, rules.mesh, c) for c in ((0, 0), (0, 1))]
    torch.testing.assert_close(halves[1][..., :d_in // 2],
                               w[..., d_in // 2:d_in], rtol=0, atol=0)
    torch.testing.assert_close(halves[1][..., d_in // 2:],
                               w[..., d_in + d_in // 2:], rtol=0, atol=0)
    torch.testing.assert_close(gather_tree(halves, desc, rules.mesh), w,
                               rtol=0, atol=0)


def test_constrain_checks_the_local_shape():
    rules = AxisRules(mesh=make_test_mesh(2, 4))
    x = torch.zeros(3, 8)
    assert constrain(x, rules, P(None, "model"), (3, 32)) is x
    with pytest.raises(ValueError, match="local shape"):
        constrain(x, rules, P("data", "model"), (4, 32))
    with pytest.raises(ValueError, match="more entries"):
        constrain(x, rules, P(None, None, None))
    assert constrain(x, AxisRules(), P("data"), (3, 8)) is x


def test_sequence_parallel_and_context_parallel_cache_raise():
    """The two paths of the reference this slice refuses, each naming the
    next sharding slice."""
    cfg = configs.reduced(configs.get_config("llama3-8b"))
    for mesh in (None, make_test_mesh(2, 2)):
        with pytest.raises(NotImplementedError, match="sequence-parallel"):
            Model(cfg, AxisRules(mesh=mesh, seq_axis="model"), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    pali = configs.reduced(configs.get_config("paligemma-3b"))
    rules = AxisRules(mesh=make_test_mesh(2, 2))
    with pytest.raises(NotImplementedError,
                       match="context-parallel decode cache"):
        check_runnable(pali, rules, 4, 16)
    check_runnable(pali, rules, 4, 15)       # odd: the cache replicates
    check_runnable(cfg, rules, 4, 16)        # 4 KV heads divide model = 2
    with pytest.raises(ValueError, match="abstract"):
        Model(cfg, rules, device="cpu",
              generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_multi_chip_dry_run_records(kind, tmp_path, monkeypatch):
    """Every pair on a production mesh: a chip's bytes are its shards',
    and a pair the port runs sharded has the collective term of
    ``step_collectives``'s link bytes over NVLink; the others say why
    not and have none."""
    from repro_torch.launch import roofline as rl
    from repro_torch.sharding import collectives
    monkeypatch.setattr(dryrun, "card_bytes", lambda: 80e9)
    assert dryrun.main(["--all", "--mesh", kind, "--out", str(tmp_path)]) == 0
    files = sorted(tmp_path.glob(f"*_{kind}.json"))
    assert len(files) == 40
    import json
    n_runs = 0
    for f in files:
        rec = json.loads(f.read_text())
        assert rec["mesh"] == kind and rec["chips"] == (
            512 if kind == "multi" else 256) and rec["model_par"] == 16
        r = rec["roofline"]
        if rec["runs"]:
            n_runs += 1
            cfg = configs.get_config(rec["arch"])
            if rec["variant"] == "swa":
                cfg = configs.with_sliding_window_variant(cfg)
            rules = dryrun.pick_rules(cfg, make_production_mesh(
                multi_pod=kind == "multi"), configs.SHAPES[rec["shape"]].mode,
                configs.SHAPES[rec["shape"]].seq_len)
            link = collectives.link_bytes(collectives.step_collectives(
                cfg, configs.SHAPES[rec["shape"]], rules), rules)
            assert rec["collective_link_bytes"] == link > 0
            assert r["collective_s"] == link / rl.LINK_BW
            assert rec["why_not"] is None
        else:
            assert r["collective_s"] == 0.0
            assert rec["collective_link_bytes"] is None
            assert "slice" in rec["why_not"]
        m = rec["memory"]
        assert m["total"] == sum(m[k] for k in ("params", "optimizer",
                                                "cache", "inputs"))
    assert n_runs >= 3
    # a chip holds 1/16 of falcon-mamba-7b's (model-sharded) weights and
    # the replicated norms and vocab-sharded tables
    rec = dryrun.run_pair("falcon-mamba-7b", "decode_32k", hbm_bytes=80e9,
                          mesh=kind)
    cfg = configs.get_config("falcon-mamba-7b")
    assert rec["memory"]["params"] < 2 * configs.param_count(cfg) / 15
    assert rec["runs"] and rec["seq_axis"] is None
