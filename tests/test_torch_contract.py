"""The port's contract with the rest of the repo: it imports neither jax,
the JAX package, networkx, msgpack nor ml_dtypes (the H100 machine has
neither of the last two), its entry points default to the card and
raise without one, and the constants and data it copied equal the
reference's."""
import ast
import dataclasses
import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.core.env as ref_env
import repro.core.micro as ref_micro
import repro.core.policy as ref_policy
import repro.core.predictor as ref_predictor
import repro.data as ref_data
import repro.kernels.compat_score.fused as ref_fused
import repro.kernels.compat_score.kernel as ref_compat
import repro.obs as ref_obs
import repro.obs.series as ref_series
import repro.sim.cluster as ref_cluster
import repro.sim.state as ref_state
import repro.sim.topology as ref_topology
import repro.workload as ref_workload
import repro.workload.trace as ref_trace
import repro.workload.batch as ref_batch
import repro_torch.configs as configs
import repro_torch.core.env as env
import repro_torch.core.micro as micro
import repro_torch.core.policy as policy
import repro_torch.core.predictor as predictor
import repro_torch.data as data
import repro_torch.kernels.compat_score.ref as compat
import repro_torch.obs as obs
import repro_torch.obs.series as series
import repro_torch.sim.cluster as cluster
import repro_torch.sim.state as state
import repro_torch.sim.topology as topology
import repro_torch.workload as workload
import repro_torch.workload.trace as trace
from repro_torch.baselines import ReactiveOTScheduler
import repro_torch.workload.batch as batch
from repro_torch.core.macro import MacroAllocator
from repro_torch.core.micro import MicroAllocator
from repro_torch.core.ppo import PPOTrainer
from repro_torch.core.theory import estimate_k0_from_reactive
from repro_torch.core.torta import TortaScheduler
from repro_torch.interop import (model_params_from_arrays,
                                 policy_params_from_arrays,
                                 predictor_params_from_arrays,
                                 rings_from_arrays)
from repro_torch.models import Model
from repro_torch.serving import Replica, ServingCluster
from repro_torch.sim.engine import Engine
from repro_torch.sim.reference import make_reference_torta
from repro_torch.sim.state import make_cluster_state
from repro_torch.sim.topology import Topology
from repro_torch import train_lm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (init_mesh, make_production_mesh,
                                     make_test_mesh, spawn)
from repro_torch.workload import StreamingWorkload

def import_reference_dryrun():
    """``repro.launch.dryrun``, for its constants and rules: importing it
    sets ``XLA_FLAGS`` to fake 512 host devices, which is put back, so no
    later JAX start in this process sees them."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref_dryrun


ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "networkx", "msgpack", "ml_dtypes")


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_include_the_train_slice():
    """The walk over the port's files reaches the token pipeline and the
    training script, so the import checks cover them."""
    for rel in ("data/__init__.py", "data/tokens.py", "train_lm.py",
                "kernels/flash_prefill/autograd.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


def test_port_files_include_the_launch_tier():
    """The walk over the port's files reaches the launch tier, so the
    import checks cover it."""
    for rel in ("launch/__init__.py", "launch/inputs.py",
                "launch/roofline.py", "launch/dryrun.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


def test_port_files_include_the_sharding_tier():
    """The walk over the port's files reaches the sharding tier and the
    mesh, so the import checks cover them."""
    for rel in ("sharding/__init__.py", "sharding/specs.py",
                "sharding/place.py", "sharding/collectives.py",
                "launch/mesh.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


def test_port_files_include_the_object_path():
    """The walk over the port's files reaches the frozen per-object oracle
    and the modules of the object path, so the import checks cover
    them."""
    for rel in ("sim/reference.py", "sim/cluster.py", "core/torta.py",
                "core/micro.py", "core/micro_state.py", "api/adapter.py"):
        assert ROOT / "src" / "repro_torch" / rel in PORT_FILES, rel


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_with_jax_and_reference_blocked():
    """Every module of the port (and chip_smoke.py) imports in a fresh
    interpreter in which ``import jax``, ``import repro``,
    ``import networkx``, ``import msgpack`` and ``import ml_dtypes``
    fail."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"roots = {FORBIDDEN!r}\n"
        "assert not any(k.split('.')[0] in roots\n"
        "               for k, v in sys.modules.items() if v is not None)\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _engine_args():
    cs = make_cluster_state(2, seed=0, servers_per_region=(3, 4))
    lat = np.full((2, 2), 10.0)
    src = StreamingWorkload(np.full((2, 2), 3.0), seed=0)
    return Topology("t2", 2, 10, lat), cs, src


def _rl_arrays(r=3):
    """(capacity, power cost, latency, traffic) of a 3-region env."""
    return (np.full(r, 40.0), np.ones(r), np.full((r, r), 10.0),
            np.full((8, r), 30.0))


def _nets(r=3):
    """A policy and a predictor on the CPU (the card's are refused
    earlier)."""
    return (policy.init_policy(torch.Generator().manual_seed(0),
                               env.obs_dim(r), r),
            predictor.init_predictor(torch.Generator().manual_seed(1), r))


ENTRY_POINTS = {
    "TortaScheduler": lambda: TortaScheduler(3),
    "TortaScheduler(jax)": lambda: TortaScheduler(
        3, micro_backend="jax", micro_fused_kernel=True),
    "TortaScheduler(pallas)": lambda: TortaScheduler(3,
                                                     use_compat_kernel=True),
    "TortaScheduler(sticky)": lambda: TortaScheduler(3,
                                                     distribution="sticky"),
    "make_reference_torta": lambda: make_reference_torta(3),
    "MicroAllocator(jax)": lambda: MicroAllocator(backend="jax"),
    "hw_load_matrix(pallas)": lambda: micro.hw_load_matrix(
        np.ones((2, 8)), np.ones((3, 8)), backend="pallas"),
    "MacroAllocator": lambda: MacroAllocator(3),
    "MacroAllocator(policy)": lambda: MacroAllocator(
        3, policy_params=_nets()[0], predictor=_nets()[1]),
    "TortaScheduler(policy)": lambda: TortaScheduler(
        3, policy_params=_nets()[0], predictor=_nets()[1],
        prediction_noise=0.3),
    "PredictorTrainer": lambda: predictor.PredictorTrainer(3),
    "PPOTrainer": lambda: PPOTrainer(
        env.make_env_params(*_rl_arrays(), device="cpu"), 3),
    "make_env_params": lambda: env.make_env_params(*_rl_arrays()),
    "estimate_k0_from_reactive": lambda: estimate_k0_from_reactive(
        3, _rl_arrays()[3], *_rl_arrays()[:3]),
    "policy_params_from_arrays": lambda: policy_params_from_arrays({}, 3),
    "predictor_params_from_arrays": lambda: predictor_params_from_arrays(
        [], 3),
    "MicroAllocator": lambda: MicroAllocator(),
    "ReactiveOTScheduler": lambda: ReactiveOTScheduler(3),
    "Engine": lambda: Engine(*_engine_args(),
                             TortaScheduler(2, device="cpu")),
    "Engine(numpy)": lambda: Engine(*_engine_args(),
                                    TortaScheduler(2, device="cpu"),
                                    step_backend="numpy"),
    "rings_from_arrays": lambda: rings_from_arrays(
        np.zeros((1, 1, 4)), np.zeros((1, 1, 4)), np.zeros((1, 1, 4, 8)),
        np.zeros((1, 1, 4))),
    "Model": lambda: Model(configs.reduced(configs.get_config(
        "tinyllama-1.1b"))),
    "Replica": lambda: Replica({}),
    "ServingCluster": lambda: ServingCluster(1, 1, ["tinyllama-1.1b"]),
    "model_params_from_arrays": lambda: model_params_from_arrays(
        configs.reduced(configs.get_config("tinyllama-1.1b")), {}),
    "train_lm": lambda: train_lm.run(train_lm.parse_args([])),
    "dryrun": lambda: dryrun.main(["--arch", "tinyllama-1.1b", "--shape",
                                   "decode_32k"]),
    "dryrun.run_pair": lambda: dryrun.run_pair("tinyllama-1.1b",
                                               "decode_32k"),
    "dryrun(single)": lambda: dryrun.main(["--all", "--mesh", "single"]),
    "spawn": lambda: spawn(_noop, make_test_mesh(1, 1), backend="gloo",
                           device="cuda"),
    "init_mesh": lambda: init_mesh(make_test_mesh(1, 1), backend="gloo",
                                   device="cuda"),
}


def _noop(mesh):
    return None


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_card_raises(name, no_card):
    with pytest.raises(RuntimeError, match="CUDA device required"):
        ENTRY_POINTS[name]()


CONSTANTS = [
    (micro, ref_micro, "W_HW"), (micro, ref_micro, "W_LOAD"),
    (micro, ref_micro, "W_LOC"), (micro, ref_micro, "W_WARM"),
    (micro, ref_micro, "W_MODEL"), (micro, ref_micro, "W_EMBED"),
    (micro, ref_micro, "LOC_DECAY"), (micro, ref_micro, "_DEMAND_BY_KIND"),
    (micro, ref_micro, "_MODEL_RANK"), (micro, ref_micro, "KIND_ORDER"),
    (cluster, ref_cluster, "GPU_TYPES"), (cluster, ref_cluster, "MODEL_SWITCH_S"),
    (cluster, ref_cluster, "MODEL_CATALOG"), (cluster, ref_cluster, "COLD_START_S"),
    (cluster, ref_cluster, "SWITCH_POWER_FRAC"),
    (cluster, ref_cluster, "MIGRATION_STAGES_S"),
    (cluster, ref_cluster, "MIGRATION_S"),
    (configs, ref_configs, "RunShape"), (configs, ref_configs, "SHAPES"),
    (state, ref_state, "_WARM_HIT_S"), (state, ref_state, "MODEL_NAMES"),
    (state, ref_state, "WARM_SLOTS"), (state, ref_state, "KINDS"),
    (predictor, ref_env, "K_HIST"), (batch, ref_batch, "EMBED_DIM"),
    (micro.MicroAllocator, ref_micro.MicroAllocator, "KEEP"),
    (micro, ref_micro, "KERNEL_LOAD_CAP"),
    (compat, ref_compat, "W_HW"), (compat, ref_compat, "W_LOAD"),
    (compat, ref_compat, "W_LOC"), (compat, ref_fused, "W_WARM"),
]


@pytest.mark.parametrize("port,ref,name", CONSTANTS,
                         ids=[f"compat.{c[2]}" if c[0] is compat else c[2]
                              for c in CONSTANTS])
def test_copied_constant_equals_reference(port, ref, name):
    got, want = getattr(port, name), getattr(ref, name)
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        assert _fields(got) == _fields(want)


def _fields(x):
    """A dataclass (class or instance), or a dict of them, as its fields,
    so that the copy in each package compares equal; anything else as
    is."""
    if isinstance(x, dict):
        return {k: _fields(v) for k, v in x.items()}
    if isinstance(x, type) and dataclasses.is_dataclass(x):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(x)]
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.astuple(x))
    return x


OBS_CONSTANTS = {
    "series.DEFAULT_WINDOW": (series.DEFAULT_WINDOW,
                              ref_series.DEFAULT_WINDOW),
    "series.PERCENTILES": (series.PERCENTILES, ref_series.PERCENTILES),
    "Counters.prometheus_text prefix": tuple(
        inspect.signature(m.Counters.prometheus_text).parameters[
            "prefix"].default for m in (obs, ref_obs)),
    "ObsConfig fields": tuple(
        [(f.name, f.default) for f in dataclasses.fields(m.ObsConfig)]
        for m in (obs, ref_obs)),
}


@pytest.mark.parametrize("name", sorted(OBS_CONSTANTS))
def test_copied_obs_constant_equals_reference(name):
    got, want = OBS_CONSTANTS[name]
    assert got == want


RL_CONSTANTS = {
    "env.K_HIST": (env.K_HIST, ref_env.K_HIST),
    "predictor.K_HIST": (predictor.K_HIST, ref_predictor.K_HIST),
    "policy.HIDDEN": (policy.HIDDEN, ref_policy.HIDDEN),
    "predictor.HIDDEN": (predictor.HIDDEN, inspect.signature(
        ref_predictor.init_predictor).parameters["hidden"].default),
}


@pytest.mark.parametrize("name", sorted(RL_CONSTANTS))
def test_copied_rl_constant_equals_reference(name):
    got, want = RL_CONSTANTS[name]
    assert got == want


def test_dry_run_budget_and_production_meshes_equal_reference(monkeypatch):
    """``FSDP_BUDGET_BYTES`` and the production meshes' axes and sizes
    (the reference's ``make_production_mesh`` with ``jax.make_mesh``
    stood in for, so no 512 devices are needed)."""
    import repro.launch.mesh as ref_mesh
    assert dryrun.FSDP_BUDGET_BYTES == \
        import_reference_dryrun().FSDP_BUDGET_BYTES
    monkeypatch.setattr(ref_mesh.jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi in (False, True):
        port = make_production_mesh(multi_pod=multi)
        shape, axes = ref_mesh.make_production_mesh(multi_pod=multi)
        assert (port.axis_sizes, port.axis_names) == (shape, axes)


def test_synthetic_data_defaults_equal_reference():
    """``SyntheticLMData``'s fields and defaults (``branching`` 32, seed 0)
    are the reference's."""
    got, want = ([(f.name, f.default) for f in dataclasses.fields(
        m.SyntheticLMData)] for m in (data, ref_data))
    assert got == want
    assert dict(got)["branching"] == 32


def test_copied_cluster_builder_matches_reference():
    """Same seeds, same fleet: every field of ``make_cluster_state``."""
    from repro.sim.state import make_cluster_state as ref_mcs
    got = make_cluster_state(7, seed=11, servers_per_region=(3, 9))
    want = ref_mcs(7, seed=11, servers_per_region=(3, 9))
    for name in want.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
        assert getattr(got, name).dtype == getattr(want, name).dtype, name


def test_copied_arch_registry_equals_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert list(configs.list_archs()) == list(ref_configs.list_archs())


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_copied_config_equals_reference(arch):
    """Every field of the published config and of its ``reduced()``
    variant, nested configs (MoE, SSM, encoder, vision) included."""
    for fn in (lambda m: m.get_config(arch),
               lambda m: m.reduced(m.get_config(arch)),
               lambda m: m.reduced(m.get_config(arch), layers=2, d_model=128,
                                   vocab=256)):
        got, want = fn(configs), fn(ref_configs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.hd, got.is_attention_free, got.has_mamba,
                got.subquadratic) == (want.hd, want.is_attention_free,
                                      want.has_mamba, want.subquadratic)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_copied_param_counts_equal_reference(arch):
    """``param_count``, ``active_param_count`` and
    ``with_sliding_window_variant`` of the published config, its reduced
    variant and a 4096 / 64-token window variant."""
    for fn in (lambda m: m.get_config(arch),
               lambda m: m.reduced(m.get_config(arch)),
               lambda m: m.with_sliding_window_variant(m.get_config(arch)),
               lambda m: m.with_sliding_window_variant(
                   m.reduced(m.get_config(arch)), window=64)):
        got, want = fn(configs), fn(ref_configs)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert configs.param_count(got) == ref_configs.param_count(want)
        assert configs.active_param_count(got) == \
            ref_configs.active_param_count(want)


def test_whisper_config_equals_reference():
    """whisper-small, the one encoder-decoder: the fields its encoder,
    cross-attention and absolute positions turn on, in the port's copy
    and the reference's, at their published values."""
    def pin(m):
        cfg = m.get_config("whisper-small")
        return (cfg.encoder.num_layers, cfg.encoder.src_len, cfg.num_layers,
                cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
                cfg.vocab, cfg.norm_kind, cfg.act, cfg.qkv_bias,
                cfg.tie_embeddings, cfg.vision)
    assert pin(configs) == pin(ref_configs) == (
        12, 1500, 12, 768, 12, 12, 3072, 51865, "layernorm", "gelu", True,
        False, None)


def test_paligemma_config_equals_reference():
    """paligemma-3b, the one vision config: its stub frontend's
    ``VisionStubConfig`` (the class's defaults and the published values,
    and the reduced variant's) and the fields the prefix and the hd 256
    decode depend on, in the port's copy and the reference's."""
    def pin(m):
        cfg = m.get_config("paligemma-3b")
        return (dataclasses.asdict(m.VisionStubConfig()),
                dataclasses.asdict(cfg.vision),
                dataclasses.asdict(m.reduced(cfg).vision), cfg.num_layers,
                cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                cfg.d_ff, cfg.vocab, cfg.act, cfg.tie_embeddings,
                cfg.sliding_window, cfg.encoder)
    assert pin(configs) == pin(ref_configs) == (
        {"num_patches": 256, "embed_dim": 1152},
        {"num_patches": 256, "embed_dim": 1152},
        {"num_patches": 8, "embed_dim": 64}, 18, 2048, 8, 1, 256, 16384,
        257216, "gelu_glu", False, None, None)


def test_moe_config_defaults_equal_reference():
    fields = {f.name: f.default for f in dataclasses.fields(configs.MoEConfig)}
    want = {f.name: f.default
            for f in dataclasses.fields(ref_configs.MoEConfig)}
    assert fields == want
    assert (fields["capacity_factor"], fields["aux_loss_weight"]) == \
        (1.25, 0.01)


def test_copied_topologies_and_scenarios_equal_reference():
    assert topology.TOPOLOGY_SPECS == ref_topology.TOPOLOGY_SPECS
    assert workload.list_scenarios() == ref_workload.list_scenarios()


def test_copied_example_trace_is_byte_equal():
    assert trace.DEFAULT_TRACE != ref_trace.DEFAULT_TRACE
    assert trace.DEFAULT_TRACE.read_bytes() == \
        ref_trace.DEFAULT_TRACE.read_bytes()
