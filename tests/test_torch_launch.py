"""The launch tier on one card (``repro_torch.launch``) and the shape
helpers it reads, against the JAX package on the CPU:

- ``analytic_costs`` and ``model_flops`` equal the reference's to the last
  bit for every architecture x ``SHAPES`` entry (the dry run's
  sliding-window variant at ``long_500k`` too) x (chips, model_par, fsdp)
  in {(1, 1, F), (256, 16, F), (256, 16, T), (512, 16, T)};
- ``Roofline``'s terms are the reference's FLOPs and bytes over the H100's
  peaks;
- ``model_shapes``, ``cache_shapes``, ``mamba_state_shapes`` and
  ``input_specs`` equal the reference's abstract trees (``Model(cfg)
  .shapes()``, its ``cache_shapes``, ``input_specs``) in keys, shapes and
  dtypes;
- ``run_pair`` records on the CPU with the card's memory given.

Only ``meta`` tensors and shape structs are built: nothing is allocated.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import roofline as ref_rl
from repro.launch.inputs import cache_specs as ref_cache_specs
from repro.launch.inputs import input_specs as ref_input_specs
from repro.models.mamba import mamba_state_shapes as ref_mamba_state_shapes
from repro.models.model import Model as RefModel
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.inputs import cache_specs, input_specs
from repro_torch.models import Model
from repro_torch.models.mamba import mamba_state_shapes
from repro_torch.models.model import cache_shapes, model_shapes, param_descs
from repro_torch.models.params import count_params

ARCHS = ref_configs.ARCH_IDS
GRID = ((1, 1, False), (256, 16, False), (256, 16, True), (512, 16, True))
H100 = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
        "float64": 67e12}
HBM, LINK = 3.35e12, 450e9


def _cfgs(arch, shape_name):
    """(port config, reference config) pairs of ``arch`` for a shape: the
    published config and, at ``long_500k``, the dry run's variant."""
    out = [(configs.get_config(arch), ref_configs.get_config(arch))]
    if shape_name == "long_500k":
        out.append(tuple(m.with_sliding_window_variant(m.get_config(arch))
                         for m in (configs, ref_configs)))
    return out


def _shapes(name):
    return configs.SHAPES[name], ref_configs.SHAPES[name]


def _flat(tree, path=""):
    """{path: (shape, dtype name)} of a nested dict of ``meta`` tensors or
    ``jax.ShapeDtypeStruct``s."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}"))
        return out
    name = (str(tree.dtype).removeprefix("torch.")
            if isinstance(tree.dtype, torch.dtype) else np.dtype(tree.dtype).name)
    return {path: (tuple(tree.shape), name)}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _same_tree(got, want):
    assert _flat(got) == _flat(want)
    assert all(t.device.type == "meta" for t in _leaves(got))


# --------------------------------------------------------------- roofline


@pytest.mark.parametrize("shape_name", sorted(ref_configs.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_costs_and_model_flops_equal_reference(arch, shape_name):
    shape, ref_shape = _shapes(shape_name)
    for cfg, ref_cfg in _cfgs(arch, shape_name):
        assert rl.model_flops(cfg, shape) == \
            ref_rl.model_flops(ref_cfg, ref_shape)
        for chips, model_par, fsdp in GRID:
            got = rl.analytic_costs(cfg, shape, chips, model_par, fsdp=fsdp)
            want = ref_rl.analytic_costs(ref_cfg, ref_shape, chips,
                                         model_par, fsdp=fsdp)
            assert got == want, (cfg.name, chips, model_par, fsdp)
            assert all(type(v) is float for v in got.values())


def test_attn_kv_sum_equals_reference():
    for s_q in (1, 7, 64, 4096):
        for s_kv in (1, 64, 4096, 32768):
            for window in (None, 1, 63, 64, 4096, 1 << 20):
                assert rl._attn_kv_sum(s_q, s_kv, window) == \
                    ref_rl._attn_kv_sum(s_q, s_kv, window)


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_terms_are_reference_costs_over_h100_peaks(arch):
    for shape_name in ref_configs.SHAPES:
        shape, ref_shape = _shapes(shape_name)
        for cfg, ref_cfg in _cfgs(arch, shape_name):
            for chips, model_par, fsdp in GRID:
                ac = ref_rl.analytic_costs(ref_cfg, ref_shape, chips,
                                           model_par, fsdp=fsdp)
                mf = ref_rl.model_flops(ref_cfg, ref_shape)
                for precision, peak in H100.items():
                    r = rl.build(arch, shape, "m", chips, cfg,
                                 model_par=model_par, fsdp=fsdp,
                                 precision=precision)
                    assert r.compute_s == ac["flops_per_device"] / peak
                    assert r.memory_s == ac["bytes_per_device"] / HBM
                    assert r.collective_s == 0.0
                    assert r.model_flops == mf
                    assert r.useful_flop_frac == \
                        mf / (ac["flops_per_device"] * chips)
                    terms = {"compute": r.compute_s, "memory": r.memory_s,
                             "collective": r.collective_s}
                    assert r.bottleneck == max(terms, key=terms.get)
                    assert r.to_dict()["precision"] == precision


def test_collective_term_is_link_bytes_over_nvlink():
    r = rl.Roofline("a", "s", "m", 8, flops_per_device=1e12,
                    bytes_per_device=1e9, collective_bytes_per_device=9e11,
                    model_flops=4e12).finalize("tf32")
    assert r.collective_s == 9e11 / LINK == 2.0
    assert r.bottleneck == "collective"
    assert r.useful_flop_frac == 4e12 / 8e12


def test_peaks_default_precision_and_mfu():
    assert rl.PEAK_FLOPS == H100
    assert (rl.HBM_BW, rl.LINK_BW) == (HBM, LINK)
    cfg = configs.get_config("tinyllama-1.1b")
    shape = configs.RunShape("train", 512, 4, "train")
    r = rl.build("tinyllama-1.1b", shape, "h100x1", 1, cfg)
    assert r.precision == "bfloat16" and r.collective_s == 0.0
    assert r.compute_s == rl.analytic_costs(
        cfg, shape, 1, 1)["flops_per_device"] / 989e12
    assert r.model_flops == 6.0 * configs.param_count(cfg) * 2048
    got = rl.mfu(cfg, shape, 0.4, precision="float32")
    assert got == r.model_flops / (0.4 * 67e12)
    assert 0.5 < got < 0.51


# ----------------------------------------------------------------- shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_trees_equal_reference(arch):
    """Parameters (bfloat16 and float32), and for every shape the cache
    and the inputs, with the dry run's variant at ``long_500k``."""
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    ref_model = RefModel(ref_cfg)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        got = model_shapes(cfg, dtype)
        _same_tree(got, ref_model.shapes(jdtype))
        total = sum(t.numel() for t in _leaves(got))
        assert total == count_params(param_descs(cfg))
    for shape_name in ref_configs.SHAPES:
        shape, ref_shape = _shapes(shape_name)
        for c, rc in _cfgs(arch, shape_name):
            m = RefModel(rc)
            _same_tree(cache_specs(c, shape),
                       ref_cache_specs(m, ref_shape)[0])
            _same_tree(cache_shapes(c, 3, 100, dtype=torch.float32),
                       m.cache_shapes(3, 100, dtype=jnp.float32))
            _same_tree(input_specs(c, shape),
                       ref_input_specs(m, ref_shape)[0])
            _same_tree(input_specs(c, shape, dtype=torch.float32),
                       ref_input_specs(m, ref_shape, dtype=jnp.float32)[0])


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if ref_configs.get_config(a).has_mamba])
def test_mamba_state_shapes_equal_reference(arch):
    for batch in (1, 4):
        assert mamba_state_shapes(configs.get_config(arch), batch) == \
            ref_mamba_state_shapes(ref_configs.get_config(arch), batch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-v0.1-52b",
                                  "whisper-small"])
def test_model_methods_match_shapes_and_init_cache(arch):
    """``Model.shapes`` / ``cache_shapes`` are the module functions of its
    config, and ``init_cache`` allocates exactly the cache's shapes."""
    cfg = configs.reduced(configs.get_config(arch))
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    _same_tree(model.shapes(torch.float32), model_shapes(cfg, torch.float32))
    assert _flat(model.shapes()) == {
        k: (shape, "bfloat16") for k, (shape, _) in
        _flat(model_shapes(cfg, torch.float32)).items()}
    meta = model.cache_shapes(2, 40, dtype=torch.float32)
    cache = model.init_cache(2, 40)
    assert _flat(cache) == _flat(meta)
    assert list(cache) == list(meta)
    assert torch.equal(cache["pos"], torch.full((2,), -1, dtype=torch.int32))
    assert all(not v.any() for k, v in cache.items() if k != "pos")
    assert _flat(model.init_cache(2, 40, dtype=torch.bfloat16)) == \
        _flat(cache_shapes(cfg, 2, 40))


# ---------------------------------------------------------------- dry run


RECORD_KEYS = {"arch", "shape", "mesh", "variant", "chips", "fsdp",
               "params", "memory", "roofline", "status"}


def test_run_pair_decode_32k_does_not_fit_80gb():
    """tinyllama-1.1b at decode_32k: the bf16 cache of 128 x 32,768
    positions (22 layers, 4 KV heads of 64) alone is 94.5 GB."""
    arch = "tinyllama-1.1b"
    cfg = configs.get_config(arch)
    rec = dryrun.run_pair(arch, "decode_32k", hbm_bytes=80e9)
    assert set(rec) == RECORD_KEYS
    assert (rec["mesh"], rec["variant"], rec["chips"], rec["fsdp"],
            rec["status"]) == ("h100x1", "baseline", 1, False, "ok")
    assert rec["params"] == configs.param_count(cfg)
    m = rec["memory"]
    assert m["params"] == 2 * count_params(param_descs(cfg))
    assert m["optimizer"] == 0
    assert m["cache"] == 2 * 22 * 128 * 32768 * 4 * 64 * 2 + 128 * 4
    assert m["inputs"] == 128 * 4
    assert m["total"] == m["params"] + m["cache"] + m["inputs"]
    assert m["hbm"] == 80e9 and m["fits"] is False
    want = rl.build(arch, configs.SHAPES["decode_32k"], "h100x1", 1, cfg)
    assert rec["roofline"] == want.to_dict()
    assert rec["roofline"]["bottleneck"] == "memory"
    json.dumps(rec)


def test_run_pair_reduced_shapes_fit_and_train_counts_adam():
    arch = "tinyllama-1.1b"
    cfg = configs.get_config(arch)
    n = count_params(param_descs(cfg))
    rec = dryrun.run_pair(arch, configs.RunShape("decode_1k", 1024, 8,
                                                 "decode"), hbm_bytes=80e9)
    assert rec["shape"] == "decode_1k" and rec["memory"]["fits"] is True
    assert rec["memory"]["cache"] == 2 * 22 * 8 * 1024 * 4 * 64 * 2 + 8 * 4
    train = dryrun.run_pair(arch, configs.RunShape("train", 512, 4, "train"),
                            hbm_bytes=80e9)
    assert train["memory"]["optimizer"] == 8 * n
    assert (train["memory"]["cache"], train["memory"]["inputs"]) == \
        (0, 2 * 4 * 512 * 4)
    assert train["memory"]["fits"] is True
    assert dryrun.run_pair(arch, "train_4k", hbm_bytes=1e9)["memory"][
        "fits"] is False


def test_run_pair_long_500k_takes_the_sliding_window_variant():
    dense = dryrun.run_pair("llama3-8b", "long_500k", hbm_bytes=80e9)
    assert dense["variant"] == "swa"
    cfg = configs.with_sliding_window_variant(configs.get_config("llama3-8b"))
    assert dense["params"] == configs.param_count(cfg)
    assert dense["roofline"] == rl.build(
        "llama3-8b", configs.SHAPES["long_500k"], "h100x1", 1,
        cfg).to_dict()
    ssm = dryrun.run_pair("falcon-mamba-7b", "long_500k", hbm_bytes=80e9)
    assert ssm["variant"] == "baseline"


def test_dryrun_main_writes_records(tmp_path, monkeypatch, capsys):
    """The command line with the card's memory stood in for."""
    monkeypatch.setattr(dryrun, "card_bytes", lambda: 80e9)
    assert dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen2.5-3b_decode_32k_h100x1.json")
                     .read_text())
    assert rec == json.loads(json.dumps(dryrun.run_pair(
        "qwen2.5-3b", "decode_32k", hbm_bytes=80e9)))
    out = capsys.readouterr().out
    assert "does not fit" in out and "bottleneck memory" in out
    assert "done: 1 pairs" in out

