"""The port's LM train step against the JAX package's: the synthetic token
pipeline (``repro_torch.data``) bit for bit, ``lm_loss`` with its ignore
labels and paligemma's prefix, ``make_train_step`` over three Adam steps
of four ``reduced()`` configs on the JAX ``Model.init`` weights bridged
with ``interop.model_params_from_arrays``, the gradient of attention
through the ``flash_prefill`` autograd path, and a ``train_lm`` run's
checkpoint loaded into the reference's ``Model``.

Tolerances, and why:

- the data: bitwise (both are the same numpy draws);
- ``lm_loss``: 1e-6 relative (one logsumexp over 11-37 logits and a sum
  taken in another order);
- the first step's gradients: each tensor within 5e-4 of its largest
  entry (or of 1% of the model's largest gradient entry, where that is
  larger: a bias on K moves every score of a query by one constant,
  which the softmax cancels, so whisper's ``bk`` gradients are 0 in
  exact arithmetic and rounding noise of 1e-8 to 2e-7 on both sides).
  Float32 sums in another order (torch's and XLA's products) differ by
  about 1e-4 of an attention layer's largest gradient entry at this
  size: the largest gap measured is 1.6e-4 (paligemma's ``wq``), and
  the Mamba configs' 2.3e-5.  whisper's is 1e-3: the reference takes
  its attention in float32 even under 64-bit mode, and its own
  gradients move by up to 6.0e-4 of a tensor's largest entry between
  its jitted and its op-by-op runs (5.9e-4 measured from the port);
- the metrics: step 1's loss within 1e-5 of the value (it is computed
  before any update), ``tokens`` exactly, ``moe_aux`` within 1e-5; steps
  2 and 3 within 1e-3 of the value.  After an update the two packages'
  parameters differ by more than the gradients do: Adam divides each
  moment by its own root mean square, so a gradient entry near 0 whose
  sign rounding decides moves its parameter by up to +-lr on one side
  and -+lr on the other.  The largest gap measured is 2.5e-4 of the
  value (whisper, step 3).  For the same reason the parameters are not
  held element by element after the steps.

The clip's global norm sums the squared gradients in the order of
``list(model.parameters())`` (the parameters' registration order), which
differs from ``jax.tree.leaves``' sorted keys, so the two norms, and the
clipped updates, differ in their last bits.

whisper-small runs both sides in float64 (the reference under
``jax.enable_x64``), as ``tests/test_torch_whisper.py``'s whole-model
comparisons do: its four attention sublayers a decoder layer amplify a
float32 rounding to 1.5e-3 of a gradient tensor's largest entry at this
size.  The others run in float32.  The attention runs through the
kernels' plain versions (the CPU path), under grad through the
``flash_prefill`` autograd path with its explicit backward."""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load_checkpoint
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.data import SyntheticLMData as RefData
from repro.data import batch_iterator as ref_batch_iterator
from repro.models import Model as RefModel
from repro.optim import Adam as RefAdam
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
from repro.serving import steps as ref_steps
from repro_torch import train_lm
from repro_torch.configs import get_config, reduced
from repro_torch.data import SyntheticLMData, batch_iterator
from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_prefill import autograd as prefill_autograd
from repro_torch.kernels.flash_prefill import flash_prefill_ref
from repro_torch.kernels.selective_scan import autograd as scan_autograd
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan import selective_scan_ref
from repro_torch.models import Model
from repro_torch.optim import Adam
from repro_torch.optim import adam as adam_mod
from repro_torch.optim.adam import apply_updates, clip_by_global_norm
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.serving import steps
from test_torch_models import _close, _pair

# ------------------------------------------------------------------ data

DATA = dict(vocab=97, seq_len=33, seed=3, branching=5)


def test_sequences_are_the_reference_draws():
    got, want = SyntheticLMData(**DATA), RefData(**DATA)
    for idx in (0, 1, 7, 1000):
        seq = got.sequence(idx)
        np.testing.assert_array_equal(seq, want.sequence(idx))
        assert seq.dtype == np.int32 and seq.shape == (DATA["seq_len"] + 1,)


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_batches_and_shards_are_the_reference_draws(num_shards):
    got, want = SyntheticLMData(**DATA), RefData(**DATA)
    full = got.batch(3, 8)
    parts = []
    for shard in range(num_shards):
        b = got.batch(3, 8, shard=shard, num_shards=num_shards)
        w = want.batch(3, 8, shard=shard, num_shards=num_shards)
        assert sorted(b) == sorted(w) == ["labels", "tokens"]
        for key in w:
            np.testing.assert_array_equal(b[key], w[key])
            assert b[key].dtype == w[key].dtype == np.int32
        parts.append(b)
    for key in full:
        np.testing.assert_array_equal(
            np.concatenate([p[key] for p in parts]), full[key])
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])


def test_batch_iterator_is_the_reference_stream():
    got = batch_iterator(SyntheticLMData(**DATA), 4, start_step=2, shard=1,
                         num_shards=2)
    want = ref_batch_iterator(RefData(**DATA), 4, start_step=2, shard=1,
                              num_shards=2)
    for _ in range(3):
        b, w = next(got), next(want)
        for key in w:
            np.testing.assert_array_equal(b[key], w[key])


# ------------------------------------------------------------------ loss

def _loss_pair(logits, labels):
    got = steps.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    want = ref_steps.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    return got, want


@pytest.mark.parametrize("labels", ["all", "some_ignored", "all_ignored"])
def test_lm_loss_matches_reference(labels):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((3, 7, 11))).astype(np.float32)
    lab = rng.integers(0, 11, (3, 7)).astype(np.int32)
    if labels == "some_ignored":
        lab[rng.random((3, 7)) < 0.4] = -1
    elif labels == "all_ignored":
        lab[:] = -1
    (loss, denom), (want_loss, want_denom) = _loss_pair(logits, lab)
    assert loss.dtype == denom.dtype == torch.float32
    assert float(denom) == float(want_denom) == max(int((lab >= 0).sum()), 1)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    if labels == "all_ignored":
        assert float(loss) == 0.0


def test_lm_loss_with_vision_prefix_labels():
    """paligemma's P prefix positions take the ignore label before the
    text's, on both sides."""
    cfg, ref_cfg = (reduced(get_config("paligemma-3b")),
                    ref_reduced(ref_get_config("paligemma-3b")))
    p = cfg.vision.num_patches
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 37, (2, 5)).astype(np.int32)
    labels[0, 1] = -1
    patches = np.zeros((2, p, cfg.vision.embed_dim), np.float32)
    full = steps._full_labels(types.SimpleNamespace(cfg=cfg), {
        "labels": torch.from_numpy(labels),
        "patches": torch.from_numpy(patches)})
    want = ref_steps._full_labels(types.SimpleNamespace(cfg=ref_cfg), {
        "labels": jnp.asarray(labels), "patches": jnp.asarray(patches)})
    np.testing.assert_array_equal(full.numpy(), np.asarray(want))
    assert full.shape == (2, p + 5) and bool((full[:, :p] == -1).all())
    logits = rng.standard_normal((2, p + 5, 37)).astype(np.float32)
    (loss, denom), (want_loss, want_denom) = _loss_pair(logits, full.numpy())
    assert float(denom) == float(want_denom) == 9
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)


# ------------------------------------------------------------ train step

# (changes to both reduced configs, float64 on both sides, gradient
# tolerance): mixtral's window cut to 8 of the batch's 16 positions, so
# the gradient crosses the window's mask, and its experts add the
# balance loss; of the Mamba configs only falcon-mamba-7b (jamba's jitted
# reference step alone takes ~50 s here: its first-step gradients are held
# by test_mamba_gradients_on_the_cpu_match_reference and its autograd path
# by test_scan_gradient_through_the_autograd_path)
CASES = {"tinyllama-1.1b": ({}, False, 5e-4),
         "mixtral-8x7b": ({"sliding_window": 8}, False, 5e-4),
         "whisper-small": ({}, True, 1e-3),
         "paligemma-3b": ({}, False, 5e-4),
         "falcon-mamba-7b": ({}, False, 5e-4)}
B, S, STEPS = 2, 16, 3
GRAD_TOL, GRAD_FLOOR = 5e-4, 1e-2
LOSS_TOL, LATER_TOL = 1e-5, 1e-3


def _batches(cfg, n: int, dtype=np.float32) -> list:
    """``n`` batches of the synthetic pipeline, with seeded frames or
    patches (x 0.02) where the config takes them."""
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=S, seed=1, branching=8)
    rng = np.random.default_rng(5)
    extra = {}
    if cfg.encoder is not None:
        extra["frames"] = rng.standard_normal(
            (B, cfg.encoder.src_len, cfg.d_model)) * 0.02
    if cfg.vision is not None:
        extra["patches"] = rng.standard_normal(
            (B, cfg.vision.num_patches, cfg.vision.embed_dim)) * 0.02
    extra = {k: v.astype(dtype) for k, v in extra.items()}
    return [dict(data.batch(i, B), **extra) for i in range(n)]


@contextlib.contextmanager
def _train_pair(arch):
    """(JAX model, its params, port model), float64 on both sides where
    ``CASES`` says, JAX's 64-bit mode on within."""
    changes, x64, _ = CASES[arch]
    ref, params, port = _pair(arch, **changes)
    if not x64:
        yield ref, params, port
        return
    with jax.enable_x64(True):
        yield (ref, jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 params), port.double())


def _ref_grads(ref, params, batch):
    def loss_fn(p):
        logits, aux, _ = ref.forward(p, batch["tokens"],
                                     **ref_steps._model_inputs(batch))
        loss, _ = ref_steps.lm_loss(logits,
                                    ref_steps._full_labels(ref, batch))
        return loss + 0.01 * aux
    return jax.jit(jax.grad(loss_fn))(params)


# the reference's first-step gradients by config, computed once a process:
# test_train_step_matches_reference and
# test_mamba_gradients_on_the_cpu_match_reference hold the same ones (the
# same weights and first batch), and the jit of a Mamba config's gradient
# takes 2-9 s
_FIRST_GRADS = {}


def _first_ref_grads(arch, ref, params, batch):
    if arch not in _FIRST_GRADS:
        _FIRST_GRADS[arch] = _ref_grads(ref, params, batch)
    return _FIRST_GRADS[arch]


def _leaf(tree, name: str):
    """The reference tree's leaf at a port parameter's name
    (``params.groups.pos0.mixer.wq`` -> ``tree["groups"]["pos0"]...``)."""
    for key in name.split(".")[1:]:
        tree = tree[key]
    return np.asarray(tree)


def _hold_grads(port, grads, want_tree, what, tol=GRAD_TOL):
    names = [n for n, _ in port.named_parameters()]
    wants = [_leaf(want_tree, n) for n in names]
    top = max(float(np.abs(w).max()) for w in wants)
    for name, g, w in zip(names, grads, wants):
        assert tuple(g.shape) == w.shape, name
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        err = float(np.abs(g.detach().double().numpy() - w).max()) / scale
        assert err <= tol, f"{what} {name}: {err:.3e} of {scale:.3e}"


@pytest.mark.parametrize("arch", sorted(CASES))
def test_train_step_matches_reference(arch):
    """The first step's gradients, then three steps' metrics, of
    ``make_train_step`` against the reference's (jitted, as
    ``examples/train_lm.py`` runs it) with the same Adam, schedule and
    clip."""
    with _train_pair(arch) as (ref, params, port):
        dtype = np.float64 if CASES[arch][1] else np.float32
        batches = _batches(ref.cfg, STEPS, dtype)
        jbatches = [{k: jnp.asarray(v) for k, v in b.items()}
                    for b in batches]
        tbatches = [{k: torch.from_numpy(v) for k, v in b.items()}
                    for b in batches]
        grads, _ = steps.train_grads(port, tbatches[0])
        _hold_grads(port, grads,
                    _first_ref_grads(arch, ref, params, jbatches[0]),
                    arch, CASES[arch][2])
        ref_opt = RefAdam(lr=ref_warmup_cosine(3e-3, 2, STEPS),
                          grad_clip=1.0)
        opt = Adam(lr=warmup_cosine(3e-3, 2, STEPS), grad_clip=1.0)
        ref_step = jax.jit(ref_steps.make_train_step(ref, ref_opt))
        step = steps.make_train_step(port, opt)
        ref_state = ref_opt.init(params)
        state = opt.init(list(port.parameters()))
        for i in range(STEPS):
            params, ref_state, want = ref_step(params, ref_state,
                                               jbatches[i])
            state, got = step(state, tbatches[i])
            assert sorted(got) == ["loss", "moe_aux", "tokens"]
            assert all(isinstance(v, torch.Tensor) for v in got.values())
            assert float(got["tokens"]) == float(want["tokens"]) == B * S
            tol = LOSS_TOL if i == 0 else LATER_TOL
            for key in ("loss", "moe_aux"):
                np.testing.assert_allclose(
                    float(got[key]), float(want[key]), rtol=tol, atol=0,
                    err_msg=f"{arch} step {i + 1} {key}")
        assert state.step == STEPS
        assert not any(p.requires_grad for p in port.parameters())
        if ref.cfg.moe is not None:
            assert float(got["moe_aux"]) > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_mamba_gradients_on_the_cpu_match_reference(arch):
    """With the scan's autograd path differentiated by autograd of the
    plain version (``selective_scan_grad`` replaced by
    ``selective_scan_ref``), the first step's gradients of the Mamba
    configs hold the same rule."""
    ref, params, port = _pair(arch)
    batch = _batches(ref.cfg, 1)[0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan_autograd, "selective_scan_grad", selective_scan_ref)
        grads, _ = steps.train_grads(
            port, {k: torch.from_numpy(v) for k, v in batch.items()})
    _hold_grads(port, grads, _first_ref_grads(
        arch, ref, params, {k: jnp.asarray(v) for k, v in batch.items()}),
        arch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_attention_gradient_through_the_autograd_path(arch, monkeypatch):
    """``wq``, ``wk`` and ``wv`` get a nonzero gradient through the
    ``flash_prefill`` autograd path, equal (1e-5 of the largest entry) to
    the one autograd takes through the plain version."""
    _, _, port = _pair(arch, **CASES[arch][0])
    batch = {k: torch.from_numpy(v) for k, v in _batches(port.cfg, 1)[0]
             .items()}
    names = [n for n, _ in port.named_parameters()]
    got, _ = steps.train_grads(port, batch)
    monkeypatch.setattr(prefill_autograd, "flash_prefill_grad",
                        flash_prefill_ref)
    want, _ = steps.train_grads(port, batch)
    for name, g, w in zip(names, got, want):
        if name.split(".")[-1] in ("wq", "wk", "wv"):
            assert float(w.abs().max()) > 0, name
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_scan_gradient_through_the_autograd_path(arch, monkeypatch):
    """Every Mamba parameter gets a nonzero gradient through the
    ``selective_scan`` autograd path (its backward the plain reverse
    recurrence on the CPU), equal (1e-5 of the largest entry) to the one
    autograd takes through the plain forward; the path runs once a Mamba
    layer."""
    _, _, port = _pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in _batches(port.cfg, 1)[0]
             .items()}
    names = [n for n, _ in port.named_parameters()]
    calls = []
    bwd = scan_ops.selective_scan_bwd
    monkeypatch.setattr(scan_ops, "selective_scan_bwd",
                        lambda *a, **k: (calls.append(1), bwd(*a, **k))[1])
    got, _ = steps.train_grads(port, batch)
    assert len(calls) == sum(k == "mamba" for k in port.period) * \
        port.cfg.num_layers // len(port.period)
    monkeypatch.setattr(scan_autograd, "selective_scan_grad",
                        selective_scan_ref)
    want, _ = steps.train_grads(port, batch)
    mamba_keys = {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj",
                  "dt_bias", "a_log", "d_skip", "out_proj"}
    for name, g, w in zip(names, got, want):
        if name.split(".")[-1] in mamba_keys:
            assert float(w.abs().max()) > 0, name
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("clip,decay", [(None, 0.0), (1.0, 0.01)])
def test_adam_update_in_place_is_update_and_apply(clip, decay, monkeypatch):
    """The train step's ``update_in_place`` gives the same bits as
    ``update`` then ``apply_updates``: the parameters and the moments
    over three steps, the gradients clipped in place as ``update`` clips
    a copy, each tensor taken in pieces of 7 elements (and a transposed
    gradient whole)."""
    monkeypatch.setattr(adam_mod, "PIECE", 7)
    rng = np.random.default_rng(9)
    shapes = [(3, 5), (7,), (2, 2, 4), (0, 3)]
    opt = Adam(lr=warmup_cosine(3e-3, 2, 3), grad_clip=clip,
               weight_decay=decay)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in shapes]
    twins = [p.clone() for p in params]
    state, twin_state = opt.init(params), opt.init(twins)
    for _ in range(3):
        grads = [torch.from_numpy(3 * rng.standard_normal(s).astype(
            np.float32)) for s in shapes]
        grads[0] = grads[0].T.contiguous().T
        updates, state = opt.update(grads, state, params)
        apply_updates(params, updates)
        kept = [g.clone() for g in grads]
        twin_state = opt.update_in_place(grads, twin_state, twins)
        if clip is not None:
            for g, k in zip(grads, clip_by_global_norm(kept, clip)):
                assert torch.equal(g, k)
    assert twin_state.step == state.step == 3
    for got, want in zip(twins + twin_state.m + twin_state.v,
                         params + state.m + state.v):
        assert torch.equal(got, want)


def test_train_step_leaves_serving_without_graph():
    """The serving steps build no graph: after a train step the
    parameters are frozen again and a forward has no ``grad_fn``."""
    _, _, port = _pair("tinyllama-1.1b")
    batch = {k: torch.from_numpy(v) for k, v in _batches(port.cfg, 1)[0]
             .items()}
    opt = Adam(lr=1e-3)
    state, _ = steps.make_train_step(port, opt)(
        opt.init(list(port.parameters())), batch)
    logits, _, _ = port(batch["tokens"])
    assert logits.grad_fn is None
    assert not any(p.requires_grad for p in port.parameters())


def test_refuse_grad_only_under_grad():
    """The guard the kernel wrappers call on their CUDA path: it raises
    when grad mode is on and a floating-point operand requires grad, and
    passes integer operands, frozen ones, and any call under
    ``no_grad``."""
    x = torch.zeros(3, requires_grad=True)
    frozen, ids = torch.zeros(3), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="selective_scan.*"
                       "autograd.selective_scan_grad"):
        refuse_grad("selective_scan", (frozen, x, None),
                    "its gradient is autograd.selective_scan_grad's, which "
                    "mamba_forward takes under grad")
    refuse_grad("selective_scan", (frozen, ids, None), "-")
    with torch.no_grad():
        refuse_grad("selective_scan", (x,), "-")


# ------------------------------------------------------------ train_lm

def test_train_lm_checkpoint_loads_into_reference(tmp_path):
    """A short ``train_lm`` run on the CPU: its checkpoint, written by the
    port, loads with ``repro.checkpoint.load_checkpoint`` into the
    reference's tree, every leaf bitwise equal to the port's parameter,
    and the reference's ``Model`` on it gives the port's forward logits
    within ``test_torch_models.py``'s 5e-4 x (1 + |logit|).  The logits
    compare in float64 on both sides (the reference under
    ``jax.enable_x64``): on the port's trained weights a float32 rounding
    grows to 1.9e-3 over the four layers (the port's float32 logits
    against its own float64 ones); in float64 the gap is 3.1e-4."""
    out = train_lm.run(train_lm.parse_args([
        "--steps", "3", "--batch", "2", "--seq", "16", "--device", "cpu",
        "--ckpt", str(tmp_path)]))
    assert np.isfinite(out["first"]) and np.isfinite(out["final"])
    port = out["model"]
    ref_cfg = ref_reduced(ref_get_config("tinyllama-1.1b"), layers=4,
                          d_model=256, vocab=512)
    ref = RefModel(ref_cfg)
    template = {"params": ref.init(jax.random.PRNGKey(1))}
    step, loaded = ref_load_checkpoint(str(tmp_path), template)
    assert step == 3
    for name, p in port.named_parameters():
        np.testing.assert_array_equal(_leaf(loaded["params"], name),
                                      p.detach().numpy(), err_msg=name)
    toks = np.random.default_rng(8).integers(0, 512, (2, 12)).astype(
        np.int32)
    with jax.enable_x64(True):
        want, _, _ = ref.forward(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         loaded["params"]), jnp.asarray(toks))
        got, _, _ = port.double()(torch.from_numpy(toks))
    _close(got, want, "logits of the loaded checkpoint")


def test_train_lm_arguments_are_the_reference_example():
    args = train_lm.parse_args([])
    assert (args.steps, args.arch, args.batch, args.seq, args.ckpt,
            args.device) == (200, "tinyllama-1.1b", 8, 128, "checkpoints/lm",
                             "cuda")
