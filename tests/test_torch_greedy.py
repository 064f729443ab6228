"""The port's fused multi-region greedy (plain version of the
``greedy_assign`` kernel, on the CPU) against the JAX package: the numpy
oracle ``MicroAllocator(backend="numpy")._assign_core`` region by region,
and the fused JAX scan itself in a separate process.  Assignments and
ring contents must be identical.  The kernel's static-operand variant
(the per-region route with the fused score kernel) is held to the JAX
per-region scan the same way, given the same static matrices."""
import numpy as np
import pytest
import torch

from _torch_port import (port_batch, port_obs, ref_obs, run_jax_fused,
                         sweep_slots, world)
from repro.core.micro import MicroAllocator as RefMicro
from repro.sim.state import OFF
from repro.workload import make_source
from repro_torch.core.micro import MicroAllocator
from repro_torch.core import micro_torch
from repro_torch.core.micro_torch import (bucket, note_norms,
                                          server_pad_map)
from repro_torch.interop import rings_from_arrays
from repro_torch.kernels.greedy_assign import greedy_assign
from repro_torch.kernels.greedy_assign import ops

# (regions, servers per region, seed): the randomized sweep of the fused
# step tests, with every size class and a 1-region case
SWEEP = [(1, 3, 0), (1, 17, 4096), (2, 8, 17), (3, 3, 1234), (3, 17, 77),
         (4, 8, 9_999), (5, 3, 31), (5, 17, 2024)]
RING_FIELDS = ("mids", "slots", "count", "embeds", "norms")


def _assert_rings_equal(ref, got, j):
    if ref is None:
        assert got is None or (got.count == 0).all(), f"region {j}"
        return
    for name in RING_FIELDS:
        np.testing.assert_array_equal(getattr(ref, name), getattr(got, name),
                                      err_msg=f"region {j} {name}")


def _run_sweep(r, spr, seed):
    """Port assignments per slot and the port allocator, plus the numpy
    oracle's per-region assignments and allocator."""
    ref = RefMicro(backend="numpy")
    port = MicroAllocator(device="cpu")
    pairs = []
    for t, cs, batch, region_of in sweep_slots(r, spr, seed):
        obs = ref_obs(cs, t)
        want = np.full(len(batch), -1, np.int32)
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                want[idx] = ref.assign_batch(obs, j, batch, idx)
        got = port.assign_batch_all(port_obs(obs), port_batch(batch),
                                    region_of)
        pairs.append((t, want, got))
    return pairs, ref, port


@pytest.mark.parametrize("r,spr,seed", SWEEP)
def test_fused_greedy_matches_numpy_oracle(r, spr, seed):
    """Identical assignments slot by slot (rings carried across 3 slots,
    zero-task and all-inactive regions included) and identical rings."""
    pairs, ref, port = _run_sweep(r, spr, seed)
    for t, want, got in pairs:
        np.testing.assert_array_equal(got, want, err_msg=f"slot {t}")
    for j in range(r):
        _assert_rings_equal(ref.locality_state(j), port.locality_state(j), j)


def test_fused_greedy_matches_fused_jax_scan(tmp_path):
    """One sweep case against ``micro_jax.assign_scan_all`` itself.  The
    fused JAX scan stores XLA's row norms in its rings, which may differ
    from the numpy oracle's in the last ulp, so ring norms are compared
    to float32 rounding there and everything else exactly."""
    r, spr, seed = 4, 8, 9_999
    ref = run_jax_fused(tmp_path, "greedy", str(r), str(spr), str(seed))
    pairs, _, port = _run_sweep(r, spr, seed)
    for t, _, got in pairs:
        np.testing.assert_array_equal(got, ref[f"out_{t}"],
                                      err_msg=f"slot {t}")
    for j in range(r):
        got = port.locality_state(j)
        if f"mids_{j}" not in ref:
            assert got is None or (got.count == 0).all()
            continue
        for name in ("mids", "slots", "count", "embeds"):
            np.testing.assert_array_equal(getattr(got, name),
                                          ref[f"{name}_{j}"],
                                          err_msg=f"region {j} {name}")
        np.testing.assert_allclose(got.norms, ref[f"norms_{j}"],
                                   rtol=2e-7, atol=0)


def test_static_variant_matches_jax_per_region_scan(tmp_path, monkeypatch):
    """``micro_jax.assign_scan`` with ``fused=True``, run region by region
    over a sweep in a separate process, saves each static matrix its
    ``fused_score`` gave; fed the same matrices, the port's per-region
    route (the greedy's static variant, plain version) assigns
    identically and ends with equal rings, uids included."""
    r, spr, seed = 5, 17, 2024
    ref = run_jax_fused(tmp_path, "scan", str(r), str(spr), str(seed), "1")
    statics = iter(sorted((k for k in ref if k.startswith("static_")),
                          key=lambda k: int(k.split("_")[1])))

    def recorded(tf, sf, task_mids, server_models, locality=None):
        got = torch.from_numpy(ref[next(statics)])
        assert got.shape == (tf.shape[0], sf.shape[0])
        return got
    monkeypatch.setattr(micro_torch, "fused_score", recorded)
    port = MicroAllocator(backend="jax", fused=True, device="cpu")
    n_calls = 0
    for t, cs, batch, region_of in sweep_slots(r, spr, seed):
        obs = port_obs(ref_obs(cs, t))
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                got = port.assign_batch(obs, j, port_batch(batch), idx)
                np.testing.assert_array_equal(
                    got, ref[f"out_{t}_{j}"], err_msg=f"slot {t} region {j}")
                n_calls += 1
    assert next(statics, None) is None and n_calls > 0
    for j in range(r):
        got = port.locality_state(j)
        if f"mids_{j}" not in ref:
            assert got is None, f"region {j}"
            continue
        for name in RING_FIELDS + ("uid",):
            np.testing.assert_array_equal(getattr(got, name),
                                          ref[f"{name}_{j}"],
                                          err_msg=f"region {j} {name}")


def test_single_region_assign_core_matches_oracle():
    """The per-region ``_assign_core`` API rides the same fused greedy
    and device rings, and still matches the oracle across slots."""
    cs, rng = world(1, 9, 23)
    ref = RefMicro(backend="numpy")
    port = MicroAllocator(device="cpu")
    for t in range(3):
        n = 21
        embeds = rng.standard_normal((n, 8)).astype(np.float32)
        has = rng.random(n) > 0.25
        embeds[~has] = 0.0
        arrs = dict(mem_t=rng.uniform(1.0, 40.0, n),
                    work=rng.uniform(1.0, 60.0, n),
                    mids=rng.integers(0, 6, n).astype(np.int16),
                    kind_ids=rng.integers(0, 3, n).astype(np.int8),
                    embeds=embeds, has_embed=has,
                    norms=np.linalg.norm(embeds, axis=1))
        obs = ref_obs(cs, t)
        np.testing.assert_array_equal(port._assign_core(port_obs(obs), 0,
                                                        **arrs),
                                      ref._assign_core(obs, 0, **arrs),
                                      err_msg=f"slot {t}")
    _assert_rings_equal(ref.locality_state(0), port.locality_state(0), 0)


def test_zero_tasks_and_unrouted_rows_stay_buffered():
    cs, _ = world(2, 5, 11)
    port = MicroAllocator(device="cpu")
    batch = port_batch(make_source("diurnal", 1, 2, seed=3,
                                   base_rate=6.0).slot_batch(0))
    obs = port_obs(ref_obs(cs, 0))
    out = port.assign_batch_all(obs, batch.select(np.arange(0)),
                                np.zeros(0, np.int32))
    assert out.shape == (0,)
    out = port.assign_batch_all(obs, batch,
                                np.full(len(batch), -1, np.int32))
    assert (out == -1).all()
    assert port.locality_state(0) is None


def test_all_inactive_fleet_assigns_nothing():
    cs, rng = world(3, 4, 7)
    cs.state[:] = OFF
    batch = port_batch(make_source("diurnal", 1, 3, seed=5,
                                   base_rate=8.0).slot_batch(0))
    port = MicroAllocator(device="cpu")
    out = port.assign_batch_all(port_obs(ref_obs(cs, 0)), batch,
                                rng.integers(0, 3, len(batch)).astype(
                                    np.int32))
    assert (out == -1).all()
    for j in range(3):
        assert (port.locality_state(j).count == 0).all()


def test_bucket_and_server_pad_map():
    """Task-axis buckets (powers of two below 256, multiples of 256 above)
    and the padded server map of ``micro_jax``."""
    assert [bucket(n) for n in (1, 16, 17, 100, 255, 256, 257, 5889)] == \
        [16, 16, 32, 128, 256, 256, 512, 6144]
    gmap, valid = server_pad_map(np.array([0, 3, 3, 5]))
    np.testing.assert_array_equal(gmap, [[0, 1, 2], [0, 0, 0], [3, 4, 0]])
    np.testing.assert_array_equal(valid, [[1, 1, 1], [0, 0, 0], [1, 1, 0]])


@pytest.mark.parametrize("width,pad", [(1, 0), (3, 5), (8, 0), (16, 0)])
def test_note_norms_equal_numpy_row_norms(width, pad):
    """The device-side ring norms are bitwise the numpy oracle's per-row
    ``np.linalg.norm``, over a wide dynamic range and with the embedding
    channel zero-padded as the wrapper pads it."""
    rng = np.random.default_rng(width * 31 + pad)
    n = 20_000
    emb = (rng.standard_normal((n, width))
           * np.exp(rng.uniform(-20, 20, (n, 1)))).astype(np.float32)
    want = np.array([np.linalg.norm(row) for row in emb], np.float32)
    got = note_norms(torch.from_numpy(np.pad(emb, ((0, 0), (0, pad)))))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_wrapper_counts_no_launch_on_cpu():
    """On a CPU operand set the wrapper runs the plain version and counts
    no kernel launch."""
    cs, rng = world(2, 6, 3)
    port = MicroAllocator(device="cpu")
    batch = port_batch(make_source("diurnal", 1, 2, seed=1,
                                   base_rate=6.0).slot_batch(0))
    before = greedy_assign.launches
    port.assign_batch_all(port_obs(ref_obs(cs, 0)), batch,
                          rng.integers(0, 2, len(batch)).astype(np.int32))
    assert greedy_assign.launches == before
    assert port._dev_rings.mids.device == torch.device("cpu")


def test_port_continues_from_reference_rings():
    """``interop.rings_from_arrays`` seeds the port with the oracle's
    rings after one slot; the next slot then assigns identically."""
    r, spr, seed = 3, 8, 42
    ref = RefMicro(backend="numpy")
    port = MicroAllocator(device="cpu")
    for t, cs, batch, region_of in sweep_slots(r, spr, seed, n_slots=2):
        obs = ref_obs(cs, t)
        want = np.full(len(batch), -1, np.int32)
        for j in range(r):
            idx = np.flatnonzero(region_of == j)
            if idx.size:
                want[idx] = ref.assign_batch(obs, j, batch, idx)
        if t == 0:
            s_pad = int(cs.region_sizes().max())
            rings = {name: np.zeros((r, s_pad) + getattr(
                ref.locality_state(0), name).shape[1:],
                getattr(ref.locality_state(0), name).dtype)
                for name in ("mids", "slots", "embeds", "norms")}
            rings["mids"][:] = -2                       # EMPTY
            for j in range(r):
                st = ref.locality_state(j)
                if st is not None:
                    for name, arr in rings.items():
                        arr[j, :st.mids.shape[0]] = getattr(st, name)
            port._dev_rings = rings_from_arrays(**rings, device="cpu")
            continue
        got = port.assign_batch_all(port_obs(obs), port_batch(batch),
                                    region_of)
        np.testing.assert_array_equal(got, want, err_msg=f"slot {t}")


# ------------------------------------------------------------ launch plan

# the H100's SM count; the plan takes the card's own on the card
N_SMS = 132


def _assert_plan_covers(plan, s_pad):
    """Every server owned by exactly one block; ranges contiguous and
    ascending in rank (the first-index tie-break folds partials of
    ascending ranges); every block owns at least one server."""
    assert plan.cluster in ops.CLUSTER_SIZES
    ranges = plan.ranges(s_pad)
    assert len(ranges) == plan.cluster
    assert ranges[0][0] == 0 and ranges[-1][1] == s_pad
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
        assert hi == nxt
    assert all(lo < hi for lo, hi in ranges)
    owners = np.zeros(s_pad, np.int64)
    for lo, hi in ranges:
        owners[lo:hi] += 1
    assert (owners == 1).all()
    # a block's first server starts a 16-byte-aligned slice of its rows
    assert plan.span % ops.GRANULE == 0
    assert all(lo % ops.GRANULE == 0 for lo, _ in ranges)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.smem <= ops.SMEM_LIMIT


def _fits_at_once(r, s_pad, e):
    """Cluster sizes whose R clusters the card holds at once
    (``resident_estimate``) with at most ``MAX_BLOCKS_PER_SM`` blocks an
    SM on average."""
    fits = []
    for c in ops.CLUSTER_SIZES:
        try:
            plan = ops.launch_plan(r, s_pad, e, N_SMS, cluster=c)
        except ValueError:
            continue
        if (ops.resident_estimate(plan, N_SMS) >= r
                and c * r <= ops.MAX_BLOCKS_PER_SM * N_SMS):
            fits.append(c)
    return fits


def _rule_choice(r, s_pad, e):
    """The wave rule written out: the admitted size with the least
    waves x ``STEP_US``, waves from ``resident_estimate``."""
    costs = {}
    for c in ops.CLUSTER_SIZES:
        try:
            plan = ops.launch_plan(r, s_pad, e, N_SMS, cluster=c)
        except ValueError:
            continue
        held = ops.resident_estimate(plan, N_SMS)
        if held > 0:
            costs[c] = -(-r // held) * ops.STEP_US[c]
    return min(costs, key=costs.get)


@pytest.mark.parametrize("e", [8, 16])
@pytest.mark.parametrize("s_pad", [20, 500, 4096])
@pytest.mark.parametrize("r", [1, 6, 25])
def test_launch_plan_covers_servers_and_fits_card(r, s_pad, e):
    """The wrapper's launch plan over the shapes the port meets covers
    every server, each block within the shared-memory limit.  Where some
    size's R clusters are held at once (``resident_estimate``, at most
    ``MAX_BLOCKS_PER_SM`` blocks an SM on average) it is the largest such
    size; 25 regions of 4096 servers need clusters of 8 for shared
    memory, which 132 SMs cannot hold at once, so they run in waves at
    the wave rule's size."""
    plan = ops.launch_plan(r, s_pad, e, N_SMS)
    _assert_plan_covers(plan, s_pad)
    assert plan.smem == ops.smem_bytes(plan.span, e, plan.cluster,
                                       plan.threads)
    held = ops.resident_estimate(plan, N_SMS)
    if r == 25 and s_pad == 4096:
        assert not _fits_at_once(r, s_pad, e)
        assert plan.cluster == _rule_choice(r, s_pad, e)
        assert held < r
        return
    assert held >= r
    assert plan.cluster * r <= ops.MAX_BLOCKS_PER_SM * N_SMS
    per_sm = held * plan.cluster // N_SMS
    assert per_sm * (plan.smem + 1024) <= ops.SM_SMEM
    assert per_sm * plan.threads <= ops.LOOP_SM_THREADS
    # the largest size that fits: the next larger one does not
    bigger = [c for c in ops.CLUSTER_SIZES if c > plan.cluster]
    if bigger:
        c = bigger[0]
        try:
            forced = ops.launch_plan(r, s_pad, e, N_SMS, cluster=c)
        except ValueError:
            return
        assert (ops.resident_estimate(forced, N_SMS) < r
                or c * r > ops.MAX_BLOCKS_PER_SM * N_SMS)


@pytest.mark.parametrize("s_pad", [20, 500, 4096])
def test_forced_cluster_sizes_cover_servers(s_pad):
    """The on-card sweep forces each size; every size the plan accepts
    still covers the servers, and a size that would leave a block with
    no server raises."""
    accepted = 0
    for c in ops.CLUSTER_SIZES:
        if (c - 1) * ops.GRANULE >= s_pad:
            with pytest.raises(ValueError, match="cannot run"):
                ops.launch_plan(1, s_pad, 8, N_SMS, cluster=c)
            continue
        try:
            plan = ops.launch_plan(1, s_pad, 8, N_SMS, cluster=c)
        except ValueError:
            continue
        assert plan.cluster == c
        _assert_plan_covers(plan, s_pad)
        accepted += 1
    assert accepted >= 2


@pytest.mark.parametrize("r,s_pad,e", [(200, 500, 8), (1, 100_000, 8),
                                       (25, 4096, 16)])
def test_launch_plan_raises_when_shape_cannot_fit(r, s_pad, e):
    """Only a region whose block overflows shared memory even at the
    largest cluster size raises (1 x 100,000).  More regions than the
    card holds clusters at once (200 x 500, 25 x 4096 at E = 16) no
    longer raise: they run in waves, on a plan that covers every server
    within the limit."""
    if s_pad == 100_000:
        with pytest.raises(ValueError, match="cannot run"):
            ops.launch_plan(r, s_pad, e, N_SMS)
        return
    plan = ops.launch_plan(r, s_pad, e, N_SMS)
    _assert_plan_covers(plan, s_pad)
    assert not _fits_at_once(r, s_pad, e)


@pytest.mark.parametrize("r,s_pad,e,want", [
    (1, 500, 8, 16), (25, 500, 8, 8), (6, 500, 16, 16), (66, 500, 8, 4),
    (132, 500, 8, 1),                          # R fits at once: as before
    (200, 500, 8, 8), (200, 500, 16, 8), (133, 500, 8, 8),
    (25, 4096, 8, 8), (25, 4096, 16, 8), (1000, 20, 8, 2)])    # waves
def test_launch_plan_wave_rule(r, s_pad, e, want):
    """The size the plan picks: the largest whose R clusters are held at
    once where one is (25 x 500: 8, R = 1: 16, as before waves existed;
    132 x 500: 1, since the card holds 66 clusters of 2 at 1024 threads a
    block); else the least waves x ``STEP_US`` (200 x 500: 8, the fastest
    of the on-card sweep at that shape)."""
    plan = ops.launch_plan(r, s_pad, e, N_SMS)
    assert plan.cluster == want
    fits = _fits_at_once(r, s_pad, e)
    assert plan.cluster == (max(fits) if fits else _rule_choice(r, s_pad, e))


def test_launch_plan_waves_follow_the_cards_count():
    """Given the card's resident count, the rule weighs waves by it: a
    card that held 200 clusters of 2 at once would run 200 x 500 in one
    wave at C = 2 rather than in four at C = 8."""
    def card(plan):
        return 200 if plan.cluster == 2 else 50
    assert ops.launch_plan(200, 500, 8, N_SMS, resident=card).cluster == 2
    assert ops.launch_plan(200, 500, 8, N_SMS,
                           resident=lambda p: 0 if p.cluster != 4
                           else 10).cluster == 4
    with pytest.raises(ValueError, match="holds no cluster"):
        ops.launch_plan(200, 500, 8, N_SMS, resident=lambda p: 0)


def test_workspace_layout():
    """One pre-pass row per (region, task slot): a 16-byte-aligned task
    record, then 17 bytes per server over S_pad rounded up to 16."""
    assert ops.task_bytes(8) == 64 and ops.task_bytes(16) == 96
    assert ops.workspace_bytes(25, 5632, 500, 8) == 25 * 5632 * (64 + 17 * 512)
    assert ops.workspace_bytes(1, 16, 20, 16) == 16 * (96 + 17 * 32)
