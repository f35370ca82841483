"""The port's replica placement against the JAX package's:
``tests/test_replica_devices.py``'s cases that mean something for torch.

* **Device assignment.** ``replica_devices(R, device)`` round-robins R
  replicas over the CUDA cards (checked here with a patched device count)
  and is ``[None] * R`` on one card or on the CPU; a set over several
  cards defaults to the overlapped placement, pins one router clone to
  each card and gives each worker a stream of its own, and a later fused
  set on the same template router puts it back on its home device.
* **Single-device defaults.** Fused is the R>1 default; an explicit
  overlapped placement pins nothing and still completes.
* **Overlapped ≡ fused ≡ plain scheduler**, per request, at R=4 and R=1,
  on a fault-free deterministic pool — and equal to the reference's.
* **Fault-grid equivalence.** Per-launch ``fault_row_offset`` makes the
  overlapped placement draw the fused dispatch's fault grid cell for
  cell: fused and overlapped streams bit-match under an active
  FaultPolicy, per seed, on both packages.

No counterpart: ``replica_mesh`` (a ``jax.sharding.Mesh``; the port's
distribution tools are still to come) and
``test_overlapped_stream_zero_recompiles_after_prewarm`` (the port runs
eagerly: no ``prewarm_compile``, nothing to recompile). The reference's
multi-device cases run there on forced XLA host devices; a patched count
stands in here, and the card run of ``chip_smoke.py`` drives overlapped
streams on the H100.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from _torch_serving import (
    PORT,
    both,
    make_pool,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    pool_budget,
)
from repro_torch.distributed import replica_devices
from repro_torch.serving import replica as t_replica


def test_replica_devices_round_robin(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", i) for i in range(3)]
    assert replica_devices(5, "cuda") == cards + cards[:2]
    assert replica_devices(2, "cuda:1") == cards[:2]
    assert replica_devices(5, "cpu") == [None] * 5     # no card for a CPU router
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert replica_devices(3, "cuda") == [None] * 3


def test_workers_are_pinned_one_router_per_card(monkeypatch):
    """Four cards (a patched count, and streams that are only recorded):
    overlapped by default, one router clone pinned to each card, one
    stream each; a later fused set on the reused template router puts it
    back on its home device."""
    made = []

    class Stream:
        def __init__(self, device):
            made.append(device)

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    _, router, _, _ = make_pool(PORT, device="cuda")    # built, never routed here
    rset = PORT.ReplicaSet(router, replicas=4, max_batch=16, max_wait_s=0.0)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert rset.placement == "overlapped"
    assert rset.device_count == 4
    assert [w.router.device for w in rset.workers] == cards
    assert [w.device for w in rset.workers] == cards
    assert made == cards
    assert len({id(w.stream) for w in rset.workers}) == 4
    assert len({id(w.router) for w in rset.workers}) == 4
    assert all(w.router.plans is router.plans and w.router.selector is router.selector
               for w in rset.workers)
    rf = PORT.ReplicaSet(router, replicas=4, max_batch=16, max_wait_s=0.0, placement="fused")
    assert all(w.router.device == torch.device("cuda") for w in rf.workers)
    assert all(w.stream is None for w in rf.workers)


def test_single_device_defaults_and_overlapped_fallback():
    """One device: fused is the default at R>1; an explicit overlapped
    placement keeps every worker on the router's device with no stream
    (the CPU launches one after another) and bit-matches the baseline."""
    def scenario(pkg):
        engine_a, router_a, qemb, _ = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        budget = pool_budget(engine_a)
        B = qemb.shape[0]
        rset = pkg.ReplicaSet(router_a, replicas=4, max_batch=16, max_wait_s=0.0,
                              placement="overlapped")
        assert rset.device_count == 1
        if pkg is PORT:
            assert replica_devices(3, "cpu") == [None, None, None]
            assert all(w.router.device == torch.device("cpu") and w.stream is None
                       for w in rset.workers)
        else:
            assert all(w.router.device is None for w in rset.workers)
        blk = rset.submit_many(np.arange(B), qemb, budget)
        rset.drain()
        base = pkg.BatchScheduler(router_b, max_batch=B, max_wait_s=0.0)
        ref = base.submit_many(np.arange(B), qemb, budget)
        base.drain()
        np.testing.assert_array_equal(blk.predictions, ref.predictions)
        np.testing.assert_array_equal(blk.costs, ref.costs)
        r2 = pkg.ReplicaSet(router_a, replicas=4, max_batch=16, max_wait_s=0.0)
        assert r2.placement == "fused"
        return {"blocks": [blk], "replica_stats": rset.stats}
    both(scenario)


@pytest.mark.parametrize("R", [4, 1])
def test_overlapped_bitmatches_fused_and_baseline(R):
    def scenario(pkg):
        pools = [make_pool(pkg) for _ in range(3)]
        budget = pool_budget(pools[0][0])
        qemb = pools[0][2]
        B = qemb.shape[0]
        blocks, stats = {}, {}
        for placement, (_, router, _, _) in zip(("overlapped", "fused"), pools):
            rset = pkg.ReplicaSet(router, replicas=R, max_batch=16, max_wait_s=0.0,
                                  placement=placement)
            blocks[placement] = rset.submit_many(np.arange(B), qemb, budget)
            rset.drain()
            stats[placement] = rset.stats
        base = pkg.BatchScheduler(pools[2][1], max_batch=B if R > 1 else 16, max_wait_s=0.0)
        ref = base.submit_many(np.arange(B), qemb, budget)
        base.drain()
        for blk in blocks.values():
            for f in ("predictions", "costs", "stop_waves"):
                np.testing.assert_array_equal(getattr(blk, f), getattr(ref, f))
        st = stats["overlapped"]
        assert st["replica_overlapped"] >= 1 and st["replica_overlapped_rows"] == B
        assert st["replica_fused"] == 0
        if R > 1:
            assert stats["fused"]["replica_fused"] >= 1
        return {"blocks": list(blocks.values()), "overlapped_stats": st,
                "fused_stats": stats["fused"]}
    both(scenario)


def _run_with_faults(pkg, placement, seed):
    engine, router, qemb, _ = make_pool(pkg)
    budget = pool_budget(engine)
    policy = pkg.FaultPolicy(len(engine.arms), 4, seed=seed)
    policy.set_arm(int(np.argmin(engine.costs)), timeout=0.4, error=0.3)
    engine.fault_policy = policy
    rset = pkg.ReplicaSet(router, replicas=3, max_batch=16, max_wait_s=0.0,
                          placement=placement)
    blk = rset.submit_many(np.arange(qemb.shape[0]), qemb, budget)
    rset.drain()
    return blk, rset.stats


@pytest.mark.parametrize("seed", [7, 13])
def test_fault_grid_overlapped_bitmatches_fused(seed):
    """Same FaultPolicy seed, same admission wave: the overlapped R=3
    stream draws the fused one's fault grid (per-launch row offsets
    reproduce the concatenation positions), so every output bit-matches."""
    def scenario(pkg):
        blk_o, st_o = _run_with_faults(pkg, "overlapped", seed)
        blk_f, st_f = _run_with_faults(pkg, "fused", seed)
        for f in ("predictions", "costs", "stop_waves", "modes"):
            np.testing.assert_array_equal(getattr(blk_o, f), getattr(blk_f, f))
        assert st_o.get("degradation_failures") == st_f.get("degradation_failures")
        return {"blocks": [blk_o, blk_f], "overlapped_stats": st_o}
    both(scenario)


def test_overlapped_launches_each_worker_on_its_stream(monkeypatch):
    """Each overlapped launch runs under its worker's stream context, in
    the fused concatenation order, with the worker's row offset."""
    engine, router, qemb, _ = make_pool(PORT)
    rset = PORT.ReplicaSet(router, replicas=3, max_batch=16, max_wait_s=0.0,
                           placement="overlapped")
    entered, offsets = [], []

    class Ctx:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            entered.append(self.stream)

        def __exit__(self, *exc):
            return False

    for w in rset.workers:
        w.stream = f"stream-{w.index}"
        begin = w.router.begin_route

        def spy(*args, _begin=begin, **kw):
            offsets.append(kw["fault_row_offset"])
            return _begin(*args, **kw)
        w.router.begin_route = spy
    monkeypatch.setattr(t_replica.torch.cuda, "stream", Ctx)
    blk = rset.submit_many(np.arange(qemb.shape[0]), qemb, pool_budget(engine))
    rset.drain()
    assert blk.done()
    assert len(entered) == rset.stats["replica_overlapped"] > 0
    assert set(entered) == {"stream-0", "stream-1", "stream-2"}
    assert 0 in offsets and max(offsets) > 0
