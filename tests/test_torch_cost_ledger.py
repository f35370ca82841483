"""The port's per-tenant CostLedger against the JAX package's:
``tests/test_cost_ledger.py``'s properties on both packages from the same
seeds, the ReplicaSet ones included, plus a snapshot taken on one package
and restored on the other.

Each example asserts the reference's own invariants on the port — spend
conservation per request and per arm (faulted runs included), tenant
totals independent of submission order, hard budgets never exceeded, the
token-bucket rate limit on an injectable clock, snapshot/restore and the
restart reconciliation, one ledger shared by an R=3 ``ReplicaSet`` — and that the port's per-request results and
ledger state equal the reference's bitwise.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import json

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 container: see requirements-test.txt
    from _hypolite import given, settings, strategies as st

from _torch_serving import (
    PACKAGES,
    PORT,
    REF,
    assert_blocks_equal,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    tabular_pool,
)

# one deterministic pool per package shared by every example (the ledger
# under test is rebuilt per example; routing is read-only and cache-warm)
_POOLS = {}
for _pkg in PACKAGES:
    _, _engine, _router, _qemb, _ = tabular_pool(_pkg)
    _POOLS[_pkg.name] = (_engine, _router)
_QEMB = _qemb
_TIERS = np.quantile(_POOLS["ref"][0].costs, [0.35, 0.6, 0.85]) * 2.5
_TENANTS = np.asarray(["acme", "zen", "umbrella", "wayne"], object)


def _sched(pkg, ledger=True, **kw):
    return pkg.BatchScheduler(_POOLS[pkg.name][1], max_wait_s=0.0, ledger=ledger,
                              budget_tiers=_TIERS.tolist(), **kw)


def _ledger_state(led):
    """Every ledger field as plain values (the snapshot, exact)."""
    return json.dumps(led.snapshot(), sort_keys=True)


def _same(out):
    got, want = out["port"], out["ref"]
    for g, w in zip(got["blocks"], want["blocks"]):
        assert_blocks_equal(g, w)
    assert got["ledger"] == want["ledger"]
    if "stats" in got:
        assert got["stats"] == {k: want["stats"][k] for k in got["stats"]}


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10**6), st.integers(1, 96), st.booleans())
def test_spend_conservation_per_request_and_per_arm(seed, n, faulty):
    out = {}
    for pkg in PACKAGES:
        engine = _POOLS[pkg.name][0]
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, _QEMB.shape[0], size=n)
        budgets = rng.choice(_TIERS, size=n)
        tenants = rng.choice(_TENANTS, size=n)
        if faulty:
            engine.fault_policy = pkg.FaultPolicy(len(engine.arms), 4, seed=seed % 997).set_arms(
                [0, 2, 5], timeout=0.25, error=0.15)
        try:
            sched = _sched(pkg, max_batch=int(rng.integers(8, 64)))
            blk = sched.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
            sched.drain()
        finally:
            engine.fault_policy = None
        led = sched.ledger
        assert np.isclose(led.total_spent, float(blk.costs.sum()), rtol=1e-12, atol=1e-18)
        by_arm_total = np.zeros(len(engine.arms))
        for name, ent in led.tenants().items():
            sel = tenants == name
            assert np.isclose(ent["spent"], float(blk.costs[sel].sum()), rtol=1e-12, atol=1e-18)
            assert np.isclose(ent["by_arm"].sum(), ent["spent"], rtol=1e-12, atol=1e-18)
            assert ent["requests"] == int(sel.sum()) and ent["reserved"] == 0.0
            by_arm_total += ent["by_arm"]
        np.testing.assert_allclose(by_arm_total, sched.arm_query_totals * engine.costs,
                                   rtol=1e-12, atol=1e-18)
        assert led.total_reserved == 0.0
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(led),
                         "stats": dict(sched.stats)}
    _same(out)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10**6), st.integers(2, 48))
def test_tenant_totals_invariant_to_submission_interleaving(seed, n):
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, _QEMB.shape[0], size=n)
        budgets = rng.choice(_TIERS, size=n)
        tenants = rng.choice(_TENANTS[:3], size=n)
        perm = rng.permutation(n)
        totals, ledgers = [], []
        for order in (np.arange(n), perm):
            sched = _sched(pkg, max_batch=int(rng.integers(4, 32)))
            for i in order:
                sched.submit(pkg.Request(payload=int(rows[i]), embedding=_QEMB[rows[i]],
                                         budget=float(budgets[i]), tenant=str(tenants[i])))
            sched.drain()
            totals.append(sched.ledger.tenants())
            ledgers.append(_ledger_state(sched.ledger))
        a, b = totals
        assert set(a) == set(b)
        for name in a:
            assert np.isclose(a[name]["spent"], b[name]["spent"], rtol=1e-12, atol=1e-18)
            assert a[name]["requests"] == b[name]["requests"]
            np.testing.assert_allclose(a[name]["by_arm"], b[name]["by_arm"], rtol=1e-12,
                                       atol=1e-18)
        out[pkg.name] = {"blocks": [], "ledger": ledgers}
    _same(out)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10**6), st.integers(1, 64), st.floats(0.0, 12.0))
def test_hard_budget_never_exceeded(seed, n, headroom):
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, _QEMB.shape[0], size=n)
        budgets = rng.choice(_TIERS, size=n)
        tenants = rng.choice(_TENANTS, size=n)
        ledger = pkg.CostLedger(num_arms=len(_POOLS[pkg.name][0].arms))
        for i, name in enumerate(_TENANTS[:-1]):          # the last one unlimited
            ledger.set_limit(str(name), float(_TIERS[0]) * headroom * (i + 0.3))
        sched = _sched(pkg, ledger=ledger, max_batch=int(rng.integers(8, 48)))
        blk = sched.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        sched.drain()
        assert blk.done()
        rejected = blk.modes == "rejected"
        assert (blk.costs[rejected] == 0.0).all() and (blk.predictions[rejected] == -1).all()
        assert (blk.budgets <= budgets + 1e-15).all()
        for name, ent in ledger.tenants().items():
            assert ent["spent"] <= ent["limit"] + 1e-12, (name, ent)
            assert ent["reserved"] == 0.0
            sel = tenants == name
            assert ent["requests"] + ent["rejected"] == int(sel.sum())
            assert np.isclose(ent["spent"], float(blk.costs[sel].sum()), rtol=1e-12, atol=1e-18)
        st_ = sched.stats
        assert st_["completed"] == n and st_["ledger_rejected"] == int(rejected.sum())
        assert st_["ledger_downgraded"] == int(((blk.budgets < budgets) & ~rejected).sum())
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(ledger), "stats": dict(st_)}
    _same(out)


def test_ledger_disabled_is_zero_overhead_and_bit_identical():
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(5)
        rows = rng.integers(0, _QEMB.shape[0], size=64)
        budgets = rng.choice(_TIERS, size=64)
        s_off, s_on = _sched(pkg, ledger=None, max_batch=32), _sched(pkg, ledger=True,
                                                                     max_batch=32)
        b_off = s_off.submit_many(rows, _QEMB[rows], budgets)
        b_on = s_on.submit_many(rows, _QEMB[rows], budgets, tenant=rng.choice(_TENANTS, size=64))
        s_off.drain()
        s_on.drain()
        np.testing.assert_array_equal(b_off.predictions, b_on.predictions)
        np.testing.assert_allclose(b_off.costs, b_on.costs, rtol=0, atol=0)
        np.testing.assert_array_equal(b_off.stop_waves, b_on.stop_waves)
        assert "ledger_spent" not in s_off.stats and s_on.stats["ledger_rejected"] == 0
        out[pkg.name] = {"blocks": [b_off, b_on], "ledger": _ledger_state(s_on.ledger)}
    _same(out)


class _FakeClock:
    """Deterministic clock for the token bucket."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def advance(self, dt):
        self.t += float(dt)

    def __call__(self):
        return self.t


def test_rate_limit_rejects_like_budget_rejection():
    out = {}
    for pkg in PACKAGES:
        clock = _FakeClock()
        ledger = pkg.CostLedger(num_arms=8, clock=clock)
        ledger.set_rate_limit("acme", qps=1.0, burst=2.0)
        sched = _sched(pkg, ledger=ledger, max_batch=16)
        rows = np.arange(8)
        blk = sched.submit_many(rows, _QEMB[rows], float(_TIERS[-1]), tenant="acme")
        sched.drain()
        rej = blk.modes == "rejected"
        assert int((~rej).sum()) == 2
        assert (blk.predictions[rej] == -1).all() and (blk.costs[rej] == 0.0).all()
        assert (blk.stop_waves[rej] == 0).all()
        st_ = sched.stats
        assert st_["completed"] == 8 and st_["ledger_rate_limited"] == 6
        assert st_["ledger_rejected"] == 0 and ledger.tenant("acme")["rate_limited"] == 6
        clock.advance(3.0)
        blk2 = sched.submit_many(rows[:4], _QEMB[rows[:4]], float(_TIERS[-1]), tenant="acme")
        sched.drain()
        assert int((blk2.modes != "rejected").sum()) == 2
        assert ledger.tenant("acme")["rate_limited"] == 8
        out[pkg.name] = {"blocks": [blk, blk2], "ledger": _ledger_state(ledger),
                         "stats": dict(sched.stats)}
    _same(out)


@settings(max_examples=10, deadline=None)
@given(st.floats(0.5, 8.0), st.integers(1, 6), st.integers(1, 30), st.floats(0.0, 1.0))
def test_rate_limit_bucket_conservation(qps, burst, n, gap):
    seen = {}
    for pkg in PACKAGES:
        clock = _FakeClock()
        ledger = pkg.CostLedger(clock=clock)
        ledger.set_rate_limit("acme", qps=qps, burst=float(burst))
        admitted, trace = 0, []
        for _ in range(n):
            ok = ledger.allow_request("acme")
            admitted += ok
            trace.append(ok)
            assert admitted <= burst + qps * clock.t + 1e-9
            clock.advance(gap)
        assert all(ledger.allow_request("zen") for _ in range(10))
        assert ledger.tenant("zen")["rate_limited"] == 0
        seen[pkg.name] = (trace, ledger.tenant("acme")["tokens"])
    assert seen["port"] == seen["ref"]


def test_snapshot_restore_json_roundtrip_mid_workload():
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(17)
        rows = rng.integers(0, _QEMB.shape[0], size=48)
        budgets = rng.choice(_TIERS, size=48)
        limit = float(_TIERS[-1]) * 40
        ledger = pkg.CostLedger(num_arms=8)
        ledger.set_limit("acme", limit)
        ledger.set_rate_limit("acme", qps=10_000.0)
        sched = _sched(pkg, ledger=ledger, max_batch=16)
        sched.submit_many(rows, _QEMB[rows], budgets, tenant="acme")
        sched._dispatch_batch()
        ent = ledger.tenant("acme")
        assert ent["reserved"] > 0.0 and ent["spent"] + ent["reserved"] <= limit + 1e-12
        mid = _ledger_state(ledger)
        payload = json.loads(json.dumps(ledger.snapshot(), allow_nan=False))
        led2 = pkg.CostLedger.restore(payload)
        e2 = led2.tenant("acme")
        for k in ("limit", "reserved", "reserved_n", "spent", "requests", "rejected",
                  "downgraded", "rate_limited", "rate_limit"):
            assert e2[k] == ent[k], k
        np.testing.assert_array_equal(e2["by_arm"], ent["by_arm"])
        assert led2.default_limit == ledger.default_limit
        sched2 = _sched(pkg, ledger=led2, max_batch=16)
        blk = sched2.submit_many(rows, _QEMB[rows], budgets, tenant="acme")
        sched2.drain()
        assert blk.done()
        e3 = led2.tenant("acme")
        assert e3["spent"] + e3["reserved"] <= limit + 1e-12
        assert e3["reserved"] >= ent["reserved"] - 1e-12
        json.dumps(pkg.CostLedger(num_arms=2).snapshot(), allow_nan=False)
        out[pkg.name] = {"blocks": [blk], "ledger": (mid, _ledger_state(led2))}
    _same(out)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10**6), st.integers(8, 48))
def test_restore_release_orphans_settle_invariant(seed, n):
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(seed)
        rows = rng.integers(0, _QEMB.shape[0], size=n)
        budgets = rng.choice(_TIERS, size=n)
        tenants = rng.choice(_TENANTS, size=n)
        limit = float(_TIERS[-1]) * n
        ledger = pkg.CostLedger(num_arms=8)
        for t in _TENANTS:
            ledger.set_limit(str(t), limit)
        sched = _sched(pkg, ledger=ledger, max_batch=8)
        sched.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        sched._dispatch_batch()
        orphaned = 0
        for ent in ledger.tenants().values():
            assert ent["spent"] + ent["reserved"] <= limit + 1e-12
            assert len(ent["resv"]) == ent["reserved_n"]
            assert np.isclose(sum(ent["resv"].values()), ent["reserved"], rtol=1e-12,
                              atol=1e-18)
            orphaned += ent["reserved_n"]
        led2 = pkg.CostLedger.restore(json.loads(json.dumps(ledger.snapshot(), allow_nan=False)))
        sched2 = _sched(pkg, ledger=led2, max_batch=8)
        assert sched2.reconcile_ledger() == orphaned
        for ent in led2.tenants().values():
            assert ent["reserved"] == 0.0 and ent["reserved_n"] == 0 and not ent["resv"]
        blk = sched2.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        sched2.drain()
        assert blk.done()
        for ent in led2.tenants().values():
            assert ent["spent"] + ent["reserved"] <= limit + 1e-12
            assert ent["reserved"] == 0.0 and not ent["resv"]
        assert sched2.reconcile_ledger() == 0
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(led2)}
    _same(out)


def test_reconcile_keeps_live_reservations():
    out = {}
    for pkg in PACKAGES:
        rng = np.random.default_rng(29)
        rows = rng.integers(0, _QEMB.shape[0], size=40)
        budgets = rng.choice(_TIERS, size=40)
        ledger = pkg.CostLedger(num_arms=8)
        ledger.set_limit("acme", float(_TIERS[-1]) * 40)
        sched = _sched(pkg, ledger=ledger, max_batch=8)
        blk = sched.submit_many(rows, _QEMB[rows], budgets, tenant="acme")
        sched._dispatch_batch()
        held = ledger.tenant("acme")["reserved"]
        assert held > 0.0 and sched.reconcile_ledger() == 0
        assert ledger.tenant("acme")["reserved"] == held
        sched.drain()
        assert ledger.tenant("acme")["reserved"] == 0.0
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(ledger)}
    _same(out)


@pytest.mark.parametrize("src,dst", [(REF, PORT), (PORT, REF)], ids=["ref-to-port", "port-to-ref"])
def test_snapshot_crosses_packages(src, dst):
    """A snapshot taken mid-stream on one package restores on the other:
    the JSON payloads are equal, the restored ledger's snapshot is the
    original's, and both sides finish the stream to the same state."""
    rng = np.random.default_rng(41)
    rows = rng.integers(0, _QEMB.shape[0], size=40)
    budgets = rng.choice(_TIERS, size=40)
    tenants = rng.choice(_TENANTS, size=40)
    states = {}
    clock = _FakeClock()                 # the rate limit reads no wall clock
    for pkg in (src, dst):
        ledger = pkg.CostLedger(num_arms=8, clock=clock)
        ledger.set_limit("acme", float(_TIERS[-1]) * 12)
        ledger.set_rate_limit("zen", qps=50.0, burst=3.0)
        sched = _sched(pkg, ledger=ledger, max_batch=8)
        sched.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        sched._dispatch_batch()
        states[pkg.name] = json.dumps(ledger.snapshot(), sort_keys=True)
    assert states[src.name] == states[dst.name]
    restored = dst.CostLedger.restore(json.loads(states[src.name]), clock=clock)
    assert json.dumps(restored.snapshot(), sort_keys=True) == states[src.name]
    finished = {}
    for pkg, led in ((dst, restored),
                     (src, src.CostLedger.restore(json.loads(states[src.name]), clock=clock))):
        sched = _sched(pkg, ledger=led, max_batch=8)
        assert sched.reconcile_ledger() > 0
        blk = sched.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        sched.drain()
        finished[pkg.name] = (blk, _ledger_state(led))
    assert_blocks_equal(finished[dst.name][0], finished[src.name][0])
    assert finished[dst.name][1] == finished[src.name][1]


def test_replica_set_settles_shared_ledger():
    """One CostLedger shared across an R=3 ReplicaSet: per-tenant spend
    equals the block's realized charges, every replica's reservations are
    released, and per-arm attribution still sums to spend."""
    out = {}
    for pkg in PACKAGES:
        engine, router = _POOLS[pkg.name]
        rng = np.random.default_rng(23)
        n = 72
        rows = rng.integers(0, _QEMB.shape[0], size=n)
        budgets = rng.choice(_TIERS, size=n)
        tenants = rng.choice(_TENANTS, size=n)
        ledger = pkg.CostLedger(num_arms=len(engine.arms))
        rset = pkg.ReplicaSet(router, replicas=3, max_batch=16, max_wait_s=0.0,
                              ledger=ledger, budget_tiers=_TIERS.tolist())
        blk = rset.submit_many(rows, _QEMB[rows], budgets, tenant=tenants)
        rset.drain()
        assert blk.done()
        assert np.isclose(ledger.total_spent, float(blk.costs.sum()), rtol=1e-12, atol=1e-18)
        assert ledger.total_reserved == 0.0
        for name, ent in ledger.tenants().items():
            sel = tenants == name
            assert ent["requests"] == int(sel.sum())
            assert np.isclose(ent["spent"], float(blk.costs[sel].sum()), rtol=1e-12, atol=1e-18)
            assert np.isclose(ent["by_arm"].sum(), ent["spent"], rtol=1e-12, atol=1e-18)
        assert rset.stats["ledger_rejected"] == 0
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(ledger),
                         "stats": rset.stats}
    _same(out)
    assert out["port"]["stats"].keys() == out["ref"]["stats"].keys()


def test_replica_set_reconcile_releases_restored_orphans():
    """The set-wide reconcile: a ReplicaSet restarted onto a restored
    ledger releases the dead process's reservations in one pass and then
    serves the stream inside the reclaimed headroom."""
    out = {}
    for pkg in PACKAGES:
        engine, router = _POOLS[pkg.name]
        rng = np.random.default_rng(31)
        rows = rng.integers(0, _QEMB.shape[0], size=48)
        budgets = rng.choice(_TIERS, size=48)
        limit = float(_TIERS[-1]) * 48
        ledger = pkg.CostLedger(num_arms=len(engine.arms))
        ledger.set_limit("acme", limit)
        sched = _sched(pkg, ledger=ledger, max_batch=16)
        sched.submit_many(rows, _QEMB[rows], budgets, tenant="acme")
        sched._dispatch_batch()
        assert ledger.tenant("acme")["reserved"] > 0.0
        led2 = pkg.CostLedger.restore(json.loads(json.dumps(ledger.snapshot())))
        rset = pkg.ReplicaSet(router, replicas=3, max_batch=16, max_wait_s=0.0,
                              ledger=led2, budget_tiers=_TIERS.tolist())
        released = rset.reconcile_ledger()
        assert released > 0
        assert led2.tenant("acme")["reserved"] == 0.0
        blk = rset.submit_many(rows, _QEMB[rows], budgets, tenant="acme")
        rset.drain()
        assert blk.done()
        ent = led2.tenant("acme")
        assert ent["spent"] + ent["reserved"] <= limit + 1e-12
        assert ent["reserved"] == 0.0
        out[pkg.name] = {"blocks": [blk], "ledger": _ledger_state(led2),
                         "released": released}
    _same(out)
    assert out["port"]["released"] == out["ref"]["released"]
