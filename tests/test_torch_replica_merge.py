"""The port's shard-merged feedback contract against the JAX package's:
``tests/test_replica_merge.py``'s properties on both packages from the
same drawn examples.

``merge_counts`` is a commutative monoid on feedback shards, bit for bit
(associative, commutative, the empty shard its identity, inputs never
mutated), and ANY partition of a label stream across R shard logs,
merged and folded through ONE central apply, leaves the estimator in
exactly the single-log state — the property that lets ``ReplicaSet`` fold
feedback locally and reconcile centrally. Each example asserts those
properties on the port and that the port's merged shards, fold reports
and estimator states equal the reference's bitwise.

Runs on the real ``hypothesis`` engine when installed, else on the
in-repo ``_hypolite`` fallback.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 container: see requirements-test.txt
    from _hypolite import given, settings, strategies as st

from _torch_serving import PACKAGES, estimator_state

L = 6            # arms
K = 4            # classes
CLUSTERS = 4
T = 3            # waves per observed request


def _estimator(pkg):
    """A fresh estimator twin (deterministic construction)."""
    wl = pkg.OracleWorkload(num_classes=K, num_clusters=CLUSTERS, num_arms=L, seed=9)
    tbl, emb, _ = wl.response_table(40 * CLUSTERS, seed=10)
    assign, _ = pkg.kmeans(emb, CLUSTERS, seed=0)
    return pkg.SuccessProbEstimator(tbl, emb, assign)


def _shard(pkg, spec):
    """One shard from a drawn spec: (cid, nq, seed) entries of
    integer-valued success/attempt buffers with succ <= att."""
    counts = {}
    labels = 0
    for cid, nq, seed in spec:
        rng = np.random.default_rng(seed)
        att = rng.integers(0, 8, L).astype(np.float64)
        succ = np.floor(att * rng.random(L))
        buf = counts.get(cid)
        if buf is None:
            counts[cid] = [succ, att, int(nq)]
        else:
            buf[0] += succ
            buf[1] += att
            buf[2] += int(nq)
        labels += int(nq)
    return pkg.FeedbackShard(counts, labels)


def _shard_state(s):
    """A shard's contents as plain values, for equality."""
    return (s.labels, {cid: (succ.tobytes(), att.tobytes(), int(n))
                       for cid, (succ, att, n) in sorted(s.counts.items())})


def _observations(n, seed):
    """A synthetic retired-group stream: cluster ids, (n, T) schedules,
    responses and invoked masks, and labels (numpy, package-free)."""
    rng = np.random.default_rng(seed)
    order = _estimator(PACKAGES[1]).cluster_order
    cids = order[rng.integers(0, len(order), n)]
    schedule = rng.integers(0, L, (n, T))
    invoked = rng.random((n, T)) < 0.7
    invoked[:, 0] = True
    responses = np.where(invoked, rng.integers(0, K, (n, T)), -1)
    labels = rng.integers(0, K, n)
    return cids.astype(np.int64), schedule, responses, invoked, labels


_ENTRY = st.tuples(
    st.integers(min_value=0, max_value=CLUSTERS - 1),
    st.integers(min_value=0, max_value=5),
    st.integers(min_value=0, max_value=10_000),
)
_SPEC = st.lists(_ENTRY, min_size=0, max_size=6)


def _on_both(fn):
    """``fn(pkg)`` on both packages; the port's value equals the reference's."""
    want, got = (fn(pkg) for pkg in PACKAGES)
    assert got == want
    return got


@settings(max_examples=30, deadline=None)
@given(_SPEC, _SPEC, _SPEC)
def test_merge_counts_associative(sa, sb, sc):
    def run(pkg):
        a, b, c = (_shard(pkg, s) for s in (sa, sb, sc))
        left = _shard_state(pkg.merge_counts(pkg.merge_counts(a, b), c))
        assert left == _shard_state(pkg.merge_counts(a, pkg.merge_counts(b, c)))
        assert left == _shard_state(pkg.merge_counts(a, b, c))
        return left
    _on_both(run)


@settings(max_examples=30, deadline=None)
@given(_SPEC, _SPEC)
def test_merge_counts_commutative(sa, sb):
    def run(pkg):
        a, b = _shard(pkg, sa), _shard(pkg, sb)
        ab = _shard_state(pkg.merge_counts(a, b))
        assert ab == _shard_state(pkg.merge_counts(b, a))
        return ab
    _on_both(run)


@settings(max_examples=20, deadline=None)
@given(_SPEC)
def test_merge_counts_identity_and_purity(spec):
    """The empty shard is the identity, and merging never aliases or
    mutates its inputs."""
    def run(pkg):
        a = _shard(pkg, spec)
        before = _shard_state(a.copy())
        merged = pkg.merge_counts(a, pkg.FeedbackShard({}, 0))
        out = _shard_state(merged)
        assert out == _shard_state(a)
        for cid in merged.counts:
            merged.counts[cid][0] += 1.0
            merged.counts[cid][1] += 1.0
        assert _shard_state(a) == before
        return out
    _on_both(run)


@settings(max_examples=15, deadline=None)
@given(
    st.integers(min_value=1, max_value=24),
    st.integers(min_value=1, max_value=4),
    st.integers(min_value=0, max_value=10_000),
    st.integers(min_value=0, max_value=10_000),
)
def test_partition_invariance_vs_single_log(n, R, stream_seed, part_seed):
    """Scatter one observation stream across R shard logs by an arbitrary
    row partition, merge the exported shards, fold ONCE through a central
    log: the estimator state and the fold report match the single-log
    baseline exactly."""
    cids, schedule, responses, invoked, labels = _observations(n, stream_seed)
    ids = np.arange(n, dtype=np.int64)
    assign = np.random.default_rng(part_seed).integers(0, R, n)

    def run(pkg):
        est_one = _estimator(pkg)
        log_one = pkg.FeedbackLog(est_one)
        log_one.observe(ids, cids, schedule, responses, invoked)
        assert log_one.record_many(ids, labels) == n
        rep_one = log_one.apply()

        est_r = _estimator(pkg)
        central = pkg.FeedbackLog(est_r)
        shards = []
        for r in range(R):
            rows = np.flatnonzero(assign == r)
            shard_log = pkg.FeedbackLog(est_r)
            if rows.size:
                shard_log.observe(ids[rows], cids[rows], schedule[rows], responses[rows],
                                  invoked[rows])
                assert shard_log.record_many(ids[rows], labels[rows]) == rows.size
            if shard_log.has_pending:
                shards.append(shard_log.export_shard())
        merged = pkg.merge_counts(*shards)
        central.absorb_shard(merged)
        rep_r = central.apply()
        report = (rep_r.labels, sorted(rep_r.clusters), sorted(rep_r.drifted))
        assert report == (rep_one.labels, sorted(rep_one.clusters), sorted(rep_one.drifted))
        assert rep_r.labels == n
        state = estimator_state(est_r)
        assert state == estimator_state(est_one)
        return report, state, _shard_state(merged)
    _on_both(run)


@settings(max_examples=10, deadline=None)
@given(
    st.integers(min_value=2, max_value=16),
    st.integers(min_value=0, max_value=10_000),
)
def test_shard_fold_order_free(n, seed):
    """Merging the SAME shards in any order folds to the same state."""
    cids, schedule, responses, invoked, labels = _observations(n, seed)
    ids = np.arange(n, dtype=np.int64)
    halves = [np.arange(0, n, 2), np.arange(1, n, 2)]

    def run(pkg):
        states = []
        for order in ((0, 1), (1, 0)):
            est = _estimator(pkg)
            central = pkg.FeedbackLog(est)
            shards = []
            for rows in halves:
                lg = pkg.FeedbackLog(est)
                lg.observe(ids[rows], cids[rows], schedule[rows], responses[rows], invoked[rows])
                lg.record_many(ids[rows], labels[rows])
                shards.append(lg.export_shard())
            central.absorb_shard(pkg.merge_counts(shards[order[0]], shards[order[1]]))
            central.apply()
            states.append(estimator_state(est))
        assert states[0] == states[1]
        return states[0]
    _on_both(run)
