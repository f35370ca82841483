"""The port's program spans (``repro_torch.trace``): the ring's records, the
budget group they share, the profiler mirror (entered only while the
profiler records, and then on the kineto timeline), the name rule, and the
router's counts of the cells past the stop against the arm calls made."""
import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data.synth import OracleWorkload
from repro_torch.models import LM
from repro_torch.models.config import ModelConfig
from repro_torch.serving import BatchScheduler, LMArm, PoolEngine, ReplicaSet, ThriftRouter

REPO = Path(__file__).resolve().parents[1]


K = 4


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class CountingArm:
    """A deterministic arm that answers query j with ``resp[j]`` and logs the
    rows it is handed, as the benchmark's arm tap does."""

    def __init__(self, name, cost, resp, handed):
        self.name, self.cost, self.resp, self.handed = name, cost, resp, handed

    def classify_batch(self, queries):
        q = np.asarray(queries, np.int64)
        self.handed.append(q.shape[0])
        return self.resp[q]

    def latency_s(self, batch):
        return 1e-6 * batch


def tabular(B=96, L=6, clusters=4, seed=3, **router_kw):
    """``(router, queries, embeddings, budget, handed)``: a pool of counting
    arms over an oracle workload's answers."""
    wl = OracleWorkload(num_classes=K, num_clusters=clusters, num_arms=L, seed=seed)
    table, emb, cid = wl.response_table(60 * clusters, seed=seed + 1)
    est = SuccessProbEstimator(table, emb, cid)
    rng = np.random.default_rng(seed + 2)
    qcid, qemb, qlab = wl.sample_queries(B, rng)
    handed = []
    arms = [CountingArm(f"t{a}", float(wl.costs[a]),
                        wl.invoke_batch(a, qcid, qlab, np.random.default_rng(seed + 100 + a)),
                        handed) for a in range(L)]
    router = ThriftRouter(PoolEngine(arms), est, K, device="cpu", **router_kw)
    budget = float(np.quantile(wl.costs, 0.8) * 3.0)
    return router, np.arange(B), qemb, budget, handed


def tiny_lm(name, **kw):
    cfg = dict(name=name, family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
               d_ff=64, vocab_size=64, dtype="float32", remat=False)
    cfg.update(kw)
    return LM(ModelConfig(**cfg), device="cpu", seed=1)


def lm_pool():
    """A router over two tiny model arms, one of them MoE; its queries."""
    arms = [LMArm("tiny-dense", tiny_lm("tiny-dense"), np.arange(K), tokens_per_query=12),
            LMArm("tiny-moe", tiny_lm("tiny-moe", family="moe", num_experts=4,
                                      experts_per_token=2, block_pattern=("moe",)),
                  np.arange(K), tokens_per_query=12)]
    wl = OracleWorkload(num_classes=K, num_clusters=3, num_arms=2, seed=5)
    table, emb, cid = wl.response_table(90, seed=6)
    est = SuccessProbEstimator(table, emb, cid)
    router = ThriftRouter(PoolEngine(arms), est, K, device="cpu")
    rng = np.random.default_rng(7)
    _, qemb, _ = wl.sample_queries(24, rng)
    tokens = rng.integers(K, 64, size=(24, 13))
    return router, tokens, qemb, float(sum(a.cost for a in arms))


def drained(router, queries, emb, budget, max_batch=32, **kw):
    trace.reset()
    sched = BatchScheduler(router, max_batch=max_batch, **kw)
    blk = sched.submit_many(queries, emb, budget)
    sched.drain()
    assert blk.done()
    return sched, trace.spans()


def by_name(recs, name):
    return [r for r in recs if r[1] == name]


def test_record_fields_and_nesting():
    trace.reset()
    group = trace.new_group()
    with trace.span("router.outer", rows=3) as counts:
        with trace.span("router.inner"):
            pass
        counts["more"] = 1
    (s_in, n_in, g_in, p_in, a_in, b_in, c_in), (s_out, n_out, g_out, p_out, a_out, b_out,
                                                c_out) = trace.spans()
    assert (n_in, n_out) == ("router.inner", "router.outer")
    assert s_out < s_in and p_in == s_out and p_out == -1
    assert g_in == g_out == group
    assert a_out <= a_in <= b_in <= b_out
    assert c_out == {"rows": 3, "more": 1} and c_in == {}


def test_a_span_closes_on_an_exception():
    trace.reset()
    with pytest.raises(ValueError):
        with trace.span("router.outer"):
            with trace.span("router.inner"):
                raise ValueError
    with trace.span("router.after"):
        pass
    assert [r[1] for r in trace.spans()] == ["router.inner", "router.outer", "router.after"]
    assert trace.spans()[-1][3] == -1


@pytest.mark.parametrize("speculation", ["jit", "reference"])
def test_one_groups_spans_share_its_number(speculation):
    router, queries, emb, budget, _ = tabular()
    sched, recs = drained(router, queries, emb, budget, speculation=speculation)
    retired = by_name(recs, "scheduler.retire")
    groups = [r[2] for r in retired]
    assert len(set(groups)) == len(groups) == sched.stats["batches"] == 3
    plane = {"router.plan", "router.finalize", "scheduler.retire", "scheduler.dispatch"}
    if speculation == "jit":
        plane |= {"router.gather", "router.wave"}
    seq = {r[0]: r for r in recs}
    for g in groups:
        mine = [r for r in recs if r[2] == g]
        assert {r[1] for r in mine} == plane
        for r in mine:
            parent = seq.get(r[3])
            if r[1] in ("router.plan", "router.gather", "router.wave"):
                assert parent[1] == "scheduler.dispatch"
            elif r[1] == "router.finalize":
                assert parent[1] == "scheduler.retire" and parent[2] == g
    assert sum(r[6]["rows"] for r in by_name(recs, "scheduler.dispatch")) == queries.size
    assert all(r[6]["wait_s"] >= 0 for r in by_name(recs, "scheduler.dispatch"))
    assert sum(r[6]["rows"] for r in retired) == queries.size


@pytest.mark.parametrize("placement", ["fused", "overlapped"])
def test_a_replica_dispatch_numbers_its_groups(placement):
    """A fused dispatch is one route: its spans and the retire of every
    worker that adopted a slice of it carry one number. Overlapped
    dispatches number each worker's route apart."""
    router, queries, emb, budget, _ = tabular(B=64)
    trace.reset()
    rset = ReplicaSet(router, replicas=2, max_batch=16, max_wait_s=0.0, placement=placement)
    blk = rset.submit_many(queries, emb, budget)
    rset.drain()
    assert blk.done()
    recs = trace.spans()
    plans, retires = by_name(recs, "router.plan"), by_name(recs, "scheduler.retire")
    assert len({r[2] for r in plans}) == len(plans)
    assert {r[2] for r in retires} == {r[2] for r in plans}
    adopted = [sum(r[2] == p[2] for r in retires) for p in plans]
    assert max(adopted) == (2 if placement == "fused" else 1) and min(adopted) == 1
    assert all(r[2] in {p[2] for p in plans} for r in by_name(recs, "router.finalize"))


@pytest.mark.parametrize("quantile", [0.3, 0.6, 0.9])
@pytest.mark.parametrize("mode", ["jit", "reference"])
def test_cells_past_stop_match_the_arm_calls(quantile, mode):
    """cells_invoked - cells_used of a route equals the rows its arms were
    handed less the sum of its stop waves."""
    router, queries, emb, _, handed = tabular(B=64)
    budget = float(np.quantile(router.engine.costs, quantile) * 3.0)
    trace.reset()
    res = router.begin_route(queries, emb, budget, mode=mode).result()
    (fin,) = by_name(trace.spans(), "router.finalize")
    counts = fin[6]
    assert counts["cells_invoked"] == sum(handed)
    assert counts["cells_used"] == int(res.stop_waves.sum())
    past = counts["cells_invoked"] - counts["cells_used"]
    assert past == sum(handed) - int(res.stop_waves.sum())
    assert past >= 0 and (mode == "jit" or past == 0)


def test_profiler_off_never_enters_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(trace, "_range", refuse)
    router, tokens, emb, budget = lm_pool()
    sched, recs = drained(router, tokens, emb, budget, max_batch=8)
    names = {r[1] for r in recs}
    assert {"arm.tiny-moe.launch", "arm.tiny-moe.wait", "router.gather"} <= names
    with trace.mark("arm.moe.route"):
        pass


def test_every_span_and_mark_is_on_the_kineto_timeline():
    from torch.profiler import ProfilerActivity, profile

    router, tokens, emb, budget = lm_pool()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sched = BatchScheduler(router, max_batch=8)
        sched.submit_many(tokens, emb, budget)
        sched.drain()
    seen = {e.name() for e in prof.profiler.kineto_results.events()}
    opened = {r[1] for r in trace.spans()}
    marks = {"arm.moe.route", "arm.moe.dispatch", "arm.moe.experts", "arm.moe.combine"}
    assert {"arm.tiny-moe.launch", "arm.tiny-moe.wait", "scheduler.dispatch",
            "router.finalize"} <= opened
    assert opened | marks <= seen, sorted((opened | marks) - seen)


NAMES = ("scheduler.dispatch", "scheduler.retire", "scheduler.prefetch", "router.plan",
         "router.gather", "router.wave", "router.finalize", "arm.moe.route", "arm.moe.dispatch",
         "arm.moe.experts", "arm.moe.combine", "arm.moe.shared", "arm.mla.project",
         "arm.mla.attend")


def _span_calls():
    """(file, first argument) of every ``trace.span``/``trace.mark`` call in
    the port."""
    out = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("span", "mark")
                    and isinstance(node.func.value, ast.Name) and node.func.value.id == "trace"):
                out.append((path.name, node.args[0]))
    return out


def test_every_span_name_starts_with_a_host_prefix():
    calls = _span_calls()
    literal = [a.value for _, a in calls if isinstance(a, ast.Constant)]
    built = sorted((f, ast.unparse(a)) for f, a in calls if not isinstance(a, ast.Constant))
    assert sorted(literal) == sorted(NAMES)
    assert all(n.startswith(trace.PREFIXES) for n in literal), literal
    assert built == [("engine.py", "self.launch_span"), ("engine.py", "self.wait_span")]
    arm = LMArm("any-arm", tiny_lm("any-arm"), np.arange(K))
    assert arm.launch_span.startswith(trace.PREFIXES) and arm.wait_span.startswith(trace.PREFIXES)


def test_the_ring_keeps_the_newest_records():
    trace.reset()
    for _ in range(trace.RING + 5):
        with trace.span("router.spin"):
            pass
    recs = trace.spans()
    assert len(recs) == trace.RING
    assert recs[-1][0] - recs[0][0] == trace.RING - 1


def test_chip_smoke_leaves_the_spans_device_rows_out(monkeypatch):
    """A span's profiler range shows on the device timeline as an annotation
    spanning its kernels; ``chip_smoke.device_events`` keeps kernel rows
    only, so the spans leave its device ms and launch counts as they were."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", smoke)
    spec.loader.exec_module(smoke)
    row = lambda key, dev=DeviceType.CUDA: SimpleNamespace(key=key, device_type=dev,
                                                           self_device_time_total=5.0)
    rows = [row("nvjet_tst_192x192"), row("arm.granite-moe-1b-a400m.launch"),
            row("arm.moe.route"), row("router.wave"), row("scheduler.dispatch"),
            row("aten::mm", DeviceType.CPU), row("flash_attention_kernel")]
    kept = smoke.device_events(SimpleNamespace(key_averages=lambda: rows))
    assert [e.key for e in kept] == ["nvjet_tst_192x192", "flash_attention_kernel"]
