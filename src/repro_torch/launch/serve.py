"""Serving launcher: stand up an oracle pool, calibrate success
probabilities, and serve a stream of classification queries through the
continuous-batching front-end under a per-query budget.

The PyTorch port's copy of ``repro/launch/serve.py``: the same flags,
defaults and printed lines, with the router's wave loop and planner on
``--device`` (default ``cuda``; a missing card is an error, never a
fallback to the CPU). The reference's ``--devices`` (it forces XLA host
devices so the replica plane can overlap per-device programs) and
``--compile-cache-dir`` (it persists XLA executables) have no counterpart:
torch needs no forced host devices — on one card the overlapped placement
gives each replica a CUDA stream of its own — and the port runs eagerly,
with nothing to compile ahead.

Requests arrive as a Poisson process at ``--qps`` (0 = as fast as
possible), are admitted by the scheduler's arrival/SLO-aware flush policy,
ride the pipelined budget-group waves, and complete through per-request
futures; the run reports throughput, p50/p99 latency, accuracy, realized
cost and which data plane (speculative device waves vs the compacting host
plane) served the traffic.

With ``--drift-after N`` the demo exercises the online loop end to end:
after N served queries the truth drifts (the served plans' arms degrade for
half the clusters), ground-truth labels stream back per completed block,
and the drift-invalidated clusters replan as ONE batched-planner dispatch
at the next admission boundary. ``--probe-rate r`` additionally probes one
currently-unplanned arm on ~r of feedback-eligible requests.

``--fault-rate r`` attaches a FaultPolicy to the pool: the listed
``--fault-arms`` (default: every arm) time out / error / degrade at the
given per-cell rates, failed wave slots re-route in-wave to the plan's
next-best affordable arm, and the failure evidence folds into the
estimator (combine with ``--drift-after`` or ``--probe-rate`` to enable
the feedback loop).

    PYTHONPATH=src python -m repro_torch.launch.serve --queries 500 --budget 1e-4
    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 4 \\
        --fault-rate 0.1 --drift-after 250 --probe-rate 0.02
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --qps 5000 --slo-ms 50
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.clustering import kmeans
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data import OracleWorkload
from repro_torch.distributed.fault import FaultPolicy
from repro_torch.serving import (
    BatchScheduler,
    FeedbackLog,
    OracleArm,
    PoolEngine,
    ReplicaSet,
    ThriftRouter,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", type=int, default=12)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--clusters", type=int, default=6)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--budget", type=float, default=1e-4)
    ap.add_argument("--history", type=int, default=2000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through an R-replica ReplicaSet (sharded "
                         "admission, overlapped or fused waves, "
                         "shard-merged feedback); 1 = the plain "
                         "BatchScheduler path")
    ap.add_argument("--placement", type=str, default="auto",
                    choices=["auto", "overlapped", "fused", "inline"],
                    help="replica wave placement (auto: overlapped when "
                         ">1 card, else fused; see ReplicaSet)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="Poisson arrival rate; 0 = open the floodgates")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request completion SLO fed to the flush policy")
    ap.add_argument("--metered", action="store_true",
                    help="mark every arm as a metered API so the speculation "
                         "switch picks the compacting reference plane")
    ap.add_argument("--drift-after", type=int, default=0,
                    help="inject truth drift after this many served queries "
                         "(0 = no drift); enables the feedback loop and "
                         "batched drift replans")
    ap.add_argument("--probe-rate", type=float, default=0.0,
                    help="exploration probe rate (fraction of requests that "
                         "invoke one unplanned arm); enables feedback")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="per-cell fault rate injected on --fault-arms "
                         "(split 50/30/20 across timeout/error/degrade); "
                         "0 = no fault injection")
    ap.add_argument("--fault-arms", type=str, default="",
                    help="comma-separated arm indices the fault policy "
                         "targets (default: all arms)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the router plans and runs its wave loop "
                         "(cuda needs a card; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    wl = OracleWorkload(
        num_classes=args.classes, num_clusters=args.clusters, num_arms=args.arms
    )
    engine = PoolEngine(
        [OracleArm(f"llm-{i}", wl, i, metered=args.metered)
         for i in range(args.arms)]
    )
    if args.fault_rate > 0:
        targets = (
            [int(a) for a in args.fault_arms.split(",") if a.strip()]
            if args.fault_arms else list(range(args.arms))
        )
        engine.fault_policy = FaultPolicy(
            args.arms, args.classes, seed=7
        ).set_arms(
            targets,
            timeout=0.5 * args.fault_rate,
            error=0.3 * args.fault_rate,
            degrade=0.2 * args.fault_rate,
        )
    T, emb, _ = wl.response_table(args.history)
    assign, _ = kmeans(emb, args.clusters, seed=0)
    est = SuccessProbEstimator(T, emb, assign)
    router = ThriftRouter(engine, est, num_classes=args.classes, device=args.device)
    online = args.drift_after > 0 or args.probe_rate > 0
    feedback = (
        FeedbackLog(est, probe_rate=args.probe_rate) if online else None
    )
    if args.replicas > 1:
        sched = ReplicaSet(
            router, replicas=args.replicas, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3, feedback=feedback,
            placement=None if args.placement == "auto" else args.placement,
        )
        stragglers = sched.stragglers
    else:
        sched = BatchScheduler(
            router, max_batch=args.max_batch,
            max_wait_s=args.max_wait_ms / 1e3, feedback=feedback,
        )
        stragglers = sched.mitigator.stragglers
    sched.prewarm(budgets=[args.budget])

    rng = np.random.default_rng(1)
    cid, qemb, labels = wl.sample_queries(args.queries, rng)
    payloads = np.column_stack([cid, labels])
    slo_s = None if args.slo_ms is None else args.slo_ms / 1e3

    drifted = [False]

    def maybe_drift(served: int) -> None:
        """The mid-stream shift: degrade the served plans' arms for half
        the clusters once ``--drift-after`` queries have gone out."""
        if not args.drift_after or drifted[0] or served < args.drift_after:
            return
        drifted[0] = True
        targets = list(range(max(1, args.clusters // 2)))
        for t in targets:
            wl.drift_arms(
                router.plans.plan(t, args.budget).order, 0.30, clusters=[t]
            )

    t0 = time.monotonic()
    blocks = []          # (BlockFuture, label slice) in submission order
    if args.qps <= 0:
        # feedback/drift need mid-stream boundaries: chunk the floodgates
        # submission so labels fold and replans fire between chunks
        step = args.max_batch if online else args.queries
        for s in range(0, args.queries, max(1, step)):
            e = min(args.queries, s + max(1, step))
            blk = sched.submit_many(payloads[s:e], qemb[s:e], args.budget,
                                    slo_s=slo_s)
            blocks.append((blk, labels[s:e]))
            sched.drain()
            if online:
                sched.record_outcomes(blk.request_ids, labels[s:e])
            maybe_drift(e)
        if online:
            sched.apply_feedback()   # fold the final chunk's labels too
    else:
        # Poisson arrivals: exponential gaps, submitted in the bursts the
        # wall clock actually delivers (columnar blocks, like a real front
        # door batching its accept loop).
        arrivals = t0 + np.cumsum(
            rng.exponential(1.0 / args.qps, args.queries)
        )
        sent = 0
        recorded = 0
        while sent < args.queries:
            now = time.monotonic()
            due = int(np.searchsorted(arrivals, now, side="right"))
            if due > sent:
                blocks.append((
                    sched.submit_many(
                        payloads[sent:due], qemb[sent:due], args.budget,
                        slo_s=slo_s, arrival_s=arrivals[sent:due],
                    ),
                    labels[sent:due],
                ))
                sent = due
            sched.pump()
            if online:
                while recorded < len(blocks) and blocks[recorded][0].done():
                    blk, lab_r = blocks[recorded]
                    sched.record_outcomes(blk.request_ids, lab_r)
                    recorded += 1
                maybe_drift(int(sched.stats["completed"]))
        sched.drain()
        if online:
            for blk, lab_r in blocks[recorded:]:
                sched.record_outcomes(blk.request_ids, lab_r)
            # no further admission will fold these: absorb them now so the
            # drift -> batched-replan counters reflect the whole stream
            sched.apply_feedback()
    dt = time.monotonic() - t0

    preds = np.concatenate([b.predictions for b, _ in blocks])
    lab = np.concatenate([l for _, l in blocks])
    cost = np.concatenate([b.costs for b, _ in blocks])
    n = int(sched.stats["completed"])
    lat = sched.latency_stats()
    st = sched.stats  # plan + speculation counters
    print(
        f"served {n} queries in {dt:.2f}s ({n/max(dt,1e-9):.0f} qps) | "
        f"p50 {1e3*lat.get('p50_s', 0):.2f}ms p99 {1e3*lat.get('p99_s', 0):.2f}ms | "
        f"accuracy {(preds == lab).mean():.3f} | mean cost {cost.mean():.3e} "
        f"(budget {args.budget:.0e}) | "
        f"planes jit={st['spec_jit']} ref={st['spec_reference']} | "
        f"flushes {st['flushes']} groups {st['batches']} | "
        f"plan hit/miss {st['plan_hits']}/{st['plan_misses']} "
        f"(prefetched {st['plan_prefetches']}) | "
        f"stragglers={stragglers()}"
    )
    if args.replicas > 1:
        print(
            f"replica plane: R={st['replicas']} on "
            f"{st['replica_devices']} device(s) [{sched.placement}] | "
            f"overlapped dispatches {st['replica_overlapped']} "
            f"({st['replica_overlapped_rows']} rows) | fused dispatches "
            f"{st['replica_fused']} ({st['replica_fused_rows']} rows) | "
            f"affinity spills {st['replica_spills']}"
        )
    if args.fault_rate > 0:
        print(
            f"fault plane: rate {args.fault_rate:.2f} on "
            f"{len(targets)} arm(s) | attempted failures "
            f"{st.get('degradation_failures', 0)} "
            f"(degraded {st.get('degradation_degraded', 0)}) over "
            f"{st.get('degradation_routes', 0)} faulted routes"
            + ("" if online else
               " | (enable --probe-rate/--drift-after to fold failures "
               "into the estimator)")
        )
    if online:
        tail = preds[args.drift_after:] if args.drift_after else preds
        tail_lab = lab[args.drift_after:] if args.drift_after else lab
        print(
            f"online loop: labels {st['feedback_labels']} "
            f"drifts {st['feedback_drifts']} | batched replans "
            f"{st['plan_batch_replans']} rebuilding {st['plan_batch_replanned']} "
            f"plans (stale dropped {st['plan_stale_dropped']}) | probes "
            f"{st['feedback_probes']} | post-drift accuracy "
            f"{(tail == tail_lab).mean():.3f}"
        )


if __name__ == "__main__":
    main()
