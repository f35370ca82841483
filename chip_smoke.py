#!/usr/bin/env python3
"""Drive the PyTorch port's serving path — the router, the continuous-
batching front door, the replica plane and the serve CLI — GreedyLLM and
the paper's baselines, the planner's hostgamma baseline and the port's
static checks, its training path (gradients through the model
kernels, the train step, the training CLI with restart, the
train-calibrate-serve pipeline), every architecture of its registry and
their prefill and decode steps with KV and recurrent caches on one CUDA
card and check them.

    python3 chip_smoke.py

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): f32 results are compared below.

Phases:

1. report — the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build — compile every CUDA kernel of ``src/repro_torch/csrc`` (seven, one
   ``nvcc`` each, all started together; timed as set-up), then count the
   tensor-core instructions (``HGMMA``/``HMMA``) in the ``flash_attention``
   library's SASS (``cuobjdump -sass``): the phase fails at 0;
3. kernels vs plain — each router kernel against its plain PyTorch version
   on the same CUDA tensors, bitwise, or the phase fails:
   ``belief_aggregate`` (beliefs and predictions) at (130, 12, 77), at the
   router's prefix-expanded shape for K=4 and K=77 and at M=40 for K=129,
   200 and 1000; ``mc_correctness_grouped`` at planner shapes (G in {1, 8},
   C=3, T=16384, L=12, K in {4, 77}; G=1 at K=128; G=8 at L=32, the last
   register kernel, at K=200, and at L=33 and 64, the wide kernel; G=1 at
   L=40, K=200) and ``mc_correctness`` on ``sample_pool_responses`` draws
   at the Fig. 11 shape (T=8000, L=8, C=8, K=4), the serve defaults (T =
   ``theta_for(0.1, 0.01, 0.95, 12)`` = 8471, L=12, C=12) at K=4, 77 and
   128, one candidate over T=300 (less than a block), a ragged last block,
   L=32, and the wide kernel at L=33, 64 and 128 (C=8, K=4) and at L=40,
   K=1000. Then one call of each of the three at its path shape under
   ``torch.profiler`` must show exactly one kernel launch and allocate
   nothing but its outputs. Past the limits of earlier versions, both mc
   kernels bitwise at T=300: L=1100 K=4 (int16 staging), L=12 and L=64 at
   K=40000 (folded bins; int32 staging), L=1100 K=40000 and L=2100 K=4 (no
   staging), each timed; and the grouped kernel at G=65537 and at
   C=65537, the single one at C=65537 (chunked launches);
4. route — the serve defaults (12 arms, K=4, 6 clusters, history 2000,
   batches of 64, eps 0.1, delta 0.01): uniform-budget batches (batched
   planner + device wave loop) and mixed-budget batches (serial planner,
   which scores candidates with ``mc_correctness_grouped`` under
   ``use_kernel``), with ``use_kernel`` off and on, each held against the
   same routes run by the port on the CPU: plans (sets, xi, cost, p*),
   predictions, schedules, costs and beliefs bitwise on both planes;
5. K=77 — one batch over a 77-class label space with ``use_kernel=True``;
6. launches — both router kernels' launch counters, zeroed just before
   phase 4, must be above 0 after phase 5; then one route of 64 is timed
   cold and warm on the card, and each kernel is checked against its plain
   version and timed at the shape the main path gave it;
7. model kernels vs plain — ``flash_attention`` in bf16 (the tensor-core
   kernels, v3 at query / kv head ratios 1-3 and v4 above, 2e-2 against
   the f32 plain version) at the two LM arms' shapes,
   at S=37 with T=45, with window 5, at hd 16, 32 and 128 and at query /
   kv head ratios 1, 3 and 16, and in f32 (the CUDA-core kernel) with and
   without windows, hd 64 and 256 (2e-5); ``rglru_scan`` at (64, 127,
   4096) and (3, 37, 200) (1e-5); ``mamba_scan`` at the falcon-mamba path
   case — bf16 x, B and C, B and C strided views of one (B, S, R + 2N)
   projection, dt in f32 as the block gives it, no initial state: h_last
   within 3e-4, the bf16 y within 3e-4 plus one rounding to nearest
   (2^-8 |y|) of the plain version's unrounded f32 y — and in f32 at (64, 127, 8192, 16) and (2, 37,
   96, 8) with nonzero initial states (3e-4); ``flash_attention`` also at
   head dims no kernel is built for (the kernels take hd as the row
   stride; the wrapper pads only bf16's hd 12, to 16): hd 8, 12 and 24 in
   bf16 (2e-2) and f32 (2e-5), and in both dtypes at the other families'
   route shapes at B=2, at hd 40, 96 and 112, ratio 9 with S < T, a window
   that binds at ratio 4, prompts whose keys stream (S = 1100 and 1500)
   and ratio 128, and at Moonlight's MLA path (B=128, H=G=16, q/k 192, v
   128 zero-padded by the wrapper: one launch, the output at v's 128);
   ``causal_conv1d`` bitwise at falcon-mamba's path case
   (B=128, x the x-half of a (B, S, 2 x 8192) bf16 split, SiLU), at
   recurrentgemma's width without the SiLU, one decode step from a state,
   S < K-1, f32, ragged channels, and every bf16 value through its SiLU;
8. models — smollm-135m, recurrentgemma-9b and falcon-mamba-7b at full
   width in f32, cut to one pattern unit of depth (1, 3 and 1 layers) so
   the CPU side takes seconds: the same weights forward on the card and on
   the CPU, logits within 1e-3;
9. LM-arm route — the three models at full width and depth in bf16 as
   ``LMArm``s (seeded init on the card) over ``make_token_task(K=4,
   seq_len=128, vocab=512)``: calibrate on 256 history queries, route a
   uniform-budget and a mixed-budget batch of 64 through
   ``ThriftRouter(use_kernel=True)``. The kernels' launch counters, zeroed
   before this phase, are read after the two routes and ``flash_attention``,
   ``rglru_scan``, ``mamba_scan`` and ``belief_aggregate`` must each be
   above 0; costs stay within budget, a second route of each batch repeats
   the first, and the plans equal those of a router planning on the CPU,
   bitwise. Then the same two batches through a ``BatchScheduler``
   (``max_batch`` 64, ``max_inflight`` 2, no faults, no labels, counters
   zeroed before it): predictions, costs and stop waves equal the router's
   own routes of the same admission groups, and the three model kernels
   and ``belief_aggregate`` launch; then one batch with faults on smollm
   (timeout 0.3, error 0.2): smollm classifies exactly its unfailed cells,
   counted row by row, and only smollm is charged failures;
10. timing — each model kernel at the LM-arm route's shapes and dtypes
    (``mamba_scan`` with bf16 x, strided bf16 B, C, f32 dt and no initial
    state, bound
    by its exponentials at the card's maximum SM clock; ``causal_conv1d``
    at the benchmark's group of 128 and the route's 64, with the SiLU, x the
    split's x-half, bound by its bytes, beside the same pass without the
    SiLU and the plain version's 21 launches; ``flash_attention`` also at
    Moonlight's MLA path: the wrapper's call, the padded kernel alone, the
    bytes bound at v 128 and SDPA, in the ``kernels`` line's flash row
    under ``by_shape``);
11. GreedyLLM on MC xi — GreedyLLM (Alg. 1) scoring candidates with
    ``McXiEstimator(use_kernel=True)`` on the card, held to the same run on
    the CPU (equal picks and final xi): (a) the Fig. 11 setting of
    ``benchmarks/paper_benches.py::xi_vs_gamma`` (40 seeds, 8 arms, theta
    8000, K=4, budget 1.0), printing its ``mean_xi_gain`` against greedy on
    gamma; (b) every cluster of the serve-default workload (K=4, 2000-query
    history) at the five budgets of ``examples/budget_sweep.py`` with theta
    ``theta_for(0.1, 0.01, max p, 12)``, then a K=77 workload at 5e-4.
    ``mc_correctness``'s launch counter, zeroed before the phase, must be
    above 0 after it; one selection is timed on the host clock (median of
    5) and the kernel at the shape the phase gave it. An ``[earlier
    kernels]`` line then sets each redesigned kernel's time (``flash_attention``,
    ``mamba_scan``, ``mc_correctness``, ``mc_correctness_grouped``,
    ``belief_aggregate``) beside
    its earlier version's recorded time (not measured in this run, and so
    kept out of the ``kernels`` line);
12. budget sweep — ``repro_torch.budget_sweep`` at the example's defaults
    (600 queries, 3000 history, 5 budgets): ThriftLLM, SurGreedy, cascade,
    top-k, single and blender with the router on the card and on the CPU;
    every column's (accuracy, mean cost) must be equal, and every
    budget-aware column within its budget;
13. 40 arms — the serve defaults over a 40-arm oracle pool (K=4), past
    the register kernels' 32 arms: a uniform-budget and a mixed-budget
    batch of 64 with ``use_kernel=True``, card vs CPU bitwise as in phase
    4, then GreedyLLM with ``McXiEstimator(use_kernel=True)`` over the same
    40 arms at budgets 1e-5 and 1e-4, picks and xi card vs CPU. The launch
    counters, zeroed just before the phase, must show ``belief_aggregate``,
    ``mc_correctness_grouped`` and ``mc_correctness`` above 0 after it;
14. scheduler — ``launch/serve.py --queries 500 --budget 1e-4 --fault-rate
    0.1 --drift-after 250 --probe-rate 0.02`` at ``--qps 0`` on the port's
    ``BatchScheduler`` (``max_batch`` 64; faults on every arm, seed 7; a
    ``FeedbackLog`` with probes; a ``CostLedger`` whose tenant "acme", every
    other request, is limited to 80% of its spend in an unlimited run, with
    downgrade tiers 2.5e-5, 5e-5, 1e-4), blocks of 64 submitted and drained
    in turn with their labels recorded, then one mixed-budget block of 64
    admitted by ``flush()`` (its plan misses plan serially): ``use_kernel``
    off and on, each on the card and on the CPU, every block's
    predictions, costs, planned costs, clusters, budgets, stop waves, modes
    and request ids, every counter and the ledger's snapshot bitwise. The
    launch counters are zeroed before and read after each card stream;
    with ``use_kernel`` on, ``belief_aggregate`` and
    ``mc_correctness_grouped`` must be above 0. Then ``--qps 5000 --slo-ms
    50`` on the card (Poisson arrivals, the same faults and probes, no
    drift, no ledger; timed, not compared) and the
    device's idle share of one profiled floodgates stream. A
    ``[scheduler]`` line prints qps, p50/p99, accuracy, planes, flushes,
    plan counters, failures, drifts, ledger rejections and downgrades and
    launches per setting;
15. replicas — the ``ReplicaSet`` and the serve CLI, ``use_kernel`` on.
    (a) phase 14's stream (limit and all; its mixed block admitted by
    ``drain()``, as the reference's replica tests drive mixed budgets, in
    both runs: a ``ReplicaSet`` has no ``flush()``) through
    ``ReplicaSet(replicas=1)`` equals a ``BatchScheduler``'s on the card:
    blocks, every shared counter, the ledger snapshot, bitwise; (b) the
    same stream with no ledger limit at R=4 in the default placement,
    which must be ``"fused"`` on one card, card vs CPU bitwise
    (``replica_fused``, ``replica_fused_rows`` and ``replica_spills``
    included); the launch counters, zeroed just before its card run and
    read just after it, must be above 0 for ``belief_aggregate`` (every
    route) and ``mc_correctness_grouped`` (the serial planner's Alg. 2
    candidates, when a drift replans one stale pair alone; the limited
    stream's rejections leave it none, so (b) runs unlimited); then R=4
    ``placement="overlapped"`` on the limited stream card vs CPU; (c) R=4 overlapped over a
    tabular pool (the serve defaults' 12 arms, answers drawn once) with
    faults on every arm and the failures folded by a ``FeedbackLog``: the
    four workers hold four distinct CUDA streams (none the default
    stream), and card overlapped == card fused == CPU overlapped, bitwise
    (the placements' own dispatch counters and plan hits aside), and the
    overlapped set once more with its streams taken away (every worker on
    the current stream; equal, bitwise, and timed: what the streams buy);
    (d) ``python -m
    repro_torch.launch.serve --queries 500 --budget 1e-4 --replicas 4
    --fault-rate 0.1 --drift-after 250 --probe-rate 0.02`` as a
    subprocess on the card, its time-free fields equal to ``--device
    cpu``'s, then ``--qps 5000 --slo-ms 50`` with probes and no drift
    (clocked, so only run and echoed); (e) ``python -m
    repro_torch.quickstart --queries 80 --history 300`` on the card prints
    exactly what it prints with ``--device cpu``. A ``[replicas]`` line
    prints qps and p50/p99 per placement (R=1 inline, R=4 fused and
    overlapped, the tabular streams), the launches, and the idle share of
    one profiled R=4 floodgates stream;
16. training — (a) each model kernel's autograd Function
    (``ops.KernelFunction``) against the plain version's own autograd on
    the same CUDA tensors and upstream gradient: ``flash_attention`` bf16
    at B=8 S=512 H=9 G=3 hd=64 (smollm-135m's training shape) and f32 at hd
    8, 12 and 24, ``rglru_scan`` and ``mamba_scan`` at the SMOKE configs'
    shapes (B=4, S=32) and ``mamba_scan`` at phase 7's bf16 path case with
    B and C strided views of one projection: one launch by the counter, the
    forward's outputs within phase 7's tolerances of the plain version's
    (the bf16 ones against the plain version on f32 copies), and input
    gradients equal bitwise; then ``flash_attention`` at the training
    shape timed forward (beside its bound, the plain version and
    ``scaled_dot_product_attention``) and backward (its Function's backward
    beside SDPA's); (b) smollm, recurrentgemma and
    falcon-mamba at their SMOKE configs in f32, the same torch-seeded
    weights trained 5 steps (4 x 32 tokens) on the card and on the CPU:
    losses within rel 1e-4 at every step, the three model kernels launched
    on the card, and every parameter's gradient on the card finite and
    non-zero; (c) smollm-135m at full width in bf16 with remat, 30 steps of
    8 x 512 ``make_token_task(K=4, seq_len=512, vocab=512)`` batches: the
    mean loss of the last 5 steps below the first 5's, ``flash_attention``
    launched exactly layers x steps x 2 (forward and remat recompute); a
    ``[train]`` line prints the median step ms, tokens/s, peak memory and
    one profiled step's idle share and device split (flash forward, the
    attention backward — every kernel under ``KernelFunction``'s backward
    range —, cuBLAS outside it, other), one checkpoint save and restore of
    the trained state timed, beside the card's name and power limit; (d)
    ``python -m repro_torch.launch.train --arch smollm-135m --steps 20
    --save-every 10`` as a subprocess, then again to 30 steps, which must
    print ``resumed from step 10`` (each run's wall clock split at its step
    loop); (e) ``python -m
    repro_torch.train_and_serve --steps 60`` on the card, then with
    ``--device cpu``: the arms' costs equal, and on the card
    ``tests/test_system.py``'s asserts hold (the largest arm beats the
    smallest, the ensemble at 100x the cheapest cost scores at least the
    best arm - 0.08, 1.2x scores above 1/K, every cost within its budget,
    every arm's loss falls by more than 0.25);
17. the other families — the seven architectures of the registry past
    phase 8's three: (a) ``flash_attention`` in bf16 at their LM-arm route
    shapes (B=64, S=T=127: h2o-danube's H=32 G=8 hd=80 with window 4096,
    no pad; starcoder2's 36/4, qwen's 64/8 and moonshot's 16/16 at hd 128)
    and at danube's window where it binds (B=1, S=T=4608), each within 2e-2
    of the f32 plain version, a profiled call holding only the flash
    kernel's rows (no pad or slice copy), and timed beside its bound, the
    plain version and SDPA (with the window as a boolean mask where it
    binds), with the design, grid and bytes copied into shared memory that
    the wrapper's tiling gives; (b) one pattern unit of each of the seven
    ``CONFIG``s at published width in f32, card vs CPU within 1e-3 as in
    phase 8, internvl2 and musicgen with frontend embeddings, the two MoE
    configs printing how many tokens pick the same experts on both and the
    smallest gap between the k-th and (k+1)-th router logit; (c) a
    full-width bf16 pool of granite-moe-1b-a400m, h2o-danube-1.8b,
    starcoder2-7b, internvl2-2b and musicgen-medium (13.6 B params) as
    ``LMArm``s, calibrated, routed and scheduled as phase 9 does (counters
    zeroed before it; ``flash_attention`` and ``belief_aggregate`` must
    launch; the fault check on granite-moe, the cheapest arm), each arm's
    forward timed and split; (d) moonshot-v1-16b-a3b alone at full width
    in bf16 (27.7 B params): one 64-query ``classify_batch`` timed (median
    of 3 after a warm-up), logits finite, peak memory, then freed; (e)
    qwen1.5-110b at published width cut to 8 of its 80 layers (13.4 B
    params; ``reduced``), the same; (f) the seven ``SMOKE`` configs in f32,
    3 train steps each card vs CPU as in phase 16 (b), the frontend configs
    on frontend batches, the MoE configs' aux finite and non-zero. A
    ``[families]`` line prints each part's numbers beside the card's name
    and power limit;
18. prefill and decode — (a) every ``SMOKE`` config of the registry in
    f32, the same weights on the card and the CPU: a prefill of 19 tokens
    (frontend configs after frontend embeddings) with 3 extra slots, then
    3 decode steps, the logits and every cache leaf (ring and ``pos``
    included) card vs CPU within 1e-4 after each (the windowed rings of 16
    wrap), the prefill's logits equal to the forward's last position on
    the card within 2e-4; smollm's with an int8 KV cache, its scales
    within 1e-6 and its int8 values equal but at rounding ties (the CPU's
    ``x / scale`` within 1e-3 of a half), where one step apart; the model
    kernels' launch counters, zeroed before the phase, must show all three
    launched; (b) smollm-135m, recurrentgemma-9b, falcon-mamba-7b and
    granite-moe-1b-a400m at published width in bf16, one at a time: 64
    queries of 127 tokens prefilled with 32 extra slots, 32 greedy decode
    steps (prefill ms, median step ms, tokens/s, peak memory, one profiled
    step's idle share, launches and device split into attention, cuBLAS,
    elementwise and other, and the bound per step: weights, KV cache and
    states over the memory rate), the bf16 decode logits' gap to the
    forward's printed beside the forward's own move under a one-ulp change
    of 1% of its embeddings; then the decode path in f32 at published
    width and depth (4 queries, or for recurrentgemma, whose 127 tokens are
    inside its local window (F4), 2056 tokens at B=2, past it), 8 steps,
    against the forward within 1e-3 of the largest logit. A ``[decode]``
    line prints (b)'s numbers beside the card's name and power limit;
19. launch tools — (a) the dry run's CLI (``python -m
    repro_torch.launch.dryrun``, called in process, its JSON records under
    ``build/dryrun``) for every architecture's ``decode_32k`` cell on the
    16x16 layout and for smollm-135m's ``train_4k``, on the meta device:
    per-device GB, ``fits_hbm``, the three roofline terms with the H100's
    ``HW`` and the counted FLOPs beside the analytic count, a line each;
    (b) the roofline of the shapes phases 16 and 18 timed on this card
    (smollm-135m training at 8 x 512, the four decode arms at B=64 with
    127 + 32 cache slots): the measured median ms and peak GB beside
    ``roofline_terms(chips=1, HW)``'s ``step_s_lower_bound`` and
    ``analytic_memory(dp=1, tp=1)["total"]``, printed, not gated
    (``[roofline]`` line); (c) expert parallelism at granite-moe-1b-a400m's
    published width and depth in f32 over a world-size-1 NCCL
    ``DeviceMesh`` (data 1, model 1), on (b)'s 64 x 127 token batch, at
    capacity factor E / k (no token dropped on either path): the forward
    under ``cfg.moe_ep`` with the rules active sends each of the 24 MoE
    layers through ``moe_mlp_ep`` (counted) and its logits equal the
    dense forward's within 1e-4 (``flash_attention``'s launches in the
    two forwards go on its row as ``launch_phase_launches``); the first MoE layer's own input and
    weights through ``moe_mlp_ep`` equal ``moe_mlp`` within 1e-5 (output
    and aux); (d) ``replica_mesh(4)`` is None on one card;
20. the sharded train step over a ``torch.distributed`` ``DeviceMesh``
    (``init_train_state``/``make_train_step`` under ``AxisRules(mesh)``:
    ``DTensor`` parameters and optimizer state laid out by
    ``param_specs``, gathered at use) — (a) smollm-135m at published width
    and depth in bf16 with remat, 3 steps of phase 16's 8 x 512 batches
    from phase 16's weights on a world-size-1 NCCL mesh (data 1, model
    1), then unsharded from the same weights: losses within rel 1e-5 and
    the whole state within 5e-5 (whether bitwise is printed), the losses
    also against phase 16's first three, step ms and peak GB beside
    phase 16's, ``flash_attention`` launched layers x steps x 2, then one
    more step of each side profiled (wall, device ms and idle share; host
    ms in the gathers at use, forward and backward, and in the AdamW
    update); (c), on (a)'s sharded state: a sharded checkpoint save (host
    0 writes ``shard_0.npz``) and restore into the sharded template,
    bitwise, the placements kept, timed; (b) smollm-135m,
    recurrentgemma-9b, falcon-mamba-7b and granite-moe-1b-a400m SMOKE in
    f32 (the four block types), 2 steps each, sharded vs unsharded on the
    card within the same bounds, all three model kernels launched in the
    sharded steps; (d) only with two or more cards: (b)'s configs on a
    2-rank NCCL world (data 2, model 1), a spawned process per card,
    against (b)'s one-card results; with four or more, on a 2x2 world
    (data 2, model 2) too, with smollm-135m at published width in bf16
    and in f32 on the launcher's first 11 batches against one card, every
    loss (f32 within rel 1e-5, bf16 within ``LAUNCHER_REL``); (e) only with
    four or more cards: the training launcher at smollm-135m's published
    width on one card, under ``torchrun`` on four as 2x2, then from the
    2x2 run's checkpoint resumed on two as 1x2 and on one card, every
    printed loss held to the one-card runs' (step 0 equal, the others
    within ``LAUNCHER_REL``)
    (else each line says it was not run). A ``[sharded]`` line prints the
    numbers beside the card's name and power limit;
21. the planner baseline and the port's thriftlint — (a) the reference
    bench's raw-speed planner setting (``HOSTGAMMA``: L=12, K=4, theta
    200, G in 1, 8, 64; ``benchmarks/serving_throughput.py:1066-1080``):
    ``_sur_greedy_many_hostgamma`` with ``use_kernel`` off and on and
    ``sur_greedy_many``, each on the card and on the CPU; every plan
    (picks, s1, s2, l*, the three xi, cost) bitwise across the planes
    (the kernel plane's xi against the fused f64 xi rounded to f32) and
    bitwise its CPU run; ``mc_correctness_grouped`` launched once per G
    by the kernel plane (counts zeroed just before); the median host ms of each
    planner per G and one profiled call of each at G=64 (wall, device ms,
    idle share) on a ``[hostgamma]`` line with the card's name and power
    limit; (b) ``repro_torch.analysis.run_lint`` over this checkout's
    ``src/``: zero findings, every suppression reasoned (``[lint]``: the
    rules, files scanned, suppressions per rule). At the end of the run
    TF32 must still be off and the f32 matmul precision "highest"
    (``[tf32 at the end]``).

Two lines before the last is a JSON object listing every kernel with its
launches, error, bound and times — ``ms``/``plain_ms``/``library_ms`` are
device time per call from a ``torch.profiler`` trace of n calls between
spin kernels that holds n times one call's kernel rows (else it is taken
again, and a ``[profiler traces]`` line lists the short ones; a
single-launch kernel whose traces all lost rows is read from its mean
kernel row, ``ms_source`` says so; a ``[profiler rows]`` line counts the
rows of bare and of bracketed traces), ``call_ms`` the
CUDA-event wall time per call, host dispatch included; a router kernel's
``launches`` count phases 4-5 and its ``lm_route_launches`` phase 9, a
model kernel's ``launches`` phase 9, ``mc_correctness``'s phase 11; the
three router kernels' ``wide_pool_launches`` count phase 13, the two
router kernels' ``scheduler_launches`` phase 14's ``use_kernel`` stream
and their ``replica_launches`` phase 15 (b)'s card stream,
and ``lm_scheduler_launches`` the LM arms' scheduler run in phase 9, and
the four model kernels' ``train_launches`` phase 16 (b) (SMOKE, f32) and
(c) (smollm-135m, bf16), and the ``flash_attention`` row's
``training_shape`` its phase-16 times and its ``families`` phase 17's
shapes, timed, and launches (the pool's route and scheduler runs,
moonshot's and qwen's forwards, the SMOKE training), and
``belief_aggregate``'s ``families_pool_launches`` phase 17 (c)'s, the
four model kernels' ``decode_phase_launches`` phase 18's (by its
prefills, by (a)'s prefills, and in the whole phase, the forwards the
prefills and decodes are held against included) and ``sharded_launches``
phase 20's sharded steps' ((a) smollm-135m bf16, (b) SMOKE f32), and
``mc_correctness_grouped``'s ``hostgamma_launches`` phase 21 (a)'s; the
two ``mc_correctness`` rows carry ``lifted``, their phase-3 cases past
the limits of earlier versions, timed.
``flash_attention`` is listed at the
recurrentgemma shape with both path shapes under ``by_shape``. Every row
carries ``launch_floor_ms``, the device time of a one-element ``zero_()``
in this run: the least a single launch costs. The three router kernels'
rows carry ``bitwise`` (their every check in this run was exact) and
``call_ms``; the two ``mc_correctness`` rows carry ``wide``, the wide
kernel at L=64 (K=4) at the row's path shape otherwise. The line
before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero; without a CUDA device, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# the card's memory rate and dense bf16 tensor-core rate: HW["hbm_bw"] and
# HW["peak_flops"] of repro_torch.launch.mesh, read in main()
HBM_BYTES_PER_S = BF16_OPS_PER_S = None
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside the tensor cores
FLASH_BF16_ATOL = 2e-2           # one bf16 rounding of the output (tests/test_kernels.py)
FLASH_F32_ATOL = 2e-5
RGLRU_ATOL = 1e-5
MAMBA_ATOL = 3e-4
BF16_ROUNDING = 2.0 ** -8         # one bf16 rounding to nearest moves y by at most 2^-8 |y|
LOGITS_ATOL = 1e-3               # f32 logits, card vs CPU: sums in other orders only
ARCHS = ("smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b")
SFU_EX2_PER_CLOCK_SM = 16        # H100 (sm_90) MUFU ex2 results per clock per SM
H100_SMS = 132


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_events(prof):
    """The device-side rows of a ``torch.profiler`` trace. A CPU op's row
    carries the device time of the kernels it launched and each kernel has
    a row of its own, so summing every row counts a torch op's kernels
    twice; the kernel rows alone count each launch once. The port's own
    spans (``repro_torch.trace``) also show there, as annotations spanning
    their kernels: their rows are left out by the spans' name prefixes."""
    from torch.autograd import DeviceType

    from repro_torch.trace import PREFIXES

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not e.key.startswith(PREFIXES)]


# every device_ms trace of n calls: how many, and those whose kernel rows
# were not n times one call's (taken again)
TRACES = {"taken": 0, "short": []}
# A trace brackets the calls it times with spin kernels (`torch.cuda._sleep`)
# after a pause, since a trace of bare calls loses some of their kernel rows
# (the `[profiler rows]` line counts them both ways); the spin kernels' rows
# are left out of the count.
SENTINELS = 4
SPIN_CYCLES = 2000
PAUSE_S = 0.05


def kernel_rows(prof):
    """(kernel rows, device us) of a ``torch.profiler`` trace, spin kernels
    left out."""
    rows = [e for e in device_events(prof) if "spin_kernel" not in e.key]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)


def traced(fn, calls: int, sentinels: int = SENTINELS, pause_s: float = PAUSE_S):
    """A ``torch.profiler`` trace (the CUDA activity) of ``calls`` calls of
    ``fn`` between ``sentinels`` spin kernels before and after, begun
    ``pause_s`` after the card is idle and ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    time.sleep(pause_s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(sentinels):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(calls):
            fn()
        for _ in range(sentinels):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    return prof


def trace_rows(fn, n: int = 20, traces: int = 5) -> dict:
    """Kernel rows of ``traces`` traces each of 1 and of ``n`` calls of
    ``fn`` (one kernel a call), and the mean kernel row's ms of the traces
    of ``n``: bare, between spin kernels, and between spin kernels after a
    pause. A trace that holds fewer rows than calls lost launches."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for way, how in {"bare": (0, 0.0), "spin kernels": (SENTINELS, 0.0),
                     "spin kernels after a pause": (SENTINELS, PAUSE_S)}.items():
        one = [kernel_rows(traced(fn, 1, *how))[0] for _ in range(traces)]
        many = [kernel_rows(traced(fn, n, *how)) for _ in range(traces)]
        out[way] = {"1": one, str(n): [r for r, _ in many],
                    "row_ms": [us / r / 1e3 if r else None for r, us in many]}
    return out


def device_ms(fn, n: int = 20, tries: int = 3, launches: int = 0):
    """Device time per call of ``fn``: the summed device time of every kernel
    it launches, from a :func:`traced` trace of ``n`` calls. The trace must
    hold ``n`` times the kernel rows of one call (``launches`` where known,
    else counted in a traced single call): one that does not (or holds no
    device time) is taken again, up to ``tries`` times. Returns ``(ms,
    "profiler")``; where no trace was whole, ``launches`` times the mean
    kernel row of the last trace with ``"profiler, rows lost"`` if
    ``launches`` is known, else the CUDA-event wall time per call with
    ``"events"``."""
    def trace(calls: int):
        return kernel_rows(traced(fn, calls))

    fn()
    torch.cuda.synchronize()
    rows = us = 0
    for _ in range(tries):
        per_call = launches or trace(1)[0]
        rows, us = trace(n)
        TRACES["taken"] += 1
        if per_call > 0 and rows == n * per_call and us > 0:
            return us / n / 1e3, "profiler"
        TRACES["short"].append({"rows": rows, "want": n * per_call, "us": us})
    if launches and rows > 0:
        return us / rows * launches / 1e3, "profiler, rows lost"
    return median_ms(fn), "events"


def profiled_split(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host-clock wall ms,
    the device ms of each kernel it launched (kernel rows only), the number
    of kernel rows, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    kernels = {e.key: e.self_device_time_total / 1e3 for e in events}
    busy = sum(kernels.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernels_ms": kernels, "launches": sum(e.count for e in events)}


# ---------------------------------------------------------------------------
# Kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------


def belief_inputs(rows_b: int, T: int, K: int, prefix: bool, seed: int, dev):
    """(responses, weights, empty) for belief_aggregate. ``prefix`` builds the
    router's layout: B queries x (T+1) prefixes of a T-wave history."""
    rng = np.random.default_rng(seed)
    if prefix:
        resp_bt = rng.integers(-1, K, (rows_b, T))
        hist = np.where(np.arange(T + 1)[None, :, None] > np.arange(T)[None, None, :],
                        resp_bt[:, None, :], -1).reshape(-1, T)
        w = np.repeat(rng.uniform(0.3, 3.0, (rows_b, 1, T)), T + 1, axis=1).reshape(-1, T)
        empty = np.repeat(rng.uniform(-3.0, -0.5, rows_b), T + 1)
    else:
        hist = rng.integers(-1, K, (rows_b, T))
        w = rng.uniform(0.3, 3.0, (rows_b, T))
        empty = rng.uniform(-3.0, -0.5, rows_b)
    put = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)
    return put(hist, torch.int32), put(w, torch.float32), put(empty, torch.float32)


def mc_inputs(G: int, T: int, L: int, K: int, C: int, seed: int, dev):
    """The planner's grouped estimator tables plus random candidate masks."""
    from repro_torch.core import prng
    from repro_torch.core.mc import GroupedXiEstimator

    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.3, 0.95, (G, L))
    thetas = rng.integers(T // 2 + 1, T + 1, G)
    thetas[0] = T
    est = GroupedXiEstimator(prng.key(seed, dev), ps, K, thetas, device=dev)
    masks = (rng.random((G, C, L)) < 0.5).astype(np.float32)
    masks[:, :, 0] = 1.0
    return (est.responses, torch.as_tensor(masks, device=dev), est.log_weights,
            est.empty, est.valid, est.theta_f32)


def belief_bound(resp, K):
    rows, M = resp.shape
    nbytes = rows * M * 4 * 2 + rows * 4 + rows * K * 4 + rows * 4
    ops = int((resp >= 0).sum()) + rows * K * 2    # votes + display/argmax
    return nbytes, ops


def mc_bound(args, K):
    resp, masks, w, empty, valid, theta = args
    G, T, L = resp.shape
    C = masks.shape[1]
    nbytes = (resp.numel() + masks.numel() + w.numel() + empty.numel()
              + valid.numel() + theta.numel() + G * C) * 4
    n_valid = valid.sum(dim=1)                                  # (G,)
    n_mask = (masks > 0).sum(dim=2).to(torch.float64)           # (G, C)
    ops = float((n_valid[:, None].double() * (n_mask + 2 * K + 1)).sum())
    return nbytes, ops


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time for the work: bytes at the memory rate or operations
    at ``ops_per_s`` (the inputs' type), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels vs their plain versions on the card
# ---------------------------------------------------------------------------


def kernel_error(name: str, got, want, label: str) -> float:
    """Max abs error of a kernel's output against its plain version's on the
    same inputs; raises, printing the rows concerned, unless they are equal
    bit for bit: ``belief_aggregate`` (beliefs and predictions) and the two
    ``mc_correctness`` kernels add in their plain versions' order."""
    torch.cuda.synchronize()
    if name == "belief_aggregate":
        (bel, pred), (bel_p, pred_p) = got, want
        err = float((bel - bel_p).abs().max())
        bad = torch.nonzero(pred != pred_p)[:, 0].tolist()
        same = bool(torch.equal(bel, bel_p)) and not bad
        log(f"  {name} {label}: max_abs_err={err:.3g} pred_mismatch={len(bad)} bitwise={same}")
        if not same:
            raise AssertionError(
                f"{name} disagrees with its plain version at {label}: err {err}, "
                f"rows {bad[:10]} kernel {pred[bad[:10]].tolist()} plain {pred_p[bad[:10]].tolist()}"
            )
        return err
    err = float((got - want).abs().max())
    same = bool(torch.equal(got, want))
    log(f"  {name} {label}: max_abs_err={err:.3g} bitwise={same}")
    if not same:
        raise AssertionError(
            f"{name} differs from its plain version at {label}: "
            f"kernel {got.tolist()} plain {want.tolist()}"
        )
    return err


def single_cases():
    """(T, L, C, K, label) of phase 3's ``mc_correctness`` checks."""
    from repro_torch.core.mc import theta_for

    t_serve = theta_for(0.1, 0.01, 0.95, 12)
    return ((8000, 8, 8, 4, "Fig. 11"), (t_serve, 12, 12, 4, "serve defaults"),
            (t_serve, 12, 12, 77, "serve defaults"), (t_serve, 12, 12, 128, "serve defaults"),
            (300, 12, 1, 4, "one candidate, T < a block"), (1000, 8, 6, 17, "ragged last block"),
            (2500, 32, 7, 4, "L=32, the last register kernel"),
            (t_serve, 33, 8, 4, "wide kernel"), (t_serve, 64, 8, 4, "wide kernel"),
            (t_serve, 128, 8, 4, "wide kernel"), (t_serve, 40, 8, 1000, "wide kernel, by first voter"))


def single_inputs(T: int, L: int, C: int, K: int, seed: int, dev):
    """One pool's ``sample_pool_responses`` draws (through ``McXiEstimator``)
    plus random candidate masks: the arguments of ``mc_correctness``."""
    from repro_torch.core import McXiEstimator, prng

    rng = np.random.default_rng(seed)
    est = McXiEstimator(prng.key(seed, dev), rng.uniform(0.4, 0.95, L), K, T, device=dev)
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    return est._responses, torch.as_tensor(masks, device=dev), est._w, est._empty


def single_bound(args, K):
    """(bytes, operations) of one ``mc_correctness`` call: draws, masks,
    weights and the empty belief read once, C values written; per draw and
    candidate one add per masked arm, the display, max and tie count."""
    resp, masks, w, _ = args
    T, L = resp.shape
    C = masks.shape[0]
    nbytes = (resp.numel() + masks.numel() + w.numel() + 1 + C) * 4
    ops = float(T * ((masks > 0).sum(dim=1).double() + 2 * K + 1).sum())
    return nbytes, ops


# (query rows B, M, K, prefix layout): belief_aggregate's phase-3 cases — the
# router's prefix-expanded layout at K=4 and 77 (64 (M + 1) rows), and M=40
# arms past 128 classes
BELIEF_CASES = ((130, 12, 77, False), (64, 12, 4, True), (64, 12, 77, True),
                (130, 40, 129, False), (130, 40, 200, False), (130, 40, 1000, False))
# (G, L, K) of the phase-3 mc_correctness_grouped checks at C=3, T=16384:
# the planner's shape, K=77 and 128, G=8, L=32 (the last register kernel),
# K=200 (folded bins), and the wide kernel at L=33 and 64
GROUPED_CASES = ((1, 12, 4), (1, 12, 77), (1, 12, 128), (8, 12, 4), (8, 12, 77), (8, 32, 4),
                 (8, 12, 200), (8, 33, 4), (8, 64, 4), (1, 40, 200))
# (G, T, L, K, C, label) of the phase-3 checks past the limits of earlier
# versions (1024 arms, 32767 classes, 65535 groups or candidates a launch),
# each bitwise for both mc kernels (the single one on group 0)
LIFTED_CASES = ((2, 300, 1100, 4, 3, "int16 staging, one warp"),
                (2, 300, 12, 40000, 3, "register kernel, folded bins"),
                (2, 300, 64, 40000, 3, "int32 staging"),
                (1, 300, 1100, 40000, 3, "no staging"),
                (2, 300, 2100, 4, 3, "no staging"))
# (G, T, L, K, C): one launch a chunk of 65535 groups, or of 65535 candidates
CHUNKED_CASES = ((65537, 8, 4, 3, 2), (2, 8, 4, 3, 65537))


def lifted_inputs(G: int, T: int, L: int, K: int, C: int, dev):
    """Grouped ``mc_correctness`` arguments at any size: responses uniform
    over [-1, K) with half the arms on classes -1..2 (so class 0 draws
    votes and ties), random masks with the last candidate empty, the last
    seventh of the draws invalid."""
    rng = np.random.default_rng(L + K + G + C)
    resp = rng.integers(-1, K, (G, T, L)).astype(np.int32)
    resp[:, :, : L // 2] = rng.integers(-1, 3, (G, T, L // 2))
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0
    valid = np.ones((G, T), np.float32)
    valid[:, T - T // 7:] = 0.0
    arrays = (resp, masks, rng.uniform(0.3, 3.0, (G, L)).astype(np.float32),
              rng.uniform(-3.0, -0.5, G).astype(np.float32), valid,
              valid.sum(axis=1).astype(np.float32))
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def single_of(args):
    """The single-pool kernel's arguments: group 0 of grouped ones."""
    resp, masks, w, empty = args[:4]
    return resp[0], masks[0], w[0], empty[:1]


def check_lifted(dev, errs: dict) -> list:
    """Both mc kernels past the limits of earlier versions, each bitwise
    its plain version; returns the timed rows of the lifted cases (device
    ms of one call at the checked shape, beside its bound)."""
    from repro_torch.kernels import ops, ref

    rows = []
    for G, T, L, K, C, label in LIFTED_CASES:
        args = lifted_inputs(G, T, L, K, C, dev)
        one = single_of(args)
        shape = f"G={G} T={T} L={L} K={K} C={C}"
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], kernel_error(
            "mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
            ref.mc_correctness_grouped_ref(*args, K), f"{label}: {shape}"))
        errs["mc_correctness"] = max(errs["mc_correctness"], kernel_error(
            "mc_correctness", ops.mc_correctness(*one, K), ref.mc_correctness_ref(*one, K),
            f"{label}: T={T} L={L} C={C} K={K}"))
        for name, fn, a, bound in (("mc_correctness_grouped", ops.mc_correctness_grouped, args,
                                    mc_bound(args, K)),
                                   ("mc_correctness", ops.mc_correctness, one,
                                    single_bound(one, K))):
            b_ms, b_by = bound_ms(*bound)
            ms, ms_source = device_ms(lambda: fn(*a, K), n=5, launches=1)
            rows.append({"name": name, "case": label, "shape": shape, "ms": ms,
                         "ms_source": ms_source, "bound_ms": b_ms, "bound_by": b_by})
        del args, one
        torch.cuda.empty_cache()
    for G, T, L, K, C in CHUNKED_CASES:
        args = lifted_inputs(G, T, L, K, C, dev)
        shape = f"G={G} T={T} L={L} K={K} C={C}"
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], kernel_error(
            "mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
            ref.mc_correctness_grouped_ref(*args, K), f"chunked launches: {shape}"))
        if C > 65535:
            one = tuple(t.contiguous() for t in single_of(args))
            errs["mc_correctness"] = max(errs["mc_correctness"], kernel_error(
                "mc_correctness", ops.mc_correctness(*one, K), ref.mc_correctness_ref(*one, K),
                f"chunked launches: T={T} L={L} C={C} K={K}"))
    return rows


def check_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref

    errs = {"belief_aggregate": 0.0, "mc_correctness_grouped": 0.0, "mc_correctness": 0.0}
    for rows_b, T, K, prefix in BELIEF_CASES:
        args = belief_inputs(rows_b, T, K, prefix, seed=rows_b + K, dev=dev)
        err = kernel_error("belief_aggregate", ops.belief_aggregate(*args, K),
                           ref.belief_aggregate_ref(*args, K),
                           f"rows={args[0].shape[0]} M={T} K={K}")
        errs["belief_aggregate"] = max(errs["belief_aggregate"], err)
    for G, L, K in GROUPED_CASES:
        args = mc_inputs(G, 16384, L, K, 3, seed=G * 100 + K + L, dev=dev)
        err = kernel_error("mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
                           ref.mc_correctness_grouped_ref(*args, K),
                           f"G={G} C=3 T=16384 L={L} K={K}")
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], err)
    for T, L, C, K, label in single_cases():
        args = single_inputs(T, L, C, K, seed=T + C + K, dev=dev)
        err = kernel_error("mc_correctness", ops.mc_correctness(*args, K),
                           ref.mc_correctness_ref(*args, K), f"{label}: T={T} L={L} C={C} K={K}")
        errs["mc_correctness"] = max(errs["mc_correctness"], err)
    single = single_inputs(8471, 12, 12, 4, seed=3, dev=dev)
    grouped = mc_inputs(1, 16384, 12, 4, 3, seed=4, dev=dev)
    belief = belief_inputs(64, 10, 4, True, seed=5, dev=dev)
    one_launch("mc_correctness", lambda: ops.mc_correctness(*single, 4))
    one_launch("mc_correctness_grouped", lambda: ops.mc_correctness_grouped(*grouped, 4))
    one_launch("belief_aggregate", lambda: ops.belief_aggregate(*belief, 4))
    errs["lifted"] = check_lifted(dev, errs)
    return errs


def one_launch(name: str, fn) -> None:
    """One call of ``fn`` (inputs on the card, kernel built) under
    ``torch.profiler``: raises unless the trace shows exactly one kernel
    launch and the call allocates nothing beyond its outputs (each one
    block of the caching allocator, a multiple of 512 bytes)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    outs = out if isinstance(out, tuple) else (out,)
    out_bytes = [t.numel() * t.element_size() for t in outs]
    allowed = sum(-(-b // 512) * 512 for b in out_bytes)
    rows = [(e.key, e.count) for e in device_events(prof)]
    log(f"  {name}: one call = kernel rows {rows}, {grown} bytes allocated "
        f"(outputs {out_bytes} bytes)")
    if len(rows) != 1 or rows[0][1] != 1 or grown > allowed:
        raise AssertionError(f"{name}: one call must be one launch and its output allocations, "
                             f"got kernel rows {rows} and {grown} bytes")


# ---------------------------------------------------------------------------
# Phases 4-5: route on the card, hold it against the CPU
# ---------------------------------------------------------------------------


def serve_state(K: int, seed: int = 0, num_arms: int = 12):
    """The serve defaults: a 12-arm oracle pool over 6 clusters, calibrated
    from 2000 historical responses (``num_arms`` arms where given)."""
    from repro_torch import convert
    from repro_torch.core.clustering import kmeans
    from repro_torch.data.synth import OracleWorkload

    wl = OracleWorkload(num_classes=K, num_clusters=6, num_arms=num_arms, seed=seed)
    table, emb, _ = wl.response_table(2000, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    arms = [{"name": f"llm-{i}", "arm_index": i, "seed": 9, "metered": False}
            for i in range(num_arms)]
    return wl, convert.workload_state(wl), {"table": table, "emb": emb, "assign": assign}, arms


def batches(wl, n: int, seed: int):
    """``n`` (queries, embeddings, budgets) batches of 64: the first uniform
    at 1e-4 USD, the rest with per-query budgets from {3e-5, 1e-4, 3e-4}."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cid, emb, lab = wl.sample_queries(64, rng)
        budget = 1e-4 if i == 0 else rng.choice([3e-5, 1e-4, 3e-4], size=64)
        out.append((np.stack([cid, lab], 1), emb, budget))
    return out


def route_all(router, work):
    """Route every batch on the device plane, then the last one again on the
    host reference plane; returns the RouteResults."""
    res = [router.route_batch(q, e, b) for q, e, b in work]
    q, e, b = work[-1]
    res.append(router.route_batch_reference(q, e, b))
    return res


def compare_plans(gpu, cpu) -> None:
    """The two routers' plans, bitwise: sets, xi, cost, p* and gamma."""
    if gpu.selector._cache.keys() != cpu.selector._cache.keys():
        raise AssertionError("the two devices planned different (p, K, budget) pairs")
    for key, s in gpu.selector._cache.items():
        c = cpu.selector._cache[key]
        same_sets = (np.array_equal(s.chosen, c.chosen) and s.l_star == c.l_star
                     and (s.s1 is None) == (c.s1 is None)
                     and (s.s1 is None or (np.array_equal(s.s1, c.s1) and np.array_equal(s.s2, c.s2))))
        xi = np.array([s.xi_est, s.xi_s1, s.xi_s2])
        xi_c = np.array([c.xi_est, c.xi_s1, c.xi_s2])
        ok = (same_sets and np.array_equal(xi, xi_c) and s.cost == c.cost
              and s.p_star == c.p_star and s.gamma_s2 == c.gamma_s2)
        if not ok:
            raise AssertionError(
                f"plan mismatch at budget {key[2]}: card chosen={s.chosen} s1={s.s1} s2={s.s2} "
                f"xi={xi.tolist()} / cpu chosen={c.chosen} s1={c.s1} s2={c.s2} xi={xi_c.tolist()}"
            )


def compare_routes(gpu_res, cpu_res) -> None:
    """The two routers' results, bitwise."""
    for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
        for field in ("predictions", "schedule", "invoked", "responses", "costs", "planned_costs"):
            a, b = getattr(g, field), getattr(c, field)
            if not np.array_equal(a, b):
                rows = np.flatnonzero((np.asarray(a) != np.asarray(b)).reshape(len(a), -1).any(1))
                raise AssertionError(
                    f"batch {i}: {field} differ at rows {rows[:10].tolist()}: "
                    f"card {np.asarray(a)[rows[:3]].tolist()} cpu {np.asarray(b)[rows[:3]].tolist()}"
                )
        err = float(np.abs(g.beliefs - c.beliefs).max())
        if not np.array_equal(g.beliefs, c.beliefs):
            rows = np.flatnonzero((g.beliefs != c.beliefs).any(1))
            raise AssertionError(
                f"batch {i}: beliefs differ (max {err:.3g}) at rows {rows[:10].tolist()}"
            )
        if not np.all(np.isfinite(g.beliefs)):
            raise AssertionError(f"batch {i}: non-finite beliefs")


def route_phase(dev) -> dict:
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=4)
    work = batches(wl, 3, seed=42)
    shapes = {}
    for use_kernel in (False, True):
        results = {}
        routers = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            router = convert.router_from_state(
                state, history, arms, 4, eps=0.1, delta=0.01, use_kernel=use_kernel, device=where,
            )
            results[label] = route_all(router, work)
            torch.cuda.synchronize()
            routers[label] = router
            log(f"  use_kernel={use_kernel} {label}: 4 routes of 64 in "
                f"{time.perf_counter() - t0:.2f} s")
        compare_plans(routers["card"], routers["cpu"])
        compare_routes(results["card"], results["cpu"])
        log(f"  use_kernel={use_kernel}: card == cpu (bitwise), "
            f"{len(routers['card'].selector._cache)} plans, "
            f"accuracy {np.mean([np.mean(r.predictions == w[0][:, 1]) for r, w in zip(results['card'], work + work[-1:])]):.3f}")
        if use_kernel:
            # the shapes the kernel plane gave each kernel
            card = routers["card"]
            T_main = max(r.schedule.shape[1] for r in results["card"][:-1])
            thetas = [card.selector.theta(card.estimator.clusters[c].p_hat, b)
                      for c in card.estimator.clusters for b in (3e-5, 1e-4, 3e-4)]
            shapes = {"belief_T": T_main, "mc_theta": max(thetas)}
    return shapes


def k77_phase(dev) -> None:
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=77, seed=1)
    router = convert.router_from_state(state, history, arms, 77, eps=0.1, delta=0.01,
                                       use_kernel=True, device=dev)
    (q, e, b), = batches(wl, 2, seed=7)[1:]
    res = router.route_batch(q, e, b)
    torch.cuda.synchronize()
    ok = (res.beliefs.shape == (64, 77) and np.all(np.isfinite(res.beliefs))
          and np.all((res.predictions >= 0) & (res.predictions < 77))
          and np.all(res.costs <= np.asarray(b) + 1e-15))
    if not ok:
        raise AssertionError("K=77 route gave malformed output")
    log(f"  K=77: 64 queries routed, accuracy {np.mean(res.predictions == q[:, 1]):.3f}, "
        f"mean cost {res.costs.mean():.3e}, {len(router.selector._cache)} plans")


def route_times(dev) -> dict:
    """Host-clock time of one 64-query route on the card, each ending in a
    synchronize: cold (its plans are built in the call) and warm (plans
    cached; median of 5), for a uniform and a mixed-budget batch on both
    belief backends."""
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=4)
    out = {}
    for use_kernel in (False, True):
        router = convert.router_from_state(state, history, arms, 4, eps=0.1, delta=0.01,
                                           use_kernel=use_kernel, device=dev)
        for label, (q, e, b) in zip(("uniform", "mixed"), batches(wl, 2, seed=43)):
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                router.route_batch(q, e, b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_{'kernel' if use_kernel else 'f64'}"] = {
                "cold_ms": times[0], "warm_ms": float(np.median(times[1:])),
            }
    return out


# ---------------------------------------------------------------------------
# Phases 7-10: the LM arms — kernels, models card vs CPU, the LM-arm route
# ---------------------------------------------------------------------------


def _randn(shape, gen, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev).mul_(scale)


def flash_inputs(B, S, T, H, G, hd, dtype, seed, dev, dv=None):
    """q, k and v; v's head dim ``dv`` (default ``hd``) may be narrower."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(_randn(s, gen, dev).to(dtype)
                 for s in ((B, S, H, hd), (B, T, G, hd), (B, T, G, hd if dv is None else dv)))


def rglru_inputs(B, S, D, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, S, D), gen, dev, 0.5).abs_().neg_(), _randn((B, S, D), gen, dev),
            _randn((B, D), gen, dev))


def mamba_inputs(B, S, Din, N, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, S, Din), gen, dev), _randn((B, S, Din), gen, dev, 0.3).abs_().add_(0.01),
            _randn((Din, N), gen, dev, 0.5).abs_().add_(0.5).neg_(), _randn((B, S, N), gen, dev),
            _randn((B, S, N), gen, dev), _randn((Din,), gen, dev), _randn((B, Din, N), gen, dev))


def mamba_path_inputs(B, S, Din, N, R, seed, dev):
    """The SSM block's own scan arguments: bf16 x, f32 dt (the block's
    softplus adds an f32 bias), B and C as strided views of one bf16
    (B, S, R + 2N) projection, f32 A and D, no initial state."""
    x, dt, A, _, _, D, _ = mamba_inputs(B, S, Din, N, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    _, Bm, Cm = _randn((B, S, R + 2 * N), gen, dev).to(torch.bfloat16).split([R, N, N], dim=-1)
    return x.to(torch.bfloat16), dt, A, Bm, Cm, D, None


# Moonlight-16B-A3B's latent attention at the benchmark's group of 128:
# q/k 192, v 128, which the wrapper pads to 192 for one v3 launch (hd 192
# runs in its 256 template)
FLASH_MLA = ("moonlight MLA path", 128, 127, 127, 16, 16, 192, 128, 0, torch.bfloat16,
             FLASH_BF16_ATOL)
# (label, B, S, T, H, G, hd, dv, window, dtype, atol), dv v's head dim: the two path shapes in
# bf16, bf16 at ragged lengths, a small window, hd 16 / 32 / 128 and
# query / kv head ratios 1, 3 and 16, then f32 with and without windows,
# at hd 64 and 256; then head dims that are no template's (the kernels
# take hd as the row stride; bf16 pads hd 12 to 16): hd 8, 12 and 24 in
# bf16 and f32, with and without a window; then, in both dtypes, the
# other families' route shapes at B=2, hd 40 / 96 / 112, ratio 9 with
# S < T, a window that binds at ratio 4, prompts whose keys stream through
# v4's slots, and ratio 128 (tests/test_torch_kernels_cuda.py's FLASH_NEW);
# last, Moonlight's MLA path (``FLASH_MLA``), the one case with v narrower
# than q/k, which must still be one launch
FLASH_NEW = (
    ("danube route, B=2", 2, 127, 127, 32, 8, 80, 4096), ("starcoder2 route, B=2", 2, 127, 127, 36, 4, 128, 0),
    ("qwen route, B=2", 2, 127, 127, 64, 8, 128, 0), ("moonshot route, B=2", 2, 127, 127, 16, 16, 128, 0),
    ("hd 40", 2, 70, 70, 6, 2, 40, 0), ("hd 96", 2, 100, 100, 8, 2, 96, 0),
    ("hd 112", 1, 129, 129, 4, 1, 112, 0), ("ratio 9, S < T", 2, 45, 70, 18, 2, 64, 0),
    ("window 48 at ratio 4", 2, 200, 200, 8, 2, 64, 48), ("keys streamed", 1, 1100, 1100, 8, 2, 128, 0),
    ("keys streamed, window 900", 1, 1500, 1500, 4, 4, 64, 900), ("ratio 128", 1, 20, 20, 128, 1, 64, 0),
)
FLASH_CASES = (
    ("smollm path", 64, 127, 127, 9, 3, 64, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("recurrentgemma path", 64, 127, 127, 16, 1, 256, 256, 2048, torch.bfloat16, FLASH_BF16_ATOL),
    ("ragged S < T", 2, 37, 45, 4, 2, 64, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("window 5", 3, 37, 37, 6, 2, 16, 16, 5, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 32, ratio 1", 2, 70, 70, 4, 4, 32, 32, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 128, ratio 3", 1, 129, 129, 6, 2, 128, 128, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("ratio 16", 2, 127, 127, 16, 1, 64, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("f32", 2, 127, 127, 4, 2, 64, 64, 0, torch.float32, FLASH_F32_ATOL),
    ("f32", 2, 127, 127, 4, 2, 64, 64, 48, torch.float32, FLASH_F32_ATOL),
    ("f32", 1, 300, 300, 16, 1, 256, 256, 64, torch.float32, FLASH_F32_ATOL),
    ("hd 8", 2, 45, 45, 6, 2, 8, 8, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 12, window 7", 2, 45, 45, 4, 2, 12, 12, 7, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 24", 2, 70, 70, 4, 1, 24, 24, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 8", 2, 45, 45, 6, 2, 8, 8, 7, torch.float32, FLASH_F32_ATOL),
    ("hd 12", 2, 45, 45, 4, 2, 12, 12, 0, torch.float32, FLASH_F32_ATOL),
    ("hd 24", 2, 70, 70, 4, 1, 24, 24, 7, torch.float32, FLASH_F32_ATOL),
) + tuple((*case[:7], case[6], case[7], dtype, atol) for case in FLASH_NEW
          for dtype, atol in ((torch.bfloat16, FLASH_BF16_ATOL), (torch.float32, FLASH_F32_ATOL))
) + (FLASH_MLA,)
RGLRU_CASES = ((64, 127, 4096), (3, 37, 200))
MAMBA_CASES = ((64, 127, 8192, 16), (2, 37, 96, 8))
MAMBA_PATH = (64, 127, 8192, 16, 256)   # falcon-mamba-7b: B, S, d_inner, N, dt_rank
# (label, B, S, D, K, dtype, x the x-half of a (B, S, 2D) split, state, silu):
# falcon-mamba's mixer at the benchmark's group of 128 and the route's 64,
# recurrentgemma's width without the SiLU, a decode step from a state,
# S < K-1, f32, channels that do not fill 16-byte pieces
# (tests/test_torch_kernels_cuda.py's CONV)
CONV_CASES = (("falcon-mamba path, group of 128", 128, 127, 8192, 4, torch.bfloat16, True, False, True),
              ("falcon-mamba path, route of 64", 64, 127, 8192, 4, torch.bfloat16, True, False, True),
              ("recurrentgemma width", 64, 127, 4096, 4, torch.bfloat16, False, False, False),
              ("decode step", 64, 1, 8192, 4, torch.bfloat16, True, True, True),
              ("S < K-1", 3, 2, 256, 4, torch.bfloat16, True, True, True),
              ("f32", 2, 37, 200, 4, torch.float32, True, True, True),
              ("ragged channels", 2, 70, 100, 2, torch.bfloat16, True, True, True))


def conv_inputs(B, S, D, K, dtype, split, with_state, seed, dev):
    """x (the x-half of a (B, S, 2D) tensor where ``split``), w, b and the
    state (or None) of one ``causal_conv1d`` call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn((B, S, 2 * D if split else D), gen, dev).to(dtype)[..., :D]
    return (x, _randn((D, K), gen, dev, 0.5).to(dtype), _randn((D,), gen, dev, 0.1).to(dtype),
            _randn((B, K - 1, D), gen, dev).to(dtype) if with_state else None)


def conv_bound(x) -> float:
    """The least ms of one call: x read once and y written once in x's
    dtype, at the card's memory rate (its ~10 f32 operations an element
    are far below the f32 rate)."""
    return 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3


def output_error(name: str, got, want, atol: float, label: str) -> float:
    """Max abs error over a kernel's outputs against its plain version's;
    raises past ``atol`` or on a non-finite output."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  {name} {label}: max_abs_err={err:.3g}")
    if not (finite and err <= atol):
        raise AssertionError(f"{name} disagrees with its plain version at {label}: "
                             f"err {err} (atol {atol}), finite={finite}")
    return err


def check_model_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref

    errs = {"flash_attention": 0.0, "rglru_scan": 0.0, "mamba_scan": 0.0, "causal_conv1d": 0.0}
    for i, (label, B, S, T, H, G, hd, dv, w, dtype, atol) in enumerate(FLASH_CASES):
        args = flash_inputs(B, S, T, H, G, hd, dtype, seed=10 + i, dev=dev, dv=dv)
        plain = ref.flash_attention_ref(*(a.float() for a in args), window=w)   # f32 plain
        before = ops.flash_attention.launches
        got = ops.flash_attention(*args, window=w)
        shape = (f"{label} B={B} S={S} T={T} H={H} G={G} hd={hd} dv={dv} window={w} "
                 f"{str(dtype)[6:]}")
        err = output_error("flash_attention", got, plain, atol, shape)
        if ops.flash_attention.launches != before + 1 or got.shape[-1] != dv:
            raise AssertionError(f"flash_attention at {shape}: "
                                 f"{ops.flash_attention.launches - before} launches, "
                                 f"out head dim {got.shape[-1]}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    for i, (B, S, D) in enumerate(RGLRU_CASES):
        args = rglru_inputs(B, S, D, seed=20 + i, dev=dev)
        err = output_error("rglru_scan", ops.rglru_scan(*args), ref.rglru_scan_ref(*args),
                           RGLRU_ATOL, f"B={B} S={S} D={D}")
        errs["rglru_scan"] = max(errs["rglru_scan"], err)
    B, S, Din, N, R = MAMBA_PATH
    args = mamba_path_inputs(B, S, Din, N, R, seed=29, dev=dev)
    y, h_last = ops.mamba_scan(*args)
    # the plain version on an f32 copy of x gives y unrounded: the kernel's
    # bf16 y is then one rounding to nearest away, within 3e-4 + 2^-8 |y|
    wy, wh = ref.mamba_scan_ref(args[0].float(), *args[1:])
    label = f"path case B={B} S={S} Din={Din} N={N} bf16 x/B/C, strided B/C, f32 dt, no h0"
    err = output_error("mamba_scan", h_last, wh, MAMBA_ATOL, f"{label}: h_last")
    y_err = (y.float() - wy).abs()
    y_ok = bool((y_err <= MAMBA_ATOL + BF16_ROUNDING * wy.abs()).all())
    log(f"  mamba_scan {label}: y max_abs_err={float(y_err.max()):.3g} "
        f"(y {y.dtype} against the unrounded f32 y, within 3e-4 + 2^-8 |y|: {y_ok})")
    if not (y_ok and y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())):
        raise AssertionError(f"mamba_scan disagrees with its plain version at {label}: "
                             f"y err {float(y_err.max())}")
    errs["mamba_scan"] = max(errs["mamba_scan"], err, float(y_err.max()))
    for i, (B, S, Din, N) in enumerate(MAMBA_CASES):
        args = mamba_inputs(B, S, Din, N, seed=30 + i, dev=dev)
        err = output_error("mamba_scan", ops.mamba_scan(*args), ref.mamba_scan_ref(*args),
                           MAMBA_ATOL, f"f32 B={B} S={S} Din={Din} N={N} with h0")
        errs["mamba_scan"] = max(errs["mamba_scan"], err)
    for i, (label, B, S, D, K, dtype, split, with_state, silu) in enumerate(CONV_CASES):
        x, w, b, state = conv_inputs(B, S, D, K, dtype, split, with_state, seed=50 + i, dev=dev)
        got = ops.causal_conv1d(x, w, b, state, silu=silu)
        want = ref.causal_conv1d_ref(x, w, b, state, silu=silu)
        torch.cuda.synchronize()
        log(f"  causal_conv1d {label} B={B} S={S} D={D} K={K} {str(dtype)[6:]} silu={silu}: "
            f"bitwise {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"causal_conv1d differs from its plain version at {label}")
    # one tap of weight 1, zero bias: every bf16 value through the SiLU
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=dev).to(torch.int16)
    x = x.view(torch.bfloat16).reshape(2, 4, 8192)
    w, b = torch.ones(8192, 1, device=dev), torch.zeros(8192, device=dev)
    same = torch.equal(ops.causal_conv1d(x, w, b, silu=True).view(torch.int16),
                       ref.causal_conv1d_ref(x, w, b, silu=True).view(torch.int16))
    log(f"  causal_conv1d SiLU of every bf16 value: bitwise {same}")
    if not same:
        raise AssertionError("causal_conv1d's SiLU differs from the plain version's on some bf16 value")
    return errs


def unit_config(arch: str):
    """The published config in f32, cut to one pattern unit of depth (width
    untouched) so that its CPU forward takes seconds."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=len(cfg.block_pattern), dtype="float32")


@contextlib.contextmanager
def router_inputs():
    """Record each MoE layer's router input and weight (``moe_mlp``'s first
    two arguments) while it runs; the list is yielded."""
    from repro_torch.models import blocks

    seen, plain = [], blocks.moe_mlp

    def spy(x, router_w, *rest):
        seen.append((x, router_w.detach().clone()))     # the model may move its weights after
        return plain(x, router_w, *rest)

    blocks.moe_mlp = spy
    try:
        yield seen
    finally:
        blocks.moe_mlp = plain


def expert_agreement(card: list, cpu: list, k: int) -> dict:
    """The top-k expert ids of each MoE layer's tokens, from the router
    inputs the card and the CPU forwards recorded: how many tokens pick the
    same experts in the same order, and the smallest gap between the k-th
    and (k+1)-th f32 router logit on the CPU (a flip needs the two sums to
    differ by more than it)."""
    from repro_torch.models import router_topk

    same = total = 0
    gap = float("inf")
    with torch.inference_mode():
        for (xg, wg), (xc, wc) in zip(card, cpu):
            ids_g, _ = router_topk(xg.float() @ wg.float(), k)
            logits = xc.float() @ wc.float()
            ids_c, _ = router_topk(logits, k)
            same += int((ids_g.cpu() == ids_c).all(dim=1).sum())
            total += ids_c.shape[0]
            top = torch.sort(logits, dim=-1, descending=True).values
            gap = min(gap, float((top[:, k - 1] - top[:, k]).min()))
    return {"tokens_same_experts": same, "tokens": total, "min_topk_gap": gap}


def model_phase(dev, archs=ARCHS, seed: int = 7) -> dict:
    """Each family's one-unit f32 model: the same weights forward on the
    card (the kernels) and on the CPU (their plain versions); frontend
    archs take frontend embeddings, MoE archs report their expert ids'
    agreement."""
    from repro_torch.models import LM

    out = {}
    for i, arch in enumerate(archs):
        cfg = unit_config(arch)
        t0 = time.perf_counter()
        model = LM(cfg, device=dev, seed=seed + i)
        rng = np.random.default_rng(seed + i)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 127)))
        fe = (torch.as_tensor(rng.normal(0, 1, (2, cfg.frontend_len, cfg.d_model)), dtype=torch.float32)
              if cfg.frontend != "none" else None)
        S = 127 + (0 if fe is None else fe.shape[1])
        with torch.inference_mode(), router_inputs() as seen:
            got = model(tokens.to(dev), None if fe is None else fe.to(dev)).cpu()
            n_card = len(seen)
            model.to("cpu")                          # the same weights, on the CPU
            want = model(tokens, fe)
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and got.shape == (2, S, want.shape[-1])
        experts = (expert_agreement(seen[:n_card], seen[n_card:], cfg.experts_per_token)
                   if cfg.num_experts else None)
        log(f"  {arch} {cfg.layer_types} f32{' with frontend' if fe is not None else ''}: logits "
            f"{tuple(got.shape)} card vs cpu max_abs_err={err:.3g} (|logit| <= "
            f"{float(want.abs().max()):.3g}) in {time.perf_counter() - t0:.1f} s"
            + (f"; experts {json.dumps(experts)}" if experts else ""))
        if not (ok and err <= LOGITS_ATOL):
            raise AssertionError(f"{arch}: card logits differ from the CPU's by {err} "
                                 f"(atol {LOGITS_ATOL}), finite/shape ok={ok}")
        out[arch] = {"max_abs_err": err, **({"experts": experts} if experts else {})}
        del model, seen
    torch.cuda.empty_cache()
    return out


def token_embed(tokens, vocab: int) -> np.ndarray:
    """The bincount query embedding of ``examples/train_and_serve.py``."""
    return np.stack([np.bincount(t, minlength=vocab) for t in tokens]).astype(float)


def lm_route_phase(dev, archs=ARCHS, seed: int = 100) -> dict:
    """Full-width bf16 arms of ``archs`` on the card, calibrated on a 256-query
    history and routed over two 64-query batches with ``use_kernel=True``;
    ``belief_aggregate`` and every model kernel the arms' layers run
    (``needed_kernels``) must launch.
    The launch counters are zeroed before and read after calibration and the
    two routes; the checks that follow run after the read.

    Arms with random weights answer at chance (1/K), where SurGreedy's plan
    stops before its first wave and no arm would run inside a route. So the
    calibration table scores each arm against the arms' own answers in turn
    (history query i takes arm i mod 3's answer): every arm calibrates above
    chance and the routes invoke arms wave by wave (query i takes arm i mod
    the pool's size). Accuracy against the
    task's labels is printed beside it (near 1/K: a smoke, not a quality
    check)."""
    from repro_torch.configs import get_config
    from repro_torch.core.estimation import SuccessProbEstimator
    from repro_torch.data import make_token_task
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.serving import LMArm, PoolEngine, ThriftRouter

    K, SEQ, VOCAB, N_HIST = 4, 128, 512, 256
    t0 = time.perf_counter()
    cls_ids = make_token_task(K, SEQ, VOCAB, n=1, seed=0)["class_token_ids"]
    arms = [LMArm(arch, LM(get_config(arch), device=dev, seed=seed + i), cls_ids,
                  tokens_per_query=SEQ) for i, arch in enumerate(archs)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  init: {sum(p.numel() for a in arms for p in a.model.parameters()) / 1e9:.2f} B "
        f"bf16 params on the card in {init_s:.1f} s; prices "
        + ", ".join(f"{a.name} {a.cost:.3e}" for a in arms))
    hist = make_token_task(K, SEQ, VOCAB, n=N_HIST, seed=1)
    test = make_token_task(K, SEQ, VOCAB, n=128, seed=2)
    emb = token_embed(hist["tokens"], VOCAB)
    assign = np.zeros(N_HIST, np.int64)
    costs = np.array([a.cost for a in arms])
    rng = np.random.default_rng(5)
    work = [
        (test["tokens"][:64], token_embed(test["tokens"][:64], VOCAB), float(costs.sum())),
        (test["tokens"][64:], token_embed(test["tokens"][64:], VOCAB),
         rng.choice(np.linspace(costs.min(), costs.sum(), 4), size=64)),
    ]

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    answers = np.zeros((N_HIST, len(arms)), np.int64)
    fwd_ms = {}
    for a, arm in enumerate(arms):
        times = []
        for lo in range(0, N_HIST, 64):
            t1 = time.perf_counter()
            answers[lo:lo + 64, a] = arm.classify_batch(hist["tokens"][lo:lo + 64])  # ends in a sync
            times.append((time.perf_counter() - t1) * 1e3)
        fwd_ms[arm.name] = float(np.median(times[1:]))
    rows = np.arange(N_HIST)
    table = (answers == answers[rows, rows % len(arms)][:, None]).astype(np.float64)
    router = ThriftRouter(PoolEngine(arms), SuccessProbEstimator(table, emb, assign), K,
                          use_kernel=True, device=dev)
    results = [router.route_batch(q, e, b) for q, e, b in work]
    torch.cuda.synchronize()
    launches = {
        "flash_attention": ops.flash_attention.launches, "rglru_scan": ops.rglru_scan.launches,
        "mamba_scan": ops.mamba_scan.launches, "causal_conv1d": ops.causal_conv1d.launches,
        "belief_aggregate": ops.belief_aggregate.launches,
        "mc_correctness_grouped": ops.mc_correctness_grouped.launches,
    }
    main_s = time.perf_counter() - t0
    log(f"  calibrate (256 queries x {len(arms)} arms) + 2 routes of 64 in {main_s:.1f} s; "
        f"launches {launches}")
    for name in needed_kernels(archs) | {"belief_aggregate"}:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the LM-arm route")
    for a, arm in enumerate(arms):
        log(f"  {arm.name}: history accuracy {np.mean(answers[:, a] == hist['labels']):.3f} "
            f"(K={K}, random weights), calibrated p {table[:, a].mean():.3f}, "
            f"forward of 64 queries {fwd_ms[arm.name]:.1f} ms (median of 3)")
    if sum(int(r.arm_query_counts.sum()) for r in results) == 0:
        raise AssertionError("the LM-arm routes invoked no arm")
    for i, ((q, e, b), res) in enumerate(zip(work, results)):
        labels = test["labels"][64 * i:64 * (i + 1)]
        if not (np.all(res.costs <= np.asarray(b) + 1e-15)
                and np.all((res.predictions >= 0) & (res.predictions < K))
                and np.all(np.isfinite(res.beliefs))):
            raise AssertionError(f"LM batch {i}: cost over budget or malformed output")
        log(f"  batch {i} ({'uniform' if i == 0 else 'mixed'} budget): accuracy "
            f"{np.mean(res.predictions == labels):.3f}, served per arm "
            f"{res.arm_query_counts.tolist()}, mean cost {res.costs.mean():.3e}, waves {res.waves}")
    # the same batches again on the card, and on a router that plans on the CPU
    cpu_router = ThriftRouter(PoolEngine(arms), SuccessProbEstimator(table, emb, assign), K,
                              use_kernel=True, device="cpu")
    for i, ((q, e, b), res) in enumerate(zip(work, results)):
        again = router.route_batch(q, e, b)
        cpu_router.route_batch(q, e, b)
        if not (np.array_equal(again.predictions, res.predictions)
                and np.array_equal(again.costs, res.costs)):
            raise AssertionError(f"LM batch {i}: routing it twice gave different answers")
    compare_plans(router, cpu_router)
    log(f"  routes repeat exactly; {len(router.selector._cache)} plans equal the CPU planner's "
        f"bitwise")
    sched_launches = lm_scheduler_check(router, work, results, archs)
    lm_fault_check(router, arms, work[1])
    breakdown = {arm.name: forward_breakdown(arm, work[0][0]) for arm in arms}
    for name, b in breakdown.items():
        log(f"  {name} forward breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in b.items()))
    del arms, router, cpu_router
    torch.cuda.empty_cache()
    return {"launches": launches, "forward_ms": fwd_ms, "init_s": init_s, "main_s": main_s,
            "breakdown": breakdown, "scheduler_launches": sched_launches}


def admission_groups(budgets, n: int):
    """Row groups of one admission of ``n`` rows as the scheduler splits it:
    one group per budget, in first-occurrence order, FIFO inside."""
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    if (budgets == budgets[0]).all():
        return [np.arange(n)]
    _, first = np.unique(budgets, return_index=True)
    return [np.flatnonzero(budgets == budgets[i]) for i in np.sort(first)]


def lm_scheduler_check(router, work, results, archs) -> dict:
    """The LM-arm route's two batches through a ``BatchScheduler``
    (``max_batch`` 64, ``max_inflight`` 2, no faults, no labels): with
    nothing to fold, each admission group routes as the router routes that
    group alone, so predictions, costs and stop waves equal the router's
    own routes of the same groups (the uniform batch: its route above).
    Returns the model kernels' launches of the scheduler's run;
    ``belief_aggregate`` and the kernels the layers of ``archs`` run must
    have launched."""
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchScheduler

    ops.reset_launch_counts()
    sched = BatchScheduler(router, max_batch=64, max_inflight=2, max_wait_s=0.0)
    blocks = [sched.submit_many(q, e, b) for q, e, b in work]
    sched.drain()
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in
                (*MODEL_KERNELS, "belief_aggregate")}
    for i, ((q, e, b), blk) in enumerate(zip(work, blocks)):
        want = np.zeros((3, q.shape[0]))
        for rows in admission_groups(b, q.shape[0]):
            res = (results[i] if rows.size == q.shape[0]
                   else router.route_batch(q[rows], e[rows], np.asarray(b)[rows]))
            want[:, rows] = res.predictions, res.costs, res.stop_waves
        got = np.stack([blk.predictions, blk.costs, blk.stop_waves])
        if not np.array_equal(got, want):
            bad = np.flatnonzero((got != want).any(axis=0))
            raise AssertionError(f"LM batch {i} through the scheduler differs from the router's "
                                 f"routes at rows {bad[:10].tolist()}")
    st = sched.stats
    log(f"  scheduler (max_batch 64, max_inflight 2): both batches equal the router's routes of "
        f"their admission groups; groups {st['batches']}, planes jit={st['spec_jit']} "
        f"ref={st['spec_reference']}, inflight peak {st['inflight_peak']}; launches {launches}")
    for name in needed_kernels(archs) | {"belief_aggregate"}:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched through the scheduler")
    return launches


def lm_fault_check(router, arms, batch) -> None:
    """The mixed-budget batch (whose plans lead with the pool's first,
    cheapest arm on some rows) with faults on that arm (timeout 0.3, error
    0.2): failed cells are never invoked, so it classifies exactly the
    scheduled, unfailed cells of its arm (its forwards counted row by row);
    the failures the wavefront attempted are its alone, their slots
    re-routed in-wave, and the outputs stay well formed."""
    from repro_torch.distributed.fault import FAULT_ERROR, FAULT_TIMEOUT, FaultPolicy

    q, e, b = batch
    policy = FaultPolicy(len(arms), router.num_classes, seed=7).set_arm(0, timeout=0.3, error=0.2)
    seen = []
    plain = arms[0].classify_batch
    arms[0].classify_batch = lambda tokens: (seen.append(len(tokens)), plain(tokens))[1]
    router.engine.fault_policy = policy
    try:
        res = router.route_batch(q, e, b)
        torch.cuda.synchronize()
    finally:
        router.engine.fault_policy = None
        del arms[0].classify_batch
    sched_T = res.fault_schedule.T
    codes = policy.grid_codes(sched_T)
    failed = (codes == FAULT_TIMEOUT) | (codes == FAULT_ERROR)
    want = int(((sched_T == 0) & ~failed).sum())
    if sum(seen) != want or failed.sum() == 0 or res.arm_fault_counts[0] == 0:
        raise AssertionError(f"{arms[0].name} classified {sum(seen)} rows under faults, want {want} "
                             f"({int(failed.sum())} cells failed)")
    ok = (np.all((res.predictions >= 0) & (res.predictions < router.num_classes))
          and np.all(res.costs <= np.asarray(b) + 1e-15)
          and set(np.flatnonzero(res.arm_fault_counts).tolist()) <= {0}
          and np.all(res.responses[res.invoked] >= 0))
    if not ok:
        raise AssertionError("the faulted LM batch gave malformed output")
    name = arms[0].name
    log(f"  faults on {name}: {int(failed.sum())} of {int((sched_T == 0).sum())} {name} cells "
        f"failed, {name} classified {sum(seen)} rows in {len(seen)} forwards (= the unfailed "
        f"cells); attempted failures {res.arm_fault_counts.tolist()}, served per arm "
        f"{res.arm_query_counts.tolist()}")


MODEL_KERNELS = ("flash_attention", "rglru_scan", "mamba_scan", "causal_conv1d")
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")


def forward_breakdown(arm, tokens) -> dict:
    """Where one 64-query forward of ``arm`` spends its time: host-clock wall
    ms of a ``classify_batch`` (which ends in copying its answers to the
    host) under ``torch.profiler``, the device time of its kernels split
    into the model kernels, cuBLAS matmuls and everything else, the
    kernel launches (rows of the trace) and the device's idle share of the
    wall time."""
    prof = profiled_split(lambda: arm.classify_batch(tokens))
    parts = dict.fromkeys([*MODEL_KERNELS, "matmul", "other"], 0.0)
    for key, ms in prof["kernels_ms"].items():
        cat = next((k for k in MODEL_KERNELS if f"{k}_kernel" in key), None)
        if cat is None:
            cat = "matmul" if any(m in key.lower() for m in GEMM_MARKS) else "other"
        parts[cat] += ms
    return {**{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share", "launches")},
            **{f"{k}_ms": v for k, v in parts.items()}}


def flash_bound(q, k, window: int, dv: int = 0):
    """(bytes, operations) of one causal attention launch: q, k, v read once
    and out written once; 2 (hd + dv) flops per visible (query, key) pair,
    v's head dim ``dv`` (default hd) in v and out."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    dv = dv or hd
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(S, np.int64)
    pairs = int((np.minimum(i + 1, T) - lo).clip(min=0).sum())
    nbytes = (q.numel() * (hd + dv) // hd + k.numel() * (hd + dv) // hd) * q.element_size()
    return nbytes, 2.0 * (hd + dv) * pairs * B * H


def sdpa_ms(q, k, v, window: int = 0):
    """The yardstick: one ``scaled_dot_product_attention`` call on the same
    tensors (causal, GQA; a window that binds, ``0 < window < S``, as a
    boolean ``attn_mask``); timed here only, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if 0 < window < q.shape[1]:
        i = torch.arange(q.shape[1], device=q.device)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        return device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                                enable_gqa=True))[0]
    return device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True))[0]


# The earlier kernels' device ms at the same shapes, as PERF.md section 6
# records them (NVIDIA H100 80GB HBM3, 700.00 W), keyed "kernel shape
# [earlier design]": flash v2 (f32 products on the CUDA cores) per path
# shape, and flash v3 (a block per query head, hd 80 padded to 128) at the
# route shapes, the training shape and danube's binding window, where v4
# (a block per kv head) now runs the GQA families; mamba_scan v1 (accurate
# expf, f32 in and out, the casts outside the kernel), the two
# mc_correctness kernels before their redesign (two launches, tie counts
# and combine; one block per (group, candidate)), and belief_aggregate's
# first design (one warp a row, a loop of broadcast loads).
EARLIER_MS = {"flash_attention smollm path [v2]": 0.20470094999999994,
              "flash_attention recurrentgemma path [v2]": 1.4304699499999998,
              "flash_attention smollm path [v3]": 0.0149703,
              "flash_attention recurrentgemma path [v3]": 0.0820508,
              "flash_attention h2o-danube-1.8b path [v3]": 0.26228615,
              "flash_attention starcoder2-7b path [v3]": 0.09743475,
              "flash_attention qwen1.5-110b path [v3]": 0.167616,
              "flash_attention moonshot-v1-16b-a3b path [v3]": 0.0509394,
              "flash_attention h2o-danube-1.8b window [v3]": 0.6821789,
              "flash_attention smollm-135m training [v3]": 0.00841235,
              "mamba_scan [v1]": 0.7823275999999999,
              "mc_correctness [two launches]": 0.007682000000000028,
              "mc_correctness_grouped [two launches]": 0.06899614999999994,
              "belief_aggregate [a warp a row]": 0.0021225999999999997}
EARLIER_FROM = "recorded in PERF.md section 6 (not measured in this run)"


def earlier_kernels(rows: list) -> dict:
    """Each redesigned kernel's device ms in this run beside its earlier
    version's recorded ms."""
    now = {}
    for r in rows:
        now[r["name"]] = r["ms"]
        if r["name"] == "flash_attention":
            shapes = r["by_shape"] + r.get("families", {}).get("by_shape", [])
            now.update({f"flash_attention {s['shape'].split(':')[0]}": s["ms"] for s in shapes})
            if "training_shape" in r:
                now["flash_attention smollm-135m training"] = r["training_shape"]["ms"]
    return {k: {"ms": now.get(k.split(" [")[0]), "earlier_ms": v, "earlier_from": EARLIER_FROM}
            for k, v in EARLIER_MS.items()}


def wide_row(fn, args, bound_of, shape: str) -> dict:
    """An ``mc_correctness`` kernel on the wide kernel's path (L=64 arms):
    bitwise its plain version, device ms and ``call_ms``, beside its
    bound."""
    from repro_torch.kernels import ref

    K = 4
    plain = getattr(ref, f"{fn.__name__}_ref")
    kernel_error(fn.__name__, fn(*args, K), plain(*args, K), f"{shape} (wide kernel)")
    b_ms, b_by = bound_ms(*bound_of(args, K))
    ms, ms_source = device_ms(lambda: fn(*args, K), launches=1)
    return {"shape": shape, "ms": ms, "ms_source": ms_source,
            "call_ms": median_ms(lambda: fn(*args, K)), "bound_ms": b_ms, "bound_by": b_by}


def launch_floor_ms(dev) -> float:
    """Device ms of a one-element ``zero_()``: the least a launch costs."""
    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.zero_(), n=50, launches=1)[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def mamba_bound(args):
    """(ms, by, detail) of one path-case scan: x and dt read and y written
    in their dtype, h_last written in f32, the B and C columns, A and D
    read once; against 5 f32 flops per (t, d, n) on the CUDA cores and one
    ``ex2`` per (t, d, n) at the SFU's 16 a clock per SM at the maximum SM
    clock. The largest of the three bounds it. The ``ex2`` term is the
    bound of a design that takes every exponential on the SFU: one that
    computed some by polynomial on the FMA pipes could go below it."""
    x, dt, A, Bm, Cm, D, _ = args
    B, S, Din = x.shape
    N = A.shape[1]
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * dt.element_size() + B * Din * N * 4
              + 2 * B * S * N * Bm.element_size() + A.numel() * 4 + D.numel() * D.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = 5.0 * x.numel() * N / F32_OPS_PER_S * 1e3
    clock = max_sm_clock_hz()
    t_ex2 = x.numel() * N / (SFU_EX2_PER_CLOCK_SM * H100_SMS * clock) * 1e3
    detail = {"bytes": nbytes, "bytes_ms": t_bytes, "f32_flops_ms": t_flops,
              "ex2": x.numel() * N, "ex2_ms": t_ex2, "max_sm_clock_mhz": clock / 1e6}
    return max(t_bytes, t_flops, t_ex2), ("bytes" if t_bytes >= max(t_flops, t_ex2) else "operations"), detail


def mla_flash_row(dev) -> dict:
    """Moonlight's MLA launch (``FLASH_MLA``) timed: device ms of the
    wrapper's call (v zero-padded from dv to hd, one launch, the output
    sliced back), of the padded kernel alone (v given at hd), the bytes
    bound at v's own dv, and SDPA on the same q, k and v."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    label, B, S, T, H, G, hd, dv, w, dtype, _ = FLASH_MLA
    q, k, v = flash_inputs(B, S, T, H, G, hd, dtype, seed=40, dev=dev, dv=dv)
    padded = torch.nn.functional.pad(v, (0, hd - dv))
    call = lambda: ops.flash_attention(q, k, v, window=w)           # noqa: E731
    ms, ms_source = device_ms(call)
    kernel_ms, kernel_source = device_ms(lambda: ops.flash_attention(q, k, padded, window=w),
                                         launches=1)
    plain_ms, _ = device_ms(lambda: ref.flash_attention_ref(q, k, v, window=w), n=5)
    b_ms, b_by = bound_ms(*flash_bound(q, k, w, dv), BF16_OPS_PER_S)
    before = ops.flash_attention.launches
    call()
    launches = ops.flash_attention.launches - before
    tl = fa.tiling(B, S, T, H, G, hd, dtype, True, w)
    row = {"shape": f"{label}: B={B} S={S} H={H} G={G} q/k hd={hd} v dv={dv} window={w} bf16",
           "ms": ms, "ms_source": ms_source, "kernel_ms": kernel_ms,
           "kernel_ms_source": kernel_source, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": sdpa_ms(q, k, v),
           "call_ms": median_ms(call), "launches_a_call": launches,
           "pad_or_copy_ops": pad_or_copy_ops(call), "design": tl.kernel,
           "grid": list(tl.grid), "fill_bytes": tl.fill_bytes, "device_bytes": tl.device_bytes}
    log(f"  flash_attention {row['shape']}: "
        f"{json.dumps({k_: v_ for k_, v_ in row.items() if k_ != 'shape'})}")
    if row["launches_a_call"] != 1:
        raise AssertionError(f"flash_attention at {row['shape']} counted "
                             f"{row['launches_a_call']} launches a call")
    return row


def time_model_kernels(launches: dict, errs: dict) -> list:
    """Each model kernel at the LM-arm route's shapes and dtypes (B=64
    queries, S=127): device ms (profiler), plain ms, bound ms and the
    library yardstick."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", 0)
    rows = []
    flash_shapes = []
    for label, B, S, T, H, G, hd, dv, w, dtype, _ in FLASH_CASES[:2]:
        args = flash_inputs(B, S, T, H, G, hd, dtype, seed=40, dev=dev)
        ms, ms_source = device_ms(lambda: ops.flash_attention(*args, window=w))
        plain_ms, _ = device_ms(lambda: ref.flash_attention_ref(*args, window=w), n=5)
        b_ms, b_by = bound_ms(*flash_bound(args[0], args[1], w), BF16_OPS_PER_S)
        tl = fa.tiling(B, S, T, H, G, hd, dtype, True, w)
        flash_shapes.append({"shape": f"{label}: B={B} S={S} H={H} G={G} hd={hd} window={w} bf16",
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": sdpa_ms(*args), "ms_source": ms_source,
                             "call_ms": median_ms(lambda: ops.flash_attention(*args, window=w)),
                             "rows": flash_kernel_rows(lambda: ops.flash_attention(*args, window=w)),
                             "design": tl.kernel, "grid": list(tl.grid),
                             "fill_bytes": tl.fill_bytes, "device_bytes": tl.device_bytes})
    flash_shapes.append(mla_flash_row(dev))
    main = flash_shapes[1]                 # the heavier (recurrentgemma) shape
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "launches": launches["flash_attention"], "max_abs_err": errs["flash_attention"],
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": main["shape"], "by_shape": flash_shapes,
    })
    args = rglru_inputs(64, 127, 4096, seed=41, dev=dev)
    b_ms, b_by = bound_ms((3 * args[0].numel() + 2 * args[2].numel()) * 4, 3.0 * args[0].numel())
    rows.append({
        "name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:47", "launches": launches["rglru_scan"],
        "max_abs_err": errs["rglru_scan"], "ms": device_ms(lambda: ops.rglru_scan(*args))[0],
        "plain_ms": device_ms(lambda: ref.rglru_scan_ref(*args), n=3)[0], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "shape": "B=64 S=127 D=4096",
        "call_ms": median_ms(lambda: ops.rglru_scan(*args)),
    })
    log(f"[profiler rows] rglru_scan, kernel rows of traces of 1 and 20 calls: "
        f"{json.dumps(trace_rows(lambda: ops.rglru_scan(*args)))}")
    B, S, Din, N, R = MAMBA_PATH
    args = mamba_path_inputs(B, S, Din, N, R, seed=42, dev=dev)
    b_ms, b_by, b_detail = mamba_bound(args)
    f32_args = mamba_inputs(B, S, Din, N, seed=43, dev=dev)
    rows.append({
        "name": "mamba_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:58", "launches": launches["mamba_scan"],
        "max_abs_err": errs["mamba_scan"], "ms": device_ms(lambda: ops.mamba_scan(*args))[0],
        "plain_ms": device_ms(lambda: ref.mamba_scan_ref(*args), n=3)[0], "bound_ms": b_ms,
        "bound_by": b_by, "bound_detail": b_detail, "library_ms": None,
        "bound_note": "operations: every exp on the SFU (16 ex2 a clock per SM), the rate of "
                      "this design; exps partly on the FMA pipes could go below it",
        "shape": f"B={B} S={S} Din={Din} N={N} bf16 x/B/C (B, C strided views), f32 dt, no h0",
        "call_ms": median_ms(lambda: ops.mamba_scan(*args)),
        "f32_ms": device_ms(lambda: ops.mamba_scan(*f32_args))[0],
        "f32_shape": f"B={B} S={S} Din={Din} N={N} f32, contiguous B/C, with h0",
    })
    shapes = []
    for label, B, S, D, K, dtype, split, with_state, silu in CONV_CASES[:2]:
        x, w, b, _ = conv_inputs(B, S, D, K, dtype, split, with_state, seed=44, dev=dev)
        ms, ms_source = device_ms(lambda: ops.causal_conv1d(x, w, b, silu=True), launches=1)
        plain_ms, plain_source = device_ms(lambda: ref.causal_conv1d_ref(x, w, b, silu=True), n=5)
        shapes.append({
            "shape": f"{label}: B={B} S={S} D={D} K={K} bf16, x the x-half of (B, S, 2D), SiLU",
            "ms": ms, "ms_source": ms_source, "plain_ms": plain_ms,
            "plain_ms_source": plain_source, "bound_ms": conv_bound(x), "bound_by": "bytes",
            "no_silu_ms": device_ms(lambda: ops.causal_conv1d(x, w, b), launches=1)[0],
            "call_ms": median_ms(lambda: ops.causal_conv1d(x, w, b, silu=True)),
            "plain_launches": kernel_rows(traced(lambda: ref.causal_conv1d_ref(x, w, b, silu=True),
                                                 1))[0]})
    main = shapes[0]
    rows.append({
        "name": "causal_conv1d", "route": "cuda", "source": "src/repro_torch/csrc/causal_conv1d.cu",
        "replaces": "none: the JAX package's conv is jnp (src/repro/models/ssm.py:23)",
        "launches": launches["causal_conv1d"], "max_abs_err": errs["causal_conv1d"],
        "bitwise": errs["causal_conv1d"] == 0.0,
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "no_silu_ms", "call_ms")},
        "library_ms": None, "shape": main["shape"], "by_shape": shapes,
    })
    return rows


# ---------------------------------------------------------------------------
# Phases 11-12: GreedyLLM on MC xi and the paper's baselines
# ---------------------------------------------------------------------------

SWEEP_BUDGETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3)        # examples/budget_sweep.py:31


def check_greedy(got, want, label: str) -> float:
    """GreedyLLM's (chosen, value) on the card against the CPU's: equal
    picks and values; returns the value gap (0)."""
    gap = abs(got[1] - want[1])
    if got[0] != want[0] or got[1] != want[1]:
        raise AssertionError(f"GreedyLLM {label}: card picked {got[0]} (xi {got[1]}), "
                             f"cpu {want[0]} (xi {want[1]})")
    return gap


def greedy_phase(dev) -> dict:
    """GreedyLLM on Monte-Carlo xi: the ``mc_correctness`` kernel on the card
    against the plain version on the CPU, over the same draws."""
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, gamma_value_batch, greedy, prng,
        theta_for, xi_exact,
    )

    est_of = lambda where, key, p, K, theta: McXiEstimator(
        prng.key(key, where), p, K, theta, use_kernel=True, device=where)
    cpu = torch.device("cpu")
    gap = 0.0
    # (a) Fig. 11: benchmarks/paper_benches.py::xi_vs_gamma
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    diffs = []
    for s in range(40):
        p, b = rng.uniform(0.4, 0.95, 8), rng.uniform(0.1, 0.6, 8)
        got = greedy(p, b, 1.0, est_of(dev, s, p, 4, 8000), empty_value=0.25)
        gap = max(gap, check_greedy(got, greedy(p, b, 1.0, est_of(cpu, s, p, 4, 8000),
                                                empty_value=0.25), f"Fig. 11 seed {s}"))
        s1 = got[0]
        s2, _ = greedy(p, b, 1.0, gamma_value_batch(p), empty_value=0.0)
        x1 = xi_exact(p[s1], 4, p_all=p) if s1 else 0.25
        x2 = xi_exact(p[s2], 4, p_all=p) if s2 else 0.25
        diffs.append(x1 - x2)
    fig11 = {"seeds": 40, "mean_xi_gain": float(np.mean(diffs)), "max_xi_gain": float(np.max(diffs)),
             "seconds": time.perf_counter() - t0}
    log(f"  Fig. 11: 40 seeds card == cpu picks; mean_xi_gain={fig11['mean_xi_gain']:+.4f} "
        f"max={fig11['max_xi_gain']:.4f} in {fig11['seconds']:.1f} s")
    # (b) the serve defaults, every cluster x budget; then K=77 at 5e-4
    serve = {}
    for K, budgets in ((4, SWEEP_BUDGETS), (77, (5e-4,))):
        t0 = time.perf_counter()
        wl, _, history, _ = serve_state(K)
        est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
        costs = np.asarray(wl.costs, np.float64)
        picks = 0
        for cid, cs in est.clusters.items():
            p = cs.p_hat
            theta = theta_for(0.1, 0.01, float(np.max(clip_probs(p))), 12)
            on_card, on_cpu = est_of(dev, 0, p, K, theta), est_of(cpu, 0, p, K, theta)
            for budget in budgets:
                got = greedy(p, costs, budget, on_card, empty_value=1 / K)
                gap = max(gap, check_greedy(got, greedy(p, costs, budget, on_cpu, empty_value=1 / K),
                                            f"K={K} cluster {cid} budget {budget}"))
                picks += len(got[0])
        serve[f"K={K}"] = {"clusters": len(est.clusters), "budgets": list(budgets),
                           "arms_picked": picks, "seconds": time.perf_counter() - t0}
        log(f"  serve defaults K={K}: {len(est.clusters)} clusters x {len(budgets)} budgets "
            f"card == cpu, {picks} arms picked, in {serve[f'K={K}']['seconds']:.1f} s")
    return {"fig11": fig11, "serve": serve, "max_gap": gap}


def greedy_times(dev) -> dict:
    """Host-clock time of one GreedyLLM selection on the card, ending in its
    last host copy (median of 5 after one warm-up), at the serve defaults'
    longest one: the cluster with the most draws at the largest budget. With
    the kernel and with the plain version on the card; one profiled selection
    with the kernel (device ms by kernel, idle share); and the kernel's
    first-round shape there, at which phase 11's kernel row is timed."""
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, greedy, prng, theta_for,
    )

    wl, _, history, _ = serve_state(4)
    est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
    costs = np.asarray(wl.costs, np.float64)
    p = max((cs.p_hat for cs in est.clusters.values()),
            key=lambda q: theta_for(0.1, 0.01, float(np.max(clip_probs(q))), 12))
    theta = theta_for(0.1, 0.01, float(np.max(clip_probs(p))), 12)
    budget = SWEEP_BUDGETS[-1]
    out = {"theta": theta, "budget": budget}
    for use_kernel in (True, False):
        xi = McXiEstimator(prng.key(0, dev), p, 4, theta, use_kernel=use_kernel, device=dev)
        sizes = []
        fn = lambda m: (sizes.append(len(m)), xi(m))[1]
        times = []
        for _ in range(6):
            sizes.clear()
            t0 = time.perf_counter()
            greedy(p, costs, budget, fn, empty_value=0.25)
            times.append((time.perf_counter() - t0) * 1e3)
        out["kernel_ms" if use_kernel else "plain_ms"] = float(np.median(times[1:]))
        out["rounds"] = len(sizes)
        if use_kernel:
            out["profiled"] = profiled_split(lambda: greedy(p, costs, budget, xi, empty_value=0.25))
            C = sizes[0]
            masks = np.zeros((C, 12), np.float32)
            masks[np.arange(C), np.flatnonzero(costs <= budget + 1e-15)] = 1.0
            out["args"] = (xi._responses, torch.as_tensor(masks, device=dev), xi._w, xi._empty)
    return out


def sweep_phase(dev) -> dict:
    """The budget sweep at the example's defaults with the router on the card
    and on the CPU: every column equal, budget-aware columns within budget."""
    from repro_torch import budget_sweep

    runs, secs = {}, {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        runs[label] = budget_sweep.sweep(device=where)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    card, cpu = runs["card"], runs["cpu"]
    for budget, cols in card["rows"].items():
        for col, (acc, cost) in cols.items():
            want = cpu["rows"][budget][col]
            if (float(acc), float(cost)) != (float(want[0]), float(want[1])):
                raise AssertionError(f"sweep {col} at {budget}: card ({acc}, {cost}) "
                                     f"cpu ({want[0]}, {want[1]})")
            if not (0.0 <= acc <= 1.0 and cost <= budget * (1 + 1e-12)):
                raise AssertionError(f"sweep {col} at {budget}: accuracy {acc}, mean cost {cost}")
    if card["blender"] != cpu["blender"]:
        raise AssertionError(f"sweep blender: card {card['blender']} cpu {cpu['blender']}")
    table = {f"{b:g}": {c: [float(a), float(m)] for c, (a, m) in cols.items()}
             for b, cols in card["rows"].items()}
    table["blender"] = [float(x) for x in card["blender"]]
    log(f"  card == cpu on every column; card {secs['card']:.1f} s, cpu {secs['cpu']:.1f} s")
    log(f"[sweep] {json.dumps(table)}")
    return {"card_s": secs["card"], "cpu_s": secs["cpu"]}


# ---------------------------------------------------------------------------
# Phase 13: a 40-arm pool, past the register kernels' 32 arms
# ---------------------------------------------------------------------------

WIDE_ARMS = 40
WIDE_BUDGETS = (1e-5, 1e-4)


def wide_pool_phase(dev) -> None:
    """The serve defaults over a 40-arm oracle pool at K=4 with
    ``use_kernel=True``: a uniform-budget and a mixed-budget batch of 64
    (the mixed one plans serially, scoring candidates with
    ``mc_correctness_grouped`` over 40 arms), each on the card and on the
    CPU, plans, predictions, schedules, costs and beliefs bitwise; then
    GreedyLLM with ``McXiEstimator(use_kernel=True)`` over the same 40
    arms (the cluster with the most draws, at two budgets), picks and xi
    card vs CPU."""
    from repro_torch import convert
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, greedy, prng, theta_for,
    )

    K = 4
    wl, state, history, arms = serve_state(K, num_arms=WIDE_ARMS)
    work = batches(wl, 2, seed=44)
    results, routers = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        routers[label] = convert.router_from_state(
            state, history, arms, K, eps=0.1, delta=0.01, use_kernel=True, device=where,
        )
        results[label] = route_all(routers[label], work)
        torch.cuda.synchronize()
        log(f"  {WIDE_ARMS} arms {label}: 3 routes of 64 in {time.perf_counter() - t0:.2f} s")
    compare_plans(routers["card"], routers["cpu"])
    compare_routes(results["card"], results["cpu"])
    card = results["card"]
    log(f"  {WIDE_ARMS} arms: card == cpu (bitwise), {len(routers['card'].selector._cache)} plans, "
        f"waves {[r.schedule.shape[1] for r in card]}, arms served "
        f"{int((card[1].arm_query_counts > 0).sum())}, accuracy "
        f"{np.mean([np.mean(r.predictions == w[0][:, 1]) for r, w in zip(card, work + work[-1:])]):.3f}")
    est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
    costs = np.asarray(wl.costs, np.float64)
    theta_of = lambda q: theta_for(0.1, 0.01, float(np.max(clip_probs(q))), WIDE_ARMS)
    p = max((cs.p_hat for cs in est.clusters.values()), key=theta_of)
    picks = {}
    for budget in WIDE_BUDGETS:
        got, want = (greedy(p, costs, budget,
                            McXiEstimator(prng.key(0, where), p, K, theta_of(p), use_kernel=True,
                                          device=where), empty_value=1 / K)
                     for where in (dev, torch.device("cpu")))
        check_greedy(got, want, f"{WIDE_ARMS} arms, budget {budget}")
        picks[budget] = (len(got[0]), got[1])
    log(f"  GreedyLLM over {WIDE_ARMS} arms (theta {theta_of(p)}): card == cpu, "
        f"(arms picked, xi) by budget {picks}")


# ---------------------------------------------------------------------------
# Phase 14: the continuous-batching scheduler at the serve defaults
# ---------------------------------------------------------------------------

SERVE_QUERIES = 500              # launch/serve.py --queries
SERVE_BUDGET = 1e-4              # --budget
SERVE_FAULT_RATE = 0.1           # --fault-rate: split 50/30/20 over timeout/error/degrade
SERVE_DRIFT_AFTER = 250          # --drift-after
SERVE_PROBE_RATE = 0.02          # --probe-rate
SERVE_TIERS = (2.5e-5, 5e-5, 1e-4)   # the ledger's downgrade ladder
LEDGER_SHARE = 0.8               # the limited tenant's share of its unlimited spend


def serve_stream(where, use_kernel: bool, limit, stream, replicas: int = 0,
                 placement=None, mixed_by: str = "flush") -> dict:
    """``launch/serve.py --queries 500 --budget 1e-4 --fault-rate 0.1
    --drift-after 250 --probe-rate 0.02`` at ``--qps 0`` (the floodgates)
    on the port, with a ``CostLedger`` whose tenant "acme" (every other
    request) is limited to ``limit`` USD (None: unlimited): fresh workload,
    pool, fault policy and estimator; blocks of ``max_batch`` submitted and
    drained in turn, their labels recorded, the truth drifted after 250
    queries; then one mixed-budget block of 64 (budgets the 0.3 and 0.8
    cost quantiles x 2.5) admitted by ``flush()`` (``mixed_by="flush"``,
    one heterogeneous route whose plan misses plan serially) or by
    ``drain()`` (one budget group each; a ``ReplicaSet`` has no
    ``flush``). ``replicas`` > 0 serves through a ``ReplicaSet`` of that many replicas
    (``placement`` None: its default) instead of a ``BatchScheduler``.
    Admission is by size, never by the clock. Returns the blocks, the
    counters, the ledger snapshot and the stream's wall time."""
    from repro_torch import convert
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.serving import BatchScheduler, CostLedger, FeedbackLog, ReplicaSet

    wl_state, history, arms, payloads, qemb, labels, mixed = stream
    router = convert.router_from_state(wl_state, history, arms, 4, eps=0.1, delta=0.01,
                                       use_kernel=use_kernel, device=where)
    engine = router.engine
    wl = engine.arms[0].workload
    engine.fault_policy = FaultPolicy(len(arms), 4, seed=7).set_arms(
        range(len(arms)), timeout=0.5 * SERVE_FAULT_RATE, error=0.3 * SERVE_FAULT_RATE,
        degrade=0.2 * SERVE_FAULT_RATE)
    ledger = CostLedger(num_arms=len(arms))
    if limit is not None:
        ledger.set_limit("acme", limit)
    kwargs = dict(max_batch=64, max_wait_s=0.002,
                  feedback=FeedbackLog(router.estimator, probe_rate=SERVE_PROBE_RATE),
                  ledger=ledger, budget_tiers=SERVE_TIERS)
    sched = (ReplicaSet(router, replicas=replicas, placement=placement, **kwargs) if replicas
             else BatchScheduler(router, **kwargs))
    sched.prewarm(budgets=[SERVE_BUDGET])
    tenants = np.where(np.arange(SERVE_QUERIES) % 2 == 0, "acme", "zen").astype(object)
    drifted = False
    blocks = []
    t0 = time.perf_counter()
    for lo in range(0, SERVE_QUERIES, 64):
        hi = min(SERVE_QUERIES, lo + 64)
        blk = sched.submit_many(payloads[lo:hi], qemb[lo:hi], SERVE_BUDGET, tenant=tenants[lo:hi])
        sched.drain()
        sched.record_outcomes(blk.request_ids, labels[lo:hi])
        blocks.append(blk)
        if not drifted and hi >= SERVE_DRIFT_AFTER:
            drifted = True
            for t in range(3):           # half of the 6 clusters
                wl.drift_arms(router.plans.plan(t, SERVE_BUDGET).order, 0.30, clusters=[t])
    sched.apply_feedback()
    m_pay, m_emb, m_bud = mixed
    blk = sched.submit_many(m_pay, m_emb, m_bud, tenant="zen")
    sched.flush() if mixed_by == "flush" else sched.drain()
    blocks.append(blk)
    if where.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    stats = dict(sched.stats)
    return {"blocks": blocks, "stats": stats, "ledger": json.dumps(ledger.snapshot(), sort_keys=True),
            "wall_s": wall_s, "latency": sched.latency_stats(), "labels": labels,
            "acme_spent": ledger.tenant("acme")["spent"],
            "placement": getattr(sched, "placement", None)}


def stream_inputs():
    """The serve-default state and one 500-query stream, made once."""
    wl, wl_state, history, arms = serve_state(K=4)
    rng = np.random.default_rng(1)
    cid, qemb, labels = wl.sample_queries(SERVE_QUERIES, rng)
    mcid, memb, mlab = wl.sample_queries(64, rng)
    mixed_budgets = rng.choice(np.quantile(wl.costs, [0.3, 0.8]) * 2.5, size=64)
    return (wl_state, history, arms, np.column_stack([cid, labels]), qemb, labels,
            (np.column_stack([mcid, mlab]), memb, mixed_budgets))


def compare_streams(card: dict, cpu: dict, label: str) -> None:
    """Every time-free result of two ``serve_stream`` runs, bitwise."""
    for i, (g, c) in enumerate(zip(card["blocks"], cpu["blocks"])):
        for field in ("predictions", "costs", "planned_costs", "clusters", "budgets",
                      "stop_waves", "modes", "request_ids"):
            a, b = getattr(g, field), getattr(c, field)
            if not np.array_equal(a, b):
                rows = np.flatnonzero(a != b)
                raise AssertionError(f"{label} block {i}: {field} differ at rows "
                                     f"{rows[:10].tolist()}: card {a[rows[:3]].tolist()} "
                                     f"cpu {b[rows[:3]].tolist()}")
    if card["stats"] != cpu["stats"]:
        diff = {k: (card["stats"][k], cpu["stats"].get(k)) for k in card["stats"]
                if card["stats"][k] != cpu["stats"].get(k)}
        raise AssertionError(f"{label}: scheduler counters differ: {diff}")
    if card["ledger"] != cpu["ledger"]:
        raise AssertionError(f"{label}: ledger snapshots differ")


def stream_summary(run: dict, launches: dict) -> dict:
    st = run["stats"]
    preds = np.concatenate([b.predictions for b in run["blocks"][:-1]])
    lat = run["latency"]
    return {
        "qps": st["completed"] / run["wall_s"], "p50_ms": lat["p50_s"] * 1e3,
        "p99_ms": lat["p99_s"] * 1e3, "accuracy": float(np.mean(preds == run["labels"])),
        "planes": {"jit": st["spec_jit"], "reference": st["spec_reference"]},
        "flushes": st["flushes"], "groups": st["batches"],
        "plan": {k: st[f"plan_{k}"] for k in ("hits", "misses", "prefetches", "batch_replans",
                                             "batch_replanned", "stale_dropped")},
        "attempted_failures": st["degradation_failures"], "degraded": st["degradation_degraded"],
        "drifts": st["feedback_drifts"], "probes": st["feedback_probes"],
        "rejected": st["ledger_rejected"], "downgraded": st["ledger_downgraded"],
        "completed": st["completed"], "launches": launches,
    }


def poisson_stream(dev, stream, qps: float = 5000.0, slo_ms: float = 50.0) -> dict:
    """``--qps 5000 --slo-ms 50`` with the same faults and probes (labels
    recorded as blocks complete; no drift, no ledger), on the card: Poisson arrivals submitted in the bursts the
    clock delivers, the scheduler pumped between them (serve.py's loop).
    Timing only: arrivals follow the clock, so this run is not compared."""
    from repro_torch import convert
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.serving import BatchScheduler, FeedbackLog

    wl_state, history, arms, payloads, qemb, labels, _ = stream
    router = convert.router_from_state(wl_state, history, arms, 4, eps=0.1, delta=0.01,
                                       use_kernel=True, device=dev)
    router.engine.fault_policy = FaultPolicy(len(arms), 4, seed=7).set_arms(
        range(len(arms)), timeout=0.05, error=0.03, degrade=0.02)
    sched = BatchScheduler(router, max_batch=64, max_wait_s=0.002,
                           feedback=FeedbackLog(router.estimator, probe_rate=SERVE_PROBE_RATE))
    sched.prewarm(budgets=[SERVE_BUDGET])
    rng = np.random.default_rng(2)
    t0 = time.monotonic()
    arrivals = t0 + np.cumsum(rng.exponential(1.0 / qps, SERVE_QUERIES))
    blocks, sent, recorded = [], 0, 0
    while sent < SERVE_QUERIES:
        due = int(np.searchsorted(arrivals, time.monotonic(), side="right"))
        if due > sent:
            blocks.append((sched.submit_many(payloads[sent:due], qemb[sent:due], SERVE_BUDGET,
                                             slo_s=slo_ms / 1e3, arrival_s=arrivals[sent:due]),
                           labels[sent:due]))
            sent = due
        sched.pump()
        while recorded < len(blocks) and blocks[recorded][0].done():
            sched.record_outcomes(blocks[recorded][0].request_ids, blocks[recorded][1])
            recorded += 1
    sched.drain()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    lat = sched.latency_stats()
    preds = np.concatenate([b.predictions for b, _ in blocks])
    return {"offered_qps": qps, "slo_ms": slo_ms, "qps": lat["count"] / wall_s,
            "p50_ms": lat["p50_s"] * 1e3, "p99_ms": lat["p99_s"] * 1e3,
            "accuracy": float(np.mean(preds == labels)), "flushes": sched.stats["flushes"],
            "groups": sched.stats["batches"]}


def scheduler_phase(dev) -> dict:
    """The serve-default stream through ``BatchScheduler`` with faults,
    feedback and a cost ledger, ``use_kernel`` off and on, each on the card
    and on the CPU: every block's predictions, costs, planned costs,
    clusters, budgets, stop waves, modes and request ids, every counter
    and the ledger's snapshot bitwise. The limited tenant's limit is 80% of
    its spend in an unlimited CPU run. The launch counters are zeroed
    before and read after each card run; with ``use_kernel`` on,
    ``belief_aggregate`` and ``mc_correctness_grouped`` must both be above
    0. Then, on the card only: a Poisson stream, and the device's idle
    share of one profiled floodgates stream."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    cpu = torch.device("cpu")
    stream = stream_inputs()
    limit = LEDGER_SHARE * serve_stream(cpu, False, None, stream)["acme_spent"]
    out = {"acme_limit_usd": limit}
    for use_kernel in (False, True):
        ops.reset_launch_counts()
        card = serve_stream(dev, use_kernel, limit, stream)
        launches = {name: getattr(ops, name).launches
                    for name in ("belief_aggregate", "mc_correctness_grouped")}
        on_cpu = serve_stream(cpu, use_kernel, limit, stream)
        compare_streams(card, on_cpu, f"use_kernel={use_kernel}")
        row = stream_summary(card, launches)
        row["cpu_qps"] = on_cpu["stats"]["completed"] / on_cpu["wall_s"]
        out["kernel" if use_kernel else "f64"] = row
        log(f"  use_kernel={use_kernel}: card == cpu (bitwise: {len(card['blocks'])} blocks, "
            f"counters, ledger); {json.dumps(row)}")
        if use_kernel:
            for name, n in launches.items():
                if n <= 0:
                    raise AssertionError(f"kernel {name} was never launched by the scheduler")
        if row["rejected"] + row["downgraded"] == 0 or row["attempted_failures"] == 0:
            raise AssertionError(f"the stream exercised no ledger limit or no fault: {row}")
    out["poisson"] = poisson_stream(dev, stream)
    log(f"  poisson: {json.dumps(out['poisson'])}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = serve_stream(dev, True, limit, stream)
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e6
    out["profiled"] = {"wall_s": run["wall_s"], "device_busy_s": busy,
                       "idle_share": 1.0 - busy / run["wall_s"]}
    log(f"  profiled floodgates stream (use_kernel=True): {json.dumps(out['profiled'])}")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the R-replica serving plane and the serve CLI
# ---------------------------------------------------------------------------

REPLICAS = 4
TABULAR_QUERIES = 512            # phase 15 (c): four blocks of 128, then a mixed block of 128
CLOCKED = re.compile(r" in [0-9.]+s \([0-9]+ qps\) \| p50 [0-9.]+ms p99 [0-9.]+ms")
SERVE_ARGS = ["--queries", str(SERVE_QUERIES), "--budget", "1e-4", "--replicas", str(REPLICAS),
              "--fault-rate", "0.1"]
QUICKSTART_ARGS = ["--queries", "80", "--history", "300"]


@dataclasses.dataclass
class TabularArm:
    """Deterministic arm: the response to query j is the precomputed
    ``resp[j]`` (so a row's answer does not depend on its batch). The
    tests' copy in ``tests/_torch_serving.py`` sits in a module that
    imports JAX and the JAX package, which this script must not."""

    name: str
    cost: float
    resp: np.ndarray
    metered: bool = False

    def classify_batch(self, queries) -> np.ndarray:
        return self.resp[np.asarray(queries, np.int64)]

    def latency_s(self, batch: int) -> float:
        return 1e-6 * self.cost * batch


def tabular_inputs():
    """A tabular pool at the serve defaults (12 arms, K=4, 6 clusters, a
    2000-query history): every arm's answers to 640 queries drawn once."""
    from repro_torch.core.clustering import kmeans
    from repro_torch.data.synth import OracleWorkload

    wl = OracleWorkload(num_classes=4, num_clusters=6, num_arms=12, seed=0)
    table, emb, _ = wl.response_table(2000, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    n = TABULAR_QUERIES + 128
    rng = np.random.default_rng(3)
    qcid, qemb, qlab = wl.sample_queries(n, rng)
    resp = np.stack([wl.invoke_batch(a, qcid, qlab, np.random.default_rng(100 + a))
                     for a in range(12)])
    budgets = rng.choice(np.quantile(wl.costs, [0.3, 0.8]) * 2.5, size=128)
    return wl.costs, (table, emb, assign), resp, qemb, budgets


def tabular_stream(where, placement: str, inputs, side_streams: bool = True) -> dict:
    """R=4 over the tabular pool with ``use_kernel=True`` under an active
    ``FaultPolicy`` (every arm: timeout 0.05, error 0.03, degrade 0.02,
    seed 7) and a ``FeedbackLog`` (the failures fold into the estimator;
    no labels, no probes): four blocks of 128 at 1e-4 USD, then a
    mixed-budget block of 128, each submitted and drained. Its own driver,
    not ``serve_stream``: this pool has no workload to drift, no labels
    and no ledger. ``side_streams=False`` takes the overlapped workers'
    streams away, so that they launch on the current stream: a timing
    comparison of what the streams buy, not a placement of the set.
    Returns the blocks, the counters and the workers' streams."""
    from repro_torch.core.estimation import SuccessProbEstimator
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.serving import PoolEngine, ReplicaSet, ThriftRouter

    costs, (table, emb, assign), resp, qemb, budgets = inputs
    engine = PoolEngine([TabularArm(f"t{a}", float(costs[a]), resp[a]) for a in range(12)])
    engine.fault_policy = FaultPolicy(12, 4, seed=7).set_arms(
        range(12), timeout=0.05, error=0.03, degrade=0.02)
    router = ThriftRouter(engine, SuccessProbEstimator(table, emb, assign), 4,
                          use_kernel=True, device=where)
    rset = ReplicaSet(router, replicas=REPLICAS, max_batch=64, max_wait_s=0.002,
                      feedback=True, placement=placement)
    if not side_streams:
        for w in rset.workers:
            w.stream = None
    blocks = []
    t0 = time.perf_counter()
    for lo in range(0, TABULAR_QUERIES + 128, 128):
        rows = np.arange(lo, lo + 128)
        budget = SERVE_BUDGET if lo < TABULAR_QUERIES else budgets
        blocks.append(rset.submit_many(rows, qemb[rows], budget))
        rset.drain()
    if where.type == "cuda":
        torch.cuda.synchronize()
    return {"blocks": blocks, "stats": dict(rset.stats), "ledger": None,
            "wall_s": time.perf_counter() - t0, "latency": rset.latency_stats(),
            "streams": [w.stream for w in rset.workers]}


def replica_summary(run: dict) -> dict:
    st, lat = run["stats"], run["latency"]
    return {"qps": st["completed"] / run["wall_s"], "p50_ms": lat["p50_s"] * 1e3,
            "p99_ms": lat["p99_s"] * 1e3, "completed": st["completed"],
            "fused": st["replica_fused"], "fused_rows": st["replica_fused_rows"],
            "overlapped": st["replica_overlapped"],
            "overlapped_rows": st["replica_overlapped_rows"], "spills": st["replica_spills"],
            "groups": st["batches"], "attempted_failures": st.get("degradation_failures", 0)}


def run_cli(module: str, args: list) -> str:
    """``python -m <module> <args>`` from the checkout with ``PYTHONPATH=src``;
    its lines are echoed, and a non-zero exit raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
        log(f"    | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def time_free(out: str) -> list:
    return [CLOCKED.sub("", line) for line in out.strip().splitlines()]


def replica_phase(dev, limit: float) -> dict:
    """(a) the phase-14 stream (``use_kernel`` on, its mixed block drained)
    through ``ReplicaSet(replicas=1)`` on the card equals a
    ``BatchScheduler``'s on the card, bitwise; (b) the same stream with no
    ledger limit at R=4 in the default placement (fused on one card), card
    vs CPU bitwise, the router kernels' launch counters zeroed just before
    its card run and above 0 just after it; the overlapped placement of
    the limited stream card vs CPU; (c)
    R=4 overlapped over a tabular pool with faults: four distinct worker
    streams, card overlapped == card fused == CPU overlapped, and timed
    against the same workers on the current stream; (d) the serve
    CLI at R=4 on the card (its time-free lines equal ``--device cpu``'s)
    and at ``--qps 5000 --slo-ms 50``; (e) the quickstart card vs CPU; then
    the idle share of one profiled R=4 stream."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    cpu = torch.device("cpu")
    stream = stream_inputs()
    out = {}

    base = serve_stream(dev, True, limit, stream, mixed_by="drain")
    r1 = serve_stream(dev, True, limit, stream, replicas=1, mixed_by="drain")
    if r1["placement"] != "inline":
        raise AssertionError(f"R=1 placement {r1['placement']}, want inline")
    compare_streams(dict(r1, stats={k: r1["stats"][k] for k in base["stats"]}), base,
                    "R=1 ReplicaSet vs BatchScheduler (card)")
    out["inline_r1"] = replica_summary(r1)
    log(f"  (a) R=1 == BatchScheduler on the card (bitwise: {len(r1['blocks'])} blocks, "
        f"counters, ledger)")

    # no ledger limit here: the limited tenant's rejections leave this
    # stream no drift replan of a lone stale pair, the one plan miss of a
    # replica set that the serial planner (mc_correctness_grouped) takes;
    # the overlapped run below keeps the limit
    ops.reset_launch_counts()
    card = serve_stream(dev, True, None, stream, replicas=REPLICAS, mixed_by="drain")
    launches = {name: getattr(ops, name).launches
                for name in ("belief_aggregate", "mc_correctness_grouped")}
    if card["placement"] != "fused":
        raise AssertionError(f"R={REPLICAS} default placement on one card: {card['placement']}")
    compare_streams(card, serve_stream(cpu, True, None, stream, replicas=REPLICAS,
                                       mixed_by="drain"), f"R={REPLICAS} fused")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched by the replica set")
    if card["stats"]["replica_fused"] == 0 or card["stats"]["replica_spills"] == 0:
        raise AssertionError(f"the R={REPLICAS} stream fused or spilled nothing: "
                             f"{replica_summary(card)}")
    out["fused"] = dict(replica_summary(card), launches=launches)
    log(f"  (b) R={REPLICAS} fused, no ledger limit: card == cpu (bitwise); "
        f"{json.dumps(out['fused'])}")
    over = serve_stream(dev, True, limit, stream, replicas=REPLICAS, placement="overlapped",
                        mixed_by="drain")
    compare_streams(over, serve_stream(cpu, True, limit, stream, replicas=REPLICAS,
                                       placement="overlapped", mixed_by="drain"),
                    f"R={REPLICAS} overlapped")
    out["overlapped"] = replica_summary(over)
    log(f"      R={REPLICAS} overlapped: card == cpu (bitwise); {json.dumps(out['overlapped'])}")

    inputs = tabular_inputs()
    ops.reset_launch_counts()
    t_over = tabular_stream(dev, "overlapped", inputs)
    tab_launches = {name: getattr(ops, name).launches
                    for name in ("belief_aggregate", "mc_correctness_grouped")}
    streams = t_over.pop("streams")
    handles = {s.cuda_stream for s in streams if s is not None}
    default = torch.cuda.default_stream(dev).cuda_stream
    if len(handles) != REPLICAS or default in handles:
        raise AssertionError(f"overlapped workers hold {len(handles)} distinct side streams")
    t_fused = tabular_stream(dev, "fused", inputs)
    t_fused.pop("streams")
    t_cpu = tabular_stream(cpu, "overlapped", inputs)
    t_cpu.pop("streams")
    compare_streams(t_over, t_cpu, "tabular overlapped, card vs cpu")
    t_one = tabular_stream(dev, "overlapped", inputs, side_streams=False)
    t_one.pop("streams")
    compare_streams(t_one, t_over, "tabular overlapped, current stream vs side streams")
    # the placements' own dispatch counters, and plan hits (counted per
    # begin_route: one fused route reads the tables once for R workers)
    placed = lambda st: {k: v for k, v in st.items() if k != "plan_hits"
                         and not k.startswith(("replica_fused", "replica_overlapped"))}
    compare_streams(dict(t_over, stats=placed(t_over["stats"])),
                    dict(t_fused, stats=placed(t_fused["stats"])), "tabular overlapped vs fused")
    if t_over["stats"]["degradation_failures"] == 0 or tab_launches["belief_aggregate"] == 0:
        raise AssertionError(f"the tabular stream met no fault or launched no kernel: "
                             f"{replica_summary(t_over)} {tab_launches}")
    out["tabular"] = {"overlapped": replica_summary(t_over), "fused": replica_summary(t_fused),
                      "overlapped_current_stream": replica_summary(t_one),
                      "streams": len(handles), "launches": tab_launches}
    log(f"  (c) tabular R={REPLICAS} with faults: {len(handles)} worker streams; card overlapped "
        f"== card fused == cpu overlapped (bitwise); {json.dumps(out['tabular'])}")

    t0 = time.perf_counter()
    log(f"  (d) python -m repro_torch.launch.serve {' '.join(SERVE_ARGS)} --drift-after 250 "
        f"--probe-rate 0.02")
    online = SERVE_ARGS + ["--drift-after", "250", "--probe-rate", "0.02"]
    on_card = time_free(run_cli("repro_torch.launch.serve", online))
    on_cpu = time_free(run_cli("repro_torch.launch.serve", online + ["--device", "cpu"]))
    if on_card != on_cpu:
        raise AssertionError(f"serve CLI: card {on_card} != cpu {on_cpu}")
    if not on_card[1].startswith(f"replica plane: R={REPLICAS} on 1 device(s) [fused]"):
        raise AssertionError(f"serve CLI replica line: {on_card[1]}")
    log("      card == cpu (time-free fields); --qps 5000 --slo-ms 50:")
    run_cli("repro_torch.launch.serve",
            SERVE_ARGS + ["--probe-rate", "0.02", "--qps", "5000", "--slo-ms", "50"])
    quick_card = run_cli("repro_torch.quickstart", QUICKSTART_ARGS)
    if quick_card != run_cli("repro_torch.quickstart", QUICKSTART_ARGS + ["--device", "cpu"]):
        raise AssertionError("quickstart: card output differs from the cpu's")
    out["cli_s"] = time.perf_counter() - t0
    log("  (e) quickstart: card == cpu (every line)")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = serve_stream(dev, True, limit, stream, replicas=REPLICAS, mixed_by="drain")
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e6
    out["profiled"] = {"wall_s": run["wall_s"], "device_busy_s": busy,
                       "idle_share": 1.0 - busy / run["wall_s"]}
    log(f"  profiled R={REPLICAS} floodgates stream (fused): {json.dumps(out['profiled'])}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: training
# ---------------------------------------------------------------------------

SMOKE_TRAIN = (4, 32, 5)          # (b): batch, sequence, steps of each SMOKE family
TRAIN_LOSS_RTOL = 1e-4            # (b): f32 losses, card vs CPU
FULL_TRAIN = (8, 512, 30)         # (c): smollm-135m's batch, sequence, steps
TRAIN_CLI = ["--arch", "smollm-135m", "--save-every", "10"]
PIPELINE_STEPS = 60               # (e): train_and_serve --steps
BACKWARD_RANGE = "flash_attention_ref backward"   # ops.KernelFunction's profiler range
HOST_RANGES = ("unshard", "adamw_update", "constrain_params")   # phase 20 (a)'s labels


def input_grads(fn, inputs, upstream):
    """``(outputs, grads)``: ``fn(*inputs)``'s outputs (a tuple, detached) and
    the gradients of its first output for ``upstream`` with respect to every
    float input, each a fresh leaf."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad(out[0], leaves, upstream)
    return tuple(o.detach() for o in out), grads


def split_bc(fn, R: int, N: int):
    """``fn(x, dt, A, B, C, D, None)`` over B and C split from one (B, S,
    R + 2N) projection, so their gradient lands on the projection as the
    SSM block's does."""
    def run(x, dt, A, proj, D):
        _, Bm, Cm = proj.split([R, N, N], dim=-1)
        return fn(x, dt, A, Bm, Cm, D, None)
    return run


def autograd_phase(dev) -> dict:
    """(a) Each model kernel's autograd Function against the plain version's
    autograd on the same CUDA tensors and upstream gradient: one launch,
    the forward's outputs within the kernel's tolerance of the plain
    version's (phase 7's), input gradients bitwise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops, ref

    f32 = lambda args: tuple(a.float() for a in args)
    x_f32 = lambda args: (args[0].float(),) + tuple(args[1:])
    B, S, _ = SMOKE_TRAIN
    # (kernel, label, Function, plain, inputs, the plain forward's inputs,
    # atol, rel): the forward holds |out - plain| <= atol + rel |plain| on
    # bf16 outputs (one rounding to nearest) and <= atol on f32 ones
    args = flash_inputs(8, 512, 512, 9, 3, 64, torch.bfloat16, seed=60, dev=dev)
    cases = [("flash_attention", "bf16 B=8 S=512 H=9 G=3 hd=64 (smollm-135m training)",
              ops.flash_attention, ref.flash_attention_ref, args, f32(args), FLASH_BF16_ATOL, 0.0)]
    for i, hd in enumerate((8, 12, 24)):
        args = flash_inputs(2, 77, 77, 4, 2, hd, torch.float32, seed=61 + i, dev=dev)
        cases.append(("flash_attention", f"f32 B=2 S=77 H=4 G=2 hd={hd}", ops.flash_attention,
                      ref.flash_attention_ref, args, args, FLASH_F32_ATOL, 0.0))
    rg = get_smoke_config("recurrentgemma-9b")
    args = rglru_inputs(B, S, rg.rnn_width, seed=65, dev=dev)
    cases.append(("rglru_scan", f"SMOKE B={B} S={S} D={rg.rnn_width}", ops.rglru_scan,
                  ref.rglru_scan_ref, args, args, RGLRU_ATOL, 0.0))
    fm = get_smoke_config("falcon-mamba-7b")
    N, R = fm.ssm_state, fm.ssm_dt_rank
    x, dt, A, Bm, _, D, _ = mamba_path_inputs(B, S, fm.d_inner, N, R, seed=66, dev=dev)
    args = (x.float(), dt, A, Bm._base.float(), D)
    cases.append(("mamba_scan", f"SMOKE B={B} S={S} Din={fm.d_inner} N={N} f32, B/C split",
                  split_bc(ops.mamba_scan, R, N), split_bc(ref.mamba_scan_ref, R, N),
                  args, args, MAMBA_ATOL, 0.0))
    Bp, Sp, Dp, Np, Rp = MAMBA_PATH
    x, dt, A, Bm, _, D, _ = mamba_path_inputs(Bp, Sp, Dp, Np, Rp, seed=67, dev=dev)
    args = (x, dt, A, Bm._base, D)
    cases.append(("mamba_scan", f"phase 7's path case B={Bp} S={Sp} Din={Dp} N={Np} bf16 x/B/C, "
                  f"strided B/C", split_bc(ops.mamba_scan, Rp, Np),
                  split_bc(ref.mamba_scan_ref, Rp, Np), args, x_f32(args), MAMBA_ATOL,
                  BF16_ROUNDING))
    out = []
    for i, (name, label, fn, plain, args, plain_args, atol, rel) in enumerate(cases):
        y = plain(*args)
        y = y[0] if isinstance(y, tuple) else y
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        upstream = _randn(y.shape, gen, dev).to(y.dtype)
        _, want = input_grads(plain, args, upstream)
        with torch.no_grad():
            fwd_want = plain(*plain_args)
        fwd_want = fwd_want if isinstance(fwd_want, tuple) else (fwd_want,)
        counter = getattr(ops, name)
        before = counter.launches
        fwd, got = input_grads(fn, args, upstream)
        torch.cuda.synchronize()
        launches = counter.launches - before
        fwd_err = max(float((o.float() - w.float()).abs().max()) for o, w in zip(fwd, fwd_want))
        fwd_ok = all(bool(((o.float() - w.float()).abs()
                           <= atol + (rel if o.dtype == torch.bfloat16 else 0.0) * w.abs()).all())
                     and bool(torch.isfinite(o).all()) for o, w in zip(fwd, fwd_want))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        log(f"  {name} {label}: forward launches {launches}, forward max_abs_err {fwd_err:.3g} "
            f"(atol {atol}{f' + {rel:.3g} |y| on bf16' if rel else ''}: {fwd_ok}), input "
            f"gradients bitwise the plain version's: {bitwise}")
        if launches != 1 or not fwd_ok or not bitwise or not finite:
            raise AssertionError(f"{name} autograd at {label}: launches {launches}, forward "
                                 f"err {fwd_err} ok {fwd_ok}, bitwise {bitwise}, finite {finite}")
        out.append({"kernel": name, "case": label, "launches": launches,
                    "forward_max_abs_err": fwd_err, "bitwise": bitwise})
        del got, want, fwd, fwd_want
    torch.cuda.empty_cache()
    return {"cases": out}


def flash_training_times(dev) -> dict:
    """``flash_attention`` at smollm-135m's training shape (B=8 S=512 H=9 G=3
    hd=64 bf16): the kernel's forward beside its bound, the plain version
    and ``scaled_dot_product_attention``; and one backward of its autograd
    Function (the plain version recomputed and differentiated) beside
    SDPA's backward, each on a graph kept for repeated backwards."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    args = flash_inputs(8, 512, 512, 9, 3, 64, torch.bfloat16, seed=95, dev=dev)
    b_ms, b_by = bound_ms(*flash_bound(args[0], args[1], 0), BF16_OPS_PER_S)
    gen = torch.Generator(device=dev).manual_seed(96)
    up = _randn(args[0].shape, gen, dev).to(torch.bfloat16)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    ours = ops.flash_attention(*leaves)
    tl = [a.detach().clone().transpose(1, 2).requires_grad_() for a in args]
    lib = F.scaled_dot_product_attention(*tl, is_causal=True, enable_gqa=True)
    lib_up = up.transpose(1, 2)
    out = {"shape": "B=8 S=512 H=9 G=3 hd=64 window=0 bf16 (smollm-135m training)",
           "bound_ms": b_ms, "bound_by": b_by}
    for key, fn, n, launches in (
            ("ms", lambda: ops.flash_attention(*args), 20, 1),
            ("plain_ms", lambda: ref.flash_attention_ref(*args), 5, 0),
            ("library_ms", lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in args), is_causal=True, enable_gqa=True), 20, 0),
            ("backward_ms", lambda: torch.autograd.grad(ours, leaves, up, retain_graph=True), 5, 0),
            ("library_backward_ms",
             lambda: torch.autograd.grad(lib, tl, lib_up, retain_graph=True), 5, 0)):
        out[key], out[key.replace("ms", "source")] = device_ms(fn, n=n, launches=launches)
    return out


def smoke_batches(cfg, B: int, S: int, steps: int, rng) -> list:
    """``steps`` batches of ``S`` positions: tokens, after ``frontend_len``
    N(0, 1) frontend embeddings for frontend archs (the training CLI's
    batches)."""
    lf = cfg.frontend_len if cfg.frontend != "none" else 0
    out = []
    for _ in range(steps):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S - lf)))}
        if lf:
            b["frontend_embeds"] = torch.from_numpy(
                rng.normal(0, 1, (B, lf, cfg.d_model)).astype(np.float32))
        out.append(b)
    return out


def smoke_train_phase(dev, archs=ARCHS, steps: int = SMOKE_TRAIN[2], seed: int = 80) -> dict:
    """(b) The SMOKE configs of ``archs`` in f32, the same torch-seeded
    weights, trained ``steps`` steps on the card and on the CPU: losses
    per step within rel 1e-4, on the card every parameter's gradient finite
    and non-zero and, for MoE configs, the aux loss finite and non-zero."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

    B, S, _ = SMOKE_TRAIN
    out = {}
    ops.reset_launch_counts()
    card_launches = dict.fromkeys(MODEL_KERNELS, 0)
    for i, arch in enumerate(archs):
        cfg = get_smoke_config(arch)
        batches = smoke_batches(cfg, B, S, steps, np.random.default_rng(seed + i))
        losses = {}
        for where, side in ((dev, "card"), (torch.device("cpu"), "cpu")):
            model = LM(cfg, device="cpu", seed=seed + 10 + i).to(where)
            params, opt = init_train_state(model)
            step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1))
            before = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
            losses[side] = []
            for batch in batches:
                params, opt, m = step(params, opt, batch)
                losses[side].append(float(m["loss"]))
            if side == "card":
                for k in MODEL_KERNELS:
                    card_launches[k] += getattr(ops, k).launches - before[k]
                loss, metrics = model.loss(batches[0])
                grads = torch.autograd.grad(loss, list(params.values()))
                bad = [n for n, g in zip(params, grads)
                       if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
                if bad:
                    raise AssertionError(f"{arch}: parameters without a finite non-zero gradient "
                                         f"on the card: {bad}")
                aux = float(metrics["aux"].detach())
                if cfg.num_experts and not (np.isfinite(aux) and aux != 0.0):
                    raise AssertionError(f"{arch}: MoE aux loss {aux} on the card")
                n_params = len(grads)
            del model, params, opt
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
        log(f"  {arch} SMOKE f32, {steps} steps of {B}x{S}"
            f"{' (frontend batches)' if cfg.frontend != 'none' else ''}: losses card "
            f"{[round(v, 6) for v in losses['card']]}, max rel vs cpu {rel:.3g}; "
            f"{n_params} parameters, every gradient finite and non-zero on the card"
            + (f"; aux {aux:.6g}" if cfg.num_experts else ""))
        if rel > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{arch}: card losses differ from the cpu's by rel {rel}")
        out[arch] = {"card_losses": losses["card"], "cpu_losses": losses["cpu"], "max_rel": rel,
                     "params_with_grad": n_params, **({"aux": aux} if cfg.num_experts else {})}
    if min(card_launches[k] for k in MODEL_KERNELS if k in needed_kernels(archs)) <= 0:
        raise AssertionError(f"a model kernel did not launch in SMOKE training: {card_launches}")
    out["launches"] = card_launches
    log(f"  model kernel launches in (b): {card_launches}")
    return out


def needed_kernels(archs) -> set:
    """The model kernels the layers of ``archs`` run: flash for attention
    and MoE blocks, rglru_scan for recurrent ones, mamba_scan for SSM ones,
    causal_conv1d for both of the last two."""
    from repro_torch.configs import get_smoke_config

    kinds = {t for a in archs for t in get_smoke_config(a).block_pattern}
    return ({"flash_attention"} if kinds & {"attn", "moe"} else set()) | (
        {"rglru_scan"} if "rec" in kinds else set()) | ({"mamba_scan"} if "ssm" in kinds else set()) | (
        {"causal_conv1d"} if kinds & {"rec", "ssm"} else set())


def range_kernels(evt) -> list:
    """(name, device us) of every kernel launched under a profiler event."""
    found = [(k.name, k.duration) for k in evt.kernels]
    for child in evt.cpu_children:
        found += range_kernels(child)
    return found


def profiled_step(run, host_split=None) -> dict:
    """Two calls of ``run`` under ``torch.profiler``, each between spin
    kernels after a pause. The first traces the card only: its wall ms,
    device busy ms and idle share. The second traces the host too, for the
    split of device ms into the flash kernel's forward, the attention
    backward (every kernel under ``ops.KernelFunction``'s backward range),
    cuBLAS outside that range and the rest, with the largest kernels of the
    rest; ``host_split(prof)``, where given, adds its keys from that
    trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(activities):
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        with profile(activities=activities) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(SENTINELS):
                torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        # kernel rows: no spin kernels, and not a range's own row on the
        # device timeline (an annotation spanning kernels, not one)
        rows = [e for e in device_events(prof)
                if "spin_kernel" not in e.key and e.key not in (BACKWARD_RANGE, *HOST_RANGES)]
        return prof, wall_ms, rows

    _, wall_ms, rows = trace([ProfilerActivity.CUDA])
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    prof, host_wall_ms, rows = trace([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    gemm = lambda name: any(m in name.lower() for m in GEMM_MARKS)
    kernels = {e.key: (e.self_device_time_total / 1e3, e.count) for e in rows}
    flash_fwd = sum(ms for k, (ms, _) in kernels.items() if "flash_attention_kernel" in k)
    in_range = [kv for e in prof.events()
                if e.name == BACKWARD_RANGE and e.device_type == DeviceType.CPU
                for kv in range_kernels(e)]
    attn_bwd = sum(us for _, us in in_range) / 1e3
    gemm_in_range = sum(us for name, us in in_range if gemm(name)) / 1e3
    cublas = sum(ms for k, (ms, _) in kernels.items() if gemm(k)) - gemm_in_range
    traced_busy = sum(ms for ms, _ in kernels.values())
    rest = sorted(((ms, n, k) for k, (ms, n) in kernels.items()
                   if not gemm(k) and "flash_attention_kernel" not in k), reverse=True)
    host = host_split(prof) if host_split else {}
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "split_trace": {"wall_ms": host_wall_ms, "device_ms": traced_busy, **host,
                            "flash_forward_ms": flash_fwd, "attention_backward_ms": attn_bwd,
                            "cublas_ms": cublas,
                            "other_ms": traced_busy - flash_fwd - attn_bwd - cublas,
                            "kernel_launches": sum(n for _, n in kernels.values()),
                            "backward_ranges": sum(e.name == BACKWARD_RANGE
                                                   and e.device_type == DeviceType.CPU
                                                   for e in prof.events()),
                            "largest_kernels_outside_gemm_and_flash": [
                                {"kernel": k[:120], "ms": ms, "count": n} for ms, n, k in rest[:8]]}}


def host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of ``fn`` ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def full_train_phase(dev) -> dict:
    """(c) smollm-135m at full width in bf16 (remat on), 30 steps of 8 x 512
    token-task batches: the loss falls, ``flash_attention`` launches layers
    x steps x 2 (forward and remat recompute), and a ``[train]`` line."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_token_task
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.training import (OptimizerConfig, adamw_update, init_train_state,
                                      make_train_step)

    B, S, steps = FULL_TRAIN
    cfg = get_config("smollm-135m")
    data = make_token_task(4, S, 512, n=B * steps, seed=0)["tokens"]
    batches = [torch.from_numpy(data[i * B:(i + 1) * B]).to(dev) for i in range(steps)]
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=5)
    params, opt = init_train_state(model)
    opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    step = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, step_ms = [], []
    for toks in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {"tokens": toks})
        losses.append(float(m["loss"]))                      # reads back: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = cfg.num_layers * steps * (2 if cfg.remat else 1)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  smollm-135m bf16 remat={cfg.remat}, {steps} steps of {B}x{S}: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean {first:.4f}, last 5 {last:.4f}); "
        f"flash_attention launches {launches['flash_attention']} (want {want})")
    if not (last < first and all(np.isfinite(losses))):
        raise AssertionError(f"smollm-135m training loss did not fall: {losses}")
    if launches["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {launches['flash_attention']} times "
                             f"in training, want {want}")

    state = {"params": params, "opt": opt}

    def one_step():
        state["params"], state["opt"], _ = step(state["params"], state["opt"],
                                                {"tokens": batches[0]})

    prof = profiled_step(one_step)

    def loss_and_grad():
        loss, _ = model.loss({"tokens": batches[0]})
        return dict(zip(state["params"], torch.autograd.grad(loss, list(state["params"].values()))))

    grads = loss_and_grad()
    host_split = {"loss_and_grad_ms": host_ms(loss_and_grad),
                  "adamw_update_ms": host_ms(lambda: adamw_update(grads, state["opt"],
                                                                  state["params"], opt_cfg))}
    med = float(np.median(step_ms))
    out = {"steps": steps, "batch": B, "seq": S, "step_ms_median": med,
           "step_ms": step_ms, "tokens_per_s": B * S / (med / 1e3),
           "peak_memory_gb": peak_gb, "init_s": init_s, "losses": losses,
           "launches": launches, "profiled_step": prof, "host_split": host_split,
           "checkpoint": checkpoint_times(state)}
    del model, params, opt, state, step, grads
    torch.cuda.empty_cache()
    return out


def checkpoint_times(state: dict) -> dict:
    """One ``CheckpointManager.save`` of a training state (the card's tensors
    copied to the host and written as npz) and one ``restore_latest`` of it
    onto the card, each timed on the host clock: the saves and the restore
    that (d)'s two runs make, at the same size."""
    from repro_torch.checkpoint import CheckpointManager

    ckpt = ROOT / "build" / "train_ckpt" / "chip_smoke_save"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(0, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, restored = mgr.restore_latest(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    shutil.rmtree(ckpt, ignore_errors=True)
    if step != 0 or not torch.equal(restored["params"]["tok"], state["params"]["tok"]):
        raise AssertionError("the training state did not restore")
    log(f"  checkpoint of the full-width state: {nbytes / 1e9:.3f} GB, save {save_s:.3f} s, "
        f"restore {restore_s:.3f} s")
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s}


def train_cli_phase() -> dict:
    """(d) ``python -m repro_torch.launch.train --arch smollm-135m --steps
    20 --save-every 10`` as a subprocess on the card, then again to 30
    steps: the second run resumes from the first's checkpoint."""
    ckpt = ROOT / "build" / "train_ckpt" / "chip_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    first = run_cli("repro_torch.launch.train", TRAIN_CLI + ["--steps", "20", "--ckpt", str(ckpt)])
    first_s = time.perf_counter() - t0
    second = run_cli("repro_torch.launch.train", TRAIN_CLI + ["--steps", "30", "--ckpt", str(ckpt)])
    total_s = time.perf_counter() - t0
    lines = second.strip().splitlines()
    if "resumed from step 10" not in lines:
        raise AssertionError(f"the second training run did not resume: {lines}")
    saved = sorted(p.relative_to(ckpt).as_posix() for p in ckpt.glob("*/step_*"))
    shutil.rmtree(ckpt, ignore_errors=True)
    # each run's wall clock against its own "done in" (the step loop, its
    # saves included): the rest is the process's start, imports, the
    # card's context, the model's init and, in the second run, the restore
    loop_s = [float(out.strip().splitlines()[-1].split()[2].rstrip("s")) for out in (first, second)]
    walls = [first_s, total_s - first_s]
    split = {"wall_s": walls, "loop_s": loop_s,
             "outside_loop_s": [w - l for w, l in zip(walls, loop_s)]}
    log(f"  (d) trained 20 steps, resumed from step 10 to 30; checkpoints {saved}; "
        f"split {json.dumps(split)}")
    return {"first_s": first_s, "total_s": total_s, "checkpoints": saved, "split": split,
            "first_lines": first.strip().splitlines(), "second_lines": lines}


def pipeline_phase() -> dict:
    """(e) ``python -m repro_torch.train_and_serve --steps 60`` on the card,
    then with ``--device cpu`` (one after the other: two torch processes at
    once fight over the host's cores): the arms' costs equal, and
    test_system's behavioural asserts hold on the card."""
    ckpt = ROOT / "build" / "train_ckpt" / "chip_smoke_pipeline"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs, wall_s = {}, {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = run_cli("repro_torch.train_and_serve", ["--steps", str(PIPELINE_STEPS),
                                                      "--device", where, "--ckpt", str(ckpt / where)])
        wall_s[where] = time.perf_counter() - t0
        runs[where] = json.loads(out.strip().splitlines()[-1])
    shutil.rmtree(ckpt, ignore_errors=True)
    card, cpu = runs["cuda"], runs["cpu"]
    costs = [a["cost"] for a in card["arms"]]
    if costs != [a["cost"] for a in cpu["arms"]]:
        raise AssertionError(f"arm costs differ: card {costs}, cpu {[a['cost'] for a in cpu['arms']]}")
    acc = [a["accuracy"] for a in card["arms"]]
    by_mult = {b["multiple"]: b for b in card["budgets"]}
    checks = {
        "bigger arm beats the smallest": acc[-1] > acc[0] and costs[-1] > costs[0],
        "ensemble >= best arm - 0.08": by_mult[100.0]["accuracy"] >= max(acc) - 0.08,
        "tight budget above 1/K": by_mult[1.2]["accuracy"] > 1.0 / 8,
        "every cost within budget": all(b["max_cost"] <= b["budget"] + 1e-15
                                        for b in card["budgets"]),
        "loss drops by more than 0.25": all(a["loss_last10"] < a["loss_first10"] - 0.25
                                            for a in card["arms"]),
    }
    log(f"  (e) arm costs card == cpu {costs}; accuracies card {acc}, cpu "
        f"{[a['accuracy'] for a in cpu['arms']]}; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"train_and_serve on the card fails test_system's asserts: {checks}")
    return {"card": card, "cpu": cpu, "checks": checks, "wall_s": wall_s}


def train_summary(train: dict, smi: str) -> dict:
    """The ``[train]`` line: (c)'s step time, throughput, peak memory and
    profiled step beside the card's name and power limit, and the other
    parts' headline numbers."""
    full, pipe = train["full"], train["pipeline"]
    keys = ("steps", "batch", "seq", "step_ms_median", "tokens_per_s", "peak_memory_gb",
            "init_s", "launches", "profiled_step", "host_split")
    return {"card": smi, **{k: full[k] for k in keys},
            "first_losses": full["losses"][:5], "last_losses": full["losses"][-5:],
            "smoke_max_rel": {a: train["smoke"][a]["max_rel"] for a in ARCHS},
            "smoke_launches": train["smoke"]["launches"], "cli_s": train["cli"]["total_s"],
            "cli_split": train["cli"]["split"], "checkpoint": full["checkpoint"],
            "pipeline": {"card_accuracy": [a["accuracy"] for a in pipe["card"]["arms"]],
                         "cpu_accuracy": [a["accuracy"] for a in pipe["cpu"]["arms"]],
                         "card_budgets": pipe["card"]["budgets"], "wall_s": pipe["wall_s"]},
            "seconds": {k: train[k] for k in ("autograd_s", "smoke_s", "full_s", "cli_s",
                                              "pipeline_s")}}


def train_phase(dev) -> dict:
    """Phase 16: (a)-(e) above, each timed."""
    out, t = {}, time.perf_counter()
    log("  (a) autograd Functions of the model kernels vs the plain versions' autograd")
    out["autograd"] = autograd_phase(dev)
    out["flash_training_shape"] = flash_training_times(dev)
    log(f"  flash_attention at the training shape: {json.dumps(out['flash_training_shape'])}")
    out["autograd_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (b) SMOKE families, f32, card vs cpu")
    out["smoke"] = smoke_train_phase(dev)
    out["smoke_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (c) smollm-135m at full width, bf16")
    out["full"] = full_train_phase(dev)
    out["full_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (d) the training CLI with checkpoint/restart")
    out["cli"] = train_cli_phase()
    out["cli_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (e) train, calibrate and serve: card vs cpu")
    out["pipeline"] = pipeline_phase()
    out["pipeline_s"] = time.perf_counter() - t
    return out


# ---------------------------------------------------------------------------
# Phase 17: the other seven architectures of the registry
# ---------------------------------------------------------------------------

NEW_ARCHS = ("h2o-danube-1.8b", "qwen1.5-110b", "starcoder2-7b", "granite-moe-1b-a400m",
             "moonshot-v1-16b-a3b", "internvl2-2b", "musicgen-medium")
# (c): the five that fit one card together in bf16 (about 13.6 B params), the
# cheapest first (the fault check's arm)
POOL_ARCHS = ("granite-moe-1b-a400m", "h2o-danube-1.8b", "starcoder2-7b", "internvl2-2b",
              "musicgen-medium")
QWEN_LAYERS = 8                   # (e): qwen1.5-110b's 80 layers cut to 8 (about 13.4 B params)
FAMILY_TRAIN_STEPS = 3            # (f)
# (label, B, S, T, H, G, hd, window): the LM-arm route's shapes (64 queries,
# 127 tokens) of danube (hd 80, GQA ratio 4; its window 4096 never
# reached), starcoder2 (ratio 9), qwen (ratio 8) and moonshot (MHA at hd
# 128), then danube's window where it binds (S = T = 4608)
FLASH_FAMILY_CASES = (
    ("h2o-danube-1.8b path", 64, 127, 127, 32, 8, 80, 4096),
    ("starcoder2-7b path", 64, 127, 127, 36, 4, 128, 0),
    ("qwen1.5-110b path", 64, 127, 127, 64, 8, 128, 0),
    ("moonshot-v1-16b-a3b path", 64, 127, 127, 16, 16, 128, 0),
    ("h2o-danube-1.8b window", 1, 4608, 4608, 32, 8, 80, 4096),
)


def scaled_flash_excess(got, q, k, v, want, window: int) -> dict:
    """The largest ``|got - want| / tol`` of a bf16 flash output, where
    ``tol = 2^-8 (|want| + att(|v|))`` per element and ``att(|v|)`` is the
    plain attention of the same scores over ``|v|`` (the f32 ``sum_j p_j
    |v_j|`` of each output element). The kernel rounds each probability to
    bf16 before the PV product (moving the output by at most ``2^-9 sum_j
    p_j |v_j|``) and the output once (at most ``2^-9 |want|``; ``2^-9``
    more of it if the row sum takes the rounded probabilities); as
    ``att(|v|) >= |want|``, a right kernel stays at or below 3/4 of
    ``tol``, give or take f32 rounding. Unlike an absolute
    bound, this scales with the rows' own size: past a long window each
    output averages thousands of keys and is about 0.03 where the first
    rows are near 1. Reported separately for the rows before the window
    and the rows at or past it."""
    from repro_torch.kernels import ref

    f32 = [a.float() for a in (q, k, v)]
    scale = ref.flash_attention_ref(f32[0], f32[1], f32[2].abs(), window=window)
    ratio = (got.float() - want).abs() / (BF16_ROUNDING * (want.abs() + scale))
    torch.cuda.synchronize()
    return {"rows_before_window": float(ratio[:, :window].max()),
            "rows_past_window": float(ratio[:, window:].max())}


def windowed_flash_check(args, got, want, window: int, label: str) -> dict:
    """Holds a windowed case whose rows run past the window to
    ``scaled_flash_excess`` below 1 in both row ranges, and shows that the
    check sees the window: the kernel run with the window one key short
    (``window - 1``) and with no window must each exceed it past the
    window."""
    from repro_torch.kernels import ops

    excess = scaled_flash_excess(got, *args, want, window)
    controls = {f"window {w}": scaled_flash_excess(ops.flash_attention(*args, window=w), *args,
                                                   want, window)["rows_past_window"]
                for w in (window - 1, 0)}
    out = {"scaled_excess": excess, "planted_wrong_window_excess": controls}
    log(f"  flash_attention {label}: |err| / (2^-8 (|want| + att(|v|))) max {json.dumps(excess)}; "
        f"planted wrong windows (must exceed 1 past the window): {json.dumps(controls)}")
    if not (max(excess.values()) < 1.0 and min(controls.values()) > 1.0):
        raise AssertionError(f"flash_attention at {label}: scaled error {excess} (must stay "
                             f"below 1), wrong-window controls {controls} (must exceed 1)")
    return out


# aten ops that would pad, slice or copy q, k, v or out around a kernel call
PAD_OR_COPY = ("aten::constant_pad_nd", "aten::pad", "aten::slice", "aten::copy_", "aten::cat",
               "aten::clone", "aten::_to_copy")


def pad_or_copy_ops(fn) -> list:
    """The ``PAD_OR_COPY`` aten ops one call of ``fn`` runs (CPU activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.key in PAD_OR_COPY})


def flash_kernel_rows(fn, calls: int = 20) -> dict:
    """That one call of ``fn`` is one flash kernel and nothing around it:
    (a) the aten ops of one call (CPU activity, which loses no events)
    hold none that pads, slices or copies (``PAD_OR_COPY``); (b) the
    device kernel rows of a traced run of ``calls`` calls (spin kernels
    left out) are all a flash kernel's and no more than ``calls``. A trace
    may lose kernel rows, never add them, and late in a run may lose them
    all: an empty trace is taken again, up to three times, and if all three
    are empty (b) is reported as lost and (a) stands alone."""
    copies = pad_or_copy_ops(fn)
    for attempt in range(3):
        rows = [e for e in device_events(traced(fn, calls)) if "spin_kernel" not in e.key]
        out = {"calls": calls, "kernel_rows": sum(e.count for e in rows),
               "kernels": sorted({e.key for e in rows}), "traces": attempt + 1,
               "pad_or_copy_ops": copies}
        if out["kernel_rows"]:
            break
    if copies or not (out["kernel_rows"] <= calls
                      and all("flash_attention_kernel" in k for k in out["kernels"])):
        raise AssertionError(f"a flash_attention call is not one kernel: {out}")
    return out


def family_flash(dev) -> list:
    """(a) ``flash_attention`` in bf16 at the new families' shapes against
    the f32 plain version (within ``FLASH_BF16_ATOL``; the case whose rows
    run past its window also within ``windowed_flash_check``'s scaled
    bound), each a single kernel row a call (``flash_kernel_rows``) and
    timed: device ms of the wrapper's call, the plain version, the byte /
    operation bound and SDPA; beside them the wrapper's tiling (design,
    grid, bytes copied into shared memory against the device bytes)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    rows = []
    for i, (label, B, S, T, H, G, hd, w) in enumerate(FLASH_FAMILY_CASES):
        args = flash_inputs(B, S, T, H, G, hd, torch.bfloat16, seed=60 + i, dev=dev)
        shape = f"{label}: B={B} S={S} H={H} G={G} hd={hd} window={w} bf16"
        got = ops.flash_attention(*args, window=w)
        want = ref.flash_attention_ref(*(a.float() for a in args), window=w)
        err = output_error("flash_attention", got, want, FLASH_BF16_ATOL, shape)
        window_check = windowed_flash_check(args, got, want, w, shape) if 0 < w < S else {}
        del got, want
        b_ms, b_by = bound_ms(*flash_bound(args[0], args[1], w), BF16_OPS_PER_S)
        ms, ms_source = device_ms(lambda: ops.flash_attention(*args, window=w))
        plain_ms, plain_source = device_ms(lambda: ref.flash_attention_ref(*args, window=w), n=5)
        tl = fa.tiling(B, S, T, H, G, hd, torch.bfloat16, True, w)
        row = {"shape": shape, "max_abs_err": err, **window_check,
               "ms": ms, "ms_source": ms_source,
               "plain_ms": plain_ms, "plain_ms_source": plain_source,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": sdpa_ms(*args, window=w),
               "call_ms": median_ms(lambda: ops.flash_attention(*args, window=w)),
               "rows": flash_kernel_rows(lambda: ops.flash_attention(*args, window=w)),
               "design": tl.kernel, "grid": list(tl.grid), "fill_bytes": tl.fill_bytes,
               "device_bytes": tl.device_bytes, "fill_over_device": tl.fill_bytes / tl.device_bytes}
        rows.append(row)
        log(f"  flash_attention {shape}: {json.dumps({k: v for k, v in row.items() if k != 'shape'})}")
        del args
    # the control: bf16 at hd 12 (not a multiple of 8) is the one shape the
    # wrapper pads, and the op check must see it
    args = flash_inputs(2, 45, 45, 4, 2, 12, torch.bfloat16, seed=69, dev=dev)
    control = pad_or_copy_ops(lambda: ops.flash_attention(*args))
    log(f"  flash_attention bf16 hd 12 (padded to 16, the control): pad or copy ops {control}")
    if not control:
        raise AssertionError("the pad check saw no pad at bf16 hd 12")
    return rows


def big_forward(dev, cfg, seed: int) -> dict:
    """One full-width bf16 model of ``cfg`` alone on the card, as an
    ``LMArm`` over 64 queries of ``make_token_task(K=4, seq_len=128,
    vocab=512)``: init time, ``classify_batch`` ms (median of 3 after one
    warm-up), the flash launches of those calls, logits finite, peak device
    memory; the model is freed after."""
    from repro_torch.data import make_token_task
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.serving import LMArm

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    task = make_token_task(4, 128, 512, n=64, seed=3)
    arm = LMArm(cfg.name, model, task["class_token_ids"], tokens_per_query=128)
    ops.reset_launch_counts()
    times = []
    for _ in range(4):
        t1 = time.perf_counter()
        pred = arm.classify_batch(task["tokens"])           # ends in a copy to the host
        times.append((time.perf_counter() - t1) * 1e3)
    launches = ops.flash_attention.launches
    with torch.inference_mode():
        logits = model(torch.as_tensor(task["tokens"][:, :-1], device=dev).long())
        finite = bool(torch.isfinite(logits).all())
    out = {"layers": cfg.num_layers, "params_b": n_params / 1e9, "init_s": init_s,
           "forward_ms": float(np.median(times[1:])), "forward_ms_all": times,
           "flash_launches": launches, "logits_finite": finite,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "predictions_in_range": bool(((pred >= 0) & (pred < 4)).all())}
    log(f"  {cfg.name} ({cfg.num_layers} layers, {n_params / 1e9:.2f} B bf16 params): "
        f"{json.dumps(out)}")
    del model, arm, logits
    torch.cuda.empty_cache()
    if not (finite and out["predictions_in_range"] and launches == 4 * cfg.num_layers):
        raise AssertionError(f"{cfg.name}: forward not finite or malformed, or flash launched "
                             f"{launches} times (want {4 * cfg.num_layers})")
    return out


def families_phase(dev) -> dict:
    """Phase 17: (a)-(f) above, each timed."""
    from repro_torch.configs import get_config

    out, seconds = {}, {}
    t = time.perf_counter()
    log("  (a) flash_attention at the new families' shapes")
    out["flash"] = family_flash(dev)
    seconds["flash_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (b) one pattern unit of each new config, full width, f32: card vs cpu")
    out["units"] = model_phase(dev, NEW_ARCHS, seed=17)
    seconds["units_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log(f"  (c) LM-arm pool at full width, bf16: {', '.join(POOL_ARCHS)}")
    out["pool"] = lm_route_phase(dev, POOL_ARCHS, seed=200)
    seconds["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log("  (d) moonshot-v1-16b-a3b alone at full width, bf16")
    out["moonshot"] = big_forward(dev, get_config("moonshot-v1-16b-a3b"), seed=300)
    seconds["moonshot_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log(f"  (e) qwen1.5-110b at published width, {QWEN_LAYERS} of its 80 layers, bf16")
    qwen = dataclasses.replace(get_config("qwen1.5-110b"), num_layers=QWEN_LAYERS)
    out["qwen"] = {**big_forward(dev, qwen, seed=310),
                   "reduced": {"num_layers": [80, QWEN_LAYERS]}}
    seconds["qwen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    log(f"  (f) the new SMOKE configs, f32, {FAMILY_TRAIN_STEPS} steps: card vs cpu")
    out["smoke"] = smoke_train_phase(dev, NEW_ARCHS, steps=FAMILY_TRAIN_STEPS, seed=180)
    seconds["smoke_s"] = time.perf_counter() - t
    out["seconds"] = seconds
    return out


def families_summary(fam: dict, smi: str) -> dict:
    """The ``[families]`` line: each part's headline numbers beside the
    card's name and power limit."""
    pool = fam["pool"]
    return {"card": smi,
            "units": fam["units"],
            "pool": {k: pool[k] for k in ("forward_ms", "init_s", "main_s", "breakdown",
                                          "launches", "scheduler_launches")},
            "moonshot": fam["moonshot"], "qwen": fam["qwen"],
            "smoke": {a: {k: v for k, v in fam["smoke"][a].items() if k != "cpu_losses"}
                      for a in NEW_ARCHS},
            "smoke_launches": fam["smoke"]["launches"], "seconds": fam["seconds"]}


# ---------------------------------------------------------------------------
# Phase 18: prefill, decode steps and the KV / recurrent caches
# ---------------------------------------------------------------------------

DECODE_PREFILL, DECODE_STEPS = 19, 3      # (a): SMOKE, the windowed rings of 16 wrap
DECODE_ATOL = 1e-4                       # (a): f32 logits and cache leaves, card vs CPU
PREFILL_FORWARD_ATOL = 2e-4              # (a): prefill logits vs forward (tests/test_models.py)
INT8_SCALE_ATOL = 1e-6                   # (a): int8 scales, card vs CPU
INT8_TIE_WINDOW = 1e-3                   # (a): |x / scale - (n + 1/2)| of a value that may flip
# (b): the four arms at published width in bf16, one block type each
DECODE_ARMS = ("smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b", "granite-moe-1b-a400m")
WIDTH_QUERIES, WIDTH_PROMPT, WIDTH_STEPS = 64, 127, 32   # the LM-arm route's queries
LONG_PREFILL = 2056                      # (b): recurrentgemma past its 2048 local window, B=2
MOE_CHECK_CAPACITY = 8.0                 # (b): no token dropped in the check against forward
# (b): decode logits vs forward at published width, held in f32 (the bf16
# gap is printed beside the bf16 forward's own sensitivity to a one-ulp
# change of 1% of its embeddings: a deep random-weight model amplifies
# rounding, so two bf16 paths may part by as much as that change moves it)
CHECK_QUERIES, CHECK_STEPS = 4, 8
# (b): the f32 check's limit as a share of the largest |logit|: the mamba
# kernel's y may part from the plain decode step by its 3e-4 tolerance per
# layer, and 64 layers carry that to the logits (falcon-mamba-7b measured
# 3.7e-4 of its largest logit, recurrentgemma-9b 5.4e-6, smollm-135m
# 1.5e-6; NVIDIA H100 80GB HBM3, 700 W)
CHECK_SHARE = 1e-3
PERTURB_EVERY = 97                       # (b): every 97th embedding element, one bf16 ulp up
DECODE_RANGE = "decode attention"        # profiler range around each attention decode
# the model kernels' launches made by phase 18's prefills (not by the
# forwards they are held against)
PREFILL_LAUNCHES = {}


def counted_prefill(model, *args, **kwargs):
    """``model.prefill(*args, **kwargs)``, its model-kernel launches added to
    ``PREFILL_LAUNCHES``."""
    from repro_torch.kernels import ops

    before = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
    out = model.prefill(*args, **kwargs)
    for k in MODEL_KERNELS:
        PREFILL_LAUNCHES[k] = PREFILL_LAUNCHES.get(k, 0) + getattr(ops, k).launches - before[k]
    return out


@contextlib.contextmanager
def quantize_inputs():
    """Record every ``quantize_kv`` input (prefill and decode) while it runs;
    the list is yielded."""
    from repro_torch.models import blocks

    seen, plain = [], blocks.quantize_kv

    def spy(x):
        seen.append(x.float().cpu())
        return plain(x)

    blocks.quantize_kv = spy
    try:
        yield seen
    finally:
        blocks.quantize_kv = plain


@contextlib.contextmanager
def attention_range():
    """Each attention decode (slot write, dequantize, direct attention) under
    a ``DECODE_RANGE`` profiler range, so a trace can split it out."""
    from repro_torch.models import blocks

    plain = blocks.attn_sublayer_decode

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(DECODE_RANGE):
            return plain(*args, **kwargs)

    blocks.attn_sublayer_decode = ranged
    try:
        yield
    finally:
        blocks.attn_sublayer_decode = plain


def decode_stages(model, tokens, fe, dev) -> list:
    """Prefill ``tokens[:, :DECODE_PREFILL]`` (after ``fe``) with
    ``extra_slots=DECODE_STEPS`` on ``dev``, then decode the next
    ``DECODE_STEPS`` tokens one at a time: after the prefill and after each
    step, ``(logits, pos, [(leaf name, tensor)])`` copied to the host."""
    def snap(logits, cache):
        leaves = [("ring", cache["ring"])] if cache["ring"] is not None else []
        leaves += [(f"layer {i} {k}", t) for i, layer in enumerate(cache["layers"])
                   for k, t in layer.items()]
        return logits.cpu(), cache["pos"], [(n, t.cpu().clone()) for n, t in leaves]

    logits, cache = counted_prefill(model, tokens[:, :DECODE_PREFILL].to(dev),
                                    None if fe is None else fe.to(dev), extra_slots=DECODE_STEPS)
    stages = [snap(logits, cache)]
    for t in range(DECODE_PREFILL, DECODE_PREFILL + DECODE_STEPS):
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1].to(dev))
        stages.append(snap(logits, cache))
    return stages


def int8_tie_masks(model, inputs: list) -> dict:
    """Where an int8 KV value may differ card vs CPU: per attention layer's
    ``k``/``v`` leaf after the last step, the values whose CPU ``x / scale``
    lies within ``INT8_TIE_WINDOW`` of a rounding boundary (the card's f32
    sums differ from the CPU's in the last bits). ``inputs`` are the CPU's
    ``quantize_kv`` inputs in call order: each attention layer's prefill k
    then v, then per step each layer's token k then v."""
    from repro_torch.models import blocks

    def near(x):
        q, scale = blocks.quantize_kv(x)
        t = (x / scale).abs()
        return (t - t.floor() - 0.5).abs() < INT8_TIE_WINDOW

    attn = [i for i, t in enumerate(model.cfg.layer_types) if t in ("attn", "moe")]
    calls = iter(inputs)
    masks = {(i, n): near(next(calls)) for i in attn for n in ("k", "v")}
    T = masks[(attn[0], "k")].shape[1]
    for pos in range(DECODE_PREFILL, DECODE_PREFILL + DECODE_STEPS):
        slot = blocks.decode_slot(pos, T, model.window)
        for i in attn:
            for n in ("k", "v"):
                masks[(i, n)][:, slot] = near(next(calls))[:, 0]
    return {f"layer {i} {n}": m for (i, n), m in masks.items()}


def smoke_decode(dev) -> dict:
    """(a) Each SMOKE config in f32, the same weights on the card and the
    CPU: prefill ``DECODE_PREFILL`` tokens (frontend archs after frontend
    embeddings) with ``extra_slots=DECODE_STEPS``, then decode
    ``DECODE_STEPS`` tokens, the logits and every cache leaf card vs CPU
    within ``DECODE_ATOL`` after the prefill and after each step; on the
    card the prefill's logits against the forward's last position within
    ``PREFILL_FORWARD_ATOL``. Then smollm's SMOKE config with an int8 KV
    cache: scales within ``INT8_SCALE_ATOL``, logits within
    ``LOGITS_ATOL``, int8 values equal but where the CPU's value lies at a
    rounding tie, where they may differ by one step."""
    import copy

    from repro_torch.configs import get_smoke_config, list_archs
    from repro_torch.models import LM

    out = {}
    cases = [(a, get_smoke_config(a)) for a in list_archs()]
    cases.append(("smollm-135m int8 kv", dataclasses.replace(get_smoke_config("smollm-135m"),
                                                              kv_quant="int8")))
    for i, (name, cfg) in enumerate(cases):
        cpu = LM(cfg, device="cpu", seed=400 + i)
        card = copy.deepcopy(cpu).to(dev)
        rng = np.random.default_rng(400 + i)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (2, DECODE_PREFILL + DECODE_STEPS)))
        fe = (torch.as_tensor(rng.normal(0, 1, (2, cfg.frontend_len, cfg.d_model)),
                              dtype=torch.float32) if cfg.frontend != "none" else None)
        int8 = cfg.kv_quant == "int8"
        got = decode_stages(card, tokens, fe, dev)
        with torch.inference_mode():
            full = card(tokens[:, :DECODE_PREFILL].to(dev),
                        None if fe is None else fe.to(dev))[:, -1].cpu()
        prefill_err = float((got[0][0] - full).abs().max())
        with quantize_inputs() as seen:
            want = decode_stages(cpu, tokens, fe, torch.device("cpu"))
        ties = int8_tie_masks(cpu, seen) if int8 else {}
        errs, int8_row = [], {}
        for step, ((gl, gpos, gleaves), (wl, wpos, wleaves)) in enumerate(zip(got, want)):
            errs.append(float((gl - wl).abs().max()))
            if gpos != wpos or [n for n, _ in gleaves] != [n for n, _ in wleaves]:
                raise AssertionError(f"{name}: pos or cache layout differ card vs cpu at {step}")
            for (leaf, g), (_, w) in zip(gleaves, wleaves):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{name}: cache leaf {leaf} is {g.dtype} "
                                         f"{tuple(g.shape)} on the card, {w.dtype} "
                                         f"{tuple(w.shape)} on the cpu")
                if w.dtype == torch.int8:
                    diff = (g.int() - w.int()).abs()
                    if step == DECODE_STEPS:
                        flips = diff > 0
                        int8_row[leaf] = {"differ": int(flips.sum()),
                                          "off_ties": int((flips & ~ties[leaf]).sum()),
                                          "near_ties": int(ties[leaf].sum())}
                    if int(diff.max()) > 1:
                        raise AssertionError(f"{name}: int8 leaf {leaf} differs by "
                                             f"{int(diff.max())} steps card vs cpu")
                    continue
                tol = INT8_SCALE_ATOL if leaf.endswith("scale") else DECODE_ATOL
                e = float((g.double() - w.double()).abs().max())
                if not e <= tol:
                    raise AssertionError(f"{name}: cache leaf {leaf} after step {step} "
                                         f"differs card vs cpu by {e} (atol {tol})")
        row = {"prefill_vs_forward_err": prefill_err, "logits_err_by_step": errs,
               "pos": got[-1][1], "ring": next((tuple(t.shape) for n, t in got[-1][2]
                                                if n == "ring"), None)}
        if int8:
            row["int8"] = {k: sum(r[k] for r in int8_row.values())
                           for k in ("differ", "off_ties", "near_ties")}
            row["int8"]["values"] = sum(t.numel() for n, t in got[-1][2]
                                        if t.dtype == torch.int8)
        log(f"  {name} {cfg.layer_types}: {json.dumps(row)}")
        tol = LOGITS_ATOL if int8 else DECODE_ATOL
        if not (prefill_err <= PREFILL_FORWARD_ATOL and max(errs) <= tol):
            raise AssertionError(f"{name}: prefill vs forward {prefill_err} (atol "
                                 f"{PREFILL_FORWARD_ATOL}), card vs cpu logits {errs} (atol {tol})")
        if int8 and row["int8"]["off_ties"]:
            raise AssertionError(f"{name}: int8 values differ card vs cpu away from rounding "
                                 f"ties: {row['int8']}")
        out[name] = row
        del cpu, card
    return out


def decode_bound(model, cache: dict, batch: int) -> dict:
    """The least time of one decode step: the bytes it must move over the
    card's memory rate — every weight once (the embedding table only for
    the batch's rows where the head is untied; a MoE's every expert, as 64
    tokens top-k route to all of them), each attention layer's k/v cache
    read and one slot of it written, each recurrent and conv state read
    and written."""
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    if model.head is not None:
        weights -= model.tok.numel() * model.tok.element_size()
        weights += batch * model.tok.shape[1] * model.tok.element_size()
    kv = state = 0
    for layer in cache["layers"]:
        if "k" in layer:
            for name, t in layer.items():
                kv += t.numel() * t.element_size() * (1 + 1 / t.shape[1])
        else:
            state += 2 * sum(t.numel() * t.element_size() for t in layer.values())
    nbytes = weights + kv + state
    return {"bytes": nbytes, "weight_bytes": weights, "kv_bytes": kv, "state_bytes": state,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def decode_split(run) -> dict:
    """One decode step under ``torch.profiler`` (card and host), begun after
    a pause and bracketed by spin kernels: wall ms, device ms, idle share,
    kernel launches, and the device time split into attention (every
    kernel under the ``DECODE_RANGE`` ranges: slot writes, dequantize,
    scores, softmax, weighted sum), cuBLAS outside them, elementwise
    kernels and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    time.sleep(PAUSE_S)
    with attention_range(), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(SENTINELS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    rows = [e for e in device_events(prof) if "spin_kernel" not in e.key and e.key != DECODE_RANGE]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    attn = sum(us for e in prof.events()
               if e.name == DECODE_RANGE and e.device_type == DeviceType.CPU
               for _, us in range_kernels(e)) / 1e3
    gemm = lambda k: any(m in k.lower() for m in GEMM_MARKS)
    attn_gemm = sum(us for e in prof.events()
                    if e.name == DECODE_RANGE and e.device_type == DeviceType.CPU
                    for k, us in range_kernels(e) if gemm(k)) / 1e3
    cublas = sum(e.self_device_time_total for e in rows if gemm(e.key)) / 1e3 - attn_gemm
    attn_elementwise = sum(us for e in prof.events()
                           if e.name == DECODE_RANGE and e.device_type == DeviceType.CPU
                           for k, us in range_kernels(e)
                           if not gemm(k) and "elementwise" in k.lower()) / 1e3
    elementwise = sum(e.self_device_time_total for e in rows
                      if not gemm(e.key) and "elementwise" in e.key.lower()) / 1e3
    elementwise -= attn_elementwise
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "launches": sum(e.count for e in rows),
            "attention_ms": attn, "cublas_ms": cublas, "elementwise_ms": elementwise,
            "other_ms": busy - attn - cublas - elementwise}


def greedy_decode(model, prompt, steps: int, extra_slots: int, profile_last: bool = False):
    """Prefill ``prompt`` then ``steps`` greedy steps (argmax over the real
    vocabulary): ``(prefill ms, per-step ms, logits (B, steps + 1, V), the
    fed tokens (B, steps), the last step's profile or None)``, each step
    timed on the host clock to a synchronize; with ``profile_last`` the
    last step runs under :func:`decode_split` instead."""
    V = model.cfg.vocab_size
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = counted_prefill(model, prompt, extra_slots=extra_slots)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, fed, step_ms, split = [logits], [], [], None
    for i in range(steps):
        nxt = logits[:, :V].argmax(-1, keepdim=True)
        fed.append(nxt)
        if profile_last and i == steps - 1:
            held = []
            split = decode_split(lambda: held.append(model.decode_step(cache, nxt)[0]))
            logits = held[0]
        else:
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, nxt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
    return prefill_ms, step_ms, torch.stack(out, 1), torch.cat(fed, 1), split


def forward_tail(model, tokens, n: int):
    """The forward's logits at the last ``n`` positions of ``tokens``."""
    with torch.inference_mode():
        h, _ = model.backbone(model.embed(tokens))
        return model.logits(h[:, -n:])


def decode_vs_forward(model, prompt, logits, fed) -> dict:
    """Decode logits (the prefill's and each step's) against the forward's
    over the prompt and the fed tokens: the largest gap, the largest
    |logit|, and how many greedy picks agree."""
    V = model.cfg.vocab_size
    want = forward_tail(model, torch.cat([prompt, fed], 1), logits.shape[1])
    gap = float((logits.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    agree = int((logits[..., :V].argmax(-1) == want[..., :V].argmax(-1)).sum())
    return {"max_abs_err": gap, "max_abs_logit": top, "err_share": gap / top,
            "argmax_agree": agree, "positions": int(logits.shape[0] * logits.shape[1])}


def rounding_sensitivity(model, tokens, n: int) -> dict:
    """How far the forward's logits at the last ``n`` positions move when
    every ``PERTURB_EVERY``-th element of the embeddings is scaled by ``1 +
    2^-8`` (one bf16 ulp): the largest move as a share of the largest
    |logit|, and how many argmaxes stay."""
    V = model.cfg.vocab_size
    with torch.inference_mode():
        h = model.embed(tokens)
        want = model.logits(model.backbone(h)[0][:, -n:])
        flat = h.view(-1)[::PERTURB_EVERY]
        flat.copy_((flat.float() * (1.0 + 2.0 ** -8)).to(h.dtype))
        got = model.logits(model.backbone(h)[0][:, -n:])
    top = float(want.float().abs().max())
    return {"err_share": float((got.float() - want.float()).abs().max()) / top,
            "argmax_agree": int((got[..., :V].argmax(-1) == want[..., :V].argmax(-1)).sum()),
            "positions": int(want.shape[0] * want.shape[1])}


def width_check(dev, arch: str, seed: int, prompt) -> dict:
    """The decode path at published width and depth in f32 (TF32 off):
    ``CHECK_QUERIES`` of the prompts (or, for a windowed arch, whose
    prompts are shorter than its window (F4), ``LONG_PREFILL`` random
    tokens at B=2, past the window), ``CHECK_STEPS`` greedy steps, the
    logits against the forward's over the same tokens within
    ``CHECK_SHARE`` of the largest logit; MoE at capacity ``MOE_CHECK_CAPACITY``, so no token is
    dropped."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, expert_capacity_factor=MOE_CHECK_CAPACITY)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device=dev, seed=seed)
    if model.window > prompt.shape[1]:
        g = torch.Generator(device=dev).manual_seed(seed)
        prompt = torch.randint(0, 512, (2, LONG_PREFILL), generator=g, device=dev)
    else:
        prompt = prompt[:CHECK_QUERIES]
    _, _, logits, fed, _ = greedy_decode(model, prompt, CHECK_STEPS, CHECK_STEPS)
    out = {**decode_vs_forward(model, prompt, logits, fed), "batch": int(prompt.shape[0]),
           "prefill": int(prompt.shape[1]), "window": model.window,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del model, logits
    torch.cuda.empty_cache()
    return out


def width_prompt(dev) -> torch.Tensor:
    """(b)'s prompts: ``WIDTH_QUERIES`` queries of ``WIDTH_PROMPT`` tokens
    of ``make_token_task``."""
    from repro_torch.data import make_token_task

    task = make_token_task(4, WIDTH_PROMPT + 1, 512, n=WIDTH_QUERIES, seed=3)
    return torch.as_tensor(task["tokens"][:, :-1], device=dev).long()


def width_decode(dev, arch: str, seed: int) -> dict:
    """(b) ``arch`` at published width in bf16 alone on the card: prefill
    ``WIDTH_QUERIES`` queries of ``WIDTH_PROMPT`` tokens of
    ``make_token_task`` with ``extra_slots=WIDTH_STEPS`` (timed: the median
    of 3 after a warm-up), ``WIDTH_STEPS`` greedy steps (median step ms,
    tokens/s), peak memory, one profiled step's split, the bound per step
    and the decode logits' gap to the forward's over the same tokens
    (printed: recurrentgemma's 127 tokens are shorter than its local
    window, the F4 regime). Then :func:`width_check` holds the decode path
    in f32."""
    from repro_torch.configs import get_config
    from repro_torch.models import LM

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LM(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = width_prompt(dev)
    greedy_decode(model, prompt, 1, WIDTH_STEPS)                     # warm-up
    _, cache = counted_prefill(model, prompt, extra_slots=WIDTH_STEPS)
    bound = decode_bound(model, cache, WIDTH_QUERIES)
    del cache
    prefill_ms, step_ms = [], []
    for rep in range(3):
        p_ms, s_ms, logits, fed, split = greedy_decode(model, prompt, WIDTH_STEPS, WIDTH_STEPS,
                                                       profile_last=rep == 2)
        prefill_ms.append(p_ms)
        step_ms += s_ms
    step = float(np.median(step_ms))
    gap = decode_vs_forward(model, prompt, logits, fed)
    gap["forward_sensitivity"] = rounding_sensitivity(model, torch.cat([prompt, fed], 1),
                                                      logits.shape[1])
    row = {"params_b": sum(p.numel() for p in model.parameters()) / 1e9, "init_s": init_s,
           "prefill_ms": float(np.median(prefill_ms)), "prefill_ms_all": prefill_ms,
           "decode_step_ms": step, "decode_step_ms_spread": [min(step_ms), max(step_ms)],
           "decode_tokens_per_s": WIDTH_QUERIES / step * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step_profile": split, "bound": bound, "bound_share": bound["bound_ms"] / step,
           ("bf16_f4_gap" if model.window > WIDTH_PROMPT else "bf16_gap"): gap}
    del model, logits
    row["f32_check"] = check = width_check(dev, arch, seed, prompt)
    log(f"  {arch} ({cfg.num_layers} layers, {row['params_b']:.2f} B bf16 params): "
        f"{json.dumps(row)}")
    if not check["err_share"] <= CHECK_SHARE:
        raise AssertionError(f"{arch}: f32 decode logits differ from the forward's by "
                             f"{check['max_abs_err']}, {check['err_share']:.3g} of the largest "
                             f"logit (limit {CHECK_SHARE})")
    return row


def decode_phase(dev) -> dict:
    """Phase 18: (a) and (b) above, and the model kernels' launch counts
    (zeroed before the phase; read after (a) and after the whole phase)
    and those of the prefills alone: (a)'s prefills must launch all
    three."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    PREFILL_LAUNCHES.clear()
    out, seconds = {}, {}
    t = time.perf_counter()
    log("  (a) SMOKE, f32: prefill and decode, card vs cpu")
    out["smoke"] = smoke_decode(dev)
    seconds["smoke_s"] = time.perf_counter() - t
    out["smoke_launches"] = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
    out["smoke_prefill_launches"] = dict(PREFILL_LAUNCHES)
    out["width"] = {}
    for i, arch in enumerate(DECODE_ARMS):
        t = time.perf_counter()
        log(f"  (b) {arch} at published width, bf16: prefill {WIDTH_QUERIES} x {WIDTH_PROMPT}, "
            f"{WIDTH_STEPS} decode steps")
        out["width"][arch] = width_decode(dev, arch, seed=500 + i)
        seconds[f"{arch}_s"] = time.perf_counter() - t
    out["launches"] = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
    out["prefill_launches"] = dict(PREFILL_LAUNCHES)
    out["seconds"] = seconds
    log(f"  launches in phase 18: {json.dumps(out['launches'])}, by its prefills "
        f"{json.dumps(out['prefill_launches'])} (SMOKE part: {json.dumps(out['smoke_launches'])}, "
        f"by its prefills {json.dumps(out['smoke_prefill_launches'])})")
    for name in MODEL_KERNELS:
        if out["smoke_prefill_launches"].get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was never launched by the SMOKE prefills")
    return out


def decode_summary(dec: dict, smi: str) -> dict:
    """The ``[decode]`` line: (b)'s numbers beside the card's name and power
    limit."""
    keys = ("prefill_ms", "decode_step_ms", "decode_tokens_per_s", "peak_memory_gb",
            "bound", "bound_share", "step_profile", "bf16_gap", "bf16_f4_gap", "f32_check")
    return {"card": smi, "queries": WIDTH_QUERIES, "prompt": WIDTH_PROMPT, "steps": WIDTH_STEPS,
            "arms": {a: {k: r[k] for k in keys if k in r} for a, r in dec["width"].items()},
            "seconds": dec["seconds"]}


# ---------------------------------------------------------------------------
# phase 19: the launch tools
# ---------------------------------------------------------------------------

DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_TRAIN_ARCH = "smollm-135m"         # (a): its train_4k cell, after every arch's decode_32k
EP_ARCH = "granite-moe-1b-a400m"          # (c): at published width and depth, f32
EP_ATOL = 1e-5                            # (c): one layer's output and aux, card EP vs card dense
EP_FORWARD_ATOL = 1e-4                    # (c): the logits, EP forward vs dense forward
REPLICAS_PROBE = 4                        # (d)


def dryrun_cells() -> list:
    """(a) The dry run's CLI on meta, in process: every arch's
    ``decode_32k`` cell at 16x16, then smollm-135m's ``train_4k``."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import dryrun

    cells = [(a, "decode_32k") for a in list_archs()] + [(DRYRUN_TRAIN_ARCH, "train_4k")]
    rows = []
    for arch, shape in cells:
        (rec,) = dryrun.main(["--arch", arch, "--shape", shape, "--out", str(DRYRUN_OUT)])
        if "error" in rec:
            raise AssertionError(f"dry run of {arch} x {shape}: {rec['error']}\n"
                                 f"{rec['traceback']}")
        t = rec["roofline"]
        row = {"arch": arch, "shape": shape, "gb_per_device": rec["analytic_memory"]["total"] / 1e9,
               "fits_hbm": rec["fits_hbm"], "compute_ms": t["compute_s"] * 1e3,
               "memory_ms": t["memory_s"] * 1e3, "collective": rec["collective_note"],
               "bottleneck": t["bottleneck"], "counted_flops": rec["counted_flops"],
               "analytic_flops": rec["analytic_flops_total"],
               "counted_share": rec["counted_flops"] / rec["analytic_flops_total"],
               "argument_gb_per_device": rec["argument_bytes_per_device"] / 1e9,
               "trace_s": rec["trace_s"]}
        log(f"  [dryrun] {json.dumps(row)}")
        rows.append(row)
    return rows


def roofline_row(arch: str, shape, measured_ms: float, peak_gb: float) -> dict:
    """(b) One timed shape's measured ms and peak GB beside its one-card
    roofline bound and analytic memory."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.roofline import (analytic_bytes, analytic_flops, analytic_memory,
                                             roofline_terms)

    cfg = get_config(arch)
    terms = roofline_terms(analytic_flops(cfg, shape)["total"],
                           analytic_bytes(cfg, shape)["total"], 0.0, 1, HW)
    mem_gb = analytic_memory(cfg, shape, dp=1, tp=1)["total"] / 1e9
    bound_ms = terms["step_s_lower_bound"] * 1e3
    return {"arch": arch, "kind": shape.kind, "batch": shape.global_batch,
            "seq": shape.seq_len, "measured_ms": measured_ms, "bound_ms": bound_ms,
            "bottleneck": terms["bottleneck"], "measured_over_bound": measured_ms / bound_ms,
            "peak_gb": peak_gb, "analytic_gb": mem_gb, "peak_over_analytic": peak_gb / mem_gb}


def roofline_shares(full: dict, width: dict) -> dict:
    """(b) Phase 16 (c)'s training step and phase 18 (b)'s decode steps
    beside their bounds (printed, not gated)."""
    from repro_torch.models import ShapeConfig

    rows = [roofline_row("smollm-135m",
                         ShapeConfig("phase16", full["seq"], full["batch"], "train"),
                         full["step_ms_median"], full["peak_memory_gb"])]
    for arch, r in width.items():
        shape = ShapeConfig("phase18", WIDTH_PROMPT + WIDTH_STEPS, WIDTH_QUERIES, "decode")
        rows.append(roofline_row(arch, shape, r["decode_step_ms"], r["peak_memory_gb"]))
    for row in rows:
        log(f"  [roofline] {json.dumps(row)}")
    return {"rows": rows}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def ep_check(dev) -> dict:
    """(c) Expert parallelism at ``EP_ARCH``'s published width and depth in
    f32 over a world-size-1 NCCL ``DeviceMesh``, on phase 18's token batch,
    at capacity factor E / k: the dense capacity is then every token, and
    the EP path's two stages hold at least as many, so neither drops one.
    One model runs the forward twice: without sharding rules (the dense
    ``moe_mlp``), then under the rules, where every MoE layer must go
    through ``moe_mlp_ep`` (each call counted). The first MoE layer's own
    input and weights, as the forward handed them over, then go through
    ``moe_mlp_ep`` and ``moe_mlp`` alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.kernels import ops
    from repro_torch.models import LM, blocks
    from repro_torch.models.moe import moe_mlp, moe_mlp_ep

    cfg = get_config(EP_ARCH)
    cfg = dataclasses.replace(cfg, dtype="float32", moe_ep=True,
                              expert_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    tokens = width_prompt(dev)
    calls = []
    dispatch = blocks.moe_mlp_ep

    def counted(*args, **kwargs):
        calls.append(None if calls else args)           # keep the first layer's inputs
        return dispatch(*args, **kwargs)

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        model = LM(cfg, device=dev, seed=19)
        flash_before = ops.flash_attention.launches
        blocks.moe_mlp_ep = counted
        try:
            with torch.no_grad():
                dense = model(tokens)
                if calls:
                    raise AssertionError("the forward without sharding rules called moe_mlp_ep")
                with use_rules(AxisRules(mesh)):
                    ep_logits = model(tokens)
        finally:
            blocks.moe_mlp_ep = dispatch
        flash_launches = ops.flash_attention.launches - flash_before
        x, rw, wg, wu, wd, k, cap = calls[0][:7]
        with torch.no_grad():
            y, aux = moe_mlp_ep(x, rw, wg, wu, wd, k, cap, mesh)
            y_d, aux_d = moe_mlp(x, rw, wg, wu, wd, k, cap)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    moe_layers = cfg.layer_types.count("moe")
    out = {"arch": EP_ARCH, "dtype": "float32", "tokens": list(tokens.shape),
           "capacity_factor": cfg.expert_capacity_factor, "moe_layers": moe_layers,
           "ep_calls": len(calls), "flash_launches": flash_launches, "y_err": float((y - y_d).abs().max()),
           "y_max": float(y_d.abs().max()), "aux_err": float((aux - aux_d).abs()),
           "forward_err": float((ep_logits - dense).abs().max()),
           "forward_max_logit": float(dense.abs().max()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seconds": time.perf_counter() - t0}
    del model, dense, ep_logits, calls, x, y, y_d
    torch.cuda.empty_cache()
    log(f"  [moe_ep] world 1, NCCL: {json.dumps(out)}")
    if out["flash_launches"] <= 0:
        raise AssertionError(f"the two {EP_ARCH} forwards never launched flash_attention")
    if out["ep_calls"] != moe_layers:
        raise AssertionError(f"{out['ep_calls']} moe_mlp_ep calls in the forward under "
                             f"cfg.moe_ep, want one per MoE layer ({moe_layers})")
    if not (out["y_err"] <= EP_ATOL and out["aux_err"] <= EP_ATOL):
        raise AssertionError(f"moe_mlp_ep on the card differs from moe_mlp: {out}")
    if not out["forward_err"] <= EP_FORWARD_ATOL:
        raise AssertionError(f"{EP_ARCH}'s forward under moe_ep differs from the dense one: {out}")
    return out


def launch_phase(dev, full: dict, width: dict) -> dict:
    """Phase 19: (a)-(d) above."""
    from repro_torch.distributed import replica_mesh

    out = {}
    t = time.perf_counter()
    log("  (a) the dry run on meta: decode_32k for every arch at 16x16, smollm-135m train_4k")
    out["dryrun"] = dryrun_cells()
    out["dryrun_s"] = time.perf_counter() - t
    log("  (b) measured vs roofline bound: phase 16's training step, phase 18's decode steps")
    out["roofline"] = roofline_shares(full, width)
    log(f"  (c) {EP_ARCH} at published width, f32: the forward under moe_ep over a "
        f"world-size-1 NCCL DeviceMesh vs the dense forward, one layer's moe_mlp_ep vs moe_mlp")
    out["ep"] = ep_check(dev)
    mesh = replica_mesh(REPLICAS_PROBE, dev)
    log(f"  (d) replica_mesh({REPLICAS_PROBE}) on {torch.cuda.device_count()} card(s): {mesh}")
    if torch.cuda.device_count() == 1 and mesh is not None:
        raise AssertionError(f"replica_mesh({REPLICAS_PROBE}) on one card: {mesh}, want None")
    return out


# ---------------------------------------------------------------------------
# phase 20: the sharded train step over torch.distributed
# ---------------------------------------------------------------------------

SHARDED_STEPS = 3                          # (a): of phase 16's 8 x 512 batches
SHARDED_ARCHS = ("smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b", "granite-moe-1b-a400m")
SHARDED_SMOKE_STEPS = 2                    # (b), (d)
SHARDED_REL = 1e-5                         # losses (tests/test_distributed.py's bounds)
SHARDED_ATOL = 5e-5                        # parameters and optimizer state
LAUNCHER = ["--arch", "smollm-135m", "--save-every", "10"]   # (e), at published width
LAUNCHER_BATCH = (8, 64)                   # the launcher's default --batch and --seq
FULL_WORLD_STEPS = 11                      # (d) 2x2 at full width: the launcher's steps 0-10
LAUNCHER_REL = 1e-2     # bf16 losses, mesh vs one card: 3x the 3.3e-3 (d) 2x2 measured


def state_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over the tensor leaves of two nested dict states (f32)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"states with other keys: {sorted(a)} vs {sorted(b)}")
        return max((state_diff(a[k], b[k]) for k in a), default=0.0)
    return float((a.detach().float() - b.detach().float().to(a.device)).abs().max())


def to_cpu(tree):
    """A nested dict of tensors copied to the host."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def train_pair(dev, mesh, build, batches, opt_cfg, on_sharded=None) -> dict:
    """The same model (``build()``) trained on ``batches`` twice: sharded
    under ``AxisRules(mesh)`` (the model distributed by
    ``init_train_state``), then unsharded. Per side its losses, step ms,
    peak GB and whole final state; the sharded side's model-kernel
    launches, counted from 0 around its steps alone. ``on_sharded(state)``
    runs on the sharded state before it is gathered."""
    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.distributed.sharding import gather, is_distributed
    from repro_torch.kernels import ops
    from repro_torch.training import init_train_state, make_train_step

    out = {}
    for side in ("sharded", "unsharded"):
        model = build()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        rules = use_rules(AxisRules(mesh)) if side == "sharded" else contextlib.nullcontext()
        with rules:
            params, opt = init_train_state(model)
            step = make_train_step(model, opt_cfg)
            ops.reset_launch_counts()
            losses, step_ms = [], []
            for batch in batches:
                t0 = time.perf_counter()
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))              # reads back: the step is done
                step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: getattr(ops, k).launches for k in MODEL_KERNELS}
            extra = on_sharded({"params": params, "opt": opt}) if (
                side == "sharded" and on_sharded) else None
            whole = gather({"params": {k: p.detach() for k, p in params.items()}, "opt": opt})
        out[side] = {"losses": losses, "step_ms": step_ms, "state": whole,
                     "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None,
                     "params": len(params),
                     "distributed": sum(is_distributed(p) for p in params.values())}
        if side == "sharded":
            out[side].update(launches=launches, extra=extra)
        del model, params, opt, step
        if cuda:
            torch.cuda.empty_cache()
    sh, un = out["sharded"], out["unsharded"]
    out["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(sh["losses"], un["losses"]))
    out["state_max_abs"] = state_diff(sh["state"], un["state"])
    out["bitwise"] = sh["losses"] == un["losses"] and out["state_max_abs"] == 0.0
    return out


def sharded_checkpoint(state: dict) -> dict:
    """(c) A sharded ``CheckpointManager.save`` (every leaf gathered, host 0
    writes) and ``restore_latest`` into the same sharded template, timed;
    the restored leaves equal the saved ones bitwise and keep their
    placements."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.sharding import gather

    ckpt = ROOT / "build" / "train_ckpt" / "chip_smoke_sharded"
    shutil.rmtree(ckpt, ignore_errors=True)
    mgr = CheckpointManager(str(ckpt))
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t0 = time.perf_counter()
    mgr.save(SHARDED_STEPS, state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, restored = mgr.restore_latest(state)
    sync()
    restore_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in ckpt.rglob("*") if f.is_file())
    files = sorted(p.name for p in ckpt.glob("step_*/*"))
    shutil.rmtree(ckpt, ignore_errors=True)
    same_layout = all(restored["params"][k].placements == p.placements
                      for k, p in state["params"].items())
    diff = state_diff(gather(restored), gather(state))
    out = {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s, "files": files,
           "restored_step": step, "max_abs": diff, "placements_kept": same_layout}
    log(f"  (c) sharded checkpoint round trip: {json.dumps(out)}")
    if step != SHARDED_STEPS or diff != 0.0 or not same_layout or files != ["meta.json",
                                                                            "shard_0.npz"]:
        raise AssertionError(f"the sharded checkpoint did not round-trip: {out}")
    return out


def gather_host_ms(prof) -> dict:
    """(a) Host ms of a traced train step by what it ran: the gathers at use
    (each ``unshard`` range, forward and remat recompute, and the backward
    nodes of its ``redistribute`` and ``to_local``), the ``adamw_update``
    and ``constrain_params`` ranges, each the union of its events' spans
    over every thread."""
    from torch.autograd import DeviceType

    def union_ms(match) -> float:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CPU and match(e.name))
        total, end = 0.0, float("-inf")
        for a, b in spans:
            total += max(0.0, b - max(a, end))
            end = max(end, b)
        return total / 1e3

    fwd = lambda name: name == "unshard"
    bwd = lambda name: name.endswith(("RedistributeBackward", "_ToTorchTensorBackward"))
    return {"host_gather_forward_ms": union_ms(fwd), "host_gather_backward_ms": union_ms(bwd),
            "host_gathers_ms": union_ms(lambda name: fwd(name) or bwd(name)),
            "host_adamw_ms": union_ms(lambda name: name == "adamw_update"),
            "host_constrain_ms": union_ms(lambda name: name == "constrain_params"),
            "unshard_ranges": sum(e.name == "unshard" for e in prof.events())}


@contextlib.contextmanager
def labelled_ranges():
    """``unshard`` (as the model calls it), ``adamw_update`` and
    ``constrain_params`` (as the train step calls them) each under a
    profiler range of its own name."""
    from unittest import mock

    from torch.profiler import record_function

    import repro_torch.models.model as model_mod
    import repro_torch.training.train_loop as loop_mod

    def labelled(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    with mock.patch.object(model_mod, "unshard", labelled("unshard", model_mod.unshard)), \
            mock.patch.object(loop_mod, "adamw_update",
                              labelled("adamw_update", loop_mod.adamw_update)), \
            mock.patch.object(loop_mod, "constrain_params",
                              labelled("constrain_params", loop_mod.constrain_params)):
        yield


def sharded_profile(dev, mesh, build, batches, opt_cfg) -> dict:
    """(a) One step of each side, sharded and unsharded, each on a model of
    its own after two untraced steps, through :func:`profiled_step`: wall
    ms, device ms and idle share from a trace of the card alone; from a
    trace of the host too, the device split and the host ms of the gathers
    at use, the AdamW update and the layout pins (:func:`gather_host_ms`)."""
    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.training import init_train_state, make_train_step

    out = {}
    for side in ("sharded", "unsharded"):
        model = build()
        rules = use_rules(AxisRules(mesh)) if side == "sharded" else contextlib.nullcontext()
        with rules, labelled_ranges():
            params, opt = init_train_state(model)
            step = make_train_step(model, opt_cfg)
            state = [params, opt]

            def run(batch):
                state[0], state[1], _ = step(state[0], state[1], batch)

            for batch in batches[:2]:
                run(batch)
            out[side] = profiled_step(lambda: run(batches[2]), host_split=gather_host_ms)
        del model, params, opt, step, state
        torch.cuda.empty_cache()
    return out


def case_config(case: dict):
    """The model config of a (d) case: the arch's SMOKE or published
    config, in ``case["dtype"]`` where one is named."""
    from repro_torch.configs import get_config, get_smoke_config

    cfg = (get_smoke_config if case["smoke"] else get_config)(case["arch"])
    return dataclasses.replace(cfg, dtype=case["dtype"]) if case["dtype"] else cfg


def train_case(dev, case: dict) -> dict:
    """A (d) case trained on its batches on ``dev`` under whatever sharding
    rules are active (every rank of a mesh calls it): its losses and, where
    ``case["state"]``, its whole final state on the host."""
    from repro_torch.distributed.sharding import gather
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

    model = LM(case_config(case), device=dev if case["init_on_card"] else "cpu",
               seed=case["seed"]).to(dev)
    params, opt = init_train_state(model)
    step = make_train_step(model, OptimizerConfig(**case["opt"]))
    losses = []
    for b in case["batches"]:
        params, opt, m = step(params, opt, {k: v.to(dev) for k, v in b.items()})
        losses.append(float(m["loss"]))
    state = (to_cpu(gather({"params": {k: p.detach() for k, p in params.items()}, "opt": opt}))
             if case["state"] else None)
    return {"losses": losses, "state": state}


def sharded_world_rank(rank: int, shape: tuple, port: int, path: str, device_type: str,
                       cases: dict) -> None:
    """(d) One rank of a world of ``data x model = shape`` ranks (NCCL on
    cards, gloo on the CPU) on a ``("data", "model")`` mesh: every case of
    ``cases`` trained sharded (:func:`train_case`); rank 0 saves the
    results to ``path``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.launch.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device_type == "cuda"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=shape[0] * shape[1], rank=rank,
                            **({"device_id": dev} if cuda else {}))
    try:
        mesh = make_mesh(shape, ("data", "model"), device_type)
        out = {}
        for name, case in cases.items():
            with use_rules(AxisRules(mesh)):
                out[name] = train_case(dev, case)
        if rank == 0:
            torch.save(out, path)
    finally:
        dist.destroy_process_group()


def sharded_world(device_type: str, shape: tuple, cases: dict, want: dict) -> dict:
    """(d) :func:`sharded_world_rank` on ``data x model`` spawned ranks,
    each on its own card; each case's losses (step by step) and, where it
    keeps one, whole state against ``want``'s, within the case's
    ``loss_rel`` bound and :data:`SHARDED_ATOL`."""
    import multiprocessing

    world = shape[0] * shape[1]
    path = ROOT / "build" / "train_ckpt" / "chip_smoke_sharded_world.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=sharded_world_rank,
                         args=(r, shape, port, str(path), device_type, cases))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"the {shape[0]}x{shape[1]} world's ranks exited with {codes}")
    got = torch.load(path)
    path.unlink()
    out = {"mesh": f"{shape[0]}x{shape[1]}", "seconds": time.perf_counter() - t0}
    for name, case in cases.items():
        rels = [abs(a - b) / abs(b) for a, b in zip(got[name]["losses"], want[name]["losses"])]
        out[name] = {"losses": got[name]["losses"], "loss_rel_by_step": rels,
                     "loss_rel": max(rels)}
        if case["state"]:
            out[name]["state_max_abs"] = state_diff(got[name]["state"], want[name]["state"])
        if max(rels) > case["loss_rel"] or out[name].get("state_max_abs", 0.0) > SHARDED_ATOL:
            raise AssertionError(f"{name} on {out['mesh']} differs from one card: {out[name]}")
    return out


def launcher_batches(cfg, steps: int) -> list:
    """The training launcher's first ``steps`` batches (no frontend): its
    draws, in its order."""
    rng = np.random.default_rng(0)
    return [{"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (LAUNCHER_BATCH[0],
                                                                         LAUNCHER_BATCH[1])
                                                     ).astype(np.int32))}
            for _ in range(steps)]


def launch_timed(module: str, args: list) -> dict:
    """A launcher run (``run_cli``): its wall and step-loop seconds, its
    printed losses by step and its lines."""
    t0 = time.perf_counter()
    lines = run_cli(module, args).strip().splitlines()
    return {"wall_s": time.perf_counter() - t0,
            "loop_s": float(lines[-1].split()[2].rstrip("s")),
            "losses": {int(w[1]): float(w[3]) for w in map(str.split, lines)
                       if w and w[0] == "step"},
            "lines": lines}


def launcher_world() -> dict:
    """(e) The training launcher at smollm-135m's published width in bf16:
    20 steps on one card unsharded; 20 steps under ``torchrun`` on four
    cards as a 2x2 mesh (NCCL, checkpoints every 10); then from that run's
    step-10 checkpoint, resumed to 30 on two cards as 1x2 and, from a copy
    of it, on one card unsharded. Every run exits 0 and both resumed runs
    start from step 10. Every loss the mesh runs print is held to the one-card
    run's at the same step from the same start: step 0 (the same weights and
    batch, before any update) equal as printed, the later steps within
    :data:`LAUNCHER_REL` (bf16: the gradient sums over ranks round otherwise
    than one card's; (d)'s full-width runs show the f32 gap)."""
    ckpt = ROOT / "build" / "train_ckpt" / "chip_smoke_launcher"
    shutil.rmtree(ckpt, ignore_errors=True)
    one = lambda steps, where: LAUNCHER + ["--steps", str(steps), "--ckpt", str(ckpt / where)]
    torchrun = lambda n, mesh, steps: ["--standalone", "--nproc-per-node", str(n), "-m",
                                       "repro_torch.launch.train", *LAUNCHER, "--steps",
                                       str(steps), "--ckpt", str(ckpt / "mesh"), "--mesh", mesh]
    out = {"one_card": launch_timed("repro_torch.launch.train", one(20, "one")),
           "mesh_2x2": launch_timed("torch.distributed.run", torchrun(4, "2x2", 20))}
    shutil.copytree(ckpt / "mesh", ckpt / "from_mesh")
    out["mesh_1x2_resumed"] = launch_timed("torch.distributed.run", torchrun(2, "1x2", 30))
    out["one_card_resumed"] = launch_timed("repro_torch.launch.train", one(30, "from_mesh"))
    shutil.rmtree(ckpt, ignore_errors=True)
    for run in ("one_card_resumed", "mesh_1x2_resumed"):
        if "resumed from step 10" not in out[run]["lines"]:
            raise AssertionError(f"the {run} run did not resume: {out[run]['lines']}")
    want = {**out["one_card"]["losses"], **out["one_card_resumed"]["losses"]}
    got = {**out["mesh_2x2"]["losses"], **out["mesh_1x2_resumed"]["losses"]}
    if got.keys() != want.keys() or got[0] != want[0]:
        raise AssertionError(f"printed losses differ: mesh {got}, one card {want}")
    rels = {s: abs(got[s] - want[s]) / abs(want[s]) for s in sorted(want)}
    if max(rels.values()) > LAUNCHER_REL:
        raise AssertionError(f"mesh losses {got} vs one card's {want}: rel {rels}")
    res = {k: {m: v[m] for m in ("wall_s", "loop_s", "losses")} for k, v in out.items()}
    return {**res, "loss_rel_by_step": rels}


def sharded_summary(sh: dict) -> dict:
    """The ``[sharded]`` line: (a)'s comparison, step times, peak memory and
    profile beside phase 16's, the checkpoint round trip, (b)'s, (d)'s and
    (e)'s comparisons."""
    full = sh["full"]
    keys = ("steps", "batch", "seq", "bitwise", "equal_phase16_losses", "loss_rel",
            "state_max_abs", "sharded_losses", "phase16_losses", "step_ms", "unsharded_step_ms",
            "phase16_step_ms_median", "peak_memory_gb", "unsharded_peak_memory_gb",
            "phase16_peak_memory_gb", "launches", "checkpoint", "phase16_checkpoint",
            "profile")
    worlds = {}
    for key in ("world2", "world4"):
        w = sh[key]
        worlds[key] = ({k: ({m: x for m, x in v.items() if m != "losses"}
                            if isinstance(v, dict) else v) for k, v in w.items()}
                       if isinstance(w, dict) else w)
    return {"full": {k: full[k] for k in keys},
            "smoke": {a: {k: r[k] for k in ("loss_rel", "state_max_abs", "bitwise")}
                      for a, r in sh["smoke"].items()},
            "smoke_launches": sh["smoke_launches"], **worlds,
            "launcher": sh["launcher"], "seconds": {k: sh[k] for k in ("full_s", "smoke_s")}}


def sharded_phase(dev, full: dict) -> dict:
    """Phase 20: (a)-(e) above."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import make_token_task
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig

    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        t = time.perf_counter()
        B, S, steps = FULL_TRAIN
        cfg = get_config("smollm-135m")
        data = make_token_task(4, S, 512, n=B * steps, seed=0)["tokens"]
        batches = [{"tokens": torch.from_numpy(data[i * B:(i + 1) * B]).to(dev)}
                   for i in range(SHARDED_STEPS)]
        opt_cfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
        log(f"  (a) smollm-135m full width bf16 remat={cfg.remat}, {SHARDED_STEPS} steps of "
            f"{B}x{S} on a world-size-1 NCCL DeviceMesh (data 1, model 1) vs unsharded")
        a = train_pair(dev, mesh, lambda: LM(cfg, device=dev, seed=5), batches, opt_cfg,
                       on_sharded=sharded_checkpoint)
        sh = a["sharded"]
        want_flash = cfg.num_layers * SHARDED_STEPS * (2 if cfg.remat else 1)
        p16 = full["losses"][:SHARDED_STEPS]
        out["full"] = {
            "arch": "smollm-135m", "batch": B, "seq": S, "steps": SHARDED_STEPS,
            "sharded_losses": sh["losses"], "unsharded_losses": a["unsharded"]["losses"],
            "phase16_losses": p16, "equal_phase16_losses": sh["losses"] == p16,
            "loss_rel": a["loss_rel"], "state_max_abs": a["state_max_abs"],
            "bitwise": a["bitwise"], "distributed_params": sh["distributed"],
            "step_ms": sh["step_ms"], "unsharded_step_ms": a["unsharded"]["step_ms"],
            "phase16_step_ms_median": full["step_ms_median"],
            "peak_memory_gb": sh["peak_memory_gb"],
            "unsharded_peak_memory_gb": a["unsharded"]["peak_memory_gb"],
            "phase16_peak_memory_gb": full["peak_memory_gb"],
            "launches": sh["launches"], "checkpoint": sh["extra"],
            "phase16_checkpoint": full["checkpoint"]}
        log(f"  (a) {json.dumps({k: v for k, v in out['full'].items() if k != 'checkpoint'})}")
        if sh["distributed"] != sh["params"] or a["unsharded"]["distributed"]:
            raise AssertionError("the sharded run's parameters were not all DTensors")
        if a["loss_rel"] > SHARDED_REL or a["state_max_abs"] > SHARDED_ATOL:
            raise AssertionError(f"the sharded smollm-135m step differs from the unsharded: "
                                 f"loss rel {a['loss_rel']}, state {a['state_max_abs']}")
        if max(abs(x - y) / abs(y) for x, y in zip(sh["losses"], p16)) > SHARDED_REL:
            raise AssertionError(f"sharded losses {sh['losses']} vs phase 16's {p16}")
        if sh["launches"]["flash_attention"] != want_flash:
            raise AssertionError(f"flash_attention launched {sh['launches']['flash_attention']} "
                                 f"times in the sharded steps, want {want_flash}")
        del a, sh
        prof = sharded_profile(dev, mesh, lambda: LM(cfg, device=dev, seed=5), batches, opt_cfg)
        out["full"]["profile"] = prof
        log(f"  (a) one step profiled, sharded and unsharded: {json.dumps(prof)}")
        if prof["sharded"]["split_trace"]["unshard_ranges"] <= 0:
            raise AssertionError("the profiled sharded step gathered no parameter")
        out["full_s"] = time.perf_counter() - t

        t = time.perf_counter()
        Bs, Ss, _ = SMOKE_TRAIN
        log(f"  (b) {', '.join(SHARDED_ARCHS)} SMOKE f32, {SHARDED_SMOKE_STEPS} steps of "
            f"{Bs}x{Ss}: sharded (world 1) vs unsharded on the card")
        smoke, launches, cases = {}, dict.fromkeys(MODEL_KERNELS, 0), {}
        for i, arch in enumerate(SHARDED_ARCHS):
            scfg, seed = get_smoke_config(arch), 120 + i
            bs = smoke_batches(scfg, Bs, Ss, SHARDED_SMOKE_STEPS, np.random.default_rng(seed))
            cases[arch] = {"arch": arch, "smoke": True, "dtype": None, "seed": seed,
                           "init_on_card": False, "batches": bs, "state": True,
                           "opt": {"lr": 1e-3, "warmup_steps": 1}, "loss_rel": SHARDED_REL}
            r = train_pair(dev, mesh, lambda: LM(scfg, device="cpu", seed=seed).to(dev),
                           [{k: v.to(dev) for k, v in b.items()} for b in bs],
                           OptimizerConfig(**cases[arch]["opt"]))
            for k in MODEL_KERNELS:
                launches[k] += r["sharded"]["launches"][k]
            smoke[arch] = {"loss_rel": r["loss_rel"], "state_max_abs": r["state_max_abs"],
                           "bitwise": r["bitwise"], "losses": r["sharded"]["losses"],
                           "unsharded": {"losses": r["unsharded"]["losses"],
                                         "state": to_cpu(r["unsharded"]["state"])}}
            log(f"  {arch}: sharded losses {r['sharded']['losses']}, loss rel {r['loss_rel']:.3g},"
                f" state max abs {r['state_max_abs']:.3g}, bitwise {r['bitwise']}")
            if r["loss_rel"] > SHARDED_REL or r["state_max_abs"] > SHARDED_ATOL:
                raise AssertionError(f"{arch}: the sharded SMOKE step differs from the unsharded")
        log(f"  model kernel launches in (b)'s sharded steps: {launches}")
        if min(launches[k] for k in needed_kernels(SHARDED_ARCHS)) <= 0:
            raise AssertionError(f"a model kernel did not launch in the sharded steps: {launches}")
        out["smoke"] = {a: {k: v for k, v in r.items() if k != "unsharded"}
                        for a, r in smoke.items()}
        out["smoke_launches"] = launches
        out["smoke_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()

    n = torch.cuda.device_count()
    want = {a: r["unsharded"] for a, r in smoke.items()}
    if n >= 2:
        log("  (d) a 2-rank NCCL world (data 2, model 1) on cards 0-1 vs one card's (b)")
        out["world2"] = sharded_world("cuda", (2, 1), cases, want)
        log(f"  (d) {json.dumps(out['world2'])}")
    else:
        out["world2"] = f"not run: {n} card"
        log(f"  (d) not run: the 2-rank NCCL world needs two cards, this machine has {n}")
    if n >= 4:
        lb = launcher_batches(cfg, FULL_WORLD_STEPS)
        for dtype, bound in (("bfloat16", LAUNCHER_REL), ("float32", SHARDED_REL)):
            name = f"smollm-135m {dtype}"
            cases[name] = {"arch": "smollm-135m", "smoke": False, "dtype": dtype, "seed": 0,
                           "init_on_card": True, "batches": lb, "state": False,
                           "opt": {"lr": 3e-3, "warmup_steps": 10, "total_steps": 20},
                           "loss_rel": bound}
            want[name] = train_case(dev, cases[name])
            torch.cuda.empty_cache()
        log(f"  (d) a 2x2 NCCL world (data 2, model 2) on cards 0-3 vs one card: (b)'s "
            f"configs, and smollm-135m at published width in bf16 and f32 on the launcher's "
            f"first {FULL_WORLD_STEPS} batches")
        out["world4"] = sharded_world("cuda", (2, 2), cases, want)
        log(f"  (d) {json.dumps(out['world4'])}")
        log("  (e) the training launcher at full width: one card, then torchrun on 2x2, "
            "resumed on 1x2")
        out["launcher"] = launcher_world()
        log(f"  (e) {json.dumps(out['launcher'])}")
    else:
        out["world4"] = out["launcher"] = f"not run: {n} card(s)"
        log(f"  (d) 2x2 and (e) not run: the 2x2 mesh needs four cards, this machine has {n}")
    return out


# ---------------------------------------------------------------------------
# phase 21: the hostgamma planner baseline and the port's thriftlint
# ---------------------------------------------------------------------------

# the reference bench's raw-speed planner setting
# (benchmarks/serving_throughput.py:1066-1080): L arms, K classes, one
# theta for every group, numpy seed 47, CRN key 9, G drifted groups
HOSTGAMMA = {"L": 12, "K": 4, "theta": 200, "seed": 47, "key": 9, "groups": (1, 8, 64)}
PLANNERS = ("fused", "hostgamma", "hostgamma_kernel")


def hostgamma_cases() -> tuple:
    """``(b, {G: (ps, budgets, thetas)})``, drawn in the bench's order."""
    rng = np.random.default_rng(HOSTGAMMA["seed"])
    b = rng.uniform(0.05, 1.0, HOSTGAMMA["L"])
    cases = {}
    for G in HOSTGAMMA["groups"]:
        ps = rng.uniform(0.2, 0.98, (G, HOSTGAMMA["L"]))
        budgets = rng.uniform(0.4, 2.5, G)
        cases[G] = (ps, budgets, np.full(G, HOSTGAMMA["theta"]))
    return b, cases


def planner(name: str, where, b, case):
    """One plan of ``case`` on ``where`` by the fused plane or the hostgamma
    baseline (``use_kernel`` on for ``hostgamma_kernel``)."""
    from repro_torch.core import prng
    from repro_torch.core.selection import _sur_greedy_many_hostgamma, sur_greedy_many

    ps, budgets, thetas = case
    fn = sur_greedy_many if name == "fused" else _sur_greedy_many_hostgamma
    return fn(ps, b, budgets, HOSTGAMMA["K"], prng.key(HOSTGAMMA["key"], where), thetas,
              use_kernel=name == "hostgamma_kernel", device=where)


def plan_fields(r, f32_xi: bool = False) -> tuple:
    """Everything a plan derives: picks, s1, s2, l*, the three xi (rounded
    to f32 when held against the kernel's), cost, p*, gamma(s2)."""
    xi = [r.xi_est, r.xi_s1, r.xi_s2]
    if f32_xi:
        xi = [float(np.float32(x)) for x in xi]
    sets = [tuple(int(a) for a in x) if x is not None else None for x in (r.chosen, r.s1, r.s2)]
    return (*sets, r.l_star, *xi, r.cost, r.p_star, r.gamma_s2)


def hostgamma_phase(dev) -> dict:
    """(a) ``_sur_greedy_many_hostgamma`` (``use_kernel`` off and on) and
    ``sur_greedy_many`` on the card at G in ``HOSTGAMMA["groups"]``: every
    plan bitwise across the planes (the kernel's xi against the fused f64
    xi rounded to f32) and bitwise the port's CPU run of the same plane;
    ``mc_correctness_grouped`` launched once per G by the kernel plane;
    the median ms of each planner per G and one profiled call each at the
    largest G."""
    from repro_torch.kernels import ops

    cpu = torch.device("cpu")
    b, cases = hostgamma_cases()
    ops.reset_launch_counts()
    card = {G: {name: planner(name, dev, b, case) for name in PLANNERS}
            for G, case in cases.items()}
    # one final_xi launch per G by the kernel plane; the other two launch none
    launches = ops.mc_correctness_grouped.launches
    if launches != len(cases):
        raise AssertionError(f"mc_correctness_grouped launched {launches} times over "
                             f"{len(cases)} hostgamma_kernel plans, not once each")
    for G, case in cases.items():
        for name in PLANNERS:
            on_cpu = planner(name, cpu, b, case)
            for g, (c, h) in enumerate(zip(card[G][name], on_cpu)):
                if plan_fields(c) != plan_fields(h):
                    raise AssertionError(f"{name} G={G} group {g}: card {plan_fields(c)} "
                                         f"!= cpu {plan_fields(h)}")
        for g, (f, h, k) in enumerate(zip(*(card[G][n] for n in PLANNERS))):
            if plan_fields(h) != plan_fields(f):
                raise AssertionError(f"hostgamma G={G} group {g}: {plan_fields(h)} != fused "
                                     f"{plan_fields(f)}")
            if plan_fields(k) != plan_fields(f, f32_xi=k.s1 is not None):
                raise AssertionError(f"hostgamma_kernel G={G} group {g}: {plan_fields(k)} != "
                                     f"fused {plan_fields(f)}")
    ms = {str(G): {name: host_ms(lambda: planner(name, dev, b, case), reps=5)
                   for name in PLANNERS} for G, case in cases.items()}
    for row in ms.values():
        row["hostgamma_over_fused"] = row["hostgamma"] / row["fused"]
    G = max(cases)
    profiled = {name: {k: v for k, v in profiled_split(
        lambda: planner(name, dev, b, cases[G])).items() if k != "kernels_ms"}
        for name in PLANNERS}
    chosen = sum(len(r.chosen) for G_ in cases for r in card[G_]["fused"])
    return {"setting": {k: list(v) if isinstance(v, tuple) else v for k, v in HOSTGAMMA.items()},
            "bitwise": True, "arms_chosen": chosen, "launches": launches, "ms": ms,
            f"profiled_G{G}": profiled}


def lint_phase() -> dict:
    """(b) the port's thriftlint over the tree that runs: zero findings."""
    from repro_torch.analysis import run_lint

    report = run_lint(src_root=ROOT / "src", package="repro_torch")
    if not report.ok:
        raise AssertionError("thriftlint findings: " + "; ".join(f.format() for f in report.findings))
    if not all(s.has_reason for s in report.suppressions):
        raise AssertionError("a thriftlint suppression gives no reason")
    return {"rules": list(report.rules_run), "files_scanned": report.files_scanned,
            "findings": len(report.findings), "suppressed_by_rule": report.suppressed_by_rule(),
            "suppression_comments": len(report.suppressions)}


def tf32_is_off() -> dict:
    """TF32 off for matmuls and cuDNN, f32 matmul precision "highest"; raises
    otherwise."""
    state = {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
             "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if (state["matmul.allow_tf32"] is not False or state["cudnn.allow_tf32"] is not False
            or state["float32_matmul_precision"] != "highest"):
        raise AssertionError(f"TF32 is on at the end of the run: {state}")
    return state


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    global HBM_BYTES_PER_S, BF16_OPS_PER_S
    from repro_torch.launch.mesh import HW
    HBM_BYTES_PER_S, BF16_OPS_PER_S = HW["hbm_bw"], HW["peak_flops"]
    # f32 results are compared below: full f32 matmuls and convolutions, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.mc import bucket_size
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda", 0)
    phases = {}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 report] {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    paths = _build.build()
    phases["build_s"] = time.perf_counter() - t0
    log(f"[2 build] {len(paths)} kernels in {phases['build_s']:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(paths["flash_attention"])],
                          capture_output=True, text=True, check=True).stdout
    mma = sum(1 for line in sass.splitlines() if "HGMMA" in line or "HMMA" in line)
    log(f"  tensor-core instructions (HGMMA|HMMA) in {paths['flash_attention'].name}: {mma}")
    if mma == 0:
        raise AssertionError("the flash_attention library holds no tensor-core instruction")

    t0 = time.perf_counter()
    log("[3 kernels vs plain, on the card]")
    errs = check_kernels(dev)
    lifted = errs.pop("lifted")
    phases["kernels_s"] = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[4 route at the serve defaults: card vs cpu]")
    shapes = route_phase(dev)
    phases["route_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[5 route K=77 with use_kernel=True]")
    k77_phase(dev)
    phases["k77_s"] = time.perf_counter() - t0
    launches = {
        "belief_aggregate": ops.belief_aggregate.launches,
        "mc_correctness_grouped": ops.mc_correctness_grouped.launches,
    }
    log(f"[6 launches on the main path] {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")

    routes = route_times(dev)
    log(f"[routes] {json.dumps(routes)}")

    # time each kernel at the shape the main path gave it
    T = shapes["belief_T"]
    Tp = bucket_size(shapes["mc_theta"], 256)
    ba_args = belief_inputs(64, T, 4, True, seed=1, dev=dev)
    mc_args = mc_inputs(1, Tp, 12, 4, 3, seed=2, dev=dev)
    kernels = []
    for name, fn, plain, args, nb_ops, shape, replaces, source in (
        ("belief_aggregate", ops.belief_aggregate, ref.belief_aggregate_ref, ba_args,
         belief_bound(ba_args[0], 4), f"rows={64 * (T + 1)} M={T} K=4",
         "src/repro/kernels/belief_aggregate.py:42",
         "src/repro_torch/csrc/belief_aggregate.cu"),
        ("mc_correctness_grouped", ops.mc_correctness_grouped, ref.mc_correctness_grouped_ref,
         mc_args, mc_bound(mc_args, 4), f"G=1 C=3 T={Tp} L=12 K=4",
         "src/repro/kernels/mc_correctness.py:174",
         "src/repro_torch/csrc/mc_correctness_grouped.cu"),
    ):
        err = kernel_error(name, fn(*args, 4), plain(*args, 4), f"{shape} (main path)")
        errs[name] = max(errs[name], err)
        ms, ms_source = device_ms(lambda: fn(*args, 4), launches=1)
        plain_ms, plain_source = device_ms(lambda: plain(*args, 4), n=5)
        b_ms, b_by = bound_ms(*nb_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape, "ms_source": ms_source,
            "plain_ms_source": plain_source,
            "call_ms": median_ms(lambda: fn(*args, 4)),
            "plain_call_ms": median_ms(lambda: plain(*args, 4), reps=5, inner=5),
        })
        kernels[-1]["bitwise"] = errs[name] == 0.0
        if name == "mc_correctness_grouped":
            kernels[-1]["wide"] = wide_row(fn, mc_inputs(1, Tp, 64, 4, 3, seed=6, dev=dev),
                                           mc_bound, f"G=1 C=3 T={Tp} L=64 K=4")
    rows = trace_rows(lambda: ops.belief_aggregate(*ba_args, 4))
    log(f"[profiler rows] belief_aggregate, kernel rows of traces of 1 and 20 calls: "
        f"{json.dumps(rows)}")

    t0 = time.perf_counter()
    log("[7 model kernels vs plain, on the card]")
    errs.update(check_model_kernels(dev))
    phases["model_kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[8 one pattern unit of each family, full width, f32: card vs cpu]")
    model_phase(dev)
    phases["models_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[9 LM-arm route: three full-width bf16 arms, use_kernel=True]")
    lm = lm_route_phase(dev)
    phases["lm_route_s"] = time.perf_counter() - t0
    for row in kernels:                 # slice-1 kernels' launches on this path too
        row["lm_route_launches"] = lm["launches"][row["name"]]
    t0 = time.perf_counter()
    log("[10 model kernels timed at the LM-arm route's shapes]")
    model_rows = time_model_kernels(lm["launches"], errs)
    kernels += model_rows
    phases["model_timing_s"] = time.perf_counter() - t0
    log(f"[lm arms] {json.dumps({k: lm[k] for k in ('forward_ms', 'init_s', 'main_s', 'breakdown')})}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[11 GreedyLLM on MC xi: mc_correctness on the card vs the cpu]")
    greedy_res = greedy_phase(dev)
    mc_launches = ops.mc_correctness.launches
    phases["greedy_s"] = time.perf_counter() - t0
    log(f"  mc_correctness launches in phase 11: {mc_launches}")
    if mc_launches <= 0:
        raise AssertionError("kernel mc_correctness was never launched by GreedyLLM")
    gt = greedy_times(dev)
    args = gt.pop("args")
    log(f"[greedy] {json.dumps({**greedy_res, 'selection': gt})}")
    T1, C1 = args[0].shape[0], args[1].shape[0]
    shape = f"T={T1} L=12 C={C1} K=4"
    err = kernel_error("mc_correctness", ops.mc_correctness(*args, 4),
                       ref.mc_correctness_ref(*args, 4), f"{shape} (phase 11)")
    errs["mc_correctness"] = max(errs["mc_correctness"], err)
    ms, ms_source = device_ms(lambda: ops.mc_correctness(*args, 4), launches=1)
    plain_ms, plain_source = device_ms(lambda: ref.mc_correctness_ref(*args, 4), n=5)
    b_ms, b_by = bound_ms(*single_bound(args, 4))
    kernels.append({
        "name": "mc_correctness", "route": "cuda",
        "source": "src/repro_torch/csrc/mc_correctness.cu",
        "replaces": "src/repro/kernels/mc_correctness.py:79",
        "launches": mc_launches, "max_abs_err": errs["mc_correctness"],
        "bitwise": errs["mc_correctness"] == 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": shape, "ms_source": ms_source,
        "plain_ms_source": plain_source,
        "call_ms": median_ms(lambda: ops.mc_correctness(*args, 4)),
        "plain_call_ms": median_ms(lambda: ref.mc_correctness_ref(*args, 4), reps=5, inner=5),
        "wide": wide_row(ops.mc_correctness, single_inputs(T1, 64, 12, 4, seed=7, dev=dev),
                         single_bound, f"T={T1} L=64 C=12 K=4"),
    })

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[12 budget sweep at the example's defaults: card vs cpu]")
    sweep_phase(dev)
    phases["sweep_s"] = time.perf_counter() - t0
    log(f"  kernel launches in phase 12: mc_correctness {ops.mc_correctness.launches}, "
        f"belief_aggregate {ops.belief_aggregate.launches}, "
        f"mc_correctness_grouped {ops.mc_correctness_grouped.launches}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log(f"[13 a {WIDE_ARMS}-arm pool: routes and GreedyLLM, card vs cpu]")
    wide_pool_phase(dev)
    wide_launches = {name: getattr(ops, name).launches
                     for name in ("belief_aggregate", "mc_correctness_grouped", "mc_correctness")}
    phases["wide_pool_s"] = time.perf_counter() - t0
    log(f"  launches in phase 13: {wide_launches}")
    for name, n in wide_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the {WIDE_ARMS}-arm path")
    for row in kernels:
        if row["name"] in wide_launches:
            row["wide_pool_launches"] = wide_launches[row["name"]]

    t0 = time.perf_counter()
    log("[14 the scheduler at the serve defaults: faults, feedback, ledger; card vs cpu]")
    sched = scheduler_phase(dev)
    phases["scheduler_s"] = time.perf_counter() - t0
    log(f"[scheduler] {json.dumps(sched)}")
    for row in kernels:
        if row["name"] in ("belief_aggregate", "mc_correctness_grouped"):
            row["scheduler_launches"] = sched["kernel"]["launches"][row["name"]]
        if row["name"] in (*MODEL_KERNELS, "belief_aggregate"):
            row["lm_scheduler_launches"] = lm["scheduler_launches"][row["name"]]
        if row["name"] in ("mc_correctness", "mc_correctness_grouped"):
            row["lifted"] = [r for r in lifted if r["name"] == row["name"]]
    t0 = time.perf_counter()
    log(f"[15 the replica plane and the serve CLI: R=1, R={REPLICAS} fused and overlapped, "
        f"card vs cpu]")
    replicas = replica_phase(dev, sched["acme_limit_usd"])
    phases["replicas_s"] = time.perf_counter() - t0
    log(f"[replicas] {json.dumps(replicas)}")
    for row in kernels:
        if row["name"] in ("belief_aggregate", "mc_correctness_grouped"):
            row["replica_launches"] = replicas["fused"]["launches"][row["name"]]
    t0 = time.perf_counter()
    log("[16 training: gradients through the kernels, SMOKE card vs cpu, smollm-135m at full "
        "width, the CLI with restart, train-calibrate-serve]")
    train = train_phase(dev)
    phases["train_s"] = time.perf_counter() - t0
    full = train["full"]
    log(f"[train] {json.dumps(train_summary(train, smi))}")
    for row in kernels:
        if row["name"] in MODEL_KERNELS:
            row["train_launches"] = {"smoke_f32": train["smoke"]["launches"][row["name"]],
                                     "smollm_135m_bf16": full["launches"][row["name"]]}
        if row["name"] == "flash_attention":
            row["training_shape"] = train["flash_training_shape"]
    t0 = time.perf_counter()
    log("[17 the other families: flash at their shapes, one unit each card vs cpu, a five-arm "
        "bf16 pool routed, moonshot alone, qwen cut to 8 layers, SMOKE training card vs cpu]")
    fam = families_phase(dev)
    phases["families_s"] = time.perf_counter() - t0
    log(f"[families] {json.dumps(families_summary(fam, smi))}")
    for row in kernels:
        if row["name"] == "flash_attention":
            row["families"] = {
                "by_shape": fam["flash"],
                "pool_launches": fam["pool"]["launches"]["flash_attention"],
                "pool_scheduler_launches": fam["pool"]["scheduler_launches"]["flash_attention"],
                "moonshot_launches": fam["moonshot"]["flash_launches"],
                "qwen_8_layer_launches": fam["qwen"]["flash_launches"],
                "train_launches_smoke_f32": fam["smoke"]["launches"]["flash_attention"]}
        if row["name"] == "belief_aggregate":
            row["families_pool_launches"] = fam["pool"]["launches"]["belief_aggregate"]
    t0 = time.perf_counter()
    log("[18 prefill and decode: SMOKE f32 card vs cpu for every family (int8 KV included), "
        "four arms at published width in bf16]")
    dec = decode_phase(dev)
    phases["decode_s"] = time.perf_counter() - t0
    log(f"[decode] {json.dumps(decode_summary(dec, smi))}")
    for row in kernels:
        if row["name"] in MODEL_KERNELS:
            row["decode_phase_launches"] = {
                "prefills": dec["prefill_launches"][row["name"]],
                "smoke_f32_prefills": dec["smoke_prefill_launches"][row["name"]],
                "phase": dec["launches"][row["name"]]}
    t0 = time.perf_counter()
    log("[19 launch tools: the dry run on meta, the roofline of phases 16 and 18, expert "
        "parallelism over NCCL, replica_mesh]")
    launch = launch_phase(dev, full, dec["width"])
    phases["launch_s"] = time.perf_counter() - t0
    for row in kernels:
        if row["name"] == "flash_attention":
            row["launch_phase_launches"] = launch["ep"]["flash_launches"]
    log(f"[roofline] {json.dumps({'card': smi, **launch['roofline']})}")
    t0 = time.perf_counter()
    log("[20 the sharded train step over a torch.distributed DeviceMesh: smollm-135m full width "
        "world 1 vs unsharded, a sharded checkpoint, SMOKE block types, a 2-rank world]")
    sharded = sharded_phase(dev, full)
    phases["sharded_s"] = time.perf_counter() - t0
    log(f"[sharded] {json.dumps({'card': smi, **sharded_summary(sharded)})}")
    for row in kernels:
        if row["name"] in MODEL_KERNELS:
            row["sharded_launches"] = {
                "smollm_135m_bf16": sharded["full"]["launches"][row["name"]],
                "smoke_f32": sharded["smoke_launches"][row["name"]]}
    t0 = time.perf_counter()
    log("[21 the hostgamma planner baseline (use_kernel off and on) vs the fused planner, "
        "card vs cpu; the port's thriftlint]")
    hostgamma = hostgamma_phase(dev)
    log(f"[hostgamma] {json.dumps({'card': smi, **hostgamma})}")
    lint = lint_phase()
    phases["hostgamma_lint_s"] = time.perf_counter() - t0
    log(f"[lint] {json.dumps(lint)}")
    for row in kernels:
        if row["name"] == "mc_correctness_grouped":
            row["hostgamma_launches"] = hostgamma["launches"]
    log(f"[earlier kernels] {json.dumps(earlier_kernels(kernels))}")
    floor = launch_floor_ms(dev)
    for row in kernels:
        row["launch_floor_ms"] = floor
    log(f"[phases] {json.dumps({k: round(v, 3) for k, v in phases.items()})}")
    log(f"[profiler traces] {json.dumps(TRACES)}")
    log(f"[tf32 at the end] {json.dumps(tf32_is_off())}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
