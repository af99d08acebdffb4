#!/usr/bin/env python3
"""Quickest proof that the PyTorch port builds and runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Print the card's name and power limit (``nvidia-smi``), build the CUDA
   kernels from ``marl_distributedformation_tpu_torch/csrc`` with ``nvcc``.
2. Hold each k-NN kernel against its plain PyTorch version on the card, at
   the shapes each path gives it — fused: training (M=1024, N=100, k=4),
   eval and populations (M=4096), the matrix (M=256), the falsifier
   search (M=1600 and 3904), playback (M=1), the promotion gate (M=64),
   the storm's gate (M=8);
   tiled: training (M=8, N=1024, k=4), eval
   (M=512), populations (M=16) and the matrix (M=32) — and on lattice, duplicate and edge-clipped points (exact ties) and
   masks with fewer than k valid points: ``idx`` and offsets bitwise,
   distances within 1 ulp. Then time the kernel (its device time under
   ``torch.profiler``, and back-to-back calls with CUDA events) and the
   plain version (CUDA events), with the SM clock, power and temperature
   sampled before and after each kernel's window. Then a capture while a
   graph owner is cyclic garbage: the collector is off inside it
   (``capture_gc_check``).
3. Drive the port's k-NN swarm evaluation at full width with a GNN from a
   seeded init: N=100, M=4096 for a full episode (1002 steps; the fused
   kernel must launch 1003 times), and N=1024, M=512 for 101 steps (the
   tiled kernel must launch 102 times). Check finite outputs, and that the
   kernel path equals the plain path end to end on a small batch.
4. Evaluate the committed MLP checkpoint (N=5, M=4096, full episode) through
   the port's evaluate CLI: learned > baseline > zero.
5. Train through the port's ``train`` CLI on the card, the iteration
   captured as CUDA graphs (``train/capture.py``):
   - ``gnn100``, the published 100-agent command (GNN, k=4, M=1024,
     ``preset=tpu``, 30 iterations) with ``fused_chunk=10``: ``knn_fused``
     must launch 1 + 30 x 10 times, counted by replay; the mean reward of
     the last 3 iterations must beat the first 3 by 20 and be above 0; the
     checkpoint it wrote, evaluated through the evaluate CLI (M=1024, full
     episode), must rank learned > baseline > zero. Then the rollout and
     the first epoch of the same command run eagerly beside the same
     window replayed, for the captured-to-eager ratio.
   - ``gnn1024`` (M=8, N=1024, ``preset=tpu``, 12 iterations): ``knn_tiled``
     must launch 1 + 12 x 10 times; the last 3 iterations must beat the
     first 3.
   - the ring/MLP default (M=1000, N=5, ``batch_size=64``), 2 iterations
     captured; its captured-to-eager ratio covers the rollout and the
     first of the 10 epochs, its profile the rollout and the first tenth
     of that epoch.
   - for every run: seconds an iteration split into rollout and update
     (CUDA events between graph replays), formation-steps/s,
     agent-transitions/s, peak memory (and above what earlier phases
     hold), each graph's nodes and capture time, and the device's busy
     share over one profiled captured iteration (``gnn100``'s, like the
     ring/MLP's, over its rollout and first epoch): the union of the device
     intervals in the trace over the wall time, asserted <= 100%, with the
     kernels' summed time beside it as a sum.
   - a 10-step rollout of each trained GNN at its training shape (N=100,
     M=1024; N=1024, M=8), captured through the kernel, against an eager
     rollout through the plain k-NN from one generator state: bitwise.
   - captured against eager training from one seed, 3 iterations: the
     ring/MLP (M=64) and the GNN (N=100, M=64) bitwise (the GNN's gather
     adds its gradient in a fixed order, ROADMAP C4).
   - a ``health=true recovery=true`` run poisoned with NaN once: it must
     end on finite parameters with a rollback in ``recovery.jsonl``.
6. Train populations (``train/sweep.py``) through the ``train`` CLI, every
   member's formations folded into one env batch, the iteration captured:
   - ``pop4``: ``gnn100``'s command with ``num_seeds=4``, cut to 16
     iterations (``fused_chunk=8``): ``knn_fused`` must launch 1 + 16 x 10 times (one
     launch a step for the whole population, at (4096,100,4)); the
     population mean of the last 3 iterations must beat the first 3 by 20
     and the best member end above 0; member 0's reward an iteration is
     printed beside phase 5's ``gnn100`` (the same seed), and iteration 1,
     before any update, must agree within ``ITER1_RTOL``; its s/iteration
     is set against 4 x ``gnn100``'s; the evaluate CLI's sweep mode (M=1024,
     full episode) must rank best member > baseline > zero.
   - ``pop1024`` (``gnn1024``'s command, 2 members, 4 iterations):
     ``knn_tiled`` must launch 1 + 4 x 10 times.
   - a 10-step population rollout at each shape, captured through the
     kernel with the K generators registered, against an eager rollout
     through the plain k-NN from the same states: bitwise.
   - ``sweep8``, the published population command
     (``docs/acceptance/sweep8``, 200 iterations, K=8, ring/MLP, M=16,
     N=3): the population mean over iterations 151-200 must beat 1-25 by
     5, with the 25-iteration windows printed beside the TPU's record; the
     best member must beat the baseline on 1024 held-out formations.
   - a ring/MLP lr sweep (K=4, M=64, 3 iterations): each member keeps its
     rate, the first update's step grows with the rate, and a run resumed
     from its anchor equals the uninterrupted one bitwise.
   - a population (K=2, M=64) captured against eager: the MLP and the GNN
     bitwise.
7. CTDE and the heterogeneous curriculum through the ``train`` CLI:
   - ``ctde20``, ``docs/acceptance/ctde20``'s command at full depth (25
     iterations): the last 3 iterations beat the first 3 by 20 and end
     above 0 (the curve printed beside the TPU v5e record); its checkpoint
     through the evaluate CLI (M=64, full episodes) ranks learned >
     baseline > zero.
   - ``ctde_knn``: the CTDE actor on k-NN observations at N=100, M=1024, 3
     iterations: ``knn_fused`` must launch 1 + 3 x 10 times by replay.
   - ``hetero5``, ``docs/acceptance/hetero5``'s K=4 command at full depth
     (200 iterations, 4 stages): in each of stages 0-2 the population mean
     of the last 5 iterations beats the first 5 by 10 (stage 3 printed);
     the captured graphs are the same 3 after the last stage as after the
     first; the evaluate CLI's sweep mode on the README's three rows (N=5,
     N=20, N=20 with 4 obstacles; M=512, seed 1234, deterministic): the
     best member and the baseline beat zero in every row, every member
     printed beside the CPU record's ranking.
   - ``hetero_ctde``: ``policy=ctde`` over a 2-stage curriculum, M=64,
     ``preset=tpu``: finite losses, padded agents' values exactly 0.
   - captured against eager across a stage boundary (M=64, N_max=20): the
     MLP and CTDE single runs bitwise; a K=2 population with
     ``fused_chunk=2`` against the host loop bitwise; a population resumed
     from a mid-stage anchor against the uninterrupted run bitwise.
8. Scenarios (``scenarios/``: disturbance layers around the env step):
   - severity 0 is the clean env on the card: phase 5's ``gnn100`` policy
     at N=100, M=1024, 50 steps through a reset and ``knn_fused``; every
     registered scenario at severity 0 equals the clean run bitwise
     (states, observations, rewards), the obstacle scenarios also with 4
     obstacles; at severity 1 every scenario but ``clean`` differs (the
     obstacle ones with obstacles, and are bitwise clean without).
   - ``scen100``: ``gnn100``'s command (20 iterations since phase 16,
     ``fused_chunk=10``) under a 3-stage schedule (12 clean, 5 of wind /
     sensor noise / actuator faults at 0.5, 3 of storm ramping 0.5 to 1.0;
     12, 12 and 6 before), the stage changes at iterations 12 and 17
     inside a chunk: the records'
     ``scenario_severity`` is the schedule's every iteration; the 3
     captured graphs hold across both changes; iteration 1's reward equals
     ``gnn100``'s to the last digit (same seed, clean stage); iterations
     10-12 beat the first 3 by 20; ``knn_fused`` 1 + 20 x 10 launches by
     replay; s/iteration per stage beside ``gnn100``'s.
   - evaluation under ``wind`` and ``storm`` at 0.5 (M=1024, N=100, full
     episodes) through the evaluate CLI on ``scen100``'s checkpoint:
     learned > zero; ``gnn100``'s checkpoint's policy row beside it (not
     gated); eval formation-steps/s under ``storm`` against clean.
   - captured == eager across a stage boundary and a severity ramp
     (ring/MLP, M=64) bitwise; ``fused_chunk=2`` == the host loop with the
     stage change inside a chunk, records included; resumed mid-stage ==
     uninterrupted, bitwise.
9. The robustness matrix, the falsifier search and pursuit-evasion
   (``scenarios/matrix.py``, ``scenarios/adversary.py``, ``envs/pursuit.py``):
   - ``matrix100``: the robustness-matrix CLI in-process on ``gnn100``'s
     and ``scen100``'s checkpoints, ``clean``, ``wind``, ``storm`` x
     severities 0, 1.0 at M=256, full episodes (12 cells since phase 17):
     one build (the eval step captured once), ``knn_fused`` 12 x 1003
     launches by replay, every severity-0 cell
     bitwise its checkpoint's clean cell, the ``wind`` 1.0 cell against
     the eager ``eval.evaluate_scenario`` within rtol 1e-5; s a cell
     captured beside the eager evaluation's; ``storm`` 1.0 of both.
   - ``matrix1024``: the same on ``gnn1024``'s checkpoint (``clean``,
     ``storm`` x 0, 1.0 at M=32) through ``knn_tiled``, 4 x 1003 launches.
   - ``adversary100``: the falsifier-search CLI on both checkpoints (4
     families, grid 6, 1 generation since phase 16 (2 before), M=64: P=25,
     1600 formations), one
     build across both; every falsifier and the highest safe probe below
     it re-evaluated through ``AdversarySearch.evaluate_cells`` (drop
     above the tolerance, and at most it); candidates/s. Then one
     generation of the default population (10 families, P=61, 3904
     formations): every severity-0 row bitwise the clean row.
   - ``chase100``: ``gnn100``'s command on ``env=pursuit_evasion`` (20
     captured iterations, ``fused_chunk=10``, ``knn_fused`` 201 launches
     by replay) and a control run of it with ``learning_rate=0``: finite
     records, the same first iteration, the last 3 iterations' mean
     reward above the control's over the same episode steps (every
     formation starts its episode at once, so the reward also follows the
     pursuer closing in); at M=1024 over full episodes the learned policy
     with its noise > the seeded policy with its noise and > zero (the
     mean action printed, not gated); every scenario at severity 0 equals
     clean pursuit bitwise (M=1024, 50 steps) and ``moving_goal`` at 0.5
     differs; s/iteration beside ``gnn100``'s.
10. Serving (``serving/``: the bucketed engine, one CUDA graph a rung,
   the micro-batch scheduler, the hot-reload registry), ladder
   1/8/64/512:
   - the committed MLP checkpoint on flat ring rows, a seeded-init MLP and
     ``gnn100``'s checkpoint (N=100, k=4) on real k-NN request rows of
     (100, 20): env states at M=1024 through ``compute_obs_knn`` and
     ``knn_fused`` (2 launches); at every rung the captured rung equals
     the eager one bitwise and ``LoadedPolicy.predict`` within rtol 1e-5,
     atol 1e-6, also on a request of 3 chunks; two stochastic dispatches
     differ; the seeded MLP's bf16 ladder is within
     ``tests/bf16_budget.py``'s budget of the f32 one (the trained
     checkpoints' bf16 divergences printed); each rung's replay, ``act``
     and eager ``act`` times, the top rung's copy in.
   - a mixed stream over every rung (4 client threads, 48 requests) with
     a hot swap from ``gnn100`` to ``scen100`` (its checkpoint copied into
     the served directory under a larger step): every request answered,
     one capture a rung and the same graphs, ``model_step`` never
     decreasing in completion order, actions after the swap equal
     ``scen100``'s ``predict``.
   - ``run_smoke_benchmark`` on the ``gnn100`` scheduler (sizes 1-100
     formations, 4 clients, 3 s): requests/s, rows/s, agent-rows/s,
     p50/p95/p99, occupancy; the device's busy share over a profiled
     smoke; ``max_rate_at_slo`` at a 50 ms p95.
11. Sebulba (``train/sebulba/``), C4 and the observability plane, each run
   through the ``train`` CLI's ``main`` with a fresh registry and ledger:
   - lockstep against the captured Anakin host loop from one seed (GNN
     N=100 and ring/MLP, M=64, 3 iterations; the actor and the learner
     each on its own stream): parameters and metrics bitwise.
   - ``sebulba100``: ``gnn100``'s command with ``architecture=sebulba
     fused_chunk=10``, 60 iterations (the actor acts with one parameter
     version a chunk, so 30 are too few for the gate), pipelined:
     ``knn_fused`` 1 + 10 a rollout by replay (dropped and unconsumed
     rollouts too); the learning gate of ``gnn100``; every consumed
     batch within ``max_param_staleness`` and no seq consumed twice; one
     build a lane and the census of its three programs; s/iteration
     beside phase 5's ``gnn100``, actor and learner rates, queue
     occupancy and staleness p95, stale drops, peak memory. Then its busy
     share: the same command with K=1, two learner iterations traced by
     ``profile=true`` with the actor lane beside them.
   - ``sebulba1024``: ``gnn1024``'s command through Sebulba, 4
     iterations: ``knn_tiled`` launches by replay, the same checks.
   - ``gnn100``'s command for 8 host-loop iterations, twice from one
     seed: the default run (``GET /metrics`` scraped during it must hold
     the JAX trainer's metric names; its census holds the three phase
     graphs with ``graph_stats()``'s capture seconds and nodes; its last
     6 iterations turn telemetry and the ledger on and off in turn, for
     their overheads) and ``telemetry=false ledger=false``: the same
     parameters bitwise (C4).
   - ``profile=true profile_iterations=3`` at N=100, M=64: the trace holds
     3 x 10 ``knn_fused`` events, and the audit line its dispatches.
12. The reference's own user surface (no gymnasium or matplotlib: the
   card's machine has neither):
   - BASELINE config 1: the ``simulate`` tool headless at N=5 for 1100
     steps (across the first auto-reset; an episode is ``max_steps + 2``
     steps) and at its default N=10 (300 steps): ``avg_dist_to_goal``
     finite and falling, ms a step; the per-formation ``step`` against row 0 of
     ``step_batch`` at M=1 from one generator seed over 1100 baseline
     steps at N=5 (ring) and 101 at N=100 (k-NN, k=4, ``max_steps=98``:
     episodes of 100 steps): bitwise, the observation included, one
     auto-reset; the k-NN step launches ``knn_fused`` at (1,100,4) once a
     step.
   - ``FormationVecEnv`` at N=100, M=1024, k=4 driven by
     ``LoadedPolicy.predict`` on ``gnn100``'s checkpoint for 1003 steps
     (across the episode end): ``knn_fused`` steps + 1 launches, every
     formation done once; obs, rewards and dones bitwise those of the
     same actions through ``make_vec_env`` from the same seed;
     formation-steps/s and the host copies' share of the wall time,
     beside phase 3's eval rate. At N=1024, M=8 on ``gnn1024``'s
     checkpoint, 101 steps (``max_steps=99``): ``knn_tiled`` steps + 1.
   - the ``visualize_policy`` tool headless for 302 steps on
     ``gnn100``'s run (``knn_fused`` at (1,100,4) once a step and once
     for the reset) and for 300 on the committed MLP checkpoint.
   - the committed checkpoint exported to SB3 naming, packed as a
     ``PPO.save`` zip and imported back: its deterministic actions equal
     the checkpoint's bitwise over a full episode through
     ``FormationVecEnv`` (N=5, M=256).
13. The serving fleet (``serving/fleet/``), the lane watchdog and the
   runtime guards:
   - ``fleet100``: ``gnn100``'s checkpoint behind ``FleetRouter`` at R=1
     and then R=2 replicas on ``cuda:0`` (ladder 1/8/64/512, request rows
     from ``serve_rows`` through ``knn_fused``), every rung of every
     replica captured before traffic: one capture a rung a replica; every
     replica's deterministic actions equal the single engine's ``act``
     bitwise (else within serving's tolerance, printed); 4 clients sending
     1, 3, 8, 9, 40 and 100 formations for 3 s with a coordinated swap to
     ``scen100``'s checkpoint in the middle (at R=2 ``kill_replica(0)``
     before it, the replica revived and readmitted half-open after):
     ``check_step_monotonic``, ``check_no_request_lost`` and
     ``check_budget_one`` find nothing; requests/s and p50/p95/p99 at
     R=1 and R=2 beside phase 10's single engine, the longest barrier
     hold at the swap, each rung's replay on each replica, and the busy
     share of one profiled R=2 window.
   - the HTTP frontend over the R=2 fleet: 4 ``ServingClient`` threads
     send 200 requests over HTTP; each answer equals the in-process
     router's bitwise and carries ``model_step`` and its ``X-Trace-Id``;
     ``/v1/health`` and ``/v1/metrics`` in Prometheus text; a 429 with
     ``Retry-After`` from a one-slot fleet and a 503 with every replica
     killed.
   - ``LaneWatchdog.watch_fleet`` over the R=2 fleet: a seeded
     ``scheduler.dispatch`` crash kills a worker under traffic; it is
     restarted (``restarts_total`` 1, its MTTR printed) and no accepted
     request is lost.
   - ``guards64``: ``gnn100``'s command at M=64, 3 iterations, with
     ``guard_retraces=1 guard_transfers=true guard_nans=true`` passes;
     then an ``.item()`` inside a guarded dispatch, ``train.carry_poison``
     armed through the chaos plane, and a forced rebuild must raise.
14. The always-learning pipeline (``pipeline/``, ``always_learning``)
   and tenant lanes (``serving/tenancy/``) on the card:
   - ``always100``: ``always_learning`` in-process on ``cuda:0`` with
     ``gnn100``'s command for 20 iterations (``fused_chunk=5``, a
     checkpoint a chunk: 4 candidates), the gate at JAX's defaults (wind
     and sensor_noise at 0.5 and 1.0, M=64), 2 replicas, 2 clients sending
     1-100 formations of ``serve_rows`` through the router, a NaN
     candidate written after the second checkpoint and a forced
     regression once two good checkpoints serve: every candidate gated,
     the NaN one rejected as non-finite and never published or served,
     the promotions strictly ascending, one rollback to a promoted step
     through ``reload_pinned``, one build of the gate's matrix,
     ``check_audit_log``, ``check_step_monotonic``,
     ``check_no_request_lost`` and ``check_budget_one`` find nothing, and
     ``knn_fused``'s launches equal the trainer's 1 + 20 x 10 plus the
     gate's cells x 1003, counted by replay. Prints the promotion latency
     p50/p95, ``gate_eval_steps_per_sec``, the trainer's s/iteration
     beside ``gnn100``'s and the busy share of one profiled window.
     It runs with ``sentinel=true`` against a bench record of this run's
     own numbers, written to a temporary directory before it
     (``gnn100``'s formation-steps/s, the gauge's definition; ``fleet100``'s
     R=2 p95; ``gnn100``'s largest capture and memory peak; the card's
     name and power limit; ``"skipped"`` for what nothing measured
     before): its report carries every ``sentinel_*`` key, the record is
     used (``platform: "gpu"``, the card's name) and checked at least
     once; its trips are printed with their live and recorded values and
     not gated (the trainer shares the card). Then two sentinels on the
     registry ``always100`` filled: a record at 10x its live training
     rate trips exactly once in ``trip_after`` checks, with one audit line
     and one ``flightrec-perf_regression-*.json``, and stays latched on a
     further check; one at 0.1x never trips. One ``[sentinel]`` line.
   - ``tenants100``: a ``TenantFleet`` at R=1 on ``cuda:0`` over
     ``gnn100``'s, ``scen100``'s and ``chase100``'s checkpoints (one GNN
     signature, one group) and the committed MLP (a second group): one
     capture a (arch, rung); each lane's deterministic actions, each
     request alone, equal a single engine's bitwise; a storm on
     ``formation-a`` with a swap of ``formation-a`` in it leaves
     ``formation-b`` without a 429 and every lane's step monotonic.
     Prints each lane's requests/s and p95.
15. The chaos storm (``chaos_storm.py``) on ``cuda:0``, each campaign's
   exception failing the run:
   - ``storm100``: ``run_campaign(seed=7, faults=25)`` over ``gnn100``'s
     command (the train leg cut to ``STORM_ITERATIONS``; a wedge of 1.2 s
     and a gate deadline of 0.9 s): zero violations, 25 fired, 0
     unfired, ``resume_ok``, 0 < MTTR < 60 s, the disabled plane's
     overhead under 5%, one build of the gate's matrix and of each
     replica's rungs, the deterministic section equal to
     ``build_schedule(7, 25)``, a gate timeout, every healthy gate eval
     under the deadline, and ``knn_fused``'s launches equal the
     trainer's iterations x 10 plus the gate's cells x 23 plus the
     trainer's reset and the probe's formation, each owner counted on
     its threads.
   - ``storm_train100``: ``run_train_campaign(seed=2, faults=10)`` at
     N=100, k=4, GNN, M=64, with JAX's test's assertions.
   - ``storm_sebulba100``: ``run_sebulba_campaign(seed=0, faults=12)``
     at the same width: zero violations, every fault fired, a duplicate
     absorbed whenever a dequeue raise fired, one build a lane.
   Prints each campaign's MTTR, probes, promotions, rejections, gate
   timeouts, restarts, recoveries, dropped and absorbed batches,
   staleness p95 and wall seconds, and each owner's ``knn_fused``
   launches.
16. Data parallelism over formations and the agent-axis ring
   (``parallel/``) on one card, gnn100's command:
   - ``dp100x1``: ``mesh={dp: 1}`` through the ``train`` CLI in a one-rank
     NCCL group in this process, 3 iterations: the parameters equal
     phase 5's ``gnn100`` after 3 iterations bitwise (one rank keeps the
     single run's reductions); ``knn_fused`` 31 launches.
   - ``dp100x2``: ``mesh={dp: 2}``, two ranks on ``cuda:0`` started by
     ``parallel.launch`` (gloo on the card's tensors; its all-reduce,
     all-gather and broadcast checked), each with its (512,100,2) block:
     iteration 1's reward within ``ITER1_RTOL`` of ``gnn100``'s, the
     parameters after 2 iterations within JAX's rtol 1e-4 atol 1e-6, but
     the policy's own leaves (``log_std``, ``actor.*``) within 2e-4
     absolute (``DP_POLICY_ATOL``), both ranks' parameters equal; 3 more
     iterations
     timed (two processes time-sharing one card, not a scaling figure);
     ``knn_fused`` 51 launches a rank at (512,100,4).
   - ``ring100x2``: ``make_ring_step`` at N=100, k=4, M=64, sp=2 on the
     same two ranks, 8 steps through auto-resets against ``step_batch``:
     observations within rtol 1e-5 atol 1e-6, ``done`` bitwise, rewards
     and metrics within 1e-4.
17. The cross-host serving tier (``serving/mesh/``) on one card:
   - ``mesh100``: ``run_mesh_smoke`` with 2 host subprocesses
     time-sharing ``cuda:0`` (R=1 each, ladder 1/8/64) serving
     ``gnn100``'s checkpoint, then ``scen100``'s and back through 3 global
     swaps under 4 clients for 6 s, host0 SIGKILLed halfway: 0 lost, 0
     step violations, one capture a (host, rung), after each commit every
     live host's answer to 8 formations bitwise equal to this process's
     engine on the same checkpoint, ``knn_fused`` launched on every host
     (its probe rows), the library built before the hosts started.
   - ``storm_mesh100``: ``run_mesh_campaign(seed=0, faults=20)`` over
     ``gnn100``'s command at M=64 with 2 hosts: 0 violations, every armed
     ``mesh.*`` fault fired, the killed host dead.
   Prints requests/s beside phase 13's ``fleet100`` R=2 (time-sharing,
   not scaling), global swap p50/p95, each host's launches, the storm's
   wall time and commit rounds.
18. The sharded big-rung slice (``serving/sharded.py``) and elastic
   capacity (``serving/elastic``) on one card:
   - ``sharded100``: ``gnn100``'s checkpoint behind R=1 (ladder 1/8/64)
     plus a ``{"dp": 2}`` slice whose two row blocks time-share ``cuda:0``
     (rungs 64 and 512 formations, 51,200 agent rows), the request rows
     through ``knn_fused`` (``serve_rows``): one capture a (slot, rung),
     counted by the guards and the program ledger; each row block bitwise
     equal to the single engine's rung of its rows, the whole rung within
     serving's rtol 1e-5 / atol 1e-6 of the single engine's rung (the max
     abs diff printed); a storm of 1-512 formations with a coordinated
     swap to ``scen100``'s checkpoint landing on both replica kinds: 0
     lost, monotonic steps, the slice serving the new parameters; on a
     seeded MLP a bf16 slice within ``tests/bf16_budget.py``'s bound and
     nonzero, and a ``{"dp": 2, "mp": 2}`` slice within 1e-5. Requests/s
     and the 512-formation requests' p95 at R=1 against R=1 plus the
     slice (time-sharing, not scaling).
   - ``elastic100``: a ``CapacityController`` over that fleet (two device
     slots of ``cuda:0``) fed an interactive mix and then a storm mix,
     each decided with traffic in flight: >= 1 re-split committed, its
     pause and prewarm captures printed, no capture on the request path
     (the ledger's census equal before and after serving the new split),
     0 lost, monotonic steps, one capture a rung.
   - ``serve --slo-bench`` and ``--elastic-bench`` with the JAX package's
     bench.py arguments on ``cuda:0``, each in a process of its own, both
     at once: one capture a rung, no program built in the elastic bench's
     measured storm.
   - ``storm_elastic100``: ``run_elastic_campaign(seed=0, faults=9)`` over
     ``gnn100``'s command: 0 violations, every fault fired, >= 2 re-splits
     committed, its row pool through ``knn_fused`` once.
19. Print the kernels' JSON line (launches and timings at the training
   paths' shapes, those of the eval paths under ``eval``, the population
   paths' under ``population``, ``ctde_knn``'s launches under
   ``ctde_knn``, ``scen100``'s under ``scenario``, phase 9's under
   ``matrix``, ``adversary``, ``population61`` and ``chase``, phase 10's
   request rows under ``serving``, phase 11's lanes under ``sebulba``,
   phase 12's VecEnv runs under ``vec_env``, its playback, (1,100,4),
   under ``playback`` and its per-formation k-NN step, (1,100,4), under
   ``single_step``, phase 13's request rows under ``fleet``, phase 14's
   trainer and gate under ``always`` at the gate's (64,100,4), its lanes'
   request rows under ``tenants``, phase 15's storms under
   ``chaos_storm``, phase 16's ranks under ``dp`` at (512,100,4), phase
   17's hosts and storm under ``mesh``, phase 18's request rows and row
   pool under ``sharded``), the
   card
   line, and the last line ``{"ok": true,
   "device": {...}}``.

Imports nothing of JAX. Exits non-zero with no result when no GPU is found.
If the run is still going 1150 s after its start, or ``always100`` runs
past 300 s, ``faulthandler`` dumps every thread's stack to stderr (the run
goes on).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from statistics import mean, median

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "docs/acceptance/tpu_run/rl_model_20480000_steps.msgpack"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Per candidate pair the search does 2 subtractions, 2 multiplies and 1 add
# for the squared distance and 1 compare against the k-th best.
OPS_PER_PAIR = 6
TOL_ULP = 1


START = time.perf_counter()
# Every thread's stack is dumped to stderr this long after the start, short
# of the 1200 s limit, so a hang leaves its stacks; a phase that can wedge
# (always100) arms a nearer dump around itself (``hang_dump``).
HANG_DUMP_S = 1150.0


def arm_hang_dump(after_s: float) -> None:
    """Dump every thread's stack to stderr ``after_s`` from now (no later
    than ``HANG_DUMP_S`` after the start), replacing the armed dump."""
    import faulthandler

    left = HANG_DUMP_S - (time.perf_counter() - START)
    faulthandler.dump_traceback_later(max(min(after_s, left), 1.0),
                                      exit=False, file=sys.stderr)


class hang_dump:
    """``with hang_dump(label, s):`` dumps every thread's stack if the block
    runs past ``s`` seconds, then re-arms the whole run's dump."""

    def __init__(self, label: str, after_s: float) -> None:
        self.label, self.after_s = label, after_s

    def __enter__(self):
        print(f"[hang] {self.label}: every thread's stack goes to stderr "
              f"if it runs past {self.after_s:.0f} s", file=sys.stderr)
        arm_hang_dump(self.after_s)
        return self

    def __exit__(self, *exc):
        arm_hang_dump(HANG_DUMP_S)
        return False


def elapsed(label: str) -> None:
    """The script's wall time so far, after ``label``: the whole run must
    stay well inside its 1200 s."""
    print(f"[time] {label}: {time.perf_counter() - START:.1f} s since start")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def smi_sample() -> str:
    """SM clock, power draw and limit, and temperature, sampled beside a
    timing window."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def knn_bound_ms(m: int, n: int, k: int, with_valid: bool) -> tuple:
    """Least time for one search: each input byte read once, each output
    byte written once, against M*N*(N-1) candidate pairs."""
    nbytes = m * n * 8 + (m * n if with_valid else 0) + m * n * k * 16
    ops = m * n * (n - 1) * OPS_PER_PAIR
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(event) -> float:
    """Device time of a ``torch.profiler`` event, in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_device_ms(fn, reps: int, key: str, windows: int = 3) -> float:
    """Device time a launch of the kernel whose name holds ``key``, over
    ``reps`` launches traced under ``torch.profiler``: the kernel's own
    time. CUDA events around back-to-back calls measure the host's launch
    path instead (allocation, checks, ctypes) when it is slower than the
    kernel, as it is for ``knn_fused`` on a slow host.

    A trace may miss the first activities after it starts (one run traced
    199 of 200 launches, another 184 of 201, both in the process's first
    trace), so each window makes ``reps + 1`` calls and the traced
    launches add up over at most ``windows`` windows until there are
    ``reps``; the mean is over the last ``reps`` of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    launches, seen = [], []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and key in e.name
        )
        seen.append(len(got))
        launches += got
        if len(launches) >= reps:
            break
    if len(launches) < reps:
        raise AssertionError(f"{key}: {seen} profiled launches in "
                             f"{len(seen)} windows, want {reps} in all")
    if seen[0] < reps + 1:
        print(f"[profile] {key}: traced launches by window {seen} of "
              f"{reps + 1} calls each")
    return sum(b - a for a, b in launches[-reps:]) / reps / 1e3


def warm_profiler() -> None:
    """One short trace before any that is read: the process's first trace
    starts the tracing library and may miss the activities at its start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1024, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x.add_(1.0)
        torch.cuda.synchronize()


def compare(name: str, got, want) -> float:
    """Fails unless idx and offsets are bitwise equal and dists within
    TOL_ULP; returns the largest absolute difference of any output."""
    import torch

    gi, go, gd = got
    wi, wo, wd = want
    if not torch.equal(gi, wi):
        bad = (gi != wi).nonzero()[:5].tolist()
        raise AssertionError(f"{name}: idx differs from the plain version at {bad}")
    if not torch.equal(go, wo):
        raise AssertionError(f"{name}: offsets differ from the plain version")
    ulp = (gd.view(torch.int32).long() - wd.view(torch.int32).long()).abs().max()
    if int(ulp) > TOL_ULP:
        raise AssertionError(f"{name}: dists differ by {int(ulp)} ulp")
    return max(
        float((gd - wd).abs().max()), float((go - wo).abs().max())
    )


def tie_cases(n: int, m: int, device):
    """Points with exact ties: an integer lattice, the lattice duplicated,
    and agents clipped onto the world's edges."""
    import torch

    side = math.isqrt(n - 1) + 1
    g = torch.arange(side * side, device=device)
    lattice = torch.stack([(g % side) * 10.0, (g // side) * 10.0], -1)[:n]
    dup = lattice.clone()
    dup[n // 2:] = lattice[: n - n // 2]
    gen = torch.Generator(device=device).manual_seed(7)
    edge = torch.rand((n, 2), generator=gen, device=device) * 500.0 - 50.0
    edge = torch.minimum(
        edge.clamp_min(0.0), torch.tensor([400.0, 600.0], device=device)
    ).round()
    out = torch.stack([lattice, dup, edge]).float()
    return out.repeat((m + 2) // 3, 1, 1)[:m].contiguous()


def check_kernel(name, kernel, m, n, k, reps):
    """Phase 2 for one kernel: agreement at the main shape, on ties and on
    short masks, then its time beside the plain version's."""
    import torch

    from marl_distributedformation_tpu_torch.ops.knn import knn_batch_torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((m, n, 2), generator=gen, device=dev)
    pts = (pts * torch.tensor([400.0, 600.0], device=dev)).contiguous()
    err = compare(f"{name} ({m},{n},{k})", kernel(pts, k), knn_batch_torch(pts, k))

    ties = tie_cases(n, min(m, 48), dev)
    compare(f"{name} ties", kernel(ties, k), knn_batch_torch(ties, k))

    valid = torch.rand((min(m, 64), n), generator=gen, device=dev) < 0.5
    valid[::4] = False
    valid[::4, : k - 1] = True  # rows with fewer than k valid points
    sub = pts[: valid.shape[0]].contiguous()
    got = kernel(sub, k, valid)
    compare(f"{name} valid", got, knn_batch_torch(sub, k, valid))
    own = torch.arange(n, device=dev)[None, :]
    if not bool((got[0][::4, :, k - 1] == own).all()):
        raise AssertionError(f"{name}: short rows lack their self-loops")

    print(f"[smi] before {name} timing: {smi_sample()}")
    call_ms = time_ms(lambda: kernel(pts, k), reps)
    ms = kernel_device_ms(lambda: kernel(pts, k), reps, f"{name}_kernel")
    print(f"[smi] after {name} timing: {smi_sample()}")
    plain_ms = time_ms(lambda: knn_batch_torch(pts, k), max(2, reps // 20), 1)
    bound_ms, bound_by = knn_bound_ms(m, n, k, with_valid=False)
    print(f"[kernel] {name} ({m},{n},{k}): ok, max_abs_err {err}, "
          f"{ms:.4f} ms on the device, {call_ms:.4f} ms a call back to back, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    # "ms" is the kernel's device time; "call_ms" CUDA events around
    # back-to-back calls, which read the host's launch path when that is
    # slower than the kernel.
    return {"shape": [m, n, k], "max_abs_err": err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# Phase 3's eval formation-steps/s by label; phase 12 prints its VecEnv's
# rate beside them.
EVAL_RATES = {}


def run_swarm(model, params, m, label):
    """One evaluation through the port's entry point with the launch
    counts set to 0 just before and read just after."""
    import torch

    from marl_distributedformation_tpu_torch.eval import (
        episode_length,
        evaluate,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    out = evaluate(policy_act_fn(model, params), params, m, seed=1234,
                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    T = episode_length(params)
    EVAL_RATES[label] = m * T / wall
    if not all(math.isfinite(v) for v in out.values()):
        raise AssertionError(f"{label}: non-finite eval output {out}")
    if out["episodes"] != m:
        raise AssertionError(f"{label}: {out['episodes']} episodes, want {m}")
    print(f"[swarm] {label}: M={m} N={params.num_agents} T={T} "
          f"{wall:.2f} s, {m * T / wall:.1f} formation-steps/s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}, return/agent "
          f"{out['episode_return_per_agent']:.3f}")
    return launches, T


def kernel_equals_plain_end_to_end(model, params, m):
    """The whole evaluation with the kernels and with the plain version,
    on the same card from the same seed: equal results."""
    from marl_distributedformation_tpu_torch.eval import evaluate, policy_act_fn

    runs = {}
    for impl in ("auto", "torch"):
        p = params.replace(knn_impl=impl)
        runs[impl] = evaluate(policy_act_fn(model, p), p, m, seed=99,
                              device="cuda")
    if runs["auto"] != runs["torch"]:
        raise AssertionError(f"kernel path {runs['auto']} != plain path "
                             f"{runs['torch']} at N={params.num_agents}")
    print(f"[swarm] N={params.num_agents} M={m}: kernel path == plain path "
          f"({runs['auto']['episode_return_per_agent']:.4f})")


def profile_breakdown(model, params, m, steps=4):
    """``profile_window`` over a short evaluation (``steps`` + 2 steps)."""
    from marl_distributedformation_tpu_torch.eval import evaluate, policy_act_fn

    p = params.replace(max_steps=steps)
    act = policy_act_fn(model, p)

    def run():
        evaluate(act, p, m, seed=5, device="cuda")

    run()
    profile_window(run, f"N={params.num_agents} M={m}, {steps + 2} steps",
                   steps + 2, "step")


def busy_union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: the time the
    device had at least one kernel (or copy) running, each instant counted
    once however many ran in it."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile_window(run, label, per, unit, top=8):
    """Device time by kernel over one call of ``run`` (warmed up by the
    caller) under ``torch.profiler``, and the device's busy share of the
    window's wall time: the union of the device events' intervals in the
    trace (kernels that overlap count once), which must not exceed the
    wall time; the sum of the kernels' times is printed beside it, as a
    sum. Profiling slows the host, so the share may read low. Prints the
    ``top`` kernels and every k-NN kernel, in ms per ``unit`` (``per`` of
    them in the window); returns the busy share in percent (None when the
    trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    started = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    cuda = torch.autograd.DeviceType.CUDA
    union = busy_union_us(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == cuda and e.time_range.end > e.time_range.start
    )
    # Only the kernels themselves: an operator's row also carries the
    # device time of the kernels it launched, which would count them twice.
    events = [
        e for e in prof.key_averages()
        if e.device_type == cuda and device_us(e) > 0
    ]
    total = sum(device_us(e) for e in events)
    if total == 0 or union == 0:
        print(f"[profile] {label}: no device time in the trace (not measured)")
        return None
    share = 100 * union / wall_us
    if union > wall_us:
        raise AssertionError(f"{label}: device busy {union:.1f} us, the "
                             f"union of its intervals, exceeds the window's "
                             f"{wall_us:.1f} us")
    launches = sum(e.count for e in events)
    print(f"[profile] {label}: device busy {union / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({share:.1f}%, the union of the "
          f"device intervals); sum of kernel times {total / 1e3:.3f} ms "
          f"({100 * total / wall_us:.1f}% of wall, a sum, not a share); "
          f"{union / per / 1e3:.4f} ms busy/{unit}, {launches / per:.0f} "
          f"kernel launches/{unit}; the window and the trace's processing "
          f"{time.perf_counter() - started:.1f} s")
    # The k-NN kernels always, on the run's own positions, even when they
    # fall outside the top.
    ranked = sorted(events, key=device_us, reverse=True)
    shown = ranked[:top] + [e for e in ranked[top:] if "knn_" in e.key]
    for e in shown:
        print(f"[profile]   {device_us(e) / total * 100:5.1f}%  "
              f"{device_us(e) / per / 1e3:8.4f} ms/{unit}  x{e.count // per:<5d} "
              f"{e.key[:90]}")
    return share


# The published 100-agent training command (docs/acceptance/gnn100) and the
# N=1024 one (docs/acceptance/gnn1024), and the TPU record of the first.
GNN100 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=100",
          "num_formation=1024", "preset=tpu", "total_timesteps=30720000")
GNN1024 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=1024",
           "num_formation=8", "preset=tpu", "total_timesteps=983040")
# gnn100's command at 20 iterations (scen100's since phase 16 was paid
# for).
GNN100_20 = GNN100[:-1] + ("total_timesteps=20480000",)
MLP_DEFAULT = ("total_timesteps=100000",)  # M=1000, N=5: 2 iterations
TPU_GNN100_CURVE = {1: -37.56, 5: -25.94, 10: -9.49, 20: 7.74, 30: 8.71}
LEARN_MARGIN = 20.0
# A captured phase runs eagerly on its first call and is captured on its
# second, so the first two iterations build; the steady split leaves them
# out (one for an eager run).
WARM_ITERATIONS = {True: 2, False: 1}


def record_phases(trainer):
    """Records a CUDA event at the start of each iteration, after its
    rollout (and GAE) and at its end, through ``Trainer.phase_hook``;
    returns the list the events go into, one triple an iteration."""
    import torch

    phases = []

    def hook(phase):
        if phase == "rollout":
            phases.append([])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        phases[-1].append(event)

    trainer.phase_hook = hook
    return phases


def train_run(name, overrides, label, capture=True, before_train=None):
    """One run of the port's ``train`` CLI on the card (``build_trainer``
    then ``Trainer.train``, as its ``main`` runs them), the launch counts
    set to 0 just before it and read just after; ``capture=False`` runs the
    iteration eagerly; ``before_train(trainer)`` is called between the two.
    Prints the time an iteration (the warm-up and capture iterations left
    out of the steady split), throughput (for a curriculum also its active
    agent-transitions, averaged over the run's stages), peak memory and the
    graphs' sizes; returns ``(trainer, rewards an iteration, launches,
    steady s/iteration)``."""
    import shutil

    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train import cli

    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    trainer = cli.build_trainer([f"name={name}", "device=cuda", *overrides],
                                capture=capture)
    events = record_phases(trainer)
    if before_train is not None:
        before_train(trainer)
    member_rows = []
    if hasattr(trainer, "num_seeds"):
        # A population's records hold member means: keep each dispatch's
        # per-member rows (a device copy queued behind it, no sync).
        dispatch = trainer._dispatch

        def keep_rows(rollouts):
            chunk = dispatch(rollouts)
            member_rows.append(chunk.rows.clone())
            return chunk

        trainer._dispatch = keep_rows
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    trainer.phase_hook = None
    if member_rows:
        del trainer._dispatch
        rows = torch.cat(member_rows).cpu()
        # (iterations, K): each member's reward an iteration.
        trainer.smoke_member_rewards = rows[
            ..., trainer.metric_names.index("reward")].numpy()
    lines = (Path(trainer.log_dir) / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    trainer.smoke_records = records
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label}: non-finite metrics {r}")
    iters = len(events)
    if len(records) != iters:
        raise AssertionError(f"{label}: {len(records)} records of {iters} "
                             "iterations")
    phase_ms = [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
                for e in events]
    trainer.smoke_phase_ms = phase_ms
    phases = phase_ms[WARM_ITERATIONS[capture]:] or phase_ms
    roll, upd = mean(p[0] for p in phases), mean(p[1] for p in phases)
    s_iter = (roll + upd) / 1e3
    m = trainer.config.num_formations
    n = trainer.env_params.num_agents
    k = getattr(trainer, "num_seeds", 1)  # a population's members
    rate = trainer.ppo.n_steps * m * k / s_iter
    steps_per_iter = trainer.step // iters
    graphs = "; ".join(
        f"{g['phase']} {g['nodes']} nodes, captured in "
        f"{g['capture_s']:.3f} s, {g['calls']} calls"
        for g in trainer.graph_stats() if g["capture_s"] is not None
    ) or "none (eager)"
    per_member = (f" (population of {k}; per member {rate / k:.1f} "
                  f"formation-steps/s, {rate * n / k:.1f} "
                  "agent-transitions/s)") if k > 1 else ""
    if hasattr(trainer, "curriculum"):
        # Active agent-transitions of the whole run, over its steady time.
        active = float(np.sum(getattr(trainer, "num_timesteps_members",
                                      trainer.num_timesteps)))
        per_s = active / iters / s_iter
        per_member += (f"; active agent-transitions/s {per_s:.1f} (padded "
                       f"to N_max={n}; per member {per_s / k:.1f})")
    print(f"[train] {label} ({'captured' if capture else 'eager'}): {iters} "
          f"iterations in {wall:.2f} s ({wall / iters:.3f} s each with "
          f"start-up, capture and saves); steady {s_iter:.4f} s/iteration = "
          f"rollout+GAE {roll / 1e3:.4f} + update {upd / 1e3:.4f} "
          f"({steps_per_iter} optimizer steps, "
          f"{steps_per_iter / (upd / 1e3):.1f}/s); {rate:.1f} "
          f"formation-steps/s, {rate * n:.1f} agent-transitions/s"
          f"{per_member} (metrics.jsonl: "
          f"{records[-1]['env_steps_per_sec']:.1f}); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held before the run; launches "
          f"{launches}; graphs: {graphs}")
    return trainer, [r["reward"] for r in records], launches, s_iter


def learning_check(rewards, label, margin):
    first3, last3 = mean(rewards[:3]), mean(rewards[-3:])
    print(f"[learn] {label}: mean reward of the first 3 iterations "
          f"{first3:.3f}, of the last 3 {last3:.3f}")
    if not last3 >= first3 + margin:
        raise AssertionError(f"{label}: last-3 mean {last3:.3f} does not "
                             f"beat first-3 {first3:.3f} by {margin}")
    return first3, last3


def rollout_graph_equals_plain(model, n, m):
    """A 10-step rollout of ``model`` on M formations of N agents captured
    as a CUDA graph through the k-NN kernel ``auto`` picks (warmed up,
    captured, replayed from the generators' states at capture) against an
    eager rollout through the plain k-NN from the same states: bitwise
    equal. A population (``PopulationModel``) rolls its K members' M
    formations each, folded into one batch, from K generators. The
    kernel's launches count by replay."""
    import torch

    from marl_distributedformation_tpu_torch.algo import collect_rollout
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        compute_obs,
        reset_batch,
    )
    from marl_distributedformation_tpu_torch.models.population import (
        PopulationModel,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train.capture import (
        PhaseGraph,
        own_stream,
    )

    dev = torch.device("cuda")
    k = getattr(model, "num_members", None)
    runs = {}
    for impl in ("auto", "torch"):
        params = EnvParams(num_agents=n, obs_mode="knn", knn_k=4,
                           knn_impl=impl)
        gens = [torch.Generator(device=dev).manual_seed(17 + i)
                for i in range(k or 1)]
        streams = gens if k else gens[0]
        state = reset_batch(params, (k or 1) * m, streams, dev)
        obs = compute_obs(state.agents, state.goal, params)
        start = [g.get_state() for g in gens]
        out = []

        forward = PopulationModel.rollout_forward if k else None

        def rollout():
            out[:] = collect_rollout(model, state, obs, streams, params, 10,
                                     forward=forward)

        if impl == "auto":
            knn_cuda.reset_launches()
            graph = PhaseGraph("rollout", rollout, gens,
                               stream=own_stream(rollout, dev))
            graph()  # the warm-up, eager
            for g, s in zip(gens, start):
                g.set_state(s)
            graph()  # captured, then replayed
            torch.cuda.synchronize()
            launches = dict(knn_cuda.LAUNCHES)
            if sum(launches.values()) != 20:
                raise AssertionError(f"rollout graph launches {launches}, "
                                     "want 10 eager + 10 replayed")
        else:
            rollout()
        runs[impl] = out
    (_, o1, b1, v1), (_, o2, b2, v2) = runs["auto"], runs["torch"]
    for field in ("obs", "actions", "log_probs", "values", "rewards"):
        if not torch.equal(getattr(b1, field), getattr(b2, field)):
            raise AssertionError(f"rollout {field}: graph through the kernel "
                                 "!= eager plain path")
    if not (torch.equal(o1, o2) and torch.equal(v1, v2)):
        raise AssertionError("rollout last obs/value: graph != eager plain")
    who = f"K={k} x M={m}" if k else f"M={m}"
    print(f"[rollout] N={n} {who}, 10 steps: captured graph through the "
          f"kernel == eager plain path bitwise (obs, actions, log_probs, "
          f"values, rewards); {graph.nodes} nodes; launches {launches}")


def _carry(trainer):
    """The trainer's state as tensors: parameters, Adam state, step, env
    carry, the metrics ring and the generators (a population's K)."""
    import torch

    it = trainer._iteration
    gens = getattr(trainer, "generators", None) or [trainer.generator]
    return {
        **{f"param {k}": p.detach().clone()
           for k, p in trainer.model.named_parameters()},
        **{f"mu {k}": v.clone() for k, v in trainer.opt_state.mu.items()},
        **{f"nu {k}": v.clone() for k, v in trainer.opt_state.nu.items()},
        "count": trainer.opt_state.count.clone(), "step": it.step.clone(),
        "agents": it.env.agents.clone(), "obs": it.obs.clone(),
        "metrics": it.ring.buf.clone(),
        "generator": torch.stack([g.get_state() for g in gens]),
    }


def captured_equals_eager(kind, iterations=3, members=None):
    """Two trainers from one seed on the card, one captured and one eager,
    ``iterations`` iterations each (the last fully replayed): parameters,
    Adam state, step, env carry, metrics and generator bitwise equal, the
    MLP's and (since the gather's backward adds in a fixed order, C4) the
    GNN's. With ``members`` K, two populations of K (members from seeds 3,
    4, ...), every member's state and generator held the same way."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        GNNActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )
    from marl_distributedformation_tpu_torch.train.sweep import SweepTrainer

    if kind == "mlp":
        params, m, ppo = EnvParams(), 64, PPOConfig()
    else:
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
        m, ppo = 64, PPOConfig(batch_size=16384)

    def make(seed):
        gen = torch.Generator().manual_seed(seed)
        return (MLPActorCritic(params.obs_dim, generator=gen)
                if kind == "mlp" else GNNActorCritic(k=4, generator=gen))

    carries = {}
    for capture in (True, False):
        config = TrainConfig(num_formations=m, seed=3, checkpoint=False,
                             log_dir=str(ROOT / "logs" / "smoke_compare"))
        if members:
            trainer = SweepTrainer(
                params, ppo, config, members,
                models=[make(3 + i) for i in range(members)],
                device="cuda", capture=capture,
            )
        else:
            trainer = Trainer(params, ppo, config, model=make(3),
                              device="cuda", capture=capture)
        for _ in range(iterations):
            trainer.run_iteration()
        torch.cuda.synchronize()
        carries[capture] = _carry(trainer)
    got, want = carries[True], carries[False]
    updates = trainer.step
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"{kind}: captured {key} != eager")
    what = "params, Adam state, step, env carry, metrics and generator bitwise"
    who = f"K={members} x M={m}" if members else f"M={m}"
    print(f"[capture] {kind} {who}: {iterations} iterations captured == "
          f"eager: {what} ({updates} optimizer steps)")


def poisoned_health_run():
    """The ring/MLP at M=64 with ``fused_chunk=2 health=true
    recovery=true``: one ``_poison_carry(nan)`` before the third chunk. The
    health word skips the poisoned iterations, the ladder rolls back to the
    last good checkpoint, and the run ends on finite parameters with a
    rollback in ``recovery.jsonl``."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.train.recovery import (
        read_recovery_log,
    )

    name = "smoke_health"
    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    trainer = cli.build_trainer([
        f"name={name}", "device=cuda", "num_formation=64",
        "total_timesteps=32000", "fused_chunk=2", "health=true",
        "recovery=true", "keep_last_n=3",
    ])
    run_chunk = trainer.run_chunk
    chunks = []

    def poisoned():
        if len(chunks) == 2:
            trainer._poison_carry(float("nan"))
        chunks.append(1)
        return run_chunk()

    trainer.run_chunk = poisoned
    trainer.train()
    del trainer.run_chunk
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.model.parameters())
    events = read_recovery_log(Path(trainer.log_dir) / "recovery.jsonl")
    kinds = [e["event"] for e in events]
    if not finite or "rollback" not in kinds or trainer.halted:
        raise AssertionError(f"health run: finite {finite}, halted "
                             f"{trainer.halted}, recovery events {kinds}")
    print(f"[health] MLP M=64 fused_chunk=2, NaN poison before chunk 3: "
          f"ends finite at {trainer.num_timesteps} steps; recovery.jsonl "
          f"{kinds}")


def wall_s(fn):
    """Seconds of one call of ``fn`` to the end of its device work."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def epoch_window(trainer):
    """A call of ``trainer``'s rollout phase and of its minibatch phase for
    one epoch's steps: the window the captured-to-eager ratios and the
    ring/MLP profile read (captured: replays; eager: the steps)."""
    rollout, minibatch, _ = trainer._phases
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs

    def window():
        rollout()
        for _ in range(steps):
            minibatch()

    return window


def capture_gc_check():
    """A graph owner left as cyclic garbage while another owner captures:
    the collector is off inside the capture, where freeing the owner would
    reset its CUDAGraph on the capturing thread and fail the capture (it
    failed ``smoke_profile64``'s once). The collector is made eager
    (threshold 1) around the check, and the garbage must be gone after."""
    import gc
    import weakref

    import torch

    from marl_distributedformation_tpu_torch.train.capture import (
        PhaseGraph,
        own_stream,
    )

    x = torch.zeros(64, device="cuda")

    class Owner:
        pass

    def victim():
        owner = Owner()
        owner.cycle = owner
        owner.graph = PhaseGraph("gc_victim", lambda: x.add_(1),
                                 stream=own_stream(owner, "cuda"))
        owner.graph()  # the warm-up
        owner.graph()  # the capture
        return weakref.ref(owner)

    seen = []

    def fn():
        seen.append(gc.isenabled())
        junk = [[i] for i in range(1000)]  # allocations that collect
        x.mul_(len(junk) // 1000)

    holder = Owner()
    graph = PhaseGraph("gc_probe", fn, stream=own_stream(holder, "cuda"))
    thresholds = gc.get_threshold()
    gc.collect()
    gone = victim()
    gc.set_threshold(1, 1, 1)
    try:
        graph()  # the warm-up
        graph()  # the capture
        graph()  # a replay
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    torch.cuda.synchronize()
    if seen != [True, False] or gone() is not None or graph.graph is None:
        raise AssertionError(
            f"capture_gc: the collector on in fn {seen}, want [True, "
            f"False]; the victim collected after: {gone() is None}")
    print("[capture] a graph owner left as cyclic garbage with the "
          "collector at threshold 1: another owner's capture ran with the "
          "collector off and succeeded; the garbage went at the next "
          "collection")


def train_phase():
    """Phase 5; returns the training paths' launch counts and the captured
    ``gnn100`` run's rewards and s/iteration (phase 6 sets them beside its
    population's)."""
    import torch

    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    kept = {}
    trainer, rewards, got, captured_s = train_run(
        "smoke_gnn100", GNN100 + ("fused_chunk=10",),
        "gnn100 M=1024 N=100 fused_chunk=10",
        before_train=lambda t: kept.update(params=keep_params(t, (1, 2, 3))))
    # Phase 16 holds dp100x1 and dp100x2 against these; phase 14's bench
    # record takes the rate (the train_env_steps_per_sec gauge's
    # formation-steps/s), the largest capture and the memory peak.
    gnn100 = {"rewards": rewards, "s_iter": captured_s,
              "model": trainer.model, "params_at": kept["params"],
              "ckpt": latest_checkpoint(trainer.log_dir),
              "env_steps_per_sec": (trainer.ppo.n_steps
                                    * trainer.config.num_formations
                                    / captured_s),
              "capture_s_max": max(g["capture_s"]
                                   for g in trainer.graph_stats()
                                   if g["capture_s"] is not None),
              "watermark_bytes": torch.cuda.max_memory_allocated()}
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"gnn100 launches {got}, want fused {want}")
    launches = {"knn_fused": got["knn_fused"]}
    print("[learn] gnn100 reward by iteration, port (TPU record): " + ", ".join(
        f"{i}: {rewards[i - 1]:.2f} ({tpu})"
        for i, tpu in TPU_GNN100_CURVE.items() if i <= len(rewards)))
    _, last3 = learning_check(rewards, "gnn100", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"gnn100: last-3 mean {last3:.3f} is not > 0")
    ckpt = latest_checkpoint(trainer.log_dir)
    res = evaluate_cli.main([
        f"checkpoint={ckpt}", "obs_mode=knn", "policy=gnn",
        "num_agents_per_formation=100", "eval_formations=1024",
        "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"gnn100 ranking learned > baseline > zero "
                             f"fails: {ret}")
    print(f"[gnn100] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f} (M=1024)")
    rollout_graph_equals_plain(trainer.model, 100, 1024)
    # Depth cut for phase 18's room: the rollout and the first of the 10
    # epochs (the epochs replay one graph), not the whole iteration, whose
    # 153,237 traced kernels took the profiler 16.8 s to process.
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    profile_window(epoch_window(trainer), f"train gnn100 M=1024 N=100, the "
                   f"rollout and the first epoch ({steps} minibatch "
                   "replays) of a captured iteration", 1, "window")
    elapsed("gnn100 captured")

    # The captured-to-eager ratio over one window, the rollout and the
    # first of the 10 epochs, by a trainer of the same command built with
    # capture=False (its phases' first calls are their eager builds; cut
    # from 2 whole eager iterations, 10.2 s on an NVIDIA H100 80GB HBM3 at
    # 700 W, for phase 14's room), beside the same window replayed.
    window_s = {"captured": wall_s(epoch_window(trainer))}
    eager = cli.build_trainer(["name=smoke_gnn100_eager", "device=cuda",
                               *GNN100], capture=False)
    window_s["eager"] = wall_s(epoch_window(eager))
    print(f"[capture] gnn100, the rollout and the first epoch "
          f"({trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs}"
          f" minibatch steps): captured {window_s['captured']:.4f} s, eager "
          f"{window_s['eager']:.4f} s, "
          f"{window_s['eager'] / window_s['captured']:.2f}x (a whole captured "
          f"iteration {captured_s:.4f} s)")
    del eager
    elapsed("gnn100 eager window")

    trainer, rewards, got, _ = train_run("smoke_gnn1024", GNN1024,
                                         "gnn1024 M=8 N=1024")
    # Phase 9's matrix on N=1024 evaluates the run's checkpoint.
    gnn100["ckpt1024"] = (latest_checkpoint(trainer.log_dir)
                          or trainer.save())
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": 0, "knn_tiled": want}:
        raise AssertionError(f"gnn1024 launches {got}, want tiled {want}")
    launches["knn_tiled"] = got["knn_tiled"]
    learning_check(rewards, "gnn1024", 0.0)
    rollout_graph_equals_plain(trainer.model, 1024, 8)
    profile_window(trainer.run_iteration, "train gnn1024 M=8 N=1024, one "
                   "captured iteration", 1, "iteration")

    trainer, *_, captured_s = train_run(
        "smoke_mlp", MLP_DEFAULT, "ring/MLP default M=1000 N=5")
    elapsed("gnn1024 captured, ring/MLP captured")
    # Depth cut: its rollout and the first tenth of its first epoch (78 of
    # 7,810 replays of one minibatch graph), not the whole iteration, whose
    # 1.39 M traced kernels took the profiler 116-177 s, nor the whole
    # first epoch (16.5 s of processing; cut for phase 18's room): the
    # epochs replay one graph.
    first_epoch = epoch_window(trainer)
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    rollout, minibatch, _ = trainer._phases

    def profiled():
        rollout()
        for _ in range(steps // 10):
            minibatch()

    profile_window(profiled, f"train ring/MLP default, the rollout and the "
                   f"first {steps // 10} of its first epoch's {steps} "
                   "minibatch replays, of a captured iteration", 1, "window")
    elapsed("ring/MLP profile")
    # The captured-to-eager ratio over that same window (cut from a whole
    # eager iteration, 52.8 s of host-bound launches on an NVIDIA H100 80GB
    # HBM3 at 700 W, for phase 14's room): the window replayed once more
    # and timed, then the same window run eagerly by a trainer of the same
    # command built with capture=False.
    captured_window_s = wall_s(first_epoch)
    eager = cli.build_trainer(["name=smoke_mlp_eager", "device=cuda",
                               *MLP_DEFAULT], capture=False)
    eager_window_s = wall_s(epoch_window(eager))
    del eager
    print(f"[capture] ring/MLP default, the rollout and the first epoch "
          f"({steps} minibatch steps): captured {captured_window_s:.4f} s, "
          f"eager {eager_window_s:.4f} s, "
          f"{eager_window_s / captured_window_s:.2f}x (a whole captured "
          f"iteration {captured_s:.4f} s)")

    elapsed("ring/MLP eager window")
    captured_equals_eager("mlp")
    captured_equals_eager("gnn")
    poisoned_health_run()
    return launches, gnn100


# The published population command (docs/acceptance/sweep8/README.md) and
# its record, the TPU's (docs/acceptance/sweep8/REGRESSION.md: population
# mean reward in 25-iteration windows; eval_all_members_tpu.json).
SWEEP8 = ("num_seeds=8", "num_formation=16", "num_agents_per_formation=3",
          "strict_parity=false", "max_steps=64", "n_steps=16",
          "batch_size=192", "n_epochs=4", "total_timesteps=153600",
          "save_freq=3200", "use_wandb=false")
SWEEP8_ENV = ("num_agents_per_formation=3", "strict_parity=false",
              "max_steps=64")
TPU_SWEEP8_WINDOWS = {(1, 25): -47.3, (76, 100): -38.3, (126, 150): -37.1,
                      (151, 175): -36.7, (176, 200): -38.1}
SWEEP8_MARGIN = 5.0
# Cut from gnn100's 30 iterations to 20 for phase 13's room and to 16 for
# phase 17's, in chunks of 8 (a fused loop runs whole chunks): by 16 the
# learning gate (last 3 above the first 3 by 20, the best member above 0)
# holds with a margin of ~39 (member 0 at 2.44, 4.61, 5.85 over iterations
# 14-16, the population mean of the first 3 -35.21, on an NVIDIA H100 80GB
# HBM3 at 700 W).
POP4 = GNN100[:-1] + ("total_timesteps=16384000", "num_seeds=4",
                      "fused_chunk=8")
# The N=1024 population: gnn1024's command, 2 members, 4 iterations.
POP1024 = GNN1024[:-1] + ("total_timesteps=327680", "num_seeds=2")
LR_SWEEP = ("num_formation=64", "num_seeds=4",
            "learning_rates=[1e-4,3e-4,1e-3,3e-3]")
# Member 0 of pop4 and the single gnn100 run share seed 0: iteration 1
# (before any update) differs only by the rounding of the members' batched
# matmuls, so its population-mean reward agrees to this relative tolerance.
ITER1_RTOL = 1e-3


def sweep_eval(name, env):
    """The evaluate CLI's sweep mode on the run's member directories
    (1024 held-out formations, seed 1234)."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli

    return evaluate_cli.main([f"name={name}", *env, "eval_formations=1024",
                              "eval_seed=1234", "device=cuda"])


def lr_sweep_check():
    """The ring/MLP lr sweep, 3 iterations: each member's rate is its own
    in the device ``lr``, the anchor and its member file; the first
    update's mean parameter step grows with the members' rates; and a run
    of 2 iterations resumed from its anchor for a third equals the run of
    3 bitwise (parameters, Adam state, steps, env carry, generators)."""
    import shutil

    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.train import cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
        latest_sweep_state,
        msgpack_restore_file,
    )

    per_iter = 64 * 5 * 10
    rates = np.float32([1e-4, 3e-4, 1e-3, 3e-3])
    for name in ("smoke_lr_full", "smoke_lr_part"):
        shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    full = cli.build_trainer(["name=smoke_lr_full", "device=cuda", *LR_SWEEP,
                              f"total_timesteps={3 * per_iter}"])
    before = {k: p.detach().clone() for k, p in full.model.params.items()}
    full.run_iteration()
    step = torch.stack([
        (full.model.params[k] - before[k]).abs().reshape(4, -1).mean(1)
        for k in before
    ]).mean(0).tolist()
    full.train()
    if not (step[0] < step[1] < step[2] < step[3]):
        raise AssertionError(f"lr sweep: mean first-update steps {step} do "
                             f"not grow with the rates {rates.tolist()}")
    got = full._iteration.lr.cpu().numpy()
    anchor = msgpack_restore_file(latest_sweep_state(full.log_dir))
    hyper = anchor["opt_state"]["1"]["hyperparams"]["learning_rate"]
    member = [msgpack_restore_file(latest_checkpoint(
        Path(full.log_dir) / f"seed{i}"))["learning_rate"] for i in range(4)]
    for what, value in (("device lr", got), ("anchor", anchor[
            "learning_rates"]), ("anchor opt_state", hyper),
            ("member files", np.float32(member))):
        if not np.array_equal(np.asarray(value, np.float32), rates):
            raise AssertionError(f"lr sweep: {what} rates {value}, want "
                                 f"{rates.tolist()}")
    part = cli.build_trainer(["name=smoke_lr_part", "device=cuda", *LR_SWEEP,
                              f"total_timesteps={2 * per_iter}"])
    part.train()
    resumed = cli.build_trainer(["name=smoke_lr_part", "device=cuda",
                                 *LR_SWEEP, f"total_timesteps={3 * per_iter}",
                                 "resume=true"])
    resumed.train()
    torch.cuda.synchronize()
    a, b = _carry(full), _carry(resumed)
    for key in a:
        if key != "metrics" and not torch.equal(a[key], b[key]):
            raise AssertionError(f"lr sweep: resumed {key} != the "
                                 "uninterrupted run's")
    print(f"[sweep] lr sweep ring/MLP K=4 M=64: rates "
          f"{[f'{x:g}' for x in rates]} in the device lr, the anchor and the "
          f"member files; mean first update {[f'{x:.3g}' for x in step]}; "
          f"resumed from the anchor at "
          f"{2 * per_iter} steps == uninterrupted at {3 * per_iter}, "
          "bitwise")


def population_phase(gnn100):
    """Phase 6, populations; returns their paths' launch counts."""
    import numpy as np

    trainer, rewards, got, pop_s = train_run(
        "smoke_pop4", POP4, "pop4 K=4 M=1024 N=100 fused_chunk=8")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"pop4 launches {got}, want fused {want}")
    launches = {"knn_fused": got["knn_fused"]}
    member0 = trainer.smoke_member_rewards[:, 0]
    single = gnn100["rewards"]
    print("[learn] pop4 member 0 (seed 0) reward by iteration beside the "
          "single gnn100 run of phase 5: " + ", ".join(
              f"{i + 1}: {a:.2f} ({b:.2f})"
              for i, (a, b) in enumerate(zip(member0, single))))
    if not abs(member0[0] - single[0]) <= ITER1_RTOL * abs(single[0]):
        raise AssertionError(f"pop4 member 0 iteration 1 {member0[0]} != "
                             f"gnn100 {single[0]} within rtol {ITER1_RTOL}")
    learning_check(rewards, "pop4 population mean", LEARN_MARGIN)
    best = float(trainer.smoke_member_rewards[-1].max())
    if not best > 0:
        raise AssertionError(f"pop4: best member ends at {best}, not > 0")
    print(f"[pop4] last iteration's member rewards "
          f"{np.round(trainer.smoke_member_rewards[-1], 3).tolist()}; "
          f"s/iteration {pop_s:.4f} against 4 x gnn100's "
          f"{gnn100['s_iter']:.4f}: ratio {pop_s / (4 * gnn100['s_iter']):.3f}")
    res = sweep_eval("smoke_pop4", ("obs_mode=knn", "policy=gnn",
                                    "num_agents_per_formation=100"))
    if not res["best_return"] > res["baseline_return"] > res["zero_return"]:
        raise AssertionError(f"pop4 ranking best > baseline > zero fails: "
                             f"{res}")
    print(f"[pop4] best member {res['best_member']} {res['best_return']:.2f} "
          f"> baseline {res['baseline_return']:.2f} > zero "
          f"{res['zero_return']:.2f} (M=1024)")
    rollout_graph_equals_plain(trainer.model, 100, 1024)
    # Depth cut for phase 17's room: the rollout and the first of the 10
    # epochs (the epochs replay one graph), not the whole iteration, whose
    # 269,560 traced kernels the profiler took tens of seconds to process.
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    profile_window(epoch_window(trainer), f"train pop4 K=4 M=1024 N=100, "
                   f"the rollout and the first epoch ({steps} minibatch "
                   "replays) of a captured iteration", 1, "window")
    elapsed("pop4")

    trainer, rewards, got, _ = train_run("smoke_pop1024", POP1024,
                                         "pop1024 K=2 M=8 N=1024")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if got != {"knn_fused": 0, "knn_tiled": want}:
        raise AssertionError(f"pop1024 launches {got}, want tiled {want}")
    launches["knn_tiled"] = got["knn_tiled"]
    rollout_graph_equals_plain(trainer.model, 1024, 8)
    profile_window(trainer.run_iteration, "train pop1024 K=2 M=8 N=1024, "
                   "one captured iteration", 1, "iteration")
    elapsed("pop1024")

    trainer, rewards, *_ = train_run("smoke_sweep8", SWEEP8,
                                     "sweep8 K=8 ring/MLP M=16 N=3")
    if len(rewards) != 200:
        raise AssertionError(f"sweep8: {len(rewards)} iterations, want 200")
    windows = {w: float(np.mean(rewards[w[0] - 1:w[1]]))
               for w in TPU_SWEEP8_WINDOWS}
    print("[learn] sweep8 population mean reward by 25-iteration window, "
          "port (the TPU's record): " + ", ".join(
              f"{a}-{b}: {windows[(a, b)]:.2f} ({tpu})"
              for (a, b), tpu in TPU_SWEEP8_WINDOWS.items()))
    early, late = windows[(1, 25)], float(np.mean(rewards[150:200]))
    print(f"[learn] sweep8: iterations 1-25 {early:.3f}, 151-200 {late:.3f}")
    if not late >= early + SWEEP8_MARGIN:
        raise AssertionError(f"sweep8: 151-200 mean {late:.3f} does not "
                             f"beat 1-25 {early:.3f} by {SWEEP8_MARGIN}")
    res = sweep_eval("smoke_sweep8", SWEEP8_ENV)
    if not res["beats_baseline"]:
        raise AssertionError(f"sweep8: best member does not beat the "
                             f"baseline: {res}")
    tpu = json.loads((ROOT / "docs/acceptance/sweep8/"
                      "eval_all_members_tpu.json").read_text())
    print(f"[sweep8] best member {res['best_member']} {res['best_return']:.2f}"
          f" > baseline {res['baseline_return']:.2f} (zero "
          f"{res['zero_return']:.2f}); the TPU's record: best "
          f"{tpu['best_member']} {tpu['best_return']:.2f}, baseline "
          f"{tpu['baseline_return']:.2f}")
    profile_window(trainer.run_iteration, "train sweep8 K=8 M=16 N=3, one "
                   "captured iteration", 1, "iteration")
    elapsed("sweep8")

    lr_sweep_check()
    captured_equals_eager("mlp", members=2)
    captured_equals_eager("gnn", members=2)
    elapsed("lr sweep, population captured == eager")
    return launches


# The published CTDE command (docs/acceptance/ctde20: 25 iterations at the
# default budget) with its record, a TPU v5e's curve and a CPU eval of the
# TPU-trained checkpoint (M=64).
CTDE20 = ("policy=ctde", "num_agents_per_formation=20",
          "num_formation=2048", "preset=tpu")
TPU_CTDE20_CURVE = {1: -37.58, 5: -25.90, 10: -11.05, 15: 3.93, 20: 6.70,
                    25: 7.63}
CTDE20_EVAL_RECORD = {"policy": 2375, "baseline": -1058, "zero": -30630}
# The CTDE actor on k-NN observations (root train.py allows it), 3
# iterations through knn_fused.
CTDE_KNN = ("policy=ctde", "obs_mode=knn", "num_agents_per_formation=100",
            "num_formation=1024", "preset=tpu", "total_timesteps=3072000")
# docs/acceptance/hetero5/README.md's K=4 command, letter for letter, and
# its CPU record's files.
HETERO5 = (
    "num_seeds=4", "num_formation=64", "num_agents_per_formation=20",
    "preset=tpu", "total_timesteps=2560000", "ent_coef_final=0.0",
    "log_std_final=-2.5", "log_std_decay_start=0.5",
    "curriculum=[{rollouts: 30, agent_counts: [5]},\n"
    "             {rollouts: 40, agent_counts: [5, 5, 20]},\n"
    "             {rollouts: 30, agent_counts: [5, 5, 20], num_obstacles: 4},\n"
    "             {rollouts: 100, agent_counts: [5, 5, 20], num_obstacles: 4}]",
)
HETERO5_DOCS = ROOT / "docs/acceptance/hetero5"
HETERO5_EVAL_ROWS = {
    "n5": ("num_agents_per_formation=5",),
    "n20": ("num_agents_per_formation=20",),
    "n20_obs": ("num_agents_per_formation=20", "num_obstacles=4"),
}
STAGE_MARGIN = 10.0  # each of stages 0-2: last 5 iterations over first 5
HETERO_CTDE = (
    "policy=ctde", "num_formation=64", "num_agents_per_formation=20",
    "preset=tpu",
    "curriculum=[{rollouts: 3, agent_counts: [20]},"
    " {rollouts: 3, agent_counts: [5, 20], num_obstacles: 2}]",
)


def stage_windows(rewards, ends, width=5):
    """``{stage: (mean of its first width iterations, of its last)}``."""
    out, start = {}, 0
    for i, end in enumerate(ends):
        seg = rewards[start:end]
        out[i] = (mean(seg[:width]), mean(seg[-width:]))
        start = end
    return out


def ctde_phase():
    """Phase 7a, CTDE: ``ctde20`` at full depth, its evaluation, and
    ``ctde_knn`` through ``knn_fused``; returns ``ctde_knn``'s launches."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    trainer, rewards, got, _ = train_run("smoke_ctde20", CTDE20,
                                         "ctde20 M=2048 N=20")
    if len(rewards) != 25 or got != {"knn_fused": 0, "knn_tiled": 0}:
        raise AssertionError(f"ctde20: {len(rewards)} iterations, launches "
                             f"{got}; want 25 on ring observations")
    print("[learn] ctde20 reward by iteration, port (a TPU v5e's record, "
          "docs/acceptance/ctde20): " + ", ".join(
              f"{i}: {rewards[i - 1]:.2f} ({tpu})"
              for i, tpu in TPU_CTDE20_CURVE.items()))
    _, last3 = learning_check(rewards, "ctde20", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"ctde20: last-3 mean {last3:.3f} is not > 0")
    res = evaluate_cli.main([
        f"checkpoint={latest_checkpoint(trainer.log_dir)}", "policy=ctde",
        "num_agents_per_formation=20", "eval_formations=64", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"ctde20 ranking learned > baseline > zero "
                             f"fails: {ret}")
    print(f"[ctde20] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f} (M=64, full "
          "episodes); the record, a CPU eval of the TPU-trained checkpoint: "
          + " / ".join(str(v) for v in CTDE20_EVAL_RECORD.values()))
    # Depth cut for phase 18's room: the rollout and the first epoch, not
    # the whole iteration (47,494 traced kernels).
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    profile_window(epoch_window(trainer), f"train ctde20 M=2048 N=20, the "
                   f"rollout and the first epoch ({steps} minibatch "
                   "replays) of a captured iteration", 1, "window")
    elapsed("ctde20")

    trainer, rewards, got, _ = train_run("smoke_ctde_knn", CTDE_KNN,
                                         "ctde_knn M=1024 N=100")
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != 3 or got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"ctde_knn launches {got} over {len(rewards)} "
                             f"iterations, want fused {want} over 3")
    # Depth cut for phase 18's room: the rollout and the first epoch, not
    # the whole iteration (12.5 s of the profiler's processing).
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    profile_window(epoch_window(trainer), f"train ctde_knn M=1024 N=100, "
                   f"the rollout and the first epoch ({steps} minibatch "
                   "replays) of a captured iteration", 1, "window")
    elapsed("ctde_knn")
    return got["knn_fused"]


def hetero5_run():
    """``hetero5`` at full depth: each of stages 0-2 learns, the captured
    graphs are the same after the last stage as after the first, then the
    sweep-mode evaluation of its three rows."""
    graphs_at_stage = []

    def track(trainer):
        start = trainer.start_stage

        def tracked(stage):
            graphs_at_stage.append(trainer.graph_count())
            start(stage)

        trainer.start_stage = tracked

    trainer, rewards, got, _ = train_run(
        "smoke_hetero5", HETERO5, "hetero5 K=4 M=64 N_max=20",
        before_train=track)
    del trainer.start_stage
    ends = trainer.curriculum.stage_ends()
    if len(rewards) != ends[-1] or got != {"knn_fused": 0, "knn_tiled": 0}:
        raise AssertionError(f"hetero5: {len(rewards)} iterations, launches "
                             f"{got}; want {ends[-1]} on ring observations")
    final = trainer.graph_count()
    print(f"[graphs] hetero5: captured graphs at each stage's start "
          f"{graphs_at_stage}, after the last stage {final}")
    if not graphs_at_stage[1] == final == 3:
        raise AssertionError("hetero5: the graph count changed across "
                             f"stages: {graphs_at_stage} then {final}")
    record = [json.loads(line) for line in (
        HETERO5_DOCS / "metrics_fix_cpu.jsonl").read_text().splitlines()]
    cpu = stage_windows([r["reward"] for r in record], ends)
    port = stage_windows(rewards, ends)
    for stage, (first, last) in port.items():
        a, b = cpu[stage]
        print(f"[learn] hetero5 stage {stage} population mean reward, first "
              f"5 -> last 5 iterations: {first:.3f} -> {last:.3f} (the CPU "
              f"record's, metrics_fix_cpu.jsonl: {a:.3f} -> {b:.3f})"
              + ("" if stage < 3 else "; not gated"))
        if stage < 3 and not last >= first + STAGE_MARGIN:
            raise AssertionError(f"hetero5 stage {stage}: last-5 mean "
                                 f"{last:.3f} does not beat first-5 "
                                 f"{first:.3f} by {STAGE_MARGIN}")
    print(f"[hetero5] members' final rewards "
          f"{[round(float(x), 3) for x in trainer.smoke_member_rewards[-1]]}")
    profile_window(trainer.run_iteration, "train hetero5 K=4 M=64 N_max=20, "
                   "one iteration (host loop, captured phases)", 1,
                   "iteration")
    elapsed("hetero5 training")

    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli

    passes = None
    for row, env in HETERO5_EVAL_ROWS.items():
        res = evaluate_cli.main(["name=smoke_hetero5", *env,
                                 "eval_formations=512", "eval_seed=1234",
                                 "eval_deterministic=true", "device=cuda"])
        ref = json.loads((HETERO5_DOCS / f"eval_member_ranking_{row}.json")
                         .read_text())
        beat = {m for m, r in res["member_returns"].items()
                if r > res["baseline_return"]}
        passes = beat if passes is None else passes & beat
        print(f"[hetero5] eval {row} (M=512, seed 1234, deterministic): "
              + ", ".join(f"{m} {r:.1f}" for m, r in
                          res["member_returns"].items())
              + f"; baseline {res['baseline_return']:.1f}, zero "
              f"{res['zero_return']:.1f}; {len(beat)} of 4 beat the "
              "baseline. The CPU record's (eval_member_ranking_"
              f"{row}.json): " + ", ".join(
                  f"{m} {r:.1f}" for m, r in ref["member_returns"].items())
              + f"; baseline {ref['baseline_return']:.1f}")
        if not (res["best_return"] > res["zero_return"]
                and res["baseline_return"] > res["zero_return"]):
            raise AssertionError(f"hetero5 eval {row}: best member "
                                 f"{res['best_return']} and baseline "
                                 f"{res['baseline_return']} must beat zero "
                                 f"{res['zero_return']}")
    print(f"[hetero5] members beating the baseline in all three rows: "
          f"{sorted(passes)} ({len(passes)} of 4; the README expects about "
          "1 in 3 to 1 in 5 candidates to)")
    elapsed("hetero5 evaluation")


def _hetero_carry(trainer):
    carry = _carry(trainer)
    carry["n_agents"] = trainer.layout.n_agents.clone()
    return carry


def curriculum_captured_equals_eager():
    """Captured against eager across a stage boundary, at M=64, N_max=20:
    the single curriculum run of 3 iterations (the boundary after the
    second) for the MLP and the CTDE model, bitwise; the curriculum
    population (K=2, MLP) with ``fused_chunk=2`` against the host loop,
    bitwise; and a population resumed from an anchor two rollouts into
    a three-rollout stage against the uninterrupted run, bitwise."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        CTDEActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import TrainConfig
    from marl_distributedformation_tpu_torch.train.curriculum import (
        Curriculum,
        CurriculumStage,
        HeteroTrainer,
    )
    from marl_distributedformation_tpu_torch.train.hetero_sweep import (
        HeteroSweepTrainer,
    )

    params = EnvParams(num_agents=20)
    base = ROOT / "logs" / "smoke_curriculum"
    shutil.rmtree(base, ignore_errors=True)

    def model(kind, seed):
        cls = CTDEActorCritic if kind == "ctde" else MLPActorCritic
        return cls(params.obs_dim, generator=torch.Generator().manual_seed(
            seed))

    def config(name, **kw):
        kw = {"num_formations": 64, "seed": 3, "checkpoint": False,
              "log_dir": str(base / name), **kw}
        return TrainConfig(**kw)

    def compare(a, b, what, skip=()):
        torch.cuda.synchronize()
        x, y = _hetero_carry(a), _hetero_carry(b)
        for key in x:
            if key not in skip and not torch.equal(x[key], y[key]):
                raise AssertionError(f"{what}: {key} differs")

    # 3 minibatches an epoch for both policies (CTDE's of 204 formations).
    ppo = PPOConfig(batch_size=4096)
    cur = Curriculum((CurriculumStage(2, (5, 20)),
                      CurriculumStage(1, (5, 20), num_obstacles=4)))
    for kind in ("mlp", "ctde"):
        runs = []
        for capture in (True, False):
            t = HeteroTrainer(cur, params, ppo,
                              config(f"{kind}{capture}"),
                              model=model(kind, 3), device="cuda",
                              capture=capture)
            t.train()
            runs.append(t)
        compare(*runs, f"curriculum {kind} captured vs eager")
        print(f"[capture] curriculum {kind} M=64 N_max=20, 3 iterations "
              f"across a stage boundary: captured == eager bitwise "
              f"(params, Adam state, step, env carry, counts, metrics, "
              f"generator; {runs[0].step} optimizer steps, "
              f"{runs[0].graph_count()} graphs)")

    cur = Curriculum((CurriculumStage(3, (5,)),
                      CurriculumStage(2, (5, 20), num_obstacles=4)))

    def sweep(name, **kw):
        return HeteroSweepTrainer(cur, params, ppo, config(name, **kw),
                                  2, models=[model("mlp", 3), model("mlp", 4)],
                                  device="cuda")

    host, fused = sweep("host"), sweep("fused", fused_chunk=2)
    host.train()
    fused.train()
    compare(host, fused, "curriculum population fused vs host loop",
            skip=("metrics",))
    records = [[{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "env_steps_per_sec")}
                for line in (Path(t.log_dir) / "metrics.jsonl").read_text()
                .splitlines()] for t in (host, fused)]
    if records[0] != records[1]:
        raise AssertionError("curriculum population: fused records differ")
    kw = dict(checkpoint=True, save_freq=10**9)
    full = sweep("full", **kw)
    full.train()
    per_iter = 10 * 64 * 5  # one member's active transitions in stage 0
    sweep("part", total_timesteps=2 * per_iter, **kw).train()
    resumed = sweep("part", resume=True, **kw)
    if resumed.completed_rollouts != 2:
        raise AssertionError(f"resumed at rollout "
                             f"{resumed.completed_rollouts}, want 2")
    resumed.train()
    compare(full, resumed, "curriculum population resumed mid-stage")
    print("[capture] curriculum population K=2 M=64 N_max=20 (MLP): "
          "fused_chunk=2 (chunks 2, 1 | 2) == the host loop bitwise, records "
          "equal; resumed from the anchor at rollout 2 of stage 0's 3 == the "
          "uninterrupted run bitwise")


def curriculum_phase():
    """Phase 7b, the curriculum: ``hetero5``, ``hetero_ctde`` and the
    captured-against-eager checks across stage boundaries."""
    import torch

    from marl_distributedformation_tpu_torch.algo.rollout import (
        policy_forward,
    )

    hetero5_run()
    trainer, *_ = train_run("smoke_hetero_ctde", HETERO_CTDE,
                            "hetero_ctde K=1 M=64 N_max=20")
    layout = trainer.layout
    with torch.no_grad():
        _, _, value = policy_forward(trainer.model, trainer.obs, layout.fmask)
    padded = ~layout.mask
    if not bool(padded.any()) or not bool((value[padded] == 0).all()):
        raise AssertionError("hetero_ctde: padded agents' values are not 0")
    print(f"[hetero_ctde] losses finite over 6 iterations; the "
          f"{int(padded.sum())} padded agents' values are exactly 0")
    profile_window(trainer.run_iteration, "train hetero_ctde M=64 N_max=20, "
                   "one captured iteration", 1, "iteration")
    curriculum_captured_equals_eager()
    elapsed("curriculum captured == eager")


# gnn100's command under a 3-stage scenario schedule; the changes at
# iterations 12 and 24 fall inside the 10-iteration chunks.
SCEN100_SCHEDULE = (
    "scenarios=[{rollouts: 12, scenarios: [clean]}, {rollouts: 5, "
    "scenarios: [wind, sensor_noise, actuator_fault], severity: 0.5}, "
    "{rollouts: 3, scenarios: [storm], severity: 1.0}]")
# 20 iterations (30, stages of 12, 12 and 6, before phase 16 was paid for):
# the learning gate reads the clean stage, which keeps its 12.
SCEN100_ITERS = 20
SCEN100 = GNN100_20 + ("fused_chunk=10", SCEN100_SCHEDULE)
SCEN100_STAGES = ((0, 12), (12, 17), (17, 20))
SCENARIO_EVALS = ("wind", "storm")
IDENTITY_STEPS = 50


def scenario_roll(model, params, sp, m=1024):
    """``model`` acting on M formations for ``IDENTITY_STEPS`` steps on the
    card, through the clean step (``sp`` None) or the scenario step: each
    step's (agents, goal, obstacles, steps, obs, reward, done), with the
    k-NN launches checked (one a step and one at the reset)."""
    import torch

    from marl_distributedformation_tpu_torch.envs import spec_for_params
    from marl_distributedformation_tpu_torch.eval import policy_act_fn
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.scenarios import (
        ScenarioStreams,
        broadcast_params,
        init_scenario_state,
        scenario_step_batch,
    )

    dev = torch.device("cuda")
    env = spec_for_params(params)
    act = policy_act_fn(model, params)
    gen = torch.Generator(device=dev).manual_seed(11)
    streams = ScenarioStreams(torch.Generator(device=dev).manual_seed(12))
    knn_cuda.reset_launches()
    state = env.reset_batch(params, m, gen, dev)
    obs = env.obs(state, params)
    if sp is not None:
        state = init_scenario_state(state, params, streams)
        sp = broadcast_params(sp.to(dev), m)
    out = []
    with torch.no_grad():
        for _ in range(IDENTITY_STEPS):
            vel = act(state.agents, state.goal, state.obstacles, obs, None)
            if sp is None:
                state, tr = env.step_batch(state, vel, params, gen)
            else:
                state, tr = scenario_step_batch(state, vel, sp, params, gen,
                                                streams)
            obs = tr.obs
            out.append((state.agents, state.goal, state.obstacles,
                        state.steps, tr.obs, tr.reward, tr.done))
    torch.cuda.synchronize()
    launches = dict(knn_cuda.LAUNCHES)
    if launches != {"knn_fused": IDENTITY_STEPS + 1, "knn_tiled": 0}:
        raise AssertionError(f"identity run launches {launches}")
    return out


def rolls_equal(a, b):
    import torch

    return all(torch.equal(x, y) for sa, sb in zip(a, b)
               for x, y in zip(sa, sb))


def scenario_identity(model):
    """Severity 0 on the card: phase 5's policy acting on M=1024 formations
    of N=100 through the knn step (``knn_fused``) for 50 steps, through a
    reset (max_steps 40); every registered scenario at severity 0 equals
    the clean run bitwise, and at severity 1 every one but ``clean``
    differs; the obstacle scenarios with 4 obstacles, and bitwise clean
    without."""
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.scenarios import (
        registered_scenarios,
        scenario_params_for,
    )

    m = 1024
    t0 = time.perf_counter()
    names = [n for n in registered_scenarios() if not n.startswith("adv:")]
    checked = []
    for obstacles in (0, 4):
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4,
                           max_steps=40, num_obstacles=obstacles)
        clean = scenario_roll(model, params, None, m)
        if int(sum(int(s[6].sum()) for s in clean)) != m:
            raise AssertionError("identity run: every formation must reset")
        for name in names:
            if obstacles and name not in ("clean", "obstacle_field",
                                          "moving_obstacles"):
                continue
            if not rolls_equal(clean, scenario_roll(
                    model, params, scenario_params_for(name, 0.0), m)):
                raise AssertionError(f"{name} at severity 0 differs from the "
                                     f"clean run ({obstacles} obstacles)")
            if name == "clean":
                continue
            obstacle_layer = name in ("obstacle_field", "moving_obstacles")
            same = rolls_equal(clean, scenario_roll(
                model, params, scenario_params_for(name, 1.0), m))
            if same != (obstacle_layer and not obstacles):
                raise AssertionError(f"{name} at severity 1 with {obstacles} "
                                     f"obstacles: equal to clean is {same}")
            checked.append(f"{name}{'+obs' if obstacles else ''}")
        del clean
    print(f"[scenario] severity 0 == clean bitwise (states, obs, rewards) "
          f"for {len(names)} scenarios at N=100 M={m}, {IDENTITY_STEPS} "
          f"steps through a reset, knn_fused {IDENTITY_STEPS + 1} launches a "
          f"run; the obstacle scenarios also with 4 obstacles; severity 1 "
          f"differs for {', '.join(checked)}; the obstacle scenarios "
          f"without obstacles equal clean at severity 1 "
          f"({time.perf_counter() - t0:.1f} s)")


def scen100_run(gnn100):
    """``scen100``: the schedule's severities every iteration, 3 graphs
    across both stage changes, iteration 1 equal to ``gnn100``'s, the
    learning gate over the clean stage, launches by replay and s/iteration
    per stage; returns the trainer and its launches."""
    import numpy as np

    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )

    graphs = []

    def track(trainer):
        run = trainer._iteration.run

        def counted(*args, **kwargs):
            graphs.append((trainer.graph_count(),
                           [id(p.graph) for p in trainer._phases]))
            run(*args, **kwargs)

        trainer._iteration.run = counted

    trainer, rewards, got, s_iter = train_run(
        "smoke_scen100", SCEN100, "scen100 M=1024 N=100 fused_chunk=10",
        before_train=track)
    del trainer._iteration.run
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != SCEN100_ITERS or got != {"knn_fused": want,
                                                "knn_tiled": 0}:
        raise AssertionError(f"scen100: {len(rewards)} iterations, launches "
                             f"{got}, want {SCEN100_ITERS} and fused {want}")
    schedule = schedule_from_cfg(SCEN100_SCHEDULE.split("=", 1)[1],
                                 default_severity=0.5)
    severities = [r["scenario_severity"] for r in trainer.smoke_records]
    expect = [float(np.float32(schedule.severity_at(i)))
              for i in range(SCEN100_ITERS)]
    if severities != expect:
        raise AssertionError(f"scen100 severities {severities} != the "
                             f"schedule's {expect}")
    final = (trainer.graph_count(), [id(p.graph) for p in trainer._phases])
    at = {i: graphs[i][0] for i in (11, 12, 16, 17)}
    if not (set(at.values()) == {3} and final[0] == 3
            and graphs[2][1] == final[1]):
        raise AssertionError(f"scen100 graphs before/after iterations 12 "
                             f"and 17: {at}, at the end {final[0]}; the same "
                             f"graph objects: {graphs[2][1] == final[1]}")
    print(f"[graphs] scen100: captured graphs before and after the stage "
          f"changes (iterations 12, 13, 17, 18): {list(at.values())}; at the "
          f"end {final[0]}, the same graph objects as at iteration 3")
    if rewards[0] != gnn100["rewards"][0]:
        raise AssertionError(f"scen100 iteration 1 {rewards[0]!r} != "
                             f"gnn100's {gnn100['rewards'][0]!r}")
    first3, late = mean(rewards[:3]), mean(rewards[9:12])
    print(f"[learn] scen100 reward by iteration: " + ", ".join(
        f"{i + 1}: {r:.3f}" for i, r in enumerate(rewards))
        + f"; iteration 1 {rewards[0]!r} == gnn100's; first 3 {first3:.3f},"
        f" iterations 10-12 {late:.3f}")
    if not late >= first3 + LEARN_MARGIN:
        raise AssertionError(f"scen100: iterations 10-12 mean {late:.3f} do "
                             f"not beat the first 3 {first3:.3f} by "
                             f"{LEARN_MARGIN}")
    steady = trainer.smoke_phase_ms
    per_stage = []
    for a, b in SCEN100_STAGES:
        rows = [sum(p) / 1e3 for p in steady[max(a, 2):b]]
        per_stage.append(mean(rows))
    print(f"[scen100] s/iteration by stage (clean; wind/sensor/fault 0.5; "
          f"storm 0.5-1.0), warm-up and capture iterations left out: "
          + ", ".join(f"{x:.4f}" for x in per_stage)
          + f"; whole run {s_iter:.4f}; gnn100's {gnn100['s_iter']:.4f} "
          f"(ratio {s_iter / gnn100['s_iter']:.3f})")
    # Depth cut for phase 17's room, as pop4's: the rollout and the first
    # epoch of a captured iteration under storm.
    steps = trainer._iteration.num_minibatch_steps // trainer.ppo.n_epochs
    profile_window(epoch_window(trainer), f"train scen100 M=1024 N=100 "
                   f"under storm, the rollout and the first epoch ({steps} "
                   "minibatch replays) of a captured iteration", 1, "window")
    return trainer, got["knn_fused"]


SCENARIO_EVAL_M = 1024


def scenario_evals(scen100, gnn100):
    """The evaluate CLI on ``scen100``'s checkpoint under wind and storm at
    0.5 (M=1024, full episodes; cut from 4096 to make room for phase 11):
    learned > zero; ``gnn100``'s policy row beside it; eval
    formation-steps/s under storm against clean (M=4096)."""
    import torch

    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        episode_length,
        evaluate,
        evaluate_checkpoint,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    ckpt = latest_checkpoint(scen100.log_dir)
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    for name in SCENARIO_EVALS:
        res = evaluate_cli.main([
            f"checkpoint={ckpt}", "obs_mode=knn", "policy=gnn",
            "num_agents_per_formation=100",
            f"eval_formations={SCENARIO_EVAL_M}",
            f"scenario={name}", "scenario_severity=0.5", "device=cuda",
        ])
        ret = {r: res[f"{r}_episode_return_per_agent"]
               for r in ("policy", "baseline", "zero")}
        if not ret["policy"] > ret["zero"]:
            raise AssertionError(f"scen100 under {name}: learned "
                                 f"{ret['policy']} does not beat zero "
                                 f"{ret['zero']}")
        plain = evaluate_checkpoint(
            str(gnn100["ckpt"]), params, SCENARIO_EVAL_M, 1234, True, "cuda",
            scenario_params=scenario_params_for(name, 0.5),
        )["episode_return_per_agent"]
        print(f"[scenario-eval] {name} 0.5 (M={SCENARIO_EVAL_M} N=100, full "
              "episodes): "
              f"scen100 learned {ret['policy']:.2f}, baseline "
              f"{ret['baseline']:.2f}, zero {ret['zero']:.2f}; gnn100's "
              f"checkpoint (clean-trained) {plain:.2f} (not gated)")
    # Eval throughput under storm against clean: the learned policy, 302
    # steps each, one run each (two before phase 15 was paid for).
    short = params.replace(max_steps=300)
    act = policy_act_fn(scen100.model, short)
    storm = scenario_params_for("storm", 0.5)
    rates = {"clean": [], "storm": []}
    for which in ("clean", "storm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate(act, short, 4096, seed=1234, device="cuda",
                 scenario_params=storm if which == "storm" else None)
        torch.cuda.synchronize()
        rates[which].append(4096 * episode_length(short)
                            / (time.perf_counter() - t0))
    clean_r, storm_r = mean(rates["clean"]), mean(rates["storm"])
    print(f"[scenario-eval] eval formation-steps/s at M=4096 N=100 "
          f"(302 steps, one run each): clean {clean_r:.1f} "
          f"{[round(x, 1) for x in rates['clean']]}, storm {storm_r:.1f} "
          f"{[round(x, 1) for x in rates['storm']]}; scenario overhead "
          f"{100 * (clean_r / storm_r - 1):.1f}% (time under storm over "
          f"clean, less one)")


def scenario_captured_equals_eager():
    """Ring/MLP, M=64, bitwise: captured == eager over 4 iterations across
    a stage boundary and a severity ramp; ``fused_chunk=2`` == the host
    loop with the stage change inside the second chunk, records included;
    and a run resumed mid-stage == the uninterrupted one."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.scenarios import (
        schedule_from_cfg,
    )
    from marl_distributedformation_tpu_torch.train import (
        TrainConfig,
        Trainer,
    )

    params = EnvParams()
    base = ROOT / "logs" / "smoke_scenario_compare"
    shutil.rmtree(base, ignore_errors=True)
    ppo = PPOConfig(batch_size=800)  # 4 minibatches an epoch
    per_iter = 10 * 64 * 5

    def make(name, schedule, capture=True, **kw):
        cfg = dict(num_formations=64, seed=3, checkpoint=False,
                   total_timesteps=4 * per_iter, log_dir=str(base / name))
        cfg.update(kw)
        return Trainer(params, ppo, TrainConfig(**cfg),
                       model=MLPActorCritic(
                           params.obs_dim,
                           generator=torch.Generator().manual_seed(3)),
                       device="cuda", capture=capture,
                       scenario_schedule=schedule_from_cfg(schedule))

    def carry(trainer):
        out = _carry(trainer)
        it = trainer._iteration
        out.update({f: getattr(it.env, f).clone() for f in it.env_fields})
        out["scenario generator"] = trainer.scenario_generator.get_state()
        out["scenario wind"] = trainer.scenario_params.wind.clone()
        return out

    def compare(a, b, what, skip=()):
        torch.cuda.synchronize()
        x, y = carry(a), carry(b)
        for key in x:
            if key not in skip and not torch.equal(x[key], y[key]):
                raise AssertionError(f"{what}: {key} differs")

    def records(trainer):
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "env_steps_per_sec")}
                for line in (Path(trainer.log_dir) / "metrics.jsonl")
                .read_text().splitlines()]

    ramp = ("[{rollouts: 2, scenarios: [clean]}, {rollouts: 2, scenarios: "
            "[wind, sensor_noise, actuator_fault, comm_dropout], severity: "
            "1.0, severity_start: 0.3}]")
    runs = [make(f"ramp{c}", ramp, capture=c) for c in (True, False)]
    for t in runs:
        t.train()
    compare(*runs, "scenario captured vs eager")
    if runs[0].graph_count() != 3:
        raise AssertionError(f"{runs[0].graph_count()} graphs, want 3")

    inside = ("[{rollouts: 3, scenarios: [storm, comm_dropout, "
              "moving_goal], severity: 1.0, severity_start: 0.2}, "
              "{rollouts: 2, scenarios: [actuator_fault, sensor_noise, "
              "wind], severity: 0.7}]")
    host, fused = make("host", inside), make("fused", inside, fused_chunk=2)
    host.train()
    fused.train()
    compare(host, fused, "scenario fused vs host loop", skip=("metrics",))
    if records(host) != records(fused):
        raise AssertionError("scenario fused vs host loop: records differ")

    kw = dict(checkpoint=True, save_freq=10)
    full = make("full", inside, **kw)
    full.train()
    make("part", inside, total_timesteps=2 * per_iter, **kw).train()
    resumed = make("part", inside, resume=True, **kw)
    resumed.train()
    compare(full, resumed, "scenario resumed mid-stage", skip=("metrics",))
    print("[capture] scenarios ring/MLP M=64, bitwise: captured == eager "
          "over 4 iterations across a stage boundary and a severity ramp "
          "(params, Adam state, step, env carry with the episode draws, "
          "metrics, both generators, the scenario buffers; 3 graphs); "
          "fused_chunk=2 == the host loop with the stage change inside the "
          "second chunk, records included; resumed at rollout 2 of the "
          "3-rollout stage == uninterrupted")


def scenario_phase(gnn100):
    """Phase 8; returns ``scen100``'s ``knn_fused`` launches and its last
    checkpoint (phase 9 judges it)."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    scenario_identity(gnn100["model"])
    elapsed("scenario identity")
    trainer, launches = scen100_run(gnn100)
    elapsed("scen100")
    scenario_evals(trainer, gnn100)
    elapsed("scenario evals")
    scenario_captured_equals_eager()
    return launches, latest_checkpoint(trainer.log_dir)


# Phase 9: the robustness matrix, the falsifier search and pursuit-evasion.
# 3 scenarios (5 before phase 15 was paid for: sensor_noise and
# comm_dropout, which phase 8's severity-0 identity still covers).
# 2 severities (3 before phase 17 was paid for): severity 0 (the bitwise
# identity) and 1.0.
MATRIX_SCENARIOS = ("clean", "wind", "storm")
MATRIX_SEVERITIES = (0.0, 1.0)
MATRIX1024_SCENARIOS = ("clean", "storm")
MATRIX1024_SEVERITIES = (0.0, 1.0)
MATRIX_RTOL = 1e-5  # a captured cell against the eager evaluate_scenario
ADVERSARY = ("scenarios=[wind,storm,actuator_fault,sensor_noise]",
             "search_grid=6", "search_generations=1", "eval_formations=64")
ADVERSARY_M = 64
# gnn100's command on pursuit-evasion, 20 iterations.
CHASE100 = GNN100[:-1] + ("env=pursuit_evasion", "total_timesteps=20480000",
                          "fused_chunk=10")


def yaml_list(items):
    return "[" + ",".join(str(x) for x in items) + "]"


def matrix_run(label, ckpts, n, m, scenarios, severities, kernel):
    """The robustness-matrix CLI in-process (``main(argv)``) on ``ckpts``
    (one architecture) with the launch counts set to 0 just before it:
    one build (``eval_compiles``), ``kernel`` launched episode_length + 1
    times a cell and the other never, every metric finite, and every
    severity-0 cell bitwise its checkpoint's clean cell. Returns the
    report, the launches and the wall seconds."""
    import torch

    from marl_distributedformation_tpu_torch import robustness_matrix
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    report = robustness_matrix.main([
        f"name=smoke_{label}", f"checkpoint={yaml_list(ckpts)}",
        "obs_mode=knn", f"num_agents_per_formation={n}",
        f"scenarios={yaml_list(scenarios)}",
        f"severities={yaml_list(severities)}", f"eval_formations={m}",
        "device=cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    cells = len(ckpts) * len(scenarios) * len(severities)
    T = 1002
    other = "knn_tiled" if kernel == "knn_fused" else "knn_fused"
    if launches != {kernel: cells * (T + 1), other: 0}:
        raise AssertionError(f"{label}: launches {launches}, want {kernel} "
                             f"{cells} x {T + 1}")
    if report["eval_compiles"] != 1:
        raise AssertionError(f"{label}: {report['eval_compiles']} builds")
    for ckpt, per_scenario in report["matrix"].items():
        clean = per_scenario["clean"]["0"]
        for scenario, per_sev in per_scenario.items():
            for sev, metrics in per_sev.items():
                if not all(math.isfinite(v) for v in metrics.values()):
                    raise AssertionError(f"{label}: non-finite {scenario} "
                                         f"{sev}: {metrics}")
            if per_sev["0"] != clean:
                raise AssertionError(f"{label}: {scenario} at severity 0 "
                                     f"!= the clean cell of {ckpt}")
    print(f"[matrix] {label}: {len(ckpts)} checkpoints x {len(scenarios)} "
          f"scenarios x {len(severities)} severities at M={m} N={n}, full "
          f"episodes: {wall:.2f} s through the CLI ({wall / cells:.3f} s a "
          f"cell with loading, warm-up and capture), eval_compiles 1, "
          f"launches {launches} by replay; every severity-0 cell == its "
          f"checkpoint's clean cell bitwise")
    return report, launches, wall


def cell_rate(program, params, name, severity, reps):
    """Seconds a cell and formation-steps/s over ``reps`` cells of
    ``program`` (built already), the host's clock around synchronised
    cells."""
    import torch

    from marl_distributedformation_tpu_torch.scenarios import (
        scenario_params_for,
    )

    sp = scenario_params_for(name, severity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        program.run(params, sp)
    torch.cuda.synchronize()
    s = (time.perf_counter() - t0) / reps
    return s, program.num_formations * 1002 / s


def matrix100(gnn100, scen100_ckpt):
    """``matrix100``: the CLI on ``gnn100``'s and ``scen100``'s checkpoints
    (3 scenarios x 2 severities, M=256); then the wind 1.0 cell against the
    eager ``eval.evaluate_scenario``, and s/cell captured beside eager."""
    import torch

    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import (
        evaluate_scenario,
        policy_act_fn,
    )
    from marl_distributedformation_tpu_torch.scenarios import MatrixProgram

    ckpts = [str(gnn100["ckpt"]), str(scen100_ckpt)]
    report, launches, _ = matrix_run("matrix100", ckpts, 100, 256,
                                     MATRIX_SCENARIOS, MATRIX_SEVERITIES,
                                     "knn_fused")
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    pol = LoadedPolicy.from_checkpoint(ckpts[0], env_params=params,
                                       device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = evaluate_scenario(policy_act_fn(pol.model, params), params,
                              "wind", 1.0, 256, 1234, "cuda")
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    cell = report["matrix"][ckpts[0]]["wind"]["1"]
    err = max(abs(cell[k] - eager[k]) / max(abs(eager[k]), 1e-30)
              for k in eager)
    if err > MATRIX_RTOL:
        raise AssertionError(f"matrix100 wind 1.0 cell {cell} != eager "
                             f"evaluate_scenario {eager} (rel {err})")
    print(f"[matrix] matrix100 wind 1.0, gnn100's checkpoint: captured cell "
          f"== eager evaluate_scenario within rtol {MATRIX_RTOL} (max rel "
          f"err {err:.3g}; bitwise: {cell == eager})")
    storm = {Path(c).parent.name: report["matrix"][c]["storm"]["1"]
             ["episode_return_per_agent"] for c in ckpts}
    print(f"[matrix] storm 1.0 return/agent (M=256 N=100, full episodes): "
          + ", ".join(f"{k} {v:.2f}" for k, v in storm.items()))
    prog = MatrixProgram(pol.model, params, 256, device="cuda")
    prog.evaluate_clean(pol.params)  # the build and the capture
    cs, cr = cell_rate(prog, pol.params, "wind", 1.0, 2)
    er = 256 * 1002 / eager_s
    print(f"[matrix] matrix100 cell (wind 1.0, M=256 N=100, 1002 steps): "
          f"captured {cs:.4f} s a cell, {cr:.1f} formation-steps/s; the "
          f"eager eval.evaluate_scenario {eager_s:.4f} s, {er:.1f} "
          f"formation-steps/s ({eager_s / cs:.2f}x)")
    return launches


def matrix1024(ckpt):
    """``matrix1024``: the CLI on ``gnn1024``'s checkpoint (clean and storm
    at 0 and 1.0, M=32) through ``knn_tiled``."""
    _, launches, _ = matrix_run("matrix1024", [str(ckpt)], 1024, 32,
                                MATRIX1024_SCENARIOS, MATRIX1024_SEVERITIES,
                                "knn_tiled")
    return launches


def adversary100(gnn100, scen100_ckpt):
    """``adversary100``: the falsifier-search CLI on ``gnn100``'s and
    ``scen100``'s checkpoints (4 families, grid 6, 1 generation, M=64:
    P=25, 1600 formations), one build across both; each falsifier and the
    highest safe probe below it re-evaluated through the search's
    ``evaluate_cells``: drop above the tolerance, and at most it. Then one
    generation at the default population (all 10 families, P=61, 3904
    formations), every severity-0 row bitwise the clean row. Returns the
    search's and the P=61 run's launches."""
    import torch

    from marl_distributedformation_tpu_torch import adversarial_search
    from marl_distributedformation_tpu_torch.compat.policy import (
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.scenarios import (
        AdversaryConfig,
        AdversarySearch,
        get_scenario,
        make_population_runner,
    )
    from marl_distributedformation_tpu_torch.scenarios.adversary import (
        _relative_drop,
        _stack_rows,
    )

    ckpts = [str(gnn100["ckpt"]), str(scen100_ckpt)]
    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    # The CLI's work (``main`` is ``run(argv)[0]``), keeping its search for
    # the brackets and the re-evaluation.
    report, search = adversarial_search.run([
        "name=smoke_adversary100", f"checkpoint={yaml_list(ckpts)}",
        "obs_mode=knn", "num_agents_per_formation=100", *ADVERSARY,
        "device=cuda",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    generations = sum(r["generations"] for r in report["searches"].values())
    if launches != {"knn_fused": generations * 1003, "knn_tiled": 0}:
        raise AssertionError(f"adversary100 launches {launches}, want "
                             f"{generations} x 1003")
    if report["eval_compiles"] != 1:
        raise AssertionError(f"adversary100: {report['eval_compiles']} "
                             "builds across both checkpoints")
    tol = report["drop_tolerance"]
    for ckpt, rep in report["searches"].items():
        params = LoadedPolicy.from_checkpoint(
            ckpt, env_params=search.env_params, device="cuda").params
        clean = rep["clean"]
        # Each falsifier beside the highest safe probe below it (the
        # bracket's floor; 0 when no probe below it was safe).
        brackets = []
        for f in rep["falsifiers"]:
            lo, hi = search.brackets[ckpt][f["scenario"]]
            if round(hi, 6) != f["severity"]:  # the record's rounding
                raise AssertionError(f"adversary100 {f['scenario']}: "
                                     f"bracket {lo, hi}, falsifier {f}")
            brackets.append((f, hi, lo))
        # One run of the search's program re-evaluates them all.
        again = search.evaluate_cells(params, [("clean", 0.0)] + [
            cell for f, hi, lo in brackets
            for cell in ((f["scenario"], hi), (f["scenario"], lo))])
        for i, (f, _, safe) in enumerate(brackets):
            drops = [_relative_drop(v, again[0])
                     for v in again[1 + 2 * i:3 + 2 * i]]
            if not (f["drop"] > tol and drops[0] > tol and drops[1] <= tol):
                raise AssertionError(
                    f"adversary100 {Path(ckpt).parent.name} {f['scenario']}:"
                    f" falsifier {f['severity']} drop {f['drop']} (again "
                    f"{drops[0]}), safe probe {safe} drop {drops[1]}, "
                    f"tolerance {tol}")
            print(f"[adversary] {Path(ckpt).parent.name} {f['scenario']}: "
                  f"falsified at {f['severity']} (drop {drops[0]:.4f} > "
                  f"{tol}), safe at {safe:.6g} (drop {drops[1]:.4f}), "
                  "re-evaluated through evaluate_cells")
        print(f"[adversary] {Path(ckpt).parent.name}: clean {clean:.2f}, "
              f"falsifiers {[(f['scenario'], f['severity']) for f in rep['falsifiers']]}"
              f", robust {rep['robust']}, {rep['generations']} generations "
              f"in {rep['search_seconds']:.2f} s")
    if search.compile_count != 1:
        raise AssertionError("adversary100: the re-evaluation rebuilt")
    print(f"[adversary] adversary100: P={report['searches'][ckpts[0]]['population']}"
          f" x M={ADVERSARY_M} = (1600,100,4) a generation, {generations} "
          f"generations over 2 checkpoints, eval_compiles 1, "
          f"{report['candidates_per_sec']:.1f} candidates/s (search time), "
          f"{wall:.2f} s through the CLI; launches {launches} by replay")

    # One generation at the default population: P = 1 + 10 x 6 = 61.
    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    pol = LoadedPolicy.from_checkpoint(ckpts[0], env_params=params,
                                       device="cuda")
    families = AdversarySearch(pol.model, params, AdversaryConfig(),
                               device="cuda").specs
    rows = [(get_scenario("clean"), 0.0)] + [
        (spec, 0.0) for spec in families for _ in range(6)]
    run, guard = make_population_runner(pol.model, params, ADVERSARY_M,
                                        device="cuda")
    torch.cuda.synchronize()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    out = run(pol.params, _stack_rows(rows))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    p61 = dict(knn_cuda.LAUNCHES)
    if p61 != {"knn_fused": 1003, "knn_tiled": 0} or guard.count != 1:
        raise AssertionError(f"P=61 launches {p61}, builds {guard.count}")
    for key, values in out.items():
        bad = [i for i in range(1, len(rows))
               if not torch.equal(values[i], values[0])]
        if bad:
            raise AssertionError(
                f"P=61: the {key} of severity-0 rows {bad} (of "
                f"{[rows[i][0].name for i in bad]}) differs from the clean "
                f"row's {values[0].item()!r}: {values[bad].tolist()}")
    print(f"[adversary] P=61 x M={ADVERSARY_M} = ({61 * ADVERSARY_M},100,4), "
          f"all 10 families at severity 0: every row == the clean row "
          f"bitwise (6 metrics); knn_fused 1003 launches by replay; one "
          f"generation with its build and capture {s:.3f} s, "
          f"{61 / s:.1f} candidates/s, "
          f"{61 * ADVERSARY_M * 1002 / s:.1f} formation-steps/s")
    return launches, p61


def pursuit_identity(model):
    """Pursuit at N=100, M=1024, 50 steps through a reset (max_steps 40),
    ``knn_fused``: every scenario at severity 0 equals clean pursuit
    bitwise; ``moving_goal`` at 0.5 (the pursuer drifts) differs."""
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.scenarios import (
        registered_scenarios,
        scenario_params_for,
    )

    params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4,
                           max_steps=40)
    clean = scenario_roll(model, params, None)
    names = [n for n in registered_scenarios() if not n.startswith("adv:")]
    for name in names:
        if not rolls_equal(clean, scenario_roll(
                model, params, scenario_params_for(name, 0.0))):
            raise AssertionError(f"pursuit: {name} at severity 0 differs "
                                 "from clean")
    if rolls_equal(clean, scenario_roll(
            model, params, scenario_params_for("moving_goal", 0.5))):
        raise AssertionError("pursuit: moving_goal at 0.5 equals clean")
    print(f"[chase] pursuit severity 0 == clean bitwise for {len(names)} "
          f"scenarios (N=100 M=1024, {IDENTITY_STEPS} steps through a "
          "reset, knn_fused); moving_goal at 0.5 differs")


def chase100(gnn100):
    """``chase100``: ``gnn100``'s command on pursuit-evasion, 20 captured
    iterations through ``knn_fused``, against a control run of the same
    command with ``learning_rate=0`` (the seeded policy, never updated):
    finite records; the same first iteration; the last 3 iterations' mean
    reward above the control's over the same episode steps; at M=1024 over
    full episodes, the learned policy with its noise above the seeded
    policy with its noise and above zero (its mean action printed, not
    gated); the severity-0 identity on pursuit. Returns its launches."""
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.envs import PursuitParams
    from marl_distributedformation_tpu_torch.eval import evaluate_checkpoint
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    seeded = {}

    def keep_seeded(trainer):
        # The seeded policy, before its first update.
        seeded["ckpt"] = trainer.save()

    trainer, rewards, got, s_iter = train_run(
        "smoke_chase100", CHASE100,
        "chase100 pursuit-evasion M=1024 N=100 fused_chunk=10",
        before_train=keep_seeded)
    want = 1 + len(rewards) * trainer.ppo.n_steps
    if len(rewards) != 20 or got != {"knn_fused": want, "knn_tiled": 0}:
        raise AssertionError(f"chase100: {len(rewards)} iterations, "
                             f"launches {got}, want 20 and fused {want}")
    print(f"[chase] chase100 {s_iter:.4f} s/iteration against gnn100's "
          f"{gnn100['s_iter']:.4f} (ratio {s_iter / gnn100['s_iter']:.3f})")
    # Every formation starts its episode at once and the 20 iterations
    # cover its steps 0-199, so an iteration's reward follows the pursuer
    # closing in as much as the policy: the control run sees the same
    # steps from the same states and streams, without the updates.
    _, control, _, _ = train_run(
        "smoke_chase100_control", CHASE100 + ("learning_rate=0.0",),
        "chase100 control, learning_rate=0")
    for label, r in (("chase100", rewards), ("control", control)):
        print(f"[learn] {label} reward by iteration: " + ", ".join(
            f"{i + 1}: {v:.3f}" for i, v in enumerate(r))
            + f"; first 3 {mean(r[:3]):.3f}, last 3 {mean(r[-3:]):.3f}")
    if not math.isclose(rewards[0], control[0], rel_tol=1e-5):
        raise AssertionError(f"chase100: iteration 1 {rewards[0]} and the "
                             f"control's {control[0]} differ")
    last3, control3 = mean(rewards[-3:]), mean(control[-3:])
    if not last3 > control3:
        raise AssertionError(f"chase100: last-3 mean {last3:.3f} does not "
                             f"beat the control's {control3:.3f}")
    print(f"[learn] chase100: last 3 iterations {last3:.3f} > the "
          f"learning_rate=0 control's {control3:.3f} over the same steps")
    # The policy as it trained, with its noise, over full episodes; the
    # seeded policy under the same noise streams.
    ckpt = latest_checkpoint(trainer.log_dir)
    res = evaluate_cli.main([
        f"checkpoint={ckpt}", "env=pursuit_evasion", "obs_mode=knn",
        "policy=gnn", "num_agents_per_formation=100",
        "eval_formations=1024", "eval_deterministic=false", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4)
    # The CLI's call (its eval_seed 1234) with the seeded policy.
    ret["seeded"] = evaluate_checkpoint(
        seeded["ckpt"], params, 1024, 1234, False,
        "cuda")["episode_return_per_agent"]
    if not ret["policy"] > max(ret["seeded"], ret["zero"]):
        raise AssertionError(f"chase100: learned {ret['policy']} does not "
                             f"beat the seeded policy {ret['seeded']} and "
                             f"zero {ret['zero']}")
    mean_action = evaluate_checkpoint(
        str(ckpt), params, 1024, 1234, True,
        "cuda")["episode_return_per_agent"]
    print(f"[chase] chase100 eval (M=1024 N=100, full episodes, with the "
          f"policy's noise): learned {ret['policy']:.2f} > seeded "
          f"{ret['seeded']:.2f}, > zero {ret['zero']:.2f}; baseline (steers "
          f"at the pursuer) {ret['baseline']:.2f}; the learned mean action "
          f"{mean_action:.2f} (not gated)")
    pursuit_identity(trainer.model)
    return got["knn_fused"]


def robustness_phase(gnn100, scen100_ckpt):
    """Phase 9; returns each path's launches."""
    launches = {"matrix100": matrix100(gnn100, scen100_ckpt)}
    elapsed("matrix100")
    launches["matrix1024"] = matrix1024(gnn100["ckpt1024"])
    elapsed("matrix1024")
    launches["adversary100"], launches["population61"] = adversary100(
        gnn100, scen100_ckpt)
    elapsed("adversary100")
    launches["chase100"] = chase100(gnn100)
    return launches


# Phase 10: serving. The ladder, the smoke's sizes and clients, and the p95
# target of the JAX package's serving bench (bench.py:1538).
SERVE_BUCKETS = (1, 8, 64, 512)
SERVE_P95_MS = 50.0
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6  # served against LoadedPolicy.predict


def bf16_action_atol(num_layers: int) -> float:
    """``tests/bf16_budget.py``'s action budget of a depth-``num_layers``
    tanh-MLP served in bf16: two casts a layer and the obs cast, each half
    an ulp of bf16."""
    return (2 * num_layers + 1) * 2.0 ** -9


def serve_rows(m=1024):
    """Real k-NN request rows for the 100-agent GNN: the port's env at
    N=100, k=4, reset and stepped once with random actions, the
    observations built by ``compute_obs_knn`` through ``knn_fused``.
    Returns ``(rows (2m, 100, 20) numpy, knn_fused launches)``."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    gen = torch.Generator(device="cuda").manual_seed(11)
    knn_cuda.reset_launches()
    reset_fn, step_fn = make_vec_env(params, m, device="cuda", generator=gen)
    state, obs = reset_fn()
    act = torch.rand((m, 100, 2), generator=gen, device="cuda") * 2 - 1
    _, tr = step_fn(state, act)
    rows = torch.cat([obs, tr.obs]).cpu().numpy()
    launches = knn_cuda.LAUNCHES["knn_fused"]
    if launches != 2 or not np.isfinite(rows).all():
        raise AssertionError(f"serve rows: {launches} knn_fused launches, "
                             "want 2, and finite observations")
    return rows, launches


def ring_rows(m=1024):
    """Flat request rows for the committed MLP: ring observations of the
    port's env at N=5, one row an agent."""
    import torch

    from marl_distributedformation_tpu_torch.env import EnvParams, make_vec_env

    gen = torch.Generator(device="cuda").manual_seed(12)
    reset_fn, _ = make_vec_env(EnvParams(), m, device="cuda", generator=gen)
    _, obs = reset_fn()
    return obs.reshape(-1, obs.shape[-1]).cpu().numpy()


def act_ms(engine, rows, reps):
    """CUDA events on the engine's stream around ``engine.act``: staging,
    the copy in, the rung, the copy out and the host's wait."""
    import torch

    with torch.cuda.stream(engine._stream):
        engine.act(rows)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            engine.act(rows)
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(graph, stream, reps):
    """CUDA events around back-to-back replays of one captured rung."""
    import torch

    with torch.cuda.stream(stream):
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def serve_ladder(label, policy, rows, layers):
    """The captured ladder against the eager one, rung by rung: bitwise,
    served == ``LoadedPolicy.predict`` within tolerance, two stochastic
    dispatches differ, bf16 against f32; then each rung's replay, act and
    eager act times. Returns the captured engine."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )

    engine = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS)
    eager = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS, capture=False)
    bf16 = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS,
                                dtype="bfloat16")
    worst = bf16_worst = 0.0
    for b in SERVE_BUCKETS:
        x = rows[:b]
        got, want = engine.act(x), eager.act(x)
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: captured rung {b} differs from "
                                 f"eager by {np.abs(got - want).max()}")
        ref, _ = policy.predict(x)
        np.testing.assert_allclose(got, ref, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg=f"{label} rung {b} vs predict")
        worst = max(worst, float(np.abs(got - ref).max()))
        bf16_worst = max(bf16_worst, float(np.abs(bf16.act(x) - got).max()))
    big = rows[: 2 * SERVE_BUCKETS[-1] + 70]  # two top chunks and a 64-rung
    np.testing.assert_allclose(engine.act(big), policy.predict(big)[0],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)
    a1 = engine.act(rows[:64], deterministic=False)
    a2 = engine.act(rows[:64], deterministic=False)
    if np.array_equal(a1, a2):
        raise AssertionError(f"{label}: two stochastic dispatches are equal")
    counts = engine.compile_counts()
    if counts != dict.fromkeys(SERVE_BUCKETS, 1):
        raise AssertionError(f"{label}: captures {counts}, want 1 a rung")
    print(f"[serve] {label}: captured == eager bitwise at rungs "
          f"{SERVE_BUCKETS}; served == predict within rtol {SERVE_RTOL} atol "
          f"{SERVE_ATOL} (max abs diff {worst:.3g}) and on {len(big)} rows "
          f"(3 chunks); stochastic dispatches differ; captures {counts}")
    if layers is not None:
        atol = bf16_action_atol(layers)
        if not bf16_worst <= atol:
            raise AssertionError(f"{label}: bf16 ladder off f32 by "
                                 f"{bf16_worst}, budget {atol}")
        print(f"[serve] {label} bf16 ladder vs f32: max abs {bf16_worst:.3g} "
              f"within the budget {atol:.4g} ({layers} layers)")
    else:
        print(f"[serve] {label} bf16 ladder vs f32: max abs {bf16_worst:.3g} "
              "(a measurement, not gated: the budget is derived for a "
              "seeded-init tanh-MLP)")
    for b in SERVE_BUCKETS:
        reps = 200 if b < 512 else 50
        rung = engine.rung(b)
        t_replay = replay_ms(rung.graph.graph, engine._stream, reps)
        t_act = act_ms(engine, rows[:b], reps)
        t_eager = act_ms(eager, rows[:b], max(10, reps // 4))
        mb = rows[:b].nbytes / 1e6
        print(f"[serve] {label} rung {b}: replay {t_replay:.4f} ms (device, "
              f"events over back-to-back replays, {rung.graph.nodes} graph "
              f"nodes), act {t_act:.4f} ms (staging, {mb:.3f} MB in, replay, "
              f"out; events on the engine's stream), eager act "
              f"{t_eager:.4f} ms ({t_eager / t_act:.2f}x)")
    top = engine.rung(SERVE_BUCKETS[-1])
    stage = engine._stage_in[: SERVE_BUCKETS[-1]]
    with torch.cuda.stream(engine._stream):
        h2d = time_ms(lambda: top.x.copy_(stage, non_blocking=True), 50)
    print(f"[serve] {label} rung {SERVE_BUCKETS[-1]}: the copy in of "
          f"{stage.numel() * 4 / 1e6:.3f} MB from pinned memory "
          f"{h2d:.4f} ms ({stage.numel() * 4 / h2d / 1e6:.1f} GB/s)")
    return engine


def serve_stream(engine, registry, rows, serve_dir, scen100_ckpt, p100):
    """A mixed stream over every rung from 4 client threads with a hot swap
    from ``gnn100`` to ``scen100`` in its middle: no request dropped, one
    capture a rung, ``model_step`` never decreasing in completion order,
    the rung graphs the same objects, and actions after the swap equal to
    ``scen100``'s policy's."""
    import shutil
    import threading

    import numpy as np

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.serving import (
        MicroBatchScheduler,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    graphs = {b: id(engine.rung(b).graph.graph) for b in SERVE_BUCKETS}
    done, lock = [], threading.Lock()
    sizes = (1, 3, 8, 9, 40, 64, 100, 512, 600)
    futures = []
    step0 = registry.active_step

    def client(i):
        for j in range(12):
            n = sizes[(i + j) % len(sizes)]
            start = (i * 97 + j * 31) % (len(rows) - n)
            fut = sched.submit(rows[start:start + n], timeout_s=60.0)
            fut.add_done_callback(record)
            with lock:
                futures.append(fut)
            fut.result(timeout=120)

    def record(fut):
        # Completion order: the worker resolves futures one by one.
        with lock:
            done.append(None if fut.exception() is not None
                        else fut.result().model_step)

    with MicroBatchScheduler(engine, registry=registry, window_ms=2.0,
                             max_queue=1024) as sched:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.perf_counter() + 120.0
        while len(done) < 20 and time.perf_counter() < deadline:
            time.sleep(0.005)
        swap_step = checkpoint_step(scen100_ckpt) + step0 + 1
        shutil.copy(scen100_ckpt,
                    serve_dir / f"rl_model_{swap_step}_steps.msgpack")
        if not registry.refresh():
            raise AssertionError(f"serve: no swap to scen100: "
                                 f"{list(registry.load_errors)}")
        for t in threads:
            t.join(timeout=300)
        after = sched.submit(rows[:600]).result(timeout=120)
    if any(t.is_alive() for t in threads) or None in done:
        raise AssertionError("serve: a client stalled or a request failed")
    if len(done) != len(futures) or len(done) != 48:
        raise AssertionError(f"serve: {len(done)} of {len(futures)} "
                             "requests answered, want 48")
    if done != sorted(done) or done[0] != step0 or done[-1] != swap_step:
        raise AssertionError(f"serve: model_step out of order: {done}")
    counts = engine.compile_counts()
    if counts != dict.fromkeys(SERVE_BUCKETS, 1) or graphs != {
            b: id(engine.rung(b).graph.graph) for b in SERVE_BUCKETS}:
        raise AssertionError(f"serve: captures {counts} after the swap")
    scen = LoadedPolicy.from_checkpoint(scen100_ckpt, env_params=p100,
                                        device="cuda")
    np.testing.assert_allclose(after.actions, scen.predict(rows[:600])[0],
                               rtol=SERVE_RTOL, atol=SERVE_ATOL)
    if after.model_step != swap_step:
        raise AssertionError(f"serve: step {after.model_step} after swap")
    print(f"[serve] gnn100 mixed stream (4 clients, sizes {sizes}, 48 "
          f"requests) with a hot swap to scen100 at step {swap_step}: all "
          f"answered, model_step monotonic ({done.count(step0)} at "
          f"{step0}, {done.count(swap_step)} at {swap_step}), captures "
          f"{counts} (the same graphs), actions after the swap == scen100's "
          f"predict within rtol {SERVE_RTOL}")


def serving_phase(gnn100_ckpt, scen100_ckpt, duration_s=3.0):
    """Phase 10: the ``gnn100`` checkpoint served at (100, 20) rows on real
    k-NN observations (``serve_ladder``, ``serve_stream``), the committed
    MLP checkpoint beside it, then ``run_smoke_benchmark`` on the
    ``gnn100`` scheduler (default sizes, 4 clients), its device busy share,
    and ``max_rate_at_slo`` at a 50 ms p95. Returns ``knn_fused``'s launches
    building the request rows and the smoke's report."""
    import shutil

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.serving import (
        MicroBatchScheduler,
        ModelRegistry,
        max_rate_at_slo,
        run_smoke_benchmark,
    )

    import torch

    from marl_distributedformation_tpu_torch.models import MLPActorCritic

    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    rows, launches = serve_rows()
    mlp = LoadedPolicy.from_checkpoint(CKPT, device="cuda")
    flat = ring_rows()
    serve_ladder("mlp (committed checkpoint)", mlp, flat, layers=None)
    # The bf16 budget is derived for a seeded-init tanh-MLP (its fact 4);
    # the trained checkpoint's weights amplify more (the JAX engine's own
    # bf16 ladder is off its f32 one by more than the budget there too:
    # tests/test_torch_serving.py).
    seeded = LoadedPolicy(MLPActorCritic(
        flat.shape[1], generator=torch.Generator().manual_seed(0)).to("cuda"))
    serve_ladder("mlp (seeded init, 64x64)", seeded, flat,
                 layers=seeded.model.depth + 1)
    elapsed("serve mlp")

    serve_dir = ROOT / "logs" / "smoke_serve100"
    shutil.rmtree(serve_dir, ignore_errors=True)
    serve_dir.mkdir(parents=True)
    shutil.copy(gnn100_ckpt, serve_dir / Path(gnn100_ckpt).name)
    registry = ModelRegistry(serve_dir, env_params=p100, device="cuda")
    engine = serve_ladder("gnn100", registry.policy, rows, layers=None)
    elapsed("serve gnn100 ladder")
    serve_stream(engine, registry, rows, serve_dir, scen100_ckpt, p100)
    elapsed("serve gnn100 stream and swap")

    with MicroBatchScheduler(engine, registry=registry) as sched:
        r = run_smoke_benchmark(sched, row_shape=rows.shape[1:],
                                duration_s=duration_s, num_clients=4,
                                registry=registry)
        if r["client_requests_ok"] == 0 or r["timeouts_total"]:
            raise AssertionError(f"serve smoke: {r}")
        print(f"[serve] smoke gnn100 (sizes 1,3,8,9,40,100 formations of "
              f"100 agents, 4 clients, {r['duration_s']} s): "
              f"{r['requests_per_sec']:.1f} requests/s, "
              f"{r['rows_per_sec']:.1f} rows/s, "
              f"{r['rows_per_sec'] * 100:.1f} agent-rows/s; p50 "
              f"{r['latency_p50_ms']:.3f} ms, p95 {r['latency_p95_ms']:.3f}"
              f" ms, p99 {r['latency_p99_ms']:.3f} ms; occupancy "
              f"{r['batch_occupancy_pct']:.1f}%, "
              f"{r['mean_rows_per_batch']:.1f} rows a batch, "
              f"{r['batches']:.0f} batches; rejected "
              f"{r['client_rejected']:.0f}")
        seen = {}

        def smoke():
            seen.update(run_smoke_benchmark(
                sched, row_shape=rows.shape[1:], duration_s=1.5,
                num_clients=4, seed=1))

        profile_window(smoke, "serve gnn100 smoke, 1.5 s profiled "
                       "(the profiler slows the host)", 1, "window")
        print(f"[serve] the profiled smoke: "
              f"{seen['requests_per_sec']:.1f} requests/s, p95 "
              f"{seen['latency_p95_ms']:.3f} ms")
        elapsed("serve smoke")
        best, reports = max_rate_at_slo(
            sched, rows.shape[1:], SERVE_P95_MS, probe_duration_s=1.0,
            iterations=4, seed=3)
        last = reports[-1]
        print(f"[serve] max_rate_at_slo gnn100 (p95 <= {SERVE_P95_MS} ms, "
              f"loss <= 1%, loadgen's default size mix 1/4/16/64/256 "
              f"formations): {best:.1f} requests/s over {len(reports)} "
              f"probes; last probe {last.offered_rps:.1f} offered, p95 "
              f"{last.p95_ms:.3f} ms, loss {last.loss_fraction:.3f}")
    if engine.compile_counts() != dict.fromkeys(SERVE_BUCKETS, 1):
        raise AssertionError(f"serve: captures {engine.compile_counts()}")
    return launches, r


# Phase 11: Sebulba on one card, C4 and the observability plane.
# 60 iterations, not gnn100's 30: with K=10 the actor acts with one
# parameter version a chunk (the learner publishes once a chunk, as the
# JAX package's does), so 30 iterations give the actor three versions,
# too few for gnn100's learning gate; the sixth clears it.
SEBULBA100 = GNN100[:-1] + ("total_timesteps=61440000",
                            "architecture=sebulba", "fused_chunk=10")
# The witness for that reading, and the busy share: gnn100's command, 30
# iterations, with K=1, so that the learner publishes after every update
# and the actor acts at most a few updates behind. It must clear gnn100's
# learning gate at gnn100's 30 iterations; a fault in the pipelined
# handoff (a wrong slot or parameter version) would not go away with K.
# Two of its learner iterations are profiled, the actor's rollout between
# them running beside the second (a K=10 chunk would trace 1.5 M kernels).
SEBULBA100_K1 = GNN100 + ("architecture=sebulba", "profile=true",
                          "profile_iterations=2")
# gnn1024's command, its 12 iterations: 10 steady ones give a spread.
SEBULBA1024 = GNN1024 + ("architecture=sebulba",)
# The observability runs: gnn100's command, 8 host-loop iterations (the
# default run's last 6 rotate telemetry and the ledger on and off; 14 and
# 12 before phase 15 was paid for).
OBS100 = GNN100[:-1] + ("total_timesteps=8192000",)
# The profile check: N=100 at M=64 (30 minibatch steps an iteration, not
# 620), 5 iterations, 3 of them traced.
PROFILE64 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=100",
             "num_formation=64", "preset=tpu", "total_timesteps=320000",
             "profile=true", "profile_iterations=3")
# The metric names GET /metrics must hold during a run (the JAX trainer's
# and ledger's).
METRIC_NAMES = ("marl_train_iterations_total", "marl_train_env_steps_per_sec",
                "marl_train_steps_per_sec", "marl_train_compiles",
                "marl_program_dispatches_total",
                "marl_program_dispatch_seconds", "marl_ledger_programs_total")


def cli_run(name, overrides, label, fresh=True, rotate=False):
    """One run of the port's ``train`` CLI as a user runs it (``main``: the
    registry and ledger configured, the census written), the launch counts
    set to 0 just before and read just after, with a fresh registry and
    ledger (``fresh``) so that the census holds this run's programs alone.
    An iteration's CUDA events (``record_phases``) on an Anakin trainer;
    on a Sebulba driver an event after each learner chunk on its stream.
    With ``rotate`` the iterations after the two that build turn the
    registry and the ledger off and on in turn (both off, telemetry off,
    both on), and ``trainer.smoke_modes`` holds each mode's steady
    s/iteration. Returns ``(trainer, records, launches, steady
    s/iteration, wall)``."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.obs import (
        MetricsRegistry,
        ProgramLedger,
        set_ledger,
        set_registry,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.train import SebulbaDriver, cli

    from marl_distributedformation_tpu_torch.obs import (
        get_ledger,
        get_registry,
    )

    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build = cli.build_trainer
    state = {}
    # In turn, ending on both on: main() writes the census only when the
    # ledger is on at the end of the run.
    modes = ("both off", "telemetry off", "both on")

    def instrumented(argv, capture=True):
        trainer = build(argv, capture)
        if isinstance(trainer, SebulbaDriver):
            learn, chunks = trainer._learn, []

            def timed(items):
                chunk = learn(items)
                with torch.cuda.stream(trainer._learner_stream):
                    event = torch.cuda.Event(enable_timing=True)
                    event.record()
                chunks.append((event, len(items), trainer.lanes_built()))
                return chunk

            trainer._learn = timed
            state["chunks"] = chunks
        else:
            state["events"] = record_phases(trainer)
        if rotate:
            hook, started = trainer.phase_hook, []

            def rotating(phase):
                if phase == "rollout":
                    started.append(1)
                    i = len(started) - 1 - WARM_ITERATIONS[True]
                    mode = modes[i % 3] if i >= 0 else "both on"
                    get_registry().enabled = mode == "both on"
                    get_ledger().enabled = mode != "both off"
                hook(phase)

            trainer.phase_hook = rotating
        return trainer

    previous = None
    if fresh:
        previous = (set_registry(MetricsRegistry()),
                    set_ledger(ProgramLedger()))
    cli.build_trainer = instrumented
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = cli.main([f"name={name}", "device=cuda", *overrides])
        torch.cuda.synchronize()
    finally:
        cli.build_trainer = build
        if previous is not None:
            set_registry(previous[0])
            set_ledger(previous[1])
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    trainer.phase_hook = None
    lines = (Path(trainer.log_dir) / "metrics.jsonl").read_text().splitlines()
    records = [json.loads(line) for line in lines]
    for r in records:
        if not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"{label}: non-finite metrics {r}")
    spread = ""
    if "chunks" in state:
        # Steady: from the end of the chunk that finished building both
        # lanes (in lockstep) to the end of the last.
        chunks = state["chunks"]
        built = next(i for i, c in enumerate(chunks) if c[2])
        steady = chunks[built + 1:]
        iters = sum(c[1] for c in steady)
        s_iter = (chunks[built][0].elapsed_time(steady[-1][0]) / 1e3 / iters
                  if steady else float("nan"))
        per_chunk = [a[0].elapsed_time(b[0]) / 1e3 / b[1]
                     for a, b in zip(chunks[built:], steady)]
        trainer.smoke_chunk_s = per_chunk
        if per_chunk:
            spread = (f" (each of {len(per_chunk)} steady chunks: min "
                      f"{min(per_chunk):.4f}, median {median(per_chunk):.4f}"
                      f", max {max(per_chunk):.4f})")
    else:
        iters = [(e[0].elapsed_time(e[1]) + e[1].elapsed_time(e[2])) / 1e3
                 for e in state["events"]]
        steady = iters[WARM_ITERATIONS[True]:] or iters
        s_iter = mean(steady)
        if rotate:
            trainer.smoke_modes = {m: mean(steady[i::3])
                                   for i, m in enumerate(modes)}
    print(f"[train] {label}: {len(records)} records in {wall:.2f} s; steady "
          f"{s_iter:.4f} s/iteration{spread}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
          f"above the {held / 2**30:.2f} GiB held before the run; launches "
          f"{launches}")
    return trainer, records, launches, s_iter, wall


def trace_kernels(path):
    """The kernel (and copy) events of a Chrome trace ``torch.profiler``
    wrote: ``[(name, start us, end us)]``."""
    trace = json.loads(Path(path).read_text())
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in trace["traceEvents"]
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def census_of(trainer):
    from marl_distributedformation_tpu_torch.obs import load_census

    return load_census(Path(trainer.log_dir) / "program_ledger.json")


def check_census(trainer, label, keys):
    """The run's census holds exactly ``keys``, one build each, with the
    capture seconds and graph nodes ``graph_stats()`` reports."""
    census = census_of(trainer)
    programs = {p["key"]: p for p in census["programs"]}
    if set(programs) != set(keys):
        raise AssertionError(f"{label}: census programs {sorted(programs)}, "
                             f"want {sorted(keys)}")
    stats = {g["phase"]: g for g in trainer.graph_stats()}
    for key, phase in keys.items():
        p, g = programs[key], stats[phase]
        if (p["traces"] != 1 or p["graph_nodes"] != g["nodes"]
                or p["compile_seconds"] != g["capture_s"]):
            raise AssertionError(f"{label}: census {key} {p} against "
                                 f"graph_stats {g}")
    print(f"[ledger] {label}: census of {len(programs)} programs, one build "
          "each, capture seconds and nodes as graph_stats(): " + "; ".join(
              f"{k} {p['graph_nodes']} nodes, {p['compile_seconds']:.3f} s "
              f"capture, {p['dispatches_total']:.0f} dispatches, "
              f"{(p['flops'] or 0) / 1e9:.2f} GFLOP in its warm-up"
              for k, p in programs.items()))
    return census


def sebulba_checks(driver, records, launches, kernel, label):
    """Launches by replay (1 at reset, 10 a rollout, dropped and
    unconsumed ones too), consumed batches within the staleness bound and
    never twice, one build a lane."""
    want = 1 + driver.rollouts * driver.ppo.n_steps
    other = "knn_tiled" if kernel == "knn_fused" else "knn_fused"
    if launches != {kernel: want, other: 0}:
        raise AssertionError(f"{label} launches {launches}, want {kernel} "
                             f"{want} ({driver.rollouts} rollouts)")
    seqs = list(driver.transfer_queue.consumed_seqs)
    if any(b <= a for a, b in zip(seqs, seqs[1:])):
        raise AssertionError(f"{label}: a seq consumed twice or out of order "
                             f"{seqs}")
    bound = driver.config.max_param_staleness
    if max(driver.consumed_staleness) > bound:
        raise AssertionError(f"{label}: consumed staleness "
                             f"{max(driver.consumed_staleness)} > {bound}")
    if not driver.actor_guard.count == driver.learner_guard.count == 1:
        raise AssertionError(f"{label}: lane builds actor "
                             f"{driver.actor_guard.count}, learner "
                             f"{driver.learner_guard.count}")
    if len(records) != len(driver.consumed_versions):
        raise AssertionError(f"{label}: {len(records)} records of "
                             f"{len(driver.consumed_versions)} consumed")
    check_census(driver, label, {
        "sebulba_sebulba_actor_rollout": "actor_rollout",
        "sebulba_sebulba_learner_minibatch": "learner_minibatch",
        "sebulba_sebulba_learner_end": "learner_end"})


def sebulba100(gnn100, overrides=SEBULBA100):
    """``gnn100``'s command through Sebulba on the card (``fused_chunk=10``:
    K=10 batches a learner chunk), pipelined; returns its launches."""
    driver, records, launches, s_iter, wall = cli_run(
        "smoke_sebulba100", overrides, "sebulba100 M=1024 N=100 K=10")
    rewards = [r["reward"] for r in records]
    print("[learn] sebulba100 reward by iteration (parameter version "
          "acted with): " + ", ".join(
              f"{i + 1}: {r:.2f} (v{v})" for i, (r, v) in enumerate(
                  zip(rewards, driver.consumed_versions))))
    sebulba_checks(driver, records, launches, "knn_fused", "sebulba100")
    _, last3 = learning_check(rewards, "sebulba100", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"sebulba100: last-3 mean {last3:.3f} <= 0")
    m, n_steps = driver.config.num_formations, driver.ppo.n_steps
    last = records[-1]
    print(f"[sebulba] sebulba100: {s_iter:.4f} s/iteration steady against "
          f"gnn100's {gnn100['s_iter']:.4f} in this call "
          f"({s_iter / gnn100['s_iter']:.3f}x); {len(records)} iterations "
          f"learned of {driver.rollouts} rollouts acted; actor "
          f"{last['actor_env_steps_per_sec']:.1f} formation-steps/s "
          f"({driver.rollouts * n_steps * m / wall:.1f} over the whole run), "
          f"learner {last['learner_steps_per_sec']:.3f} chunks of "
          f"{driver._learner_chunk_k}/s ({len(records) / wall:.3f} "
          "iterations/s over the whole run); queue occupancy p95 "
          f"{driver.occupancy_p95():.2f} (depth "
          f"{driver.config.transfer_queue_depth}), staleness p95 "
          f"{driver.staleness_p95():.2f} (bound "
          f"{driver.config.max_param_staleness}), stale drops "
          f"{driver.stale_dropped}, consumed versions "
          f"{driver.consumed_versions[:3]}...{driver.consumed_versions[-3:]}")
    return launches["knn_fused"]


def sebulba100_k1():
    """The witness for ``sebulba100``'s slower learning: the same command
    at K=1 must clear gnn100's gate at gnn100's 30 iterations. Two of its
    learner iterations are profiled: the device's busy share over them
    (the union of the kernel intervals over the window's wall; the trace
    holds the actor lane's kernels too) and the k-NN kernel's events by
    stream."""
    driver, records, launches, _, _ = cli_run(
        "smoke_sebulba100_k1", SEBULBA100_K1,
        "sebulba100 K=1, 30 iterations, two learner iterations profiled")
    rewards = [r["reward"] for r in records]
    print("[learn] sebulba100 K=1 reward by iteration (parameter version "
          "acted with): " + ", ".join(
              f"{i + 1}: {r:.2f} (v{v})" for i, (r, v) in enumerate(
                  zip(rewards, driver.consumed_versions))))
    sebulba_checks(driver, records, launches, "knn_fused", "sebulba100 K=1")
    _, last3 = learning_check(rewards, "sebulba100 K=1", LEARN_MARGIN)
    if not last3 > 0:
        raise AssertionError(f"sebulba100 K=1: last-3 mean {last3:.3f} <= 0")
    print(f"[sebulba] sebulba100 K=1: {len(records)} iterations learned of "
          f"{driver.rollouts} rollouts acted; staleness p95 "
          f"{driver.staleness_p95():.2f} (bound "
          f"{driver.config.max_param_staleness}), stale drops "
          f"{driver.stale_dropped}")
    window = driver.trace_window
    events = trace_kernels(window.trace_path)
    union = busy_union_us((a, b) for _, a, b in events)
    wall_us = window.window_s * 1e6
    if union > wall_us:
        raise AssertionError(f"sebulba100 K=1 busy {union:.1f} us > window "
                             f"{wall_us:.1f} us")
    knn = [e for e in events if "knn_fused" in e[0]]
    trace = json.loads(Path(window.trace_path).read_text())
    streams = sorted({e.get("args", {}).get("stream") for e in
                      trace["traceEvents"] if "knn_fused" in e.get("name", "")
                      and e.get("cat") == "kernel"})
    learner_streams = sorted({e.get("args", {}).get("stream") for e in
                              trace["traceEvents"]
                              if e.get("cat") == "kernel"
                              and "gemm" in e.get("name", "")})
    print(f"[profile] sebulba100 K=1, two learner iterations with the actor "
          f"lane beside them: device busy {union / 1e3:.3f} ms of "
          f"{wall_us / 1e3:.3f} ms wall ({100 * union / wall_us:.1f}%, the "
          f"union of the device intervals); {len(events)} device events; "
          f"knn_fused {len(knn)} events on stream(s) {streams}; GEMMs on "
          f"stream(s) {learner_streams}")
    return 100 * union / wall_us


def sebulba1024():
    driver, records, launches, s_iter, _ = cli_run(
        "smoke_sebulba1024", SEBULBA1024, "sebulba1024 M=8 N=1024 K=1")
    sebulba_checks(driver, records, launches, "knn_tiled", "sebulba1024")
    print(f"[sebulba] sebulba1024: {s_iter:.4f} s/iteration steady, "
          f"{len(records)} iterations of {driver.rollouts} rollouts; queue "
          f"occupancy p95 {driver.occupancy_p95():.2f}, staleness p95 "
          f"{driver.staleness_p95():.2f}")
    return launches["knn_tiled"]


def lockstep_equals_anakin(kind):
    """A Sebulba driver in lockstep (each lane on its own stream) against
    the captured Anakin host loop from one seed, 3 iterations: parameters
    and every iteration's metrics bitwise."""
    import torch

    from marl_distributedformation_tpu_torch.algo import PPOConfig
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.models import (
        GNNActorCritic,
        MLPActorCritic,
    )
    from marl_distributedformation_tpu_torch.train import (
        SebulbaDriver,
        TrainConfig,
        Trainer,
    )

    if kind == "mlp":
        params, ppo = EnvParams(), PPOConfig()
    else:
        params = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
        ppo = PPOConfig(batch_size=16384)
    runs = []
    for cls, arch in ((Trainer, "anakin"), (SebulbaDriver, "sebulba")):
        gen = torch.Generator().manual_seed(3)
        model = (MLPActorCritic(params.obs_dim, generator=gen)
                 if kind == "mlp" else GNNActorCritic(k=4, generator=gen))
        runs.append(cls(params, ppo, TrainConfig(
            num_formations=64, seed=3, checkpoint=False, architecture=arch,
            log_dir=str(ROOT / "logs" / "smoke_lockstep")),
            model=model, device="cuda"))
    anakin, sebulba = runs
    for i in range(3):
        a = anakin.run_iteration()
        s = sebulba.run_lockstep_iteration()
        torch.cuda.synchronize()
        for name in a:
            if not torch.equal(a[name], s[name]):
                raise AssertionError(f"lockstep {kind}: metric {name} "
                                     f"differs at iteration {i}")
    for p, q in zip(anakin.model.parameters(), sebulba.model.parameters()):
        if not torch.equal(p, q):
            raise AssertionError(f"lockstep {kind}: parameters differ")
    if sebulba.graph_count() != 3:
        raise AssertionError(f"lockstep {kind}: {sebulba.graph_count()} "
                             "graphs, want 3")
    print(f"[lockstep] {kind} M=64: 3 lockstep round trips (actor and "
          "learner on their own streams, captured) == the captured Anakin "
          f"host loop bitwise: parameters and every metric; "
          f"{anakin.step} optimizer steps")


def observability_phase():
    """gnn100's command for 8 host-loop iterations twice from one seed:
    the default run (``GET /metrics`` served and scraped during it, the
    census checked; its last 6 iterations turn the registry and the
    ledger on and off in turn, for the telemetry and ledger overheads
    inside one run) and ``telemetry=false ledger=false``; both end on the
    same parameters bitwise (C4, and observability changes nothing on the
    device). Then ``profile=true profile_iterations=3`` at N=100, M=64: its
    trace holds 3 x 10 ``knn_fused`` events, and the audit line."""
    import socket
    import threading
    import urllib.request

    import torch

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    scraped = {}
    done = threading.Event()

    def scrape():
        url = f"http://127.0.0.1:{port}/metrics"
        while not done.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as resp:
                    body = resp.read().decode()
                if "marl_train_iterations_total" in body and (
                        "marl_program_dispatches_total" in body):
                    scraped["body"] = body
                    return
            except OSError:
                pass
            time.sleep(0.2)

    poller = threading.Thread(target=scrape, daemon=True)
    poller.start()
    try:
        default, _, _, s_default, _ = cli_run(
            "smoke_obs_default", OBS100 + (f"telemetry_port={port}",),
            "gnn100 8 iterations, telemetry and ledger on (the last 6 "
            "rotating)", rotate=True)
    finally:
        done.set()
        poller.join(timeout=10)
    body = scraped.get("body", "")
    missing = [n for n in METRIC_NAMES if n not in body]
    if missing:
        raise AssertionError(f"GET /metrics during the run lacks {missing}")
    print(f"[metrics] GET /metrics during the run: {len(body)} bytes, "
          f"{sum(1 for ln in body.splitlines() if ln.startswith('# TYPE'))} "
          f"families, holding {', '.join(METRIC_NAMES)}")
    check_census(default, "gnn100 default run", {
        "trainer_train_rollout": "rollout",
        "trainer_train_minibatch": "minibatch", "trainer_train_end": "end"})
    bare, *_, s_bare, _ = cli_run(
        "smoke_obs_bare", OBS100 + ("telemetry=false", "ledger=false"),
        "gnn100 8 iterations, telemetry and ledger off")
    if (Path(bare.log_dir) / "program_ledger.json").exists():
        raise AssertionError("ledger=false wrote a census")
    for p, q in zip(default.model.parameters(), bare.model.parameters()):
        if not torch.equal(p, q):
            raise AssertionError("C4: gnn100 with telemetry=false "
                                 "ledger=false ends on other parameters than "
                                 "the default run")
    print(f"[c4] gnn100 8 iterations from one seed, two runs (telemetry "
          f"and the ledger on, and off): parameters bitwise equal "
          f"({default.step} optimizer steps)")
    modes = default.smoke_modes
    print(f"[overhead] gnn100 s/iteration inside the default run, 2 "
          f"iterations each: both on {modes['both on']:.4f}, telemetry off "
          f"{modes['telemetry off']:.4f}, both off {modes['both off']:.4f}: "
          f"telemetry_overhead_pct "
          f"{100 * (modes['both on'] / modes['telemetry off'] - 1):+.2f}, "
          f"ledger_overhead_pct "
          f"{100 * (modes['telemetry off'] / modes['both off'] - 1):+.2f}; "
          f"across the two runs (6 steady iterations each): default "
          f"{s_default:.4f}, both off {s_bare:.4f} "
          f"({100 * (s_default / s_bare - 1):+.2f}%)")

    trainer, *_ = cli_run("smoke_profile64", PROFILE64,
                          "gnn N=100 M=64, 3 iterations profiled")
    window = trainer.trace_window
    knn = [e for e in trace_kernels(window.trace_path) if "knn_fused" in e[0]]
    want = 3 * trainer.ppo.n_steps
    if len(knn) != want:
        raise AssertionError(f"profile: {len(knn)} knn_fused events in the "
                             f"trace, want {want}")
    audit = (Path(window.trace_dir) / "capture_ledger.jsonl").read_text()
    line = json.loads(audit.splitlines()[-1])
    if not (line["completed"] and line["dispatches_traced"] == 3
            and line["programs"].get("trainer_train_rollout") == 3):
        raise AssertionError(f"profile audit line {line}")
    print(f"[profile] profile=true profile_iterations=3 at N=100 M=64: "
          f"{len(knn)} knn_fused events in {window.trace_path} "
          f"({window.window_s:.3f} s window); audit line programs "
          f"{line['programs']}")


def sebulba_phase(gnn100):
    """Phase 11; returns the Sebulba paths' launches."""
    lockstep_equals_anakin("mlp")
    lockstep_equals_anakin("gnn")
    elapsed("lockstep == Anakin")
    launches = {"knn_fused": sebulba100(gnn100)}
    elapsed("sebulba100")
    sebulba100_k1()
    elapsed("sebulba100 K=1")
    launches["knn_tiled"] = sebulba1024()
    elapsed("sebulba1024")
    observability_phase()
    elapsed("observability")
    return launches



# ---------------------------------------------------------------------------
# Phase 12: the reference's own user surface.

CONFIG1_STEPS = 1100  # crosses the first auto-reset (episodes of 1002)
CONFIG1_DEFAULT_STEPS = 300  # depth cut of the N=10 demo (1000) for time
VECENV_STEPS = 1003  # one full episode of 1002 steps and one more
PLAYBACK_STEPS = 302  # playback100's depth (1003 before phase 15)
MLP_PLAYBACK_STEPS = 300  # depth cut of the MLP playback for time


def config1_phase():
    """BASELINE config 1 through the ``simulate`` tool (N=5 for 1100 steps
    and the default N=10), then the per-formation step against its row of
    ``step_batch`` on the card (N=5 ring, N=100 k-NN); returns the k-NN
    step's ``knn_fused`` launches."""
    import torch

    from marl_distributedformation_tpu_torch import simulate
    from marl_distributedformation_tpu_torch.env import (
        EnvParams,
        control,
        reset,
        reset_batch,
        step,
        step_batch,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    for n, steps in ((5, CONFIG1_STEPS), (10, CONFIG1_DEFAULT_STEPS)):
        t0 = time.perf_counter()
        rows = simulate.main(["headless=true", f"num_agents={n}",
                              f"steps={steps}", "device=cuda"])
        wall = time.perf_counter() - t0
        dist = [r["avg_dist_to_goal"] for r in rows]
        first_episode = [r["avg_dist_to_goal"] for r in rows
                         if r["step"] <= 1000]
        if not all(math.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"config1 N={n}: non-finite rows {rows}")
        if not first_episode[-1] < first_episode[0]:
            raise AssertionError(f"config1 N={n}: avg_dist_to_goal did not "
                                 f"fall: {dist}")
        print(f"[config1] simulate N={n} M=1 {steps} steps: "
              f"{wall / steps * 1e3:.4f} ms a step, avg_dist_to_goal "
              f"{first_episode[0]:.2f} -> {first_episode[-1]:.2f} "
              f"(step {rows[-1]['step']}: {dist[-1]:.2f})")

    # One formation's step is step_batch's row on a batch of one: bitwise,
    # the observation included, the auto-reset drawn from generators of one
    # seed; with k-NN observations at N=100 the step launches knn_fused at
    # (1,100,4) once a step.
    dev = torch.device("cuda")
    single_launches = 0
    for params, steps in ((EnvParams(num_agents=5), CONFIG1_STEPS),
                          (EnvParams(num_agents=100, obs_mode="knn",
                                     knn_k=4, max_steps=98), 101)):
        label = f"N={params.num_agents} {params.obs_mode}"
        gen_one = torch.Generator(device=dev).manual_seed(21)
        gen_batch = torch.Generator(device=dev).manual_seed(21)
        one = reset(params, gen_one, dev)
        batch = reset_batch(params, 1, gen_batch, dev)
        ones, rows = [], []  # each step's outputs, compared once at the end
        launches = 0

        def fields(state, tr):
            return [state.agents, state.goal, state.steps, tr.obs,
                    tr.reward, tr.done, *tr.metrics.values()]

        with torch.no_grad():
            for _ in range(steps):
                vel = control(batch.agents, batch.goal, batch.obstacles,
                              params)
                knn_cuda.reset_launches()
                one, tr_one = step(one, vel[0], params, gen_one)
                launches += knn_cuda.LAUNCHES["knn_fused"]
                batch, tr = step_batch(batch, vel, params, gen_batch)
                ones.append(fields(one, tr_one))
                rows.append([x[0] for x in fields(batch, tr)])
        for i, (a, b) in enumerate(zip(zip(*ones), zip(*rows))):
            if not torch.equal(torch.stack(a), torch.stack(b)):
                raise AssertionError(f"{label}: per-formation step differs "
                                     f"from step_batch's row on the card "
                                     f"(field {i})")
        dones = int(torch.stack([r[5] for r in rows]).sum())
        if dones != 1:
            raise AssertionError(f"{label}: {dones} auto-resets in {steps} "
                                 "steps, want 1")
        want = steps if params.obs_mode == "knn" else 0
        if launches != want:
            raise AssertionError(f"{label}: the per-formation step launched "
                                 f"knn_fused {launches} times, want {want}")
        if params.obs_mode == "knn":
            single_launches = launches
        print(f"[config1] {label}: per-formation step == step_batch row 0 "
              f"at M=1, bitwise over {steps} steps (1 auto-reset), "
              f"knn_fused {launches} launches by the step")
    return single_launches


def timed_vec_env(params, m, seed):
    """A ``FormationVecEnv`` on the card that sums the seconds of its host
    copies (the actions in, the transition out), each timed between
    synchronizations."""
    import torch

    from marl_distributedformation_tpu_torch.compat import FormationVecEnv

    class Timed(FormationVecEnv):
        copy_s = 0.0

        def _to_device(self, actions):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._to_device(actions)
            torch.cuda.synchronize()
            self.copy_s += time.perf_counter() - t0
            return out

        def _fetch(self, tr):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super()._fetch(tr)
            self.copy_s += time.perf_counter() - t0
            return out

    return Timed(params, m, seed=seed, device="cuda")


def vec_env_run(ckpt, params, m, steps, label, kernel):
    """``FormationVecEnv`` driven by ``LoadedPolicy.predict`` on ``ckpt``:
    the kernel's launches (steps + 1, the reset's included), one done a
    formation an episode, and, interleaved, the same actions through
    ``make_vec_env`` from the same seed: obs, rewards and dones bitwise.
    Returns the VecEnv's launches of ``kernel``."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.compat import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import make_vec_env
    from marl_distributedformation_tpu_torch.eval import episode_length
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    seed = 17
    policy = LoadedPolicy.from_checkpoint(ckpt, env_params=params,
                                          device="cuda")
    env = timed_vec_env(params, m, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    reset_fn, step_fn = make_vec_env(params, m, "cuda", gen)
    n = params.num_agents

    knn_cuda.reset_launches()
    side = 0  # launches of the direct path, taken out of the count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    obs = env.reset()
    wall = time.perf_counter() - t0
    before = knn_cuda.LAUNCHES[kernel]
    state, ref_obs = reset_fn()
    side += knn_cuda.LAUNCHES[kernel] - before
    if not np.array_equal(obs, ref_obs.reshape(m * n, -1).cpu().numpy()):
        raise AssertionError(f"{label}: reset obs differ from make_vec_env's")
    # The VecEnv's host arrays go back to the card and are compared there,
    # into one flag read at the end; the comparison is outside the timing.
    same = torch.ones((), dtype=torch.bool, device="cuda")
    done_rows = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        actions, _ = policy.predict(obs, deterministic=True)
        obs, rewards, dones, _ = env.step(actions)
        wall += time.perf_counter() - t0
        done_rows += int(dones.sum())
        before = knn_cuda.LAUNCHES[kernel]
        act = torch.from_numpy(actions.reshape(m, n, 2)).to("cuda")
        state, tr = step_fn(state, act)
        side += knn_cuda.LAUNCHES[kernel] - before
        for host, dev in ((obs, tr.obs), (rewards, tr.reward),
                          (dones, tr.done.repeat_interleave(n))):
            same &= (torch.from_numpy(host).to("cuda")
                     == dev.reshape(host.shape)).all()
        same &= torch.isfinite(tr.obs).all()
        torch.cuda.synchronize()
    if not bool(same):
        raise AssertionError(f"{label}: VecEnv differs from make_vec_env "
                             "(or a non-finite obs)")
    launches = knn_cuda.LAUNCHES[kernel] - side
    if launches != steps + 1:
        raise AssertionError(f"{label}: {kernel} launched {launches} times, "
                             f"want {steps + 1}")
    episodes = steps // episode_length(params)
    if done_rows != episodes * m * n:
        raise AssertionError(f"{label}: {done_rows} done rows, want "
                             f"{episodes * m * n}")
    print(f"[vec_env] {label}: M={m} N={n} {steps} steps, {kernel} "
          f"{launches} launches, == make_vec_env bitwise; "
          f"{m * steps / wall:.1f} formation-steps/s with predict, host "
          f"copies {env.copy_s:.3f} s = {100 * env.copy_s / wall:.1f}% of "
          f"{wall:.3f} s wall; phase 3 eval "
          + ", ".join(f"{k} {v:.1f}" for k, v in EVAL_RATES.items())
          + f" formation-steps/s; {card_line()}")
    return launches


def playback(name, overrides, steps):
    """The ``visualize_policy`` tool headless on ``logs/{name}``, its
    transitions captured; returns the k-NN launches."""
    import contextlib
    import io

    from marl_distributedformation_tpu_torch import visualize_policy
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    out = io.StringIO()
    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        played = visualize_policy.main([f"name={name}", "headless=true",
                                        f"steps={steps}", "device=cuda",
                                        *overrides])
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    text = out.getvalue()
    if played != steps or text.count("rewards:") != steps:
        raise AssertionError(f"playback {name}: {played} steps, "
                             f"{text.count('rewards:')} transitions printed")
    if "nan" in text:
        raise AssertionError(f"playback {name}: non-finite transition")
    print(f"[playback] {name}: {steps} steps in {wall:.2f} s "
          f"({wall / steps * 1e3:.3f} ms a step), launches {launches}")
    return launches


def sb3_round_trip(m=256):
    """The committed checkpoint exported to SB3 naming, packed as a
    ``PPO.save`` zip and imported back; its deterministic actions against
    the checkpoint's, bitwise, over a full episode on the card."""
    import json as _json
    import shutil
    import zipfile

    import numpy as np

    from marl_distributedformation_tpu_torch.compat import (
        FormationVecEnv,
        LoadedPolicy,
    )
    from marl_distributedformation_tpu_torch.compat.sb3_import import (
        export_sb3_state_dict,
        import_sb3_checkpoint,
    )
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.eval import episode_length

    work = ROOT / "logs" / "smoke_sb3"
    shutil.rmtree(work, ignore_errors=True)
    pth = export_sb3_state_dict(CKPT, work / "policy.sb3.pth")
    src = work / CKPT.with_suffix(".zip").name
    with zipfile.ZipFile(src, "w") as zf:
        zf.writestr("data", _json.dumps({"policy_class": "MlpPolicy"}))
        zf.writestr("policy.pth", pth.read_bytes())
    out = import_sb3_checkpoint(src, work / "imported")
    ours = LoadedPolicy.from_checkpoint(CKPT, device="cuda")
    back = LoadedPolicy.from_checkpoint(out, device="cuda")
    params = EnvParams(num_agents=5)
    env = FormationVecEnv(params, m, seed=3, device="cuda")
    obs = env.reset()
    steps = episode_length(params)
    for _ in range(steps):
        a, _ = ours.predict(obs, deterministic=True)
        b, _ = back.predict(obs, deterministic=True)
        if not np.array_equal(a, b):
            raise AssertionError("SB3 round trip: imported actions differ")
        obs, *_ = env.step(a)
    print(f"[sb3] {CKPT.name} -> {pth.name} -> {src.name} -> {out.name}: "
          f"deterministic actions bitwise equal over {steps} steps at M={m}")


def surface_phase(gnn100):
    """Phase 12; returns the VecEnv and playback launches by kernel."""
    import shutil

    from marl_distributedformation_tpu_torch.env import EnvParams

    single = config1_phase()
    elapsed("config 1")
    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    vec100 = vec_env_run(gnn100["ckpt"], p100, 1024, VECENV_STEPS,
                         "vecenv100", "knn_fused")
    p1024 = EnvParams(num_agents=1024, obs_mode="knn", knn_k=4, max_steps=99)
    vec1024 = vec_env_run(gnn100["ckpt1024"], p1024, 8, 101, "vecenv1024",
                          "knn_tiled")
    elapsed("VecEnv")
    gnn_run = Path(gnn100["ckpt"]).parent.relative_to(ROOT / "logs")
    got = playback(str(gnn_run), ("obs_mode=knn",
                                  "num_agents_per_formation=100"),
                   PLAYBACK_STEPS)
    if got != {"knn_fused": PLAYBACK_STEPS + 1, "knn_tiled": 0}:
        raise AssertionError(f"playback100 launches {got}, want knn_fused "
                             f"{PLAYBACK_STEPS + 1}")
    mlp_dir = ROOT / "logs" / "smoke_playback_mlp"
    shutil.rmtree(mlp_dir, ignore_errors=True)
    mlp_dir.mkdir(parents=True)
    shutil.copy(CKPT, mlp_dir / CKPT.name)
    if playback(mlp_dir.name, (), MLP_PLAYBACK_STEPS) != {"knn_fused": 0,
                                                          "knn_tiled": 0}:
        raise AssertionError("MLP playback launched a k-NN kernel")
    sb3_round_trip()
    elapsed("playback, SB3")
    return {"vec_env": {"knn_fused": vec100, "knn_tiled": vec1024},
            "playback": got["knn_fused"], "single_step": single}


# Phase 13: the serving fleet, the lane watchdog and the runtime guards.
# gnn100's command at M=64 for 3 iterations, one a dispatch: the first
# warms the phases up, the second captures them, the third is the first
# post-warm-up dispatch, which guard_transfers guards.
GUARDS64 = ("policy=gnn", "obs_mode=knn", "num_agents_per_formation=100",
            "num_formation=64", "preset=tpu", "total_timesteps=192000",
            "fused_chunk=1", "guard_retraces=1", "guard_transfers=true",
            "guard_nans=true")
FLEET_DURATION_S = 1.5  # a cell's storm (3.0 before phase 17 was paid for)
FLEET_HTTP_REQUESTS = 200  # over 4 HTTP clients


def fleet_equals_engine(router, engine, rows):
    """Every replica's deterministic actions against the single engine's
    ``act`` on the same rows, rung by rung: bitwise, or else within
    serving's tolerance with the largest difference printed. Returns the
    largest difference."""
    import numpy as np

    worst, bitwise = 0.0, True
    for r in router.replicas:
        params, _ = r.registry.active()
        for b in SERVE_BUCKETS:
            got = r.engine.act(rows[:b], nn_params=params)
            want = engine.act(rows[:b])
            if not np.array_equal(got, want):
                bitwise = False
                np.testing.assert_allclose(
                    got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL,
                    err_msg=f"fleet replica {r.index} rung {b} vs engine")
                worst = max(worst, float(np.abs(got - want).max()))
    print(f"[fleet] R={len(router.replicas)}: every replica's deterministic "
          f"actions == the single engine's act at rungs {SERVE_BUCKETS}: "
          + ("bitwise" if bitwise else
             f"NOT bitwise, within rtol {SERVE_RTOL} atol {SERVE_ATOL} (max "
             f"abs diff {worst:.3g})"))
    return worst


def fleet_storm(replicas, fleet_dir, p100, rows, swap_ckpt, step0, engine):
    """One fleet cell: ``replicas`` replicas of ``gnn100``'s checkpoint on
    ``cuda:0``, every rung of every replica captured before traffic, then
    4 clients for ``FLEET_DURATION_S`` with a coordinated swap to
    ``scen100``'s checkpoint in the middle (and at R=2 ``kill_replica(0)``
    before it and its half-open readmission after). Gates: one capture a
    rung a replica, no step-monotonicity violation, no accepted request
    lost, every replica on the new step. Returns ``(router, coordinator,
    report)`` with the router still started."""
    import shutil

    from marl_distributedformation_tpu_torch.chaos import (
        check_budget_one,
        check_no_request_lost,
        check_step_monotonic,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        fleet_from_checkpoint_dir,
        run_fleet_smoke,
        warmup_fleet,
    )

    router, coordinator = fleet_from_checkpoint_dir(
        fleet_dir, env_params=p100, num_replicas=replicas,
        buckets=SERVE_BUCKETS, window_ms=2.0, probe_interval_s=0.2,
        max_failovers=2)
    t0 = time.perf_counter()
    warmup_fleet(router, rows.shape[1:])
    capture_s = time.perf_counter() - t0
    counts = router.compile_counts()
    if counts != {r.index: dict.fromkeys(SERVE_BUCKETS, 1)
                  for r in router.replicas}:
        raise AssertionError(f"fleet R={replicas}: captures {counts}")
    fleet_equals_engine(router, engine, rows)
    swap_step = step0 + replicas  # a newer step for each cell
    target = fleet_dir / f"rl_model_{swap_step}_steps.msgpack"
    events = {}

    def chaos():
        if replicas > 1:
            router.kill_replica(0)
        shutil.copy(swap_ckpt, fleet_dir / ".incoming.tmp")
        (fleet_dir / ".incoming.tmp").replace(target)
        if not coordinator.refresh():
            raise AssertionError(f"fleet R={replicas}: no swap: "
                                 f"{list(coordinator.load_errors)}")
        events["pause_ms"] = coordinator.last_pause_ms
        if replicas > 1:
            router.replicas[0].scheduler.start()

    log = {}
    router.start()
    report = run_fleet_smoke(
        router, rows.shape[1:], duration_s=FLEET_DURATION_S, num_clients=4,
        coordinator=coordinator, mid_storm=chaos,
        mid_storm_at_s=FLEET_DURATION_S / 2, warmup=False, row_pool=rows,
        log=log)
    if replicas > 1:
        # The half-open probe readmits the revived replica on the routing
        # path once its interval has passed.
        deadline = time.perf_counter() + 10.0
        while not router.replicas[0].healthy and time.perf_counter() < deadline:
            router.submit(rows[:1]).result(timeout=30)
            time.sleep(0.01)
        if not router.replicas[0].healthy:
            raise AssertionError("fleet R=2: replica 0 never readmitted")
    violations = (
        check_step_monotonic(log["steps"])
        + check_no_request_lost(log["outcomes"])
        + check_budget_one({f"replica{i}_rung{b}": n
                            for i, c in router.compile_counts().items()
                            for b, n in c.items()}))
    if violations:
        raise AssertionError(f"fleet R={replicas}: "
                             f"{[v.record() for v in violations]}")
    if (report["client_requests_ok"] == 0 or report["client_failed"]
            or report["client_timed_out"]
            or report["model_step_max"] != swap_step
            or any(r.registry.active_step != swap_step
                   for r in router.replicas)):
        raise AssertionError(f"fleet R={replicas}: {report}")
    report["capture_s"] = capture_s
    report["pause_ms"] = events["pause_ms"]
    report["outcomes"] = len(log["outcomes"])
    print(f"[fleet] fleet100 R={replicas} on cuda:0 (sizes 1,3,8,9,40,100 "
          f"formations of 100 agents, 4 clients, {report['duration_s']} s, "
          f"{'kill_replica(0), ' if replicas > 1 else ''}a coordinated swap "
          f"to scen100 at step {swap_step}"
          f"{', readmitted half-open' if replicas > 1 else ''}): "
          f"{report['requests_per_sec_fleet']:.1f} requests/s; p50 "
          f"{report['latency_p50_ms']:.3f} ms, p95 "
          f"{report['latency_p95_ms']:.3f} ms, p99 "
          f"{report['latency_p99_ms']:.3f} ms; routed "
          + ", ".join(f"replica{r.index} "
                      f"{report.get(f'replica{r.index}_routed', 0):.0f}"
                      for r in router.replicas)
          + f"; failed over {report['fleet_failed_over_total']:.0f}, breaks "
          f"{report['fleet_breaks_total']:.0f}, rejected "
          f"{report['client_rejected']:.0f}; {report['outcomes']} accepted "
          f"requests, none lost; model_step {report['model_step_min']:.0f} "
          f"-> {report['model_step_max']:.0f}, 0 monotonicity violations; "
          f"the longest barrier hold at the swap {events['pause_ms']:.3f} ms;"
          f" captures {router.compile_counts()} ({capture_s:.2f} s)")
    for r in router.replicas:
        print(f"[fleet] R={replicas} replica {r.index} replay ms a rung "
              "(events over back-to-back replays on its stream): "
              + ", ".join(
                  f"{b}: {replay_ms(r.engine.rung(b).graph.graph, r.engine._stream, 100 if b < 512 else 30):.4f}"
                  for b in SERVE_BUCKETS))
    return router, coordinator, report


def http_cell(router, rows):
    """``FleetFrontend`` on 127.0.0.1:0 over the R=2 fleet: 4 HTTP clients
    send ``FLEET_HTTP_REQUESTS`` requests through the port's
    ``ServingClient``; every answer equals the in-process router's
    bitwise and carries ``model_step`` and its ``X-Trace-Id``; then
    ``/v1/health`` and ``/v1/metrics`` in Prometheus text. The schedulers
    coalesce nothing during the cell (window 0), so a request is served
    alone through the rung its size picks, over HTTP as in-process: a row
    served in a batch of another rung runs other GEMM tiles, and can
    differ in its last bits."""
    import threading
    import urllib.request

    import numpy as np

    from marl_distributedformation_tpu_torch.obs import TRACE_HEADER
    from marl_distributedformation_tpu_torch.serving import ServingClient
    from marl_distributedformation_tpu_torch.serving.client import post_json
    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetFrontend,
    )

    lat, errors, seen, lock = [], [], [], threading.Lock()

    def worker(i, url):
        client = ServingClient(url, max_retries=3)

        def traced(base_url, body, trace_id, wait_s):
            status, payload, headers = post_json(
                base_url, "/v1/act", body, headers={TRACE_HEADER: trace_id},
                timeout_s=wait_s + 10.0)
            with lock:
                seen.append(headers.get(TRACE_HEADER) == trace_id
                            and "model_step" in payload
                            and payload.get("trace_id", trace_id)
                            == trace_id)
            return status, payload

        client._post_act = traced
        rng = np.random.default_rng(100 + i)
        try:
            for j in range(FLEET_HTTP_REQUESTS // 4):
                # Small requests: a 100-formation request is ~4 MB of JSON.
                n = (1, 3, 8, 9)[(i + j) % 4]
                start = int(rng.integers(0, len(rows) - n))
                obs = rows[start:start + n]
                t0 = time.perf_counter()
                actions, step = client.predict(obs)
                dt = time.perf_counter() - t0
                local = router.submit(obs).result(timeout=60)
                if not np.array_equal(actions, local.actions) or \
                        step != local.model_step:
                    raise AssertionError(
                        f"HTTP answer off the router's by "
                        f"{np.abs(actions - local.actions).max()} (steps "
                        f"{step}, {local.model_step})")
                with lock:
                    lat.append(dt)
        except Exception as e:  # noqa: BLE001 — raised below
            with lock:
                errors.append(repr(e))

    windows = [r.scheduler.window_s for r in router.replicas]
    for r in router.replicas:
        r.scheduler.window_s = 0.0
    with FleetFrontend(router, port=0) as frontend:
        threads = [threading.Thread(target=worker, args=(i, frontend.url))
                   for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(frontend.url + "/v1/health",
                                    timeout=10) as resp:
            health = (resp.status, json.loads(resp.read()))
        with urllib.request.urlopen(urllib.request.Request(
                frontend.url + "/v1/metrics",
                headers={"Accept": "text/plain"}), timeout=10) as resp:
            text = resp.read().decode()
            ctype = resp.headers["Content-Type"]
    for r, window in zip(router.replicas, windows):
        r.scheduler.window_s = window
    if errors or len(lat) != FLEET_HTTP_REQUESTS:
        raise AssertionError(f"http: {len(lat)} answered, errors {errors[:3]}")
    if len(seen) < FLEET_HTTP_REQUESTS or not all(seen):
        raise AssertionError("http: a response without its X-Trace-Id or "
                             "model_step")
    if health[0] != 200 or health[1]["healthy_replicas"] != 2:
        raise AssertionError(f"http: /v1/health {health}")
    if not ctype.startswith("text/plain") or \
            "fleet_routed_total" not in text:
        raise AssertionError(f"http: /v1/metrics {ctype} {text[:200]}")
    lat.sort()
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * (len(lat) - 1))]
    print(f"[fleet] frontend over R=2: {len(lat)} HTTP requests from 4 "
          f"ServingClient threads (sizes 1, 3, 8, 9 formations), "
          f"{len(lat) / wall:.1f} requests/s over HTTP (each also served "
          f"in-process for the comparison), p50 {p50 * 1e3:.3f} ms, p95 "
          f"{p95 * 1e3:.3f} ms; every answer == the router's bitwise (each "
          f"served alone, window 0), "
          f"model_step and X-Trace-Id on every response; /v1/health "
          f"{health[1]}; /v1/metrics Prometheus text ({len(text)} bytes)")


def http_failures(policy, rows):
    """The frontend's forced failures on a one-slot fleet: a 429 with
    ``Retry-After`` (the worker held at its batch barrier, one request
    queued), then a 503 from act and health with every replica killed."""
    import urllib.error
    import urllib.request

    from marl_distributedformation_tpu_torch.serving.fleet import (
        FleetFrontend,
        FleetRouter,
        warmup_fleet,
    )

    def post(url, obs):
        req = urllib.request.Request(
            url + "/v1/act", data=json.dumps({"obs": obs.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.status, resp.headers, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers, json.loads(e.read() or b"{}")

    router = FleetRouter(policy, num_replicas=1, buckets=(1,), window_ms=0.0,
                         max_queue=1, probe_interval_s=60.0)
    warmup_fleet(router, rows.shape[1:])
    gate = router.replicas[0].registry.batch_lock
    with router, FleetFrontend(router, port=0) as frontend:
        gate.acquire()  # the worker blocks at its next batch
        try:
            held = router.submit(rows[:1])
            deadline = time.perf_counter() + 10.0
            while (router.replicas[0].scheduler.queue_depth
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            queued = router.submit(rows[1:2])
            status, headers, body = post(frontend.url, rows[2:3])
        finally:
            gate.release()
        held.result(timeout=30)
        queued.result(timeout=30)
        if (status != 429 or int(headers["Retry-After"]) < 1
                or body.get("error") != "backpressure"
                or headers["X-Trace-Id"] != body.get("trace_id")):
            raise AssertionError(f"http 429: {status} {dict(headers)} {body}")
        router.kill_replica(0)
        act503 = post(frontend.url, rows[3:4])[0]
        try:
            urllib.request.urlopen(frontend.url + "/v1/health", timeout=10)
            health503 = 200
        except urllib.error.HTTPError as e:
            health503 = e.code
    if (act503, health503) != (503, 503):
        raise AssertionError(f"http 503: act {act503}, health {health503}")
    print(f"[fleet] frontend failures: 429 with Retry-After "
          f"{headers['Retry-After']} s (retry_after_s "
          f"{body['retry_after_s']:.4f}) from a full one-slot fleet; every "
          "replica killed: act 503, health 503")


def watchdog_cell(router, rows):
    """``LaneWatchdog.watch_fleet`` over the R=2 fleet: a seeded
    ``scheduler.dispatch`` crash kills one worker while clients send; the
    watchdog restarts it within the wedge timeout, ``restarts_total`` is
    1, and no accepted request is lost. Prints the MTTR (the fault's
    firing to the worker alive again)."""
    import threading

    from marl_distributedformation_tpu_torch.chaos import (
        FaultPlane,
        FaultSchedule,
        LaneWatchdog,
        check_no_request_lost,
        set_fault_plane,
    )

    schedule = FaultSchedule.from_seed(
        13, faults=1, points={"scheduler.dispatch": ("crash",)}, max_hit=4)
    watchdog = LaneWatchdog(backoff_base_s=0.0, poll_interval_s=0.005)
    watchdog.watch_fleet(router)
    plane = FaultPlane(enabled=False)
    previous = set_fault_plane(plane)
    outcomes, stop = [], threading.Event()

    def client(i):
        while not stop.is_set():
            fut = router.submit(rows[i:i + 8])
            try:
                fut.result(timeout=router.default_timeout_s + 5.0)
                outcomes.append({"ok": True, "hung": False})
            except Exception as e:  # noqa: BLE001 — classified below
                outcomes.append({"ok": False, "error": repr(e),
                                 "hung": not fut.done()})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        watchdog.start()
        for t in threads:
            t.start()
        plane.arm(schedule)
        plane.enabled = True
        deadline = time.perf_counter() + 30.0
        while not plane.fired and time.perf_counter() < deadline:
            time.sleep(0.0005)
        if not plane.fired:
            raise AssertionError("watchdog: the armed crash never fired")
        fired_at = plane.fired[0]["t"]
        plane.enabled = False
        while watchdog.restarts_total() < 1 and \
                time.perf_counter() < deadline:
            time.sleep(0.0005)
        alive = all(r.scheduler.alive for r in router.replicas)
        mttr = time.perf_counter() - fired_at
        time.sleep(0.3)  # traffic through the healed fleet
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        watchdog.stop()
        set_fault_plane(previous)
    lost = check_no_request_lost(outcomes)
    if (watchdog.restarts_total() != 1 or not alive or lost
            or mttr > watchdog.wedge_timeout_s
            or not all(o["ok"] for o in outcomes)):
        raise AssertionError(
            f"watchdog: restarts {watchdog.restarts_total()}, alive {alive}, "
            f"mttr {mttr:.3f} s, lost {[v.record() for v in lost]}, "
            f"failed {[o for o in outcomes if not o['ok']][:3]}")
    print(f"[fleet] watchdog over R=2: a seeded scheduler.dispatch crash "
          f"(hit {schedule.specs[0].at_hit}) killed "
          f"{watchdog.restart_log[0]['lane']}; restarted by the watchdog, "
          f"restarts_total 1, MTTR {mttr * 1e3:.3f} ms (fault to worker "
          f"alive; wedge timeout {watchdog.wedge_timeout_s:g} s); "
          f"{len(outcomes)} accepted requests, none lost or failed")


def guards_run():
    """``GUARDS64`` must train through with the three guards on; then
    three negatives on the same trainer, each of which must raise: an
    ``.item()`` inside a guarded dispatch (the sync debug mode),
    ``train.carry_poison`` armed through the plane (``FloatingPointError``
    naming an aten op) and a forced rebuild (``RetraceError``)."""
    import torch

    from marl_distributedformation_tpu_torch.analysis import RetraceError
    from marl_distributedformation_tpu_torch.chaos import (
        FaultPlane,
        FaultSchedule,
        FaultSpec,
        set_fault_plane,
    )

    trainer, rewards, launches, _ = train_run(
        "guards64", GUARDS64, "guards64 (gnn100 at M=64, guard_retraces=1 "
        "guard_transfers=true guard_nans=true)")
    if trainer.retrace_guard.count != 1 or trainer.graph_count() != 3:
        raise AssertionError(f"guards64: builds {trainer.retrace_guard.count}"
                             f", graphs {trainer.graph_count()}")
    caught = {}

    def sync(phase):
        if phase == "update":
            torch.ones((), device="cuda").add(1).item()

    trainer.phase_hook = sync
    try:
        trainer.run_chunk()
    except RuntimeError as e:
        caught["transfers"] = str(e).splitlines()[0]
    finally:
        trainer.phase_hook = None
    plane = FaultPlane(enabled=True)
    plane.arm(FaultSchedule([FaultSpec("train.carry_poison", "raise", 1)]))
    previous = set_fault_plane(plane)
    try:
        trainer.run_chunk()
    except FloatingPointError as e:
        caught["nans"] = str(e)
    finally:
        set_fault_plane(previous)
    for phase in trainer._phases:
        phase.drop()
    try:
        trainer.run_chunk()
    except RetraceError as e:
        caught["retraces"] = str(e)[:120]
    if ("synchroniz" not in caught.get("transfers", "")
            or "aten." not in caught.get("nans", "")
            or "budget 1" not in caught.get("retraces", "")):
        raise AssertionError(f"guards: a negative did not raise: {caught}")
    print(f"[guards] guards64 passed with the three guards on (1 build, 3 "
          f"graphs, {launches['knn_fused']} knn_fused launches); negatives "
          f"raised: .item() in a guarded dispatch -> {caught['transfers']!r}; "
          f"train.carry_poison under guard_nans -> {caught['nans']!r}; a "
          f"forced rebuild under guard_retraces=1 -> {caught['retraces']!r}")


def fleet_phase(gnn100_ckpt, scen100_ckpt, single=None):
    """Phase 13: ``fleet100`` at R=1 and R=2 on ``cuda:0`` (the request rows
    through ``knn_fused``), the R=2 fleet's profiled window, the HTTP
    frontend and its failures, the watchdog, and the runtime guards;
    ``single`` is phase 10's smoke report, printed beside the fleet's.
    Returns ``knn_fused``'s launches building the request rows."""
    import shutil

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        run_fleet_smoke,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    rows, launches = serve_rows()
    policy = LoadedPolicy.from_checkpoint(gnn100_ckpt, env_params=p100,
                                          device="cuda")
    engine = BucketedPolicyEngine(policy, buckets=SERVE_BUCKETS)
    step0 = checkpoint_step(gnn100_ckpt)
    swap_step0 = max(step0, checkpoint_step(scen100_ckpt)) + 1
    reports = {}
    for replicas in (1, 2):
        fleet_dir = ROOT / "logs" / f"smoke_fleet100_r{replicas}"
        shutil.rmtree(fleet_dir, ignore_errors=True)
        fleet_dir.mkdir(parents=True)
        shutil.copy(gnn100_ckpt, fleet_dir / Path(gnn100_ckpt).name)
        router, coordinator, report = fleet_storm(
            replicas, fleet_dir, p100, rows, scen100_ckpt, swap_step0,
            engine)
        reports[replicas] = report
        if replicas == 1:
            router.stop()
            elapsed("fleet R=1")
    print("[fleet] requests/s and p50/p95/p99 ms: "
          + "; ".join(
              f"R={r} {reports[r]['requests_per_sec_fleet']:.1f}, "
              f"{reports[r]['latency_p50_ms']:.3f}/"
              f"{reports[r]['latency_p95_ms']:.3f}/"
              f"{reports[r]['latency_p99_ms']:.3f}" for r in (1, 2))
          + (f"; phase 10's single engine {single['requests_per_sec']:.1f}, "
             f"{single['latency_p50_ms']:.3f}/{single['latency_p95_ms']:.3f}"
             f"/{single['latency_p99_ms']:.3f}" if single else "")
          + f"; R=2/R=1 {reports[2]['requests_per_sec_fleet'] / reports[1]['requests_per_sec_fleet']:.3f}")
    seen = {}

    def storm():
        seen.update(run_fleet_smoke(
            router, rows.shape[1:], duration_s=1.5, num_clients=4,
            warmup=False, row_pool=rows, seed=1))

    profile_window(storm, "fleet100 R=2 storm, 1.5 s profiled (the "
                   "profiler slows the host)", 1, "window")
    print(f"[fleet] the profiled R=2 storm: "
          f"{seen['requests_per_sec_fleet']:.1f} requests/s, p95 "
          f"{seen['latency_p95_ms']:.3f} ms")
    elapsed("fleet R=2")
    try:
        http_cell(router, rows)
        elapsed("fleet frontend")
        watchdog_cell(router, rows)
    finally:
        router.stop()
    http_failures(policy, rows)
    elapsed("fleet watchdog and frontend failures")
    guards_run()
    return launches, reports[2]


# Phase 14: the always-learning pipeline and tenant lanes on one card.
# gnn100's command for 20 iterations at fused_chunk=5: the trainer writes
# a checkpoint at each chunk boundary (JAX's and the port's fused loops
# both do), so K=10 would give 2 candidates in 20 iterations; K=5 gives 4.
ALWAYS_GATE_M = 64  # JAX's gate_formations default
ALWAYS100 = GNN100[:-1] + (
    "total_timesteps=20480000", "fused_chunk=5", "save_freq=50",
    f"gate_formations={ALWAYS_GATE_M}", "pipeline_replicas=2",
    "pipeline_buckets=[1,8,64]",
    "pipeline_budget_s=240", "pipeline_poll_s=0.05",
    "watchdog_wedge_timeout_s=120")
ALWAYS_CLIENT_SIZES = (1, 3, 8, 9, 40, 100)
TENANT_DURATION_S = 2.0
ALWAYS_PROFILE_S = 0.4


def write_nan_candidate(source, step):
    """``source``'s checkpoint with NaN parameters under a valid footer, as
    ``rl_model_{step}_steps.msgpack`` beside it: it loads, and must fail
    the gate on its eval (the trainer's own writer refuses non-finite
    trees)."""
    import numpy as np

    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_path,
        msgpack_restore_file,
        msgpack_serialize,
        with_footer,
    )

    raw = msgpack_restore_file(source)

    def nan(tree):
        if isinstance(tree, dict):
            return {k: nan(v) for k, v in tree.items()}
        if isinstance(tree, np.ndarray) and tree.dtype.kind == "f":
            return np.full_like(tree, np.nan)
        return tree

    raw["params"] = nan(raw["params"])
    path = checkpoint_path(Path(source).parent, step)
    tmp = path.parent / f".{path.name}.tmp"
    tmp.write_bytes(with_footer(msgpack_serialize(raw)))
    tmp.replace(path)
    return path


def always100(gnn100, rows, bench=None):
    """``always100``: the port's ``always_learning`` in-process on
    ``cuda:0`` (``ALWAYS100``), one NaN candidate written after the second
    checkpoint, a forced regression once the fleet serves two good
    checkpoints, and 2 clients sending 1-100 formations of ``rows``
    through the router from the fleet's start to the training's end;
    with ``bench`` (``(path, record)`` of a bench record) the regression
    sentinel runs against it (``sentinel_phase``). Returns the
    ``knn_fused`` launches of the run, the trainer's and the gate's each
    counted on its own (``knn_cuda.counted_for``)."""
    import shutil
    import threading

    import torch

    from marl_distributedformation_tpu_torch import always_learning
    from marl_distributedformation_tpu_torch.chaos import (
        check_audit_log,
        check_budget_one,
        check_no_request_lost,
        check_step_monotonic,
    )
    from marl_distributedformation_tpu_torch.obs import (
        MetricsRegistry,
        ProgramLedger,
        set_ledger,
        set_registry,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.pipeline import (
        PromotionLog,
        RollbackMonitor,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    name = "smoke_always100"
    shutil.rmtree(ROOT / "logs" / name, ignore_errors=True)
    ctx = {"nan": None, "seen": 0, "written": set(), "forced": False,
           "steps": [],
           "outcomes": [], "share": None}
    registry, ledger = MetricsRegistry(), ProgramLedger(enabled=True)
    previous = set_registry(registry), set_ledger(ledger)
    sentinel_keys = () if bench is None else (
        "sentinel=true", f"sentinel_bench={bench[0]}")

    # Each owner's launches, counted where they are made: the trainer's
    # thread (its dispatches), the gate's evaluations (on this thread), and
    # this thread as a whole, whose launches outside the gate are the
    # trainer's reset at its construction.
    owned = {"trainer": {}, "gate": {}, "main": {}}

    def counted(fn, tally):
        def run(*args, **kwargs):
            with knn_cuda.counted_for(tally):
                return fn(*args, **kwargs)
        return run

    def on_trainer(trainer, pipeline):
        ctx["trainer"], ctx["pipeline"] = trainer, pipeline
        ctx["events"] = record_phases(trainer)
        trainer.train = counted(trainer.train, owned["trainer"])
        pipeline.gate.evaluate = counted(pipeline.gate.evaluate,
                                         owned["gate"])
        nudge = trainer.on_checkpoint

        def on_checkpoint(path):
            # On the writer thread, after the rename: after the second
            # checkpoint, a NaN candidate one step above it.
            ctx["seen"] += 1
            ctx["written"].add(checkpoint_step(path))
            if ctx["seen"] == 2 and ctx["nan"] is None:
                ctx["nan"] = write_nan_candidate(path,
                                                 checkpoint_step(path) + 1)
            nudge(path)

        trainer.on_checkpoint = on_checkpoint

    def on_fleet(pipeline, router, coordinator):
        ctx["router"], ctx["coordinator"] = router, coordinator

        def forced():
            # One served-metric regression, once two good checkpoints
            # serve (the monitor samples only then).
            if ctx["forced"]:
                return {"forced_regression": 0.0}
            ctx["forced"] = True
            return {"forced_regression": 1.0}

        pipeline.attach_monitor(RollbackMonitor(
            forced, "forced_regression", threshold=0.5, trip_after=1))
        stop = threading.Event()
        lock = threading.Lock()

        def record(result):
            with lock:
                ctx["steps"].append((time.perf_counter(),
                                     int(result.model_step)))

        def client(idx):
            import numpy as np

            rng = np.random.default_rng(idx)
            i = idx
            while not stop.is_set():
                n = ALWAYS_CLIENT_SIZES[i % len(ALWAYS_CLIENT_SIZES)]
                i += 1
                start = int(rng.integers(0, len(rows) - n + 1))
                try:
                    fut = router.submit(rows[start:start + n],
                                        on_result=record)
                except Exception as e:  # noqa: BLE001 — measured
                    with lock:
                        ctx["outcomes"].append(
                            {"ok": False, "error": repr(e), "hung": False})
                    time.sleep(0.01)
                    continue
                try:
                    fut.result(timeout=router.default_timeout_s + 5.0)
                    outcome = {"ok": True, "error": None, "hung": False}
                except TimeoutError:
                    outcome = {"ok": False, "error": "hung", "hung": True}
                except Exception as e:  # noqa: BLE001 — typed, resolved
                    outcome = {"ok": False, "error": repr(e), "hung": False}
                with lock:
                    ctx["outcomes"].append(outcome)

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        ctx["fleet_at"] = (time.perf_counter() - t0, len(ctx["events"]))

        def stop_traffic():
            # The profiled window comes after the training and the last
            # gate eval: a trace stopped while the trainer's thread
            # launched its graphs hung the process on the card (twice), so
            # it holds the R=2 fleet under the 2 clients, on this thread,
            # while the pipeline's loop sleeps.
            trainer = ctx["trainer"]
            if trainer.num_timesteps >= trainer.total_timesteps:
                ctx["share"] = profile_window(
                    lambda: time.sleep(ALWAYS_PROFILE_S),
                    f"always100, {ALWAYS_PROFILE_S} s of the R=2 fleet under "
                    "2 clients after the training (profiled; the profiler "
                    "slows the host)", 1, "window")
            stop.set()
            for t in threads:
                t.join(timeout=60.0)

        return stop_traffic

    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        with knn_cuda.counted_for(owned["main"]):
            report = always_learning.main(
                [f"name={name}", "device=cuda", *ALWAYS100,
                 *sentinel_keys],
                on_trainer=on_trainer, on_fleet=on_fleet)
    finally:
        set_registry(previous[0])
        set_ledger(previous[1])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(knn_cuda.LAUNCHES)
    trainer, pipeline = ctx["trainer"], ctx["pipeline"]
    router, coordinator = ctx["router"], ctx["coordinator"]
    trainer.phase_hook = None
    del trainer.train, pipeline.gate.evaluate
    log = Path(trainer.log_dir) / "promotions.jsonl"
    records = PromotionLog.read(log)
    gated = [r for r in records if r["event"] in ("promoted", "rejected")]
    nan_step = checkpoint_step(ctx["nan"]) if ctx["nan"] else None
    written = sorted(ctx["written"] | {nan_step} - {None})
    promoted = [r["step"] for r in records if r["event"] == "promoted"]
    rejected = [r for r in records if r["event"] == "rejected"]
    rolled = [r for r in records if r["event"] == "rolled_back"]
    served = sorted({s for _, s in ctx["steps"]})
    iterations = len(ctx["events"])
    T = pipeline.gate.program.run.__self__.T
    want_trainer = 1 + iterations * trainer.ppo.n_steps
    want_gate = pipeline.gate.cells_evaluated * (T + 1)
    reset = owned["main"]["knn_fused"] - owned["gate"]["knn_fused"]
    counts = {"trainer": owned["trainer"]["knn_fused"] + reset,
              "gate": owned["gate"]["knn_fused"],
              "knn_fused": launches["knn_fused"]}
    receipts = {f"gate:{pipeline.gate.program.guard.name}":
                pipeline.gate.program.compile_count,
                "train_iteration": trainer.retrace_guard.count}
    for i, per in router.compile_counts().items():
        receipts.update({f"replica{i}_rung{b}": c for b, c in per.items()})
    violations = (
        check_audit_log(log)
        + check_step_monotonic(ctx["steps"],
                               [r["to_step"] for r in rolled])
        + check_no_request_lost(ctx["outcomes"])
        + check_budget_one(receipts))
    problems = []
    if violations:
        problems.append(f"violations {[v.record() for v in violations]}")
    if sorted(r["step"] for r in gated) != written:
        problems.append(f"gated {[r['step'] for r in gated]} of the "
                        f"written {written}")
    if nan_step is None or [r["step"] for r in rejected
                            if "non-finite" in r["reasons"][0]] != [nan_step]:
        problems.append(f"NaN candidate {nan_step} not rejected as "
                        f"non-finite: {rejected}")
    if nan_step in pipeline.promoter.published_steps() or nan_step in served:
        problems.append(f"NaN candidate {nan_step} published or served")
    if len(promoted) < 3 or promoted != sorted(set(promoted)):
        problems.append(f"promotions {promoted}: want 3 or more, strictly "
                        "ascending")
    if len(rolled) != 1 or rolled[0]["to_step"] not in promoted[:-1]:
        problems.append(f"rollbacks {rolled}: want one, to a promoted step")
    if len([s for s in served if s in promoted]) < 2:
        problems.append(f"served steps {served}: want 2 or more promotions "
                        "served")
    if pipeline.gate.program.compile_count != 1:
        problems.append(f"gate builds {pipeline.gate.program.compile_count}")
    tiled = [t["knn_tiled"] for t in (launches, *owned.values())]
    if (counts["trainer"] != want_trainer or reset != 1
            or counts["gate"] != want_gate
            or counts["knn_fused"] != want_trainer + want_gate or any(tiled)):
        problems.append(
            f"launches {launches}: the trainer's thread "
            f"{owned['trainer']}, the gate {owned['gate']}, this thread "
            f"{owned['main']}; want trainer {want_trainer} (its reset 1 on "
            f"this thread outside the gate), gate {want_gate}, all of them "
            "and no other")
    ok = [o for o in ctx["outcomes"] if o["ok"]]
    if not ok or report.get("train_error") or report["pipeline_errors"]:
        problems.append(f"{len(ok)} client requests served; train error "
                        f"{report.get('train_error')}; pipeline errors "
                        f"{report['pipeline_errors']}")
    if problems:
        raise AssertionError("always100: " + "; ".join(problems))
    phase_ms = [(e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2]))
                for e in ctx["events"]]
    steady = phase_ms[WARM_ITERATIONS[True]:]
    s_iter = mean(a + b for a, b in steady) / 1e3
    gate_cfg = pipeline.gate.config
    print(f"[always] always100 on cuda:0 ({iterations} iterations of "
          f"gnn100's command at fused_chunk=5, gate {gate_cfg.scenarios} x "
          f"{gate_cfg.severities} at M={gate_cfg.eval_formations}, fleet "
          "R=2, 2 clients): "
          f"{wall:.1f} s; {len(gated)} candidates gated (written {written}, "
          f"the NaN one {nan_step} rejected as non-finite, never published "
          f"or served); promoted {promoted}; rolled back "
          f"{rolled[0]['from_step']} -> {rolled[0]['to_step']} through "
          f"reload_pinned; served steps {served}; gate builds 1 across "
          f"{len(gated)} candidates; check_audit_log, check_step_monotonic, "
          f"check_no_request_lost and check_budget_one: nothing; "
          f"{len(ok)} of {len(ctx['outcomes'])} client requests served")
    print(f"[always] promotion_latency_s p50 "
          f"{report['promotion_latency_s_p50']} p95 "
          f"{report['promotion_latency_s_p95']}; gate_eval_steps_per_sec "
          f"{report['gate_eval_steps_per_sec']}; stage p50s "
          f"{report['promotion_span_breakdown']}; the trainer {s_iter:.4f} "
          f"s/iteration beside gnn100's {gnn100['s_iter']:.4f} alone "
          f"({s_iter / gnn100['s_iter']:.2f}x, the cost of sharing the "
          f"card); the fleet attached {ctx['fleet_at'][0]:.1f} s into the "
          f"run, at the trainer's iteration {ctx['fleet_at'][1]}; busy "
          "share of the profiled window (the fleet after the training) "
          + (f"{ctx['share']:.1f}%" if ctx["share"] is not None
             else "not measured")
          + f"; knn_fused launches {counts['knn_fused']}, counted by "
          f"replay: the trainer {counts['trainer']} (its reset {reset} + "
          f"its thread {owned['trainer']['knn_fused']}; want 1 + "
          f"{iterations} x {trainer.ppo.n_steps}), the gate "
          f"{counts['gate']} (want {pipeline.gate.cells_evaluated} cells x "
          f"{T + 1}), none elsewhere")
    if bench is not None:
        sentinel_phase(report, registry, ledger, Path(trainer.log_dir),
                       bench)
    return counts


SENTINEL_KEYS = ("sentinel_checks", "sentinel_trips", "sentinel_missing",
                 "sentinel_never_observed", "sentinel_bench_record")


def write_bench_record(gnn100, card, fleet_p95_ms):
    """A bench record of this run's own numbers, in a temporary directory:
    ``gnn100``'s formation-steps/s (the ``train_env_steps_per_sec``
    gauge's definition), its largest capture and memory peak,
    ``fleet100``'s R=2 p95, the card's name and power limit; ``"skipped"``
    for the sentinel's fields nothing measured before phase 14. Returns
    ``(path, record)``."""
    import tempfile

    name, power_limit = (part.strip() for part in card.split(",", 1))
    record = {
        "platform": "gpu", "device": name, "power_limit": power_limit,
        "source": "chip_smoke.py phases 5 and 13 of this run",
        "train_env_steps_per_sec": gnn100["env_steps_per_sec"],
        "serving_fleet_p95_ms": fleet_p95_ms,
        "ledger_compile_seconds_max": gnn100["capture_s_max"],
        "device_memory_watermark_bytes": gnn100["watermark_bytes"],
        "gate_eval_steps_per_sec": "skipped",
        "recovery_mttr_s": "skipped",
    }
    path = Path(tempfile.mkdtemp(prefix="smoke_bench_")) / "BENCH_smoke.json"
    path.write_text(json.dumps(record))
    return path, record


def planted_sentinel(live, factor, workdir, snapshot):
    """A sentinel on ``live`` train rate x ``factor`` (a record of this
    card), checked ``trip_after`` times and once more; returns ``(trips by
    check, audit lines, flight records)``."""
    import torch

    from marl_distributedformation_tpu_torch.obs import (
        FlightRecorder,
        MetricsRegistry,
        RegressionSentinel,
        Tracer,
        default_watches,
    )

    workdir.mkdir(parents=True, exist_ok=True)
    sentinel = RegressionSentinel(
        default_watches(),
        record={"platform": "gpu", "device": torch.cuda.get_device_name(0),
                "train_env_steps_per_sec": live * factor},
        trip_after=3, audit_dir=workdir, registry=MetricsRegistry(),
        tracer=Tracer(flightrec=FlightRecorder(workdir)),
        device="cuda", device_kind=torch.cuda.get_device_name(0))
    trips = [len(sentinel.check(dict(snapshot)))
             for _ in range(sentinel.trip_after + 1)]
    audit = workdir / RegressionSentinel.AUDIT_NAME
    lines = audit.read_text().splitlines() if audit.exists() else []
    dumps = sorted(workdir.glob("flightrec-perf_regression-*.json"))
    return trips, lines, dumps


def sentinel_phase(report, registry, ledger, log_dir, bench):
    """The regression sentinel inside ``always100`` (its report's
    ``sentinel_*`` keys, against this run's record ``bench``), then two
    planted records on the registry ``always100`` filled: 10x its live
    training rate trips exactly once and stays latched, 0.1x never
    trips."""
    path, record = bench
    problems = [f"report lacks {k}" for k in SENTINEL_KEYS
                if k not in report]
    missing = report.get("sentinel_missing", {})
    if report.get("sentinel_checks", 0) < 1:
        problems.append(f"sentinel_checks {report.get('sentinel_checks')}")
    if report.get("sentinel_bench_record") != str(path):
        problems.append(f"sentinel_bench_record "
                        f"{report.get('sentinel_bench_record')}, want {path}")
    if "train_env_steps_per_sec" in missing:
        problems.append(f"the record was not used: {missing}")
    audit = log_dir / "perf_incidents.jsonl"
    trips = ([json.loads(x) for x in audit.read_text().splitlines()]
             if audit.exists() else [])
    if len(trips) != report.get("sentinel_trips"):
        problems.append(f"{len(trips)} audit lines for "
                        f"{report.get('sentinel_trips')} trips")
    snapshot = {**registry.snapshot(), **ledger.snapshot()}
    live = snapshot.get("train_env_steps_per_sec")
    planted = {}
    if not live:
        problems.append(f"no live train_env_steps_per_sec: {live}")
    else:
        for factor in (10.0, 0.1):
            planted[factor] = planted_sentinel(
                live, factor, log_dir / f"sentinel_x{factor:g}", snapshot)
        trips10, lines10, dumps10 = planted[10.0]
        if trips10 != [0, 0, 1, 0] or len(lines10) != 1 or len(dumps10) != 1:
            problems.append(f"10x record: trips by check {trips10}, "
                            f"{len(lines10)} audit lines, {len(dumps10)} "
                            "flight records; want [0, 0, 1, 0], 1, 1")
        trips01, lines01, dumps01 = planted[0.1]
        if any(trips01) or lines01 or dumps01:
            problems.append(f"0.1x record tripped: {trips01}")
    if problems:
        raise AssertionError("sentinel: " + "; ".join(problems))
    print(f"[sentinel] {record['device']}, {record['power_limit']}: "
          f"always100 checked {report['sentinel_checks']} times against "
          f"this run's record {path.name} (train "
          f"{record['train_env_steps_per_sec']:.1f} formation-steps/s, "
          f"fleet R=2 p95 {record['serving_fleet_p95_ms']:.3f} ms, capture "
          f"max {record['ledger_compile_seconds_max']:.3f} s, peak "
          f"{record['device_memory_watermark_bytes'] / 2**30:.2f} GiB); "
          f"{report['sentinel_trips']} trips (not gated: the trainer "
          "shares the card)"
          + "".join(f"; {t['gauge']} live {t['live']:.4g} against recorded "
                    f"{t['recorded']:.4g} (limit {t['limit']:.4g})"
                    for t in trips)
          + f"; missing {sorted(missing)}; never observed "
          f"{report['sentinel_never_observed']}; planted on the live "
          f"{live:.1f}: 10x trips by check {planted[10.0][0]} with 1 audit "
          f"line and 1 flight record, 0.1x {planted[0.1][0]}")


def pursuit_rows(m=1024):
    """Request rows for ``chase100``'s lane: pursuit-evasion at N=100,
    k=4, reset, observations through ``knn_fused``. Returns ``(rows (m,
    100, 20) numpy, knn_fused launches)``."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.envs import (
        PursuitParams,
        spec_for_params,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    params = PursuitParams(num_agents=100, obs_mode="knn", knn_k=4)
    spec = spec_for_params(params)
    gen = torch.Generator(device="cuda").manual_seed(13)
    knn_cuda.reset_launches()
    state = spec.reset_batch(params, m, gen, torch.device("cuda"))
    rows = spec.obs(state, params).cpu().numpy()
    launches = knn_cuda.LAUNCHES["knn_fused"]
    if launches != 1 or not np.isfinite(rows).all():
        raise AssertionError(f"pursuit rows: {launches} knn_fused launches, "
                             "want 1, and finite observations")
    return rows, launches


def tenants100(gnn100_ckpt, scen100_ckpt, chase100_ckpt, rows):
    """``tenants100``: a ``TenantFleet`` at R=1 on ``cuda:0`` over the lanes
    ``formation-a`` (``gnn100``'s checkpoint), ``formation-b``
    (``scen100``'s), ``pursuit`` (``chase100``'s) and ``ring-mlp`` (the
    committed MLP checkpoint, another architecture): one capture a (arch,
    rung); each lane's deterministic actions, each request served alone,
    equal a single engine's bitwise; a batch storm on ``formation-a`` with
    a swap of ``formation-a`` in it leaves ``formation-b`` admitted with
    no 429 and every lane's step monotonic. Returns the request rows'
    ``knn_fused`` launches."""
    import shutil

    import numpy as np

    from marl_distributedformation_tpu_torch import serve as serve_cli
    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )
    from marl_distributedformation_tpu_torch.serving.tenancy import (
        TenantDirectory,
        run_tenant_smoke,
        tenant_fleet_from_directory,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    p_rows, p_launches = pursuit_rows()
    lanes = {"formation-a": (gnn100_ckpt, rows),
             "formation-b": (scen100_ckpt, rows),
             "pursuit": (chase100_ckpt, p_rows),
             "ring-mlp": (CKPT, ring_rows())}
    base = ROOT / "logs" / "smoke_tenants100"
    shutil.rmtree(base, ignore_errors=True)
    specs = []
    for mid, (ckpt, _) in lanes.items():
        promoted = base / mid / "promoted"
        promoted.mkdir(parents=True)
        shutil.copy(ckpt, promoted / Path(ckpt).name)
        config = Path(ckpt).parent / "config.json"
        if config.exists():  # the run's env params, as serve reads them
            shutil.copy(config, base / mid / "config.json")
        specs.append(serve_cli._lane_spec(mid, str(promoted), None))
    directory = TenantDirectory(specs)
    fleet = tenant_fleet_from_directory(
        directory, device="cuda", num_replicas=1, buckets=SERVE_BUCKETS)
    t0 = time.perf_counter()
    fleet.warmup()
    capture_s = time.perf_counter() - t0
    groups = directory.arch_groups()
    census = fleet.shared_rung_compiles()
    want = {f"{arch}:rung{b}": 1 for arch in groups for b in SERVE_BUCKETS}
    if census != want:
        raise AssertionError(f"tenants100: census {census}, want {want}")
    swap_src = scen100_ckpt
    swap_step = max(checkpoint_step(c) for c, _ in lanes.values()) + 1
    coord = fleet.coordinators["formation-a"]
    swapped = {}

    def mid_storm():
        target = (directory.get("formation-a").promoted_dir
                  / f"rl_model_{swap_step}_steps.msgpack")
        shutil.copy(swap_src, target.parent / ".incoming.tmp")
        (target.parent / ".incoming.tmp").replace(target)
        swapped["ok"] = coord.refresh()

    with fleet:
        # Each request alone (one sequential client): a lane's actions
        # against a single engine of its own checkpoint, rung by rung.
        for mid, (ckpt, pool) in lanes.items():
            spec = directory.get(mid)
            engine = BucketedPolicyEngine(
                LoadedPolicy.from_checkpoint(
                    ckpt, env_params=spec.env_params(), device="cuda"),
                buckets=SERVE_BUCKETS)
            for b in SERVE_BUCKETS:
                got = fleet.submit(pool[:b], model_id=mid).result(
                    timeout=60).actions
                if not np.array_equal(got, engine.act(pool[:b])):
                    raise AssertionError(f"tenants100: lane {mid} rung {b} "
                                         "differs from a single engine")
        report = run_tenant_smoke(
            fleet, sizes=(1, 3, 8, 9, 40, 100), duration_s=TENANT_DURATION_S,
            clients_per_lane=2, storm_lane="formation-a", storm_clients=3,
            mid_storm=mid_storm, mid_storm_at_s=TENANT_DURATION_S / 4,
            warmup=False, row_pools={m: pool for m, (_, pool) in
                                     lanes.items()})
    problems = []
    if not swapped.get("ok"):
        problems.append(f"no swap: {list(coord.load_errors)}")
    for mid in lanes:
        if (report[f"model_{mid}__requests_ok"] == 0
                or report[f"model_{mid}__step_monotonic_violations"]
                or report[f"model_{mid}__failed"]
                or report[f"model_{mid}__timed_out"]):
            problems.append(f"lane {mid}: {report}")
    if report["model_formation-b__rejected"]:
        problems.append("formation-b saw 429s under formation-a's storm")
    if report["model_formation-a__step_max"] != swap_step:
        problems.append(f"formation-a ended at step "
                        f"{report['model_formation-a__step_max']}")
    if fleet.shared_rung_compiles() != want:
        problems.append(f"captures after traffic {fleet.shared_rung_compiles()}")
    if problems:
        raise AssertionError("tenants100: " + "; ".join(problems))
    print(f"[tenants] tenants100 on cuda:0, R=1, {len(lanes)} lanes in "
          f"{len(groups)} arch groups ("
          + "; ".join(f"{arch}: {', '.join(s.model_id for s in specs)}"
                      for arch, specs in groups.items())
          + f"): one capture a (arch, rung) ({capture_s:.2f} s); each lane's "
          f"deterministic actions == a single engine's bitwise at rungs "
          f"{SERVE_BUCKETS}, each request alone; a {TENANT_DURATION_S} s "
          f"storm (2 interactive clients a lane, 3 batch clients on "
          f"formation-a from the second half) with formation-a swapped to "
          f"step {swap_step} in it: formation-b rejected 0, every lane's "
          f"step monotonic, isolation p95 ratio "
          f"{report['tenant_isolation_p95_ratio']:.3f}")
    print("[tenants] requests/s and p95 ms by lane: " + "; ".join(
        f"{mid} {report[f'model_{mid}__requests_per_sec']:.1f}, "
        f"{report[f'model_{mid}__latency_p95_ms']:.3f}" for mid in lanes))
    return p_launches


def pipeline_phase(gnn100, scen100_ckpt, card, fleet_p95_ms):
    """Phase 14: ``always100`` with the regression sentinel against a
    record of this run (``card``: ``nvidia-smi``'s name and power limit;
    ``fleet_p95_ms``: phase 13's R=2 p95), and ``tenants100``. Returns
    the launches of each path."""
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        latest_checkpoint,
    )

    rows, row_launches = serve_rows()
    bench = write_bench_record(gnn100, card, fleet_p95_ms)
    # always100 hung once (no stack): its budget is 240 s.
    with hang_dump("always100", 300.0):
        always = always100(gnn100, rows, bench=bench)
    elapsed("always100")
    chase100_ckpt = latest_checkpoint(ROOT / "logs" / "smoke_chase100")
    tenant_launches = tenants100(gnn100["ckpt"], scen100_ckpt,
                                 chase100_ckpt, rows)
    elapsed("tenants100")
    return {"always": always, "rows": row_launches + tenant_launches}


# Phase 15: the chaos storm. storm100 is gnn100's command (its
# total_timesteps aside: the campaign sets its own), the train and Sebulba
# campaigns run it at M=64.
STORM100 = GNN100[:-1]
STORM64 = tuple("num_formation=64" if o.startswith("num_formation=") else o
                for o in STORM100)
STORM_ITERATIONS = 10  # storm100's train leg (JAX's default: 16)
# The wedge and the gate's deadline: the deadline above the healthy gate
# evals measured on the card (0.09-0.52 s: PERF.md §6), the wedge (JAX's
# test's) above the deadline and the pipeline watchdog's 1 s, so wedges
# still time out and restart (JAX's test's deadline: 0.6 s).
STORM_WEDGE_S, STORM_GATE_TIMEOUT_S = 1.2, 0.9
STORM_STEPS = 10  # gnn100's n_steps: the trainer's launches an iteration
STORM_GATE_M = 8  # the storm's gate: JAX's eval_formations
STORM_CELL_LAUNCHES = 23  # a gate cell's knn_fused launches: T + 1, T = 22


def storm_line(label, report, keys):
    print(f"[storm] {label}: " + ", ".join(
        f"{k} {report.get(k)}" for k in keys))


def storm100(work):
    """``run_campaign(seed=7, faults=25)`` over ``gnn100``'s command; the
    trainer's and the gate's ``knn_fused`` launches each counted on the
    threads that make them (``knn_cuda.counted_for``)."""
    from marl_distributedformation_tpu_torch import chaos_storm
    from marl_distributedformation_tpu_torch.ops import knn_cuda
    from marl_distributedformation_tpu_torch.pipeline.gate import (
        PromotionGate,
    )
    from marl_distributedformation_tpu_torch.train import Trainer

    owned = {"trainer": {}, "gate": {}}
    patched = {(Trainer, "train"): owned["trainer"],
               (PromotionGate, "_evaluate_inner"): owned["gate"]}
    originals = {key: getattr(*key) for key in patched}

    def counted(fn, tally):
        def run(*args, **kwargs):
            with knn_cuda.counted_for(tally):
                return fn(*args, **kwargs)
        return run

    for (cls, name), tally in patched.items():
        setattr(cls, name, counted(originals[(cls, name)], tally))
    knn_cuda.reset_launches()
    try:
        report = chaos_storm.run_campaign(
            seed=7, faults=25, workdir=str(work / "storm100"),
            train_iterations=STORM_ITERATIONS, wedge_s=STORM_WEDGE_S,
            gate_timeout_s=STORM_GATE_TIMEOUT_S, device="cuda",
            overrides=STORM100)
    finally:
        for (cls, name), fn in originals.items():
            setattr(cls, name, fn)
    total = knn_cuda.LAUNCHES["knn_fused"]
    counts = {k: v["knn_fused"] for k, v in owned.items()}
    storm_line("storm100", report, (
        "chaos_invariant_violations", "chaos_faults_fired",
        "chaos_faults_unfired", "chaos_mttr_p50_s", "chaos_mttr_s",
        "chaos_disruptions", "probes_total", "probes_ok", "promotions",
        "rejections", "gate_timeouts", "gate_timeout_s", "gate_eval_s_max",
        "pipeline_restarts", "train_writes_skipped",
        "checkpoints_quarantined", "resume_step",
        "fault_plane_overhead_pct", "compile_receipts",
        "campaign_seconds"))
    if report["chaos_invariant_violations"] != 0:
        raise AssertionError(f"storm100 violations: "
                             f"{report.get('chaos_violations')}")
    expected = chaos_storm.build_schedule(7, 25, wedge_s=STORM_WEDGE_S)
    checks = {
        "25 fired": report["chaos_faults_fired"] == 25,
        "0 unfired": report["chaos_faults_unfired"] == 0,
        "resume_ok": report["resume_ok"],
        "0 < MTTR < 60 s": 0.0 < report.get("chaos_mttr_s", 0.0) < 60.0,
        "overhead < 5%": report["fault_plane_overhead_pct"] < 5.0,
        "probes served": report["probes_ok"] > 0,
        "deterministic section": report["deterministic"] == {
            "chaos_seed": 7, "chaos_faults_armed": 25,
            "schedule": expected.record()},
        "one build a program": (
            report["compile_receipts"]["gate_matrix"] == 1
            and set(report["compile_receipts"].values()) == {1}
            and len(report["compile_receipts"]) == 5),
        "a wedge timed out": report["gate_timeouts"] >= 1,
        "healthy evals under the deadline": (
            report["gate_eval_s_max"] is not None
            and report["gate_eval_s_max"] < STORM_GATE_TIMEOUT_S),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"storm100 fails {failed}: {report}")
    # The trainer's iterations x n_steps on its thread; the gate's T + 1 a
    # cell on whichever thread evaluates (T = 22, the storm's max_steps of
    # 20 + 2, as 1,002 for 1,000); besides, the trainer's reset and the
    # probe's formation on this thread (which also runs the bootstrap
    # eval, counted with the gate's).
    want = {"trainer": STORM_ITERATIONS * STORM_STEPS,
            "gate": STORM_CELL_LAUNCHES * report["gate_cells_evaluated"]}
    rest = total - counts["trainer"] - counts["gate"]
    print(f"[storm] storm100 knn_fused launches: {total} in all, trainer "
          f"{counts['trainer']} (want {want['trainer']}), gate "
          f"{counts['gate']} (want {want['gate']}, "
          f"{report['gate_cells_evaluated']} cells x "
          f"{STORM_CELL_LAUNCHES}), the rest {rest} (want 2)")
    if (counts["trainer"] != want["trainer"] or counts["gate"] != want["gate"]
            or rest != 2):
        raise AssertionError(f"storm100 launches {counts}, total {total}, "
                             f"want {want} and 2 more")
    return report, {"knn_fused": total, **counts}


def storm_train100(work):
    """``run_train_campaign(seed=2, faults=10)`` at N=100, k=4, GNN, M=64
    with JAX's test's assertions."""
    from marl_distributedformation_tpu_torch import chaos_storm
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    knn_cuda.reset_launches()
    report = chaos_storm.run_train_campaign(
        seed=2, faults=10, workdir=str(work / "storm_train100"),
        device="cuda", overrides=STORM64)
    storm_line("storm_train100", report, (
        "chaos_invariant_violations", "chaos_faults_fired",
        "chaos_faults_unfired", "recovery_mttr_p50_s", "recovery_mttr_s",
        "train_recoveries", "train_divergence_events",
        "train_skipped_updates", "train_halted", "train_writes_skipped",
        "checkpoints_nonfinite_skipped", "checkpoints_quarantined",
        "train_compiles", "final_timesteps", "campaign_seconds"))
    expected = chaos_storm.build_schedule(
        2, 10,
        point_names=chaos_storm.TRAIN_LANE_POINTS + chaos_storm.TRAIN_POINTS)
    checks = {
        "0 violations": report["chaos_invariant_violations"] == 0,
        "10 fired": report["chaos_faults_fired"] == 10,
        "0 unfired": report["chaos_faults_unfired"] == 0,
        "not halted": not report["train_halted"],
        "a recovery": report["train_recoveries"] >= 1,
        "0 < MTTR < 60 s": 0.0 < report.get("recovery_mttr_s", 0.0) < 60.0,
        "deterministic section": report["deterministic"] == {
            "chaos_seed": 2, "chaos_faults_armed": 10,
            "schedule": expected.record()},
        "one build": report["train_compiles"] == 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"storm_train100 fails {failed}: {report}")
    launches = knn_cuda.LAUNCHES["knn_fused"]
    print(f"[storm] storm_train100 knn_fused launches: {launches}")
    if launches <= 0:
        raise AssertionError("storm_train100 launched no knn_fused")
    return report, {"knn_fused": launches}


def storm_sebulba100(work):
    """``run_sebulba_campaign(seed=0, faults=12)`` at N=100, k=4, GNN,
    M=64."""
    from marl_distributedformation_tpu_torch import chaos_storm
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    knn_cuda.reset_launches()
    report = chaos_storm.run_sebulba_campaign(
        seed=0, faults=12, workdir=str(work / "storm_sebulba100"),
        device="cuda", overrides=STORM64)
    storm_line("storm_sebulba100", report, (
        "chaos_invariant_violations", "chaos_faults_fired",
        "chaos_faults_unfired", "sebulba_batches_enqueued",
        "sebulba_batches_dropped", "sebulba_duplicates_absorbed",
        "sebulba_dequeue_raises_fired", "sebulba_publishes_dropped",
        "sebulba_stale_dropped", "sebulba_batches_consumed",
        "transfer_queue_occupancy_p95", "param_staleness_p95_updates",
        "sebulba_actor_compiles", "sebulba_learner_compiles",
        "final_timesteps", "campaign_seconds"))
    checks = {
        "0 violations": report["chaos_invariant_violations"] == 0,
        "12 fired": report["chaos_faults_fired"] == 12,
        "0 unfired": report["chaos_faults_unfired"] == 0,
        "a duplicate absorbed": (report["sebulba_dequeue_raises_fired"] == 0
                                 or report["sebulba_duplicates_absorbed"]
                                 >= 1),
        "one build a lane": (report["sebulba_actor_compiles"] == 1
                             and report["sebulba_learner_compiles"] == 1),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"storm_sebulba100 fails {failed}: {report}")
    launches = knn_cuda.LAUNCHES["knn_fused"]
    print(f"[storm] storm_sebulba100 knn_fused launches: {launches}")
    if launches <= 0:
        raise AssertionError("storm_sebulba100 launched no knn_fused")
    return report, {"knn_fused": launches}


def storm_phase():
    """Phase 15: the three campaigns in turn, each with a fresh metrics
    registry and ledger. Returns each one's ``knn_fused`` launches."""
    import tempfile

    from marl_distributedformation_tpu_torch.obs import (
        MetricsRegistry,
        ProgramLedger,
        set_ledger,
        set_registry,
    )

    work = Path(tempfile.mkdtemp(prefix="chaos_storm_"))
    launches = {}
    for label, run in (("storm100", storm100),
                       ("storm_train100", storm_train100),
                       ("storm_sebulba100", storm_sebulba100)):
        previous = set_registry(MetricsRegistry()), set_ledger(
            ProgramLedger(enabled=True))
        t0 = time.perf_counter()
        try:
            _, launches[label] = run(work)
        finally:
            set_registry(previous[0])
            set_ledger(previous[1])
        print(f"[storm] {label} wall {time.perf_counter() - t0:.1f} s")
    return launches


# Phase 16: data parallelism over formations and the agent-axis ring
# (parallel/), on one card. dp100x1 is gnn100's command for 3 iterations,
# mesh={dp: 1}, in a one-rank NCCL group in this process; dp100x2 the same
# command at mesh={dp: 2}, two ranks on cuda:0 (gloo on the card's
# tensors) started by parallel.launch, held against gnn100 after 2
# iterations and timed over 3 more; ring100x2 make_ring_step at N=100,
# k=4, M=64, sp=2 on the same two ranks against step_batch for 8 steps
# (tests/test_parallel.py:99-135's tolerances).
GNN100_ITERATION = 10 * 1024 * 100  # agent-transitions an iteration
DP100 = GNN100[:-1]
DP100X1 = DP100 + (f"total_timesteps={3 * GNN100_ITERATION}",
                   "mesh={dp: 1}")
DP100X2 = DP100 + (f"total_timesteps={5 * GNN100_ITERATION}",
                   "mesh={dp: 2}")
DP_COMPARE_AT, DP_TIMED = 2, 3
# dp100x2's gate after 2 iterations: JAX's own tolerance for dp against the
# single run (tests/test_parallel.py:45-66) on every leaf but the policy's
# own (log_std, actor.*), which are held to DP_POLICY_ATOL absolute. Their
# gradient is the clipped surrogate's alone. The ranks' forward passes run
# on half the rows, so their rounding differs from the single run's, and
# a row whose ratio lies within that rounding of 1 +- clip_range takes the
# clipped branch in one run and not in the other: the row's term of a
# 16384-row mean leaves or joins a gradient that is mostly noise, and Adam
# carries it into the step. DP_POLICY_ATOL is 3.4x the largest such drift
# measured on the card (5.817e-5 on log_std); with the clip out of reach
# (clip_range=1e6) every leaf holds JAX's tolerance, and a rank's doubled
# loss share or advantages normalised a rank fail the gate (PERF.md,
# chip_ab.py --cell dp100x2).
DP_RTOL, DP_ATOL = 1e-4, 1e-6
DP_POLICY_ATOL = 2e-4
RING100 = {"num_agents": 100, "knn_k": 4, "M": 64, "steps": 8}


def keep_params(trainer, at):
    """Device copies of ``trainer``'s parameters after each iteration in
    ``at`` (queued behind it on the caller's stream, no sync), taken at
    the "end" mark of ``trainer.phase_hook``; returns the dict they go
    into."""
    kept, count = {}, [0]
    inner = trainer.phase_hook

    def hook(phase):
        if inner is not None:
            inner(phase)
        if phase == "end":
            count[0] += 1
            if count[0] in at:
                kept[count[0]] = {k: p.detach().clone() for k, p in
                                  trainer.model.named_parameters()}

    trainer.phase_hook = hook
    return kept


def params_digest(named):
    """A digest of a model's parameter bytes (ranks compare theirs)."""
    import hashlib

    h = hashlib.sha256()
    for k, p in sorted(named.items()):
        h.update(k.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def policy_leaf(name):
    """Whether a parameter is the policy's own (its gradient is the
    clipped surrogate's alone)."""
    return name == "log_std" or name.startswith("actor.")


def params_error(got, want, label=None):
    """``(max abs error, elements beyond DP_RTOL/DP_ATOL, leaves beyond
    dp100x2's gate)`` over every leaf; with ``label``, a line a leaf: its
    max abs error, its largest value and its elements beyond JAX's
    tolerance."""
    err, beyond, failing = 0.0, 0, []
    for k, w in want.items():
        g, w = got[k].detach().to(w.device), w.detach()
        diff = (g - w).abs()
        top = float(diff.max())
        err = max(err, top)
        out = int((diff > DP_ATOL + DP_RTOL * w.abs()).sum())
        beyond += out
        if (not top <= DP_POLICY_ATOL) if policy_leaf(k) else out:
            failing.append(f"{k} {top:.3e}")
        if label is not None:
            print(f"[dp] {label} {k} {tuple(w.shape)}: max abs {top:.3e}, "
                  f"max |w| {float(w.abs().max()):.3e}, {out} of "
                  f"{w.numel()} beyond rtol {DP_RTOL} atol {DP_ATOL}")
    return err, beyond, failing


def ring_check(mesh, dev):
    """``ring100x2`` on this rank: ``make_ring_step`` on its slab against
    its rows of ``step_batch``, 8 steps through auto-resets; returns the
    max errors and whether each is within its tolerance."""
    import torch

    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.env.formation import (
        reset_batch,
        step_batch,
    )
    from marl_distributedformation_tpu_torch.parallel import (
        make_ring_step,
        place_ring_state,
    )

    params = EnvParams(num_agents=RING100["num_agents"], obs_mode="knn",
                       knn_k=RING100["knn_k"], max_steps=3)
    m = RING100["M"]
    g_ref = torch.Generator(device=dev).manual_seed(7)
    g_ring = torch.Generator(device=dev).manual_seed(7)
    g_vel = torch.Generator(device=dev).manual_seed(11)
    ref = reset_batch(params, m, g_ref, dev)
    ring = place_ring_state(reset_batch(params, m, g_ring, dev), mesh)
    step = make_ring_step(params, mesh)
    tol = {"obs": (1e-5, 1e-6), "reward": (1e-4, 1e-4),
           "metrics": (1e-4, 1e-4), "agents": (1e-5, 1e-5)}
    err = dict.fromkeys(tol, 0.0)
    ok = dict.fromkeys(tol, True)
    done_equal = True

    def note(key, got, want):
        err[key] = max(err[key], float((got - want).abs().max()))
        rtol, atol = tol[key]
        ok[key] = ok[key] and bool(torch.allclose(got, want, rtol=rtol,
                                                  atol=atol))

    for _ in range(RING100["steps"]):
        vel = 20 * torch.rand((m, params.num_agents, 2), generator=g_vel,
                              device=dev) - 10
        ref, tr_ref = step_batch(ref, vel, params, g_ref)
        ring, tr = step(ring, mesh.take(vel), g_ring)
        note("obs", tr.obs, mesh.take(tr_ref.obs))
        note("reward", tr.reward, mesh.take(tr_ref.reward))
        note("agents", ring.agents, mesh.take(ref.agents))
        for k, v in tr_ref.metrics.items():
            note("metrics", tr.metrics[k], v)
        done_equal = done_equal and bool(torch.equal(tr.done, tr_ref.done))
    return {"max_abs_err": err, "within": ok, "done_bitwise": done_equal,
            "ok": all(ok.values()) and done_equal}


def plant_fault(name):
    """A deliberate fault in this rank's loss, to show that dp100x2's gate
    can fail: ``share`` doubles rank 1's loss share, ``advnorm``
    normalises the advantages over the rank's rows instead of the whole
    minibatch."""
    import dataclasses

    from marl_distributedformation_tpu_torch.algo import ppo
    from marl_distributedformation_tpu_torch.parallel import distributed

    loss_fn = ppo.ppo_loss

    def planted(model, mb, config, ent_coef=None, rows=None):
        if name == "share":
            loss, metrics = loss_fn(model, mb, config, ent_coef, rows)
            return (2 * loss if distributed.process_index() == 1
                    else loss), metrics
        if rows is None:
            return loss_fn(model, mb, config, ent_coef, rows)
        start, count = rows
        adv = mb.advantages.clone()
        own = adv.narrow(0, start, count)
        own.copy_((own - own.mean()) / (own.std() + 1e-8))
        return loss_fn(model, dataclasses.replace(mb, advantages=adv),
                       dataclasses.replace(config, normalize_advantage=False),
                       ent_coef, rows)

    ppo.ppo_loss = planted


def collectives_check(dev):
    """The port's all-reduce, all-gather and broadcast on the card's
    tensors as they are, each result checked (raises when one is wrong)."""
    import torch

    from marl_distributedformation_tpu_torch.parallel import distributed

    rank = distributed.process_index()
    got = {
        "all_reduce": distributed.all_reduce_sum(
            torch.full((4,), rank + 1.0, device=dev)),
        "all_gather": distributed.all_gather(
            torch.full((4,), float(rank), device=dev)),
        "broadcast": distributed.broadcast_(
            torch.full((4,), rank + 7.0, device=dev)),
    }
    want = {"all_reduce": torch.full((4,), 3.0),
            "all_gather": torch.tensor([[0.0] * 4, [1.0] * 4]),
            "broadcast": torch.full((4,), 7.0)}
    for k, v in got.items():
        if not (v.is_cuda and torch.equal(v.cpu(), want[k])):
            raise AssertionError(f"rank {rank}: gloo {k} on the card gave "
                                 f"{v.tolist()}")
    return sorted(got)


def allreduce_ms(dev, numel, reps=100):
    """Mean ms of one gloo all-reduce of ``numel`` float32 values on the
    card, two ways in alternating blocks: the card's tensor as it is (the
    port's path) and through a fresh pinned host copy (copied down, the
    stream synchronized, reduced, copied back)."""
    import torch
    import torch.distributed as dist

    t = torch.zeros(numel, device=dev)
    ms = {"direct": 0.0, "staged": 0.0}
    for block in range(4):
        for way in sorted(ms, reverse=block % 2 == 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                if way == "direct":
                    dist.all_reduce(t)
                    continue
                host = torch.empty(numel, pin_memory=True)
                host.copy_(t, non_blocking=True)
                torch.cuda.current_stream(dev).synchronize()
                dist.all_reduce(host)
                t.copy_(host, non_blocking=True)
            torch.cuda.synchronize()
            ms[way] += (time.perf_counter() - t0) * 1e3 / reps / 4
    return ms


def dp_worker(argv):
    """One rank of ``dp100x2`` and ``ring100x2``, started by
    ``parallel.launch`` (``python3 chip_smoke.py --dp-worker <dir>
    [--plant NAME] [override ...]``): prints one ``DPWORKER {json}``
    line."""
    import torch

    sys.path.insert(0, str(ROOT))
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda
    from marl_distributedformation_tpu_torch.parallel import (
        make_mesh,
        shutdown_distributed,
    )
    from marl_distributedformation_tpu_torch.parallel import distributed
    from marl_distributedformation_tpu_torch.train import cli

    out_dir, extra = argv[0], list(argv[1:])
    if extra[:1] == ["--plant"]:
        plant_fault(extra[1])
        extra = extra[2:]
    _build.build([knn_cuda.SOURCE])  # built in phase 1: loads it
    knn_cuda.reset_launches()
    trainer = cli.build_trainer(["name=smoke_dp100x2", "device=cuda",
                                 *DP100X2, *extra])
    rank, dev = distributed.process_index(), trainer.device
    block = tuple(trainer.env_state.agents.shape)
    if block != (512, 100, 2):
        raise AssertionError(f"rank {rank}: block {block}, want 512x100x2")
    named = dict(trainer.model.named_parameters())
    reward_1 = None
    for i in range(1, DP_COMPARE_AT + 1):
        metrics = trainer.run_iteration()
        if reward_1 is None:
            reward_1 = float(metrics["reward"])
        if rank == 0:
            torch.save({k: p.detach().cpu() for k, p in named.items()},
                       Path(out_dir) / f"params_{i}.pt")
    torch.cuda.synchronize()
    digest = params_digest(named)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(DP_TIMED):
        trainer.run_iteration()
    end.record()
    torch.cuda.synchronize()
    s_iter = start.elapsed_time(end) / 1e3 / DP_TIMED
    launches = dict(knn_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    collectives = collectives_check(dev)
    numel = sum(p.numel() for p in trainer.model.parameters())
    allreduce = allreduce_ms(dev, numel)
    knn_cuda.reset_launches()
    ring = ring_check(make_mesh({"dp": 1, "sp": 2}), dev)
    print("DPWORKER " + json.dumps({
        "rank": rank, "backend": distributed.backend(),
        "block": list(block),
        "launches": launches, "digest": digest, "s_iter": s_iter,
        "peak_gib": peak, "collectives": collectives,
        "allreduce_numel": numel, "allreduce_ms": allreduce,
        "graphs": trainer.graph_count(), "ring": ring,
        "reward_1": reward_1,
        "steps_per_iteration": trainer.step // (DP_COMPARE_AT + DP_TIMED),
    }), flush=True)
    shutdown_distributed()
    return 0


def dp100x1(gnn100):
    """``dp100x1``: gnn100's command at mesh={dp: 1} through the train CLI
    in a one-rank NCCL group in this process, 3 iterations, against
    gnn100's parameters after 3: bitwise (one rank keeps the single run's
    reductions)."""
    import os

    from marl_distributedformation_tpu_torch.parallel import distributed
    from marl_distributedformation_tpu_torch.parallel.launch import (
        free_port,
    )

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
                      MASTER_PORT=str(free_port()))
    try:
        trainer, _, launches, s_iter = train_run(
            "smoke_dp100x1", DP100X1, "dp100x1 mesh={dp: 1} M=1024 N=100, "
            "a one-rank NCCL group")
        if distributed.backend() != "nccl":
            raise AssertionError(f"dp100x1 backend {distributed.backend()}")
        named = dict(trainer.model.named_parameters())
        want = gnn100["params_at"][3]
        equal = all(bool((named[k] == w).all()) for k, w in want.items())
        err, _, _ = params_error(named, want)  # the gap when not equal
        if not equal:
            raise AssertionError(f"dp100x1 parameters differ from gnn100's "
                                 f"after 3 iterations: max abs {err}")
        if launches != {"knn_fused": 31, "knn_tiled": 0}:
            raise AssertionError(f"dp100x1 launches {launches}, want 31")
        print(f"[dp] dp100x1: parameters after 3 iterations equal gnn100's "
              f"bitwise; {s_iter:.4f} s/iteration steady against gnn100's "
              f"{gnn100['s_iter']:.4f} ({s_iter / gnn100['s_iter']:.3f}x), "
              f"{trainer.graph_count()} graphs; knn_fused {launches} "
              "launches at (1024,100,4)")
        return launches["knn_fused"]
    finally:
        distributed.shutdown_distributed()
        for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE",
                    "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(key, None)


def dp100x2(gnn100, plant=None, extra=()):
    """``dp100x2`` and ``ring100x2``: two ranks on cuda:0 started by
    ``parallel.launch``, with ``plant_fault(plant)`` and the train
    overrides ``extra`` when given; returns each rank's ``knn_fused``
    launches and the slower rank's s/iteration."""
    import shutil

    import torch

    from marl_distributedformation_tpu_torch.parallel.launch import launch

    out_dir = ROOT / "logs" / "smoke_dp100x2"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    planted = ["--plant", plant] if plant else []
    results = launch([str(ROOT / "chip_smoke.py"), "--dp-worker",
                      str(out_dir), *planted, *extra], nprocs=2, timeout=240,
                     cwd=str(ROOT))
    wall = time.perf_counter() - t0
    reports = []
    for rank, (code, out) in enumerate(results):
        lines = [ln for ln in out.splitlines() if ln.startswith("DPWORKER ")]
        if code != 0 or not lines:
            print(out[-4000:])
            raise AssertionError(f"dp100x2 rank {rank} failed (exit {code})")
        reports.append(json.loads(lines[-1][len("DPWORKER "):]))
    errs = {}
    for i in range(1, DP_COMPARE_AT + 1):
        errs[i] = params_error(
            torch.load(out_dir / f"params_{i}.pt"), gnn100["params_at"][i],
            f"dp100x2 after {i} iteration(s):" if i == DP_COMPARE_AT
            else None)
    err, beyond, failing = errs[DP_COMPARE_AT]
    if failing:
        raise AssertionError(f"dp100x2 parameters after {DP_COMPARE_AT} "
                             f"iterations beyond the gate (rtol {DP_RTOL} "
                             f"atol {DP_ATOL}; the policy's leaves "
                             f"{DP_POLICY_ATOL} absolute): {failing}")
    # Before any update the rollouts differ only by the rounding of the
    # GNN's matmuls on half the formations (as pop4's member 0, phase 6).
    r1, want1 = reports[0]["reward_1"], gnn100["rewards"][0]
    if not abs(r1 - want1) <= ITER1_RTOL * abs(want1):
        raise AssertionError(f"dp100x2 iteration 1 reward {r1} != gnn100's "
                             f"{want1} within rtol {ITER1_RTOL}")
    digests = {r["digest"] for r in reports}
    if len(digests) != 1:
        raise AssertionError(f"dp100x2 ranks hold different parameters: "
                             f"{digests}")
    want = 1 + (DP_COMPARE_AT + DP_TIMED) * 10
    for r in reports:
        if r["launches"] != {"knn_fused": want, "knn_tiled": 0}:
            raise AssertionError(f"dp100x2 rank {r['rank']} launches "
                                 f"{r['launches']}, want {want}")
        if not r["ring"]["ok"]:
            raise AssertionError(f"ring100x2 rank {r['rank']}: {r['ring']}")
    s_iter = max(r["s_iter"] for r in reports)
    print(f"[dp] dp100x2: iteration 1 reward {r1:.6f} against gnn100's "
          f"{want1:.6f}; parameters against gnn100's after 1 iteration max "
          f"abs {errs[1][0]:.3e} ({errs[1][1]} elements beyond rtol "
          f"{DP_RTOL} atol {DP_ATOL}), after {DP_COMPARE_AT} max abs "
          f"{err:.3e} ({beyond} beyond; the policy's leaves within "
          f"{DP_POLICY_ATOL} absolute, the others within JAX's tolerance); "
          "both ranks' digests equal; backend "
          f"{reports[0]['backend']} on the card's tensors "
          f"({', '.join(reports[0]['collectives'])} checked); each rank's "
          "block "
          f"{reports[0]['block']}, knn_fused {want} launches a rank at "
          f"(512,100,4); {reports[0]['graphs']} graphs a rank")
    ar = reports[0]["allreduce_ms"]
    print(f"[dp] dp100x2: one gloo all-reduce of the "
          f"{reports[0]['allreduce_numel']} parameters' float32 on the card, "
          f"rank 0: {ar['direct']:.4f} ms as they are (the port's path), "
          f"{ar['staged']:.4f} ms through a fresh pinned host copy "
          "(alternating blocks of 100)")
    print(f"[dp] dp100x2: {s_iter:.4f} s/iteration over {DP_TIMED} "
          f"iterations (the slower rank; ranks "
          f"{[round(r['s_iter'], 4) for r in reports]}) beside gnn100's "
          f"{gnn100['s_iter']:.4f}: two processes time-sharing one card, "
          f"not a scaling figure; peak "
          f"{[round(r['peak_gib'], 2) for r in reports]} GiB a rank; "
          f"launch to exit {wall:.1f} s")
    for r in reports:
        ring = r["ring"]
        print(f"[dp] ring100x2 rank {r['rank']} (N=100 k=4 M=64 sp=2, 8 "
              f"steps): max abs obs {ring['max_abs_err']['obs']:.2e}, reward "
              f"{ring['max_abs_err']['reward']:.2e}, metrics "
              f"{ring['max_abs_err']['metrics']:.2e}, agents "
              f"{ring['max_abs_err']['agents']:.2e}; done bitwise "
              f"{ring['done_bitwise']}")
    return [r["launches"]["knn_fused"] for r in reports], s_iter


def parallel_phase(gnn100):
    """Phase 16; returns ``dp100x1``'s launches and each ``dp100x2`` rank's,
    and dp100x2's s/iteration."""
    x1 = dp100x1(gnn100)
    elapsed("dp100x1")
    x2, s_iter = dp100x2(gnn100)
    elapsed("dp100x2, ring100x2")
    return {"dp100x1": x1, "dp100x2": x2, "s_iter": s_iter}


# Phase 17: the cross-host serving tier (serving/mesh/) on one card.
# mesh100: run_mesh_smoke over gnn100's checkpoint and scen100's in turn, 2
# host subprocesses time-sharing cuda:0, R=1 each. The ladder is 1/8/64:
# JAX's smoke's 1/8 (one formation a request, up to 4 coalesced) and the 64
# rung of each host's probe batch; the fleet's 512 rung would add a capture
# a host that no request of this load reaches. 4 clients for 6 s, 3 global
# swaps, host0 SIGKILLed halfway; after each commit every live host answers
# MESH_CHECK_ROWS formations alone (rung 8), held bitwise against this
# process's engine on the same checkpoint.
MESH_BUCKETS = (1, 8, 64)
MESH_DURATION_S = 6.0
MESH_SWAPS = 3
MESH_CLIENTS = 4
MESH_CHECK_ROWS = 8
# storm_mesh100: run_mesh_campaign(seed=0, faults=20) over gnn100's command
# at M=64 (storm_train100's width) with its default 16-iteration train leg,
# 2 hosts; the storm's wedge and gate deadline of phase 15.
MESH_STORM_SEED, MESH_STORM_FAULTS = 0, 20


def mesh100(gnn100_ckpt, scen100_ckpt):
    """``run_mesh_smoke`` on the card; returns its report with the bitwise
    checks made after each commit."""
    import tempfile

    import numpy as np

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
    )
    from marl_distributedformation_tpu_torch.serving.mesh import (
        run_mesh_smoke,
    )
    from marl_distributedformation_tpu_torch.serving.mesh.rpc import (
        post_json,
    )

    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    rows, _ = serve_rows(m=64)
    engines = {
        Path(c): BucketedPolicyEngine(
            LoadedPolicy.from_checkpoint(c, env_params=p100, device="cuda"),
            buckets=MESH_BUCKETS)
        for c in (gnn100_ckpt, scen100_ckpt)}
    check = rows[:MESH_CHECK_ROWS]
    body = json.dumps({"obs": check.tolist()}).encode()
    verified = []

    def on_commit(mesh, step, source):
        want = engines[Path(source)].act(check)
        live = sorted(h.host_id for h in mesh.hosts if h.alive())
        routable = mesh.coordinator.routable_hosts()
        if sorted(h.host_id for h in routable) != live:
            raise AssertionError(f"mesh100 step {step}: routable "
                                 f"{[h.host_id for h in routable]}, live "
                                 f"{live}")
        for h in routable:
            status, payload, _ = post_json(h.data_url, "/v1/act", body,
                                           timeout_s=30.0)
            got = np.asarray(payload.get("actions"), np.float32)
            if (status != 200 or payload.get("model_step") != step
                    or not np.array_equal(got, want)):
                raise AssertionError(
                    f"mesh100 step {step} {h.host_id}: status {status}, "
                    f"step {payload.get('model_step')}, max abs diff "
                    f"{np.abs(got - want).max() if got.shape == want.shape else got.shape}")
        verified.append((step, live))

    t0 = time.perf_counter()
    report = run_mesh_smoke(
        Path(tempfile.mkdtemp(prefix="mesh100_")), hosts=2,
        duration_s=MESH_DURATION_S, swaps=MESH_SWAPS, clients=MESH_CLIENTS,
        buckets=MESH_BUCKETS, device="cuda",
        checkpoints=(gnn100_ckpt, scen100_ckpt), env_params=p100, rows=rows,
        on_commit=on_commit, ready_timeout_s=180.0)
    report["wall_s"] = time.perf_counter() - t0
    report["verified"] = verified
    want_receipt = {f"rung{b}_f32_replicated_compiles": 1.0
                    for b in MESH_BUCKETS}
    launches = report["mesh_host_knn_fused_launches"]
    checks = {
        "0 lost": report["mesh_failover_lost_requests"] == 0,
        "0 step violations": report["mesh_step_violations"] == 0,
        "1 capture a (host, rung)": report["mesh_host_compile_receipts"]
        == {"host0": want_receipt, "host1": want_receipt},
        "3 swaps, each host bitwise after each":
            report["mesh_global_swaps"] == MESH_SWAPS
            and len(verified) == MESH_SWAPS,
        "host0 killed": report["mesh_host_killed"] == "host0",
        "knn_fused on every host": sorted(launches) == ["host0", "host1"]
        and min(launches.values()) > 0,
        "hosts on cuda:0, the library prebuilt": all(
            r["device"] == "cuda:0" and r["kernels_prebuilt"]
            for r in report["mesh_hosts_ready"]),
        "requests served": report["mesh_requests_ok"] > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"mesh100 fails {failed}: {report}")
    return report


def storm_mesh100(work):
    """``run_mesh_campaign`` over ``gnn100``'s command at M=64, 2 hosts on
    ``cuda:0``; returns the report and this process's ``knn_fused``
    launches (the trainer, the gate, the probe's formation)."""
    from marl_distributedformation_tpu_torch import chaos_storm
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    knn_cuda.reset_launches()
    t0 = time.perf_counter()
    report = chaos_storm.run_mesh_campaign(
        seed=MESH_STORM_SEED, faults=MESH_STORM_FAULTS, hosts=2,
        workdir=str(work / "storm_mesh100"), wedge_s=STORM_WEDGE_S,
        gate_timeout_s=STORM_GATE_TIMEOUT_S, device="cuda",
        overrides=STORM64)
    wall = time.perf_counter() - t0
    launches = knn_cuda.LAUNCHES["knn_fused"]
    storm_line("storm_mesh100", report, (
        "chaos_invariant_violations", "chaos_faults_fired",
        "chaos_faults_unfired", "chaos_mttr_p50_s", "chaos_mttr_s",
        "chaos_disruptions", "probes_total", "probes_ok", "promotions",
        "rejections", "pipeline_restarts", "mesh_host_killed",
        "mesh_host_states", "mesh_commit_rounds", "mesh_global_swaps",
        "mesh_failed_over_total", "mesh_final_step", "compile_receipts",
        "campaign_seconds"))
    armed = {(f["point"], f["at_hit"])
             for f in report["deterministic"]["schedule"]
             if f["point"].startswith("mesh.")}
    fired = {(f["point"], f["at_hit"]) for f in report["chaos_fired"]
             if f["point"].startswith("mesh.")}
    killed = report["mesh_host_killed"]
    checks = {
        "0 violations": report["chaos_invariant_violations"] == 0,
        "every armed mesh.* fault fired": bool(armed) and armed == fired,
        "the killed host dead": killed is not None
        and report["mesh_host_states"].get(killed) == "dead",
        "a global swap landed": report["mesh_global_swaps"] >= 1,
        "knn_fused in this process": launches > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"storm_mesh100 fails {failed}: {report}")
    print(f"[mesh] storm_mesh100 (seed {MESH_STORM_SEED}, "
          f"{MESH_STORM_FAULTS} faults, 2 hosts on cuda:0, M=64): wall "
          f"{wall:.1f} s, {report['mesh_commit_rounds']} commit rounds "
          f"({report['mesh_global_swaps']} landed), mesh faults fired "
          f"{sorted(fired)}, {killed} {report['mesh_host_states'][killed]}; "
          f"knn_fused {launches} in this process")
    return report, launches


def mesh_phase(gnn100_ckpt, scen100_ckpt, fleet_rate=None):
    """Phase 17: ``mesh100`` and ``storm_mesh100``. ``fleet_rate`` is
    phase 13's R=2 requests/s, printed beside. Returns the hosts' and this
    process's ``knn_fused`` launches."""
    import tempfile

    report = mesh100(gnn100_ckpt, scen100_ckpt)
    launches = report["mesh_host_knn_fused_launches"]
    print(f"[mesh] mesh100, 2 host subprocesses time-sharing cuda:0 (R=1 "
          f"each, ladder {'/'.join(map(str, MESH_BUCKETS))}, "
          f"{MESH_CLIENTS} clients, {report['mesh_load_seconds']} s of load, "
          f"{report['mesh_host_killed']} SIGKILLed halfway): "
          f"{report['mesh_req_per_sec']} requests/s (time-sharing one card, "
          "not a scaling figure"
          + (f"; phase 13's fleet100 R=2 {fleet_rate:.1f}" if fleet_rate
             else "")
          + f"); global swap p50 {report['mesh_global_swap_latency_s_p50']}"
          f" s, p95 {report['mesh_global_swap_latency_s_p95']} s over "
          f"{report['mesh_global_swaps']} swaps ({report['mesh_aborted_rounds']}"
          f" aborted rounds retried); {report['mesh_requests_ok']} served, "
          f"{report['mesh_typed_errors']} typed errors, "
          f"{report['mesh_failover_lost_requests']} lost, "
          f"{report['mesh_step_violations']} step violations; captures "
          f"{report['mesh_host_compile_receipts']}; knn_fused launches a "
          f"host {launches} (each host's probe rows, (64,100,4)); bitwise "
          f"== this process's engine after each commit on "
          f"{report['verified']}; wall {report['wall_s']:.1f} s")
    _, storm_launches = storm_mesh100(
        Path(tempfile.mkdtemp(prefix="storm_mesh_")))
    return {"hosts": launches, "storm": storm_launches}


# ---------------------------------------------------------------------------
# Phase 18: the sharded big-rung slice and elastic capacity on one card.
# ``sharded100``: gnn100's checkpoint behind R=1 on the ladder 1/8/64 plus
# a {"dp": 2} slice on cuda:0 whose rungs are 64 and 512 formations
# (51,200 agent rows); the fleet's two device slots are both cuda:0, so
# the slice's row blocks and the elastic controller's decisions see two.
SHARDED_SPEC = {"axis_sizes": {"dp": 2}, "buckets": (64, 512)}
SHARDED_FLEET_BUCKETS = (1, 8, 64)
SHARDED_SIZES = (1, 8, 64, 512)  # the clients' request sizes, formations
SHARDED_DURATION_S = 1.5
# The elastic controller's mixes (JAX's --elastic-bench's, in formations).
ELASTIC_INTERACTIVE = (1, 2, 4, 8)
ELASTIC_STORM = (64, 128, 256)
ELASTIC_REQUESTS = 48  # a mix's window, over the controller's floor of 32
# The serving benches with the arguments the JAX package's bench.py passes
# them (bench.py:1538-1552, :1633-1647), on cuda:0 (the device default).
SLO_BENCH_ARGS = ("--init-policy", "MLPActorCritic", "--obs-dim", "8",
                  "--slo-bench", "--replicas", "2", "--duration", "1.5",
                  "--slo-p95-ms", "50.0")
ELASTIC_BENCH_ARGS = ("--init-policy", "MLPActorCritic", "--obs-dim", "8",
                      "--hidden", "64,64", "--elastic-bench", "--replicas",
                      "2", "--duration", "2.0", "--load-rps", "120",
                      "--slo-p95-ms", "80.0", "--slo-iterations", "4")


def timed_clients(router, rows, sizes, duration_s, clients=4):
    """``clients`` request loops cycling through ``sizes`` (formations of
    ``rows`` at random offsets) for ``duration_s``: requests/s, the p95 ms
    of the largest size's requests, and the requests lost (accepted, never
    resolved) or failed."""
    import threading
    from concurrent.futures import TimeoutError as FutureTimeout

    import numpy as np

    lat = {n: [] for n in sizes}
    counts = {"ok": 0, "lost": 0, "failed": 0}
    lock = threading.Lock()
    stop = time.perf_counter() + duration_s

    def loop(i):
        rng = np.random.default_rng(i)
        k = i
        while time.perf_counter() < stop:
            n = sizes[k % len(sizes)]
            k += 1
            start = int(rng.integers(0, len(rows) - n + 1))
            t0 = time.perf_counter()
            try:
                fut = router.submit(rows[start:start + n])
                fut.result(timeout=router.default_timeout_s + 5.0)
            except FutureTimeout:
                with lock:
                    counts["lost" if not fut.done() else "failed"] += 1
                continue
            except Exception:  # noqa: BLE001 — a typed failure, counted
                with lock:
                    counts["failed"] += 1
                continue
            with lock:
                counts["ok"] += 1
                lat[n].append(time.perf_counter() - t0)

    threads = [threading.Thread(target=loop, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + 60.0)
    wall = time.perf_counter() - t0
    big = sorted(lat[max(sizes)])
    return {"requests_per_sec": counts["ok"] / wall,
            "big_p95_ms": (big[min(len(big) - 1, int(0.95 * len(big)))]
                           * 1e3 if big else 0.0),
            "big_requests": len(big), **counts}


def sharded_fleet(fleet_dir, p100, **extra):
    """R=1 of ``fleet_dir``'s checkpoint on the ladder 1/8/64 over two
    device slots of ``cuda:0``, plus ``extra`` router arguments."""
    import torch

    from marl_distributedformation_tpu_torch.serving.fleet import (
        fleet_from_checkpoint_dir,
    )

    cuda0 = torch.device("cuda", 0)
    return fleet_from_checkpoint_dir(
        fleet_dir, env_params=p100, device="cuda", devices=[cuda0, cuda0],
        num_replicas=1, buckets=SHARDED_FLEET_BUCKETS, window_ms=2.0,
        probe_interval_s=0.2, max_failovers=2, **extra)


def sharded_equals_engine(sh, engine, rows):
    """Each row block of every slice rung bitwise against the single
    engine's rung of its rows; the whole rung within serving's tolerance of
    the single engine's rung ``b``. Returns the largest difference."""
    import numpy as np

    params, _ = sh.registry.active()
    dp = sh.engine.mesh.dp
    worst = 0.0
    for b in SHARDED_SPEC["buckets"]:
        got = sh.engine.act(rows[:b], nn_params=params)
        h = b // dp
        for d in range(dp):
            want = engine.act(rows[d * h:(d + 1) * h])
            if not np.array_equal(got[d * h:(d + 1) * h], want):
                raise AssertionError(
                    f"sharded100 rung {b} row block {d} != the single "
                    f"engine's rung {h}: max abs diff "
                    f"{np.abs(got[d * h:(d + 1) * h] - want).max():.3g}")
        want = engine.act(rows[:b])
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg=f"sharded100 rung {b}")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


def seeded_mlp_slices():
    """A seeded MLP (obs 8, (64, 64)) on the card: its bf16 {"dp": 2}
    slice against the f32 engine within ``tests/bf16_budget.py``'s bound
    and not f32; its {"dp": 2, "mp": 2} slice within JAX's atol 1e-5.
    Returns the two largest differences."""
    import numpy as np
    import torch

    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.models import MLPActorCritic
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
        ShardedPolicyEngine,
    )
    from marl_distributedformation_tpu_torch.serving.sharded import (
        make_slice,
    )

    model = MLPActorCritic(8, generator=torch.Generator().manual_seed(0))
    policy = LoadedPolicy(model.to("cuda").eval())
    rows = np.random.default_rng(3).standard_normal((512, 8)).astype(
        np.float32)
    buckets = SHARDED_SPEC["buckets"]
    f32 = BucketedPolicyEngine(policy, buckets=buckets)
    bf16 = ShardedPolicyEngine(policy, make_slice({"dp": 2}),
                               buckets=buckets, dtype="bfloat16")
    mp = ShardedPolicyEngine(policy, make_slice({"dp": 2, "mp": 2}),
                             buckets=buckets)
    atol = bf16_action_atol(num_layers=3)
    d16 = dmp = 0.0
    for b in buckets:
        want = f32.act(rows[:b])
        d16 = max(d16, float(np.abs(bf16.act(rows[:b]) - want).max()))
        dmp = max(dmp, float(np.abs(mp.act(rows[:b]) - want).max()))
    if not 0.0 < d16 <= atol:
        raise AssertionError(f"bf16 slice divergence {d16:.3g} outside "
                             f"(0, {atol:.3g}]")
    if dmp > 1e-5:
        raise AssertionError(f"dp x mp slice divergence {dmp:.3g} > 1e-5")
    return d16, dmp, atol


def sharded100(gnn100_ckpt, scen100_ckpt, workdir):
    """``sharded100``: the gates of phase 18's first half (see the module
    docstring). Returns ``(router, coordinator, rows, report)`` with the
    router started, for ``elastic100``."""
    import shutil

    import numpy as np

    from marl_distributedformation_tpu_torch.chaos import (
        check_no_request_lost,
        check_step_monotonic,
    )
    from marl_distributedformation_tpu_torch.compat.policy import LoadedPolicy
    from marl_distributedformation_tpu_torch.env import EnvParams
    from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
    from marl_distributedformation_tpu_torch.serving import (
        BucketedPolicyEngine,
        ShardedSpec,
        TraceRecorder,
    )
    from marl_distributedformation_tpu_torch.serving.fleet import (
        run_fleet_smoke,
        warmup_fleet,
    )
    from marl_distributedformation_tpu_torch.utils.checkpoint import (
        checkpoint_step,
    )

    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    rows, launches = serve_rows()
    policy = LoadedPolicy.from_checkpoint(gnn100_ckpt, env_params=p100,
                                          device="cuda")
    engine = BucketedPolicyEngine(policy, buckets=(32, 64, 256, 512))
    step0 = checkpoint_step(gnn100_ckpt)
    swap_step = max(step0, checkpoint_step(scen100_ckpt)) + 7
    report = {"launches": launches}

    # R=1 alone, for the requests/s and big p95 beside the sliced fleet.
    alone_dir = workdir / "alone"
    alone_dir.mkdir(parents=True)
    shutil.copy(gnn100_ckpt, alone_dir / Path(gnn100_ckpt).name)
    alone, _ = sharded_fleet(alone_dir, p100)
    warmup_fleet(alone, rows.shape[1:])
    with alone:
        report["alone"] = timed_clients(alone, rows, SHARDED_SIZES,
                                        SHARDED_DURATION_S)

    fleet_dir = workdir / "sliced"
    fleet_dir.mkdir(parents=True)
    shutil.copy(gnn100_ckpt, fleet_dir / Path(gnn100_ckpt).name)
    ledger = get_ledger()
    before = len(ledger.entries())
    router, coordinator = sharded_fleet(
        fleet_dir, p100, sharded=ShardedSpec(**SHARDED_SPEC),
        trace_recorder=TraceRecorder())
    sh = router.sharded_replica
    t0 = time.perf_counter()
    warmup_fleet(router, rows.shape[1:])
    report["capture_s"] = time.perf_counter() - t0
    want_counts = {0: dict.fromkeys(SHARDED_FLEET_BUCKETS, 1),
                   sh.index: dict.fromkeys(SHARDED_SPEC["buckets"], 1)}
    if router.compile_counts() != want_counts:
        raise AssertionError(f"sharded100 captures {router.compile_counts()}")
    blocks = {k: g.count for k, g in sh.engine.block_guards.items()}
    sliced_programs = [e for e in ledger.entries()[before:]
                       if e.subsystem == "serving_sharded"]
    if (set(blocks.values()) != {1} or len(blocks) != 4
            or len(sliced_programs) != 4
            or any(part.graph.graph is None
                   for b in SHARDED_SPEC["buckets"]
                   for part in sh.engine.rung(b))):
        raise AssertionError(f"sharded100: one capture a (slot, rung) "
                             f"fails: guards {blocks}, ledger "
                             f"{[e.name for e in sliced_programs]}")
    report["captures"] = blocks
    report["max_abs_diff"] = sharded_equals_engine(sh, engine, rows)

    # The storm, with a coordinated swap to scen100's checkpoint landing
    # on both replica kinds halfway.
    def swap():
        target = fleet_dir / f"rl_model_{swap_step}_steps.msgpack"
        shutil.copy(scen100_ckpt, fleet_dir / ".incoming.tmp")
        (fleet_dir / ".incoming.tmp").replace(target)
        if not coordinator.refresh():
            raise AssertionError(f"sharded100: no swap: "
                                 f"{list(coordinator.load_errors)}")

    router.start()
    log = {}
    storm = run_fleet_smoke(
        router, rows.shape[1:], sizes=SHARDED_SIZES,
        duration_s=SHARDED_DURATION_S, num_clients=4,
        coordinator=coordinator, mid_storm=swap, mid_storm_at_s=0.5,
        warmup=False, row_pool=rows, log=log, seed=3)
    violations = (check_no_request_lost(log["outcomes"])
                  + check_step_monotonic(log["steps"]))
    steps = {r.kind: r.registry.active_step for r in router.replicas}
    if (violations or storm["max_compiles_per_rung"] != 1.0
            or storm["fleet_swap_count"] != 1.0
            or set(steps.values()) != {swap_step}):
        raise AssertionError(f"sharded100 storm: violations {violations}, "
                             f"steps {steps}, report {storm}")
    # After the swap the slice serves scen100's parameters.
    newer = LoadedPolicy.from_checkpoint(scen100_ckpt, env_params=p100,
                                         device="cuda")
    params, _ = sh.registry.active()
    np.testing.assert_allclose(
        sh.engine.act(rows[:64], nn_params=params),
        BucketedPolicyEngine(newer, buckets=(64,)).act(rows[:64]),
        rtol=SERVE_RTOL, atol=SERVE_ATOL, err_msg="sharded100 after swap")
    report["storm"] = storm
    report["lost"] = sum(1 for o in log["outcomes"] if o.get("hung"))
    report["sliced"] = timed_clients(router, rows, SHARDED_SIZES,
                                     SHARDED_DURATION_S)
    for cell in ("alone", "sliced"):
        if report[cell]["lost"] or not report[cell]["big_requests"]:
            raise AssertionError(f"sharded100 {cell}: {report[cell]}")
    report["bf16_diff"], report["mp_diff"], report["bf16_atol"] = (
        seeded_mlp_slices())
    return router, coordinator, rows, report


def elastic_drive(router, rows, sizes, count, outcomes, steps, seed):
    """``count`` requests cycling through ``sizes`` formations, submitted
    back to back, then every future resolved (the no-lost-request
    witness); successes record ``(t_done, step)``."""
    from concurrent.futures import TimeoutError as FutureTimeout

    import numpy as np

    rng = np.random.default_rng(seed)
    futures = []
    for i in range(count):
        n = sizes[i % len(sizes)]
        start = int(rng.integers(0, len(rows) - n + 1))
        try:
            futures.append(router.submit(rows[start:start + n],
                                         timeout_s=10.0))
        except Exception as e:  # noqa: BLE001 — a typed reject resolved
            outcomes.append({"ok": False, "hung": False,
                             "error": type(e).__name__})
    for f in futures:
        try:
            result = f.result(timeout=30.0)
        except FutureTimeout as e:
            # A RequestTimeout is a TimeoutError too: a typed outcome.
            outcomes.append({"ok": False, "hung": not f.done(),
                             "error": type(e).__name__})
            continue
        except Exception as e:  # noqa: BLE001 — a typed failure resolved
            outcomes.append({"ok": False, "hung": False,
                             "error": type(e).__name__})
            continue
        outcomes.append({"ok": True, "hung": False, "error": None})
        steps.append((time.perf_counter(), int(result.model_step)))


def elastic100(router, coordinator, rows):
    """``elastic100``: a ``CapacityController`` over ``sharded100``'s
    fleet, fed an interactive mix and then a storm mix, each decided with
    traffic in flight. Gates: at least 1 re-split committed, prewarm
    captures counted, no capture on the request path (the ledger's census
    before and after serving on the new split), 0 lost, monotonic
    steps, one capture a rung everywhere. Returns its report."""
    import threading

    from marl_distributedformation_tpu_torch.chaos import (
        check_no_request_lost,
        check_step_monotonic,
    )
    from marl_distributedformation_tpu_torch.obs.ledger import get_ledger
    from marl_distributedformation_tpu_torch.serving import (
        CapacityController,
    )

    controller = CapacityController(
        router, coordinator, row_shape=rows.shape[1:], p95_target_ms=50.0,
        min_requests=32, drain_timeout_s=10.0)
    router.trace_recorder.clear()  # sharded100's traffic decides nothing
    outcomes, steps, reports = [], [], []
    for i, mix in enumerate((ELASTIC_INTERACTIVE, ELASTIC_STORM)):
        elastic_drive(router, rows, mix, ELASTIC_REQUESTS, outcomes, steps,
                      seed=10 + i)
        stop = threading.Event()

        def pump(mix=mix):
            k = 0
            while not stop.is_set():
                elastic_drive(router, rows, (1, mix[-1]), 2, outcomes, steps,
                              seed=100 + k)
                k += 1

        pumper = threading.Thread(target=pump, daemon=True)
        pumper.start()
        try:
            reports.append(controller.step())
        finally:
            stop.set()
            pumper.join(timeout=60.0)
    committed = [r for r in reports if r and r.get("committed")]
    if not committed:
        raise AssertionError(f"elastic100: no re-split committed: {reports}")
    ledger = get_ledger()
    census = len(ledger.entries())
    if census != committed[-1]["prewarm_programs_after"]:
        raise AssertionError(f"elastic100: {census} programs, the last "
                             f"prewarm left {committed[-1]}")
    elastic_drive(router, rows, ELASTIC_STORM + ELASTIC_INTERACTIVE, 24,
                  outcomes, steps, seed=999)
    after = len(ledger.entries())
    violations = (check_no_request_lost(outcomes)
                  + check_step_monotonic(sorted(steps)))
    counts = router.compile_counts()
    if (after != census or violations
            or any(c != 1 for rungs in counts.values()
                   for c in rungs.values())
            or not all(o["ok"] for o in outcomes)):
        raise AssertionError(f"elastic100: programs {census} -> {after} "
                             f"serving the new split, violations "
                             f"{violations}, captures {counts}, failures "
                             f"{[o for o in outcomes if not o['ok']][:3]}")
    snap = controller.snapshot()
    return {"reports": reports, "snapshot": snap, "requests": len(outcomes),
            "census": census, "counts": counts,
            "buckets": {r.index: (r.kind, r.engine.buckets)
                        for r in router.replicas}}


def serve_benches():
    """``serve --slo-bench`` and ``--elastic-bench`` on ``cuda:0``, each
    in a process of its own as bench.py starts them, both at once (they
    time-share the card with each other, not only within themselves; one
    after the other in this process they took 88.2 s on an NVIDIA H100
    80GB HBM3 at 700 W).
    Returns each one's JSON line; every process ends before this returns."""
    procs = {}
    try:
        for name, args in (("slo", SLO_BENCH_ARGS),
                           ("elastic", ELASTIC_BENCH_ARGS)):
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "marl_distributedformation_tpu_torch"
                 ".serve", *args], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        out = {}
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=400)
            lines = stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                raise AssertionError(f"serve --{name}-bench exited "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            out[name] = json.loads(lines[-1])
        return out
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def sharded_phase(gnn100_ckpt, scen100_ckpt):
    """Phase 18: ``sharded100``, ``elastic100``, the two serving benches
    and ``storm_elastic100``. Returns the ``knn_fused`` launches: the
    request rows (``serve_rows``, at the train shape) and the elastic
    storm's row pool ((64,100,4))."""
    import shutil

    from marl_distributedformation_tpu_torch import chaos_storm
    from marl_distributedformation_tpu_torch.obs.ledger import (
        ProgramLedger,
        set_ledger,
    )
    from marl_distributedformation_tpu_torch.ops import knn_cuda

    workdir = ROOT / "logs" / "smoke_sharded100"
    shutil.rmtree(workdir, ignore_errors=True)
    previous = set_ledger(ProgramLedger(enabled=True))
    knn_cuda.reset_launches()
    try:
        router, coordinator, rows, rep = sharded100(gnn100_ckpt, scen100_ckpt,
                                                    workdir)
        alone, sliced = rep["alone"], rep["sliced"]
        print(f"[sharded] sharded100: R=1 (ladder "
              f"{'/'.join(map(str, SHARDED_FLEET_BUCKETS))}) + a dp=2 slice "
              f"on cuda:0 (rungs {'/'.join(map(str, SHARDED_SPEC['buckets']))}"
              f" formations; 512 = 51,200 agent rows), captured in "
              f"{rep['capture_s']:.2f} s, one capture a (slot, rung) "
              f"{rep['captures']}; every row block bitwise == the single "
              f"engine's rung of its rows; whole rung vs the single engine's "
              f"rung b: max abs diff {rep['max_abs_diff']:.3g} (rtol "
              f"{SERVE_RTOL}, atol {SERVE_ATOL}); mid-storm swap on both "
              f"kinds: {rep['storm']['client_requests_ok']:.0f} served, "
              f"{rep['lost']} lost, "
              f"{rep['storm']['step_monotonic_violations']:.0f} step "
              f"violations; knn_fused {rep['launches']} (request rows)")
        print(f"[sharded] time-sharing cuda:0, not scaling: requests/s and "
              f"the 512-formation requests' p95 ms, 4 clients x "
              f"{SHARDED_DURATION_S} s of sizes {SHARDED_SIZES}: R=1 "
              f"{alone['requests_per_sec']:.1f}, {alone['big_p95_ms']:.3f} "
              f"({alone['big_requests']} big); R=1 + slice "
              f"{sliced['requests_per_sec']:.1f}, {sliced['big_p95_ms']:.3f}"
              f" ({sliced['big_requests']} big)")
        print(f"[sharded] seeded MLP (obs 8, 64x64): bf16 dp=2 slice max abs "
              f"diff {rep['bf16_diff']:.3g} in (0, {rep['bf16_atol']:.3g}]; "
              f"dp=2 x mp=2 slice {rep['mp_diff']:.3g} <= 1e-5")
        elapsed("sharded100")
        try:
            el = elastic100(router, coordinator, rows)
        finally:
            router.stop()
        decisions = [(r or {}).get("decision", {}) for r in el["reports"]]
        snap = el["snapshot"]
        print(f"[elastic] elastic100: "
              f"{snap['elastic_resplits_committed']:.0f} re-split(s) "
              f"committed of "
              f"{len(el['reports'])} decisions "
              + "; ".join(
                  f"{d.get('replicated_buckets')}+{d.get('sharded_buckets')}"
                  for d in decisions)
              + f", pause {snap['elastic_last_pause_ms']:.3f} ms, "
              f"prewarm {snap['elastic_last_prewarm_ms']:.1f} ms, "
              f"{snap['elastic_prewarm_compiles_total']:.0f} "
              f"prewarm captures, 0 on the request path (census "
              f"{el['census']} before and after serving the new split), "
              f"{el['requests']} requests, 0 lost, monotonic; replicas now "
              f"{el['buckets']}")
        elapsed("elastic100")
        benches = serve_benches()
        slo, ela = benches["slo"], benches["elastic"]
        print(f"[sharded] --slo-bench (its own process beside the elastic "
              f"bench's, time-sharing cuda:0): replicated / "
              f"sharded / bf16 512-rung p95 {slo['replicated_512_p95_ms']:.3f}"
              f" / {slo['sharded_512_p95_ms']:.3f} / "
              f"{slo['bf16_512_p95_ms']:.3f} ms, bf16 speedup "
              f"{slo['bf16_speedup_pct']:.1f}%, req/s at p95 <= 50 ms "
              f"{slo['req_per_sec_at_p95_slo']:.1f}, {slo['passes']} passes, "
              f"max captures a rung {slo['max_compiles_per_rung']}")
        print(f"[elastic] --elastic-bench (its own process beside the slo "
              f"bench's, time-sharing cuda:0): storm p95 "
              f"static {ela['static_storm_p95_ms']:.3f} / elastic "
              f"{ela['elastic_storm_p95_ms']:.3f} ms, req/s at p95 <= 80 ms "
              f"static {ela['req_per_sec_at_p95_slo_static']:.1f} / elastic "
              f"{ela['req_per_sec_at_p95_slo_elastic']:.1f}, re-split pause "
              f"{ela['elastic_resplit_pause_ms']:.3f} ms, "
              f"{ela['elastic_prewarm_compiles']:.0f} prewarm captures, "
              f"{ela['elastic_storm_new_programs']} new programs in the "
              f"measured storm, buckets {ela['elastic_buckets']}")
        if (slo["max_compiles_per_rung"] != 1
                or ela["elastic_storm_new_programs"] != 0
                or ela["max_compiles_per_rung"] != 1):
            raise AssertionError(f"benches: {slo} {ela}")
        elapsed("serving benches")
        rows_launches = knn_cuda.LAUNCHES["knn_fused"]
        storm = chaos_storm.run_elastic_campaign(
            overrides=list(GNN100), device="cuda")
        pool_launches = knn_cuda.LAUNCHES["knn_fused"] - rows_launches
        if (storm["chaos_invariant_violations"] != 0
                or storm["chaos_faults_unfired"] != 0
                or storm["elastic_resplits_committed"] < 2
                or pool_launches != 1):
            raise AssertionError(f"storm_elastic100: {storm}, knn_fused "
                                 f"{pool_launches}")
        print(f"[storm] storm_elastic100 (--elastic over gnn100's command, "
              f"seed 0): 0 violations, {storm['chaos_faults_fired']} of "
              f"{storm['deterministic']['chaos_faults_armed']} fired, "
              f"{storm['elastic_resplits_committed']} committed / "
              f"{storm['elastic_resplits_aborted']} aborted / "
              f"{storm['elastic_resplits_skipped']} skipped in "
              f"{storm['elastic_rounds']} rounds, "
              f"{storm['requests_ok']}/{storm['requests_resolved']} served, "
              f"pause {storm['elastic_last_pause_ms']:.3f} ms, "
              f"{storm['campaign_seconds']} s; knn_fused {pool_launches} "
              f"(its row pool, (64,100,4))")
        return {"rows": rows_launches, "storm": pool_launches}
    finally:
        set_ledger(previous)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from marl_distributedformation_tpu_torch import evaluate as evaluate_cli
    from marl_distributedformation_tpu_torch.device import resolve_device
    from marl_distributedformation_tpu_torch.env.types import EnvParams
    from marl_distributedformation_tpu_torch.models import GNNActorCritic
    from marl_distributedformation_tpu_torch.ops import _build, knn_cuda

    arm_hang_dump(HANG_DUMP_S)
    dev = resolve_device("cuda")
    card = card_line()
    print(card)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # Phase 1: build.
    t0 = time.perf_counter()
    _build.build([knn_cuda.SOURCE])
    print(f"[build] {knn_cuda.SOURCE}.cu in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log(knn_cuda.SOURCE).splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")

    elapsed("phase 1, build")
    warm_profiler()

    # Phase 2: each kernel against its plain version, at the shape of the
    # training path that launches it and at the eval path's.
    shapes = {
        "knn_fused": (knn_cuda.knn_fused, 200,
                      {"train": (1024, 100, 4), "eval": (4096, 100, 4),
                       "population": (4096, 100, 4),
                       "matrix": (256, 100, 4),
                       "adversary": (25 * ADVERSARY_M, 100, 4),
                       "population61": (61 * ADVERSARY_M, 100, 4),
                       "playback": (1, 100, 4),
                       "gate": (ALWAYS_GATE_M, 100, 4),
                       "storm_gate": (STORM_GATE_M, 100, 4),
                       "dp": (512, 100, 4)}),
        "knn_tiled": (knn_cuda.knn_tiled, 50,
                      {"train": (8, 1024, 4), "eval": (512, 1024, 4),
                       "population": (16, 1024, 4),
                       "matrix": (32, 1024, 4)}),
    }
    stats = {}
    for name, (fn, reps, by_path) in shapes.items():
        done = {}  # a shape two paths share is checked once
        for path, shape in by_path.items():
            if shape not in done:
                done[shape] = check_kernel(name, fn, *shape, reps)
            stats.setdefault(name, {})[path] = done[shape]

    elapsed("phase 2, kernels")
    capture_gc_check()

    # Phase 3: the k-NN swarm evaluation at full width.
    gen = torch.Generator().manual_seed(0)
    gnn = GNNActorCritic(k=4, generator=gen).to(dev).eval()
    p100 = EnvParams(num_agents=100, obs_mode="knn", knn_k=4)
    # 101 steps: at T <= 100 the JAX package's last-100 window starts below 0
    # and wraps (eval.py:119); the port keeps that for parity.
    p1024 = EnvParams(num_agents=1024, obs_mode="knn", knn_k=4, max_steps=99)
    eval_launches = {}
    got, T = run_swarm(gnn, p100, 4096, "gnn knn N=100")
    if got != {"knn_fused": T + 1, "knn_tiled": 0}:
        raise AssertionError(f"N=100 launches {got}, want fused {T + 1}")
    eval_launches["knn_fused"] = got["knn_fused"]
    got, T = run_swarm(gnn, p1024, 512, "gnn knn N=1024")
    if got != {"knn_fused": 0, "knn_tiled": T + 1}:
        raise AssertionError(f"N=1024 launches {got}, want tiled {T + 1}")
    eval_launches["knn_tiled"] = got["knn_tiled"]
    profile_breakdown(gnn, p100, 4096)
    profile_breakdown(gnn, p1024, 512)
    kernel_equals_plain_end_to_end(gnn, p100, 32)
    kernel_equals_plain_end_to_end(gnn, p1024.replace(max_steps=18), 4)

    elapsed("phase 3, k-NN swarm evaluation")

    # Phase 4: the committed MLP checkpoint through the evaluate CLI.
    res = evaluate_cli.main([
        f"checkpoint={CKPT}", "eval_formations=4096", "device=cuda",
    ])
    ret = {r: res[f"{r}_episode_return_per_agent"]
           for r in ("policy", "baseline", "zero")}
    if not ret["policy"] > ret["baseline"] > ret["zero"]:
        raise AssertionError(f"ranking learned > baseline > zero fails: {ret}")
    print(f"[mlp] learned {ret['policy']:.2f} > baseline "
          f"{ret['baseline']:.2f} > zero {ret['zero']:.2f}")

    elapsed("phase 4, committed checkpoint")

    # Phase 5: training through the kernels.
    launches, gnn100 = train_phase()
    elapsed("phase 5, training")

    # Phase 6: populations through the kernels.
    pop_launches = population_phase(gnn100)
    elapsed("phase 6, populations")

    # Phase 7: CTDE and the curriculum, this slice's main paths.
    ctde_knn_launches = ctde_phase()
    curriculum_phase()
    elapsed("phase 7, CTDE and the curriculum")

    # Phase 8: scenarios.
    scen_launches, scen100_ckpt = scenario_phase(gnn100)
    elapsed("phase 8, scenarios")

    # Phase 9: the robustness matrix, the falsifier search and
    # pursuit-evasion, this slice's main paths.
    robust = robustness_phase(gnn100, scen100_ckpt)
    elapsed("phase 9, robustness matrix, falsifier search, pursuit")

    # Phase 10: serving.
    serve_launches, serve_smoke = serving_phase(gnn100["ckpt"], scen100_ckpt)
    elapsed("phase 10, serving")

    # Phase 11: Sebulba, C4 and observability, this slice's main paths.
    sebulba_launches = sebulba_phase(gnn100)
    elapsed("phase 11, Sebulba, C4, observability")

    # Phase 12: the reference's own user surface, this slice's main paths.
    surface = surface_phase(gnn100)
    elapsed("phase 12, single-formation API, VecEnv, tools")

    # Phase 13: the serving fleet, the watchdog and the runtime guards,
    # this slice's main paths.
    fleet_launches, fleet_r2 = fleet_phase(gnn100["ckpt"], scen100_ckpt,
                                           serve_smoke)
    fleet_rate = fleet_r2["requests_per_sec_fleet"]
    elapsed("phase 13, fleet, watchdog, guards")

    # Phase 14: the always-learning pipeline (with the regression sentinel
    # against this run's own record) and tenant lanes, this slice's main
    # paths.
    pipeline_launches = pipeline_phase(gnn100, scen100_ckpt, card,
                                       fleet_r2["latency_p95_ms"])
    elapsed("phase 14, always-learning pipeline, tenant lanes")

    # Phase 15: the chaos storm, this slice's main path.
    storm_launches = storm_phase()
    elapsed("phase 15, chaos storm")

    # Phase 16: data parallelism and the agent-axis ring, this slice's
    # main path.
    dp = parallel_phase(gnn100)
    elapsed("phase 16, dp and the ring")

    # Phase 17: the cross-host serving tier, this slice's main path.
    mesh = mesh_phase(gnn100["ckpt"], scen100_ckpt, fleet_rate)
    elapsed("phase 17, the serving mesh")

    # Phase 18: the sharded big-rung slice and elastic capacity, this
    # slice's main paths.
    sharded = sharded_phase(gnn100["ckpt"], scen100_ckpt)
    elapsed("phase 18, the sharded slice and elastic capacity")

    replaces = {
        "knn_fused": "marl_distributedformation_tpu/ops/knn_pallas.py:117",
        "knn_tiled": "marl_distributedformation_tpu/ops/knn_pallas.py:155",
    }
    paths = {"knn_fused": "train gnn100", "knn_tiled": "train gnn1024"}
    pop_paths = {"knn_fused": "train pop4", "knn_tiled": "train pop1024"}
    # The launches and timings of the training path that launches each
    # kernel (this slice's main path); those of phase 3's eval under "eval".
    kernels = [
        {"name": name, "route": "cuda",
         "source": "marl_distributedformation_tpu_torch/csrc/knn.cu",
         "replaces": replaces[name], "path": paths[name],
         "launches": launches[name], **stats[name]["train"],
         "library_ms": None,
         "eval": {"launches": eval_launches[name], **stats[name]["eval"]},
         "population": {"path": pop_paths[name],
                        "launches": pop_launches[name],
                        **stats[name]["population"]}}
        for name in ("knn_fused", "knn_tiled")
    ]
    # The CTDE actor on k-NN observations launches knn_fused at the train
    # shape, (1024,100,4), timed above.
    kernels[0]["ctde_knn"] = {"path": "train ctde_knn",
                              "launches": ctde_knn_launches,
                              "shape": stats["knn_fused"]["train"]["shape"]}
    # scen100 launches knn_fused at gnn100's shape, (1024,100,4).
    kernels[0]["scenario"] = {"path": "train scen100",
                              "launches": scen_launches,
                              "shape": stats["knn_fused"]["train"]["shape"]}
    # Phase 9's paths, each at its own shape (timed in phase 2).
    for i, name in enumerate(("knn_fused", "knn_tiled")):
        kernels[i]["matrix"] = {
            "path": "matrix100" if i == 0 else "matrix1024",
            "launches": robust["matrix100" if i == 0
                               else "matrix1024"][name],
            **stats[name]["matrix"]}
    kernels[0]["adversary"] = {"path": "adversary100",
                               "launches": robust["adversary100"]["knn_fused"],
                               **stats["knn_fused"]["adversary"]}
    kernels[0]["population61"] = {
        "path": "adversary100 P=61",
        "launches": robust["population61"]["knn_fused"],
        **stats["knn_fused"]["population61"]}
    # Phase 10's request rows: env states through knn_fused at the train
    # shape, (1024,100,4), timed above (the served GNN reads its neighbor
    # indices from the rows and launches no kernel).
    kernels[0]["serving"] = {"path": "serve100 request rows",
                             "launches": serve_launches,
                             "shape": stats["knn_fused"]["train"]["shape"]}
    kernels[0]["chase"] = {"path": "train chase100",
                           "launches": robust["chase100"],
                           "shape": stats["knn_fused"]["train"]["shape"]}
    # Phase 11's lanes: the actor launches knn_fused at gnn100's shape and
    # knn_tiled at gnn1024's, each timed above.
    for i, name in enumerate(("knn_fused", "knn_tiled")):
        kernels[i]["sebulba"] = {
            "path": "train sebulba100" if i == 0 else "train sebulba1024",
            "launches": sebulba_launches[name],
            "shape": stats[name]["train"]["shape"]}
    # Phase 12's VecEnv runs at vecenv100's (1024,100,4), the train shape,
    # and vecenv1024's (8,1024,4), the train shape; playback and the
    # per-formation k-NN step at (1,100,4).
    for i, name in enumerate(("knn_fused", "knn_tiled")):
        kernels[i]["vec_env"] = {
            "path": "vecenv100" if i == 0 else "vecenv1024",
            "launches": surface["vec_env"][name],
            "shape": stats[name]["train"]["shape"]}
    kernels[0]["playback"] = {"path": "playback100 visualize_policy",
                              "launches": surface["playback"],
                              **stats["knn_fused"]["playback"]}
    kernels[0]["single_step"] = {"path": "config1 per-formation step N=100",
                                 "launches": surface["single_step"],
                                 **stats["knn_fused"]["playback"]}
    # Phase 13's request rows: env states through knn_fused at the train
    # shape, (1024,100,4) (the served GNN launches no kernel).
    kernels[0]["fleet"] = {"path": "fleet100 request rows",
                           "launches": fleet_launches,
                           "shape": stats["knn_fused"]["train"]["shape"]}
    # Phase 14: always100's trainer at the train shape and its gate at
    # (64,100,4) (timed above), and the lanes' request rows at the train
    # shape (the served GNNs launch no kernel).
    always = pipeline_launches["always"]
    kernels[0]["always"] = {
        "path": "always100 trainer and gate", "launches": always["knn_fused"],
        "trainer_launches": always["trainer"],
        "gate_launches": always["gate"], **stats["knn_fused"]["gate"]}
    kernels[0]["tenants"] = {"path": "tenants100 request rows",
                             "launches": pipeline_launches["rows"],
                             "shape": stats["knn_fused"]["train"]["shape"]}
    # Phase 15: storm100's trainer at the train shape, (1024,100,4), its
    # gate at (8,100,4) and its probe's formation at (1,100,4); the train
    # and Sebulba campaigns at (64,100,4), timed above as the gate's shape.
    kernels[0]["chaos_storm"] = {
        "path": "storm100, storm_train100, storm_sebulba100",
        "launches": sum(v["knn_fused"] for v in storm_launches.values()),
        "storm100": {
            "launches": storm_launches["storm100"]["knn_fused"],
            "trainer_launches": storm_launches["storm100"]["trainer"],
            "gate_launches": storm_launches["storm100"]["gate"],
            "train_shape": stats["knn_fused"]["train"]["shape"],
            "gate": stats["knn_fused"]["storm_gate"]},
        "storm_train100": {
            "launches": storm_launches["storm_train100"]["knn_fused"],
            **stats["knn_fused"]["gate"]},
        "storm_sebulba100": {
            "launches": storm_launches["storm_sebulba100"]["knn_fused"],
            **stats["knn_fused"]["gate"]}}
    # Phase 16: each dp100x2 rank's block at (512,100,4) (timed above);
    # dp100x1's one rank at the train shape.
    kernels[0]["dp"] = {
        "path": "train dp100x2, each rank's block",
        "launches": dp["dp100x2"], "dp100x1_launches": dp["dp100x1"],
        "dp100x2_s_iter": dp["s_iter"], **stats["knn_fused"]["dp"]}
    # Phase 17: each mesh host's probe rows at (64,100,4), the gate's
    # shape (timed above); storm_mesh100's trainer, gate and probe in this
    # process.
    kernels[0]["mesh"] = {
        "path": "mesh100 hosts' probe rows, storm_mesh100",
        "launches": sum(mesh["hosts"].values()) + mesh["storm"],
        "host_launches": mesh["hosts"], "storm_mesh100_launches":
        mesh["storm"], **stats["knn_fused"]["gate"]}
    # Phase 18: sharded100's request rows at the train shape, (1024,100,4)
    # (the served GNN launches no kernel; the MLP benches none), and
    # storm_elastic100's row pool at the gate's (64,100,4), timed above.
    kernels[0]["sharded"] = {
        "path": "sharded100 request rows, storm_elastic100's row pool",
        "launches": sharded["rows"] + sharded["storm"],
        "sharded100_launches": sharded["rows"],
        "storm_elastic100_launches": sharded["storm"],
        "shape": stats["knn_fused"]["train"]["shape"],
        "storm_pool": stats["knn_fused"]["gate"]}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2:]))
    sys.exit(main())
