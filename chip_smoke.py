#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port builds, serves and trains on
the card.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from ``trustworthy_dl_tpu_torch/ops/
   csrc`` with nvcc for sm_90a (one nvcc per source, started together).
3. kernels: call each kernel's wrapper at its path's shapes (serving's
   for B4-B9 and the int8 branches of B5/B6, training's for B1-B3), hold
   it against its plain PyTorch version on the same inputs, and time the
   kernel, the plain version and a library yardstick (median of
   per-launch CUDA-event timings, L2 flushed before each launch).  B4 at
   M = 1, 8, 16 and 64 on GPT-2 small's four block matrices and n_embd
   96's qkv at M = 8 (``cases``, each with the profiler's device time of
   the kernel and of the yardstick).  B8
   also at 144 rows (two launches), B2 also at D = 32 and 128 (``cases``,
   with ``tflops``), B6 also over 128-position blocks (``block128``),
   B6-int8 also from position 0 and as a 64-row chunk, B5-int8 also at
   the verify window (T = 5), B9 also at GPT-2 medium's width and rank
   64 (``cases``); B2, B3, B5, B6 (both pools), B7, B8 and B9 also with
   the profiler's device time of the kernel and of the yardstick (B3's
   beside SDPA's whole backward's); B7 at the decode tick's 8 rows and a
   prompt's last chunk, 1 row (``cases``).
4. serve: drive ``ServingEngine`` at the full width of GPT-2 small (12
   layers, 768 wide, 12 heads, vocab 50257, bf16; random weights from
   seed 0) over 16 requests, with every kernel launch counter set to 0
   just before and read just after; hold the greedy streams against the
   same engine on the plain path.
4b. serve_spec: the same traffic with ``spec_k=4`` over the int8 KV pool
   (parity probe on; the engine must keep the int8 pool), launch counts
   of B4, B5-int8, B6-int8, B7 and B8 exactly as the engine's counters
   say, greedy streams against the same engine at ``spec_k=0`` and
   against the spec engine's plain path.  Then the same engine with a
   draft that cannot propose a seeded half of the vocabulary, so that
   proposals are rejected: launch counts, no leaked block, greedy streams
   against ``spec_k=0``.
4c. serve_int8_weights: ``weight_dtype="int8"``, ``spec_k=0``, the same
   traffic; B4's launch count exact; greedy streams against the plain
   path.  Then serve_int8_weights_d96: the same tier on a bf16 GPT-2 at
   n_embd 96 (2 heads of 48; block matrices multiples of 16, not of 64)
   over 8 of the requests, launch counts exact, greedy streams against
   the same engine on the CPU (every kernel its plain twin).
4d. serve_adapters, serve_adapters_int8: the same traffic from 8 tenants
   through rank-16 adapters (bf16 pages, then int8 pages with scales), the
   pool one page short of the adapters the tenants' Zipf map assigns; B9's
   launches exactly 2 x 12 per decode tick and per chunk, none on the
   plain path; greedy streams against the plain path; at least one
   eviction, no leaked page or block, and some greedy stream moved from
   the rank-0 serve drive's.
4e. serve_stripe, serve_stripe_int8_weights: the legacy stripe engine
   (``paged=False``, 8 slots of 512 positions, 151 MB in bf16) over the
   same traffic, model-dtype then int8 weights; B7 launched once per
   admission and once per decode tick, B4 4 x 12 times per forward at
   int8, nothing else; greedy streams against the paged drive of the same
   tier by the near-tie rule; tokens/s, TTFT and ITL, and the device's
   busy share over engine steps 12-27 of a fresh run
   (``utils/serve_profile.busy_window``).
4f. serve_migrate: two paged engines in one process; requests 1 and 2
   (greedy) and 3 (sampled) migrate mid-decode (``serve/migrate.py``),
   2 with ``quarantine_src=True``, then request 5 between two engines over
   int8 pools.  Migrated streams token for token the unmigrated drive's,
   the others by the near-tie rule; the source's free blocks up by the
   request's private blocks (unchanged under quarantine, those impounded);
   ``verify_attribution()`` on both engines; B5-B7 exact from both
   engines' counters; the copy's ms per request and per block.
4g. serve_chaos: the SERVE_POISON drill on one paged and one stripe
   engine: request 15 alone flagged, one slot quarantined, capacity back
   after the release, the kernels of each layout exact.
4h. serve_fleet: a ``ServingFleet`` of 3 smoke engines on the card over
   the serve traffic (fleet seed 0), the launch counters set to 0 just
   before each drill and read just after.  The JAX package's acceptance
   plan (REPLICA_POISON on replica 2 at tick 1, REPLICA_CRASH on 0 at 3,
   REPLICA_STALL on 1 at 6 for 10 ticks) under one monitor shared by the
   replicas (warm-up 4, primed with 4 clean serve requests, flags at z >
   1000): counters equal to ``predict_fleet()``; every request completed,
   greedy streams against the serve drive's by the near-tie rule, sampled
   ones token for token against one engine given the same seeds; states
   ``{0: healthy, 1: healthy, 2: quarantined}``; ``verify_attribution()``
   with a record spanning two journals; B5, B6 and B7 exactly n_layer x
   the decode ticks, n_layer x the prefill chunks, and the prefilled
   prompts plus the decode ticks, summed over every replica generation
   (the crashed one included, each generation's summary kept).  Then
   REPLICA_PREEMPT on replica 0 at tick 8 (at JAX's tick 3 every request
   there is still prefilling): migrations and preempts equal
   to ``predict_fleet(preempt_inflight=)`` at the decode-ready requests
   the replica held, every stream token for token the one engine's.  Then
   ``cli serve --fleet-replicas 2`` exits 0 with the fleet summary.  The
   line: each drill's wall and tokens/s beside the one engine's, the
   host's ms a tick outside the replicas' ``step()``, the ticks and ms
   from the crash until its requests are back in rows, a migration's
   hand-off ms.
4i. serve_fleet_control: the fleet's control plane on GPT-2 small (the
   launch counters set to 0 just before each drill and read just after).
   The JAX package's flood and autoscale drill: a 2 -> 3 fleet (4 slots,
   48 positions, queue 32, monitor off), three SLO classes with 60 s /
   10 s targets, a 100,000-token tenant bucket without refill and the
   flood tenant's own (40, 0), the queue-only autoscaler, 20 seeded
   diurnal requests closed loop at 10 open, a TENANT_FLOOD of 12 at tick
   8, then 24 idle ticks.  Counters equal to ``predict_fleet(autoscale=
   True, quota_tokens=40, flood_request_tokens=8)`` (1 scale-up, 1
   scale-down, 7 throttles); scale events ``[("up", 2, 3), ("down", 3,
   2)]``, one replica RETIRED with its journal kept; every stream token
   for token one engine's greedy stream, replica 2 serving at least one;
   neither ``standard`` nor ``premium`` breached; ``verify_attribution()``;
   no kernel library loaded and no storm after warmup.  Then JAX's
   disaggregated pools: ``pool_roles=("prefill", "decode", "decode")``, 5
   requests, 5 migrations, each ``disagg`` off replica 0, streams equal.
   B5 and B7 exactly as every replica generation's counters make them;
   every prompt fits one chunk, so B6 launches no time.  The line:
   scale-up to re-admission and the retiring replica's drain in ticks and
   ms, the host's ms a tick outside the replicas' ``step()``, the drill's
   tokens/s beside one engine's, a pool hand-off's ms.
4j. serve_adversary: JAX's sub-threshold attacker drill on GPT-2 small: 3
   replicas (6 slots, queue 4), the adaptive attacker on replica 2 (seed
   5, safety margin 0.08, signal scale 40, no jitter), a margin-signature
   monitor at 20.0, vote K 2, closed loop at 30 open requests until
   replica 2 is quarantined.  Counters equal to ``predict_fleet(vote_k=2)``;
   the only drain ``verdict_outvoted``; the strength trajectory equal to
   ``predict_attacker_trajectory`` over the recorded flags; no clean
   replica quarantined; clean streams token for token one engine's,
   corrupted ones not; attribution across the vote replays; no storm;
   the clean requests' largest mean margin printed beside the threshold.
   Then ``run_serve_envelope(device="cuda")`` at GPT-2 small's widths in
   bf16 on JAX's grid (3 strengths x 2 thresholds x 2 vote K, 3 replicas,
   24 requests): every cell completes its 24, no clean replica
   quarantined, no K = 0 cell reports ``vote``, one cell run twice gives
   the same record; the matrix (``render_table``) printed, and the sweep's
   wall.  B5 and B7 exact in both (B6 no time, as in 4i).
5. train: ``DistributedTrainer.train_epoch`` on GPT-2 small at full width
   (T = 1024, 4 nodes x 8 sequences, AdamW lr 1e-4, block remat, flash
   attention through ``attn_impl="auto"``, synthetic tokens from seed 0),
   with the launch counters set to 0 just before and read just after:
   detection OFF for 2 warm-up + 6 timed steps, then detection ON for 16
   steps with gradient poisoning of node 2 from step 12 (steps 2-11
   timed).  Node 2 must be gated on every attacked step and confirmed by
   the second, no other node ever flagged or gated, and the kernels
   launched exactly as the design says.  Then one step from the same
   state with flash and with full attention, and flash-vs-full attention
   fwd+bwd times at T = 512 and 1024.
5b. moe: ``gpt2-moe`` (``models/moe.py``: 8 experts, top-2, capacity
   factor 1.25, positional dispatch; 12 layers, 768 wide, 12 heads, vocab
   50257, bf16, random weights from seed 0) through ``DistributedTrainer``
   in data mode: 4 nodes x 4 sequences of 1024, AdamW lr 1e-4, block
   remat, flash, detection ON, node 2 gradient-poisoned from step 5 of
   10 (steps 2-4 under the profiler: the device's kernel time a step and
   busy share, ``utils/train_profile.busy_window``), then a fresh trainer
   with ``dispatch="priority"`` at capacity factor 0.5 for 4 clean steps
   (gate: every step's ``moe_drop_fraction`` >= 0.5, which E C = S k / 2
   forces), each run with the launch counters set to 0 just before and
   read just after.  Gates: the train phase's gating of node 2, finite
   losses, B1-B3 exactly as the steps make them (B1 at most 128 segments a
   launch: 4 x 17 gradient segments and 4 feature segments a step).  Then
   B1 over the MoE step's 68-segment gradient battery (2.08e9 values)
   against its plain twin, timed with its bound and library calls.  Step
   ms, tokens/s, peak memory and each step's drop fraction.
5c. envelope: ``experiments.run_detection_envelope`` on the card at GPT-2
   small's width (``model_overrides``: 12 layers, 768, 12 heads, vocab
   50257, 1024 positions, T 1024; bf16, no remat, flash; 4 nodes x 2
   sequences), gradient poisoning and byzantine at intensity 1.0 on node
   2 after 8 warm-up steps, 12 attacked steps, in a temporary directory,
   the counters set to 0 just before and read just after.  Gates (the
   JAX package's floors): every run finite, the clean run and the
   gradient-poisoning cell without a false positive, gradient poisoning
   detected at rate 1.0 within 3 steps with family attribution 1.0, the
   JSON and markdown artifacts written, B1-B3 exactly as the 60 steps make
   them; the byzantine cell is printed only.  The default targets at 4
   nodes, (1, 3), attack half the fleet, where the cross-node median can
   attribute neither (both packages; ``tests/test_torch_envelope.py``).
6. train_fused_ce: GPT-2 small at full width, 4 nodes x 16 sequences of
   1024 (16,384 tokens a node, where ``lm_head_chunk="auto"`` takes the
   vocab-chunked fused head at 8192 columns), block remat, flash, AdamW,
   detection ON, gradient poisoning of node 2 from step 4 of 8: the train
   phase's gates, exact B1-B3 launch counts and the fused head's call
   counts, with the counters set to 0 just before and read just after;
   ``migration_time`` in every reassignment record.  Then one step from
   the final state through four arms (fused head, materialised head,
   ``grad_accum_steps=2``, ``remat_policy="attention"`` on full
   attention): verdicts equal, per-node losses within ARMS_LOSS_ATOL,
   each arm's step ms and peak memory.  Then ``validate_metrics`` over 4
   validation batches through the fused eval head (against the
   materialised eval on the first), two Adafactor steps (state bytes
   beside AdamW's), and the fused head alone at [16384, 768] x 50257 bf16
   against the materialised cross-entropy, fwd+bwd: loss, dx and dW,
   times and peak memory.
7. experiment: ``ExperimentRunner`` at GPT-2 small's full width (T = 1024,
   ``attn_impl="auto"``, 4 nodes x 8 sequences, 4 steps an epoch, 5
   epochs, a validation batch after each), gradient poisoning of node 2
   at intensity 0.5 from epoch 3 (step 12), artifacts in a temporary
   directory: the results JSON loads, the CSV has ``trust_node_0..3``,
   the report exists, detection quality exact (targets [2], precision and
   recall 1, no false positive, node 2 confirmed within 2 steps), B1-B3
   launched exactly as 20 steps and 5 validations make them, with the
   counters set to 0 just before the run and read just after.
8. survival: the JAX package's scripted drill (a lost batch at step 3, a
   0.01 s stall at 7, the step-10 checkpoint corrupted after its commit,
   NaN params after step 12, a preemption at 18) at the same geometry,
   checkpoints every 5 steps, 4 epochs of 8 steps, through
   ``TrainingSupervisor(max_retries=2, rollback_after=2,
   max_restarts=2)``: the report equal to ``FaultPlan.predict``, every
   fault fired, the rollback at step 5 (past the corrupt step 10), the run
   completed with its last epoch's loss finite and under its first's, and
   B1-B3 launched exactly as the drill's step executions make them.
   Then the newest checkpoint corrupted: a fresh trainer's
   ``load_checkpoint()`` lands on the prior verified step with params
   bit-equal to its files, and two restores of it each take one step on
   the same batch with bit-equal per-node losses.  Each save's bytes and
   seconds (host copy, write, CRC), each restore's (read, copy to the
   card) and each integrity check's.  The drill's directory is removed
   at the end of the phase.  The drill runs at ``async_host_depth=0``:
   ``FaultPlan.predict``'s retry counts are the synchronous guard's.
9. async_host: the train geometry, detection ON, node 2 poisoned from
   step 4: runs of 8 steps at ``async_host_depth`` 0 and 2 from the
   same state (each arm's step ms over its last 6 steps), then a
   12-step epoch of each depth with steps 3-10 under the profiler (the
   device's busy share in a steady window,
   ``utils/train_profile.busy_window``); losses, per-node losses,
   trust, weights, statuses and incidents bit-equal in every run, B1-B3
   exact.  Then a GRAD_NAN drill at depth 2 (checkpoints every 4 steps,
   NaN params after step 5, ``rollback_after=1``): the report equals the
   lagged arithmetic (no retry, the rollback to step 4, steps 7-8 in
   flight discarded, steps 1-5 accounted).
10. elastic: the train geometry with ``elastic_resharding`` and
   ``readmit_after_steps=8``, node 2 poisoned from step 6: confirmed at
   step 8 and evicted at 10 (the depth-2 drain), the loader re-sized to 3
   x 8, the eviction record timed (``migration_time_s``,
   ``measured_gbps``); a save, and a fresh 4-node trainer's resume onto
   the 3-node topology with its node map and cool-off; the attack
   cleared, node 2 readmitted at step 18 on probation (recovery rate
   0.02, fresh baselines), the loader back to 4 x 8; B1-B3 exact for each
   step's node count, every loss finite.
10b. pipeline: GPT-2 small at full width through
   ``DistributedTrainer(parallelism="model")``: 4 stages of 3 layers, 4
   microbatches of 2 x 1024 tokens, AdamW.  The pipelined loss and every
   block gradient against the sequential forward over the unstacked
   blocks (JAX's test tolerance, rtol 5e-2, atol 5e-3).  A trusted run
   (``elastic_resharding``, ``readmit_after_steps=4``): stage 2 poisoned
   from step 5, confirmed at 7, gated from its first attacked step,
   restaffed 4 -> 3 at 9 (``choose_stage_count(12, 3)``), the attack
   cleared, node 2 back in the pool at 13 and the pipeline regrown 3 -> 4;
   every layer's params move after the restaff, the survivors' trust
   rows carry over, no clean stage flagged, every loss finite.  The
   restaffed checkpoint restored by a fresh 4-stage trainer: its next
   step's loss equals the running trainer's.  Byzantine compute on stage
   1 after a clean epoch (its busy window: busy share, host enqueue):
   flagged by the canary at the first attacked step, no other stage.
   B1-B3 exact in both runs (M x L = 48 of B2, dq and dk/dv a step at
   any stage count, one B1), and each against its plain twin at the
   pipeline's shapes (``pipeline_case``).  The schedule study at S = 4,
   M in (1, 2, 4, 8), batch 16, one layer a stage at GPT-2 small's
   width: step time, bubble fraction, peak bytes above the state.
10c. sequence: the non-causal instances of B2 and B3 (``causal=False``)
   at [96, 256, 64] (the ring's chunk) and [96, 1024, 64] bf16 against
   their plain twins (the causal cases' tolerances), timed with events and
   the profiler's ``device_ms`` beside their bounds and SDPA with
   ``is_causal=False``, forward and whole backward (``sequence_case`` in
   the B2/B3 entries), and ``flash_chunk``'s backward under a nonzero lse
   cotangent against the twins.  Ring attention at [8, 12, 1024, 64] bf16
   over 4 positions of the card, forward and gradients: each within 2x
   the data-mode flash attention's error against f32 full attention on
   the same inputs, exactly 4 causal and 6 non-causal launches of B2, dq
   and dk/dv; Ulysses against the model's full attention.  GPT-2 small
   through ``DistributedTrainer(parallelism="sequence", mesh=build_mesh(4,
   "sequence", devices=["cuda"] * 16))``, a (4, 4) mesh, a ring of 4, 4
   nodes x 8 x 1024, node 2 poisoned from step 5, beside a data-mode
   trainer from the same seed on the same batches: every step's loss
   within SEQ_LOSS_RTOL relative, and a control (the ring with its
   below-diagonal chunks dropped) outside it, the same incident, B1-B3
   exact (10 B2, dq and dk/dv a layer a node-step, 6 of them
   non-causal), step ms, busy share over one step and peak memory of
   both.  Then a 2-step ``cli train
   --parallelism sequence``, a ring of 1: B2 launches as data mode's at
   that shape.
10d. group_modes: GPT-2 small at full width on position meshes over
   the card, 4 nodes x 2 x 1024, no remat, node 2 poisoned from step 5:
   data mode, then tensor on ``build_mesh(4, "tensor", devices=["cuda"]
   * 8)`` (4, 2), hybrid ``{data: 4, model: 2}`` and data mode with
   ``shard_opt_state`` and ``shard_params`` on 4 data positions, 7 steps
   each: every step's loss, trust, gates and statuses equal to data
   mode's bit for bit, B1-B3 exact (336 of each flash kernel, 14 B1) and
   equal, the params' and moments' bytes a position
   (``tree_bytes_per_device`` over the specs) equal to the arithmetic of
   GPT-2 small's shapes, printed beside ``torch.cuda.memory_allocated``.
   ``gpt2-moe`` (8 experts, block remat) on a (4, 2) data x expert mesh,
   2 steps of 4 x 1 x 1024, equal to its data-mode run bit for bit, the
   expert mesh bound. Tensor mode with ``elastic_resharding`` (depth 0):
   node 2 evicted at step 7 to a (3, 2) mesh of 6 positions, the attack
   cleared, readmitted at step 9 to (4, 2), the records and node maps as
   predicted, the layout then equal to a fresh tensor trainer's, B1-B3
   exact over the 38 node-steps.
10e. serve_tp: tensor-parallel serving replicas on the card.  The serve
   phase's 16 requests on a smoke engine at ``tp_size`` 1 and at 2 (a
   ``model`` mesh of 2 positions, both ``cuda:0``, the params with the TP
   layout): every stream equal to the other arm's and to the serve
   phase's, B5, B6 and B7 exactly as each engine's counters make them and
   equal between the arms; tokens/s and peak memory of each; the TP-2
   specs' bytes a position (``tree_bytes_per_device``) beside
   ``torch.cuda.memory_allocated``.  The HBM gate with a budget 40 blocks
   above what is allocated: both widths shrink the pool to the same
   blocks (the gate divides by distinct devices, 1 here).  Then JAX's TP
   scale-up scenario on real engines: 2 replicas at TP 1, ``tp_max`` 4, 4
   slots each, 8 requests filling every slot (occupancy pressure, a queue
   below its threshold): one scale-up, one ``tp_scale_ups``, replica 2
   at TP 2, ``chips_in_service`` 2 -> 4; 4 more requests once it is
   healthy, replica 2 serving some; every stream equal to one engine's;
   ``verify_attribution()``; B5 and B7 exactly as every generation's
   counters make them.
10f. multihost: two processes on the card (``utils/multiproc_worker``),
   joined over gloo on 127.0.0.1 (``initialize_multihost``), run the
   gathered trusted step at GPT-2 small's width: 4 nodes (2 a rank) x 8 x
   1024, 3 steps, gradient and data poisoning of nodes 1 and 2 from step 1.
   Both exit 0; losses, trust and the final params' hash equal across the
   ranks; B1-B3 per rank exactly as its 2 nodes a step make them; the
   losses within 1e-5 relative and the trust within 1e-5 of the
   one-process run in this process (whether they are bit-equal is
   printed).  Per rank: step ms, the gather's ms and bytes, peak memory,
   the last step's busy share; the card's compute mode (two CUDA
   contexts on one card need ``Default``).

11. vision: ``ExperimentRunner`` on the three vision presets at their
   own configuration (8 nodes, batch 32, synthetic CIFAR-10 32x32x3
   images of 10 classes, bf16, full published widths; random weights
   from seed 0), epochs cut: ``vgg16_cifar10_poisoning`` (gradient and
   data poisoning of nodes 1 and 3 from step 12 of 18) and
   ``resnet101_byzantine`` (418 leaves, 42.5M params; Byzantine nodes 1
   and 3 from step 12 of 18): the targets gated on every attacked step and
   confirmed after the start, no other node flagged or gated, every loss
   finite; ``resnet32_cifar10_clean`` 52 steps, no node flagged, and,
   where scikit-learn imports, ``ml_flags`` for all 8 nodes after the
   second epoch's refit (else 26 steps and the tier off, nothing fed:
   JAX's gate, and the line says so).  B1 launched exactly ceil(8 L / 128) + 1 times a
   step for L leaves (28 for ResNet-101, 5 for VGG-16, 10 for ResNet-32),
   no other kernel; B1 at each drive's gradient mix against its plain
   twin, timed (ResNet-101's with the twin, bound and library calls);
   each drive's step ms, samples/s, peak memory, the host's
   record-keeping ms a step (the ML tier's feed included), busy share and
   the host's enqueue ms (``busy_window`` over step 3 of a fresh 4-step
   epoch), and one step's host time by ``tddl.*`` range.  The
   host ``AttackDetector`` on the card: the exact battery of ResNet-101's
   concatenated gradient against numpy, the Byzantine and backdoor
   checks on card tensors.

12. text: raw text to served text through ``cli.main``, in a temporary
   directory.  The checkout's Markdown documents and the port package's
   .py sources, read as text and repeated to 4 MB, become
   ``openwebtext.txt``; ``prepare --vocab-size 8192`` writes the ``.bin``
   and the tokenizer (gates: decode(encode(corpus)) is the corpus, every
   id under 8192, the ``.bin``'s bytes the uint16 ids, the 5% holdout
   holds a validation batch; the BPE training and encoding seconds and
   which pre-tokenizer ran).  ``train --config`` (the nested README
   schema in JSON, and in YAML where pyyaml imports: both resolve equal;
   ``profile_dir`` set) with ``--seq-len 1024 --epochs 1
   --steps-per-epoch 4`` and ``TDDL_DATA_DIR`` on the corpus: the train
   phase's 4 nodes x 8 sequences of 1024, block remat, detection ON
   (gates: the file's values applied and the flag's epochs over the
   file's, batches with ids >= 512, finite losses, B1-B3 exact for 4 steps
   and the validation batch, a Chrome trace with the 4 ``train_step#N``
   annotations and kernel events, the checkpoint committed).  ``serve
   --checkpoint-dir`` over 8 requests of 32-128 prompt tokens, greedy,
   then sampled (gates:
   "restored step 4", B5 and B6 exact from the engine's counters, B7
   launched, the restored params bit-equal to the trainer's final ones,
   the greedy streams equal to an engine built in-process on those
   params).  ``generate --prompt-text --tokenizer-dir`` at the defaults
   (top-k 40), with ``--top-p 0.9``, with ``--top-k 1`` and greedy (gates:
   every draw inside the keep-set the CPU computes from the same logits,
   top-k 1 equal to greedy, the decoded text printed).
12b. host_tier: the C++ host tier (``native/``) and the kernel-build
   cache (``utils/compile_cache.py``), host code.  At the train phase's
   geometry (512 windows of 1024 from the synthetic stream of 524,801
   tokens): the synthetic stream, a permutation of the windows, the 4 x 8
   x 1024 row gather and the 32 x 1024 window gather, each bit-equal to
   its numpy twin, with both tiers' host ms and the loader's ms a batch.
   The text phase's corpus encoded by fresh tokenizers through the C++
   batch encoder and through the Python merge loop: ids equal, seconds
   and tokens/s of each.  Then two fresh processes warm one new cache
   directory under ``build/`` (``python -m
   trustworthy_dl_tpu_torch.utils.compile_cache``): the first records an
   ``nvcc_build`` for each of the five kernel libraries and a
   ``gxx_build`` for the native one, the second records no build and six
   loads; each one's seconds; the directory is removed.  The ``build``
   line also carries the native library's ``g++`` seconds.

13. obs: the telemetry plane (``trustworthy_dl_tpu_torch/obs``) on the
   card.  Serve: the serve phase's GPT-2 small geometry over the 16 smoke
   requests, driven closed-loop (at most 8 open, so a watcher can never
   shed one), once bare and once under an ``ObsSession`` (spans, the
   attribution ledger, the default SLO rules, the anomaly watcher, the HBM
   monitor, the compile watcher and forensics: what ``cli serve --obs-dir``
   opens); gates: every stream, entropy and margin bit-identical between
   the arms, B5-B7 launched the same counts, no library loaded and no
   compile storm under the watch, every trace line valid, one
   attribution record per request whose ``token_hash`` is its stream's and
   ``verify_attribution`` clean, one ``serve.request`` span per request in
   ``trace_events.json``, ``tddl_serve_tokens_total`` the tokens emitted;
   both arms' tokens/s, the events and their bytes, and a trace bus's
   per-event emit cost.  Open loop: the 16 requests queued whole, as ``cli
   serve`` queues them, under such a session, whose watchers may shed
   queued requests; gates: every request completed or shed (the summary's
   ``requests_shed_slo`` the count), the completed ones whole with greedy
   streams following the bare arm's by the near-tie rule, one attribution
   record each (shed ones not admitted) and ``verify_attribution`` clean;
   the shed count printed.  Forced storm: the same traffic under such a
   session, with the paged-attention library dropped from the loaded set
   inside the third guarded decode, so that its next launch loads it again
   through ``ops.kernel_library``; gates: exactly one load, one storm
   episode, one ``compile_storm`` flight dump and its paired incident,
   which ``cli obs incident list --dir`` prints, streams equal to the bare
   arm's; the load's seconds printed.  The two sessions share one
   temporary perf ledger: the second's sentinel verdict and ``cli obs
   diff`` over the two directories printed, with ``analyze_programs``'
   decode and prefill counts.  HBM gate: an engine under an ``HbmMonitor``
   whose budget is the allocated bytes plus half the KV pool's: the pool
   shrunk to what the gate computed, one ``hbm_pressure`` event and
   ``tddl_hbm_pressure_total`` 1, 4 requests served as in the bare arm, the
   watermark between the pool's bytes and ``max_memory_allocated``. Train:
   the train geometry (4 nodes x 8 x 1024, detection ON, node 2 poisoned
   from step 4), 8 batches supervised at depth 0 with NaN params after step
   7 (the bad step 8, two retries, a rollback to step 0), once bare and
   once under a session; gates: trajectories and B1-B3 launches equal
   between the arms and as the 10 step executions make them, ``train_step``
   per accounted step, ``detection_verdict`` naming node 2, ``guard_trip``,
   ``supervisor_retry``, ``chaos_fault``, ``ckpt_commit``, flight dumps
   beside the checkpoints, each with its paired incident (forensics on),
   no compile storm, and ``obs_report.json``'s mean step within 10% of the
   steps' wall, its MFU against the H100 peak and ``mfu_analyzed`` between
   0 and 1 (the session's first step counted: library products through
   ``FlopCounterMode``, B1-B3 through their shape counts, every one of them
   non-zero but B1's; its rate over the other steps), and the counter's
   count of an f32-out product (``aten::mm.dtype``, the fused head's) exact;
   the phase fractions, both MFUs, ``flops_per_step`` and the counted first
   step's wall beside step 2's (both arms) printed.  Every session's perf
   ledger and verdict store is an explicit path under the phase's temporary
   root, whatever the environment names.

The line before the last two is the ``kernels`` summary, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# Kernel-vs-plain tolerances.  bf16 attention outputs: the kernel and the
# plain version both accumulate in f32 and round to bf16, in another
# summation order, so they may differ by one bf16 step, 2^-7 relative.
# The outputs are weighted means of unit-normal V rows over hundreds of
# keys, about 0.1 in size, where one step is about 5e-4: atol 2e-3 +
# rtol 2^-7, a few steps and not a tenth of a typical value.  The trust
# epilogue: margin exactly equal (max/min only), entropy within 1e-4 (one
# f32 pass over 50257 terms against log_softmax's two).
ATTN_ATOL = 2e-3
ATTN_RTOL = 2.0 ** -7
ENTROPY_ATOL = 1e-4
# Greedy streams of the kernel path and the plain path are compared while
# their tokens agree.  At the first disagreement the plain path's top-1
# margin there must be below NEAR_TIE_MARGIN: under it the two paths'
# last-bit differences may flip the argmax legitimately (the parity
# tolerance of the JAX package's int8 probe).  At every agreeing position
# the two paths' margins differ by less than that same bound, and their
# entropies by less than about one bf16 step of logits of size 1-2
# (2^-7), which bounds how far the entropy moves when every logit moves
# by at most one step and the logits' spread is about 1.
NEAR_TIE_MARGIN = 0.05
SERVE_MARGIN_ATOL = NEAR_TIE_MARGIN
SERVE_ENTROPY_ATOL = 1e-2
# Moment battery (B1): min, max and max|x| exactly equal (order-free); each
# sum within 1e-5 of the matching magnitude sum (sum |x|^p), the f32
# rounding of a sum over up to 38.6M terms taken in another order.  Flash
# kernels (B2, B3): the attention tolerance above; lse within 1e-3 (f32
# logsumexp over bf16 score products).  Train comparison, flash vs full
# attention from the same state: per-node losses within 2e-2 (bf16
# compute), every verdict vector equal.
MOMENT_RTOL = 1e-5
LSE_ATOL = 1e-3
FLASH_VS_FULL_LOSS_ATOL = 2e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/paged_attention.cu"
# B5's and B6's bf16-query kernels (each over both pools), by the name the
# profiler reports.
DECODE_KERNEL = "decode_split_kernel"
PREFILL_KERNEL = "prefill_mma_kernel"
STATS_SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/fused_stats.cu"
FLASH_SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/flash_attention.cu"
DQ_SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/fused_dequant_matmul.cu"
DQ_KERNEL = "dq_split_kernel"
# B7's kernel and B8's (one launch: the vocab stream and the fold), by the
# names the profiler reports.
TRUST_KERNEL = "trust_cluster_kernel"
VERIFY_KERNEL = "verify_stream_kernel"
ADAPTER_SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/adapter_delta.cu"
# B9: f32 sums of bf16 or int8 x bf16 products in another order than the
# plain twin's einsum: within 1e-5 of the plain output's largest
# magnitude; rows on the zero page exactly 0.0.
ADAPTER_RTOL = 1e-5
ADAPTER_RANK = 16
# B4: each output within 1e-5 of sum |x| |w| scale over its terms (f32
# summation order only: bf16 x int8 products are exact in f32).  B8: the
# logits within one bf16 step of the plain twin's plus that same f32 sum
# bound (the twin's f32 product in another order, each rounded to bf16),
# the margin exactly top-2 of the kernel's own logits, the entropy within
# ENTROPY_ATOL.
DQ_RTOL = 1e-5
SPEC_K = 4
# GPT-2 small's four block matrices (K, N): qkv, attention proj, fc, mlp
# proj; then n_embd 96's qkv (K and N multiples of 16, not of 64).
DQ_SHAPES = {"qkv": (768, 2304), "attn_proj": (768, 768),
             "fc": (768, 3072), "mlp_proj": (3072, 768),
             "d96_qkv": (96, 288)}
# B4's rows: decode batch 1, a draft step's 8, 16, a prefill chunk's 64.
DQ_ROWS = (1, 8, 16, 64)
# Train phase geometry (GPT-2 small at full width).
TRAIN_NODES, TRAIN_BATCH, TRAIN_T = 4, 32, 1024
OFF_WARMUP, OFF_TIMED = 2, 6
ON_STEPS, ATTACK_START, ON_WARMUP = 16, 12, 2
# moe geometry: gpt2-moe (8 experts, top-2) at GPT-2 small's width, 4 x
# 1024 tokens a node, 10 steps with node 2 poisoned from step 5, then 4
# clean steps of the priority dispatcher at capacity factor 0.5 (E C =
# S k / 2 slots: at least half the assignments must drop).
MOE_BATCH, MOE_STEPS, MOE_ATTACK_START = 16, 10, 5
MOE_PRIORITY_STEPS, MOE_PRIORITY_FACTOR = 4, 0.5
MOE_BUSY_FIRST, MOE_BUSY_LAST = 2, 4
# envelope: the detection sweep at GPT-2 small's width, 4 nodes x 2 x 1024
# tokens, node 2 attacked after 8 warm-up steps, for 12 steps.
ENVELOPE_WARMUP, ENVELOPE_ATTACK, ENVELOPE_TARGETS = 8, 12, (2,)
ENVELOPE_TYPES = ("gradient_poisoning", "byzantine")
# train_fused_ce geometry: 64 x 1024 over the 4 nodes, 8 steps, gradient
# poisoning of node 2 from step 4, then 4 validation batches.
FCE_BATCH, FCE_STEPS, FCE_ATTACK_START, FCE_VAL_BATCHES = 64, 8, 4, 4
# One step from the same state through the four arms: per-node losses
# within ARMS_LOSS_ATOL of the fused arm's, and the first validation
# batch's fused eval loss within it of the materialised one.  The
# materialised arms round every logit to bf16 where the fused head keeps
# them in f32, and the attention arm runs full attention where the others
# run flash; each per-node loss is a mean over 16,384 tokens, so those
# roundings mostly cancel.  The limit sits between what the sound arms
# read (at most 4.2e-5 on an H100 80GB HBM3 at 700 W) and what a head that
# let wte's 47 padded columns into its softmax would shift the loss by
# (8.9e-4 there), which the phase computes from the same state each run
# and requires to exceed the limit.
ARMS_LOSS_ATOL = 1.5e-4
# The fused head alone against the materialised cross-entropy on the same
# bf16 inputs: the loss within FCE_LOSS_RTOL relative (sound: 8.7e-7 on
# that card; the padded-columns fault, 7.3e-5 there, is computed each run
# on the same inputs and must read above it), dx and dW within 2^-7 of their largest
# magnitude (the materialised backward's bf16 dlogits and products, one
# bf16 step).
FCE_LOSS_RTOL = 2e-5
FCE_GRAD_RTOL = 2.0 ** -7
# experiment geometry: the train phase's 4 nodes x 8 sequences of 1024, 4
# steps an epoch, 5 epochs, node 2 poisoned from epoch 3 (step 12, past
# detector_warmup 10) at intensity 0.5.
EXP_STEPS_PER_EPOCH, EXP_EPOCHS, EXP_ATTACK_EPOCH = 4, 5, 3
# survival: the JAX package's scripted drill (tests/test_survival.py).
DRILL_EPOCHS, DRILL_STEPS_PER_EPOCH, DRILL_INTERVAL = 4, 8, 5
# The serve_fleet phase: JAX's acceptance plan (tick, kind, replica,
# severity), its FleetConfig, and the preempt drill's event.  The preempt
# fires at tick 8, not JAX's 3: the smoke's prompts take 2-5 chunks, so at
# tick 3 every request replica 0 holds is still prefilling and nothing
# could move as a block copy; by tick 8 all of them decode.
FLEET_DRILL = ((1, "REPLICA_POISON", 2, 1.0), (3, "REPLICA_CRASH", 0, 1.0),
               (6, "REPLICA_STALL", 1, 10.0))
FLEET_PREEMPT = ((8, "REPLICA_PREEMPT", 0, 1.0),)
FLEET_CONFIG = dict(num_replicas=3, max_retries=6, heartbeat_miss_limit=3,
                    restart_ticks=2, drain_grace_ticks=4,
                    quarantine_cooloff_ticks=10_000)
FLEET_MAX_TICKS = 400
# The serve_fleet_control phase: JAX's flood and autoscale drill
# (tests/test_fleet_control.py) with its knobs, at GPT-2 small's width.
CONTROL_FLOOD = (8, 12)                # tick, requests of the flood
CONTROL_ENGINE = dict(max_slots=4, max_seq=48, queue_limit=32,
                      enable_monitor=False)
CONTROL_AUTOSCALE = dict(min_replicas=2, max_replicas=3,
                         scale_up_queue_per_replica=6.0,
                         scale_down_queue_per_replica=0.5,
                         scale_up_occupancy=1.1, scale_down_occupancy=1.0,
                         scale_up_cooldown_ticks=200,
                         scale_down_cooldown_ticks=8,
                         scale_down_idle_ticks=6)
CONTROL_WORKLOAD = dict(seed=5, num_requests=20, mean_rps=16.0,
                        burstiness=0.6, prompt_median=6, output_median=5,
                        max_output=8)
CONTROL_OPEN, CONTROL_IDLE_TICKS, CONTROL_MAX_TICKS = 10, 24, 4000
# The serve_adversary phase: JAX's sub-threshold attacker drill
# (tests/test_fleet.py) and its monitor threshold; then the envelope.
ADVERSARY_THRESHOLD = 20.0
ADVERSARY_REQUESTS, ADVERSARY_OPEN = 150, 30
GPT2_SMALL = dict(n_layer=12, n_embd=768, n_head=12, vocab_size=50257,
                  n_positions=1024)

DRILL_SCRIPT = ((3, "data_loss", 1.0), (7, "stall", 0.01),
                (10, "ckpt_corrupt", 1.0), (12, "grad_nan", 1.0),
                (18, "preempt", 1.0))
DRILL_RETRIES, DRILL_ROLLBACK_AFTER, DRILL_RESTARTS = 2, 2, 2
# async_host: detection-ON runs of ASYNC_STEPS steps at async_host_depth 0
# and 2, in the order ASYNC_ORDER (the first ASYNC_WARMUP steps of each
# run untimed), node 2 poisoned from step ASYNC_ATTACK (detector_warmup
# 2); then the GRAD_NAN drill at depth 2: checkpoints every 4 steps, NaN
# params after step 5, rollback_after 1, one epoch of 8 steps.
# One run a depth, for the smoke's time limit; the bit-equality gate
# holds as with runs in turns.
ASYNC_ORDER, ASYNC_STEPS, ASYNC_WARMUP, ASYNC_ATTACK = (0, 2), 8, 2, 4
NAN_INTERVAL, NAN_STEP, NAN_STEPS = 4, 5, 8
# elastic: node 2 poisoned from step 6 (detector_warmup 4), readmission
# after 8 steps; epoch 0 12 steps at 4 x 8, then, after a save and a
# resume onto the saved topology, 10 steps of 3 x 8 rows with the attack
# cleared.
ELASTIC_ATTACK, ELASTIC_READMIT, ELASTIC_STEPS = 6, 8, (12, 10)
# pipeline: GPT-2 small in 4 stages of 3 layers, 4 microbatches of 2 x
# 1024 tokens (batch 8), AdamW at 1e-4, detector_warmup 4.  The trusted
# run: stage 2 poisoned from step PIPE_ATTACK, confirmed two steps later
# and restaffed 4 -> 3 two steps after that (the async pipeline's drain);
# the attack is cleared at the end of the first epoch (PIPE_EPOCHS[0]
# steps) and the evicted id re-enters after PIPE_READMIT steps, regrowing
# 3 -> 4.  The Byzantine run: a clean epoch of PIPE_BUSY_STEPS steps (the
# busy window over its steps PIPE_BUSY_FIRST-PIPE_BUSY_LAST), then
# Byzantine compute on stage 1 for PIPE_BYZ_STEPS steps.  The study: S =
# 4, M in PIPE_STUDY_MICRO, batch 16, one layer a stage at GPT-2 small's
# width, 2 timed steps a cell.
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 4, 8
PIPE_ATTACK, PIPE_READMIT, PIPE_EPOCHS = 5, 4, (10, 6)
PIPE_BUSY_STEPS, PIPE_BUSY_FIRST, PIPE_BUSY_LAST = 5, 3, 4
PIPE_BYZ_STEPS = 4
PIPE_STUDY_MICRO, PIPE_STUDY_BATCH, PIPE_STUDY_STEPS = (1, 2, 4, 8), 16, 2
# JAX's own pipeline test tolerance (tests/test_pipeline.py) for the
# pipelined loss and block gradients against the sequential forward.
PIPE_RTOL, PIPE_ATOL = 5e-2, 5e-3
# sequence: the non-causal kernel cases (BH, T) at D = 64; ring attention
# at SEQ_ATTN_SHAPE over SEQ_RING positions of the card, its error within
# SEQ_ERR_RATIO x the data-mode flash attention's; the trainers at the
# train geometry on a (4, SEQ_RING) mesh, SEQ_STEPS steps with node 2
# poisoned from SEQ_ATTACK (detector_warmup 4), the busy window over step
# SEQ_BUSY_STEP, every step's loss within SEQ_LOSS_RTOL of data mode's
# and a ring that drops its below-diagonal chunks outside it (on an H100
# the sound ring's largest gap over the 8 steps read 4.23e-5, the
# control's 1.21e-2; the limit sits 12x over the one and 24x under the
# other); the CLI's steps.
SEQ_CASES = ((96, 256), (96, 1024))
SEQ_RING, SEQ_ATTN_SHAPE, SEQ_ERR_RATIO = 4, (8, 12, 1024, 64), 2.0
SEQ_STEPS, SEQ_ATTACK, SEQ_BUSY_STEP, SEQ_LOSS_RTOL = 8, 5, 3, 5e-4
SEQ_CLI_STEPS = 2
# group_modes: GPT-2 small at full width on position meshes over the
# card, 4 nodes x GROUP_ROWS x 1024 tokens.  Arms (a) data, (b) tensor on
# a (4, 2) mesh, (c) hybrid {data: 4, model: 2}, (d) data with ZeRO-1 and
# FSDP on 4 data positions: GROUP_STEPS steps with node 2 poisoned from
# GROUP_ATTACK (detector_warmup 4), every step's loss, trust, gate and
# status bit-equal to (a)'s, B1-B3 exact and equal.  (e) gpt2-moe (8
# experts, block remat) on a (4, 2) data x expert mesh beside its own
# data-mode run, GROUP_MOE_STEPS clean steps of GROUP_MOE_ROWS rows a
# node, bit-equal.  (f) tensor with elastic_resharding at async depth 0:
# node 2 confirmed at step GROUP_ATTACK + 2 and evicted (mesh (3, 2)), the
# attack cleared, readmitted GROUP_READMIT steps later (mesh (4, 2)), one
# more step; its layout then equals a fresh tensor trainer's.
GROUP_ROWS, GROUP_STEPS, GROUP_ATTACK = 2, 7, 5
GROUP_MOE_ROWS, GROUP_MOE_STEPS, GROUP_READMIT = 1, 2, 2
# serve_tp: the serve phase's traffic on a TP-1 and a TP-2 engine; the
# HBM gate's budget TP_GATE_BLOCKS blocks above what is allocated, so
# both widths shrink their pool to that; the fleet drill is JAX's
# scenario (2 replicas at TP 1, tp_max 4) on real engines of TP_FLEET
# slots: TP_FLEET_FIRST requests fill every slot (occupancy pressure,
# queue per replica below the 8.0 threshold), the scale-up brings replica
# 2 at TP 2, and TP_FLEET_SECOND more arrive once it is healthy.
TP_GATE_BLOCKS = 40
TP_FLEET = dict(max_slots=4, max_seq=48, queue_limit=32,
                enable_monitor=False)
TP_FLEET_FIRST, TP_FLEET_SECOND, TP_FLEET_MAX_TICKS = 8, 4, 400
# multihost: two worker processes on the card over gloo at GPT-2 small's
# width, 4 nodes (2 a rank) x 8 rows of 1024 tokens, MULTIHOST_STEPS
# steps under the live plan (gradient and data poisoning of nodes 1 and
# 2 from step 1); each rank's losses within MULTIHOST_LOSS_RTOL of the
# one-process run in this process (the same kernels on the same inputs:
# expected equal), its trust within MULTIHOST_TRUST_ATOL.
MULTIHOST_STEPS, MULTIHOST_TIMEOUT_S = 3, 420
MULTIHOST_LOSS_RTOL, MULTIHOST_TRUST_ATOL = 1e-5, 1e-5
# vision: the runner's three vision presets at their own configuration (8
# nodes, batch 32, CIFAR-10's 32x32x3 images and 10 classes, bf16, full
# published widths), epochs cut to fit: (preset, epochs, steps an epoch,
# attack start epoch).  VGG-16 and ResNet-101 are attacked on nodes 1
# and 3 from step 12 (past detector_warmup 10); ResNet-32 runs 52 clean
# steps, so that the ML tier's refit after its second epoch has 52
# samples a node (its floor is 50).  Without scikit-learn the tier is off
# and nothing is fed, so the clean drive runs VISION_CLEAN_PER_EPOCH_NO_ML
# steps an epoch instead (26 in all, past detector_warmup 10).
VISION_NODES, VISION_BATCH, VISION_TARGETS = 8, 32, (1, 3)
VISION_DRIVES = (("vgg16_cifar10_poisoning", 3, 6, 2),
                 ("resnet101_byzantine", 3, 6, 2),
                 ("resnet32_cifar10_clean", 2, 26, None))
VISION_CLEAN_PER_EPOCH_NO_ML = 13
# Each drive's busy share and host enqueue: ``busy_window`` over step 3
# of a fresh 4-step epoch.  One profiled step, not three: reading a
# ResNet-101 window's trace back took most of that drive's 122 s.
VISION_BUSY_FIRST, VISION_BUSY_LAST, VISION_BUSY_STEPS = 3, 3, 4
# The host detector on the card, over ResNet-101's concatenated gradient
# (42.5M f32 values), against numpy on the same values: median and
# quartiles within ORDER_RTOL relative (the sort picks the same elements;
# the interpolation rounds in f32 on the card and in f64 in numpy), min
# and max exact, the mean within MOMENT_RTOL of the std and the std and L2
# norm within MOMENT_RTOL relative (f32 sums of 42.5M terms in another
# order than numpy's f64 sums).
ORDER_RTOL = 1e-6
# text: the corpus (the checkout's Markdown and the port's .py sources)
# repeated to at least TEXT_CORPUS_BYTES, so that the loader's 5% holdout
# holds one validation batch of TRAIN_BATCH windows of TRAIN_T tokens (the
# validation loader takes at most TEXT_VAL_WINDOWS: max(32 x 4 / 10, 32));
# a BPE of TEXT_VOCAB ids (JAX's default); TEXT_STEPS train steps at the
# train phase's geometry, then TEXT_SERVE_REQUESTS served requests and
# four generate runs of 32 tokens from TEXT_PROMPT.
TEXT_CORPUS_BYTES = 4_000_000
TEXT_VAL_WINDOWS = 32
TEXT_VOCAB = 8192
TEXT_STEPS = 4
TEXT_SERVE_REQUESTS = 8
TEXT_PROMPT = "The trusted training step gates every node by"
# obs: OBS_STEPS batches of the train geometry, node 2 poisoned from step
# OBS_ATTACK (detector_warmup 2), NaN params after step OBS_NAN_STEP; the
# bad step retried DRILL_RETRIES times, then rolled back (rollback_after
# 1) to the step-0 checkpoint with the loader spent.  The report's mean
# step within OBS_STEP_RTOL of the accounted steps' wall; OBS_EMITS emits
# time the trace bus.
OBS_STEPS, OBS_ATTACK, OBS_NAN_STEP = 8, 4, 7
OBS_STEP_RTOL = 0.10
OBS_EMITS = 5000
# The guarded decode inside which the forced-storm arm drops a library.
FORCED_STORM_DECODE = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def one_card() -> str:
    """Make the first visible card the only one this process sees, so the
    run and its report name one card; returns its index or UUID."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.strip() or "0"
    return os.environ["CUDA_VISIBLE_DEVICES"]


def nvidia_smi_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--id={card}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median ms of one call of ``fn``, each launch timed alone between
    CUDA events with the L2 cache flushed before it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, flush, kernel: str, reps: int = 25) -> float:
    """Mean device time of one call's ``kernel`` (a substring of the CUDA
    kernel's name, launched once a call) over ``reps`` calls with the L2
    flushed before each, from ``torch.profiler``
    (``utils/kernel_ab.device_ms``, which counts the launches): the
    kernel's own time, where ``time_ms``'s event window also holds the
    host's dispatch of the call whenever the card waits for it."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    return kernel_ab.device_ms(fn, flush, reps, kernel=kernel, launches=1)


def attention_bound(starts, t, h, dh, kv_itemsize, cap, scale_itemsize=0):
    """Least time for the attention work these rows need: each row reads
    K and V (and an int8 pool's per-position scales) of positions [0,
    min(start + t, cap)) once, ``cap`` being the positions its table
    holds, reads bf16 q and writes bf16 out once; 2 flops per multiply-add
    in q.k and p.v over each query's window, clipped to the table."""
    rows = len(starts)
    positions = sum(min(s + t, cap) for s in starts)
    kv_bytes = positions * h * 2 * (dh * kv_itemsize + scale_itemsize)
    io_bytes = 2 * rows * h * t * dh * 2 + rows * 4
    flops = sum(sum(min(s + i + 1, cap) for i in range(t)) for s in starts) \
        * h * dh * 4
    return kv_bytes + io_bytes, flops


def bound_entry(n_bytes, flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def check_kernels(torch, pa):
    """Phase 3: every kernel at the serving path's shapes vs its plain
    version; returns the kernels entries (launches filled in later)."""
    import numpy as np
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    r, h, dh, bsz, nbps = 8, 12, 64, 16, 32
    nb = r * nbps + 1
    pool_k = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    pool_v = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=dev)
    entries = {}

    def attn_case(name, wrapper, plain, q, tab, start_list, replaces,
                  kernel=None):
        start = torch.tensor(start_list, dtype=torch.int32, device=dev)
        got = wrapper(q, pool_k, pool_v, tab, start)
        torch.cuda.synchronize()
        ref = plain(q, pool_k, pool_v, tab, start)
        err = (got.float() - ref.float()).abs()
        ok = bool((err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"(max abs err {float(err.max())})")
        # Yardstick: SDPA over the already-gathered view (gather not
        # timed), with the same causal + ragged mask.
        rows, _, t, _ = q.shape
        view_k = pool_k[tab.long()].permute(0, 2, 1, 3, 4).reshape(
            rows, h, -1, dh)
        view_v = pool_v[tab.long()].permute(0, 2, 1, 3, 4).reshape(
            rows, h, -1, dh)
        kpos = torch.arange(view_k.shape[2], device=dev)
        qpos = start.long()[:, None] + torch.arange(t, device=dev)[None]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        n_bytes, flops = attention_bound(start_list, t, h, dh, 2,
                                         nbps * bsz)
        bound_ms, bound_by = bound_entry(n_bytes, flops, "bfloat16")

        def kern():
            return wrapper(q, pool_k, pool_v, tab, start)

        def library():
            return F.scaled_dot_product_attention(q, view_k, view_v,
                                                  attn_mask=mask)

        entries[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": 0,
            "max_abs_err": float(err.max()),
            "ms": time_ms(torch, kern, flush),
            "plain_ms": time_ms(torch, lambda: plain(q, pool_k, pool_v, tab,
                                                     start), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(torch, library, flush),
            "shape": {"q": list(q.shape), "pool": list(pool_k.shape),
                      "starts": start_list},
        }
        if kernel is not None:   # the kernel's and SDPA's own device time
            entries[name]["device_ms"] = device_ms(kern, flush, kernel)
            # SDPA may launch several kernels: all but the flush's count.
            entries[name]["library_device_ms"] = kernel_ab.device_ms(
                library, flush, 25)

    starts = [int(s) for s in rng.integers(0, nbps * bsz, size=r)]
    q1 = torch.randn(r, h, 1, dh, device=dev).to(torch.bfloat16)
    attn_case("paged_decode_attention", pa.paged_attention,
              pa.paged_attention_plain, q1, table, starts,
              "trustworthy_dl_tpu/ops/paged_attention.py:429",
              kernel=DECODE_KERNEL)
    # Prefill: one 64-position chunk resuming after a 128-token prefix
    # hit, the shape the serve path gives it (R = 1).
    q64 = torch.randn(1, h, 64, dh, device=dev).to(torch.bfloat16)
    attn_case("paged_prefill_attention", pa.paged_prefill_attention,
              pa.paged_prefill_attention_plain, q64, table[:1], [128],
              "trustworthy_dl_tpu/ops/paged_attention.py:649",
              kernel=PREFILL_KERNEL)
    entries["paged_prefill_attention"]["block128"] = block128_case(
        torch, pa, flush, rng)
    # A ragged multi-row prefill check (not timed): 8 rows, mid-block
    # starts, chunks crossing block boundaries.
    q20 = torch.randn(r, h, 20, dh, device=dev).to(torch.bfloat16)
    start20 = torch.tensor([0, 5, 13, 30, 77, 200, 301, 490],
                           dtype=torch.int32, device=dev)
    got = pa.paged_prefill_attention(q20, pool_k, pool_v, table, start20)
    ref = pa.paged_prefill_attention_plain(q20, pool_k, pool_v, table,
                                           start20)
    keep = torch.arange(20, device=dev)[None, :] + start20.long()[:, None] \
        < nbps * bsz                     # rows inside each table
    err = (got.float() - ref.float()).abs()
    within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
    inside = keep[:, None, :, None].expand_as(got)
    if not bool(within[inside].all()):
        raise AssertionError("ragged prefill: max abs err "
                             f"{float(err[inside].max())}")

    check_trust_stats(torch, pa, entries, flush)
    check_int8_attention(torch, pa, entries, flush, rng)
    check_dequant_matmul(torch, entries, flush)
    check_verify_tail(torch, pa, entries, flush)
    check_adapter_delta(torch, pa, entries, flush)
    return entries


def check_trust_stats(torch, pa, entries, flush):
    """B7 at the serve path's two launches: a decode tick's 8 rows (the
    entry's numbers) and a prompt's last chunk, 1 row (``cases``), f32
    logits [B, 50257] with row 0's maximum duplicated (margin 0), each
    against its plain twin, timed beside the library calls that give logZ
    and the margin (``logsumexp`` + ``topk``), with the kernel's and the
    library calls' own device time."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    v = 50257

    def case(b):
        logits = torch.randn(b, v, device=dev) * 2.0
        logits[0, 11] = logits[0, 4000] = float(logits[0].max()) + 1.0
        ent, mar = pa.logit_trust_stats(logits)
        torch.cuda.synchronize()
        ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
        ent_err = float((ent - ent_ref).abs().max())
        if not torch.equal(mar, mar_ref) or ent_err > ENTROPY_ATOL \
                or float(mar[0]) != 0.0:
            raise AssertionError(f"trust epilogue at B={b} disagrees: "
                                 f"entropy err {ent_err}, margins equal "
                                 f"{torch.equal(mar, mar_ref)}")
        bound_ms, bound_by = bound_entry(b * v * 4 + 2 * b * 4, b * v * 6,
                                         "float32")

        def library():
            return torch.logsumexp(logits, -1), torch.topk(logits, 2, -1)

        return {
            "rows": b, "max_abs_err": ent_err,
            "ms": time_ms(torch, lambda: pa.logit_trust_stats(logits),
                          flush),
            "plain_ms": time_ms(torch, lambda: pa.logit_trust_stats_plain(
                logits), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # Yardstick: logsumexp + top-2 (entropy has no single library
            # call).
            "library_ms": time_ms(torch, library, flush),
            # The kernel's and the library calls' own device time: the
            # event window holds the host's dispatch whenever the card
            # waits for it.
            "device_ms": device_ms(lambda: pa.logit_trust_stats(logits),
                                   flush, TRUST_KERNEL),
            "library_device_ms": kernel_ab.device_ms(library, flush, 25),
            "shape": {"logits": [b, v]},
        }

    decode = case(8)
    entries["logit_trust_stats"] = {
        "name": "logit_trust_stats", "route": "cuda", "source": SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/paged_attention.py:787",
        "launches": 0, **{k: val for k, val in decode.items() if k != "rows"},
        "cases": [case(1)],
    }


def block128_case(torch, pa, flush, rng):
    """B6 over a bf16 pool of 128-position blocks, the geometry the old
    CUDA-core kernel refused at Dh = 64: one 128-row chunk (an engine's
    chunk at that block size) from position 128 over 4-block tables,
    checked against the twin and given its device time; then a chunk as
    long as the table from three starts over 8 rows (checked on the rows
    inside each table, finite everywhere)."""
    dev = torch.device("cuda")
    r, h, dh, bsz, nbps = 8, 12, 64, 128, 4
    cap = nbps * bsz
    nb = r * nbps + 1
    pool_k = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    pool_v = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=dev)

    def check(q, tab, start_list):
        start = torch.tensor(start_list, dtype=torch.int32, device=dev)
        got = pa.paged_prefill_attention(q, pool_k, pool_v, tab, start)
        torch.cuda.synchronize()
        ref = pa.paged_prefill_attention_plain(q, pool_k, pool_v, tab, start)
        t = q.shape[2]
        keep = (torch.arange(t, device=dev)[None, :] + start.long()[:, None]
                < cap)[:, None, :, None].expand_as(got)
        err = (got.float() - ref.float()).abs()
        within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
        if not bool(within[keep].all()) or not torch.isfinite(got).all():
            raise AssertionError("block128 prefill: kernel disagrees with "
                                 f"plain (max abs err "
                                 f"{float(err[keep].max())})")
        return float(err[keep].max()), start

    q128 = torch.randn(1, h, bsz, dh, device=dev).to(torch.bfloat16)
    err, start = check(q128, table[:1], [128])
    err_long, _ = check(torch.randn(r, h, cap, dh, device=dev).to(
        torch.bfloat16), table, [0, 77, 300] * 2 + [0, 450])
    return {"max_abs_err": max(err, err_long),
            "device_ms": device_ms(lambda: pa.paged_prefill_attention(
                q128, pool_k, pool_v, table[:1], start), flush,
                PREFILL_KERNEL),
            "shape": {"q": list(q128.shape), "pool": list(pool_k.shape),
                      "starts": [128],
                      "also_checked": {"q": [r, h, cap, dh],
                                       "starts": [0, 77, 300] * 2 + [0, 450]}}}


def check_int8_attention(torch, pa, entries, flush, rng):
    """B5 and B6 over an int8 pool at the serve shapes (the serve drive's
    pool geometry, int8 values with f32 per-(head, position) scales), against
    the twin with scales; yardstick SDPA over the dequantized gathered
    view (dequantization and gather not timed).  B6's entry is the
    serve_spec path's launch: under int8 KV the chunk is max_seq, so a
    prefix hit resumes at position 128 with one 512-row chunk whose last
    128 rows lie past the 512-position table (checked on the rows inside
    it, as the engine reads only those).  The bf16-query kernels of B5
    and B6 and SDPA also get the profiler's device time (``device_ms``,
    ``library_device_ms``): B5 at the draft's T = 1 and at the verify
    window (T = 5, ``verify_window``), B6 at that launch and at the
    ``start0`` and ``chunk64`` cases."""
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.quant import int8 as q8
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    r, h, dh, bsz, nbps = 8, 12, 64, 16, 32
    nb = r * nbps + 1
    kq, ks = q8.quantize_kv(torch.randn(nb, h, bsz, dh, device=dev))
    vq, vs = q8.quantize_kv(torch.randn(nb, h, bsz, dh, device=dev))
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=dev)
    kd = (kq.float() * ks[..., None]).to(torch.bfloat16)
    vd = (vq.float() * vs[..., None]).to(torch.bfloat16)

    def case(name, wrapper, q, tab, start_list, timed=True, kernel=None):
        start = torch.tensor(start_list, dtype=torch.int32, device=dev)
        got = wrapper(q, kq, vq, tab, start, ks, vs)
        torch.cuda.synchronize()
        ref = pa.paged_attention_plain(q, kq, vq, tab, start, ks, vs)
        rows, _, t, _ = q.shape
        keep = (torch.arange(t, device=dev)[None, :] + start.long()[:, None]
                < nbps * bsz)[:, None, :, None].expand_as(got)
        err = (got.float() - ref.float()).abs()
        within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
        if not bool(within[keep].all()) or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"(max abs err {float(err[keep].max())})")
        numbers = {"max_abs_err": float(err[keep].max())}
        if not timed:
            return numbers
        view_k = kd[tab.long()].permute(0, 2, 1, 3, 4).reshape(rows, h, -1,
                                                               dh)
        view_v = vd[tab.long()].permute(0, 2, 1, 3, 4).reshape(rows, h, -1,
                                                               dh)
        kpos = torch.arange(view_k.shape[2], device=dev)
        qpos = start.long()[:, None] + torch.arange(t, device=dev)[None]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        n_bytes, flops = attention_bound(start_list, t, h, dh, 1,
                                         nbps * bsz, scale_itemsize=4)
        bound_ms, bound_by = bound_entry(n_bytes, flops, "bfloat16")
        def kern():
            return wrapper(q, kq, vq, tab, start, ks, vs)

        def library():
            return F.scaled_dot_product_attention(q, view_k, view_v,
                                                  attn_mask=mask)

        if kernel is not None:   # the kernel's and SDPA's own device time
            numbers["device_ms"] = device_ms(kern, flush, kernel)
            # SDPA may launch several kernels: all but the flush's count.
            numbers["library_device_ms"] = kernel_ab.device_ms(library, flush,
                                                               25)
        return {
            **numbers,
            "ms": time_ms(torch, kern, flush),
            "plain_ms": time_ms(torch, lambda: pa.paged_attention_plain(
                q, kq, vq, tab, start, ks, vs), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(torch, library, flush),
            "shape": {"q": list(q.shape), "pool": list(kq.shape),
                      "pool_dtype": "int8", "starts": start_list},
        }

    def entry(name, replaces, numbers):
        entries[name] = {"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": replaces, "launches": 0, **numbers}

    starts = [int(s0) for s0 in rng.integers(0, nbps * bsz - 8, size=r)]
    bf = torch.bfloat16
    entry("paged_decode_attention_int8",
          "trustworthy_dl_tpu/ops/paged_attention.py:429 (quantized=True, "
          "kernel branch :328-352)",
          case("int8 decode", pa.paged_attention_int8,
               torch.randn(r, h, 1, dh, device=dev).to(bf), table, starts,
               kernel=DECODE_KERNEL))
    # The verify window (T = k + 1) through the same kernel, timed.
    entries["paged_decode_attention_int8"]["verify_window"] = case(
        "int8 verify window", pa.paged_attention_int8,
        torch.randn(r, h, SPEC_K + 1, dh, device=dev).to(bf), table, starts,
        kernel=DECODE_KERNEL)
    prefill_kernel = PREFILL_KERNEL
    entry("paged_prefill_attention_int8",
          "trustworthy_dl_tpu/ops/paged_attention.py:649 (quantized=True, "
          "kernel branch :556-576)",
          case("int8 prefill", pa.paged_prefill_attention_int8,
               torch.randn(1, h, nbps * bsz, dh, device=dev).to(bf),
               table[:1], [128], kernel=prefill_kernel))
    # Extra cases: a fresh 512-row prompt chunk from position 0 and a
    # 64-row chunk at position 128 (both timed), and a ragged multi-row
    # prefill, 8 rows of T = 20 with mid-block starts (checked).
    entries["paged_prefill_attention_int8"]["start0"] = case(
        "int8 prefill from 0", pa.paged_prefill_attention_int8,
        torch.randn(1, h, nbps * bsz, dh, device=dev).to(bf), table[:1],
        [0], kernel=prefill_kernel)
    entries["paged_prefill_attention_int8"]["chunk64"] = case(
        "int8 prefill 64", pa.paged_prefill_attention_int8,
        torch.randn(1, h, 64, dh, device=dev).to(bf), table[:1], [128],
        kernel=prefill_kernel)
    entries["paged_prefill_attention_int8"]["ragged_max_abs_err"] = case(
        "int8 ragged prefill", pa.paged_prefill_attention_int8,
        torch.randn(r, h, 20, dh, device=dev).to(bf), table,
        [0, 5, 13, 30, 77, 200, 301, 490], timed=False)["max_abs_err"]


def check_dequant_matmul(torch, entries, flush):
    """B4 at M = 1, 8 (a draft step's rows), 16 and 64 (a prefill chunk)
    for each of GPT-2 small's four block matrices and n_embd 96's qkv; the
    entry's numbers are the fc matrix at M = 8 (the largest decode
    launch), every case in ``cases`` with the profiler's device time of
    the kernel and of the yardstick.  Yardstick: ``x @ w_bf16 * scale``
    with the weight cast to bf16 beforehand (not timed)."""
    from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
    from trustworthy_dl_tpu_torch.quant import int8 as q8
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for label, (k, n) in DQ_SHAPES.items():
        wq, scale = q8.quantize_int8(
            torch.randn(k, n, device=dev, generator=gen) * 0.02, axis=0)
        wq, scale = wq.contiguous(), scale.contiguous()
        w_bf = (wq.float()).to(torch.bfloat16)
        for m in DQ_ROWS if label != "d96_qkv" else (8,):
            x = torch.randn(m, k, device=dev, generator=gen).to(
                torch.bfloat16)
            got = fdm.dequant_matmul(x, wq, scale)
            torch.cuda.synchronize()
            ref = fdm.dequant_matmul_plain(x, wq, scale)
            mag = (x.float().abs() @ wq.float().abs()) * scale
            err = (got - ref).abs()
            if not bool((err <= DQ_RTOL * mag + 1e-30).all()):
                raise AssertionError(
                    f"dequant_matmul {label} M={m}: worst error / bound "
                    f"{float((err / (DQ_RTOL * mag + 1e-30)).max())}")
            bound_ms, bound_by = bound_entry(
                k * n + n * 4 + m * k * 2 + m * n * 4, 2 * m * k * n,
                "bfloat16")
            def kern():
                return fdm.dequant_matmul(x, wq, scale)

            def library():
                return (x @ w_bf).float() * scale

            cases.append({
                "matrix": label, "m": m, "k": k, "n": n,
                "max_abs_err": float(err.max()),
                "ms": time_ms(torch, kern, flush),
                "plain_ms": time_ms(torch, lambda: fdm.dequant_matmul_plain(
                    x, wq, scale), flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": time_ms(torch, library, flush),
                "device_ms": device_ms(kern, flush, DQ_KERNEL),
                "library_device_ms": kernel_ab.device_ms(library, flush,
                                                         25)})
    main = next(c for c in cases if c["matrix"] == "fc" and c["m"] == 8)
    entries["dequant_matmul"] = {
        "name": "dequant_matmul", "route": "cuda", "source": DQ_SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/fused_dequant_matmul.py:51",
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms", "device_ms",
                                      "library_device_ms")},
        "shape": {"x": [8, 768], "w_q": [768, 3072], "dtype": "bfloat16"},
        "cases": cases,
    }


def check_verify_tail(torch, pa, entries, flush):
    """B8 at the spec verify shape: normed [R (k + 1) = 40, 768] bf16 x the
    tied head [50257, 768] bf16, one row with a duplicated maximum; then
    the 16 x 9 = 144 rows of ``max_slots=16, spec_k=8``, which the wrapper
    runs as two launches (rows 0-95, 96-143).  Yardstick: ``torch.matmul``
    + ``logsumexp`` + ``topk``."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    d, v = 768, 50257
    head = (torch.randn(v, d, device=dev, generator=gen) * 0.02).to(
        torch.bfloat16)
    head[v - 1] = head[7]

    def check(b, launches):
        normed = torch.randn(b, d, device=dev, generator=gen).to(
            torch.bfloat16)
        normed[b - 1] = (head[7].float() * 60.0).to(torch.bfloat16)
        before = pa.fused_verify_tail.launches
        logits, ent, mar = pa.fused_verify_tail(normed, head)
        torch.cuda.synchronize()
        if pa.fused_verify_tail.launches - before != launches:
            raise AssertionError(
                f"verify tail at B={b}: "
                f"{pa.fused_verify_tail.launches - before} launches, want "
                f"{launches}")
        ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
        bound = ref.abs() * 2.0 ** -7 \
            + DQ_RTOL * (normed.float().abs() @ head.float().abs().T)
        excess = float(((logits - ref).abs() - bound).max())
        top2 = torch.topk(logits, 2, dim=-1).values
        ent_err = float((ent - ent_ref).abs().max())
        if excess > 0.0 or not torch.equal(mar, top2[:, 0] - top2[:, 1]) \
                or ent_err > ENTROPY_ATOL or float(mar[b - 1]) != 0.0:
            raise AssertionError(
                f"verify tail at B={b} disagrees: logits excess over bound "
                f"{excess}, margin == top-2 of own logits "
                f"{torch.equal(mar, top2[:, 0] - top2[:, 1])}, entropy err "
                f"{ent_err}, duplicated-max margin {float(mar[b - 1])}")
        return normed, float((logits - ref).abs().max()), ent_err

    wide, wide_err, wide_ent_err = check(16 * 9, 2)
    del wide
    b = 8 * (SPEC_K + 1)
    normed, max_err, ent_err = check(b, 1)
    head_t = head.T

    def library():
        lg = (normed @ head_t).float()
        return torch.logsumexp(lg, -1), torch.topk(lg, 2, -1)

    bound_ms, bound_by = bound_entry(v * d * 2 + b * d * 2 + b * v * 4
                                     + 2 * b * 4, 2 * b * d * v, "bfloat16")
    entries["fused_verify_tail"] = {
        "name": "fused_verify_tail", "route": "cuda", "source": SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/paged_attention.py:898",
        "launches": 0, "max_abs_err": max_err,
        "entropy_max_abs_err": ent_err,
        "cases": [{"rows": 16 * 9, "launches": 2, "max_abs_err": wide_err,
                   "entropy_max_abs_err": wide_ent_err}],
        "ms": time_ms(torch, lambda: pa.fused_verify_tail(normed, head),
                      flush),
        "plain_ms": time_ms(torch, lambda: pa.fused_verify_tail_plain(
            normed, head), flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(torch, library, flush),
        # Device time of the call's one kernel (the vocab stream with the
        # fold in its last CTA) and of the library calls.
        "device_ms": kernel_ab.device_ms(
            lambda: pa.fused_verify_tail(normed, head), flush, 25,
            kernel=VERIFY_KERNEL, launches=1),
        "library_device_ms": kernel_ab.device_ms(library, flush, 25),
        "shape": {"normed": [b, d], "head": [v, d], "dtype": "bfloat16"},
    }


def check_adapter_delta(torch, pa, entries, flush):
    """B9 at the serve path's shapes against its plain twin, on one site of
    one layer of a GPT-2-small adapter pool [12, 5, 2, 768, 16] (a strided
    view, as the engine passes it), bf16 pages and int8 pages with
    per-page scales: decode rows R = 8, T = 1 over pages [0, 1, 2, 2, 3, 0,
    4, 1] (zero page and duplicates), a 64-position chunk, and a ragged
    T = 20 over pages [3, 0]; then the decode launch at GPT-2 medium's
    width and rank 64 (pool [2, 5, 2, 1024, 64]).  Yardstick: the page
    gather and two ``torch.bmm`` in bf16, scaled, with its events ``ms``
    and profiler ``device_ms`` (every kernel of the call).  The entry's
    numbers are the bf16 decode case (the path's most frequent launch);
    every case is in ``cases``."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    pages = 4
    decode = ("decode", 8, 1, [0, 1, 2, 2, 3, 0, 4, 1])
    # (label suffix, layers, D, rank, launches)
    geometries = (("", 12, 768, ADAPTER_RANK,
                   (decode, ("chunk", 1, 64, [2]), ("ragged", 2, 20, [3, 0]))),
                  ("_d1024_r64", 2, 1024, 64, (decode,)))
    cases = []
    for suffix, n_layer, d, rank, launches in geometries:
        shape_a = (n_layer, pages + 1, 2, d, rank)
        shape_b = (n_layer, pages + 1, 2, rank, d)
        tiers = {}
        a = (torch.randn(shape_a, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        b = (torch.randn(shape_b, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        a[:, 0] = 0
        b[:, 0] = 0
        tiers["bf16"] = (a, b, None, None)
        qa = torch.randint(-127, 128, shape_a, device=dev, generator=gen,
                           dtype=torch.int8)
        qb = torch.randint(-127, 128, shape_b, device=dev, generator=gen,
                           dtype=torch.int8)
        qa[:, 0] = 0
        qb[:, 0] = 0
        sa = torch.rand(n_layer, pages + 1, 2, device=dev,
                        generator=gen) * 1e-3
        sb = torch.rand(n_layer, pages + 1, 2, device=dev,
                        generator=gen) * 1e-3
        sa[:, 0] = 1.0
        sb[:, 0] = 1.0
        tiers["int8"] = (qa, qb, sa, sb)
        layer, site = min(3, n_layer - 1), 1
        for tier, (pa_, pb_, psa, psb) in tiers.items():
            a_site, b_site = pa_[layer][:, site], pb_[layer][:, site]
            sa_site = None if psa is None else psa[layer][:, site]
            sb_site = None if psb is None else psb[layer][:, site]
            for label, rows, t, page_list in launches:
                cases.append(adapter_case(
                    torch, pa, kernel_ab, flush, gen, tier, label + suffix,
                    rows, t, d, rank, page_list,
                    (a_site, b_site, sa_site, sb_site)))
    main = cases[0]
    entries["adapter_delta"] = {
        "name": "adapter_delta", "route": "cuda", "source": ADAPTER_SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/paged_attention.py:1008",
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        **{key: main[key] for key in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library_device_ms")},
        "library_calls": "page gather + 2 x torch.bmm (bf16), scaled",
        "shape": {"x": [8, 1, 768], "pool": [12, pages + 1, 2, 768,
                                             ADAPTER_RANK],
                  "rank": ADAPTER_RANK, "dtype": "bfloat16",
                  "site": "layer 3, site 1 view"},
        "cases": cases,
    }


def adapter_case(torch, pa, kernel_ab, flush, gen, tier, label, rows, t, d,
                 rank, page_list, site):
    """One B9 launch against its twin (within ADAPTER_RTOL of the plain
    output's largest magnitude, zero-page rows exactly 0.0), then timed
    beside its plain twin and the library call (``utils/adapter_ab``'s
    ``library_delta``)."""
    from trustworthy_dl_tpu_torch.utils import adapter_ab

    dev = torch.device("cuda")
    a_site, b_site, sa_site, sb_site = site
    x = torch.randn(rows, t, d, device=dev, generator=gen).to(torch.bfloat16)
    pg = torch.tensor(page_list, dtype=torch.int32, device=dev)
    args = (x, a_site, b_site, pg, sa_site, sb_site)
    got = pa.adapter_delta(*args)
    torch.cuda.synchronize()
    ref = pa.adapter_delta_plain(*args)
    err = float((got - ref).abs().max())
    zero_rows = [i for i, p_ in enumerate(page_list) if p_ == 0]
    if err > ADAPTER_RTOL * float(ref.abs().max()) \
            or not torch.isfinite(got).all() \
            or any(bool((got[i] != 0.0).any()) for i in zero_rows):
        raise AssertionError(
            f"adapter_delta {tier} {label}: max abs err {err} "
            f"(limit {ADAPTER_RTOL} x {float(ref.abs().max())}), "
            f"zero-page rows {zero_rows} exact "
            f"{[bool((got[i] == 0.0).all()) for i in zero_rows]}")

    def library():
        return adapter_ab.library_delta(*args)

    distinct = len(set(page_list))
    itemsize = a_site.element_size()
    n_bytes = (rows * t * d * 2 + rows * t * d * 4 + rows * 4
               + distinct * 2 * d * rank * itemsize
               + (distinct * 8 if sa_site is not None else 0))
    bound_ms, bound_by = bound_entry(n_bytes, 4 * rows * t * d * rank,
                                     "bfloat16")
    return {
        "tier": tier, "case": label, "rows": rows, "t": t, "d": d,
        "rank": rank, "pages": page_list, "max_abs_err": err,
        "plain_max_abs": float(ref.abs().max()),
        "ms": time_ms(torch, lambda: pa.adapter_delta(*args), flush),
        "device_ms": device_ms(lambda: pa.adapter_delta(*args), flush,
                               "adapter_delta_kernel"),
        "plain_ms": time_ms(torch, lambda: pa.adapter_delta_plain(*args),
                            flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": time_ms(torch, library, flush),
        "library_device_ms": kernel_ab.device_ms(library, flush, 25)}


def serve_drive(torch, pa, entries, card):
    """Phase 4: GPT-2 small through the port's engine, kernel path, with
    the launch counters set to 0 just before and read just after; then the
    same traffic on the plain path for the greedy-stream comparison."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import (serve_smoke,
                                                              smoke_traffic)

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    serve_smoke(cfg, params, "kernel", requests[:1])        # warm-up

    ops.reset_launch_counts()
    engine, results, wall = serve_smoke(cfg, params, "kernel", requests)
    counts = ops.launch_counts()
    launches = {name: counts.pop(name) for name in
                ("paged_attention", "paged_prefill_attention",
                 "logit_trust_stats")}
    if any(counts.values()):
        raise AssertionError(f"kernels off this path launched: {counts}")
    summary = engine.metrics_summary()
    check_completed(results, requests)
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if launches["paged_attention"] != cfg.n_layer * summary["decode_ticks"]:
        raise AssertionError(f"decode launches {launches} != n_layer x "
                             f"{summary['decode_ticks']} ticks")
    if launches["paged_prefill_attention"] != \
            cfg.n_layer * summary["prefill_chunks"]:
        raise AssertionError(f"prefill launches {launches} != n_layer x "
                             f"{summary['prefill_chunks']} chunks")
    if summary["prefix_hits"] == 0:
        raise AssertionError("traffic produced no prefix-cache hit")

    _, plain_results, plain_wall = serve_smoke(cfg, params, "plain",
                                               requests)
    vs_plain = compare_greedy(requests, results, plain_results,
                              "kernel vs plain path")
    for name, n in launches.items():
        key = {"paged_attention": "paged_decode_attention"}.get(name, name)
        entries[key]["launches"] = n
    emit({"phase": "serve", "card": card, "model": "gpt2 (12L, 768, 12H, V50257, bf16, "
          "random init seed 0)", "requests": len(requests),
          "wall_s": wall, "plain_path_wall_s": plain_wall,
          "tokens_per_s": summary["tokens_per_s"],
          "ttft_p50_ms": summary.get("ttft_p50_ms"),
          "ttft_p99_ms": summary.get("ttft_p99_ms"),
          "itl_p50_ms": summary.get("itl_p50_ms"),
          "itl_p99_ms": summary.get("itl_p99_ms"),
          "itl_samples": summary["itl_samples"],
          "decode_ticks": summary["decode_ticks"],
          "prefill_chunks": summary["prefill_chunks"],
          "prefix_hits": summary["prefix_hits"],
          "mean_occupancy": summary["mean_occupancy"],
          "launches": launches,
          "greedy_tokens": 32 * sum(temp == 0.0 for _, temp in requests),
          **vs_plain, "near_tie_margin": NEAR_TIE_MARGIN})
    return results


def compare_greedy(requests, results, ref_results, what,
                   either_margin=False, only=None):
    """The near-tie rule (over the requests whose ids are in ``only``,
    when given): walk each greedy stream while its tokens agree
    with the reference's; at the first split the reference's top-1 margin
    (with ``either_margin``, the lesser of the two streams' margins there)
    must be below NEAR_TIE_MARGIN; at every agreeing position the entropies
    and margins must agree within the serve bounds.  Returns (tokens
    compared, splits at near ties, entropy err, margin err)."""
    compared = near_ties = 0
    ent_err = mar_err = 0.0
    for rid, (_, temp) in enumerate(requests):
        if temp > 0.0 or (only is not None and rid not in only):
            continue
        mine, ref = results[rid], ref_results[rid]
        for i, (a, b) in enumerate(zip(mine.tokens, ref.tokens)):
            if a != b:
                split_margin = (min(ref.margins[i], mine.margins[i])
                                if either_margin else ref.margins[i])
                if split_margin >= NEAR_TIE_MARGIN:
                    raise AssertionError(
                        f"{what}: request {rid} token {i}: {a} != {b} at "
                        f"reference margin {ref.margins[i]}")
                near_ties += 1
                break
            compared += 1
            ent_err = max(ent_err, abs(mine.entropies[i] - ref.entropies[i]))
            mar_err = max(mar_err, abs(mine.margins[i] - ref.margins[i]))
    if compared == 0 or ent_err > SERVE_ENTROPY_ATOL \
            or mar_err > SERVE_MARGIN_ATOL:
        raise AssertionError(
            f"{what}: greedy streams over {compared} agreeing tokens: "
            f"entropy err {ent_err} (limit {SERVE_ENTROPY_ATOL}), margin "
            f"err {mar_err} (limit {SERVE_MARGIN_ATOL})")
    return {"greedy_tokens_compared": compared,
            "greedy_streams_split_at_near_tie": near_ties,
            "greedy_entropy_max_abs_err": ent_err,
            "greedy_margin_max_abs_err": mar_err}


def check_completed(results, requests, max_new=32):
    if len(results) != len(requests):
        raise AssertionError(f"{len(results)} of {len(requests)} done")
    for res in results.values():
        if res.status != "completed" or len(res.tokens) != max_new:
            raise AssertionError(f"request {res.request_id} ended "
                                 f"{res.status} with {len(res.tokens)} "
                                 "tokens")
        if not all(map(math.isfinite, res.entropies + res.margins)):
            raise AssertionError(f"request {res.request_id}: non-finite "
                                 "trust signals")


def expect_launches(launches, want, what):
    """Every kernel of ``want`` launched exactly as counted, at least once,
    and no other kernel launched."""
    got = {name: n for name, n in launches.items() if n or name in want}
    if got != want or min(want.values()) == 0:
        raise AssertionError(f"{what}: launches {got}, design says {want}")


def serve_tiers_drive(torch, entries, card):
    """Phases 4b and 4c: speculative decoding over the int8 KV pool, then
    the weight-only int8 tier, at the smoke geometry and traffic."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.models import generate as gen
    from trustworthy_dl_tpu_torch.quant import int8 as q8
    from trustworthy_dl_tpu_torch.utils.serve_profile import (drive_smoke,
                                                              serve_smoke,
                                                              smoke_engine,
                                                              smoke_traffic)

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    n_layer = cfg.n_layer
    # The int8 KV parity probe's own report (the engine runs the probe).
    probe = q8.kv_parity_report(gen._decode_view(params, cfg), cfg)
    spec = dict(spec_k=SPEC_K, kv_dtype="int8", prefill_chunk=None)
    serve_smoke(cfg, params, "kernel", requests[:1], **spec)   # warm-up
    ops.reset_launch_counts()
    engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                        **spec)
    launches = ops.launch_counts()
    s = engine.metrics_summary()
    if engine.kv_fallback_reason is not None or not engine.scheduler.kv.quantized:
        raise AssertionError(f"int8 pool not kept ({engine.kv_fallback_reason}"
                             f"); probe report {probe}")
    check_completed(results, requests)
    sched = engine.scheduler
    if sched._spec_claims or sched.blocks_in_use != len(sched.prefix):
        raise AssertionError("speculative claims or blocks leaked")

    def spec_launches(s):
        ticks, fallback = s["spec_ticks"], s["spec_fallback_ticks"]
        return {"fused_verify_tail": ticks,
                "dequant_matmul": 4 * n_layer * SPEC_K * ticks,
                "paged_attention_int8": n_layer * ((SPEC_K + 1) * ticks
                                                   + fallback),
                "paged_prefill_attention_int8": n_layer * s["prefill_chunks"],
                "logit_trust_stats": len(requests) + fallback}

    want = spec_launches(s)
    expect_launches(launches, want, "serve_spec")
    off_engine, off_results, off_wall = serve_smoke(
        cfg, params, "kernel", requests, spec_k=0, kv_dtype="int8",
        prefill_chunk=None)
    off_summary = off_engine.metrics_summary()
    vs_off = compare_greedy(requests, results, off_results, "spec vs spec off")
    _, plain_results, plain_wall = serve_smoke(cfg, params, "plain",
                                               requests, **spec)
    vs_plain = compare_greedy(requests, results, plain_results,
                              "spec kernel vs plain path")
    for name in want:
        if name != "logit_trust_stats":
            entries_key = {"paged_attention_int8":
                           "paged_decode_attention_int8"}.get(name, name)
            entries[entries_key]["launches"] = launches[name]
    emit({"phase": "serve_spec", "card": card,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16, random init seed 0)",
          "spec_k": SPEC_K, "kv_dtype": "int8", "requests": len(requests),
          "kv_fallback_reason": engine.kv_fallback_reason,
          "kv_parity_report": probe, "wall_s": wall,
          "spec_off_wall_s": off_wall, "plain_path_wall_s": plain_wall,
          "spec_off": {key: off_summary.get(key) for key in (
              "tokens_per_s", "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms",
              "decode_ticks")},
          **{key: s.get(key) for key in (
              "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
              "itl_p99_ms", "accepted_rate", "spec_proposed",
              "spec_accepted", "spec_near_tie_flips", "spec_ticks",
              "spec_fallback_ticks", "spec_draft_s", "spec_verify_s",
              "spec_verify_fraction", "local_prefills", "prefill_chunks",
              "prefix_hits", "mean_occupancy")},
          "launches": {k: launches[k] for k in want},
          "expected_launches": want,
          "vs_spec_off": vs_off, "vs_plain_path": vs_plain,
          "near_tie_margin": NEAR_TIE_MARGIN})

    # Rejections on the card.  The int8 self-draft of random weights agrees
    # with its target almost always, so the drive above never rejects.
    # Here the same spec engine drafts through a head with a seeded half
    # of its vocabulary rows zeroed: the draft cannot propose those tokens,
    # so about half the proposals at each window position are rejected.
    # Rejected draft K/V stays in the pool under later writes, speculative
    # claims are released after a reject and lengths advance by 1 to k + 1.
    # The emitted streams are still the target's: held against spec off
    # (a split only where either stream's margin is a near tie, since a
    # near-tie flip emits the draft's token), no block leaked.
    engine = smoke_engine(cfg, params, "kernel", **spec)
    draft = dict(engine.scheduler.draft_view)
    head = draft["wte_head"]
    keep = torch.rand(head.shape[0], device=head.device,
                      generator=torch.Generator(device=head.device)
                      .manual_seed(1)) < 0.5
    draft["wte_head"] = head * keep[:, None].to(head.dtype)
    engine.scheduler.draft_view = draft
    ops.reset_launch_counts()
    results, reject_wall = drive_smoke(engine, requests)
    launches = ops.launch_counts()
    s = engine.metrics_summary()
    check_completed(results, requests)
    sched = engine.scheduler
    if engine.kv_fallback_reason is not None or not sched.kv.quantized:
        raise AssertionError("rejecting drive: int8 pool not kept")
    if sched._spec_claims or sched.blocks_in_use != len(sched.prefix):
        raise AssertionError("rejecting drive leaked claims or blocks")
    if not s["spec_accepted"] < s["spec_proposed"]:
        raise AssertionError(f"no proposal rejected: {s['spec_accepted']} "
                             f"of {s['spec_proposed']} accepted")
    want = spec_launches(s)
    expect_launches(launches, want, "serve_spec with rejections")
    vs_off = compare_greedy(requests, results, off_results,
                            "rejecting spec vs spec off", either_margin=True)
    emit({"phase": "serve_spec_rejecting", "card": card,
          "draft": "the int8 self-draft, half its head rows zeroed (seed 1)",
          "wall_s": reject_wall,
          **{key: s.get(key) for key in (
              "tokens_per_s", "accepted_rate", "spec_proposed",
              "spec_accepted", "spec_near_tie_flips", "spec_ticks",
              "spec_fallback_ticks", "spec_draft_s", "spec_verify_s")},
          "launches": {k: launches[k] for k in want},
          "expected_launches": want, "vs_spec_off": vs_off})

    weights = dict(weight_dtype="int8")
    serve_smoke(cfg, params, "kernel", requests[:1], **weights)  # warm-up
    ops.reset_launch_counts()
    engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                        **weights)
    launches = ops.launch_counts()
    s = engine.metrics_summary()
    check_completed(results, requests)
    forwards = s["decode_ticks"] + s["local_prefills"] + s["prefill_chunks"]
    want = {"dequant_matmul": 4 * n_layer * forwards,
            "paged_attention": n_layer * s["decode_ticks"],
            "paged_prefill_attention": n_layer * s["prefill_chunks"],
            "logit_trust_stats": len(requests) + s["decode_ticks"]}
    expect_launches(launches, want, "serve_int8_weights")
    _, plain_results, plain_wall = serve_smoke(cfg, params, "plain",
                                               requests, **weights)
    vs_plain = compare_greedy(requests, results, plain_results,
                              "int8 weights kernel vs plain path")
    entries["dequant_matmul"]["launches_int8_weights_drive"] = \
        launches["dequant_matmul"]
    emit({"phase": "serve_int8_weights", "card": card,
          "weight_dtype": "int8", "requests": len(requests),
          "wall_s": wall, "plain_path_wall_s": plain_wall,
          "weight_roundtrip_errors": q8.weight_roundtrip_errors(
              params, cfg, qview=engine.scheduler.view),
          **{key: s.get(key) for key in (
              "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
              "itl_p99_ms", "decode_ticks", "local_prefills",
              "prefill_chunks", "prefix_hits")},
          "launches": {k: launches[k] for k in want},
          "expected_launches": want, "vs_plain_path": vs_plain})
    return {"int8_kv": off_results, "int8_weights": results}


def serve_d96_drive(torch, entries, card):
    """Phase 4c, second drive: the weight-only int8 tier on a bf16 GPT-2 at
    n_embd 96 with 2 heads of 48 (12 layers, vocab 50257, random weights
    from seed 0), whose block matrices (96 x 288, 96 x 96, 96 x 384,
    384 x 96) are multiples of 16 and not of 64, over the first 8 smoke
    requests: B4's launches exact, the greedy streams against the same
    engine on the CPU, where every kernel is its plain twin."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import (serve_smoke,
                                                              smoke_traffic)

    cfg = gpt2.GPT2Config(vocab_size=50257, n_positions=1024, n_layer=12,
                          n_embd=96, n_head=2, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    requests = smoke_traffic(cfg.vocab_size)[:8]
    weights = dict(weight_dtype="int8")
    serve_smoke(cfg, params, "kernel", requests[:1], **weights)  # warm-up
    ops.reset_launch_counts()
    engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                        **weights)
    launches = ops.launch_counts()
    s = engine.metrics_summary()
    check_completed(results, requests)
    n_layer = cfg.n_layer
    forwards = s["decode_ticks"] + s["local_prefills"] + s["prefill_chunks"]
    want = {"dequant_matmul": 4 * n_layer * forwards,
            "paged_attention": n_layer * s["decode_ticks"],
            "paged_prefill_attention": n_layer * s["prefill_chunks"],
            "logit_trust_stats": len(requests) + s["decode_ticks"]}
    expect_launches(launches, want, "serve_int8_weights_d96")
    _, cpu_results, cpu_wall = serve_smoke(cfg, params, "kernel", requests,
                                           device="cpu", **weights)
    vs_cpu = compare_greedy(requests, results, cpu_results,
                            "n_embd 96 int8 weights card vs CPU twins")
    entries["dequant_matmul"]["launches_int8_weights_d96_drive"] = \
        launches["dequant_matmul"]
    emit({"phase": "serve_int8_weights_d96", "card": card,
          "model": "gpt2 (12L, 96, 2H, V50257, bf16, random init seed 0)",
          "weight_dtype": "int8", "requests": len(requests), "wall_s": wall,
          "cpu_wall_s": cpu_wall,
          **{key: s.get(key) for key in (
              "tokens_per_s", "decode_ticks", "local_prefills",
              "prefill_chunks", "prefix_hits")},
          "launches": {k: launches[k] for k in want},
          "expected_launches": want, "vs_cpu_plain": vs_cpu})


def serve_adapters_drive(torch, entries, card, base_results):
    """Phase 4d: the smoke traffic from 8 tenants through rank-16 adapters,
    bf16 pages (serve_adapters) then int8 pages (serve_adapters_int8), on
    the kernel path with the launch counters set to 0 just before and read
    just after, then on the plain path; ``base_results`` is the rank-0
    serve drive's, for the check that the deltas move the streams."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import (
        serve_smoke, smoke_adapter_traffic, smoke_traffic)

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    tenants, adapter_map, pages = smoke_adapter_traffic(len(requests))
    n_layer = cfg.n_layer
    for tier, phase in (("model", "serve_adapters"),
                        ("int8", "serve_adapters_int8")):
        knobs = dict(adapter_rank=ADAPTER_RANK, adapter_pool_pages=pages,
                     adapter_dtype=tier, adapter_map=adapter_map)
        serve_smoke(cfg, params, "kernel", requests[:1],      # warm-up
                    tenants=tenants[:1], **knobs)
        ops.reset_launch_counts()
        engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                            tenants=tenants, **knobs)
        launches = ops.launch_counts()
        s = engine.metrics_summary()
        check_completed(results, requests)
        if s["local_prefills"] != 0:
            raise AssertionError(f"{phase}: {s['local_prefills']} adapter "
                                 "prompts took the dense local prefill")
        want = {"adapter_delta": 2 * n_layer * (s["decode_ticks"]
                                                + s["prefill_chunks"]),
                "paged_attention": n_layer * s["decode_ticks"],
                "paged_prefill_attention": n_layer * s["prefill_chunks"],
                "logit_trust_stats": len(requests) + s["decode_ticks"]}
        expect_launches(launches, want, phase)
        pool, sched = engine.adapter_pool, engine.scheduler
        refcounts = {name: pool.alloc.refcount(page)
                     for name, page in pool.resident.items()}
        if s["adapters"]["evictions"] < 1:
            raise AssertionError(f"{phase}: no eviction ({s['adapters']})")
        if any(n != 1 for n in refcounts.values()) \
                or sched.blocks_in_use != len(sched.prefix):
            raise AssertionError(f"{phase}: leaked pages {refcounts} or "
                                 f"blocks ({sched.blocks_in_use} in use, "
                                 f"{len(sched.prefix)} cached)")
        if any(r.adapter != adapter_map[tenants[rid]]
               for rid, r in results.items()):
            raise AssertionError(f"{phase}: a request lost its adapter")
        ops.reset_launch_counts()
        _, plain_results, plain_wall = serve_smoke(
            cfg, params, "plain", requests, tenants=tenants, **knobs)
        if any(ops.launch_counts().values()):
            raise AssertionError(f"{phase}: the plain path launched "
                                 f"{ops.launch_counts()}")
        vs_plain = compare_greedy(requests, results, plain_results,
                                  f"{phase} kernel vs plain path")
        greedy = [rid for rid, (_, temp) in enumerate(requests)
                  if temp == 0.0]
        moved = [rid for rid in greedy
                 if results[rid].tokens != base_results[rid].tokens]
        if not moved:
            raise AssertionError(f"{phase}: no greedy stream differs from "
                                 "the rank-0 drive's")
        key = "launches" if tier == "model" else "launches_int8_drive"
        entries["adapter_delta"][key] = launches["adapter_delta"]
        emit({"phase": phase, "card": card, "adapter_rank": ADAPTER_RANK,
              "adapter_dtype": tier, "adapter_pool_pages": pages,
              "adapter_map": adapter_map, "requests": len(requests),
              "wall_s": wall, "plain_path_wall_s": plain_wall,
              **{key_: s.get(key_) for key_ in (
                  "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                  "itl_p50_ms", "itl_p99_ms", "decode_ticks",
                  "local_prefills", "prefill_chunks", "prefix_hits",
                  "mean_occupancy", "adapters")},
              "resident_refcounts": refcounts,
              "launches": {k: launches[k] for k in want},
              "expected_launches": want, "vs_plain_path": vs_plain,
              "greedy_streams_moved_from_rank0": len(moved),
              "greedy_streams": len(greedy)})


def serve_stripe_drive(torch, entries, card, base_results, tier_results):
    """Phase 4e: the legacy stripe engine (``paged=False``, 8 slots of 512
    positions) over the smoke traffic, in the model-dtype tier and at
    ``weight_dtype="int8"``, with the launch counters set to 0 just before
    and read just after: B7 once per admission (the stripe prefill samples
    the first token) and once per decode tick; at int8, B4 once per block
    matrix a forward (4 x 12 per admission and per tick); nothing else.
    The greedy streams held against the paged drive's of the same tier by
    the near-tie rule; then a fresh run with engine steps 12-27 (steady
    decode ticks) profiled for the device's busy share."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import (
        busy_window, serve_smoke, smoke_engine, smoke_traffic)

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    n_layer = cfg.n_layer
    for tier, phase, ref in (("model", "serve_stripe", base_results),
                             ("int8", "serve_stripe_int8_weights",
                              tier_results["int8_weights"])):
        t_phase = time.perf_counter()
        knobs = dict(paged=False, weight_dtype=tier)
        serve_smoke(cfg, params, "kernel", requests[:1], **knobs)  # warm-up
        ops.reset_launch_counts()
        engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                            **knobs)
        launches = ops.launch_counts()
        s = engine.metrics_summary()
        check_completed(results, requests)
        if s["layout"] != "stripe" or s["local_prefills"] != len(requests):
            raise AssertionError(f"{phase}: {s['layout']} engine, "
                                 f"{s['local_prefills']} prefills")
        forwards = s["local_prefills"] + s["decode_ticks"]
        want = {"logit_trust_stats": forwards}
        if tier == "int8":
            want["dequant_matmul"] = 4 * n_layer * forwards
        expect_launches(launches, want, phase)
        pool = engine.scheduler.kv
        vs_paged = compare_greedy(requests, results, ref,
                                  f"{phase} vs the paged drive")
        busy = busy_window(smoke_engine(cfg, params, "kernel", **knobs),
                           requests)
        key = "launches_stripe_drive" if tier == "model" \
            else "launches_stripe_int8_weights_drive"
        entries["logit_trust_stats"][key] = launches["logit_trust_stats"]
        if tier == "int8":
            entries["dequant_matmul"]["launches_stripe_drive"] = \
                launches["dequant_matmul"]
        emit({"phase": phase, "card": card,
              "seconds": time.perf_counter() - t_phase,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16, random init "
              "seed 0)", "layout": "stripe", "weight_dtype": tier,
              "max_slots": pool.max_slots, "max_seq": pool.max_seq,
              "pool_bytes": pool.pool_bytes, "requests": len(requests),
              "buckets": list(engine.scheduler.buckets), "wall_s": wall,
              **{key_: s.get(key_) for key_ in (
                  "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                  "itl_p50_ms", "itl_p99_ms", "decode_ticks",
                  "local_prefills", "decode_tick_fraction",
                  "mean_occupancy", "attn_kernel_paths")},
              "busy_window": busy,
              "launches": launches_of(launches, want),
              "expected_launches": want, "vs_paged_drive": vs_paged})


def launches_of(launches, want):
    return {k: launches[k] for k in want}


def migrate_pair(torch, cfg, params, requests, moves, **knobs):
    """Two smoke engines of one configuration on the card: every request
    submitted to the source, the source stepped until each request of
    ``moves`` ({request id: quarantine the source}) has 4 tokens, each
    then migrated to the destination, both run until idle.  A record
    times the whole hand-off (``migrate_request``: export, claim, copy,
    adopt, the source's cancel) and, within it, the pool copy alone
    (``serve.migrate._copy_pools``, the card synchronized around it).
    Returns (source, destination, {request id: its stream across both},
    [per-migration record])."""
    from trustworthy_dl_tpu_torch.obs.attribution import AttributionLedger
    from trustworthy_dl_tpu_torch.serve import ServeRequest, migrate_request
    from trustworthy_dl_tpu_torch.serve import migrate as migrate_mod
    from trustworthy_dl_tpu_torch.utils.serve_profile import smoke_engine

    copy_ms = []
    real_copy = migrate_mod._copy_pools

    def timed_copy(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_copy(*args)
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)

    src = smoke_engine(cfg, params, "kernel", **knobs)
    dst = smoke_engine(cfg, params, "kernel", **knobs)
    for engine in (src, dst):
        engine.ledger = AttributionLedger()
    for prompt, temp in requests:
        if src.submit(ServeRequest(prompt=prompt, max_new_tokens=32,
                                   temperature=temp)) is None:
            raise RuntimeError("request shed by backpressure")
    pending, records, new_ids = dict(moves), [], {}
    migrate_mod._copy_pools = timed_copy
    try:
        for _ in range(400):
            if not pending:
                break
            src.step()
            ready = [r for r in pending if r in src._inflight
                     and len(src._inflight[r][0].emitted) >= 4]
            for rid in ready:
                quarantine = pending.pop(rid)
                snap = src.export_request(rid)
                private = sum(src.scheduler.blocks.refcount(b) == 1
                              for b in snap["block_ids"])
                free = src.scheduler.blocks.free_count
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n_copies = len(copy_ms)
                moved = migrate_request(src, dst, rid,
                                        quarantine_src=quarantine)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if moved is None:
                    raise AssertionError(
                        f"migration of request {rid} refused")
                freed = src.scheduler.blocks.free_count - free
                if freed != (0 if quarantine else private):
                    raise AssertionError(
                        f"request {rid}: the source freed {freed} blocks, "
                        f"expected {0 if quarantine else private} of "
                        f"{moved['blocks']}")
                if quarantine and not set(snap["block_ids"]) >= \
                        src.scheduler.blocks.quarantined:
                    raise AssertionError("quarantined blocks outside the "
                                         "migrated table")
                new_ids[rid] = moved["local_id"]
                copied = sum(copy_ms[n_copies:])
                records.append({"request_id": rid,
                                "tokens_at_move": len(snap["task"].emitted),
                                "blocks": moved["blocks"],
                                "private_blocks": private,
                                "quarantine_src": quarantine,
                                "handoff_ms": ms, "copy_ms": copied,
                                "copy_ms_per_block":
                                    copied / moved["blocks"]})
    finally:
        migrate_mod._copy_pools = real_copy
    if pending:
        raise AssertionError(f"requests {sorted(pending)} never reached "
                             "mid-decode")
    src_results = dict(src.run_until_idle())
    dst_results = dict(dst.run_until_idle())
    torch.cuda.synchronize()
    streams = {}
    for rid in range(len(requests)):
        res = dst_results[new_ids[rid]] if rid in new_ids \
            else src_results[rid]
        streams[rid] = res
        if rid in new_ids and src_results[rid].status != "migrated":
            raise AssertionError(f"request {rid}: source status "
                                 f"{src_results[rid].status}")
    for name, engine in (("source", src), ("destination", dst)):
        ok, problems = engine.verify_attribution()
        if not ok:
            raise AssertionError(f"{name} attribution: {problems[:3]}")
    return src, dst, streams, records


def serve_migrate_drive(torch, entries, card, base_results, tier_results):
    """Phase 4f: live migration between two paged engines in one process
    on the card.  Of the 16 smoke requests, 1 and 2 (greedy) and 3
    (sampled) move mid-decode from one engine to another, 2 with
    ``quarantine_src=True``; then 5 moves between two engines over int8
    pools.  Gates: every stream (across the hand-off) equal to the
    unmigrated drive's, the migrated ones token for token, the others by
    the near-tie rule (admission timing on the source moves with the freed
    rows, so a prefix hit may change); the source's free blocks up by the
    migrated request's private blocks (unchanged under quarantine, those
    impounded); ``verify_attribution()`` on both engines; B5-B7 launched
    exactly as both engines' counters make them."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import smoke_traffic

    t_phase = time.perf_counter()
    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    n_layer = cfg.n_layer
    out = {"phase": "serve_migrate", "card": card, "requests":
           len(requests)}
    for arm, moves, knobs, ref, suffix in (
            ("model", {1: False, 2: True, 3: False}, {}, base_results, ""),
            ("int8", {5: False}, dict(kv_dtype="int8", prefill_chunk=None),
             tier_results["int8_kv"], "_int8")):
        ops.reset_launch_counts()
        src, dst, streams, records = migrate_pair(torch, cfg, params,
                                                  requests, moves, **knobs)
        launches = ops.launch_counts()
        for rid in moves:
            if streams[rid].tokens != ref[rid].tokens:
                raise AssertionError(f"{arm}: migrated request {rid} "
                                     "diverged from the unmigrated stream")
        check_completed(streams, requests)
        vs_ref = compare_greedy(requests, streams, ref,
                                f"{arm} migrated vs unmigrated")
        ticks = sum(e.metrics_summary()["decode_ticks"] for e in (src, dst))
        chunks = sum(e.metrics_summary()["prefill_chunks"]
                     for e in (src, dst))
        want = {f"paged_attention{suffix}": n_layer * ticks,
                f"paged_prefill_attention{suffix}": n_layer * chunks,
                "logit_trust_stats": len(requests) + ticks}
        expect_launches(launches, want, f"serve_migrate {arm}")
        if src.in_service_capacity != 8 - sum(moves.values()):
            raise AssertionError(f"{arm}: source capacity "
                                 f"{src.in_service_capacity}")
        out[arm] = {"migrations": records,
                    "blocks_moved": sum(r["blocks"] for r in records),
                    "copy_ms_per_request": statistics.mean(
                        r["copy_ms"] for r in records),
                    "copy_ms_per_block": sum(r["copy_ms"] for r in records)
                    / sum(r["blocks"] for r in records),
                    "handoff_ms_per_request": statistics.mean(
                        r["handoff_ms"] for r in records),
                    "handoff_ms_per_block":
                        sum(r["handoff_ms"] for r in records)
                    / sum(r["blocks"] for r in records),
                    "source_quarantined_blocks":
                        len(src.scheduler.blocks.quarantined),
                    "launches": launches_of(launches, want),
                    "expected_launches": want, "vs_unmigrated": vs_ref}
    emit({**out, "seconds": time.perf_counter() - t_phase})


def serve_chaos_drive(torch, entries, card):
    """Phase 4g: the SERVE_POISON drill of the JAX package's
    ``tests/test_survival.py`` at full width, on one paged and one stripe
    engine over the smoke traffic: request 15's signals poisoned at its
    retirement, a monitor that absorbs 4 clean requests first and flags
    at z > 1000 (far above what random weights' requests reach, far below
    the poison's: margins of 1000), launch counters set to 0 just before
    and read just after.  Gates: request 15 alone flagged, exactly one
    slot quarantined (capacity 7), capacity 8 after the operator's release
    (the impounded blocks back too on the paged engine), one fault fired,
    the kernels of each layout launched exactly."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.chaos import (FaultEvent, FaultInjector,
                                                FaultKind, FaultPlan)
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import OutputMonitor
    from trustworthy_dl_tpu_torch.utils.serve_profile import (drive_smoke,
                                                              smoke_engine,
                                                              smoke_traffic)

    t_phase = time.perf_counter()
    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    n_layer = cfg.n_layer
    poisoned = len(requests) - 1
    out = {"phase": "serve_chaos", "card": card, "poisoned_request":
           poisoned}
    for layout in ("paged", "stripe"):
        injector = FaultInjector(FaultPlan.scripted(
            [FaultEvent(step=poisoned, kind=FaultKind.SERVE_POISON)]))
        engine = smoke_engine(cfg, params, "kernel",
                              paged=layout == "paged", chaos=injector,
                              monitor=OutputMonitor(warmup=4,
                                                    z_threshold=1000.0))
        ops.reset_launch_counts()
        results, wall = drive_smoke(engine, requests)
        launches = ops.launch_counts()
        s = engine.metrics_summary()
        check_completed(results, requests)
        flagged = sorted(r for r, res in results.items() if res.flagged)
        if flagged != [poisoned] or injector.counts() != \
                {"serve_poison": 1}:
            raise AssertionError(f"{layout}: flagged {flagged}, fired "
                                 f"{injector.counts()}")
        quarantined = sorted(engine.quarantined_slots)
        if len(quarantined) != 1 or engine.in_service_capacity != 7:
            raise AssertionError(f"{layout}: quarantined {quarantined}, "
                                 f"capacity {engine.in_service_capacity}")
        impounded = (len(engine.scheduler.blocks.quarantined)
                     if layout == "paged" else 0)
        engine.release_quarantine(quarantined[0])
        if engine.in_service_capacity != 8 or (
                layout == "paged" and engine.scheduler.blocks.quarantined):
            raise AssertionError(f"{layout}: release left capacity "
                                 f"{engine.in_service_capacity}")
        ticks = s["decode_ticks"]
        if layout == "paged":
            want = {"paged_attention": n_layer * ticks,
                    "paged_prefill_attention": n_layer * s["prefill_chunks"],
                    "logit_trust_stats": len(requests) + ticks}
        else:
            want = {"logit_trust_stats": s["local_prefills"] + ticks}
        expect_launches(launches, want, f"serve_chaos {layout}")
        out[layout] = {"wall_s": wall, "flagged": flagged,
                       "monitor_z": results[poisoned].monitor_z,
                       "max_clean_z": max(res.monitor_z for r, res in
                                          results.items()
                                          if r != poisoned),
                       "quarantined_slot": quarantined[0],
                       "impounded_blocks": impounded,
                       "launches": launches_of(launches, want),
                       "expected_launches": want}
    emit({**out, "seconds": time.perf_counter() - t_phase})


def fleet_drill(torch, cfg, params, requests, events, **engine_kwargs):
    """One ``ServingFleet`` drill on the card: 3 smoke engines (every
    generation kept, each ``step()`` timed), the plan of ``events``, the
    requests submitted with the fleet's seeds, the launch counters set to
    0 just before the ticks and read just after.  Returns (fleet, plan,
    record), the record holding the results, the kept engines, the crash
    and preemption snapshots and each migration's hand-off ms."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.chaos import (FaultEvent, FaultInjector,
                                                FaultKind, FaultPlan)
    from trustworthy_dl_tpu_torch.obs.attribution import AttributionLedger
    from trustworthy_dl_tpu_torch.serve import (FleetConfig, ServeRequest,
                                                ServingEngine, ServingFleet)
    from trustworthy_dl_tpu_torch.serve import fleet as fleet_mod

    plan = FaultPlan.scripted([
        FaultEvent(step=tick, kind=getattr(FaultKind, kind), target=replica,
                   severity=severity)
        for tick, kind, replica, severity in events])
    generations, step_s, handoff_ms = [], [0.0], []

    def factory(index, **kwargs):
        engine = ServingEngine(params, cfg, **kwargs)
        real_step = engine.step

        def timed_step():
            t0 = time.perf_counter()
            try:
                return real_step()
            finally:
                step_s[0] += time.perf_counter() - t0

        engine.step = timed_step
        generations.append((index, engine))
        return engine

    fleet = ServingFleet(
        fleet_config=FleetConfig(**FLEET_CONFIG),
        chaos=FaultInjector(plan), ledger=AttributionLedger(), seed=0,
        engine_factory=factory, device="cuda", max_slots=8, max_seq=512,
        block_size=16, prefill_chunk=64, prefix_cache=True,
        attn_impl="kernel", **engine_kwargs)
    crash, preempt = {}, {}
    real_crash, real_preempt = fleet._crash_replica, fleet._preempt_replica

    def crash_replica(rep):
        crash.update(replica=rep.index, tick=fleet.tick,
                     t=time.perf_counter(),
                     victims=[fid for (r, _), fid in
                              fleet._local2fleet.items() if r == rep.index])
        real_crash(rep)

    def preempt_replica(rep):
        preempt.update(replica=rep.index, tick=fleet.tick,
                       inflight=len(rep.engine.inflight_ids),
                       decode_ready=len(rep.engine.decode_ready_ids),
                       queued=len(rep.engine.queued_ids))
        real_preempt(rep)

    real_migrate = fleet_mod.migrate_request

    def timed_migrate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = real_migrate(*args, **kwargs)
        torch.cuda.synchronize()
        if moved is not None:
            handoff_ms.append((time.perf_counter() - t0) * 1e3)
        return moved

    def in_rows(fid):
        """A crash victim back in a row of a live replica (or done)."""
        rec = fleet.requests.get(fid)
        if rec is None:
            return fid in fleet.results
        return any(fleet.replicas[r].engine is not None
                   and att.local_id in fleet.replicas[r].engine._inflight
                   for r, att in rec.live.items())

    fleet._crash_replica, fleet._preempt_replica = crash_replica, \
        preempt_replica
    seeds = []
    for prompt, temp in requests:
        fid = fleet.submit(ServeRequest(prompt=prompt, max_new_tokens=32,
                                        temperature=temp))
        if fid is None:
            raise RuntimeError("fleet shed a request by backpressure")
        seeds.append(fleet.requests[fid].seed)
    fleet_mod.migrate_request = timed_migrate
    tick_s = 0.0
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        while fleet.busy:
            t_tick = time.perf_counter()
            fleet.step()
            tick_s += time.perf_counter() - t_tick
            if crash and "readmitted_tick" not in crash and all(
                    map(in_rows, crash["victims"])):
                crash["readmitted_tick"] = fleet.tick
                crash["readmitted_ms"] = (time.perf_counter()
                                          - crash["t"]) * 1e3
            if fleet.tick > FLEET_MAX_TICKS:
                raise AssertionError(f"fleet did not drain in "
                                     f"{FLEET_MAX_TICKS} ticks: "
                                     f"{fleet.states()}")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    finally:
        fleet_mod.migrate_request = real_migrate
    return fleet, plan, {"wall": wall, "launches": launches,
                         "seeds": seeds, "generations": generations,
                         "crash": crash, "preempt": preempt,
                         "handoff_ms": handoff_ms,
                         "host_ms_per_tick": (tick_s - step_s[0])
                         / fleet.tick * 1e3}


def fleet_streams(fleet, generations):
    """Each fleet request's winning ``ServeResult`` (trust signals
    included), read from the engine generation and local id its canonical
    ledger record names."""
    engines, seen = {}, {}
    for index, engine in generations:
        engines[f"{index}:{seen.get(index, 0)}"] = engine
        seen[index] = seen.get(index, 0) + 1
    out = {}
    for rec in fleet.ledger.records():
        if rec.get("admitted") and rec["status"] == "completed":
            winner = rec["attempts"][-1]
            out[rec["request_id"]] = \
                engines[rec["journal"]].results[winner["local_id"]]
    return out


def fleet_launch_check(generations, launches, n_layer, what,
                       prefill_chunks=True):
    """B5, B6 and B7 exactly as every replica generation's counters make
    them; returns each generation's summary.  ``prefill_chunks=False``:
    every prompt fits one chunk and takes the engine's local prefill, so
    B6 must launch no time at all."""
    gens, seen = [], {}
    for index, engine in generations:
        s = engine.metrics_summary()
        gens.append({"replica": index, "gen": seen.get(index, 0),
                     **{k: s[k] for k in (
                         "decode_ticks", "prefill_chunks",
                         "prompts_prefilled", "local_prefills",
                         "tokens_emitted", "prefix_hits")}})
        seen[index] = seen.get(index, 0) + 1
    ticks = sum(g["decode_ticks"] for g in gens)
    want = {"paged_attention": n_layer * ticks,
            "paged_prefill_attention":
                n_layer * sum(g["prefill_chunks"] for g in gens),
            "logit_trust_stats":
                sum(g["prompts_prefilled"] for g in gens) + ticks}
    if not prefill_chunks:
        if want.pop("paged_prefill_attention"):
            raise AssertionError(f"{what}: a prompt took prefill chunks")
    expect_launches(launches, want, what)
    return gens, want


def serve_fleet_drive(torch, entries, card, base_results):
    """Phase 4h: the serving fleet on the card (module docstring)."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import OutputMonitor, ServeRequest
    from trustworthy_dl_tpu_torch.utils.serve_profile import (smoke_engine,
                                                              smoke_traffic)

    t_phase = time.perf_counter()
    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen_ = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen_, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    n_layer = cfg.n_layer
    out = {"phase": "serve_fleet", "card": card, "replicas":
           FLEET_CONFIG["num_replicas"], "requests": len(requests)}

    # -- 1. the acceptance plan --------------------------------------------
    monitor = OutputMonitor(warmup=4, z_threshold=1000.0)
    for rid in range(4):
        monitor.observe(base_results[rid].entropies,
                        base_results[rid].margins)
    fleet, plan, rec = fleet_drill(torch, cfg, params, requests,
                                   FLEET_DRILL, monitor=monitor)
    seeds = rec["seeds"]

    # One engine, the same traffic and seeds, in the same call: the
    # sampled streams' reference and the wall the fleet is read beside.
    engine = smoke_engine(cfg, params, "kernel")
    for (prompt, temp), seed in zip(requests, seeds):
        engine.submit(ServeRequest(prompt=prompt, max_new_tokens=32,
                                   temperature=temp, seed=seed))
    t0 = time.perf_counter()
    one = dict(engine.run_until_idle())
    torch.cuda.synchronize()
    one_wall = time.perf_counter() - t0
    one_tokens = sum(len(r.tokens) for r in one.values())
    out["one_engine"] = {"wall_s": one_wall,
                         "tokens_per_s": one_tokens / one_wall}

    predicted = plan.predict_fleet(
        horizon=fleet.tick,
        cooloff_ticks=FLEET_CONFIG["quarantine_cooloff_ticks"])
    observed = {k: fleet.counters[k] for k in predicted}
    if observed != predicted:
        raise AssertionError(f"fleet drill: counters {observed}, "
                             f"predict_fleet {predicted}")
    if fleet.states() != {0: "healthy", 1: "healthy", 2: "quarantined"}:
        raise AssertionError(f"fleet drill: states {fleet.states()}")
    ok, problems = fleet.verify_attribution()
    if not ok:
        raise AssertionError(f"fleet attribution: {problems[:3]}")
    admitted = [r for r in fleet.ledger.records() if r.get("admitted")]
    spanning = [r["request_id"] for r in admitted
                if len({a["journal"] for a in r["attempts"]}) > 1]
    if not spanning or not {"0:0", "0:1"} <= set(fleet.journals):
        raise AssertionError(f"fleet drill: spanning records {spanning}, "
                             f"journals {sorted(fleet.journals)}")
    streams = fleet_streams(fleet, rec["generations"])
    check_completed(streams, requests)
    if sorted(fleet.results) != list(range(len(requests))) or any(
            r.tokens != streams[f].tokens
            for f, r in fleet.results.items()):
        raise AssertionError("fleet results differ from their engines'")
    # The poison rewrote the signals of the streams replica 2 retired
    # (not their tokens): those go by their tokens alone.
    poisoned = {f for f, r in fleet.results.items() if r.flagged}
    vs_serve = compare_greedy(requests, streams, base_results,
                              "fleet drill vs the serve drive",
                              only=set(streams) - poisoned)
    for rid in sorted(poisoned):
        if requests[rid][1] > 0.0:
            continue           # sampled: against one engine below
        ref = base_results[rid]
        for i, (a, b) in enumerate(zip(streams[rid].tokens, ref.tokens)):
            if a != b and ref.margins[i] >= NEAR_TIE_MARGIN:
                raise AssertionError(f"fleet drill: poisoned request {rid} "
                                     f"token {i}: {a} != {b} at reference "
                                     f"margin {ref.margins[i]}")
            if a != b:
                break
    for rid, (_, temp) in enumerate(requests):
        if temp > 0.0 and streams[rid].tokens != one[rid].tokens:
            raise AssertionError(f"fleet drill: sampled request {rid} "
                                 "differs from one engine's")
    gens, want = fleet_launch_check(rec["generations"], rec["launches"],
                                    n_layer, "serve_fleet drill")
    tokens = sum(len(r.tokens) for r in fleet.results.values())
    crash = rec["crash"]
    out["drill"] = {
        "wall_s": rec["wall"], "tokens_per_s": tokens / rec["wall"],
        "ticks": fleet.tick, "host_ms_per_tick": rec["host_ms_per_tick"],
        "counters": observed, "states": fleet.states(),
        "crash_victims": len(crash["victims"]),
        "crash_to_readmitted_ticks":
            crash["readmitted_tick"] - crash["tick"],
        "crash_to_readmitted_ms": crash["readmitted_ms"],
        "migrations": fleet.counters["migrations"],
        "handoff_ms": rec["handoff_ms"],
        "spanning_records": len(spanning),
        "flagged": sorted(poisoned),
        "generations": gens, "launches": launches_of(rec["launches"], want),
        "expected_launches": want, "vs_serve": vs_serve,
        "sampled_equal_one_engine": sum(t > 0.0 for _, t in requests)}
    del fleet, rec, streams

    # -- 2. REPLICA_PREEMPT ------------------------------------------------
    fleet, plan, rec = fleet_drill(torch, cfg, params, requests,
                                   FLEET_PREEMPT)
    pre = rec["preempt"]
    predicted = plan.predict_fleet(preempt_inflight=pre["decode_ready"])
    observed = {k: fleet.counters[k] for k in predicted}
    if observed != predicted:
        raise AssertionError(f"fleet preempt: counters {observed}, "
                             f"predict_fleet {predicted}")
    ok, problems = fleet.verify_attribution()
    if not ok:
        raise AssertionError(f"fleet preempt attribution: {problems[:3]}")
    for fid, res in one.items():
        if fleet.results[fid].tokens != res.tokens:
            raise AssertionError(f"fleet preempt: request {fid} differs "
                                 "from one engine's")
    gens, want = fleet_launch_check(rec["generations"], rec["launches"],
                                    n_layer, "serve_fleet preempt")
    tokens = sum(len(r.tokens) for r in fleet.results.values())
    out["preempt"] = {
        "wall_s": rec["wall"], "tokens_per_s": tokens / rec["wall"],
        "ticks": fleet.tick, "host_ms_per_tick": rec["host_ms_per_tick"],
        "at_preemption": pre, "counters": observed,
        "failovers": fleet.counters["failovers"],
        "handoff_ms": rec["handoff_ms"],
        "handoff_ms_mean": (statistics.mean(rec["handoff_ms"])
                            if rec["handoff_ms"] else None),
        "generations": gens, "launches": launches_of(rec["launches"], want),
        "expected_launches": want}
    del fleet, rec, params
    torch.cuda.empty_cache()

    # -- 3. cli serve --fleet-replicas 2 -----------------------------------
    lines = []
    with tempfile.TemporaryDirectory() as empty:
        t0 = time.perf_counter()
        printed = run_cli(["serve", "--fleet-replicas", "2",
                           "--num-requests", "8", "--max-new-tokens", "16",
                           "--prompt-len", "32", "--max-seq", "256",
                           "--checkpoint-dir", empty, "--seed", "0"], lines)
    if "fleet served" not in printed or "  statuses:" not in printed:
        raise AssertionError(f"cli serve --fleet-replicas: {printed[-800:]}")
    out["cli"] = {"seconds": time.perf_counter() - t0,
                  "summary": [ln.strip() for ln in lines
                              if ln.startswith("fleet served")
                              or ln.startswith("  statuses")
                              or ln.startswith("  replica_states")
                              or ln.startswith("  completed_tokens")]}
    emit({**out, "seconds": time.perf_counter() - t_phase})


class StampedTrace:
    """A host trace sink keeping every fleet event with its wall stamp."""

    def __init__(self):
        self.events = []

    def emit(self, type, **data):
        self.events.append({"type": getattr(type, "value", type),
                            "t": time.perf_counter(), **data})

    def of(self, type):
        return [e for e in self.events if e["type"] == type]


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def recorded_fleet(torch, dev, params, cfg, fleet_config, **kwargs):
    """A ``ServingFleet`` on ``dev`` whose replica engines are kept (every
    generation) with their ``step()`` time summed, a stamped trace, an
    attribution ledger and a compile watcher over the kernel libraries.
    Returns (fleet, record)."""
    from types import SimpleNamespace

    from trustworthy_dl_tpu_torch.obs.attribution import AttributionLedger
    from trustworthy_dl_tpu_torch.obs.compilewatch import (CompileRegistry,
                                                           CompileWatcher)
    from trustworthy_dl_tpu_torch.serve import ServingEngine, ServingFleet

    generations, step_s = [], [0.0]

    def factory(index, **kw):
        engine = ServingEngine(params, cfg, **kw)
        real_step = engine.step

        def timed_step():
            t0 = time.perf_counter()
            try:
                return real_step()
            finally:
                step_s[0] += time.perf_counter() - t0

        engine.step = timed_step
        generations.append((index, engine))
        return engine

    compiles = CompileRegistry().install()
    watcher = CompileWatcher(compiles)
    trace = StampedTrace()
    fleet = ServingFleet(fleet_config=fleet_config, ledger=AttributionLedger(),
                         seed=0, engine_factory=factory, device=dev,
                         obs=SimpleNamespace(trace=trace,
                                             compilewatch=watcher),
                         **kwargs)
    return fleet, {"generations": generations, "step_s": step_s,
                   "trace": trace, "compiles": compiles, "watcher": watcher}


def drive_ticks(torch, dev, fleet, rec, feed=None, idle_ticks=0,
                max_ticks=CONTROL_MAX_TICKS):
    """Tick ``fleet`` until it is idle (``feed()`` submits before each
    tick), then ``idle_ticks`` more, with the launch counters set to 0
    just before and read just after; fills ``rec`` with the wall, the
    launches, the host's ms a tick outside the replicas' ``step()`` and
    the library loads the compile watch saw."""
    from trustworthy_dl_tpu_torch import ops

    rec["step_s"][0] = 0.0
    loads0 = rec["compiles"].total
    tick_s = 0.0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ticks = 0
    while True:
        if feed is not None:
            feed()
        if not fleet.busy and (feed is None or feed.done):
            break
        t_tick = time.perf_counter()
        fleet.step()
        tick_s += time.perf_counter() - t_tick
        ticks += 1
        if ticks > max_ticks:
            raise AssertionError(f"fleet did not drain in {max_ticks} "
                                 f"ticks: {fleet.states()}")
    for _ in range(idle_ticks):
        t_tick = time.perf_counter()
        fleet.step()
        tick_s += time.perf_counter() - t_tick
        ticks += 1
    sync(torch, dev)
    rec["wall"] = time.perf_counter() - t0
    rec["launches"] = ops.launch_counts()
    rec["host_ms_per_tick"] = (tick_s - rec["step_s"][0]) / ticks * 1e3
    rec["library_loads"] = rec["compiles"].total - loads0
    rec["storms"] = rec["watcher"].storm_total
    rec["compiles"].uninstall()


def one_engine_streams(torch, dev, params, cfg, reqs, **kwargs):
    """Greedy streams of one engine over ``reqs`` ([(prompt, new)]) in one
    batch, and its tokens/s."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    engine = ServingEngine(params, cfg, device=dev, queue_limit=len(reqs),
                           **kwargs)
    ids = [engine.submit(ServeRequest(prompt=list(p), max_new_tokens=n))
           for p, n in reqs]
    t0 = time.perf_counter()
    out = engine.run_until_idle()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    results = [out[i] for i in ids]
    return results, sum(len(r.tokens) for r in results) / wall


def control_drill(torch, dev, params, cfg):
    """JAX's flood and autoscale drill: seeded diurnal traffic driven
    closed loop at CONTROL_OPEN open requests, a TENANT_FLOOD, the whole
    control plane on a 2 -> 3 fleet.  Returns (fleet, plan, record)."""
    from trustworthy_dl_tpu_torch.chaos import (FaultEvent, FaultInjector,
                                                FaultKind, FaultPlan)
    from trustworthy_dl_tpu_torch.serve import (AutoscalerConfig,
                                                FleetConfig, SLOClass,
                                                ServeRequest,
                                                TenantQuotaConfig)
    from trustworthy_dl_tpu_torch.serve.workload import (WorkloadConfig,
                                                         generate_workload)

    tick, severity = CONTROL_FLOOD
    plan = FaultPlan.scripted([FaultEvent(step=tick,
                                          kind=FaultKind.TENANT_FLOOD,
                                          severity=severity,
                                          tenant="flood")])
    # 60 s / 10 s targets: the classes' counters depend on ticks alone.
    classes = (SLOClass("batch", priority=0, weight=1.0),
               SLOClass("standard", priority=1, weight=2.0,
                        ttft_target_s=60.0, itl_target_s=10.0),
               SLOClass("premium", priority=2, weight=4.0,
                        ttft_target_s=60.0, itl_target_s=10.0))
    fleet, rec = recorded_fleet(
        torch, dev, params, cfg, FleetConfig(
            num_replicas=2, max_retries=6, restart_ticks=2,
            quarantine_cooloff_ticks=10_000, slo_classes=classes,
            tenant_quota=TenantQuotaConfig(
                capacity_tokens=100_000, refill_per_tick=0.0,
                per_tenant={"flood": (40.0, 0.0)}),
            autoscale=AutoscalerConfig(**CONTROL_AUTOSCALE)),
        chaos=FaultInjector(plan), **CONTROL_ENGINE)
    items = generate_workload(WorkloadConfig(**CONTROL_WORKLOAD),
                              cfg.vocab_size, CONTROL_ENGINE["max_seq"])
    reqs = {}

    class Feed:
        pending = list(items)
        done = False

        def __call__(self):
            while self.pending and fleet.open_requests < CONTROL_OPEN:
                item = self.pending[0]
                fid = fleet.submit(ServeRequest(
                    prompt=list(item.prompt),
                    max_new_tokens=item.max_new_tokens, temperature=0.0,
                    priority=item.priority, tenant=item.tenant))
                if fid is None:
                    break
                self.pending.pop(0)
                reqs[fid] = (list(item.prompt), item.max_new_tokens)
            self.done = not self.pending

    drive_ticks(torch, dev, fleet, rec, feed=Feed(),
                idle_ticks=CONTROL_IDLE_TICKS)
    rec["reqs"] = reqs
    return fleet, plan, rec


def scale_timings(trace):
    """Scale-up to the new replica's re-admission, and the retiring
    replica's drain, each in ticks and ms, from the stamped events."""
    ups = [e for e in trace.of("fleet_scale") if e["direction"] == "up"]
    downs = [e for e in trace.of("fleet_scale") if e["direction"] == "down"]
    moves = trace.of("replica_transition")
    out = {}
    if ups:
        up = ups[0]
        back = next(e for e in moves if e["reason"] == "warmup_complete"
                    and e["t"] >= up["t"])
        out["scale_up_to_readmitted"] = {"ticks": back["tick"] - up["tick"],
                                         "ms": (back["t"] - up["t"]) * 1e3,
                                         "replica": back["replica"]}
    if downs:
        start = next(e for e in moves if e["reason"] == "scale_down")
        retired = next(e for e in moves if e["to_state"] == "retired")
        out["scale_down_drain"] = {
            "ticks": retired["tick"] - start["tick"],
            "ms": (retired["t"] - start["t"]) * 1e3,
            "replica": retired["replica"]}
    return out


def disagg_drill(torch, dev, params, cfg):
    """JAX's disaggregated pools (tests/test_migrate.py): one prefill and
    two decode replicas, 5 requests; each request's hand-off timed."""
    import numpy as np

    from trustworthy_dl_tpu_torch.serve import FleetConfig, ServeRequest
    from trustworthy_dl_tpu_torch.serve import fleet as fleet_mod

    fleet, rec = recorded_fleet(
        torch, dev, params, cfg,
        FleetConfig(num_replicas=3,
                    pool_roles=("prefill", "decode", "decode")),
        max_slots=2, max_seq=48, queue_limit=32)
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(5):
        plen = int(rng.integers(3, 8))
        new = int(rng.integers(6, 10))
        reqs.append((rng.integers(0, cfg.vocab_size, plen).tolist(), new))
        fleet.submit(ServeRequest(prompt=reqs[-1][0], max_new_tokens=new))
    real, handoff_ms = fleet_mod.migrate_request, []

    def timed_migrate(*args, **kwargs):
        sync(torch, dev)
        t0 = time.perf_counter()
        moved = real(*args, **kwargs)
        sync(torch, dev)
        if moved is not None:
            handoff_ms.append((time.perf_counter() - t0) * 1e3)
        return moved

    fleet_mod.migrate_request = timed_migrate
    try:
        drive_ticks(torch, dev, fleet, rec, max_ticks=2000)
    finally:
        fleet_mod.migrate_request = real
    rec["reqs"], rec["handoff_ms"] = reqs, handoff_ms
    return fleet, rec


def smoke_gpt2(torch, dev, n_layer):
    """GPT-2 small at full width in bf16, ``n_layer`` deep, random weights
    from seed 0 on ``dev``."""
    import dataclasses

    from trustworthy_dl_tpu_torch.models import gpt2

    cfg = dataclasses.replace(gpt2.GPT2Config.from_name(
        "gpt2", dtype=torch.bfloat16), n_layer=n_layer)
    return cfg, gpt2.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)


def serve_fleet_control_drive(torch, entries, card, dev="cuda",
                              n_layer=12):
    """Phase 4i: the fleet's control plane on the card (module docstring);
    ``dev`` and ``n_layer`` rehearse it on the CPU."""
    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg, params = smoke_gpt2(torch, dev, n_layer)
    out = {"phase": "serve_fleet_control", "card": card}

    # -- 1. flood and autoscale --------------------------------------------
    fleet, plan, rec = control_drill(torch, dev, params, cfg)
    reqs = rec["reqs"]
    predicted = plan.predict_fleet(autoscale=True, quota_tokens=40,
                                   flood_request_tokens=8)
    observed = {k: fleet.counters[k] for k in predicted}
    if observed != predicted or (observed["scale_ups"],
                                 observed["scale_downs"],
                                 observed["throttles"]) != (1, 1, 7):
        raise AssertionError(f"control drill: counters {observed}, "
                             f"predict_fleet {predicted}")
    scales = [(e["direction"], e["from_replicas"], e["to_replicas"])
              for e in rec["trace"].of("fleet_scale")]
    retired = [r for r in fleet.replicas if r.state.value == "retired"]
    if scales != [("up", 2, 3), ("down", 3, 2)] or len(retired) != 1 \
            or f"{retired[0].index}:0" not in fleet.journals:
        raise AssertionError(f"control drill: scales {scales}, states "
                             f"{fleet.states()}")
    results = fleet.results
    flood = sorted(f for f, r in results.items() if r.tenant == "flood")
    if len(flood) != 5 or sorted(results) != sorted(list(reqs) + flood) \
            or any(r.status != "completed" for r in results.values()):
        raise AssertionError(f"control drill: results {results}")
    order = sorted(reqs)
    flood_req = ([0] * fleet.config.flood_prompt_len,
                 fleet.config.flood_new_tokens)
    ref, one_tps = one_engine_streams(
        torch, dev, params, cfg, [reqs[f] for f in order] + [flood_req],
        max_slots=CONTROL_ENGINE["max_slots"],
        max_seq=CONTROL_ENGINE["max_seq"], enable_monitor=False)
    want = {f: r.tokens for f, r in zip(order, ref)}
    want.update({f: ref[-1].tokens for f in flood})
    differ = [f for f in results if results[f].tokens != want[f]]
    if differ:
        raise AssertionError(f"control drill: requests {differ} differ "
                             "from one engine's greedy streams")
    served_by_new = sum(1 for r in results.values() if r.replica == 2)
    per_class = fleet.metrics_summary()["per_class"]
    if served_by_new < 1 or per_class["standard"]["breached"] \
            or per_class["premium"]["breached"]:
        raise AssertionError(f"control drill: replica 2 served "
                             f"{served_by_new}, classes {per_class}")
    ok, problems = fleet.verify_attribution()
    if not ok:
        raise AssertionError(f"control drill attribution: {problems[:3]}")
    if rec["library_loads"] or rec["storms"]:
        raise AssertionError(f"control drill: {rec['library_loads']} "
                             f"library loads, {rec['storms']} storms after "
                             "warmup")
    gens, want_launches = fleet_launch_check(
        rec["generations"], rec["launches"], cfg.n_layer, "control drill",
        prefill_chunks=False)
    tokens = sum(len(r.tokens) for r in results.values())
    out["drill"] = {
        "wall_s": rec["wall"], "tokens_per_s": tokens / rec["wall"],
        "one_engine_tokens_per_s": one_tps, "ticks": fleet.tick,
        "host_ms_per_tick": rec["host_ms_per_tick"],
        "counters": observed, "scales": scales,
        "replica_trace": fleet.replica_trace,
        **scale_timings(rec["trace"]),
        "served_by_scaled_up_replica": served_by_new,
        "per_class": {c: {k: v for k, v in s.items()
                          if k in ("completed", "tokens", "shed",
                                   "breached")}
                      for c, s in per_class.items()},
        "library_loads_after_warmup": rec["library_loads"],
        "storms": rec["storms"], "generations": gens,
        "launches": launches_of(rec["launches"], want_launches),
        "expected_launches": want_launches}
    del fleet, rec

    # -- 2. disaggregated pools --------------------------------------------
    fleet, rec = disagg_drill(torch, dev, params, cfg)
    migs = rec["trace"].of("kv_migration")
    if fleet.counters["migrations"] != 5 or len(migs) != 5 or any(
            e["reason"] != "disagg" or e["from_replica"] != 0
            for e in migs):
        raise AssertionError(f"disagg drill: migrations {migs}")
    ref, one_tps = one_engine_streams(torch, dev, params, cfg, rec["reqs"],
                                      max_slots=2, max_seq=48)
    if sorted(fleet.results) != list(range(5)) or any(
            fleet.results[f].tokens != ref[f].tokens for f in range(5)):
        raise AssertionError("disagg drill: streams differ from one "
                             "engine's")
    ok, problems = fleet.verify_attribution()
    if not ok or rec["library_loads"] or rec["storms"]:
        raise AssertionError(f"disagg drill: attribution {problems[:3]}, "
                             f"{rec['library_loads']} loads")
    gens, want_launches = fleet_launch_check(
        rec["generations"], rec["launches"], cfg.n_layer, "disagg drill",
        prefill_chunks=False)
    out["pools"] = {
        "wall_s": rec["wall"], "ticks": fleet.tick,
        "host_ms_per_tick": rec["host_ms_per_tick"],
        "migrations": fleet.counters["migrations"],
        "handoff_ms": rec["handoff_ms"],
        "handoff_ms_mean": statistics.mean(rec["handoff_ms"]),
        "generations": gens,
        "launches": launches_of(rec["launches"], want_launches),
        "expected_launches": want_launches}
    emit({**out, "seconds": time.perf_counter() - t_phase})


def adversary_drill(torch, dev, params, cfg):
    """JAX's sub-threshold attacker drill: 3 replicas, the adaptive
    attacker on replica 2, a margin-signature monitor, vote K 2, closed
    loop at ADVERSARY_OPEN open requests until replica 2 is quarantined.
    Returns (fleet, plan, attacker, record)."""
    import numpy as np

    from trustworthy_dl_tpu_torch.chaos import (AdaptivePoisonAttacker,
                                                AdversaryConfig, FaultEvent,
                                                FaultInjector, FaultKind,
                                                FaultPlan,
                                                MarginSignatureMonitor)
    from trustworthy_dl_tpu_torch.serve import FleetConfig, ServeRequest

    adv_cfg = AdversaryConfig(
        target=2, seed=5, flag_rate_quarantine=0.25, safety_margin=0.08,
        initial_strength=0.3, step_up=0.1, backoff=0.5, min_strength=0.05,
        max_strength=1.0, signal_scale=40.0, signal_jitter=0.0,
        vocab_size=cfg.vocab_size)
    attacker = AdaptivePoisonAttacker(adv_cfg)
    plan = FaultPlan.scripted([FaultEvent(
        step=1, kind=FaultKind.REPLICA_ADAPTIVE_POISON, target=2)])
    fleet, rec = recorded_fleet(
        torch, dev, params, cfg, FleetConfig(
            num_replicas=3, max_retries=6, flag_window=16,
            flag_min_count=4, flag_rate_quarantine=0.25,
            suspicion_threshold=0.1, suspicion_min_flags=2, vote_k=2,
            vote_outvote_limit=2, quarantine_cooloff_ticks=10_000),
        chaos=FaultInjector(plan, adversary=attacker), max_slots=6,
        max_seq=48, queue_limit=4,
        monitor=MarginSignatureMonitor(ADVERSARY_THRESHOLD))
    rng = np.random.default_rng(1)
    prepared = []
    for _ in range(ADVERSARY_REQUESTS):
        plen = int(rng.integers(3, 10))
        new = int(rng.integers(4, 10))
        prepared.append((rng.integers(0, cfg.vocab_size, plen).tolist(),
                         int(new)))
    reqs = {}

    class Feed:
        done = False

        def __call__(self):
            if fleet.replicas[2].state.value == "quarantined":
                self.done = True
                return
            while prepared and sum(1 for r in fleet.requests.values()
                                   if not r.done) < ADVERSARY_OPEN:
                prompt, new = prepared.pop(0)
                fid = fleet.submit(ServeRequest(prompt=prompt,
                                                max_new_tokens=new))
                if fid is None:
                    prepared.insert(0, (prompt, new))
                    break
                reqs[fid] = (prompt, new)
            self.done = not prepared

    drive_ticks(torch, dev, fleet, rec, feed=Feed())
    rec["reqs"] = reqs
    return fleet, plan, attacker, rec


def envelope_launches(torch, dev, run):
    """``run()`` with every replica engine a fleet builds kept and the
    launch counters set to 0 just before and read just after; returns
    (its result, the engines, the launches)."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.serve import fleet as fleet_mod

    engines = []
    real = fleet_mod.ServingFleet._default_factory

    def keep(self, index, **kwargs):
        engine = real(self, index, **kwargs)
        engines.append((index, engine))
        return engine

    fleet_mod.ServingFleet._default_factory = keep
    try:
        ops.reset_launch_counts()
        result = run()
        sync(torch, dev)
        launches = ops.launch_counts()
    finally:
        fleet_mod.ServingFleet._default_factory = real
    return result, engines, launches


def serve_adversary_drive(torch, entries, card, dev="cuda", n_layer=12):
    """Phase 4j: the adaptive adversary and the serve envelope on the card
    (module docstring); ``dev`` and ``n_layer`` rehearse it on the CPU."""
    from trustworthy_dl_tpu_torch.chaos import predict_attacker_trajectory
    from trustworthy_dl_tpu_torch.experiments import serve_envelope

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg, params = smoke_gpt2(torch, dev, n_layer)
    out = {"phase": "serve_adversary", "card": card}

    # -- 1. the sub-threshold attacker -------------------------------------
    fleet, plan, attacker, rec = adversary_drill(torch, dev, params, cfg)
    reasons = {e["reason"] for e in rec["trace"].of("replica_transition")
               if e["to_state"] == "draining"}
    if reasons != {"verdict_outvoted"} or fleet.states() != {
            0: "healthy", 1: "healthy", 2: "quarantined"} \
            or fleet.replicas[2].flag_rate >= 0.25:
        raise AssertionError(f"adversary drill: drains {reasons}, states "
                             f"{fleet.states()}")
    predicted = plan.predict_fleet(vote_k=2, vote_outvote_limit=2,
                                   horizon=fleet.tick, cooloff_ticks=10_000)
    observed = {k: fleet.counters[k] for k in predicted}
    if observed != predicted:
        raise AssertionError(f"adversary drill: counters {observed}, "
                             f"predict_fleet {predicted}")
    flags = [f for f, _ in attacker.flag_observations]
    trajectory = predict_attacker_trajectory(attacker.config, flags,
                                             flag_window=16)
    if sum(flags) < 2 or attacker.strength_history != trajectory:
        raise AssertionError(f"adversary drill: trajectory "
                             f"{attacker.strength_history} != {trajectory}")
    reqs, results = rec["reqs"], fleet.results
    if sorted(results) != sorted(reqs) or any(
            r.status != "completed" for r in results.values()):
        raise AssertionError("adversary drill: an accepted request did not "
                             "complete")
    order = sorted(reqs)
    ref, one_tps = one_engine_streams(
        torch, dev, params, cfg, [reqs[f] for f in order], max_slots=6,
        max_seq=48, enable_monitor=False)
    corrupted = clean = 0
    clean_margin = 0.0
    for f, want in zip(order, ref):
        if results[f].replica == 2:
            if results[f].tokens == want.tokens:
                raise AssertionError(f"adversary drill: request {f} served "
                                     "by the attacker is not corrupted")
            corrupted += 1
        else:
            if results[f].tokens != want.tokens:
                raise AssertionError(f"adversary drill: clean request {f} "
                                     "differs from one engine's")
            clean += 1
            clean_margin = max(clean_margin, results[f].monitor_z)
    ok, problems = fleet.verify_attribution()
    replays = [r for r in fleet.ledger.records()
               if r.get("status") == "vote_replay"]
    if corrupted < 2 or clean < 2 or not ok \
            or len(replays) != 2 * fleet.counters["votes"] \
            or rec["library_loads"] or rec["storms"]:
        raise AssertionError(f"adversary drill: {corrupted} corrupted, "
                             f"{clean} clean, attribution {problems[:3]}, "
                             f"{rec['library_loads']} loads, "
                             f"{rec['storms']} storms")
    if clean_margin >= ADVERSARY_THRESHOLD:
        raise AssertionError(f"adversary drill: a clean request's mean "
                             f"margin {clean_margin} reaches the threshold")
    gens, want_launches = fleet_launch_check(
        rec["generations"], rec["launches"], cfg.n_layer, "adversary drill",
        prefill_chunks=False)
    tokens = sum(len(r.tokens) for r in results.values())
    out["drill"] = {
        "wall_s": rec["wall"], "tokens_per_s": tokens / rec["wall"],
        "one_engine_tokens_per_s": one_tps, "ticks": fleet.tick,
        "host_ms_per_tick": rec["host_ms_per_tick"],
        "requests": len(reqs), "counters": observed,
        "flags": sum(flags), "observations": len(flags),
        "final_strength": attacker.strength,
        "target_flag_rate": fleet.replicas[2].flag_rate,
        "corrupted_streams": corrupted, "clean_streams": clean,
        "clean_max_mean_margin": clean_margin,
        "monitor_threshold": ADVERSARY_THRESHOLD,
        "vote_replays": len(replays), "storms": rec["storms"],
        "generations": gens,
        "launches": launches_of(rec["launches"], want_launches),
        "expected_launches": want_launches}
    del fleet, rec, params

    # -- 2. the serve envelope at GPT-2 small's width ----------------------
    widths = dict(GPT2_SMALL, n_layer=n_layer)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res, engines, launches = envelope_launches(
            torch, dev, lambda: serve_envelope.run_serve_envelope(
                output_dir=tmp, model_overrides=widths, dtype="bfloat16",
                device=dev))
        wall = time.perf_counter() - t0
        table = serve_envelope.render_table(res)
        again, _, _ = envelope_launches(
            torch, dev, lambda: serve_envelope.run_serve_envelope(
                output_dir=tmp, strengths=(0.45,), thresholds=(24.0,),
                vote_ks=(2,), model_overrides=widths, dtype="bfloat16",
                device=dev, make_figure=False))
    cells = res["cells"]
    if len(cells) != 12 or any(
            c["completed"] != c["requests"] or c["requests"] != 24
            or c["clean_replica_quarantines"] for c in cells) \
            or any(c["detected_by"] == "vote" for c in cells
                   if c["vote_k"] == 0):
        raise AssertionError(f"serve envelope: cells {cells}")
    first = next(c for c in cells if (c["strength"], c["threshold"],
                                      c["vote_k"]) == (0.45, 24.0, 2))
    strip = (lambda c: {k: v for k, v in c.items() if k != "wall_time_s"})
    if strip(again["cells"][0]) != strip(first):
        raise AssertionError(f"serve envelope: a cell run twice differs: "
                             f"{again['cells'][0]} vs {first}")
    gens, want_launches = fleet_launch_check(engines, launches, cfg.n_layer,
                                             "serve envelope",
        prefill_chunks=False)
    print(table, flush=True)
    out["envelope"] = {
        "wall_s": wall, "sweep_wall_time_s": res["wall_time_s"],
        "cells": [{k: c[k] for k in (
            "strength", "threshold", "vote_k", "detected_by",
            "corrupted_served", "completed", "target_flag_rate",
            "suspicions", "votes", "outvotes", "ticks", "wall_time_s")}
            for c in cells],
        "engines": len(engines),
        "launches": launches_of(launches, want_launches),
        "expected_launches": want_launches}
    emit({**out, "seconds": time.perf_counter() - t_phase})


def padded_columns_shift(torch, normed, w) -> float:
    """What a head that let ``w``'s padded rows into its softmax would add
    to the mean loss over ``normed`` [..., D]: the logsumexp over the
    padded bf16 logits less that over the real columns, the same logits."""
    from trustworthy_dl_tpu_torch.ops import fused_ce

    padded = fused_ce.pad_vocab(w, torch.bfloat16)
    logits = (normed.bfloat16() @ padded.T).float()
    return float((torch.logsumexp(logits, -1) - torch.logsumexp(
        logits[..., :w.shape[0]], -1)).mean())


def gpt2_small(torch, **overrides):
    from trustworthy_dl_tpu_torch.models import gpt2

    return gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16,
                                     **overrides)


def flash_work(bh, t, d, matmuls, causal=True):
    """Flops of ``matmuls`` [t, t] x [t, d]-shaped products over ``bh``
    heads, 2 per multiply-add: over the causal triangle (t (t + 1) / 2
    query-key pairs) when ``causal``, else the whole score matrix."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 2 * bh * d * pairs * matmuls


FLASH_KERNELS = (
    # entry, profiler kernel name, tiles read, tiles written, lse-sized
    # rows moved, [t, t] x [t, d] products
    ("flash_attention_fwd", "flash_fwd_kernel", 3, 1, 1, 2),
    ("flash_attention_bwd_dq", "flash_dq_kernel", 4, 1, 2, 3),
    ("flash_attention_bwd_dkv", "flash_dkv_kernel", 4, 2, 2, 4))


def flash_case(torch, bh, t, d, causal, flush, gen, what):
    """B2, dq and dk/dv at [bh, t, d] bf16 (``causal`` or not; B3 from
    the new B2's ``lse``) against their plain twins, each within the
    attention tolerances, timed (events and the profiler's device time)
    beside its bound, its twin and SDPA (the forward; for both B3 entries
    SDPA's whole backward, which computes dq, dk and dv together).
    Returns ``{entry name: case}``; the forward's case also holds its lse
    error and its rate on events."""
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    dev = flush.device
    q, k, v, do = (torch.randn(bh, t, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    calls = {
        "flash_attention_fwd": (lambda: fa.flash_attention_fwd(q, k, v,
                                                               causal),
                                lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*args, causal),
            lambda: fa.flash_bwd_dq_plain(*args, causal)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*args, causal),
            lambda: fa.flash_bwd_dkv_plain(*args, causal))}
    errs = {}
    for name, (kern, plain) in calls.items():
        got = (o, lse) if name == "flash_attention_fwd" else kern()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        if name == "flash_attention_fwd":
            lse_err = float((got[1] - ref[1]).abs().max())
            if lse_err > LSE_ATOL:
                raise AssertionError(f"{what}: flash fwd lse err {lse_err}")
            got, ref = got[:1], ref[:1]
        errs[name] = 0.0
        for a, b in zip(got, ref):
            e = (a.float() - b.float()).abs()
            if not bool((e <= ATTN_ATOL + ATTN_RTOL * b.float().abs()).all()):
                raise AssertionError(f"{what}: {name} disagrees with plain "
                                     f"(max abs err {float(e.max())})")
            errs[name] = max(errs[name], float(e.max()))
        del got, ref
    q4, k4, v4 = (a.reshape(1, bh, t, d).clone().requires_grad_()
                  for a in (q, k, v))
    out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), is_causal=causal)

    def sdpa_bwd():
        return torch.autograd.grad(out4, (q4, k4, v4), do.view(1, bh, t, d),
                                   retain_graph=True)

    def library_device(fn):
        """SDPA's device ms, or None (not measured) where the profiler
        drops some of its kernels' launches in every session, as it did
        for cuDNN's backward late in a whole smoke: a yardstick, not a
        gate.  The kernels' own device times stay strict."""
        try:
            return kernel_ab.device_ms(fn, flush, 25)
        except RuntimeError as exc:
            print(f"{what}: SDPA's device time not measured: {exc}",
                  file=sys.stderr, flush=True)
            return None

    library = {"flash_attention_fwd": (sdpa_fwd, time_ms(torch, sdpa_fwd,
                                                         flush),
                                       library_device(sdpa_fwd))}
    library["flash_attention_bwd_dq"] = library["flash_attention_bwd_dkv"] \
        = (sdpa_bwd, time_ms(torch, sdpa_bwd, flush),
           library_device(sdpa_bwd))
    tile, rows = bh * t * d * 2, bh * t * 4
    label = f"SDPA is_causal={causal}"
    cases = {}
    for name, kernel, ins, n_out, n_rows, matmuls in FLASH_KERNELS:
        kern, plain = calls[name]
        b_ms, b_by = bound_entry((ins + n_out) * tile + n_rows * rows,
                                 flash_work(bh, t, d, matmuls, causal),
                                 "bfloat16")
        _, lib_ms, lib_dev = library[name]
        cases[name] = {
            "bhtd": [bh, t, d], "causal": causal,
            "max_abs_err": errs[name], "ms": time_ms(torch, kern, flush),
            "device_ms": device_ms(kern, flush, kernel),
            "plain_ms": time_ms(torch, plain, flush, reps=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev,
            "library": label + ("" if name == "flash_attention_fwd"
                                else ", its whole backward")}
    fwd = cases["flash_attention_fwd"]
    fwd["lse_max_abs_err"] = lse_err
    fwd["tflops"] = flash_work(bh, t, d, 2, causal) / (fwd["ms"] * 1e-3) \
        / 1e12
    return cases


def moments_case(torch, segs, flush):
    """B1 over ``segs`` against its plain twin (the sums within
    MOMENT_RTOL of each segment's magnitudes, the extrema exact), timed
    beside its bound and the fewest PyTorch reductions that give the
    eight sums."""
    from trustworthy_dl_tpu_torch.ops import fused_stats as fs

    got = fs.fused_moments(segs)
    torch.cuda.synchronize()
    ref = fs.fused_moments_plain(segs)
    mag = torch.stack([torch.stack([x.abs().sum(), (x * x).sum(),
                                    (x.abs() ** 3).sum(), (x ** 4).sum(),
                                    x.abs().sum()]) for x in segs])
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    sum_err = (got[:, sums] - ref[:, sums]).abs()
    exact = [fs.MIN, fs.MAX, fs.LINF]
    if not bool((sum_err <= MOMENT_RTOL * mag).all()) or not torch.equal(
            got[:, exact], ref[:, exact]):
        raise AssertionError(
            "fused_moments disagrees with plain: worst sum error / "
            f"magnitude {float((sum_err / mag).max())}, extrema equal "
            f"{torch.equal(got[:, exact], ref[:, exact])}")
    n_el = sum(x.numel() for x in segs)

    def library_moments():
        for x in segs:
            x.sum()
            for order in (1, 2, 4, float("inf")):
                torch.linalg.vector_norm(x, order)
            torch.aminmax(x)
            x.pow(3).sum()

    bound_ms, bound_by = bound_entry(n_el * 4 + len(segs) * 32, n_el * 12,
                                     "float32")
    return {"max_abs_err": float(sum_err.max()),
            "ms": time_ms(torch, lambda: fs.fused_moments(segs), flush,
                          reps=10),
            "plain_ms": time_ms(torch, lambda: fs.fused_moments_plain(segs),
                                flush, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(torch, library_moments, flush, reps=5)}


def check_train_kernels(torch, entries):
    """Phase 3, training kernels: B1 over the 16 gradient leaves of GPT-2
    small on each of 4 nodes (one launch, 64 segments), B2 and B3 at one
    node's attention shape [96, 1024, 64] bf16 (B3 from the new B2's
    ``lse``; each with the profiler's ``device_ms``, B3's beside SDPA's
    whole backward), and B2 at D = 32 and 128 (``cases``, T = 1024)."""
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = gpt2_small(torch)
    shapes = [tuple(p.shape) for p in tree_leaves(
        gpt2.init_params(cfg, gen, device=dev))]
    grads = [torch.randn((TRAIN_NODES,) + s, device=dev, generator=gen)
             * 1e-3 for s in shapes]
    segs = [g[i].reshape(-1) for i in range(TRAIN_NODES) for g in grads]
    entries["fused_moments"] = {
        "name": "fused_moments", "route": "cuda", "source": STATS_SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/fused_stats.py:85",
        "launches": 0, **moments_case(torch, segs, flush),
        "library_calls": "per segment: sum, linalg.vector_norm ord 1/2/4/"
                         "inf, aminmax, pow(3).sum",
        "shape": {"segments": len(segs),
                  "elements": sum(x.numel() for x in segs)},
    }
    del grads, segs

    bh, t, d = cfg.n_head * TRAIN_BATCH // TRAIN_NODES, TRAIN_T, \
        cfg.head_dim
    cases = flash_case(torch, bh, t, d, True, flush, gen, "train")
    for name, replaces in (("flash_attention_fwd", ":176"),
                           ("flash_attention_bwd_dq", ":306"),
                           ("flash_attention_bwd_dkv", ":324")):
        entries[name] = {
            "name": name, "route": "cuda", "source": FLASH_SOURCE,
            "replaces": "trustworthy_dl_tpu/ops/flash_attention.py"
                        + replaces,
            "launches": 0, **cases[name],
            "shape": {"bhtd": [bh, t, d], "dtype": "bfloat16"}}
    fwd = entries["flash_attention_fwd"]

    def err(a, b, name):
        e = (a.float() - b.float()).abs()
        if not bool((e <= ATTN_ATOL + ATTN_RTOL * b.float().abs()).all()):
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"(max abs err {float(e.max())})")
        return float(e.max())

    # B2 at the other head widths the kernel is built for, at T = 1024:
    # the same checks and yardstick, one entry each under ``cases``.
    fwd["cases"] = []
    for c_bh, c_d in ((96, 32), (48, 128)):
        q, k, v = (torch.randn(c_bh, t, c_d, device=dev, generator=gen).to(
            torch.bfloat16) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v)
        c_err = err(o, o_ref, f"flash fwd D={c_d}")
        c_lse = float((lse - lse_ref).abs().max())
        if c_lse > LSE_ATOL:
            raise AssertionError(f"flash fwd D={c_d} lse err {c_lse}")
        q4, k4, v4 = (a.view(1, c_bh, t, c_d) for a in (q, k, v))
        c_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), flush)
        c_dev = device_ms(lambda: fa.flash_attention_fwd(q, k, v),
                          flush, "flash_fwd_kernel")
        c_bound, c_by = bound_entry(4 * c_bh * t * c_d * 2 + c_bh * t * 4,
                                    flash_work(c_bh, t, c_d, 2), "bfloat16")
        fwd["cases"].append({
            "bhtd": [c_bh, t, c_d], "max_abs_err": c_err,
            "lse_max_abs_err": c_lse, "ms": c_ms, "device_ms": c_dev,
            "tflops": flash_work(c_bh, t, c_d, 2) / (c_ms * 1e-3) / 1e12,
            "bound_ms": c_bound, "bound_by": c_by,
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), flush)})
        del q, k, v, o, lse, o_ref, lse_ref, q4, k4, v4


def train_drive(torch, entries, card):
    """Phase 5: GPT-2 small at full width through ``DistributedTrainer``,
    detection OFF then ON under a gradient-poisoning attack on node 2."""
    import itertools

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    cfg = gpt2_small(torch)
    tokens_per_step = TRAIN_BATCH * TRAIN_T

    def trainer(detection):
        config = TrainingConfig(
            model_name="gpt2", batch_size=TRAIN_BATCH,
            num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
            remat=True, attack_detection_enabled=detection,
            gradient_verification_enabled=detection, seed=0)
        tr = DistributedTrainer(config, model_overrides=dict(
            seq_len=TRAIN_T, attn_impl="auto"), device="cuda")
        tr.initialize()
        return tr

    loader = get_dataloader("openwebtext", batch_size=TRAIN_BATCH,
                            seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                            num_examples=TRAIN_BATCH * ON_STEPS, seed=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    off = trainer(False)
    off.train_epoch(itertools.islice(iter(loader), OFF_WARMUP + OFF_TIMED),
                    0)
    off_hist = off.batch_history
    del off
    on = trainer(True)
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=ATTACK_START))
    attacker.activate_attacks()
    on.set_attack_plan(attacker.plan(TRAIN_NODES))
    on.train_epoch(loader, 0)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    on_hist = on.batch_history

    steps = OFF_WARMUP + OFF_TIMED + ON_STEPS
    per_layer = cfg.n_layer * TRAIN_NODES * steps
    want = {"flash_attention_fwd": 2 * per_layer,      # forward + remat
            "flash_attention_bwd_dq": per_layer,
            "flash_attention_bwd_dkv": per_layer,
            "fused_moments": 2 * steps}               # gradients + features
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"design says {n}: {launches}")
    losses = [h["loss"] for h in off_hist + on_hist]
    if not all(math.isfinite(x) for x in losses) or len(on_hist) != ON_STEPS:
        raise AssertionError(f"train losses {losses}")
    flag_steps = [s for s, h in enumerate(on_hist) if h["attacked"][2]]
    expect_gating(on_hist, ATTACK_START, "train")
    if not flag_steps or flag_steps[0] > ATTACK_START + 1:
        raise AssertionError(f"node 2 confirmed at steps {flag_steps}")
    if [r["node_id"] for r in on.attack_history] != [2] or \
            on.attack_history[0]["attack_type"] != "gradient_poisoning":
        raise AssertionError(f"attack history {on.attack_history}")

    # A step's step_s is the wall since the previous step ended (batch
    # drawn and copied, step, host sync, record-keeping), so the timed
    # steps tile their window and tokens/s is over the window's wall.
    off_window = [h["step_s"] for h in off_hist[OFF_WARMUP:]]
    on_window = [h["step_s"] for h in on_hist[ON_WARMUP:ATTACK_START]]
    tps_off = tokens_per_step * len(off_window) / sum(off_window)
    tps_on = tokens_per_step * len(on_window) / sum(on_window)
    off_ms = 1e3 * statistics.mean(off_window)
    on_ms = 1e3 * statistics.mean(on_window)
    for name in want:
        entries[name]["launches"] = launches[name]
    emit({"phase": "train", "card": card,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                   "weights, random init seed 0)",
          "nodes": TRAIN_NODES, "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
          "tokens_per_step": tokens_per_step,
          "tokens_per_s_detection_on": tps_on,
          "tokens_per_s_detection_off": tps_off,
          "vs_baseline": tps_on / tps_off,
          "step_ms_on": on_ms, "step_ms_off": off_ms,
          "step_ms_on_each": [1e3 * h["step_s"] for h in on_hist],
          "step_ms_off_each": [1e3 * h["step_s"] for h in off_hist],
          "peak_memory_bytes": peak,
          "losses_off": [h["loss"] for h in off_hist],
          "losses_on": [h["loss"] for h in on_hist],
          "per_node_loss_last": on_hist[-1]["per_node_loss"],
          "launches": launches, "expected_launches": want,
          "attack_start_step": ATTACK_START, "flag_steps": flag_steps,
          "attack_history": [{k: r[k] for k in ("node_id", "step",
                                                "attack_type")}
                             for r in on.attack_history],
          "trust_last": on_hist[-1]["trust_scores"]})
    return on, loader


def flash_vs_full(torch, on, loader, card):
    """One train step from the detection-ON run's final state with flash
    and with full attention (verdicts equal, losses within bf16), then
    fwd+bwd times of one layer's attention at T = 512 and 1024 (the
    AUTO_FLASH_MIN_T choice)."""
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
    from trustworthy_dl_tpu_torch.engine.step import build_train_step
    from trustworthy_dl_tpu_torch.models.factory import create_model
    from trustworthy_dl_tpu_torch.models.gpt2 import full_attention
    from trustworthy_dl_tpu_torch.ops.flash_attention import flash_attention

    batch = on._node_batch(next(iter(loader)))
    plan = null_plan(TRAIN_NODES, "cuda")
    out = {}
    for impl in ("flash", "full"):
        bundle = create_model("gpt2", seq_len=TRAIN_T, attn_impl=impl,
                              remat=True)
        step = build_train_step(bundle, on.config, on.optimizer)
        _, m = step(on.state, batch, plan)
        out[impl] = {k: getattr(m, k).tolist() for k in (
            "per_node_loss", "attacked", "verified", "finite", "byzantine",
            "backdoor", "status")}
        out[impl]["gated"] = (m.weights == 0).tolist()
        # attack_type is meaningful only where a node is confirmed.
        out[impl]["attack_type"] = torch.where(
            m.attacked, m.attack_type, -1).tolist()
        del m
    diff = max(abs(a - b) for a, b in zip(out["flash"]["per_node_loss"],
                                          out["full"]["per_node_loss"]))
    verdicts_equal = all(out["flash"][k] == out["full"][k]
                         for k in out["flash"] if k != "per_node_loss")
    if diff > FLASH_VS_FULL_LOSS_ATOL or not verdicts_equal:
        raise AssertionError(f"flash vs full step: loss diff {diff}, "
                             f"verdicts {out}")

    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    times = {}
    for t in (512, 1024):
        qkv = [torch.randn(TRAIN_BATCH // TRAIN_NODES, 12, t, 64,
                           device=dev, generator=gen).to(torch.bfloat16)
               .requires_grad_() for _ in range(3)]
        g = torch.randn_like(qkv[0])
        for name, fn in (("flash", flash_attention),
                         ("full", full_attention)):
            def fwd_bwd(fn=fn):
                torch.autograd.grad(fn(*qkv), qkv, g)
            times[f"{name}_T{t}_ms"] = time_ms(torch, fwd_bwd, flush)
    emit({"phase": "flash_vs_full", "card": card,
          "step_per_node_loss_max_abs_diff": diff,
          "step_verdicts_equal": verdicts_equal,
          "attention_fwd_bwd_shape": "[8, 12, T, 64] bf16", **times})


def moe_launches(cfg, steps, leaves, nodes=TRAIN_NODES):
    """B1-B3 launches of ``steps`` MoE step executions with block remat:
    B2/B3 as :func:`step_launches`, B1 at most ``MAX_SEGMENTS`` segments
    a launch, ``nodes x leaves`` gradient segments and ``nodes`` feature
    segments a step."""
    from trustworthy_dl_tpu_torch.ops.fused_stats import MAX_SEGMENTS

    want = step_launches(cfg, [nodes] * steps)
    want["fused_moments"] = steps * (-(-nodes * leaves // MAX_SEGMENTS)
                                     + -(-nodes // MAX_SEGMENTS))
    return want


def moe_drive(torch, entries, card):
    """Phase 5b: ``gpt2-moe`` at GPT-2 small's full width through
    ``DistributedTrainer`` in data mode, detection ON under a
    gradient-poisoning attack, then the priority dispatcher under capacity
    pressure, then B1 at the MoE gradient mix."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.models.moe import _capacity
    from trustworthy_dl_tpu_torch.utils.train_profile import busy_window
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    node_tokens = MOE_BATCH // TRAIN_NODES * TRAIN_T

    def trainer(**overrides):
        config = TrainingConfig(
            model_name="gpt2-moe", batch_size=MOE_BATCH,
            num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
            remat=True, seed=0)
        tr = DistributedTrainer(config, model_overrides=dict(
            seq_len=TRAIN_T, attn_impl="auto", **overrides), device="cuda")
        tr.initialize()
        return tr

    def loader(steps, seed):
        return get_dataloader("openwebtext", batch_size=MOE_BATCH,
                              seq_len=TRAIN_T, vocab_size=50257,
                              num_examples=MOE_BATCH * steps, seed=seed)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer()
    cfg = tr.model.config
    shapes = [tuple(p.shape) for p in tree_leaves(tr.state.params)]
    n_params = sum(math.prod(s) for s in shapes)
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=MOE_ATTACK_START))
    attacker.activate_attacks()
    tr.set_attack_plan(attacker.plan(TRAIN_NODES))
    ops.reset_launch_counts()
    busy = busy_window(tr, loader(MOE_STEPS, 0), first=MOE_BUSY_FIRST,
                       last=MOE_BUSY_LAST)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = list(tr.batch_history)
    want = moe_launches(cfg, MOE_STEPS, len(shapes))
    expect_launches_equal(launches, want, "moe")
    losses = [h["loss"] for h in hist]
    drops = [h["moe_drop_fraction"] for h in hist]
    if len(hist) != MOE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"moe losses {losses}")
    if not all(0.0 <= d < 1.0 for d in drops):
        raise AssertionError(f"moe drop fractions {drops}")
    expect_gating(hist, MOE_ATTACK_START, "moe")
    flag_steps = [s for s, h in enumerate(hist) if h["attacked"][2]]
    if [r["node_id"] for r in tr.attack_history] != [2] or \
            tr.attack_history[0]["attack_type"] != "gradient_poisoning":
        raise AssertionError(f"moe attack history {tr.attack_history}")
    incidents = [{k: r[k] for k in ("node_id", "step", "attack_type")}
                 for r in tr.attack_history]
    step_ms = [1e3 * h["step_s"] for h in hist]
    # After the profiled window: its last step's record also holds the
    # trace's processing.
    timed = step_ms[MOE_BUSY_LAST + 1:]
    del tr, hist
    gc.collect()
    torch.cuda.empty_cache()

    # The priority dispatcher under capacity pressure, clean.
    torch.cuda.reset_peak_memory_stats()
    pr = trainer(dispatch="priority", capacity_factor=MOE_PRIORITY_FACTOR)
    ops.reset_launch_counts()
    pr.train_epoch(loader(MOE_PRIORITY_STEPS, 1), 0)
    pri_launches = ops.launch_counts()
    pri_peak = torch.cuda.max_memory_allocated()
    pri_want = moe_launches(cfg, MOE_PRIORITY_STEPS, len(shapes))
    expect_launches_equal(pri_launches, pri_want, "moe priority")
    pri_hist = list(pr.batch_history)
    pri_losses = [h["loss"] for h in pri_hist]
    pri_drops = [h["moe_drop_fraction"] for h in pri_hist]
    if len(pri_hist) != MOE_PRIORITY_STEPS or not all(
            math.isfinite(x) for x in pri_losses):
        raise AssertionError(f"moe priority losses {pri_losses}")
    if not all(d >= 0.5 for d in pri_drops):
        raise AssertionError(f"moe priority drop fractions {pri_drops}: "
                             "capacity factor 0.5 forces >= 0.5")
    pri_flagged = [s for s, h in enumerate(pri_hist) if any(h["attacked"])]
    pri_ms = [1e3 * h["step_s"] for h in pri_hist]
    pri_capacity = _capacity(node_tokens, pr.model.config)
    del pr, pri_hist
    gc.collect()
    torch.cuda.empty_cache()

    # B1 over the MoE step's gradient battery against its twin.
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8,
                        device=torch.device("cuda"))
    mix = b1_at_mix(torch, shapes, TRAIN_NODES, flush, full=True)
    split = moe_layer_split(torch, cfg, node_tokens, flush)
    del flush
    entries["fused_moments"]["moe_mix"] = {
        k: mix[k] for k in ("segments", "elements", "launches_per_battery",
                            "ms", "ms_per_launch", "graph_ms",
                            "host_us_per_launch", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "max_abs_err")}
    for name in want:
        entries[name]["launches_moe"] = launches[name] + pri_launches[name]
    device_ms = 1e3 * busy["device_kernel_s"] / (
        MOE_BUSY_LAST - MOE_BUSY_FIRST + 1)
    emit({"phase": "moe", "card": card,
          "seconds": time.perf_counter() - t_phase,
          "model": f"gpt2-moe ({n_params} params, {len(shapes)} leaves: "
                   f"{cfg.n_layer}L, {cfg.n_embd}, {cfg.n_head}H, "
                   f"V{cfg.vocab_size}, {cfg.n_experts} experts top-"
                   f"{cfg.top_k}, bf16 over f32 master weights, block "
                   "remat, random init seed 0)",
          "nodes": TRAIN_NODES, "batch": MOE_BATCH, "seq_len": TRAIN_T,
          "tokens_per_step": MOE_BATCH * TRAIN_T,
          "capacity": _capacity(node_tokens, cfg),
          "step_ms": step_ms,
          "timed_steps": [MOE_BUSY_LAST + 1, MOE_STEPS - 1],
          "step_ms_median": statistics.median(timed),
          "tokens_per_s": MOE_BATCH * TRAIN_T * len(timed) / sum(timed)
          * 1e3,
          "device_ms_per_step": device_ms, "busy": busy,
          "peak_memory_bytes": peak, "losses": losses,
          "drop_fraction": drops, "attack_start_step": MOE_ATTACK_START,
          "flag_steps": flag_steps, "attack_history": incidents,
          "launches": launches, "expected_launches": want,
          "priority": {"capacity_factor": MOE_PRIORITY_FACTOR,
                       "capacity": pri_capacity, "step_ms": pri_ms,
                       "peak_memory_bytes": pri_peak,
                       "losses": pri_losses, "drop_fraction": pri_drops,
                       "flagged_steps": pri_flagged,
                       "launches": pri_launches},
          "b1_at_mix": mix, "layer_forward_ms": split})


def moe_layer_split(torch, cfg, tokens, flush):
    """ms of one MoE layer's forward parts at one node's shape (``tokens``
    tokens, random unit-normal activations and a fresh layer): the
    routing (router product, softmax, dispatcher), the dispatch product
    (bf16 [S, E C] x [S, d]), the expert FFN and the f32 combine product,
    and the whole ``moe_mlp``."""
    import dataclasses

    from trustworthy_dl_tpu_torch.models import moe
    from trustworthy_dl_tpu_torch.utils.tree import map_tree

    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(3)
    one = dataclasses.replace(cfg, n_layer=1)
    blk = map_tree(lambda a: a[0], moe.init_block_params(one, gen, dev)
                   )["moe"]
    x = torch.randn(tokens, cfg.n_embd, device=dev, generator=gen)
    cap = moe._capacity(tokens, cfg)
    dt = cfg.dtype

    def time_part(fn):
        return time_ms(torch, fn, flush, reps=10)

    # The parts are moe_mlp's own helpers, so the split times its code.
    with torch.no_grad():
        combine, _ = moe.route(blk, x, cfg, cap)
        routed = combine > 0
        expert_in = moe.dispatch_tokens(routed, x, dt)
        out = moe.experts(blk, expert_in, dt)
        return {"tokens": tokens, "capacity": cap,
                "routing": time_part(lambda: moe.route(blk, x, cfg, cap)),
                "dispatch_product": time_part(
                    lambda: moe.dispatch_tokens(routed, x, dt)),
                "experts": time_part(lambda: moe.experts(blk, expert_in, dt)),
                "combine_product": time_part(
                    lambda: moe.combine_outputs(combine, out)),
                "moe_mlp": time_part(lambda: moe.moe_mlp(blk, x[None], cfg))}


def envelope_drive(torch, entries, card):
    """Phase 5c: ``run_detection_envelope`` at GPT-2 small's width on the
    card, gated by the JAX package's floors."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.experiments import run_detection_envelope

    cfg = gpt2_small(torch)
    out_dir = tempfile.mkdtemp(prefix="tddl_envelope_")
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run_detection_envelope(
            output_dir=out_dir, attack_types=ENVELOPE_TYPES,
            intensities=[1.0], num_nodes=TRAIN_NODES,
            targets=ENVELOPE_TARGETS, warmup_steps=ENVELOPE_WARMUP,
            attack_steps=ENVELOPE_ATTACK, device="cuda",
            model_overrides=dict(n_layer=cfg.n_layer, n_embd=cfg.n_embd,
                                 n_head=cfg.n_head,
                                 vocab_size=cfg.vocab_size,
                                 n_positions=cfg.n_positions,
                                 seq_len=TRAIN_T))
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        files = sorted(os.listdir(out_dir))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    runs = [res["clean"]] + res["cells"]
    steps = (ENVELOPE_WARMUP + ENVELOPE_ATTACK) * len(runs)
    want = step_launches(cfg, [TRAIN_NODES] * steps, remat=False)
    expect_launches_equal(launches, want, "envelope")
    for name in want:
        entries[name]["launches_envelope"] = launches[name]
    if [r["steps"] for r in runs] != [ENVELOPE_WARMUP + ENVELOPE_ATTACK] \
            * len(runs) or not all(r["finite"] for r in runs):
        raise AssertionError(f"envelope runs {runs}")
    gp = res["cells"][ENVELOPE_TYPES.index("gradient_poisoning")]
    for run in (res["clean"], gp):
        if run["fp_rate"] != 0.0 or run["false_positive_incidents"]:
            raise AssertionError(f"envelope false positives: {run}")
    if gp["detection_rate"] != 1.0 or gp["median_latency_steps"] > 3 \
            or gp["attribution_accuracy"] != 1.0:
        raise AssertionError(f"envelope gradient poisoning floor: {gp}")
    if not {"detection_envelope.json", "detection_envelope.md"} <= \
            set(files):
        raise AssertionError(f"envelope artifacts {files}")
    keys = ("attack_type", "detection_rate", "detected_nodes",
            "median_latency_steps", "latencies", "fp_rate",
            "false_positive_incidents", "attribution_accuracy",
            "strict_attribution_accuracy", "attributed_types", "finite")
    emit({"phase": "envelope", "card": card, "seconds": wall,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                   "weights, no remat, flash; each run from seed 0)",
          "nodes": TRAIN_NODES, "batch": 2 * TRAIN_NODES,
          "seq_len": TRAIN_T, "targets": list(ENVELOPE_TARGETS),
          "warmup_steps": ENVELOPE_WARMUP, "attack_steps": ENVELOPE_ATTACK,
          "wall_time_s": res["wall_time_s"], "artifacts": files,
          "clean": {k: res["clean"][k] for k in keys},
          "cells": [{k: c[k] for k in keys} for c in res["cells"]],
          "platform": res["run_metadata"]["platform"],
          "launches": launches, "expected_launches": want})


def expect_gating(hist, attack_start, what, targets=(2,),
                  nodes=TRAIN_NODES):
    """The ``targets`` gated on every step from ``attack_start`` and never
    before, no other node ever flagged or gated."""
    others = [i for i in range(nodes) if i not in targets]
    for s, h in enumerate(hist):
        if any(h["attacked"][i] or h["weights"][i] == 0 for i in others):
            raise AssertionError(f"{what} step {s}: a clean node was "
                                 f"flagged or gated: {h}")
        for t in targets:
            if s >= attack_start and h["weights"][t] != 0:
                raise AssertionError(f"{what} step {s}: node {t} not gated "
                                     "under attack")
            if s < attack_start and (h["weights"][t] == 0
                                     or h["attacked"][t]):
                raise AssertionError(f"{what} step {s}: node {t} gated "
                                     "before the attack")


def timed_step(torch, step, state, batch, plan):
    """(metrics, ms, peak bytes) of a step's second run from ``state``
    (the first warms the allocator and the library's GEMM choices)."""
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, m = step(state, batch, plan)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    return m, ms, torch.cuda.max_memory_allocated()


def state_bytes(opt_state):
    return sum(t.numel() * t.element_size()
               for t in [opt_state.count] + opt_state.mu + opt_state.nu)


def train_fused_ce(torch, entries, card):
    """Phase 6: the training path at 16,384 tokens a node, where the
    vocab-chunked fused head, gradient accumulation, the attention remat
    policy, evaluation and Adafactor each run on the card."""
    import itertools

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.step import build_node_eval_step, \
        build_train_step
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.models import layers as L
    from trustworthy_dl_tpu_torch.models.factory import create_model
    from trustworthy_dl_tpu_torch.ops import fused_ce

    cfg = gpt2_small(torch)
    node_tokens = FCE_BATCH // TRAIN_NODES * TRAIN_T
    chunk = gpt2.resolve_lm_head_chunk(cfg, node_tokens)
    if chunk != fused_ce.DEFAULT_CHUNK:
        raise AssertionError(f"auto resolved to {chunk} at {node_tokens} "
                             "tokens a node")

    def trainer(optimizer="adamw"):
        config = TrainingConfig(
            model_name="gpt2", batch_size=FCE_BATCH, num_nodes=TRAIN_NODES,
            optimizer=optimizer, learning_rate=1e-4, remat=True, seed=0)
        tr = DistributedTrainer(config, model_overrides=dict(
            seq_len=TRAIN_T, attn_impl="auto"), device="cuda")
        tr.initialize()
        return tr

    loader = get_dataloader("openwebtext", batch_size=FCE_BATCH,
                            seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                            num_examples=FCE_BATCH * FCE_STEPS, seed=1)
    tr = trainer()
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=FCE_ATTACK_START))
    attacker.activate_attacks()
    tr.set_attack_plan(attacker.plan(TRAIN_NODES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fused_ce.reset_calls()
    tr.train_epoch(loader, 0)
    launches = ops.launch_counts()
    calls = dict(fused_ce.CALLS)
    peak = torch.cuda.max_memory_allocated()
    hist = tr.batch_history

    per_layer = cfg.n_layer * TRAIN_NODES * FCE_STEPS
    want = {"flash_attention_fwd": 2 * per_layer,      # forward + remat
            "flash_attention_bwd_dq": per_layer,
            "flash_attention_bwd_dkv": per_layer,
            "fused_moments": 2 * FCE_STEPS}           # gradients + features
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"train_fused_ce: {name} launched "
                                 f"{launches[name]} times, design says {n}")
        entries[name]["launches_train_fused_ce"] = n
    # Once a node and step forward, once in its own backward: block remat
    # recomputes the blocks, not the head.
    want_calls = {"forward": TRAIN_NODES * FCE_STEPS,
                  "backward": TRAIN_NODES * FCE_STEPS, "eval": 0}
    if calls != want_calls:
        raise AssertionError(f"fused head calls {calls}, want {want_calls}")
    losses = [h["loss"] for h in hist]
    if len(hist) != FCE_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train_fused_ce losses {losses}")
    expect_gating(hist, FCE_ATTACK_START, "train_fused_ce")
    if [r["node_id"] for r in tr.attack_history] != [2] or \
            tr.attack_history[0]["attack_type"] != "gradient_poisoning":
        raise AssertionError(f"attack history {tr.attack_history}")
    if not tr.reassignment_history or not all(
            math.isfinite(r["migration_time"])
            for r in tr.reassignment_history):
        raise AssertionError(f"reassignments {tr.reassignment_history}")
    step_ms = [1e3 * h["step_s"] for h in hist]
    incidents = [{k: r[k] for k in ("node_id", "step", "attack_type")}
                 for r in tr.attack_history]
    migration_s = [r["migration_time"] for r in tr.reassignment_history]

    # One step from the final state through the four arms.
    batch = tr._node_batch(next(iter(loader)))
    plan = null_plan(TRAIN_NODES, "cuda")
    arm_kw = {
        "fused": ({}, {}),
        "materialised": ({}, {"lm_head_chunk": 0}),
        "accum2": ({"grad_accum_steps": 2}, {}),
        "attention_remat_full": ({"remat_policy": "attention"},
                                 {"attn_impl": "full",
                                  "remat_policy": "attention"})}
    arms = {}
    for name, (config_kw, model_kw) in arm_kw.items():
        config = TrainingConfig(**{**tr.config.__dict__, **config_kw})
        bundle = create_model("gpt2", **{"seq_len": TRAIN_T, "remat": True,
                                         "attn_impl": "auto", **model_kw})
        step = build_train_step(bundle, config, tr.optimizer)
        fused_ce.reset_calls()
        m, ms, arm_peak = timed_step(torch, step, tr.state, batch, plan)
        arms[name] = {"step_ms": ms, "peak_memory_bytes": arm_peak,
                      "fused_forward_calls": fused_ce.CALLS["forward"] // 2,
                      "per_node_loss": m.per_node_loss.tolist(),
                      "verdicts": {k: getattr(m, k).tolist() for k in (
                          "attacked", "verified", "finite", "byzantine",
                          "backdoor", "status")},
                      "gated": (m.weights == 0).tolist(),
                      "attack_type": torch.where(m.attacked, m.attack_type,
                                                 -1).tolist()}
        del m, step
    ref = arms["fused"]
    loss_diff = {name: max(abs(a - b) for a, b in zip(
        arm["per_node_loss"], ref["per_node_loss"]))
        for name, arm in arms.items()}
    same = {name: all(arm[k] == ref[k] for k in ("verdicts", "gated",
                                                 "attack_type"))
            for name, arm in arms.items()}
    want_fwd = {"fused": TRAIN_NODES, "materialised": 0, "accum2": 0,
                "attention_remat_full": TRAIN_NODES}
    # What the padded-columns fault would read here: node 0's loss on
    # this batch, from the final state.
    params = tr.state.params
    node0 = {k: v[0] for k, v in batch.items()}
    with torch.no_grad():
        hidden = gpt2.apply_blocks(params["blocks"],
                                   gpt2.embed(params, node0["input"]),
                                   tr.model.config)
        arms_planted = padded_columns_shift(
            torch, L.layernorm(params["ln_f"], hidden), params["wte"])
    del hidden, params, node0
    if not max(loss_diff.values()) <= ARMS_LOSS_ATOL < arms_planted \
            or not all(same.values()) \
            or {k: a["fused_forward_calls"] for k, a in arms.items()} \
            != want_fwd:
        raise AssertionError(f"arms: loss diff {loss_diff} (limit "
                             f"{ARMS_LOSS_ATOL}, padded-columns fault "
                             f"{arms_planted}), verdicts equal {same}: "
                             f"{arms}")

    # Validation through the fused eval head.
    val = get_dataloader("openwebtext", split="validation",
                         batch_size=FCE_BATCH, seq_len=TRAIN_T,
                         vocab_size=cfg.vocab_size,
                         num_examples=FCE_BATCH * FCE_VAL_BATCHES, seed=0)
    fused_ce.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val_metrics = tr.validate_metrics(val)
    val_ms = 1e3 * (time.perf_counter() - t0)
    if fused_ce.CALLS["eval"] != TRAIN_NODES * FCE_VAL_BATCHES or not all(
            math.isfinite(v) for v in val_metrics.values()):
        raise AssertionError(f"validation {val_metrics} {fused_ce.CALLS}")
    first = tr._node_batch(next(iter(val)), for_eval=True)
    fused_first = tr._eval_step(tr.state.params, first)
    mat_first = build_node_eval_step(create_model(
        "gpt2", seq_len=TRAIN_T, lm_head_chunk=0))(tr.state.params, first)
    val_diff = abs(float(fused_first["loss"]) - float(mat_first["loss"]))
    if val_diff > ARMS_LOSS_ATOL:
        raise AssertionError(f"fused vs materialised eval loss {val_diff}")
    adamw_bytes = state_bytes(tr.state.opt_state)
    wte = tr.state.params["wte"].detach().clone()
    del tr, batch, first

    # Two Adafactor steps.
    ada = trainer(optimizer="adafactor")
    ada.train_epoch(itertools.islice(iter(loader), 2), 0)
    ada_losses = [h["loss"] for h in ada.batch_history]
    if len(ada_losses) != 2 or not all(math.isfinite(x) for x in ada_losses):
        raise AssertionError(f"adafactor losses {ada_losses}")
    ada_bytes = state_bytes(ada.state.opt_state)
    del ada

    # The fused head alone against the materialised cross-entropy.
    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(node_tokens, cfg.n_embd, device=dev, generator=gen
                    ).requires_grad_()
    w = wte.requires_grad_()
    tgt = torch.randint(0, cfg.vocab_size, (node_tokens,), device=dev,
                        generator=gen)

    def fused_loss():
        return fused_ce.fused_lm_loss(x, w, tgt, chunk, torch.bfloat16)

    def mat_loss():
        logits = gpt2.project_logits(gpt2.head_weight({"wte": w}, cfg), x,
                                     cfg)
        return L.cross_entropy_loss(logits, tgt)

    head = {}
    for name, fn in (("fused", fused_loss), ("materialised", mat_loss)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss = fn()
        grads = torch.autograd.grad(loss, (x, w))
        torch.cuda.synchronize()
        head[name] = {"loss": float(loss.detach()), "grads": grads,
                      "peak_memory_bytes":
                          torch.cuda.max_memory_allocated() - base,
                      "fwd_bwd_ms": time_ms(torch, lambda fn=fn:
                                            torch.autograd.grad(fn(), (x, w)),
                                            flush, reps=5)}
        del loss
    loss_rel = abs(head["fused"]["loss"] - head["materialised"]["loss"]) \
        / abs(head["materialised"]["loss"])
    grad_rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(
        head["fused"].pop("grads"), head["materialised"].pop("grads"))]
    with torch.no_grad():
        head_planted = padded_columns_shift(torch, x, w) \
            / abs(head["materialised"]["loss"])
    if not loss_rel <= FCE_LOSS_RTOL < head_planted \
            or max(grad_rel) > FCE_GRAD_RTOL:
        raise AssertionError(f"fused head vs materialised: loss rel "
                             f"{loss_rel} (limit {FCE_LOSS_RTOL}, "
                             f"padded-columns fault {head_planted}), dx/dW "
                             f"rel {grad_rel}")
    # The products' route, on one block: f32 results of bf16 operands
    # (``torch.mm(..., out_dtype=torch.float32)``) against an f32 product
    # of the same values (TF32 off) and a bf16 product; the last block at
    # its 1,105 real columns against the 1,152 it is padded to.
    xb = x.detach().bfloat16()
    wb = w.detach()[:chunk].bfloat16()
    xf32, wf32 = xb.float(), wb.float()
    tail = cfg.vocab_size % chunk
    padded = tail + -tail % fused_ce.VOCAB_PAD
    routes = {
        "block": [node_tokens, cfg.n_embd, chunk],
        "out_dtype_f32_ms": time_ms(
            torch, lambda: fused_ce.product_f32(xb, wb.T), flush, reps=10),
        "f32_product_ms": time_ms(torch, lambda: xf32 @ wf32.T, flush,
                                  reps=10),
        "bf16_product_ms": time_ms(torch, lambda: xb @ wb.T, flush, reps=10),
        f"last_block_{tail}_ms": time_ms(
            torch, lambda: fused_ce.product_f32(xb, wb[:tail].T), flush,
            reps=10),
        f"last_block_{padded}_ms": time_ms(
            torch, lambda: fused_ce.product_f32(xb, wb[:padded].T), flush,
            reps=10)}
    del xb, wb, xf32, wf32
    # Least time of the fused head's fwd+bwd: four products of 2 N D V
    # flops (forward, the backward's recompute, dx, dW) at the bf16 peak.
    head_bound_ms = 4 * 2 * node_tokens * cfg.n_embd * cfg.vocab_size \
        / PEAK_FLOPS["bfloat16"] * 1e3
    emit({"phase": "train_fused_ce", "card": card,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                   "weights, random init seed 0)",
          "nodes": TRAIN_NODES, "batch": FCE_BATCH, "seq_len": TRAIN_T,
          "tokens_per_node": node_tokens, "lm_head_chunk": chunk,
          "materialised_logits_bytes_per_node":
              node_tokens * cfg.vocab_size * 2,
          "losses": losses, "step_ms_each": step_ms,
          "step_ms_after_first": statistics.mean(step_ms[1:]),
          "peak_memory_bytes": peak, "launches": launches,
          "expected_launches": want, "fused_head_calls": calls,
          "attack_start_step": FCE_ATTACK_START,
          "flag_steps": [s for s, h in enumerate(hist) if h["attacked"][2]],
          "attack_history": incidents, "migration_time_s": migration_s,
          "arms": {k: {f: a[f] for f in ("step_ms", "peak_memory_bytes",
                                         "per_node_loss")}
                   for k, a in arms.items()},
          "arms_per_node_loss_max_abs_diff": loss_diff,
          "arms_loss_atol": ARMS_LOSS_ATOL,
          "arms_padded_columns_fault": arms_planted,
          "arms_verdicts_equal": same,
          "validation": dict(val_metrics, ms=val_ms,
                             batches=FCE_VAL_BATCHES),
          "validation_first_batch_fused_vs_materialised_loss_diff":
              val_diff,
          "adafactor_losses": ada_losses,
          "optimizer_state_bytes": {"adamw": adamw_bytes,
                                    "adafactor": ada_bytes},
          "fused_head_check": {"shape": [node_tokens, cfg.n_embd,
                                         cfg.vocab_size],
                               "loss_rel_err": loss_rel,
                               "loss_rtol": FCE_LOSS_RTOL,
                               "padded_columns_fault_rel": head_planted,
                               "dx_dw_rel_err": grad_rel,
                               "bound_ms": head_bound_ms,
                               "product_routes": routes, **head}})


def flash_b1_launches(cfg, steps, remat, validations=0, val_rows=0):
    """B1-B3 launches of ``steps`` step executions and ``validations``
    validation batches of ``val_rows`` rows: per step, one flash forward
    a layer and node (two with block remat), one dq and one dk/dv, and
    two moment batteries; per validation row, one forward a layer."""
    per_layer = cfg.n_layer * TRAIN_NODES * steps
    return {"flash_attention_fwd": (2 if remat else 1) * per_layer
            + cfg.n_layer * val_rows * validations,
            "flash_attention_bwd_dq": per_layer,
            "flash_attention_bwd_dkv": per_layer,
            "fused_moments": 2 * steps}


def experiment_drive(torch, entries, card):
    """Phase 7: ``ExperimentRunner`` on GPT-2 small at full width."""
    import csv

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core.config import ExperimentConfig
    from trustworthy_dl_tpu_torch.experiments import ExperimentRunner

    cfg = gpt2_small(torch)
    out_dir = tempfile.mkdtemp(prefix="tddl_experiment_")
    t0 = time.perf_counter()
    try:
        config = ExperimentConfig(
            experiment_name="gpt2_small_attack", model_name="gpt2",
            dataset_name="openwebtext", num_nodes=TRAIN_NODES,
            num_epochs=EXP_EPOCHS, batch_size=TRAIN_BATCH,
            learning_rate=1e-4, attack_enabled=True,
            attack_start_epoch=EXP_ATTACK_EPOCH, attack_intensity=0.5,
            target_nodes=[2], attack_types=["gradient_poisoning"],
            steps_per_epoch=EXP_STEPS_PER_EPOCH, output_dir=out_dir)
        runner = ExperimentRunner(
            config, model_overrides=dict(seq_len=TRAIN_T, attn_impl="auto"),
            data_overrides=dict(seq_len=TRAIN_T,
                                vocab_size=cfg.vocab_size),
            device="cuda")
        runner.setup_experiment()
        val_batches = len(runner.val_loader)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        results = runner.run_experiment()
        launches = ops.launch_counts()
        steps = EXP_STEPS_PER_EPOCH * EXP_EPOCHS
        want = flash_b1_launches(cfg, steps, runner.training_config.remat,
                                 EXP_EPOCHS * val_batches, TRAIN_NODES)
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"experiment: {name} launched "
                                     f"{launches[name]} times, design says "
                                     f"{n}")
            entries[name]["launches_experiment"] = n
        with open(runner.output_dir / "experiment_results.json") as f:
            loaded = json.load(f)
        with open(runner.output_dir / "training_metrics.csv",
                  newline="") as f:
            header = next(csv.reader(f))
        if any(f"trust_node_{i}" not in header for i in range(TRAIN_NODES)):
            raise AssertionError(f"experiment: CSV header {header}")
        if not (runner.output_dir / "experiment_report.md").exists():
            raise AssertionError("experiment: no report")
        summary = results["experiment_summary"]
        quality = summary["detection_quality"]
        want_quality = {"target_nodes": [2], "detected_nodes": [2],
                        "true_positives": [2], "false_positives": [],
                        "missed": [], "precision": 1.0, "recall": 1.0}
        got_quality = {k: quality[k] for k in want_quality}
        if got_quality != want_quality or \
                not 0 < quality["steps_to_detection"][2] <= 2:
            raise AssertionError(f"experiment: detection quality {quality}")
        if summary["total_steps"] != steps or \
                loaded["experiment_summary"]["total_steps"] != steps:
            raise AssertionError(f"experiment: {summary['total_steps']} "
                                 "steps")
        records = results["epoch_records"]
        losses = [r["training_loss"] for r in records]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"experiment: losses {losses}")
        plots = sorted(p.name for p in runner.output_dir.glob("*.png"))
        emit({"phase": "experiment", "card": card,
              "seconds": time.perf_counter() - t0,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
              "seq_len": TRAIN_T, "steps": steps,
              "validation_batches_per_epoch": val_batches,
              "epoch_s": [r["epoch_time_s"] for r in records],
              "samples_per_sec": [r["system_metrics"].get("samples_per_sec")
                                  for r in records],
              "device_memory_utilization": [
                  r["system_metrics"].get("device_memory_utilization")
                  for r in records],
              "training_loss": losses,
              "validation_loss": [r["validation_loss"] for r in records],
              "trust_last": records[-1]["trust_scores"],
              "detection_quality": quality, "plots": plots,
              "launches": launches, "expected_launches": want,
              "experiment_time_s": results["experiment_time_s"]})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def io_rates(timings):
    """Each checkpoint operation's bytes, seconds and GB/s."""
    out = []
    for t in timings:
        row = dict(t)
        for key in ("snapshot_s", "write_s", "crc_s", "read_s",
                    "to_device_s", "s"):
            if key in t and t[key] > 0:
                row[key.replace("_s", "_gbps") if key != "s"
                    else "gbps"] = t["bytes"] / t[key] / 1e9
        out.append(row)
    return out


def survival_drive(torch, entries, card):
    """Phase 8: the scripted chaos drill through the supervisor, then a
    fall-back restore and two bit-equal restored steps."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
        FaultKind, FaultPlan, corrupt_file
    from trustworthy_dl_tpu_torch.chaos.injector import _largest_file
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.checkpoint import _leaves
    from trustworthy_dl_tpu_torch.engine.supervisor import \
        TrainingSupervisor
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    cfg = gpt2_small(torch)
    plan = FaultPlan.scripted([FaultEvent(step=s, kind=FaultKind(k),
                                          severity=v)
                               for s, k, v in DRILL_SCRIPT])
    ckpt_dir = tempfile.mkdtemp(prefix="tddl_survival_")
    t0 = time.perf_counter()

    def trainer():
        # Depth 0: FaultPlan.predict's retry counts are the synchronous
        # guard's (the async_host phase drills the lagged one).
        config = TrainingConfig(
            model_name="gpt2", batch_size=TRAIN_BATCH,
            num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
            remat=True, seed=0, checkpoint_interval=DRILL_INTERVAL,
            checkpoint_dir=ckpt_dir, num_epochs=DRILL_EPOCHS,
            async_host_depth=0)
        tr = DistributedTrainer(config, model_overrides=dict(
            seq_len=TRAIN_T, attn_impl="auto"), device="cuda")
        tr.initialize()
        return tr

    try:
        loader = get_dataloader(
            "openwebtext", batch_size=TRAIN_BATCH, seq_len=TRAIN_T,
            vocab_size=cfg.vocab_size,
            num_examples=TRAIN_BATCH * DRILL_STEPS_PER_EPOCH, seed=2)
        tr = trainer()
        sup = TrainingSupervisor(
            tr, max_retries=DRILL_RETRIES,
            rollback_after=DRILL_ROLLBACK_AFTER,
            max_restarts=DRILL_RESTARTS, chaos=FaultInjector(plan))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_drill = time.perf_counter()
        result = sup.run(loader, num_epochs=DRILL_EPOCHS)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t_drill
        launches = ops.launch_counts()
        report = result["supervisor"]
        predicted = plan.predict(DRILL_RETRIES, DRILL_ROLLBACK_AFTER)
        if {k: report[k] for k in predicted} != predicted:
            raise AssertionError(f"survival: report {report}, plan "
                                 f"predicts {predicted}")
        if sum(report["faults_fired"].values()) != len(plan.events):
            raise AssertionError(f"survival: fired {report['faults_fired']}")
        if report["rollback_steps"] != [5]:
            raise AssertionError(f"survival: rolled back to "
                                 f"{report['rollback_steps']}")
        if result["stats"]["training_state"] != "completed":
            raise AssertionError(f"survival: {result['stats']}")
        losses = [e["train_loss"] for e in result["epochs"]]
        if not math.isfinite(losses[-1]) or not losses[-1] < losses[0]:
            raise AssertionError(f"survival: epoch losses {losses}")
        # Every accepted step ran once; each bad step once and once a
        # retry; a preemption raises before its step runs.
        executions = len(tr.batch_history) + report["bad_steps"] * (
            1 + DRILL_RETRIES)
        want = flash_b1_launches(cfg, executions, True)
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"survival: {name} launched "
                                     f"{launches[name]} times, design says "
                                     f"{n}")
            entries[name]["launches_survival"] = n
        drill_timings = io_rates(tr.checkpointer.timings)
        ckpt_bytes = next(t["bytes"] for t in drill_timings
                          if t["op"] == "save")
        del tr, sup
        torch.cuda.empty_cache()

        # The newest checkpoint rots: a fresh trainer lands on the prior
        # verified step, with params bit-equal to that step's files.
        fresh = trainer()
        mgr = fresh.checkpointer
        mgr.timings.clear()
        latest = mgr.latest_step()
        corrupt_file(_largest_file(mgr.path_for(latest)))
        fresh.load_checkpoint()
        prior = fresh.global_step
        if prior != mgr.latest_step() or not prior < latest:
            raise AssertionError(f"survival: restored step {prior}, latest "
                                 f"was {latest}")
        saved = torch.load(os.path.join(mgr.path_for(prior), "params.pt"),
                           weights_only=True)
        live = {"/".join(k): v
                for k, v in _leaves(fresh.state.params, ("params",))}
        if saved.keys() != live.keys() or not all(
                torch.equal(saved[k].to(v.device), v)
                for k, v in live.items()):
            raise AssertionError("survival: restored params differ from "
                                 "the checkpoint's tensors")
        batch = next(iter(loader))
        per_node = []
        for _ in range(2):
            fresh.load_checkpoint(prior)
            per_node.append(fresh.train_step(batch, 0)["per_node_loss"])
        if per_node[0] != per_node[1] or not all(
                math.isfinite(x) for x in per_node[0]):
            raise AssertionError(f"survival: restored steps {per_node}")
        restore_timings = io_rates(mgr.timings)
        emit({"phase": "survival", "card": card,
              "seconds": time.perf_counter() - t0, "drill_s": drill_s,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
              "seq_len": TRAIN_T, "report": report, "predicted": predicted,
              "epoch_losses": losses, "step_executions": executions,
              "launches": launches, "expected_launches": want,
              "checkpoint_bytes": ckpt_bytes,
              "param_leaves": len(tree_leaves(fresh.state.params)),
              "drill_io": drill_timings,
              "corrupted_step": latest, "restored_step": prior,
              "restored_per_node_loss": per_node[0],
              "restore_io": restore_timings})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def record_status(tr):
    """Wrap ``tr._record_batch`` so that every recorded step's node
    statuses land in the returned list (the records do not keep them)."""
    statuses = []
    record = tr._record_batch

    def wrapped(host, epoch, step_s=None):
        statuses.append(host["status"].tolist())
        return record(host, epoch, step_s)

    tr._record_batch = wrapped
    return statuses


def step_launches(cfg, nodes_per_step, remat=True):
    """B1-B3 launches of step executions with the given node counts."""
    return {"flash_attention_fwd": (2 if remat else 1) * cfg.n_layer
            * sum(nodes_per_step),
            "flash_attention_bwd_dq": cfg.n_layer * sum(nodes_per_step),
            "flash_attention_bwd_dkv": cfg.n_layer * sum(nodes_per_step),
            "fused_moments": 2 * len(nodes_per_step)}


def expect_launches_equal(launches, want, what):
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{what}: {name} launched {launches[name]} "
                                 f"times, design says {n}")


def async_host_drive(torch, entries, card):
    """Phase 9: the async host pipeline at depth 2 against depth 0 on the
    train geometry (runs in turns, bit-equal trajectories, busy shares),
    then a GRAD_NAN drill inside the in-flight window."""
    import dataclasses

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
        FaultKind, FaultPlan
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
    from trustworthy_dl_tpu_torch.engine.supervisor import \
        TrainingSupervisor
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.utils.train_profile import BUSY_STEPS, \
        busy_window

    cfg = gpt2_small(torch)
    t0 = time.perf_counter()
    tr = DistributedTrainer(TrainingConfig(
        model_name="gpt2", batch_size=TRAIN_BATCH, num_nodes=TRAIN_NODES,
        optimizer="adamw", learning_rate=1e-4, remat=True, seed=0,
        detector_warmup=2), model_overrides=dict(
            seq_len=TRAIN_T, attn_impl="auto"), device="cuda")
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=ASYNC_ATTACK))
    attacker.activate_attacks()

    def run(depth, steps):
        tr.config = dataclasses.replace(tr.config, async_host_depth=depth)
        tr.reset_for_run(0)
        tr.set_attack_plan(attacker.plan(TRAIN_NODES))
        return get_dataloader("openwebtext", batch_size=TRAIN_BATCH,
                              seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                              num_examples=TRAIN_BATCH * steps, seed=0)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runs = []
    for depth in ASYNC_ORDER:
        loader = run(depth, ASYNC_STEPS)
        statuses = record_status(tr)
        tr.train_epoch(loader, 0)
        del tr._record_batch
        hist = tr.batch_history
        runs.append({
            "depth": depth,
            "step_ms": [1e3 * h["step_s"] for h in hist[ASYNC_WARMUP:]],
            "trajectory": {
                "loss": [h["loss"] for h in hist],
                "per_node_loss": [h["per_node_loss"] for h in hist],
                "trust": [h["trust_scores"] for h in hist],
                "weights": [h["weights"] for h in hist],
                "status": statuses,
                "incidents": [(r["node_id"], r["step"], r["attack_type"])
                              for r in tr.attack_history]}})
    busy = {}
    for depth in (0, 2):
        busy[depth] = busy_window(tr, run(depth, BUSY_STEPS))
    launches = ops.launch_counts()
    executed = len(ASYNC_ORDER) * ASYNC_STEPS + 2 * BUSY_STEPS
    want = step_launches(cfg, [TRAIN_NODES] * executed)
    expect_launches_equal(launches, want, "async_host")
    ref = runs[0]["trajectory"]
    if not ref["incidents"] or any(r["trajectory"] != ref for r in runs):
        raise AssertionError("async_host: trajectories differ between "
                             "depth 0 and depth 2 (or no incident): "
                             f"{[r['trajectory'] for r in runs]}")
    if not all(math.isfinite(x) for x in ref["loss"]):
        raise AssertionError(f"async_host: losses {ref['loss']}")
    arm_ms = {d: [ms for r in runs if r["depth"] == d for ms in r["step_ms"]]
              for d in (0, 2)}

    # GRAD_NAN inside the window at depth 2: the lagged guard runs no
    # retry and rolls back to the checkpoint before the window.
    ckpt_dir = tempfile.mkdtemp(prefix="tddl_async_drill_")
    try:
        tr.config = dataclasses.replace(
            tr.config, async_host_depth=2, checkpoint_interval=NAN_INTERVAL,
            checkpoint_dir=ckpt_dir)
        tr.checkpointer = CheckpointManager(ckpt_dir)
        tr.reset_for_run(0)
        plan = FaultPlan.scripted([FaultEvent(step=NAN_STEP,
                                              kind=FaultKind.GRAD_NAN)])
        sup = TrainingSupervisor(tr, max_retries=DRILL_RETRIES,
                                 rollback_after=1, max_restarts=0,
                                 chaos=FaultInjector(plan))
        loader = get_dataloader("openwebtext", batch_size=TRAIN_BATCH,
                                seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                                num_examples=TRAIN_BATCH * NAN_STEPS, seed=2)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_drill = time.perf_counter()
        result = sup.run(loader, num_epochs=1)
        torch.cuda.synchronize()
        drill_s = time.perf_counter() - t_drill
        drill_launches = ops.launch_counts()
        report = result["supervisor"]
        # The bad step NAN_STEP + 1 drains when NAN_STEP + 3 is pushed (the
        # window holds 2); it rolls back to the save at NAN_INTERVAL, and
        # the two steps in flight are discarded.
        lagged = {"retries": 0, "rollbacks": 1,
                  "rollback_steps": [NAN_INTERVAL], "restarts": 0,
                  "preemptions": 0, "bad_steps": 1}
        accounted = [h["step"] for h in tr.batch_history]
        if {k: report[k] for k in lagged} != lagged or \
                report["faults_fired"] != {"grad_nan": 1} or \
                accounted != list(range(1, NAN_STEP + 1)) or \
                tr.global_step != NAN_INTERVAL:
            raise AssertionError(f"async_host drill: report {report}, "
                                 f"accounted steps {accounted}, global "
                                 f"step {tr.global_step}; the lagged "
                                 f"arithmetic says {lagged}")
        expect_launches_equal(drill_launches,
                              step_launches(cfg, [TRAIN_NODES] * NAN_STEPS),
                              "async_host drill")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for name in want:
        entries[name]["launches_async_host"] = want[name]
    emit({"phase": "async_host", "card": card,
          "seconds": time.perf_counter() - t0,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                   "weights, random init seed 0)",
          "nodes": TRAIN_NODES, "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
          "order": list(ASYNC_ORDER),
          "step_ms_median": {d: statistics.median(v)
                             for d, v in arm_ms.items()},
          "step_ms": {d: v for d, v in arm_ms.items()},
          "depth2_over_depth0": statistics.median(arm_ms[2])
          / statistics.median(arm_ms[0]),
          "busy": busy, "trajectories_bit_equal": True,
          "incidents": ref["incidents"], "launches": launches,
          "expected_launches": want, "drill_report": report,
          "drill_lagged_arithmetic": lagged, "drill_s": drill_s,
          "drill_accounted_steps": accounted,
          "drill_launches": drill_launches})
    del tr, sup
    torch.cuda.empty_cache()


def elastic_drive(torch, entries, card):
    """Phase 10: eviction of a poisoned node, a save and a resume onto
    the 3-node topology, and readmission on probation after the
    cool-off."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    cfg = gpt2_small(torch)
    ckpt_dir = tempfile.mkdtemp(prefix="tddl_elastic_")
    t0 = time.perf_counter()

    def trainer():
        tr = DistributedTrainer(TrainingConfig(
            model_name="gpt2", batch_size=TRAIN_BATCH,
            num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
            remat=True, seed=0, detector_warmup=4, elastic_resharding=True,
            readmit_after_steps=ELASTIC_READMIT, checkpoint_interval=10 ** 6,
            checkpoint_dir=ckpt_dir), model_overrides=dict(
                seq_len=TRAIN_T, attn_impl="auto"), device="cuda")
        tr.initialize()
        return tr

    try:
        tr = trainer()
        attacker = AdversarialAttacker(AttackConfig(
            attack_types=["gradient_poisoning"], target_nodes=[2],
            intensity=1.0, start_step=ELASTIC_ATTACK))
        attacker.activate_attacks()
        tr.set_attack_plan(attacker.plan(TRAIN_NODES))
        per_node = TRAIN_BATCH // TRAIN_NODES
        loader = get_dataloader(
            "openwebtext", batch_size=TRAIN_BATCH, seq_len=TRAIN_T,
            vocab_size=cfg.vocab_size,
            num_examples=TRAIN_BATCH * ELASTIC_STEPS[0], seed=0)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        tr.train_epoch(loader, 0)
        hist = list(tr.batch_history)
        incident = ELASTIC_ATTACK + 2      # the second attacked step
        evict_step = incident + 2          # drained two steps later
        evictions = [r for r in tr.reassignment_history
                     if "evicted_nodes" in r]
        if [(r["node_id"], r["step"]) for r in tr.attack_history] != \
                [(2, incident)] or len(evictions) != 1 or \
                evictions[0]["step"] != evict_step or \
                evictions[0]["evicted_nodes"] != [2] or \
                not evictions[0]["migration_time_s"] > 0 or \
                not evictions[0]["measured_gbps"] > 0:
            raise AssertionError(f"elastic: incidents {tr.attack_history}, "
                                 f"records {tr.reassignment_history}")
        if loader.batch_size != 3 * per_node or \
                tr.config.batch_size != 3 * per_node or \
                tr.node_map != [0, 1, 3]:
            raise AssertionError(f"elastic: loader {loader.batch_size}, "
                                 f"config {tr.config.batch_size}, node map "
                                 f"{tr.node_map}")
        saved_step = tr.global_step
        t_save = time.perf_counter()
        tr.save_checkpoint()
        save_s = time.perf_counter() - t_save
        eviction = dict(evictions[0])
        del tr
        torch.cuda.empty_cache()

        # A fresh process's trainer, built for 4 nodes, resumes onto the
        # saved 3-node topology with the pending cool-off.
        resumed = trainer()
        t_load = time.perf_counter()
        resumed.load_checkpoint()
        load_s = time.perf_counter() - t_load
        if resumed.config.num_nodes != 3 or resumed.node_map != [0, 1, 3] \
                or resumed._evicted_at != {2: evict_step} or \
                resumed.global_step != saved_step:
            raise AssertionError(
                f"elastic resume: {resumed.config.num_nodes} nodes, map "
                f"{resumed.node_map}, evicted {resumed._evicted_at}, step "
                f"{resumed.global_step}")
        resumed.set_attack_plan(null_plan(3, "cuda"))
        loader2 = get_dataloader(
            "openwebtext", batch_size=3 * per_node, seq_len=TRAIN_T,
            vocab_size=cfg.vocab_size,
            num_examples=3 * per_node * ELASTIC_STEPS[1], seed=1)
        resumed.train_epoch(loader2, 1)
        launches = ops.launch_counts()
        hist += resumed.batch_history
        readmits = [r for r in resumed.reassignment_history
                    if "readmitted_nodes" in r]
        readmit_step = evict_step + ELASTIC_READMIT
        coord = resumed.node_map.index(2) if 2 in resumed.node_map else -1
        trust = resumed.state.trust
        if len(readmits) != 1 or readmits[0]["step"] != readmit_step or \
                resumed.node_map != [0, 1, 3, 2] or \
                float(trust.recovery_rate[coord]) != \
                float(torch.tensor(0.02)) or \
                loader2.batch_size != TRAIN_BATCH or \
                not int(resumed.state.out_baseline.count[coord]) < \
                int(resumed.state.out_baseline.count[0]):
            raise AssertionError(
                f"elastic readmission: records {readmits}, node map "
                f"{resumed.node_map}, recovery "
                f"{trust.recovery_rate.tolist()}, loader "
                f"{loader2.batch_size}")
        nodes = [len(h["per_node_loss"]) for h in hist]
        steps = [h["step"] for h in hist]
        want_nodes = [TRAIN_NODES if s <= evict_step or s > readmit_step
                      else 3 for s in steps]
        losses = [h["loss"] for h in hist]
        if nodes != want_nodes or not all(math.isfinite(x)
                                          for x in losses):
            raise AssertionError(f"elastic: nodes a step {nodes} (want "
                                 f"{want_nodes}), losses {losses}")
        want = step_launches(cfg, nodes)
        expect_launches_equal(launches, want, "elastic")
        for name in want:
            entries[name]["launches_elastic"] = want[name]
        emit({"phase": "elastic", "card": card,
              "seconds": time.perf_counter() - t0,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "rows_per_node": per_node, "seq_len": TRAIN_T,
              "attack_start_step": ELASTIC_ATTACK, "incident_step": incident,
              "eviction": {k: v for k, v in eviction.items()
                           if k != "timestamp"},
              "readmission": {k: v for k, v in readmits[0].items()
                              if k != "timestamp"},
              "save_s": save_s, "resume_load_s": load_s,
              "resumed_at_step": saved_step,
              "nodes_per_step": nodes, "steps": steps,
              "step_ms": [1e3 * h["step_s"] for h in hist],
              "losses": losses, "launches": launches,
              "expected_launches": want,
              "readmitted_recovery_rate": float(trust.recovery_rate[coord]),
              "readmitted_status": int(trust.status[coord])})
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def pipeline_kernel_cases(torch, entries, flush):
    """B1, B2 and B3 against their plain twins at the pipeline phase's
    shapes (``pipeline_case`` in each entry): B2 and B3 at one
    microbatch's attention [2 x 12, 1024, 64] bf16, B1 over the 48
    segments of the four stages' block-gradient leaves."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.parallel.pipeline import stack_stages
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    cfg = gpt2_small(torch)
    blocks = stack_stages(gpt2.init_params(cfg, gen, device=dev)["blocks"],
                          PIPE_STAGES)
    grads = [torch.randn(x.shape, device=dev, generator=gen) * 1e-3
             for x in tree_leaves(blocks)]
    del blocks
    segs = [g[s].reshape(-1) for s in range(PIPE_STAGES) for g in grads]
    entries["fused_moments"]["pipeline_case"] = {
        "segments": len(segs), "elements": sum(x.numel() for x in segs),
        **moments_case(torch, segs, flush)}
    del grads, segs

    bh = cfg.n_head * PIPE_BATCH // PIPE_MICRO
    cases = flash_case(torch, bh, TRAIN_T, cfg.head_dim, True, flush, gen,
                       "pipeline")
    for name, case in cases.items():
        entries[name]["pipeline_case"] = case


def pipeline_schedule_check(torch, tr, batch):
    """The pipelined loss and every block gradient against the sequential
    forward over the unstacked blocks, on the trainer's params and one
    batch: JAX's test tolerance."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.parallel import pipeline as pipe
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, \
        tree_unflatten

    cfg = tr.model.config
    fn = pipe.build_pipeline_apply(cfg, tr.mesh, PIPE_STAGES, PIPE_MICRO)
    stacked = tr.state.params
    flat = dict(stacked, blocks=pipe.unstack_stages(stacked["blocks"]))
    tokens, targets = batch["input"], batch["target"]

    def grads(params, forward):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params["blocks"])]
        p = dict(params, blocks=tree_unflatten(params["blocks"], leaves))
        y = forward(p)
        loss, _ = gpt2.head_loss_and_signature(p, y, targets, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def piped(p):
        x = gpt2.embed(p, tokens)
        b, t, d = x.shape
        y = fn(p["blocks"], x.reshape(PIPE_MICRO, b // PIPE_MICRO, t, d))[0]
        return y.reshape(b, t, d)

    loss, got = grads(stacked, piped)
    seq_loss, want = grads(flat, lambda p: gpt2.apply_blocks(
        p["blocks"], gpt2.embed(p, tokens), cfg))
    worst = 0.0
    for g, w in zip(got, want):
        g = g.reshape(w.shape).float()
        err = (g - w.float()).abs()
        if not bool((err <= PIPE_ATOL + PIPE_RTOL * w.float().abs()).all()):
            raise AssertionError(f"pipeline schedule: a block gradient off "
                                 f"by {float(err.max())}")
        worst = max(worst, float(err.max()))
    loss_err = abs(float(loss) - float(seq_loss))
    if not loss_err <= PIPE_ATOL + PIPE_RTOL * abs(float(seq_loss)):
        raise AssertionError(f"pipeline schedule: loss {float(loss)} vs "
                             f"sequential {float(seq_loss)}")
    return {"loss": float(loss), "sequential_loss": float(seq_loss),
            "loss_abs_err": loss_err, "grad_max_abs_err": worst,
            "rtol": PIPE_RTOL, "atol": PIPE_ATOL}


def pipeline_want(steps):
    """B1-B3 launches of ``steps`` pipeline steps: M x L stage-layer
    applications a step (any stage count), each one B2 in the forward
    and one dq and one dk/dv of B3 in the backward (no remat), and one B1
    over every stage's block leaves (at most 48 segments)."""
    n = PIPE_MICRO * GPT2_SMALL["n_layer"] * steps
    return {"flash_attention_fwd": n, "flash_attention_bwd_dq": n,
            "flash_attention_bwd_dkv": n, "fused_moments": steps}


def pipeline_drive(torch, entries, card):
    """Phase 10b: pipeline (stage) parallelism on GPT-2 small through
    ``DistributedTrainer(parallelism="model")``: the schedule against the
    sequential forward, a trusted run with a restaff 4 -> 3 and the
    regrowth 3 -> 4, a checkpoint of the restaffed pipeline resumed, the
    canary against Byzantine compute, exact B1-B3 launches, B1-B3 at the
    pipeline's shapes, and the schedule study."""
    import itertools

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.experiments.pipeline_study import \
        render_study, run_pipeline_study
    from trustworthy_dl_tpu_torch.parallel.pipeline import unstack_stages
    from trustworthy_dl_tpu_torch.utils.train_profile import busy_window
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    cfg = gpt2_small(torch)
    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    tmp = tempfile.mkdtemp(prefix="tddl_pipeline_")
    t0 = time.perf_counter()
    parts = {}

    def trainer(elastic):
        tr = DistributedTrainer(TrainingConfig(
            model_name="gpt2", batch_size=PIPE_BATCH, num_nodes=PIPE_STAGES,
            parallelism="model", num_microbatches=PIPE_MICRO,
            optimizer="adamw", learning_rate=1e-4, seed=0,
            detector_warmup=4, elastic_resharding=elastic,
            readmit_after_steps=PIPE_READMIT if elastic else 0,
            checkpoint_interval=10 ** 6, checkpoint_dir=tmp),
            model_overrides=dict(seq_len=TRAIN_T, attn_impl="auto"),
            device="cuda")
        tr.initialize()
        return tr

    def loader(steps, seed):
        return get_dataloader("openwebtext", batch_size=PIPE_BATCH,
                              seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                              num_examples=PIPE_BATCH * steps, seed=seed)

    def blocks_of(tr):
        return [x.detach().clone() for x in tree_leaves(
            unstack_stages(tr.state.params["blocks"]))]

    try:
        # 1. The schedule against the sequential forward.
        tr = trainer(True)
        t1 = time.perf_counter()
        schedule = pipeline_schedule_check(
            torch, tr, tr._node_batch(next(iter(loader(1, 9)))))
        parts["schedule_s"] = time.perf_counter() - t1

        # 2. The trusted run: restaff 4 -> 3, regrowth 3 -> 4.
        attacker = AdversarialAttacker(AttackConfig(
            attack_types=["gradient_poisoning"], target_nodes=[2],
            intensity=1.0, start_step=PIPE_ATTACK))
        attacker.activate_attacks()
        tr.set_attack_plan(attacker.plan(PIPE_STAGES, "cuda"))
        run_loader = loader(max(PIPE_EPOCHS), 0)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        tr.train_epoch(itertools.islice(iter(run_loader), PIPE_EPOCHS[0]),
                       0)
        restaffed = blocks_of(tr)
        saved_step, saved_map = tr.global_step, list(tr.node_map)
        t_save = time.perf_counter()
        tr.save_checkpoint()
        save_s = time.perf_counter() - t_save
        tr.set_attack_plan(null_plan(tr.config.num_nodes, "cuda"))
        tr.train_epoch(itertools.islice(iter(run_loader), PIPE_EPOCHS[1]),
                       1)
        torch.cuda.synchronize()
        parts["trusted_run_s"] = time.perf_counter() - t1 - save_s
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() - resident
        hist = list(tr.batch_history)
        steps = [h["step"] for h in hist]
        losses = [h["loss"] for h in hist]
        incident = PIPE_ATTACK + 2          # the second attacked step
        restaff_step = incident + 2         # drained two steps later
        regrow_step = restaff_step + PIPE_READMIT
        records = [{k: v for k, v in r.items() if k != "timestamp"}
                   for r in tr.reassignment_history]
        stages = [len(h["trust_scores"]) for h in hist]
        want_stages = [PIPE_STAGES if s <= restaff_step or s > regrow_step
                       else PIPE_STAGES - 1 for s in steps]
        if [(r["node_id"], r["step"], r["attack_type"])
                for r in tr.attack_history] != \
                [(2, incident, "gradient_poisoning")] or \
                [(r["step"], r["evicted_nodes"], r["old_num_stages"],
                  r["new_num_stages"]) for r in records] != \
                [(restaff_step, [2], 4, 3), (regrow_step, [], 3, 4)] or \
                saved_map != [0, 1, 3] or tr.node_map != [0, 1, 2, 3] or \
                tr._idle_pool or stages != want_stages or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(
                f"pipeline: incidents {tr.attack_history}, records "
                f"{records}, stages {stages} (want {want_stages}), map "
                f"{saved_map} -> {tr.node_map}, losses {losses}")
        for s, h in enumerate(hist):
            if steps[s] > PIPE_ATTACK and steps[s] <= restaff_step and \
                    h["weights"][2] != 0:
                raise AssertionError(f"pipeline: stage 2 not gated at step "
                                     f"{steps[s]}: {h}")
            if any(h["attacked"][i] for i in range(len(h["attacked"]))
                   if not (i == 2 and steps[s] <= restaff_step)):
                raise AssertionError(f"pipeline: a clean stage flagged at "
                                     f"step {steps[s]}: {h}")
        moved = [float((a - b).float().norm()) for a, b in
                 zip(blocks_of(tr), restaffed)]
        per_layer = [((a - b).float().reshape(a.shape[0], -1).norm(dim=1)
                      > 0).all().item()
                     for a, b in zip(blocks_of(tr), restaffed)]
        before = hist[steps.index(restaff_step)]["trust_scores"]
        after = hist[steps.index(restaff_step + 1)]["trust_scores"]
        if not all(per_layer) or any(
                abs(after[n] - before[n]) > 0.05 or after[n] <= 0.5
                for n in (0, 1, 3)):
            raise AssertionError(f"pipeline: layers moved {per_layer}, "
                                 f"trust {before} -> {after}")
        want = pipeline_want(len(hist))
        expect_launches_equal(launches, want, "pipeline")
        for name in want:
            entries[name]["launches_pipeline"] = want[name]
        step_ms = [1e3 * h["step_s"] for h in hist[2:]
                   if h["step_s"] is not None]

        # 4. The restaffed checkpoint, restored by a fresh trainer: the
        # next step equals the running trainer's.
        tr.cleanup()
        del tr
        torch.cuda.empty_cache()
        fresh = trainer(True)
        t_load = time.perf_counter()
        fresh.load_checkpoint(saved_step)
        load_s = time.perf_counter() - t_load
        if fresh.config.num_nodes != 3 or fresh.node_map != saved_map or \
                fresh._evicted_at != {2: restaff_step}:
            raise AssertionError(f"pipeline resume: {fresh.config.num_nodes}"
                                 f" stages, map {fresh.node_map}, evicted "
                                 f"{fresh._evicted_at}")
        fresh.set_attack_plan(null_plan(3, "cuda"))
        resume_loader = loader(max(PIPE_EPOCHS), 0)
        for _ in resume_loader:     # the running trainer's epoch 0
            pass
        record = fresh.train_step(next(iter(resume_loader)), 1)
        running = hist[steps.index(saved_step + 1)]["loss"]
        if abs(record["loss"] - running) > 1e-6:
            raise AssertionError(f"pipeline resume: next loss "
                                 f"{record['loss']} vs running {running}")
        resume = {"save_s": save_s, "load_s": load_s,
                  "saved_step": saved_step, "next_loss": record["loss"],
                  "running_loss": running}
        del fresh
        torch.cuda.empty_cache()

        # 3. The canary against Byzantine compute on stage 1, after a
        # clean epoch whose steps 3-4 are the busy window.
        tr = trainer(False)
        busy = busy_window(tr, loader(PIPE_BUSY_STEPS, 3),
                           first=PIPE_BUSY_FIRST, last=PIPE_BUSY_LAST)
        onset = tr.global_step
        byz = AdversarialAttacker(AttackConfig(
            attack_types=["byzantine"], target_nodes=[1], intensity=0.5,
            start_step=onset))
        byz.activate_attacks()
        tr.set_attack_plan(byz.plan(PIPE_STAGES, "cuda"))
        ops.reset_launch_counts()
        tr.train_epoch(loader(PIPE_BYZ_STEPS, 4), 1)
        byz_launches = ops.launch_counts()
        byz_hist = tr.batch_history[-PIPE_BYZ_STEPS:]
        if [(r["node_id"], r["step"], r["attack_type"])
                for r in tr.attack_history] != [(1, onset + 1, "byzantine")] \
                or not all(h["attacked"][1] for h in byz_hist) or any(
                    h["attacked"][i] for h in tr.batch_history
                    for i in (0, 2, 3)) or not all(
                    math.isfinite(h["loss"]) for h in tr.batch_history):
            raise AssertionError(f"pipeline byzantine: incidents "
                                 f"{tr.attack_history}, attacked "
                                 f"{[h['attacked'] for h in byz_hist]}")
        expect_launches_equal(byz_launches, pipeline_want(PIPE_BYZ_STEPS),
                              "pipeline byzantine")
        del tr
        torch.cuda.empty_cache()

        # 5. B1-B3 at the pipeline's shapes.
        t1 = time.perf_counter()
        pipeline_kernel_cases(torch, entries, flush)
        parts["kernel_cases_s"] = time.perf_counter() - t1

        # 6. The schedule study.
        t1 = time.perf_counter()
        study = run_pipeline_study(
            output_dir=os.path.join(tmp, "study"),
            stage_counts=(PIPE_STAGES,), microbatches=PIPE_STUDY_MICRO,
            batch=PIPE_STUDY_BATCH, steps=PIPE_STUDY_STEPS,
            model_overrides=dict(n_embd=cfg.n_embd, n_head=cfg.n_head,
                                 vocab_size=cfg.vocab_size,
                                 n_positions=cfg.n_positions,
                                 seq_len=TRAIN_T),
            device="cuda")
        parts["study_s"] = time.perf_counter() - t1
        if [c["num_microbatches"] for c in study["cells"]] != \
                list(PIPE_STUDY_MICRO) or not all(
                    c["step_time_s"] > 0 and c["temp_bytes"] > 0
                    for c in study["cells"]):
            raise AssertionError(f"pipeline study: {study['cells']}")
        emit({"phase": "pipeline", "card": card,
              "seconds": time.perf_counter() - t0, "parts_s": parts,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
              "batch": PIPE_BATCH, "seq_len": TRAIN_T,
              "schedule": schedule,
              "step_ms_median": statistics.median(step_ms),
              "step_ms": step_ms, "busy": busy,
              "enqueue_ms_median": busy["enqueue_ms_median"],
              "busy_share": busy["busy_share"],
              "peak_memory_bytes": peak, "resident_before_bytes": resident,
              "losses": losses, "stages_per_step": stages,
              "incidents": [(2, incident, "gradient_poisoning")],
              "restaff": records, "layers_moved_norm": moved,
              "resume": resume, "launches": launches,
              "expected_launches": want,
              "byzantine": {"onset_step": onset + 1,
                            "launches": byz_launches},
              "study": {"cells": study["cells"],
                        "table": render_study(study).splitlines()}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sequence_kernel_cases(torch, entries, flush):
    """B2 and B3's non-causal instances against their plain twins at
    ``SEQ_CASES`` (D = 64, bf16), timed beside their bounds, the twins and
    SDPA with ``is_causal=False`` (``sequence_case`` in each entry), and
    ``flash_chunk``'s backward under a nonzero lse cotangent at the ring's
    chunk against the twins given Delta - dlse."""
    from trustworthy_dl_tpu_torch.ops import flash_attention as fa

    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(26)
    d = GPT2_SMALL["n_embd"] // GPT2_SMALL["n_head"]
    for name, *_ in FLASH_KERNELS:
        entries[name]["sequence_case"] = []
    for bh, t in SEQ_CASES:
        for name, case in flash_case(torch, bh, t, d, False, flush, gen,
                                     f"sequence {bh}x{t}").items():
            entries[name]["sequence_case"].append(case)

    def err(a, b, what):
        e = (a.float() - b.float()).abs()
        if not bool((e <= ATTN_ATOL + ATTN_RTOL * b.float().abs()).all()):
            raise AssertionError(f"sequence: {what} disagrees with plain "
                                 f"(max abs err {float(e.max())})")
        return float(e.max())

    # flash_chunk's backward with an lse cotangent, at the ring's chunk.
    bh, t = SEQ_CASES[0]
    q, k, v, do = (torch.randn(bh, t, d, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(4))
    dlse = 0.5 * torch.randn(bh, t, device=dev, generator=gen)
    chunk = {}
    for causal in (True, False):
        args = [a.clone().requires_grad_() for a in (q, k, v)]
        o, lse = fa.flash_chunk(*args, causal)
        grads = torch.autograd.grad((o, lse), args, (do, dlse))
        delta = (do.float() * o.detach().float()).sum(-1) - dlse
        lse = lse.detach()
        refs = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
                *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
        chunk["causal" if causal else "full"] = max(
            err(g, r, f"flash_chunk causal={causal} grad")
            for g, r in zip(grads, refs))
    return {"flash_chunk_dlse_grad_max_abs_err": chunk,
            "bhtd": [bh, t, d]}


def ring_attention_check(torch):
    """Ring attention over SEQ_RING positions of the card at
    SEQ_ATTN_SHAPE bf16, forward and gradients, against f32 full
    attention beside the data-mode flash attention's error on the same
    inputs; its launches; Ulysses against the model's full attention."""
    import numpy as np

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core.mesh import SEQ_AXIS, Mesh
    from trustworthy_dl_tpu_torch.models.gpt2 import full_attention
    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.parallel import sequence as seq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    qkv = [torch.randn(*SEQ_ATTN_SHAPE, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(3)]
    g = torch.randn(*SEQ_ATTN_SHAPE, device=dev, generator=gen).to(
        torch.bfloat16)
    ref_in = [a.float().requires_grad_() for a in qkv]
    ref = full_attention(*ref_in, True)
    refs = [ref.detach(), *torch.autograd.grad(ref, ref_in, g.float())]
    del ref, ref_in
    mesh = Mesh(np.array([dev] * SEQ_RING, dtype=object), (SEQ_AXIS,))

    def errors(fn):
        args = [a.clone().requires_grad_() for a in qkv]
        out = fn(*args)
        got = [out.detach(), *torch.autograd.grad(out, args, g)]
        return [float((a.float() - b).abs().max()) for a, b in
                zip(got, refs)]

    flash_err = errors(lambda q, k, v: fa.flash_attention(q, k, v))
    ops.reset_launch_counts()
    with seq.use_sequence_mesh(mesh):
        ring_err = errors(lambda q, k, v: seq.ring_attention(q, k, v, True))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    causal_calls = SEQ_RING
    full_calls = SEQ_RING * (SEQ_RING - 1) // 2
    for name in names:
        got = (launches[name], launches[f"{name}_full"])
        if got != (causal_calls + full_calls, full_calls):
            raise AssertionError(f"sequence ring: {name} launched {got} "
                                 f"(all, non-causal), design says "
                                 f"{(causal_calls + full_calls, full_calls)}")
    labels = ("out", "dq", "dk", "dv")
    for label, r, f in zip(labels, ring_err, flash_err):
        if not r <= SEQ_ERR_RATIO * f:
            raise AssertionError(f"sequence ring: {label} error {r} against "
                                 f"f32 full attention, over {SEQ_ERR_RATIO}"
                                 f" x data mode's {f}")
    with seq.use_sequence_mesh(mesh):
        uly = seq.ulysses_attention(*qkv, True)
    full = full_attention(*qkv, True)
    uly_err = float((uly.float() - full.float()).abs().max())
    if not bool(((uly.float() - full.float()).abs()
                 <= ATTN_ATOL + ATTN_RTOL * full.float().abs()).all()):
        raise AssertionError(f"sequence ulysses: off full attention by "
                             f"{uly_err}")
    return {"shape": list(SEQ_ATTN_SHAPE), "positions": SEQ_RING,
            "ring_err_vs_f32": dict(zip(labels, ring_err)),
            "flash_err_vs_f32": dict(zip(labels, flash_err)),
            "err_ratio_limit": SEQ_ERR_RATIO,
            "launches": {n: [launches[n], launches[f"{n}_full"]]
                         for n in names},
            "ulysses_max_abs_vs_full": uly_err}


def sequence_want(steps, nodes=TRAIN_NODES, ring=SEQ_RING):
    """B1-B3 launches of ``steps`` sequence-mode steps (no remat): per
    layer a node-step, a causal ring of ``ring`` makes ring causal and
    ring (ring - 1) / 2 non-causal chunk launches of B2 in the forward and
    of dq and dk/dv in the backward; two B1 a step (gradients, features).
    The ``_full`` counts are the non-causal share."""
    layers = GPT2_SMALL["n_layer"] * nodes * steps
    full = ring * (ring - 1) // 2
    want = {"fused_moments": 2 * steps}
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        want[name] = (ring + full) * layers
        want[f"{name}_full"] = full * layers
    return want


def sequence_drive(torch, entries, card):
    """Phase 10c: sequence parallelism (module docstring): the non-causal
    kernel cases, ring and Ulysses attention on the card, GPT-2 small
    through ``DistributedTrainer(parallelism="sequence")`` on a (4, 4)
    mesh under gradient poisoning beside data mode, and ``cli train
    --parallelism sequence``."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.core.mesh import build_mesh
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.parallel import sequence as seq
    from trustworthy_dl_tpu_torch.utils.train_profile import busy_window

    cfg = gpt2_small(torch)
    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    tmp = tempfile.mkdtemp(prefix="tddl_sequence_")
    t0 = time.perf_counter()
    parts = {}
    try:
        t1 = time.perf_counter()
        chunk = sequence_kernel_cases(torch, entries, flush)
        parts["kernel_cases_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        ring = ring_attention_check(torch)
        parts["ring_s"] = time.perf_counter() - t1
        del flush
        torch.cuda.empty_cache()

        def make(parallelism):
            """A trainer of ``parallelism`` under the attack, and its
            loader (the same batches for every arm)."""
            mesh = build_mesh(TRAIN_NODES, "sequence",
                              devices=["cuda"] * (TRAIN_NODES * SEQ_RING)) \
                if parallelism == "sequence" else None
            tr = DistributedTrainer(TrainingConfig(
                model_name="gpt2", batch_size=TRAIN_BATCH,
                num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
                seed=0, detector_warmup=4, parallelism=parallelism,
                checkpoint_interval=10 ** 6, checkpoint_dir=tmp),
                mesh=mesh, model_overrides=dict(seq_len=TRAIN_T),
                device="cuda")
            tr.initialize()
            attacker = AdversarialAttacker(AttackConfig(
                attack_types=["gradient_poisoning"], target_nodes=[2],
                intensity=1.0, start_step=SEQ_ATTACK))
            attacker.activate_attacks()
            tr.set_attack_plan(attacker.plan(TRAIN_NODES, "cuda"))
            loader = get_dataloader(
                "openwebtext", batch_size=TRAIN_BATCH, seq_len=TRAIN_T,
                vocab_size=cfg.vocab_size,
                num_examples=TRAIN_BATCH * SEQ_STEPS, seed=0)
            return tr, loader

        def done(tr):
            tr.cleanup()
            del tr
            gc.collect()
            torch.cuda.empty_cache()

        def run(parallelism):
            tr, loader = make(parallelism)
            gc.collect()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            busy = busy_window(tr, loader, first=SEQ_BUSY_STEP,
                               last=SEQ_BUSY_STEP)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = ops.launch_counts()
            hist = list(tr.batch_history)
            out = {"mesh": dict(tr.mesh.shape),
                   "attn_impl": tr.model.config.attn_impl,
                   "losses": [h["loss"] for h in hist],
                   "step_ms": [1e3 * h["step_s"] for h in hist
                               if h["step_s"] is not None],
                   "busy_share": busy["busy_share"],
                   "enqueue_ms_median": busy["enqueue_ms_median"],
                   "peak_memory_bytes":
                       torch.cuda.max_memory_allocated() - resident,
                   "resident_before_bytes": resident,
                   "run_s": wall, "launches": launches,
                   "incidents": [(r["node_id"], r["step"], r["attack_type"])
                                 for r in tr.attack_history]}
            expect_gating(hist, SEQ_ATTACK, f"sequence ({parallelism})")
            done(tr)
            return out

        def control():
            """The loss gate's control: the ring with its below-diagonal
            chunks dropped (each gives no mass: zero output, lse at the
            merge's NEG_INF), on the same batches; its losses."""
            real = fa.flash_chunk

            def dropped(q, k, v, causal):
                if causal:
                    return real(q, k, v, causal)
                return torch.zeros_like(q), torch.full(
                    q.shape[:2], seq.NEG_INF, device=q.device)

            fa.flash_chunk = dropped
            try:
                tr, loader = make("sequence")
                tr.train_epoch(loader, 0)
                losses = [h["loss"] for h in tr.batch_history]
            finally:
                fa.flash_chunk = real
            done(tr)
            return losses

        t1 = time.perf_counter()
        sp = run("sequence")
        parts["sequence_run_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        dp = run("data")
        parts["data_run_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        ctrl = control()
        parts["control_run_s"] = time.perf_counter() - t1
        if sp["mesh"] != {"data": TRAIN_NODES, "seq": SEQ_RING} or \
                sp["attn_impl"] != "ring" or dp["attn_impl"] != "auto":
            raise AssertionError(f"sequence: mesh {sp['mesh']}, attention "
                                 f"{sp['attn_impl']} / {dp['attn_impl']}")
        want = sequence_want(SEQ_STEPS)
        expect_launches_equal(sp["launches"], want, "sequence trainer")
        data_want = step_launches(cfg, [TRAIN_NODES] * SEQ_STEPS,
                                  remat=False)
        expect_launches_equal(dp["launches"], data_want, "sequence's data "
                                                         "arm")
        if any(dp["launches"][f"{n}_full"] for n in (
                "flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv")):
            raise AssertionError(f"sequence's data arm launched a "
                                 f"non-causal kernel: {dp['launches']}")
        # Every step's loss against data mode's: from step 2 on they read
        # the ring's gradients (flash_chunk's backward, lse cotangent
        # included).  The control, a ring that drops its below-diagonal
        # chunks, must fall outside the limit, or the gate proves nothing.
        gaps = [abs(a - b) / abs(b) for a, b in zip(sp["losses"],
                                                     dp["losses"])]
        ctrl_gaps = [abs(a - b) / abs(b) for a, b in zip(ctrl,
                                                          dp["losses"])]
        if len(gaps) != SEQ_STEPS or len(ctrl_gaps) != SEQ_STEPS or \
                not max(gaps) <= SEQ_LOSS_RTOL or not all(
                    math.isfinite(x) for x in sp["losses"]) or \
                not max(ctrl_gaps) > SEQ_LOSS_RTOL:
            raise AssertionError(
                f"sequence: losses {sp['losses']} vs data mode's "
                f"{dp['losses']}: largest relative gap {max(gaps)}, the "
                f"control's {max(ctrl_gaps)} ({ctrl}); limit "
                f"{SEQ_LOSS_RTOL}")
        incident = [(2, SEQ_ATTACK + 2, "gradient_poisoning")]
        if sp["incidents"] != dp["incidents"] or sp["incidents"] != incident:
            raise AssertionError(f"sequence: incidents {sp['incidents']} vs "
                                 f"data mode's {dp['incidents']}, design "
                                 f"says {incident}")
        for name in want:
            if name in entries:
                entries[name]["launches_sequence"] = want[name]
            elif name.endswith("_full"):
                entries[name[:-5]]["launches_full_sequence"] = want[name]

        # cli train --parallelism sequence: a ring of 1.
        t1 = time.perf_counter()
        seq.set_sequence_mesh(None)
        ops.reset_launch_counts()
        cli_out = []
        run_cli(["train", "--parallelism", "sequence", "--nodes",
                 str(TRAIN_NODES), "--batch-size", str(TRAIN_BATCH),
                 "--seq-len", str(TRAIN_T), "--steps-per-epoch",
                 str(SEQ_CLI_STEPS), "--epochs", "1", "--checkpoint-dir",
                 os.path.join(tmp, "cli")], cli_out)
        cli_launches = ops.launch_counts()
        parts["cli_s"] = time.perf_counter() - t1
        # Data mode at this shape: one causal B2 a layer a node-step and a
        # validation pass (one batch over the nodes); a ring of 1 is one
        # causal flash_chunk a layer, so the same count.
        cli_want = GPT2_SMALL["n_layer"] * TRAIN_NODES * (SEQ_CLI_STEPS + 1)
        if cli_launches["flash_attention_fwd"] != cli_want or \
                cli_launches["flash_attention_fwd_full"] or \
                seq.get_sequence_mesh().shape != {"data": 1, "seq": 1}:
            raise AssertionError(f"sequence cli: launches {cli_launches}, "
                                 f"design says {cli_want} causal B2, mesh "
                                 f"{seq.get_sequence_mesh()}")
        seq.set_sequence_mesh(None)
        emit({"phase": "sequence", "card": card,
              "seconds": time.perf_counter() - t0, "parts_s": parts,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "nodes": TRAIN_NODES, "batch": TRAIN_BATCH, "seq_len": TRAIN_T,
              "ring": SEQ_RING, "flash_chunk": chunk, "ring_attention": ring,
              "sequence": sp, "data": dp, "expected_launches": want,
              "expected_launches_data": data_want,
              "loss_rel_gaps": gaps, "loss_rel_gap_max": max(gaps),
              "control_losses": ctrl, "control_loss_rel_gaps": ctrl_gaps,
              "control_loss_rel_gap_max": max(ctrl_gaps),
              "loss_rtol": SEQ_LOSS_RTOL,
              "step_ms_median": statistics.median(sp["step_ms"][2:]),
              "data_step_ms_median": statistics.median(dp["step_ms"][2:]),
              "cli": {"launches": cli_launches, "want_b2": cli_want,
                      "out_tail": cli_out[-6:]}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def group_bytes_want(cfg, ways):
    """Params a position of GPT-2 ``cfg`` under each layout, from the
    shapes alone (f32): ``tensor`` halves the six column- and row-parallel
    block leaves over ``ways`` (qkv and fc weights and biases, both proj
    weights), ``fsdp`` divides every leaf (each has a dim divisible by
    ``ways``), ``full`` is the whole tree."""
    d, v, p, n = cfg.n_embd, cfg.vocab_size, cfg.n_positions, cfg.n_layer
    block = 2 * d + (d * 3 * d + 3 * d) + (d * d + d) + 2 * d + \
        (d * 4 * d + 4 * d) + (4 * d * d + d)
    full = v * d + p * d + 2 * d + n * block
    tp_sharded = n * (d * 3 * d + 3 * d + d * d + d * 4 * d + 4 * d
                      + 4 * d * d)
    return {"full": 4 * full, "tensor": 4 * (full - tp_sharded
                                             + tp_sharded // ways),
            "fsdp": 4 * full // ways}


def group_modes_drive(torch, entries, card, dev="cuda", n_layer=12,
                      seq_len=TRAIN_T):
    """Phase 10d: the tensor, hybrid and expert modes, ZeRO-1 and FSDP, and
    the group modes of ``elastic/`` on the card (module docstring).  A
    rehearsal on the CPU passes ``dev="cpu"`` and a shallower, shorter
    model (the CPU counts no launch)."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
    from trustworthy_dl_tpu_torch.core import sharding as shreg
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.core.mesh import build_mesh
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.models import moe as tmoe
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    cfg = gpt2_small(torch, n_layer=n_layer)
    batch = TRAIN_NODES * GROUP_ROWS
    positions = [dev] * 8
    tmp = tempfile.mkdtemp(prefix="tddl_group_")

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def allocated():
        return torch.cuda.memory_allocated() if dev == "cuda" else 0
    t0 = time.perf_counter()
    parts = {}

    def trainer(parallelism="data", mesh=None, model="gpt2", rows=GROUP_ROWS,
                attack=True, **kw):
        tr = DistributedTrainer(TrainingConfig(
            model_name=model, batch_size=TRAIN_NODES * rows,
            num_nodes=TRAIN_NODES, optimizer="adamw", learning_rate=1e-4,
            seed=0, detector_warmup=4, parallelism=parallelism,
            checkpoint_interval=10 ** 6, checkpoint_dir=tmp, **kw),
            mesh=mesh, model_overrides=dict(seq_len=seq_len,
                                            n_layer=n_layer), device=dev)
        tr.initialize()
        if attack:
            attacker = AdversarialAttacker(AttackConfig(
                attack_types=["gradient_poisoning"], target_nodes=[2],
                intensity=1.0, start_step=GROUP_ATTACK))
            attacker.activate_attacks()
            tr.set_attack_plan(attacker.plan(TRAIN_NODES, dev))
        return tr

    def loader(rows, steps, seed=0):
        return get_dataloader("openwebtext", batch_size=TRAIN_NODES * rows,
                              seq_len=seq_len, vocab_size=cfg.vocab_size,
                              num_examples=TRAIN_NODES * rows * steps,
                              seed=seed)

    def done(tr):
        tr.cleanup()
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()

    def run(name, tr, rows=GROUP_ROWS, steps=GROUP_STEPS):
        """One arm: its trajectory, launches and layout figures."""
        statuses = record_status(tr)
        sync()
        resident = allocated()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        tr.train_epoch(loader(rows, steps), 0)
        sync()
        parts[f"{name}_s"] = time.perf_counter() - t1
        hist = list(tr.batch_history)
        tree = shreg.opt_state_tree(tr.state.opt_state)
        out = {"mesh": dict(tr.mesh.shape),
               "trajectory": {
                   "loss": [h["loss"] for h in hist],
                   "trust": [h["trust_scores"] for h in hist],
                   "weights": [h["weights"] for h in hist],
                   "attacked": [h["attacked"] for h in hist],
                   "status": statuses,
                   "drop": [h.get("moe_drop_fraction") for h in hist]},
               "incidents": [(r["node_id"], r["step"], r["attack_type"])
                             for r in tr.attack_history],
               "launches": ops.launch_counts(),
               "params_bytes_per_position": shreg.tree_bytes_per_device(
                   tr.state.params, tr.specs["params"], tr.mesh),
               "opt_bytes_per_position": shreg.tree_bytes_per_device(
                   tree, tr.specs["opt_state"], tr.mesh),
               "params_bytes": shreg.tree_bytes_per_device(tr.state.params),
               "memory_allocated_bytes": allocated(),
               "resident_before_bytes": resident,
               "step_ms": [1e3 * h["step_s"] for h in hist
                           if h["step_s"] is not None]}
        out["specs"] = tr.specs
        done(tr)
        return out

    try:
        fsdp_mesh = build_mesh(TRAIN_NODES, "data",
                               devices=positions[:TRAIN_NODES])
        arms = {
            "data": run("data", trainer()),
            "tensor": run("tensor", trainer("tensor", build_mesh(
                TRAIN_NODES, "tensor", devices=positions))),
            "hybrid": run("hybrid", trainer(
                "hybrid", mesh_shape={"data": TRAIN_NODES, "model": 2})),
            "fsdp": run("fsdp", trainer(
                "data", fsdp_mesh, shard_opt_state=True, shard_params=True)),
        }
        want_mesh = {"data": {"data": 1},
                     "tensor": {"data": TRAIN_NODES, "model": 2},
                     "hybrid": {"data": TRAIN_NODES, "model": 2},
                     "fsdp": {"data": TRAIN_NODES}}
        want = step_launches(cfg, [TRAIN_NODES] * GROUP_STEPS, remat=False)
        base = arms["data"]
        expect_gating([dict(weights=w, attacked=a) for w, a in zip(
            base["trajectory"]["weights"], base["trajectory"]["attacked"])],
            GROUP_ATTACK, "group_modes (data)")
        incident = [(2, GROUP_ATTACK + 2, "gradient_poisoning")]
        for name, arm in arms.items():
            if arm["mesh"] != want_mesh[name]:
                raise AssertionError(f"group_modes {name}: mesh "
                                     f"{arm['mesh']}, want {want_mesh[name]}")
            expect_launches_equal(arm["launches"], want,
                                  f"group_modes {name}")
            if arm["trajectory"] != base["trajectory"] or \
                    arm["incidents"] != incident or \
                    len(arm["trajectory"]["loss"]) != GROUP_STEPS or \
                    not all(math.isfinite(x)
                            for x in arm["trajectory"]["loss"]):
                raise AssertionError(
                    f"group_modes {name}: trajectory "
                    f"{arm['trajectory']['loss']} incidents "
                    f"{arm['incidents']}, data mode's "
                    f"{base['trajectory']['loss']} {base['incidents']}")
        figures = group_bytes_want(cfg, 2)
        fsdp = group_bytes_want(cfg, TRAIN_NODES)
        bytes_want = {"data": (figures["full"], 2 * figures["full"]),
                      "tensor": (figures["tensor"], 2 * figures["tensor"]),
                      "hybrid": (figures["tensor"], 2 * figures["tensor"]),
                      "fsdp": (fsdp["fsdp"], 2 * fsdp["fsdp"])}
        for name, (p_want, moments) in bytes_want.items():
            arm = arms[name]
            # AdamW's two f32 moments, and the count (a replicated i32).
            if arm["params_bytes_per_position"] != p_want or \
                    arm["opt_bytes_per_position"] != moments + 4 or \
                    arm["params_bytes"] != figures["full"]:
                raise AssertionError(
                    f"group_modes {name}: {arm['params_bytes_per_position']}"
                    f" / {arm['opt_bytes_per_position']} bytes a position, "
                    f"the shapes say {p_want} / {moments + 4}")
        if arms["tensor"]["specs"] != arms["hybrid"]["specs"]:
            raise AssertionError("group_modes: the hybrid layout is not the "
                                 "tensor layout")

        # (e) expert parallelism on the MoE model beside its data mode.
        moe = {}
        for name, kw in (("expert", dict(parallelism="expert",
                                         mesh=build_mesh(
                                             TRAIN_NODES, "expert",
                                             devices=positions))),
                         ("moe_data", {})):
            tr = trainer(model="gpt2-moe", rows=GROUP_MOE_ROWS,
                         attack=False, remat=True, **kw)
            leaves = len(tree_leaves(tr.state.params))
            moe_cfg = tr.model.config
            if name == "expert" and tmoe.get_expert_mesh() is not tr.mesh:
                raise AssertionError("group_modes expert: the trainer did "
                                     "not bind its expert mesh")
            moe[name] = run(name, tr, rows=GROUP_MOE_ROWS,
                            steps=GROUP_MOE_STEPS)
        tmoe.set_expert_mesh(None)
        moe_want = moe_launches(moe_cfg, GROUP_MOE_STEPS, leaves)
        for name, arm in moe.items():
            expect_launches_equal(arm["launches"], moe_want,
                                  f"group_modes {name}")
        if moe["expert"]["trajectory"] != moe["moe_data"]["trajectory"] or \
                moe["expert"]["mesh"] != {"data": TRAIN_NODES,
                                          "expert": 2} or \
                not all(0.0 <= d < 1.0
                        for d in moe["expert"]["trajectory"]["drop"]):
            raise AssertionError(
                f"group_modes expert: {moe['expert']['trajectory']} vs "
                f"data mode's {moe['moe_data']['trajectory']}, mesh "
                f"{moe['expert']['mesh']}")

        # (f) group eviction and readmission in tensor mode.
        t1 = time.perf_counter()
        tr = trainer("tensor", build_mesh(TRAIN_NODES, "tensor",
                                          devices=positions),
                     elastic_resharding=True,
                     readmit_after_steps=GROUP_READMIT, async_host_depth=0,
                     prefetch_depth=0)
        ops.reset_launch_counts()
        tr.train_epoch(loader(GROUP_ROWS, GROUP_STEPS), 0)
        meshes = [tuple(tr.mesh.devices.shape)]
        maps = [list(tr.node_map)]
        tr.set_attack_plan(null_plan(tr.config.num_nodes, dev))
        tail = GROUP_READMIT + 1
        examples = 3 * GROUP_ROWS * GROUP_READMIT + batch
        tr.train_epoch(get_dataloader(
            "openwebtext", batch_size=3 * GROUP_ROWS, seq_len=seq_len,
            vocab_size=cfg.vocab_size, num_examples=examples, seed=1), 1)
        meshes.append(tuple(tr.mesh.devices.shape))
        maps.append(list(tr.node_map))
        f_launches = ops.launch_counts()
        parts["elastic_s"] = time.perf_counter() - t1
        hist = list(tr.batch_history)
        nodes = [len(h["per_node_loss"]) for h in hist]
        evict_step = GROUP_ATTACK + 2
        records = [{k: v for k, v in r.items()
                    if k not in ("timestamp", "migration_time_s",
                                 "bytes_moved", "measured_gbps")}
                   for r in tr.reassignment_history]
        want_records = [
            {"evicted_nodes": [2], "surviving_nodes": [0, 1, 3],
             "new_device_count": 6, "step": evict_step},
            {"readmitted_nodes": [2], "all_nodes": [0, 1, 3, 2],
             "new_device_count": 8, "step": evict_step + GROUP_READMIT}]
        want_nodes = [TRAIN_NODES] * GROUP_STEPS + [3] * GROUP_READMIT + \
            [TRAIN_NODES]
        specs_fresh = arms["tensor"]["specs"]
        expect_gating(hist[:GROUP_STEPS], GROUP_ATTACK, "group_modes elastic")
        if records != want_records or nodes != want_nodes or \
                meshes != [(3, 2), (TRAIN_NODES, 2)] or \
                maps != [[0, 1, 3], [0, 1, 3, 2]] or \
                tr.specs != specs_fresh or len(hist) != GROUP_STEPS + tail:
            raise AssertionError(
                f"group_modes elastic: records {records} (want "
                f"{want_records}), nodes {nodes} (want {want_nodes}), meshes "
                f"{meshes}, maps {maps}, specs fresh "
                f"{tr.specs == specs_fresh}")
        f_want = step_launches(cfg, nodes, remat=False)
        expect_launches_equal(f_launches, f_want, "group_modes elastic")
        elastic = {"records": [{k: v for k, v in r.items()
                                if k != "timestamp"}
                               for r in tr.reassignment_history],
                   "nodes_per_step": nodes, "meshes": meshes,
                   "losses": [h["loss"] for h in hist],
                   "launches": f_launches}
        done(tr)

        for name in want:
            entries[name]["launches_group_modes"] = \
                4 * want[name] + 2 * moe_want[name] + f_want[name]
        emit({"phase": "group_modes", "card": card,
              "seconds": time.perf_counter() - t0, "parts_s": parts,
              "model": f"gpt2 ({n_layer}L, 768, 12H, V50257, bf16 over f32 "
                       "master weights, random init seed 0); gpt2-moe (8 "
                       "experts, top-2) for the expert arm",
              "nodes": TRAIN_NODES, "rows_per_node": GROUP_ROWS,
              "seq_len": seq_len, "steps": GROUP_STEPS,
              "attack_start": GROUP_ATTACK, "incident": incident,
              "arms": {name: {k: v for k, v in arm.items()
                              if k not in ("specs", "trajectory")}
                       for name, arm in {**arms, **moe}.items()},
              "losses": base["trajectory"]["loss"],
              "moe_losses": moe["moe_data"]["trajectory"]["loss"],
              "bytes_per_position_want": {"params": {
                  k: v[0] for k, v in bytes_want.items()}},
              "expected_launches": want, "expected_launches_moe": moe_want,
              "elastic": elastic})
    finally:
        tmoe.set_expert_mesh(None)
        shutil.rmtree(tmp, ignore_errors=True)


def tp_fleet_drill(torch, dev, params, cfg):
    """JAX's TP scale-up scenario on real engines: a 2-replica fleet at
    TP 1 with ``tp_max`` 4 under occupancy pressure.  Returns (fleet,
    record, requests by fleet id, chips in service at each tick)."""
    import numpy as np

    from trustworthy_dl_tpu_torch.serve import (AutoscalerConfig,
                                                FleetConfig, ReplicaState,
                                                ServeRequest)

    fleet, rec = recorded_fleet(
        torch, dev, params, cfg, FleetConfig(
            num_replicas=2, tp_size=1, tp_max=4, restart_ticks=2,
            quarantine_cooloff_ticks=10_000,
            autoscale=AutoscalerConfig(
                min_replicas=2, max_replicas=3,
                scale_up_queue_per_replica=8.0,
                scale_down_queue_per_replica=-1.0,
                scale_up_occupancy=0.9, scale_down_occupancy=-1.0,
                scale_up_cooldown_ticks=10 ** 6,
                scale_down_cooldown_ticks=1,
                scale_down_idle_ticks=10 ** 6)), **TP_FLEET)
    rng = np.random.default_rng(13)
    waves = [[(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 9)))
               .tolist(), int(rng.integers(8, 13))) for _ in range(n)]
             for n in (TP_FLEET_FIRST, TP_FLEET_SECOND)]
    reqs, chips = {}, []

    class Feed:
        sent = 0
        done = False

        def __call__(self):
            chips.append(fleet.chips_in_service())
            ready = self.sent == 0 or (
                len(fleet.replicas) > 2
                and fleet.replicas[2].state is ReplicaState.HEALTHY)
            if self.sent < len(waves) and ready:
                for prompt, new in waves[self.sent]:
                    fid = fleet.submit(ServeRequest(prompt=prompt,
                                                    max_new_tokens=new))
                    if fid is None:
                        raise AssertionError("serve_tp fleet: shed")
                    reqs[fid] = (prompt, new)
                self.sent += 1
            self.done = self.sent == len(waves)

    drive_ticks(torch, dev, fleet, rec, feed=Feed(),
                max_ticks=TP_FLEET_MAX_TICKS)
    chips.append(fleet.chips_in_service())
    return fleet, rec, reqs, chips


def serve_tp_drive(torch, entries, card, base_results=None, dev="cuda",
                   n_layer=12):
    """Phase 10e: tensor-parallel serving replicas on one card (module
    docstring).  A rehearsal on the CPU passes ``dev="cpu"`` and a
    shallower model (no serve-phase reference then; the CPU counts no
    launch)."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core import sharding as shreg
    from trustworthy_dl_tpu_torch.obs.hbm import HbmMonitor
    from trustworthy_dl_tpu_torch.serve.fleet import ReplicaObs
    from trustworthy_dl_tpu_torch.serve.kv_slots import kv_bytes_per_token
    from trustworthy_dl_tpu_torch.utils.serve_profile import (serve_smoke,
                                                              smoke_engine,
                                                              smoke_traffic)

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg, params = smoke_gpt2(torch, dev, n_layer)
    requests = smoke_traffic(cfg.vocab_size)
    out = {"phase": "serve_tp", "card": card,
           "model": f"gpt2 ({n_layer}L, 768, 12H, V50257, bf16, random "
                    "init seed 0)", "requests": len(requests)}

    # -- 1. TP 1 against TP 2 over the serve traffic -----------------------
    arms = {}
    for tp in (1, 2):
        sync(torch, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        engine, results, wall = serve_smoke(cfg, params, "kernel", requests,
                                            device=dev, tp_size=tp)
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else 0
        summary = engine.metrics_summary()
        check_completed(results, requests)
        want = {"paged_attention": cfg.n_layer * summary["decode_ticks"],
                "paged_prefill_attention":
                    cfg.n_layer * summary["prefill_chunks"],
                "logit_trust_stats": summary["prompts_prefilled"]
                + summary["decode_ticks"]}
        if dev.type == "cuda":
            expect_launches(launches, want, f"serve_tp tp={tp}")
        arm = {"wall_s": wall, "tokens_per_s": summary["tokens_per_s"],
               "peak_memory_bytes": peak,
               "launches": launches_of(launches, want),
               "decode_ticks": summary["decode_ticks"],
               "prefill_chunks": summary["prefill_chunks"]}
        if tp > 1:
            whole = shreg.tree_bytes_per_device(params)
            per_position = shreg.tree_bytes_per_device(
                params, engine.tp_specs, engine.tp_mesh)
            arm.update({
                "mesh": engine.tp_mesh.shape,
                "positions_on": sorted({str(d) for d in
                                        engine.tp_mesh.devices.flat}),
                "param_bytes": whole,
                "param_bytes_per_position": per_position,
                "memory_allocated_bytes": (torch.cuda.memory_allocated()
                                           if dev.type == "cuda" else 0)})
            if not per_position < whole:
                raise AssertionError(f"serve_tp: TP-2 specs shard nothing "
                                     f"({per_position} of {whole} bytes)")
        arms[tp] = (results, arm)
        del engine
    res1, res2 = arms[1][0], arms[2][0]
    differ = [r for r in res1 if res1[r].tokens != res2[r].tokens]
    if base_results is not None:
        differ += [r for r in res1 if res1[r].tokens
                   != base_results[r].tokens]
    if differ:
        raise AssertionError(f"serve_tp: streams of requests {differ} "
                             "differ between TP 1, TP 2 and the serve "
                             "phase")
    if arms[1][1]["launches"] != arms[2][1]["launches"]:
        raise AssertionError(f"serve_tp: launches {arms[1][1]['launches']} "
                             f"at TP 1, {arms[2][1]['launches']} at TP 2")
    out["arms"] = {f"tp{tp}": arm for tp, (_, arm) in arms.items()}
    out["tp2_over_tp1_tokens_per_s"] = (arms[2][1]["tokens_per_s"]
                                        / arms[1][1]["tokens_per_s"])
    out["streams_bit_identical"] = True
    out["reference"] = "serve phase" if base_results is not None \
        else "tp1 only"
    del arms, res1, res2

    # -- 2. the HBM gate admits the same blocks at both widths -------------
    block_bytes = 16 * kv_bytes_per_token(cfg)
    admitted = {}
    for tp in (1, 2):
        gc.collect()
        if dev.type == "cuda":
            budget = torch.cuda.memory_allocated() \
                + TP_GATE_BLOCKS * block_bytes
        else:
            budget = TP_GATE_BLOCKS * block_bytes
        hbm = HbmMonitor(budget_bytes=budget)
        engine = smoke_engine(cfg, params, "kernel", device=dev,
                              tp_size=tp, obs=ReplicaObs(hbm=hbm))
        admitted[tp] = {"num_blocks": engine.scheduler.num_blocks,
                        "denials": hbm.pressure_denials}
        del engine
    if admitted[1] != admitted[2] or admitted[1]["denials"] != 1:
        raise AssertionError(f"serve_tp: the HBM gate admitted {admitted}")
    out["hbm_gate"] = {"budget_blocks": TP_GATE_BLOCKS, **{
        f"tp{tp}": a for tp, a in admitted.items()}}

    # -- 3. the fleet's scale-up to a doubled TP group ---------------------
    fleet, rec, reqs, chips = tp_fleet_drill(torch, dev, params, cfg)
    counters = {k: fleet.counters[k] for k in ("scale_ups", "scale_downs",
                                                "tp_scale_ups")}
    widths = [r.tp for r in fleet.replicas]
    new = fleet.replicas[2] if len(fleet.replicas) > 2 else None
    if counters != {"scale_ups": 1, "scale_downs": 0, "tp_scale_ups": 1} \
            or widths != [1, 1, 2] or chips[0] != 2 or max(chips) != 4 \
            or new.engine.tp_mesh is None:
        raise AssertionError(f"serve_tp fleet: counters {counters}, widths "
                             f"{widths}, chips {chips}")
    results = fleet.results
    order = sorted(reqs)
    ref, one_tps = one_engine_streams(
        torch, dev, params, cfg, [reqs[f] for f in order],
        max_slots=TP_FLEET["max_slots"], max_seq=TP_FLEET["max_seq"],
        enable_monitor=False)
    differ = [f for f, r in zip(order, ref)
              if results[f].status != "completed"
              or results[f].tokens != r.tokens]
    by_new = sum(1 for r in results.values() if r.replica == 2)
    if differ or by_new < 1:
        raise AssertionError(f"serve_tp fleet: requests {differ} differ "
                             f"from one engine's; replica 2 served {by_new}")
    ok, problems = fleet.verify_attribution()
    if not ok:
        raise AssertionError(f"serve_tp fleet attribution: {problems[:3]}")
    gens, want = fleet_launch_check(rec["generations"], rec["launches"],
                                    cfg.n_layer, "serve_tp fleet",
                                    prefill_chunks=False) \
        if dev.type == "cuda" else ([], {})
    tokens = sum(len(r.tokens) for r in results.values())
    out["fleet"] = {
        "wall_s": rec["wall"], "ticks": fleet.tick,
        "tokens_per_s": tokens / rec["wall"],
        "one_engine_tokens_per_s": one_tps, "counters": counters,
        "widths": widths, "chips_in_service": [chips[0], max(chips),
                                               chips[-1]],
        "replica_2_mesh": new.engine.tp_mesh.shape,
        "served_by_scaled_up_replica": by_new,
        "host_ms_per_tick": rec["host_ms_per_tick"],
        "generations": gens, "launches": launches_of(rec["launches"], want),
        "expected_launches": want}
    for name, n in out["arms"]["tp2"]["launches"].items():
        key = {"paged_attention": "paged_decode_attention"}.get(name, name)
        if key in entries and n:
            entries[key]["launches_serve_tp"] = n
    emit({**out, "seconds": time.perf_counter() - t_phase})


def compute_mode(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--id={card}", "--query-gpu=compute_mode",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def multihost_drive(torch, entries, card, smi):
    """Phase 10f: two processes on the card over gloo run the gathered
    trusted step at GPT-2 small's width (module docstring)."""
    import socket

    from trustworthy_dl_tpu_torch.utils import multiproc_worker as worker

    t_phase = time.perf_counter()
    mode = compute_mode(card)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = [str(port), "--device", "cuda", "--size", "gpt2-small",
            "--steps", str(MULTIHOST_STEPS), "--plan", "live", "--profile"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "trustworthy_dl_tpu_torch.utils."
         "multiproc_worker", str(r), "2", *args], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=MULTIHOST_TIMEOUT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.perf_counter() - t_phase
    ranks, stats = [], []
    for r, (rc, out, err) in enumerate(outs):
        lines = out.splitlines()
        ok = [ln for ln in lines if ln.startswith("MULTIPROC_OK")]
        st = [ln for ln in lines if ln.startswith("MULTIPROC_STATS ")]
        if rc != 0 or len(ok) != 1 or len(st) != 1:
            raise AssertionError(f"multihost: rank {r} exited {rc} "
                                 f"(compute mode {mode}): {err[-3000:]}")
        ranks.append(worker.parse_ok_line(ok[0]))
        stats.append(json.loads(st[0].split(" ", 1)[1]))
    if ranks[0]["losses"] != ranks[1]["losses"] or \
            ranks[0]["trust"] != ranks[1]["trust"] or \
            ranks[0]["params"] != ranks[1]["params"]:
        raise AssertionError(f"multihost: the ranks disagree: {ranks}")
    cfg = gpt2_small(torch)
    want = step_launches(cfg, [TRAIN_NODES // 2] * MULTIHOST_STEPS)
    for r, st in enumerate(stats):
        got = {k: st["launches"].get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"multihost: rank {r} launches {got}, "
                                 f"design says {want}")
    t_ref = time.perf_counter()
    ref = worker.run_steps("gpt2-small", "cuda", MULTIHOST_STEPS,
                               "live", profile=True)
    ref_s = time.perf_counter() - t_ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                ref["losses"])]
    trust_gap = max(abs(a - b) for a, b in zip(ranks[0]["trust"],
                                               ref["trust"]))
    if max(gaps) > MULTIHOST_LOSS_RTOL or trust_gap > MULTIHOST_TRUST_ATOL \
            or not all(math.isfinite(x) for x in ref["losses"]):
        raise AssertionError(f"multihost: losses {ranks[0]['losses']} "
                             f"against one process's {ref['losses']}, "
                             f"trust gap {trust_gap}")
    ref_want = step_launches(cfg, [TRAIN_NODES] * MULTIHOST_STEPS)
    if {k: ref["launches"].get(k, 0) for k in ref_want} != ref_want:
        raise AssertionError(f"multihost: one-process launches "
                             f"{ref['launches']}, design says {ref_want}")
    for name, n in want.items():
        entries[name]["launches_multihost"] = 2 * n
    keys = ("step_ms", "gather_ms", "gather_bytes", "peak_memory_bytes",
            "profile", "rows")
    emit({"phase": "multihost", "card": smi, "compute_mode": mode, "seconds": time.perf_counter() - t_phase,
          "workers_s": spawn_s, "one_process_s": ref_s,
          "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                   "weights, random init seed 0)",
          "world": 2, "backend": "gloo (staged through host memory)",
          "nodes": TRAIN_NODES, "rows_per_node": 8, "seq_len": TRAIN_T,
          "steps": MULTIHOST_STEPS,
          "ranks": [{k: st.get(k) for k in keys} for st in stats],
          "one_process": {k: ref.get(k) for k in keys},
          # Medians over the steps after the first (which loads and warms).
          "rank_step_ms_median": statistics.median(
              ms for st in stats for ms in st["step_ms"][1:]),
          "one_process_step_ms_median": statistics.median(
              ref["step_ms"][1:]),
          "gather_ms_median": statistics.median(
              ms for st in stats for ms in st["gather_ms"][1:]),
          "losses": ranks[0]["losses"], "one_process_losses": ref["losses"],
          "loss_rel_gap_max": max(gaps), "trust_gap_max": trust_gap,
          "bit_equal_to_one_process": (ranks[0]["losses"] == ref["losses"]
                                       and ranks[0]["params"]
                                       == ref["params"]),
          "trust": ranks[0]["trust"], "launches_per_rank": want,
          "one_process_launches": ref_want})


def b1_at_mix(torch, shapes, nodes, flush, full=False):
    """B1 over a drive's gradient battery (every leaf of every node, at
    most ``MAX_SEGMENTS`` a launch, split as the step splits it) on random
    gradients of the drive's leaf shapes, against the plain twin: the sums
    within MOMENT_RTOL of their magnitude sums, the extrema exact.  The
    battery's ms and ms a launch; with ``full`` also the plain twin's,
    the bound's and the library calls'."""
    from trustworthy_dl_tpu_torch.engine.step import _moments
    from trustworthy_dl_tpu_torch.ops import fused_stats as fs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    grads = [torch.randn((nodes,) + tuple(s), device=dev, generator=gen)
             * 1e-3 for s in shapes]
    segs = [g[i].reshape(-1) for i in range(nodes) for g in grads]
    got = _moments(segs)
    torch.cuda.synchronize()
    ref = fs.fused_moments_plain(segs)
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    mag = torch.stack([torch.stack([x.abs().sum(), (x * x).sum(),
                                    (x.abs() ** 3).sum(), (x ** 4).sum(),
                                    x.abs().sum()]) for x in segs])
    sum_err = (got[:, sums] - ref[:, sums]).abs()
    exact = [fs.MIN, fs.MAX, fs.LINF]
    if not bool((sum_err <= MOMENT_RTOL * mag).all()) or not torch.equal(
            got[:, exact], ref[:, exact]):
        raise AssertionError(
            f"fused_moments at {len(segs)} segments disagrees with plain: "
            f"worst sum error / magnitude {float((sum_err / mag).max())}")
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    launches = -(-len(segs) // fs.MAX_SEGMENTS)
    n_el = sum(x.numel() for x in segs)
    ms = time_ms(torch, lambda: _moments(segs), flush, reps=10)
    # The events also hold the wrapper's host work (its segment table,
    # built in Python), which the card waits on: the battery's launches
    # replayed as one CUDA graph (the card's own time, with the gaps
    # between kernels), and the host's enqueue of one launch.
    dev_ms = kernel_ab.graph_ms(lambda: _moments(segs), flush, reps=10)
    first = segs[:fs.MAX_SEGMENTS]
    out = {"segments": len(segs), "elements": n_el,
           "launches_per_battery": launches, "ms": ms,
           "ms_per_launch": ms / launches, "graph_ms": dev_ms,
           "graph_ms_per_launch": dev_ms / launches,
           "host_us_per_launch": kernel_ab.host_us(
               lambda: fs.fused_moments(first), calls=20),
           "max_abs_err": float(sum_err.max())}
    if full:
        def library_moments():
            for x in segs:
                x.sum()
                for order in (1, 2, 4, float("inf")):
                    torch.linalg.vector_norm(x, order)
                torch.aminmax(x)
                x.pow(3).sum()

        bound_ms, bound_by = bound_entry(n_el * 4 + len(segs) * 32,
                                         n_el * 12, "float32")
        out.update(plain_ms=time_ms(torch, lambda: fs.fused_moments_plain(
            segs), flush, reps=2), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(torch, library_moments, flush, reps=2))
    del grads, segs, got, ref, mag
    torch.cuda.empty_cache()
    return out


def host_phase_ms(torch, tr, loader):
    """One step's host time by the step's ``tddl.*`` ranges
    (``torch.profiler``, CPU activity: the recording adds to every op's
    host cost alike), from the trainer's state; the state moves on.  The
    step's whole enqueue is ``busy_window``'s."""
    from torch.profiler import ProfilerActivity, profile

    batch = tr._node_batch(next(iter(loader)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.state, _ = tr._train_step(tr.state, batch, tr.attack_plan)
    torch.cuda.synchronize()
    ranges = {e.key: e.cpu_time_total / 1e3 for e in prof.key_averages()
              if e.key.startswith("tddl.")}
    return {"ranges_ms_profiled": ranges, "work_units": tr.work_units(batch)}


def host_detector_on_card(torch, shapes):
    """The host ``AttackDetector`` on the card: the exact battery of
    ResNet-101's concatenated gradient against numpy on the same values,
    and the Byzantine and backdoor checks on card tensors."""
    import numpy as np

    from trustworthy_dl_tpu_torch.detect.detector import AttackDetector

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    flat = torch.cat([torch.randn(math.prod(s), device=dev, generator=gen)
                      for s in shapes]) * 1e-3
    det = AttackDetector(device="cuda")
    t0 = time.perf_counter()
    stats = det.calculate_gradient_statistics([flat])
    battery_s = time.perf_counter() - t0
    x = flat.cpu().numpy()
    x64 = x.astype(np.float64)
    want = {"median": float(np.median(x)),
            "percentile_25": float(np.percentile(x, 25)),
            "percentile_75": float(np.percentile(x, 75))}
    std = float(x64.std())
    errors = {k: abs(stats[k] - v) / abs(v) for k, v in want.items()}
    errors.update(
        mean=abs(stats["mean"] - float(x64.mean())) / std,
        std=abs(stats["std"] - std) / std,
        norm_l2=abs(stats["norm_l2"] - float(np.sqrt((x64 * x64).sum())))
        / float(np.sqrt((x64 * x64).sum())))
    limits = {"median": ORDER_RTOL, "percentile_25": ORDER_RTOL,
              "percentile_75": ORDER_RTOL, "mean": MOMENT_RTOL,
              "std": MOMENT_RTOL, "norm_l2": MOMENT_RTOL}
    if any(errors[k] > limits[k] for k in limits) or \
            stats["min"] != float(x.min()) or stats["max"] != float(x.max()):
        raise AssertionError(f"host detector on the card: relative errors "
                             f"{errors} against {limits}, min/max "
                             f"{stats['min']}/{stats['max']} vs "
                             f"{x.min()}/{x.max()}")
    base = torch.randn(512, device=dev, generator=gen)
    outputs = {i: base + 0.01 * torch.randn(512, device=dev, generator=gen)
               for i in range(VISION_NODES)}
    for i in VISION_TARGETS:
        outputs[i] = torch.randn(512, device=dev, generator=gen)
    byzantine = det.detect_byzantine_behavior(outputs, 0)
    m = torch.randn(32, 10, device=dev, generator=gen)
    backdoor = [det.detect_backdoor_attack(m, e, 0) for e in (m, -8 * m)]
    if byzantine != list(VISION_TARGETS) or backdoor != [False, True]:
        raise AssertionError(f"host detector on the card: Byzantine "
                             f"{byzantine}, backdoor {backdoor}")
    return {"elements": int(flat.numel()), "battery_s": battery_s,
            "relative_errors": errors, "limits": limits,
            "median": stats["median"], "byzantine": byzantine,
            "backdoor": backdoor}


def vision_drive(torch, entries, card):
    """Phase 11: the runner's three vision presets on the card (VGG-16
    and ResNet-101 under attack, ResNet-32 clean through the ML tier),
    B1 at each drive's gradient mix, and the host detector's API on card
    tensors."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import _sklearn_available
    from trustworthy_dl_tpu_torch.experiments import ExperimentRunner, \
        preset_config
    from trustworthy_dl_tpu_torch.ops import fused_stats as fs
    from trustworthy_dl_tpu_torch.utils.train_profile import busy_window
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    sklearn = _sklearn_available()
    out_dir = tempfile.mkdtemp(prefix="tddl_vision_")
    t_phase = time.perf_counter()
    b1_total = 0
    try:
        for preset, epochs, per_epoch, attack_epoch in VISION_DRIVES:
            if attack_epoch is None and not sklearn:
                per_epoch = VISION_CLEAN_PER_EPOCH_NO_ML
            # What earlier phases left allocated (and the flush buffer),
            # once their garbage is collected: the drive's peak is counted
            # above it.
            gc.collect()
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            kw = dict(num_epochs=epochs, steps_per_epoch=per_epoch,
                      output_dir=out_dir, experiment_name=preset)
            if attack_epoch is not None:
                kw["attack_start_epoch"] = attack_epoch
            config = preset_config(preset, **kw)
            runner = ExperimentRunner(config, device="cuda")
            runner.setup_experiment()
            tr = runner.trainer
            parts = {"setup_s": time.perf_counter() - t0}
            if config.num_nodes != VISION_NODES or \
                    config.batch_size != VISION_BATCH or \
                    tr.model.input_spec != {"image_shape": (32, 32, 3),
                                            "num_classes": 10} or \
                    tr.model.config.dtype != torch.bfloat16:
                raise AssertionError(f"{preset}: {config}, "
                                     f"{tr.model.input_spec}")
            shapes = [tuple(p.shape) for p in tree_leaves(tr.state.params)]
            n_params = sum(math.prod(s) for s in shapes)
            t1 = time.perf_counter()
            mix = b1_at_mix(torch, shapes, VISION_NODES, flush,
                            full=preset.startswith("resnet101"))
            parts["b1_mix_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            host_api = host_detector_on_card(torch, shapes) \
                if preset.startswith("resnet101") else None
            parts["host_api_s"] = time.perf_counter() - t1
            refits = []
            detector = tr.attack_detector
            refit = detector.update_detection_models

            def timed_refit(*args, refit=refit, **kwargs):
                t = time.perf_counter()
                refit(*args, **kwargs)
                refits.append(time.perf_counter() - t)

            detector.update_detection_models = timed_refit
            record, record_s = tr._record_batch, []

            def timed_record(host, epoch, step_s=None, record=record,
                             record_s=record_s):
                t = time.perf_counter()
                out = record(host, epoch, step_s)
                record_s.append(time.perf_counter() - t)
                return out

            tr._record_batch = timed_record
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            results = runner.run_experiment()
            parts["run_s"] = time.perf_counter() - t1
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() - resident
            steps = epochs * per_epoch
            per_step = mix["launches_per_battery"] + 1   # + the features
            want = {name: 0 for name in launches}
            want["fused_moments"] = steps * per_step
            expect_launches_equal(launches, want, preset)
            b1_total += want["fused_moments"]
            hist = list(tr.batch_history)
            losses = [h["loss"] for h in hist]
            if len(hist) != steps or not all(math.isfinite(x)
                                             for x in losses):
                raise AssertionError(f"{preset}: {len(hist)} steps, losses "
                                     f"{losses}")
            incidents = [(r["node_id"], r["step"], r["attack_type"])
                         for r in tr.attack_history]
            if attack_epoch is None:
                expect_gating(hist, steps, preset, targets=(),
                              nodes=VISION_NODES)
                if incidents:
                    raise AssertionError(f"{preset}: incidents {incidents}")
            else:
                start = attack_epoch * per_epoch
                expect_gating(hist, start, preset, targets=VISION_TARGETS,
                              nodes=VISION_NODES)
                if sorted(i[0] for i in incidents) != list(VISION_TARGETS) \
                        or any(i[1] <= start for i in incidents):
                    raise AssertionError(f"{preset}: incidents {incidents}")
            if sklearn:
                ml_tier = "on"
                if len(refits) != epochs:
                    raise AssertionError(f"{preset}: {len(refits)} refits")
                # Past the 50-sample floor every node has a fitted model
                # and a verdict (below it a node's verdict is False).
                fitted = sorted(detector.anomaly_detectors)
                nodes = list(range(VISION_NODES))
                if sorted(tr.ml_flags) != nodes or fitted != (
                        nodes if steps >= detector.ML_MIN_SAMPLES else []):
                    raise AssertionError(f"{preset}: ML flags "
                                         f"{tr.ml_flags}, models {fitted}")
            else:
                ml_tier = "off: scikit-learn not installed"
                if tr._ml_enabled or detector.output_history or refits or \
                        tr.ml_flags:
                    raise AssertionError(f"{preset}: the ML tier ran "
                                         "without scikit-learn")
            del tr._record_batch
            step_ms = [1e3 * h["step_s"] for h in hist[2:]
                       if h["step_s"] is not None]
            median_ms = statistics.median(step_ms)
            t1 = time.perf_counter()
            tr.initialize()

            def loader(steps, seed):
                return get_dataloader("cifar10", batch_size=VISION_BATCH,
                                      num_examples=VISION_BATCH * steps,
                                      seed=seed)

            busy = busy_window(tr, loader(VISION_BUSY_STEPS, 3),
                               first=VISION_BUSY_FIRST,
                               last=VISION_BUSY_LAST)
            phases = host_phase_ms(torch, tr, loader(1, 4))
            parts["profile_s"] = time.perf_counter() - t1
            emit({"phase": "vision", "drive": preset, "card": card,
                  "seconds": time.perf_counter() - t0,
                  "model": f"{tr.model.name} ({n_params} params, "
                           f"{len(shapes)} leaves, bf16 over f32 master "
                           "weights, random init seed 0)",
                  "nodes": VISION_NODES, "batch": VISION_BATCH,
                  "image_shape": [32, 32, 3], "steps": steps,
                  "attack": None if attack_epoch is None else {
                      "types": list(config.attack_types),
                      "targets": list(VISION_TARGETS),
                      "start_step": attack_epoch * per_epoch},
                  "step_ms_median": median_ms, "step_ms": step_ms,
                  "samples_per_s": phases["work_units"] * 1e3 / median_ms,
                  "peak_memory_bytes": peak,
                  "resident_before_bytes": resident, "busy": busy,
                  "enqueue_ms_median": busy["enqueue_ms_median"],
                  "host_phases": phases, "parts_s": parts,
                  "b1": {"launches": launches["fused_moments"],
                         "per_step": per_step, "at_mix": mix},
                  "losses": losses, "incidents": incidents,
                  "ml_tier": ml_tier, "refit_s": refits[:epochs],
                  "record_ms_median": 1e3 * statistics.median(record_s),
                  "ml_flags": {str(k): v for k, v in tr.ml_flags.items()},
                  "ml_models": sorted(detector.anomaly_detectors),
                  "host_api": host_api,
                  "epoch_s": [r["epoch_time_s"]
                              for r in results["epoch_records"]]})
            if preset.startswith("resnet101"):
                entries["fused_moments"]["resnet101_mix"] = {
                    k: mix[k] for k in ("segments", "elements",
                                        "launches_per_battery", "ms",
                                        "ms_per_launch", "graph_ms",
                                        "graph_ms_per_launch",
                                        "host_us_per_launch", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "max_abs_err")}
            # The wrappers hold the trainer and the detector too.
            del runner, tr, detector, refit, timed_refit, record, timed_record
            torch.cuda.empty_cache()
        entries["fused_moments"]["launches_vision"] = b1_total
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase": "vision_done", "seconds": time.perf_counter() - t_phase,
          "ml_tier": "on" if sklearn else "off: scikit-learn not installed",
          "b1_launches": b1_total, "b1_max_segments": fs.MAX_SEGMENTS})


def run_cli(args, out_lines):
    """``cli.main(args)`` with its standard output captured into
    ``out_lines``; fails on a non-zero exit code."""
    import contextlib
    import io

    from trustworthy_dl_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args))
    out_lines.extend(buf.getvalue().splitlines())
    if rc != 0:
        raise AssertionError(f"text: cli {args[0]} exited {rc}: "
                             f"{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def text_corpus(root):
    """The corpus of the text phase: the checkout's Markdown documents and
    the port package's .py sources (read as text, never imported),
    repeated to at least TEXT_CORPUS_BYTES."""
    import glob

    here = os.path.dirname(os.path.abspath(__file__))
    paths = sorted(glob.glob(os.path.join(here, "*.md"))) + sorted(
        glob.glob(os.path.join(here, "trustworthy_dl_tpu_torch", "**",
                               "*.py"), recursive=True))
    parts = []
    for path in paths:
        with open(path, encoding="utf-8", errors="replace") as f:
            parts.append(f.read())
    base = "\n".join(parts)
    copies = max(1, math.ceil(TEXT_CORPUS_BYTES / len(base.encode())))
    text = "\n".join([base] * copies)
    path = os.path.join(root, "openwebtext.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    # The corpus as ``prepare`` reads it (universal newlines).
    with open(path, encoding="utf-8", errors="replace") as f:
        text = f.read()
    return path, text, {"files": len(paths), "copies": copies,
                        "bytes": len(text.encode())}


def text_drive(torch, entries, card):
    """Phase 12: raw text to served text through the port's command line:
    ``prepare`` on a corpus from the checkout, ``train --config`` on it at
    the train phase's geometry with a trace, ``serve`` and ``generate``
    from the checkpoint it committed."""
    import numpy as np

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig, \
        load_config
    from trustworthy_dl_tpu_torch.data import tokenizer as tok_mod
    from trustworthy_dl_tpu_torch.engine import trainer as trainer_mod
    from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
    from trustworthy_dl_tpu_torch.models import generate as gen_mod
    from trustworthy_dl_tpu_torch.serve import engine as engine_mod
    from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves

    cfg = gpt2_small(torch)
    root = tempfile.mkdtemp(prefix="tddl_text_")
    t_phase = time.perf_counter()
    seconds, out, gates = {}, [], []
    patched = []

    def patch(owner, name, value):
        patched.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    try:
        # -- 1. the corpus --------------------------------------------------
        t = time.perf_counter()
        corpus, text, corpus_info = text_corpus(root)
        seconds["corpus"] = time.perf_counter() - t

        # -- 2. prepare ---------------------------------------------------------
        bpe = {"train_bpe_s": 0.0, "encode_s": 0.0}
        train_fn = tok_mod.BPETokenizer.__dict__["train"].__func__
        encode_fn = tok_mod.BPETokenizer.encode

        def timed_train(klass, corpus_text, vocab_size=8192):
            t0 = time.perf_counter()
            tok = train_fn(klass, corpus_text, vocab_size)
            bpe["train_bpe_s"] += time.perf_counter() - t0
            return tok

        def timed_encode(self, corpus_text):
            t0 = time.perf_counter()
            ids = encode_fn(self, corpus_text)
            bpe["encode_s"] += time.perf_counter() - t0
            return ids

        patch(tok_mod.BPETokenizer, "train", classmethod(timed_train))
        patch(tok_mod.BPETokenizer, "encode", timed_encode)
        t = time.perf_counter()
        run_cli(["prepare", corpus, "--vocab-size", str(TEXT_VOCAB)], out)
        seconds["prepare"] = time.perf_counter() - t
        for owner, name, value in reversed(patched):
            setattr(owner, name, value)
        patched.clear()
        tok = tok_mod.BPETokenizer.load(os.path.join(root, "tokenizer"))
        ids = tok.encode(text)
        if tok.decode(ids) != text:
            raise AssertionError("text: decode(encode(corpus)) != corpus")
        if max(ids) >= TEXT_VOCAB or tok.vocab_size != TEXT_VOCAB:
            raise AssertionError(f"text: ids up to {max(ids)}, vocab "
                                 f"{tok.vocab_size}")
        with open(os.path.join(root, "openwebtext.bin"), "rb") as f:
            written = f.read()
        if written != np.asarray(ids, np.uint16).tobytes():
            raise AssertionError("text: the .bin's bytes are not the ids")
        holdout = len(ids) - int(len(ids) * 0.95)
        val_windows = min((holdout - 1) // TRAIN_T, TEXT_VAL_WINDOWS)
        if val_windows < TRAIN_BATCH:
            raise AssertionError(f"text: the holdout's {holdout} tokens "
                                 "hold no validation batch")
        gates += ["round_trip", "ids_below_vocab", "bin_bytes",
                  "validation_batch"]

        # -- 3. train --config ---------------------------------------------------
        ckpt = os.path.join(root, "ckpt")
        prof = os.path.join(root, "profile")
        file_config = {
            "model": {"name": "gpt2", "size": "small"},
            "training": {"batch_size": TRAIN_BATCH, "learning_rate": 0.0001,
                         "num_epochs": 3, "optimizer": "adamw"},
            "distributed": {"num_nodes": TRAIN_NODES, "parallelism": "data"},
            "security": {"trust_threshold": 0.7, "attack_detection": True,
                         "gradient_verification": True},
            "dataset": "openwebtext", "remat": True, "seed": 0,
            "checkpoint_dir": ckpt, "profile_dir": prof}
        config_path = os.path.join(root, "config.json")
        with open(config_path, "w") as f:
            json.dump(file_config, f)
        resolved = load_config(config_path)
        try:
            import yaml

            yaml_path = os.path.join(root, "config.yaml")
            with open(yaml_path, "w") as f:
                yaml.safe_dump(file_config, f)
            if load_config(yaml_path) != resolved:
                raise AssertionError("text: the YAML and JSON configs "
                                     "resolve differently")
            yaml_state = "yaml and json resolve equal"
        except ImportError:
            yaml_state = "pyyaml not installed: json only"
        made, batch_max = [], []
        saved_params = {}

        class Recording(trainer_mod.DistributedTrainer):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

            def _node_batch(self, batch, for_eval=False):
                if not for_eval:
                    batch_max.append(int(np.asarray(batch["input"]).max()))
                return super()._node_batch(batch, for_eval)

            def save_checkpoint(self):
                path = super().save_checkpoint()
                saved_params["params"] = map_tree(
                    lambda a: a.detach().clone(), self.state.params)
                return path

        patch(trainer_mod, "DistributedTrainer", Recording)
        previous_dir = os.environ.get("TDDL_DATA_DIR")
        os.environ["TDDL_DATA_DIR"] = root
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        try:
            run_cli(["train", "--config", config_path, "--seq-len",
                     str(TRAIN_T), "--epochs", "1", "--steps-per-epoch",
                     str(TEXT_STEPS)], out)
        finally:
            if previous_dir is None:
                os.environ.pop("TDDL_DATA_DIR")
            else:
                os.environ["TDDL_DATA_DIR"] = previous_dir
        seconds["train"] = time.perf_counter() - t
        launches = ops.launch_counts()
        tr = made[0]
        applied = {k: getattr(tr.config, k) for k in (
            "model_name", "batch_size", "learning_rate", "num_epochs",
            "num_nodes", "attack_detection_enabled", "remat",
            "profile_dir", "checkpoint_dir")}
        want_applied = {"model_name": "gpt2", "batch_size": TRAIN_BATCH,
                        "learning_rate": 0.0001, "num_epochs": 1,
                        "num_nodes": TRAIN_NODES,
                        "attack_detection_enabled": True, "remat": True,
                        "profile_dir": prof, "checkpoint_dir": ckpt}
        if applied != want_applied or resolved.num_epochs != 3:
            raise AssertionError(f"text: config applied {applied}, want "
                                 f"{want_applied} (the file says 3 epochs, "
                                 "the flag 1)")
        if len(batch_max) != TEXT_STEPS or max(batch_max) < 512:
            raise AssertionError(f"text: train batches' max ids {batch_max}"
                                 ": not the corpus's")
        losses = [r["loss"] for r in tr.batch_history]
        if len(losses) != TEXT_STEPS or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"text: losses {losses}")
        want = flash_b1_launches(cfg, TEXT_STEPS, True,
                                 val_windows // TRAIN_BATCH, TRAIN_NODES)
        expect_launches_equal(launches, want, "text train")
        for name, n in want.items():
            entries[name]["launches_text"] = n
        traces = [os.path.join(prof, n) for n in os.listdir(prof)
                  if n.endswith(".json")]
        if len(traces) != 1:
            raise AssertionError(f"text: traces {traces}")
        t = time.perf_counter()
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        seconds["trace_read"] = time.perf_counter() - t
        steps = [e["name"] for e in events
                 if e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith("train_step#")]
        if steps != [f"train_step#{i}" for i in range(1, TEXT_STEPS + 1)]:
            raise AssertionError(f"text: trace step annotations {steps}")
        device_events = sum(1 for e in events
                            if e.get("cat") == "kernel")
        if device_events == 0:
            raise AssertionError("text: the trace holds no kernel")
        if CheckpointManager(ckpt).latest_step() != TEXT_STEPS:
            raise AssertionError("text: no committed checkpoint at step "
                                 f"{TEXT_STEPS}")
        final = saved_params["params"]
        gates += ["config_applied", "flag_wins", "corpus_batches",
                  "losses_finite", "b1_b3_exact", "trace_steps",
                  "checkpoint_committed"]
        for owner, name, value in reversed(patched):
            setattr(owner, name, value)
        patched.clear()
        del tr, made[:]
        torch.cuda.empty_cache()

        # -- 4. serve --checkpoint-dir -----------------------------------------
        engines, served_params, submitted = [], [], []
        from_config = engine_mod.ServingEngine.__dict__["from_config"]

        def recording_from_config(klass, params, *a, **kw):
            served_params.append(params)
            engine = from_config.__func__(klass, params, *a, **kw)
            submit = engine.submit

            def recording_submit(request):
                submitted.append(request)
                return submit(request)

            engine.submit = recording_submit
            engines.append((engine, a, kw))
            return engine

        patch(engine_mod.ServingEngine, "from_config",
              classmethod(recording_from_config))
        # Prompts of 32-128 tokens: those past the 64-position chunk take
        # the chunked prefill (B6), the rest the local one.
        serve_args = ["serve", "--checkpoint-dir", ckpt, "--num-requests",
                      str(TEXT_SERVE_REQUESTS), "--max-new-tokens", "32",
                      "--prompt-len", "64"]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        greedy_out = run_cli(serve_args + ["--temperature", "0"], out)
        seconds["serve_greedy"] = time.perf_counter() - t
        serve_launches = ops.launch_counts()
        engine, e_args, e_kw = engines[0]
        summary = engine.metrics_summary()
        if f"restored step {TEXT_STEPS} from {ckpt}" not in greedy_out:
            raise AssertionError("text: serve did not restore the "
                                 "checkpoint")
        if summary["requests_completed"] != TEXT_SERVE_REQUESTS or \
                summary["prefill_chunks"] == 0:
            raise AssertionError(f"text: serve summary {summary}")
        serve_want = {
            "paged_attention": cfg.n_layer * summary["decode_ticks"],
            "paged_prefill_attention": cfg.n_layer
            * summary["prefill_chunks"]}
        expect_launches_equal(serve_launches, serve_want, "text serve")
        if serve_launches["logit_trust_stats"] == 0:
            raise AssertionError("text: B7 never launched")
        for name, n in serve_launches.items():
            if name in ("paged_attention", "paged_prefill_attention",
                        "logit_trust_stats"):
                key = {"paged_attention": "paged_decode_attention"}.get(
                    name, name)
                entries[key]["launches_text"] = n
        for a, b in zip(tree_leaves(served_params[0]), tree_leaves(final),
                        strict=True):
            if not torch.equal(a.to(b.device), b):
                raise AssertionError("text: restored params differ from "
                                     "the trainer's final params")
        greedy_requests = list(submitted)
        cli_streams = [engine.results[rid].tokens
                       for rid in sorted(engine.results)]
        in_process = from_config.__func__(engine_mod.ServingEngine, final,
                                          *e_args, **e_kw)
        for request in greedy_requests:
            in_process.submit(request)
        ref = in_process.run_until_idle()
        ref_streams = [ref[rid].tokens for rid in sorted(ref)]
        if cli_streams != ref_streams:
            raise AssertionError("text: cli serve's greedy streams differ "
                                 "from the in-process engine's")
        del in_process, ref
        engines.clear()
        submitted.clear()
        t = time.perf_counter()
        sampled_out = run_cli(serve_args + ["--temperature", "0.8"], out)
        seconds["serve_sampled"] = time.perf_counter() - t
        sampled_summary = engines[0][0].metrics_summary()
        if f"restored step {TEXT_STEPS}" not in sampled_out or \
                sampled_summary["requests_completed"] != TEXT_SERVE_REQUESTS:
            raise AssertionError(f"text: sampled serve {sampled_summary}")
        engines.clear()
        served_params.clear()
        gates += ["serve_restored", "b5_b6_exact_b7_launched",
                  "restored_params_bitwise", "greedy_streams_in_process"]
        for owner, name, value in reversed(patched):
            setattr(owner, name, value)
        patched.clear()

        # -- 5. generate --prompt-text -------------------------------------------
        draws = []
        sample_fn = gen_mod._sample

        def recording_sample(logits, temperature, top_k=0, top_p=1.0,
                             generator=None):
            token = sample_fn(logits, temperature, top_k, top_p, generator)
            draws.append((logits.float().cpu(), token.cpu(), temperature,
                          top_k, top_p))
            return token

        patch(gen_mod, "_sample", recording_sample)
        gen_args = ["generate", "--checkpoint-dir", ckpt, "--prompt-text",
                    TEXT_PROMPT, "--tokenizer-dir",
                    os.path.join(root, "tokenizer")]
        runs = {}
        for label, extra in (("top_k_40", []), ("top_p_0.9", ["--top-p",
                                                                "0.9"]),
                             ("top_k_1", ["--top-k", "1"]),
                             ("greedy", ["--temperature", "0"])):
            draws.clear()
            t = time.perf_counter()
            printed = run_cli(gen_args + extra, out)
            seconds[f"generate_{label}"] = time.perf_counter() - t
            if f"restored step {TEXT_STEPS}" not in printed:
                raise AssertionError(f"text: generate {label} did not "
                                     "restore the checkpoint")
            kept, tokens = 0, []
            for logits, token, temp, k, p in draws:
                tokens.append(int(token[0]))
                if temp <= 0:
                    if int(token[0]) != int(logits.argmax(dim=-1)[0]):
                        raise AssertionError("text: greedy not argmax")
                    continue
                keep = torch.isfinite(gen_mod._filter_logits(
                    logits / max(temp, 1e-6), k, p))
                if not bool(keep.gather(1, token[:, None].long()).all()):
                    raise AssertionError(f"text: generate {label} drew "
                                         "outside its keep-set")
                kept = max(kept, int(keep.sum()))
            text_line = [ln for ln in printed.splitlines()
                         if ln.startswith("generated:")]
            if len(tokens) != 32 or not text_line:
                raise AssertionError(f"text: generate {label} printed "
                                     f"{printed[-500:]}")
            runs[label] = {"tokens": tokens, "largest_keep_set": kept,
                           "text": text_line[0][len("generated:"):].strip(),
                           "replacement_chars":
                               text_line[0].count("�")}
        if runs["top_k_1"]["tokens"] != runs["greedy"]["tokens"]:
            raise AssertionError("text: --top-k 1 differs from greedy")
        gates += ["draws_in_keep_sets", "top_k_1_is_greedy",
                  "text_printed"]
        for owner, name, value in reversed(patched):
            setattr(owner, name, value)
        patched.clear()
        emit({"phase": "text", "card": card,
              "seconds": time.perf_counter() - t_phase,
              "step_seconds": seconds,
              "corpus": corpus_info, "pretokenizer": tok_mod.PRETOKENIZER,
              "tokens": len(ids), "validation_tokens": holdout,
              "vocab": tok.vocab_size, **bpe,
              "encode_tokens_per_s": len(ids) / bpe["encode_s"],
              "config": yaml_state,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16 over f32 master "
                       "weights, random init seed 0)",
              "nodes": TRAIN_NODES, "batch": TRAIN_BATCH,
              "seq_len": TRAIN_T, "steps": TEXT_STEPS,
              "train_loss": losses, "train_batch_max_id": batch_max,
              "train_launches": {k: launches[k] for k in want},
              "trace_events": len(events),
              "trace_kernel_events": device_events,
              "trace_bytes": os.path.getsize(traces[0]),
              "serve": {k: summary.get(k) for k in (
                  "tokens_per_s", "decode_ticks", "prefill_chunks",
                  "ttft_p50_ms", "itl_p50_ms", "requests_flagged")},
              "serve_launches": {k: serve_launches[k] for k in (
                  "paged_attention", "paged_prefill_attention",
                  "logit_trust_stats")},
              "serve_sampled_tokens_per_s": sampled_summary["tokens_per_s"],
              "generate": runs, "gates": gates})
        return text, tok
    finally:
        for owner, name, value in reversed(patched):
            setattr(owner, name, value)
        shutil.rmtree(root, ignore_errors=True)


def best_ms(fn, reps=5):
    """Least host ms of ``reps`` calls of ``fn`` (host code: no card)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def warm_cache(directory):
    """One fresh process warming the kernel-build cache ``directory``
    (``python -m trustworthy_dl_tpu_torch.utils.compile_cache``): its
    compile events by stage, their seconds and the process's wall."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "trustworthy_dl_tpu_torch.utils.compile_cache",
         directory], cwd=here, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"host_tier: warming {directory} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    record["process_s"] = time.perf_counter() - t0
    return record


def host_tier_drive(card, text, tok):
    """Phase 12b: the C++ host tier (``native/``) at the train geometry and
    on the text phase's corpus, then the kernel-build cache
    (``utils/compile_cache.py``) in two fresh processes."""
    import numpy as np

    from trustworthy_dl_tpu_torch import native, ops
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.data import tokenizer as tok_mod

    t_phase = time.perf_counter()
    gates = []

    def same(what, got, want):
        for g, w in (zip(got, want) if isinstance(got, tuple)
                     else [(got, want)]):
            if g.dtype != w.dtype or g.shape != w.shape or \
                    not np.array_equal(g, w):
                raise AssertionError(f"host_tier: {what} differs from its "
                                     "numpy twin")
        gates.append(f"{what}_bit_equal")

    # -- 1. the C entries against their numpy twins, at the train geometry
    n = TRAIN_BATCH * ON_STEPS            # the train phase's windows
    stream_len = n * (TRAIN_T + 1) + 1    # its synthetic stream
    ms = {}
    stream = native.synthetic_tokens(stream_len, 512, 0)
    same("synthetic_tokens", stream,
         native.synthetic_tokens_plain(stream_len, 512, 0))
    ms["synthetic_tokens"] = best_ms(
        lambda: native.synthetic_tokens(stream_len, 512, 0))
    ms["synthetic_tokens_plain"] = best_ms(
        lambda: native.synthetic_tokens_plain(stream_len, 512, 0), 1)
    loader = get_dataloader("openwebtext", batch_size=TRAIN_BATCH,
                            seq_len=TRAIN_T, vocab_size=50257,
                            num_examples=n, seed=0)
    rows = loader.inputs
    perm = native.permutation(0, len(rows))
    same("permutation", perm, native.permutation_plain(0, len(rows)))
    ms["permutation"] = best_ms(lambda: native.permutation(0, len(rows)))
    ms["permutation_plain"] = best_ms(
        lambda: native.permutation_plain(0, len(rows)))
    sel = perm[:TRAIN_BATCH]              # 4 nodes x 8 rows of 1024
    same("gather_rows", native.gather_rows(rows, sel),
         native.gather_rows_plain(rows, sel))
    ms["gather_rows"] = best_ms(lambda: native.gather_rows(rows, sel), 25)
    ms["gather_rows_plain"] = best_ms(
        lambda: native.gather_rows_plain(rows, sel), 25)
    same("window_gather", native.window_gather(stream, TRAIN_T,
                                               TRAIN_BATCH, 7),
         native.window_gather_plain(stream, TRAIN_T, TRAIN_BATCH, 7))
    ms["window_gather"] = best_ms(
        lambda: native.window_gather(stream, TRAIN_T, TRAIN_BATCH, 7), 25)
    ms["window_gather_plain"] = best_ms(
        lambda: native.window_gather_plain(stream, TRAIN_T, TRAIN_BATCH, 7),
        25)
    t0 = time.perf_counter()
    batches = sum(1 for _ in loader)
    loader_ms = (time.perf_counter() - t0) * 1e3 / batches

    # -- 2. the text phase's corpus through both encoders ----------------
    merges = [m for m, _ in sorted(tok.ranks.items(), key=lambda kv: kv[1])]
    encode = {}
    for label, method in (("batch_cpp", "encode"),
                          ("python_loop", "encode_plain")):
        fresh = tok_mod.BPETokenizer(tok.vocab, merges)   # empty word cache
        t0 = time.perf_counter()
        ids = getattr(fresh, method)(text)
        seconds = time.perf_counter() - t0
        encode[label] = {"seconds": seconds, "tokens": len(ids),
                         "tokens_per_s": len(ids) / seconds, "ids": ids}
    if encode["batch_cpp"].pop("ids") != encode["python_loop"].pop("ids"):
        raise AssertionError("host_tier: the batch encoder's ids differ "
                             "from the Python loop's")
    gates.append("encoders_equal")

    # -- 3. the kernel-build cache in two fresh processes ------------------
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="kernel_cache_", dir=build)
    try:
        first, second = warm_cache(cache), warm_cache(cache)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    kernels = sorted(ops.SIGNATURES)
    if sorted(first["events"].get("nvcc_build", [])) != kernels or \
            first["events"].get("gxx_build") != ["tddl_native"]:
        raise AssertionError(f"host_tier: the first process built "
                             f"{first['events']}")
    if set(second["events"]) != {"library_load"} or \
            sorted(second["events"]["library_load"]) != \
            sorted(kernels + ["tddl_native"]):
        raise AssertionError(f"host_tier: the second process over the warm "
                             f"cache recorded {second['events']}")
    gates += ["first_process_builds_all", "second_process_only_loads"]

    def cache_line(record):
        return {"events": record["events"], "seconds": record["seconds"],
                "process_s": record["process_s"],
                "event_seconds": record["event_seconds"]}

    emit({"phase": "host_tier", "card": card,
          "seconds": time.perf_counter() - t_phase,
          "native": {"gxx_build_s":
                     first["event_seconds"]["gxx_build:tddl_native"],
                     "geometry": {"rows": int(len(rows)), "seq_len": TRAIN_T,
                                  "batch": TRAIN_BATCH,
                                  "stream_tokens": stream_len},
                     "host_ms": ms, "loader_ms_per_batch": loader_ms,
                     "loader_batches": batches},
          "encode": {"corpus_bytes": len(text.encode()),
                     "pretokenizer": tok_mod.PRETOKENIZER, **encode},
          "cache": {"first": cache_line(first),
                    "second": cache_line(second)},
          "gates": gates})


def trace_files(path):
    """The trace file and its rotated segments."""
    from trustworthy_dl_tpu_torch.obs.events import rotated_segments

    return [p for p, _ in rotated_segments(path)] + [path]


def emit_cost_us():
    """Host microseconds a trace bus takes per ``serve_retire`` emit into a
    JSONL file, a flight recorder and the events counter, and per span
    recorded through it."""
    from trustworthy_dl_tpu_torch.obs import EventType, FlightRecorder, \
        MetricsRegistry, SpanTracker, TraceBus

    root = tempfile.mkdtemp(prefix="tddl_emit_")
    try:
        bus = TraceBus(os.path.join(root, "trace.jsonl"),
                       recorder=FlightRecorder(), registry=MetricsRegistry())
        spans = SpanTracker(trace=bus)
        t0 = time.perf_counter()
        for i in range(OBS_EMITS):
            bus.emit(EventType.SERVE_RETIRE, request_id=i,
                     status="completed", tokens=32, flagged=False,
                     monitor_z=0.5)
        t1 = time.perf_counter()
        for i in range(OBS_EMITS):
            spans.add("serve.decode_tick", t1, t1 + 1e-3, kind="serve",
                      tokens=8, active=8)
        t2 = time.perf_counter()
        bus.close()
        return {"event_us": 1e6 * (t1 - t0) / OBS_EMITS,
                "span_us": 1e6 * (t2 - t1) / OBS_EMITS,
                "bytes_per_event": os.path.getsize(
                    os.path.join(root, "trace.jsonl")) / (2 * OBS_EMITS)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_trace(root):
    """Every event of ``root``'s trace validates; returns them."""
    from trustworthy_dl_tpu_torch.obs import read_jsonl_rotated
    from trustworthy_dl_tpu_torch.obs.events import validate_event

    events = read_jsonl_rotated(os.path.join(root, "trace.jsonl"))
    for event in events:
        validate_event(event)
    return events


def obs_open_loop(torch, root, params, cfg, requests, ref_results):
    """The traffic queued whole up front, as ``cli serve`` submits it,
    under a session with the default watchers, which may shed queued
    requests while an SLO rule burns or an anomaly episode is open.  Every
    request must end completed or shed, each with its attribution record;
    the completed greedy streams follow the bare arm's by the near-tie
    rule."""
    from trustworthy_dl_tpu_torch.obs import token_hash
    from trustworthy_dl_tpu_torch.utils.obs_ab import serve_session
    from trustworthy_dl_tpu_torch.utils.serve_profile import drive_smoke, \
        smoke_engine

    session = serve_session(
        root, perf_ledger=os.path.join(root, "PERF_LEDGER.jsonl"),
        verdict_path=os.path.join(root, "VERDICTS.jsonl"))
    engine = smoke_engine(cfg, params, "kernel", obs=session)
    results, wall = drive_smoke(engine, requests)
    summary = engine.metrics_summary()
    status = {rid: r.status for rid, r in results.items()}
    shed = sorted(rid for rid, s in status.items() if s == "shed_slo")
    done = {rid for rid, s in status.items() if s == "completed"}
    if sorted(status) != list(range(len(requests))) or \
            len(done) + len(shed) != len(requests) or \
            summary["requests_shed_slo"] != len(shed):
        raise AssertionError(f"obs open loop: statuses {status}, summary "
                             f"shed {summary['requests_shed_slo']}")
    check_completed({rid: results[rid] for rid in done},
                    [requests[rid] for rid in done])
    greedy = compare_greedy(requests, results, ref_results,
                            "obs open loop", only=done) \
        if any(requests[rid][1] == 0.0 for rid in done) else {}
    records = session.ledger.records()
    verdict = engine.verify_attribution()
    if sorted(r["request_id"] for r in records) != sorted(status) or \
            verdict != (True, []) or any(
                r["admitted"] != (r["request_id"] in done) or
                r["token_hash"] != token_hash(results[r["request_id"]]
                                              .tokens) for r in records):
        raise AssertionError(f"obs open loop: {len(records)} records, "
                             f"verification {verdict}")
    session.finalize()
    check_trace(root)
    tokens = sum(len(r.tokens) for r in results.values())
    return {"requests": len(requests), "completed": len(done),
            "shed_slo": len(shed), "shed_request_ids": shed,
            "anomaly_events": session.anomaly.event_total,
            "slo_breaches": session.slo.breach_total,
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_p50_ms": summary.get("ttft_p50_ms"),
            "itl_p50_ms": summary.get("itl_p50_ms"),
            "itl_p99_ms": summary.get("itl_p99_ms"), **greedy}


def run_obs_cli(args):
    """``python -m trustworthy_dl_tpu_torch.cli obs ARGS`` in a process of
    its own; returns its standard output (a failure raises)."""
    proc = subprocess.run(
        [sys.executable, "-m", "trustworthy_dl_tpu_torch.cli", "obs",
         *args], capture_output=True, text=True, timeout=120,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"cli obs {args}: rc {proc.returncode}\n"
                             f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout


def obs_forced_storm(torch, root, params, cfg, requests, ref_results):
    """Phase 13, the compile watch's contract: the smoke traffic under a
    session as ``cli serve --obs-dir`` opens it, with the paged-attention
    library dropped from the loaded set inside the third guarded decode,
    so that its wrapper's next launch loads it again through
    ``ops.kernel_library`` (the hook the watch listens to) after warmup.
    One load, one storm episode, one flight dump and its incident; the
    session shares the serve arm's temporary perf ledger."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.serve import scheduler
    from trustworthy_dl_tpu_torch.utils.obs_ab import serve_session
    from trustworthy_dl_tpu_torch.utils.serve_profile import \
        drive_closed_loop, smoke_engine

    storm_dir = os.path.join(root, "storm")
    session = serve_session(
        storm_dir, perf_ledger=os.path.join(root, "PERF_LEDGER.jsonl"),
        verdict_path=os.path.join(storm_dir, "VERDICTS.jsonl"))
    real = scheduler._paged_decode_impl
    calls = []

    def decode(*args, **kwargs):
        calls.append(1)
        if len(calls) == FORCED_STORM_DECODE:
            # The loaded set's entry only: the next kernel_library call
            # loads the built library again and reports it.
            ops._LIBS.pop("paged_attention")
        return real(*args, **kwargs)

    scheduler._paged_decode_impl = decode
    try:
        engine = smoke_engine(cfg, params, "kernel", obs=session)
        results, _ = drive_closed_loop(engine, requests)
    finally:
        scheduler._paged_decode_impl = real
    for rid, ref in ref_results.items():
        if results[rid].tokens != ref.tokens:
            raise AssertionError(f"obs storm: request {rid} differs")
    compiles = session.compiles.summary()
    watch = session.compilewatch
    engine.analyze_programs(session.cost_ledger)
    session.finalize()
    names = sorted(os.listdir(storm_dir))
    dumps = [n for n in names if n.startswith("flight_")
             and "_compile_storm" in n]
    incidents = [n for n in names if n.startswith("incident_")
                 and n.endswith("_compile_storm.json")]
    if compiles["total"] != 1 or watch.storm_total != 1 or \
            watch.status()["serve_decode"]["storms"] != 1 or \
            len(dumps) != 1 or len(incidents) != 1 or \
            dumps[0].split("_")[1] != incidents[0].split("_")[1]:
        raise AssertionError(f"obs storm: compiles {compiles}, watch "
                             f"{watch.status()}, files {names}")
    listing = run_obs_cli(["incident", "list", "--dir", storm_dir])
    if incidents[0][:-len(".json")] not in listing:
        raise AssertionError(f"obs storm: cli obs lists {listing!r}")
    diff = run_obs_cli(["diff", os.path.join(root, "serve"), storm_dir])
    return {"decodes": len(calls), "compiles": compiles,
            "load_s": compiles["by_stage"]["library_load"]["seconds"],
            "storms": watch.storm_total, "status": watch.status(),
            "flight_dumps": dumps, "incidents": incidents,
            "cli_incident_list": listing.strip().splitlines(),
            "perf_verdict": session.perf_verdict,
            "cli_obs_diff": diff.strip().splitlines()}


def obs_serve(torch, root, params, cfg):
    """Phase 13, serving: the bare arm and the arm under a session, both
    closed-loop; the traffic open-loop under a session; and the HBM gate's
    shrunk engine."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.obs import ObsSession, token_hash
    from trustworthy_dl_tpu_torch.serve.kv_slots import kv_bytes_per_token
    from trustworthy_dl_tpu_torch.utils.obs_ab import serve_session
    from trustworthy_dl_tpu_torch.utils.serve_profile import \
        drive_closed_loop, smoke_engine, smoke_traffic

    requests = smoke_traffic(cfg.vocab_size)
    kernels = ("paged_attention", "paged_prefill_attention",
               "logit_trust_stats")
    # One request first, so that neither arm pays the first engine's
    # warm-up.
    drive_closed_loop(smoke_engine(cfg, params, "kernel"),
                      requests[:1])
    arms = {}
    session = None
    for arm in ("off", "on"):
        if arm == "on":
            session = serve_session(
                os.path.join(root, "serve"),
                perf_ledger=os.path.join(root, "PERF_LEDGER.jsonl"),
                verdict_path=os.path.join(root, "serve", "VERDICTS.jsonl"))
        engine = smoke_engine(cfg, params, "kernel", obs=session)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        results, wall = drive_closed_loop(engine, requests)
        counts = ops.launch_counts()
        launches = {name: counts.pop(name) for name in kernels}
        if any(counts.values()) or min(launches.values()) == 0:
            raise AssertionError(f"obs serve {arm}: launches {launches}, "
                                 f"off this path {counts}")
        check_completed(results, requests)
        tokens = sum(len(r.tokens) for r in results.values())
        arms[arm] = {"engine": engine, "results": results, "wall": wall,
                     "launches": launches, "tokens": tokens,
                     "summary": engine.metrics_summary()}
    off, on = arms["off"], arms["on"]
    for rid, ref in off["results"].items():
        got = on["results"][rid]
        if (got.tokens, got.entropies, got.margins) != \
                (ref.tokens, ref.entropies, ref.margins):
            raise AssertionError(f"obs serve: request {rid} differs under "
                                 "the session")
    if on["launches"] != off["launches"]:
        raise AssertionError(f"obs serve: launches {on['launches']} under "
                             f"the session, {off['launches']} bare")
    engine = on["engine"]
    records = session.ledger.records()
    verdict = engine.verify_attribution()
    if len(records) != len(requests) or verdict != (True, []) or any(
            rec["token_hash"] != token_hash(on["results"][rec["request_id"]]
                                            .tokens) for rec in records):
        raise AssertionError(f"obs serve: {len(records)} records, "
                             f"verification {verdict}")
    if on["summary"]["requests_shed_slo"]:
        raise AssertionError(f"obs serve: {on['summary']}")
    watch = session.compilewatch.status().get("serve_decode", {})
    if session.compiles.total or session.compilewatch.storm_total or \
            watch.get("calls", 0) < 2:
        raise AssertionError(f"obs serve: compiles "
                             f"{session.compiles.summary()}, watch "
                             f"{session.compilewatch.status()}")
    engine.analyze_programs(session.cost_ledger)
    session.finalize()
    path = os.path.join(root, "serve", "trace.jsonl")
    events = check_trace(os.path.join(root, "serve"))
    with open(os.path.join(root, "serve", "trace_events.json")) as f:
        chrome = json.load(f)["traceEvents"]
    roots = sorted(e["tid"] for e in chrome if e["name"] == "serve.request")
    if roots != sorted(on["results"]):
        raise AssertionError(f"obs serve: serve.request spans for {roots}")
    with open(os.path.join(root, "serve", "metrics.prom")) as f:
        prom = f.read().splitlines()
    if f"tddl_serve_tokens_total {float(on['tokens'])!r}" not in prom:
        raise AssertionError("obs serve: tddl_serve_tokens_total is not "
                             f"the {on['tokens']} tokens emitted")
    by_type = {}
    for event in events:
        by_type[event["type"]] = by_type.get(event["type"], 0) + 1
    serve = {
        "requests": len(requests), "tokens": on["tokens"],
        "tokens_per_s_off": off["tokens"] / off["wall"],
        "tokens_per_s_on": on["tokens"] / on["wall"],
        "on_over_off": off["wall"] / on["wall"],
        "wall_s_off": off["wall"], "wall_s_on": on["wall"],
        "launches": on["launches"], "events": len(events),
        "events_by_type": by_type,
        "trace_bytes": sum(os.path.getsize(p) for p in trace_files(path)),
        "ledger_bytes": os.path.getsize(os.path.join(root, "serve",
                                                     "attribution.jsonl")),
        "anomaly_events": session.anomaly.event_total,
        "slo_breaches": session.slo.breach_total,
        "ttft_p50_ms": on["summary"].get("ttft_p50_ms"),
        "itl_p50_ms": on["summary"].get("itl_p50_ms"),
        "itl_p99_ms": on["summary"].get("itl_p99_ms"),
        "emit_cost": emit_cost_us(),
        "compile_watch": {"compiles": session.compiles.summary(),
                          "status": session.compilewatch.status(),
                          "storms": session.compilewatch.storm_total},
        "cost_ledger": session.cost_ledger.to_dict()}
    del engine
    serve["open_loop"] = obs_open_loop(
        torch, os.path.join(root, "open"), params, cfg, requests,
        off["results"])
    serve["forced_storm"] = obs_forced_storm(
        torch, root, params, cfg, requests, off["results"])
    del arms

    # The HBM gate: a budget of the allocated bytes plus half the pool's.
    gc.collect()
    torch.cuda.empty_cache()
    block, bpt = 16, kv_bytes_per_token(cfg)
    requested = 8 * (512 // block) * block * bpt
    budget = torch.cuda.memory_allocated() + requested // 2
    hsession = ObsSession(None)
    monitor = hsession.enable_hbm(budget_bytes=budget)
    small = smoke_engine(cfg, params, "kernel", obs=hsession)
    want = max(monitor.last_headroom // (block * bpt), 512 // block)
    got = small.scheduler.num_blocks
    pressure = [e for e in hsession.recorder.events()
                if e["type"] == "hbm_pressure"]
    counter = hsession.registry.get("tddl_hbm_pressure_total").value()
    if got != want or not got < requested // (block * bpt) or \
            len(pressure) != 1 or counter != 1.0:
        raise AssertionError(f"obs hbm: {got} blocks (the gate computed "
                             f"{want}), {len(pressure)} pressure events, "
                             f"counter {counter}")
    shrunk, _ = drive_closed_loop(small, requests[:4])
    for rid, res in shrunk.items():
        if res.tokens != off["results"][rid].tokens:
            raise AssertionError(f"obs hbm: request {rid} differs on the "
                                 "shrunk pool")
    sweep = monitor.sweep(emit=True)
    pool = small.scheduler.kv.pool_bytes
    peak = torch.cuda.max_memory_allocated()
    if not pool <= monitor.watermark_bytes <= peak:
        raise AssertionError(f"obs hbm: watermark {monitor.watermark_bytes}"
                             f" outside [{pool}, {peak}]")
    hbm = {"requested_bytes": requested, "budget_bytes": budget,
           "headroom_bytes": monitor.last_headroom,
           "blocks_requested": requested // (block * bpt),
           "blocks_granted": got, "pool_bytes": pool,
           "watermark_bytes": monitor.watermark_bytes,
           "live_bytes": sweep["total_bytes"],
           "max_memory_allocated": peak}
    del small
    return serve, hbm


def obs_train(torch, root):
    """Phase 13, training: the supervised GRAD_NAN run bare and under a
    session, from the same state."""
    import dataclasses

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
        FaultKind, FaultPlan
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
    from trustworthy_dl_tpu_torch.engine.supervisor import \
        TrainingSupervisor
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.obs import PHASES, ObsSession, \
        read_jsonl_rotated
    from trustworthy_dl_tpu_torch.obs.events import validate_event
    from trustworthy_dl_tpu_torch.obs.hbm import count_flops

    cfg = gpt2_small(torch)
    tr = DistributedTrainer(TrainingConfig(
        model_name="gpt2", batch_size=TRAIN_BATCH, num_nodes=TRAIN_NODES,
        optimizer="adamw", learning_rate=1e-4, remat=True, seed=0,
        detector_warmup=2, async_host_depth=0, checkpoint_interval=1000),
        model_overrides=dict(seq_len=TRAIN_T, attn_impl="auto"),
        device="cuda")
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=OBS_ATTACK))
    attacker.activate_attacks()
    arms = {}
    session = None
    for arm in ("off", "on"):
        ckpt = os.path.join(root, f"ckpt_{arm}")
        tr.config = dataclasses.replace(tr.config, checkpoint_dir=ckpt)
        tr.checkpointer = CheckpointManager(ckpt)
        tr.reset_for_run(0)
        tr.set_attack_plan(attacker.plan(TRAIN_NODES))
        if arm == "on":
            train_dir = os.path.join(root, "train")
            session = ObsSession(train_dir, perf_ledger=os.path.join(
                train_dir, "PERF_LEDGER.jsonl"))
            session.enable_spans()
            session.install_watchers(slo_rules=())
            session.enable_forensics(
                verdict_path=os.path.join(train_dir, "VERDICTS.jsonl"))
            session.enable_compile_watch()
            session.enable_hbm()
        sup = TrainingSupervisor(
            tr, max_retries=DRILL_RETRIES, rollback_after=1, max_restarts=0,
            chaos=FaultInjector(FaultPlan.scripted([FaultEvent(
                step=OBS_NAN_STEP, kind=FaultKind.GRAD_NAN)])), obs=session)
        loader = get_dataloader("openwebtext", batch_size=TRAIN_BATCH,
                                seq_len=TRAIN_T, vocab_size=cfg.vocab_size,
                                num_examples=TRAIN_BATCH * OBS_STEPS, seed=0)
        statuses = record_status(tr)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = sup.run(loader, num_epochs=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        del tr._record_batch
        hist = tr.batch_history
        arms[arm] = {
            "wall": wall, "launches": launches,
            "report": result["supervisor"],
            "step_s": [h["step_s"] for h in hist],
            "trajectory": {
                "loss": [h["loss"] for h in hist],
                "per_node_loss": [h["per_node_loss"] for h in hist],
                "trust": [h["trust_scores"] for h in hist],
                "weights": [h["weights"] for h in hist],
                "status": statuses,
                "incidents": [(r["node_id"], r["step"], r["attack_type"])
                              for r in tr.attack_history]}}
    off, on = arms["off"], arms["on"]
    if on["trajectory"] != off["trajectory"]:
        raise AssertionError("obs train: the trajectory moved under the "
                             f"session: {on['trajectory']} vs "
                             f"{off['trajectory']}")
    accounted = len(on["trajectory"]["loss"])
    executions = accounted + 1 + DRILL_RETRIES
    want = step_launches(cfg, [TRAIN_NODES] * executions)
    for arm in arms.values():
        expect_launches_equal(arm["launches"], want, "obs train")
    lagless = {"retries": DRILL_RETRIES, "rollbacks": 1,
               "rollback_steps": [0], "bad_steps": 1}
    if accounted != OBS_NAN_STEP or \
            {k: on["report"][k] for k in lagless} != lagless or \
            not off["trajectory"]["incidents"]:
        raise AssertionError(f"obs train: {accounted} accounted steps, "
                             f"report {on['report']}, incidents "
                             f"{off['trajectory']['incidents']}")
    session.finalize()
    events = read_jsonl_rotated(os.path.join(root, "train", "trace.jsonl"))
    for event in events:
        validate_event(event)
    by_type = {}
    for event in events:
        by_type[event["type"]] = by_type.get(event["type"], 0) + 1
    verdicts = [e["node"] for e in events
                if e["type"] == "detection_verdict"]
    needed = ("guard_trip", "supervisor_retry", "chaos_fault",
              "ckpt_commit", "supervisor_rollback")
    if by_type.get("train_step") != accounted or verdicts != [2] or \
            not all(by_type.get(t) for t in needed):
        raise AssertionError(f"obs train: events {by_type}, verdicts "
                             f"{verdicts}")
    ckpt_files = os.listdir(os.path.join(root, "ckpt_on"))
    dumps = sorted(n for n in ckpt_files if n.startswith("flight_"))
    paired = sorted(n for n in ckpt_files if n.startswith("incident_"))
    if not dumps or [d.split("_")[1] for d in dumps] != \
            [i.split("_")[1] for i in paired]:
        raise AssertionError(f"obs train: flight dumps {dumps}, incidents "
                             f"{paired} beside the checkpoints")
    if session.compilewatch.storm_total:
        raise AssertionError(f"obs train: compile storms "
                             f"{session.compilewatch.status()}")
    with open(os.path.join(root, "train", "obs_report.json")) as f:
        report = json.load(f)
    mean = report["step_time_s"]["mean"]
    wall_per_step = statistics.mean(on["step_s"])
    fractions = {k: v["fraction"] for k, v in report["phases"].items()}
    if report["num_steps"] != accounted or not set(fractions) <= \
            set(PHASES) or abs(sum(fractions.values()) - 1.0) > 1e-6 or \
            abs(mean - wall_per_step) > OBS_STEP_RTOL * wall_per_step or \
            not report["mfu"]["peak_flops_source"].startswith(
                "bf16-peak-table:h100"):
        raise AssertionError(f"obs train: report {report}, wall per step "
                             f"{wall_per_step}")
    analyzed = report.get("mfu_analyzed") or {}
    cost = report.get("cost_ledger", {}).get("train_step", {})
    kernels = cost.get("kernel_flops", {})
    counted = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    if not 0.0 < (analyzed.get("mfu") or 0.0) < 1.0 or \
            analyzed.get("flops_per_step") != cost.get("flops") or \
            set(kernels) != {"fused_moments", *counted} or \
            kernels["fused_moments"] != 0 or \
            not all(kernels[k] > 0 for k in counted) or \
            cost.get("library_flops", 0) <= 0:
        raise AssertionError(f"obs train: mfu_analyzed {analyzed}, cost "
                             f"ledger {cost}")
    # The fused head's f32-out product (``aten::mm.dtype``) is counted by
    # the library counter itself, on this card's torch.
    with count_flops() as head:
        torch.mm(torch.ones(64, 768, dtype=torch.bfloat16, device="cuda"),
                 torch.ones(768, 512, dtype=torch.bfloat16, device="cuda"),
                 out_dtype=torch.float32)
    if head["library_flops"] != 2 * 64 * 768 * 512:
        raise AssertionError(f"obs train: the f32-out product counted "
                             f"{head}")
    train = {"steps_accounted": accounted, "step_executions": executions,
             "wall_s_off": off["wall"], "wall_s_on": on["wall"],
             "step_s_mean_off": statistics.mean(off["step_s"]),
             "step_s_mean_on": wall_per_step,
             "report_step_s": report["step_time_s"],
             "wall_per_step_s": wall_per_step,
             "phase_fractions": fractions,
             "phase_mean_s": {k: v["mean_s"]
                              for k, v in report["phases"].items()},
             "mfu": report["mfu"], "mfu_analyzed": analyzed,
             "cost_ledger": cost,
             "mm_dtype_flops": head["library_flops"],
             "counted_step_s": on["step_s"][0],
             "step2_s": on["step_s"][1],
             "first_step_s_off": off["step_s"][0],
             "step2_s_off": off["step_s"][1],
             "flight_incidents": paired,
             "compile_watch": session.compilewatch.status(),
             "events": len(events),
             "events_by_type": by_type, "flight_dumps": dumps,
             "launches": on["launches"], "expected_launches": want,
             "supervisor": on["report"],
             "incidents": off["trajectory"]["incidents"]}
    del tr, sup
    return train


def obs_drive(torch, entries, card):
    """Phase 13: the telemetry plane through serving, the HBM gate and
    supervised training."""
    from trustworthy_dl_tpu_torch.models import gpt2

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="tddl_obs_")
    try:
        cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = gpt2.init_params(cfg, gen, device="cuda")
        serve, hbm = obs_serve(torch, root, params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        train = obs_train(torch, root)
        for name, n in {**serve["launches"], **train["launches"]}.items():
            key = {"paged_attention": "paged_decode_attention"}.get(name,
                                                                    name)
            if key in entries and n:
                entries[key]["launches_obs"] = n
        emit({"phase": "obs", "card": card,
              "seconds": time.perf_counter() - t0,
              "model": "gpt2 (12L, 768, 12H, V50257, bf16; training over "
                       "f32 master weights; random init seed 0)",
              "serve": serve, "hbm": hbm, "train": train})
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    card = one_card()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from trustworthy_dl_tpu_torch import ops
        from trustworthy_dl_tpu_torch.ops import paged_attention as pa
    except ImportError as exc:
        print(f"chip_smoke: run from the repo root ({exc})", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible, "
              "want 1", file=sys.stderr)
        return 1
    smi = nvidia_smi_line(card)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    built = ops.build()
    from trustworthy_dl_tpu_torch import native

    gxx = native.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built, "gxx_seconds": gxx})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(torch, pa)
    check_train_kernels(torch, entries)
    emit({"phase": "kernel_checks", "ok": True})
    base_results = serve_drive(torch, pa, entries, smi)
    tier_results = serve_tiers_drive(torch, entries, smi)
    serve_d96_drive(torch, entries, smi)
    serve_adapters_drive(torch, entries, smi, base_results)
    serve_stripe_drive(torch, entries, smi, base_results, tier_results)
    serve_migrate_drive(torch, entries, smi, base_results, tier_results)
    serve_chaos_drive(torch, entries, smi)
    serve_fleet_drive(torch, entries, smi, base_results)
    serve_fleet_control_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    serve_adversary_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    del tier_results
    on, loader = train_drive(torch, entries, smi)
    flash_vs_full(torch, on, loader, smi)
    del on
    torch.cuda.empty_cache()
    moe_drive(torch, entries, smi)
    gc.collect()
    torch.cuda.empty_cache()
    envelope_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    train_fused_ce(torch, entries, smi)
    torch.cuda.empty_cache()
    experiment_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    survival_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    async_host_drive(torch, entries, smi)
    elastic_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    pipeline_drive(torch, entries, smi)
    gc.collect()
    torch.cuda.empty_cache()
    sequence_drive(torch, entries, smi)
    gc.collect()
    torch.cuda.empty_cache()
    group_modes_drive(torch, entries, smi)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp_drive(torch, entries, smi, base_results)
    gc.collect()
    torch.cuda.empty_cache()
    multihost_drive(torch, entries, card, smi)
    gc.collect()
    torch.cuda.empty_cache()
    vision_drive(torch, entries, smi)
    torch.cuda.empty_cache()
    text, tok = text_drive(torch, entries, smi)
    host_tier_drive(smi, text, tok)
    del text, tok
    gc.collect()
    torch.cuda.empty_cache()
    obs_drive(torch, entries, smi)
    emit({"kernels": list(entries.values())})
    print(nvidia_smi_line(card), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
