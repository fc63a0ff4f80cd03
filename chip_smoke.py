#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``horovod_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``horovod_tpu_torch/csrc`` (printing
ptxas's registers and spills of each attention kernel), holds each kernel
against its plain PyTorch version at the shapes the flagship's training
step gives it, and times both beside a PyTorch library call and the
card's bound. Attention is also held to its plain version at S 4096 and
timed beside SDPA at two long causal shapes (``LONG_FLASH``), in TFLOP/s.
Then it drives the main path through the entry points a user calls: the
flagship transformer's forward at full width from ``entry()`` (held
against the same model in fp32 on the CPU), and five AdamW steps of
``make_train_step`` on one batch, whose loss must fall.
Kernel launch counters are zeroed just before the main path and read just
after: every kernel must have run there, four attention launches (one per
layer) and one cross-entropy launch per forward.

``[bn]`` holds the batch norm kernels the port adds (``csrc/batch_norm.cu``,
no Pallas kernel behind them) to their plain stages at every ResNet-50
layer shape at batch 256 (sums against fp64 sums; y, the statistics, the
running averages and dx to the bit from the kernels' own sums) and
through the zoo's layer at the stem, then times them beside the five-pass
bound, the plain stages and cuDNN's ``torch.batch_norm``. ``[zoo]`` checks
that every step of a model runs four of them for each of its batch norms.
``[flash_mla]`` holds the attention kernel's (192, 128) instance
(multi-head latent attention, ``models/deepseek.py``) to its plain version,
v a strided view as the model gives it, and times it at the DeepSeek cell's
8x4096x16 beside the plain version, SDPA and its operations bound.

The int8 error-feedback slice adds six kernels (``csrc/quantize.cu``), each
held against its plain version at the flagship embedding's [64000, 256],
at a ragged [33, 128], at block 100 and on an all-zero row (the quantizers
to equal codes and scales), and four more main paths of five train steps
each from the same seed-0 weights, with the optimizers of
``horovod_tpu_torch.profile_step.OPTIMIZERS``: ``ef_adamw``
(``DistributedOptimizer(adamw, compression=ErrorFeedback(
Compression.int8))``: quantize + dequantize kernels), ``fused_adam``
(quantize_ef + fused_adam), ``fused_sgd_momentum`` (quantize_ef +
fused_sgd) and ``fused_sgd`` (quantize_ef + fused_sgd0). Each path's
counters are zeroed before it: its two kernels must run once per parameter
a step and the other quantize kernels never, its loss must fall, and the
loss of the two Adam paths must end within EF_LOSS_TOL of plain AdamW's.

The data-parallel slice adds four phases over ``torch.distributed``, each
from the same seed-0 weights and 8-row batch:

* ``[dp_nccl]``: an NCCL process group of world 1 on the card (the axis
  of size 1 still runs its collectives), ``make_overlap_train_step`` with
  ``DP_MICRO`` microbatches and the default 64 MiB buckets (two for the
  flagship), five AdamW steps. The loss falls, step 1's loss equals the
  ``[train]`` phase's first loss within ``DP_LOSS_TOL``, step 1's synced
  gradient equals the one-process full-batch gradient
  (``models.make_grad_fn``) within ``DP_GRAD_TOL`` per leaf, and the
  kernels launch ``n_layers x DP_MICRO x 5`` and ``DP_MICRO x 5`` times.
* ``[dp_nccl_int8]``: the same with ``compression=Compression.int8``:
  ``quantize`` and ``dequantize`` launch ``buckets x DP_MICRO x 5`` times
  each (the gather at n = 1 is one slice), no other quantize kernel does,
  and the 5th loss is within ``DP_INT8_TOL`` of ``[dp_nccl]``'s.
* ``[dp_nccl_fused_adam]``: ``DistributedOptimizer(fused_adam(1e-3),
  compression=ErrorFeedback(Compression.int8), axis=mesh.axis("dp"))``,
  the axis regime at world 1: ``quantize_ef`` and ``dequantize`` launch
  once a parameter a step and ``fused_adam`` never; the 5th loss within
  EF_LOSS_TOL of AdamW's.
* ``[dp_gloo_2rank]``: two ranks of this script (``--gloo-rank``), two
  one-card "hosts" on ``cuda:0`` over gloo, 4 rows each, with a timeout:
  three AdamW steps of ``make_train_step(cfg, mesh)``, then three of the
  overlap engine with int8. Step 1's synced gradient equals the
  full-batch one, both ranks hold bit-identical parameters after every
  step, and the int8 launch counts are those of n = 2.

The observability slice adds three phases, each around steps of a path
above with ``TelemetryCallback`` (step timer, goodput ledger, time series,
anomaly engine, ``torch.profiler`` capture, memory gauges), the
process-wide observability state reset before each:

* ``[telemetry]``: ``TELEMETRY_STEPS`` AdamW steps of ``make_train_step``
  (flash_attn_fwd and xent_fwd), ``HVD_TPU_GOODPUT_WINDOW`` 5, the
  observability and profile directories in a temporary directory, the
  first two steps captured. It checks the step, token and histogram
  counts, ``hvd_mfu`` in (0, 1] against the card's row of the peak table,
  the card's FLOP count against the same step counted on the CPU (over
  meta tensors: shapes only) within ``FLOPS_TOL``, two closed goodput
  windows whose categories sum to their wall time (and the ``1 − MFU``
  attribution over them, as bench.py reports it), the 12 points of the
  time series, one capture whose Chrome trace names both kernels, and
  ``0 < peak_bytes_in_use <= bytes_limit``; then it times the step with
  and without the callback, in turns (which goes first swapped every
  pair), with the hooks' own host time, the StepTimer's MFU of each
  observed step, and the captures and findings the pairs set off.
* ``[telemetry_fused_adam]``: three steps of the fused Adam path
  (quantize_ef and fused_adam) inside the callback.
* ``[telemetry_dp_int8]``: three steps of ``[dp_nccl_int8]`` inside the
  callback: the plan gauges equal the plan, and the int8 pre/wire byte
  counters equal the bytes computed here from the leaf shapes and the
  block size. The exposed-communication gauge of the eager
  ``DistributedOptimizer`` is read from ``[dp_gloo_2rank]``, whose ranks
  run three eager int8 steps too (an eager sync needs a world of two).

The tensor, sequence and expert slice adds four phases:

* ``[guard]``: guarded AdamW steps (``GuardedStep`` over
  ``guarded_apply``) of a small model with a NaN batch between two clean
  ones, under ``torch.cuda.set_sync_debug_mode("error")``: the poisoned
  step is skipped and the state ends bit-equal to two clean steps.
  ``[dp_nccl]``'s guarded overlap steps run under the same mode.
* ``[tp_sp]``: the dense flagship on ``{sp:2, tp:2}``; ``[moe_ep_sp]``:
  with 4 experts, top-2, capacity 1.25 on ``{ep:2, sp:2}``. Each is a
  4-rank gloo world on ``cuda:0`` (``--gloo-rank DIR ROLE``, killed at
  ``GLOO_TIMEOUT_S``) at full width and LAYOUT_LAYERS layers (the layout
  phases, the pipelines and ``[autotune]`` cut depth), 3 AdamW steps of
  ``make_train_step(cfg, mesh)`` from the seed-0 weights sliced for each
  rank. Checks: every rank reports the same loss each step; step 1's loss
  within LAYOUT_LOSS_TOL of the layout's fp32 loss on the CPU (plain
  versions); the loss falls; replicated leaves bit-identical across the
  ranks that hold them after the last step; step 1's gradient computed
  with fp32 on the ranks within LAYOUT_FP32_GRAD_TOL (rel L2, per leaf)
  of the one-process fp32 gradient on the card, sliced (for MoE the
  grouped reference: each layout group of tokens gated on its own), and
  the bf16 one within LAYOUT_GRAD_TOL for the dense layout; for MoE,
  whose bf16 router sends some tokens to other experts than fp32 does,
  within LAYOUT_MOE_FLOOR_RATIO floors of fp32 and LAYOUT_MOE_PAIR_RATIO
  floors of the one-process bf16 grouped gradient (a floor: that one
  against fp32, per leaf); per rank, ``flash_attn_fwd`` launched
  ``L x steps x (sp position + 1)`` times (the causal ring skips later
  blocks) and ``xent_fwd`` once a step where tp is 1; the inputs of each
  rank's first bf16 launch of each ring kind (own block diagonal-causal,
  earlier block full) and of ``xent_fwd``, taken in step 1, run again
  through the kernel and its plain version after the counted steps
  (LAYOUT_FLASH_O_TOL/LSE_TOL, LAYOUT_XENT_TOL), both ring kinds covered
  across the ranks.
* ``[ulysses]``: in the ``[tp_sp]`` world, one forward and backward of
  ``ulysses_attention_spmd`` at ULYSSES_SHAPE bf16 over sp = 2 against the
  plain attention in fp32 (output and gradients within ULYSSES_TOL), one
  kernel launch a rank.
gloo's send/recv cannot take CUDA tensors (the ring's exchanges go through
the host, ``mesh_collectives.GLOO_HOST_STAGED``, printed on each line).

The pipeline slice adds four phases:

* ``[pp_tp]``: the flagship on ``{pp:2, tp:2}`` with PP_MICRO microbatches
  (GPipe), a layout phase as above (four gloo ranks): ``flash_attn_fwd``
  ``L/pp x PP_MICRO`` times a step on every rank, ``xent_fwd`` never (the
  vocab is split); the embedding and ``ln_f`` bit-identical across the
  stages, and every leaf across its replicas, after every step; the bf16
  gradient held in floors as MoE's.
* ``[pipeline_1f1b]`` and ``[pipeline_interleaved]``: two gloo ranks of
  ``make_pipeline_train_step`` over ``{pp:2}`` (1F1B over two layers, one
  a rank; interleaved over four, two chunks of one layer a rank),
  PIPELINE_MICRO microbatches, the
  flagship's block as ``layer_fn`` and ``ln_f``, the tied head (held
  fixed) and the fused xent as ``loss_fn``, on the seed-0 embedding of the
  seed-1 tokens, PIPELINE_STEPS fused AdamW steps. Checks: the fp32
  losses and final parameters (gathered, natural order) within
  PIPELINE_FP32_TOL of the pp = 1 step in one process (the overlap
  engine, an NCCL world of one), step 1's bf16 loss within
  PIPELINE_LOSS_TOL of its fp32 loss, equal losses on both ranks,
  ``flash_attn_fwd`` a rank's layers x 4 times a step on each rank (one
  process's references at both depths) and ``xent_fwd`` 4 times
  on the rank holding the last chunk, each held against its plain version
  on the rank's own inputs, and a NaN step skipped on both stages with the
  guard's device work under ``set_sync_debug_mode("error")``. Each prints
  its step ms and the measured bubble, ``1 − t(pp = 1) / t(pp)`` with
  t(pp = 1) one process's step on a rank's share of the work (half the
  rows, microbatches of two), beside the analytic one (no limit: gloo
  ranks on one card price no layout).
* ``[autotune]``: in the one-process world, ``make_overlap_train_step(...,
  autotune=...)`` over AUTOTUNE_PLANS (the flagship at LAYOUT_LAYERS
  layers) with a budget of AUTOTUNE_BUDGET
  steps locks one plan, and a second build over the same cache directory
  locks it with zero trials.

The checkpoint slice adds two phases:

* ``[checkpoint]``: the flagship at full width on the card. Run A feeds a
  seeded corpus of CKPT_CORPUS batches through ``ShardedDataset`` and
  ``device_prefetch`` into ``make_train_step``, steps 0 to CKPT_STEPS - 1,
  under ``CheckpointCallback(every_n_steps=CKPT_EVERY)`` (commits
  CKPT_COMMITS) and ``TelemetryCallback`` (goodput windows of CKPT_EVERY
  steps), and ends with ``on_train_end()`` and no state: the writer
  drains, no final save. Each saved data position is the dataset's cursor
  less the prefetcher's buffer. Run B starts from other weights, restores
  the newest commit (CKPT_RESUME) into its model, optimizer and dataset,
  and runs from ``next_step`` to the end. Checks: run A's commits; the
  state restored equal to the bit to the state at ``save(CKPT_RESUME)``;
  run B's batches equal to run A's; run B's losses and final parameters
  equal to run A's to the bit if a repeat of run A (run A') is bit-equal
  to A, else within A's distance to A'; ``flash_attn_fwd`` 4 and
  ``xent_fwd`` 1 launches per forward in both runs; every goodput window
  books ``checkpoint_stall`` > 0 and closes on its wall time; the cut: run
  A's whole state saved, then every tensor negated in place on the current
  stream right after ``save`` returns, restores to the values at the
  call; the checkpoint's bytes (three fp32 copies of the 29.0 M
  parameters, plus the step counts) from the manifest. It prints the
  inline stall of each save, the background write and restore seconds,
  and the step time fed by ``device_prefetch`` beside steps fed host
  tensors, in turns, with the card's name and power limit.
* ``[checkpoint_2rank]``: two gloo ranks of this script on ``cuda:0``
  (``--gloo-rank DIR checkpoint``): rank 1 starts from other weights and
  ``BroadcastGlobalVariablesCallback`` makes both ``param_digest`` equal;
  CKPT_DP_STEPS dp steps; a commit of model and optimizer state in which
  each rank wrote only its axis-0 slices, which this process restores at
  world 1 equal to the bit to rank 0's state; ``MetricAverageCallback``
  averages one value a rank; ``ReplicaCanary`` finds nothing on equal
  replicas, and after rank 1 moves one element both ranks record the tie
  (``hvd_canary_divergence_total`` and a ``canary_mismatch`` event).

The model-zoo slice adds three phases (no kernel of their own: cuDNN and
cuBLAS; none of the eight kernels is on their path):

* ``[zoo]``: in an NCCL world of one (its dp axis still syncs the
  gradients), each ZOO_MODELS row at full width, bf16 compute, fp32
  parameters, ``channels_last``, bench.py's per-card batch and optimizer:
  ResNet-50 with both stems, VGG-16, Inception V3 (299x299) and BERT-Large
  (S 128), ZOO_STEPS steps of its ``make_*_train_step`` on one seeded batch
  (real step indices for dropout). Checks: finite losses that fall from
  step 1 to the last (at dropout 0 too when dropout's noise hides the
  fall, printed); at ZOO_CHECK_BATCH rows, the initial weights' forward
  (batch statistics, dropout off) in bf16 on the card within ZOO_LOSS_TOL
  (loss) and ZOO_LOGIT_TOL (logits, of the largest) of fp32 on the CPU,
  and in fp32 on the card within ZOO_LOGIT_TOL (ZOO_LOGITS_PRINTED's bf16
  logits are printed only); the FLOPs of a step counted
  (``metrics.mfu.flops_per_step``) within ZOO_FLOPS_TOL of bench.py's
  ``3·2·FWD_MACS_PER_IMG·B`` for the CNNs. It prints images/s (sequences/s)
  from the median of steps 2-5, MFU against the card's peak row,
  ``peak_bytes_in_use``, and the card's name and power limit.
* ``[zoo_dp_gloo_2rank]``: ResNet-50 in fp32 at 224x224 as two gloo ranks
  (``--gloo-rank DIR zoo_dp``) of ZOO_DP_ROWS images each, against one
  process on the same 32: step 1's loss, the synced gradient of every leaf
  and the BN running statistics (the global batch's), the ranks
  bit-identical after each of ZOO_DP_STEPS steps; it prints how far a
  local BN (each rank's own block) would have put the gradient and the
  statistics.
* ``[bert_tp_gloo_2rank]``: BERT at bert_large width, depth cut to
  BERT_TP_LAYERS (printed), S BERT_TP_SEQ, fp32, as two gloo ranks over
  ``{tp: 2}`` (``--gloo-rank DIR bert_tp``) against one process: the loss,
  each leaf's gradient reassembled from both shards, and BERT_TP_STEPS
  AdamW steps' losses.

The serving slice adds three phases (no kernel of their own: the decode
math is plain fp32 torch, as the JAX package's is XLA code, and none of
the eight kernels is on its path):

* ``[serve_generate]``: ``GenerateEngine`` with the flagship (fp32,
  seed-0 weights) at SERVE_SLOTS slots, the default 64 KiB pages and
  SERVE_CHUNK-token prefill chunks serves SERVE_REQUESTS seeded requests
  (prompts SERVE_PROMPT, max_new SERVE_NEW) in two waves, the second
  while the first decodes. Checks: (a) one CUDA graph capture of
  ``gen_decode_step`` and of ``gen_prefill_chunk`` over the whole phase;
  (b) SERVE_RERUNS requests rerun one at a time give bit-identical
  tokens; (c) SERVE_ORACLE requests equal the card's
  ``reference_greedy_decode`` up to the first step whose top-two logit
  margin is under SERVE_TIE_REL of the largest logit (printed); (d)
  ``request_level_generate`` over the same requests takes strictly more
  decode steps for identical tokens; (e) on a churned slot state the
  replayed decode step gives the eager step's tokens and pools to the bit
  (the scratch page aside). It prints tokens/s, TTFT and ITL p50/p99, the
  decode step's median host ms replayed and eager, its device ms
  (``time_ms`` of the graph replay and of the eager body), the launches
  of an eager step, occupancy, the pages high-water mark, and the bytes a
  step moves beside their bound at 3.35 TB/s.
* ``[serve_http]``: a generate-mode ``ReplicaServer`` on the card serves
  the flagship from a store holding one commit behind a ``Router``:
  SERVE_HTTP concurrent ``/generate`` requests plus two more copies of two
  ids (one token stream per id), a second commit (seed-1 weights, step 2)
  written mid-run and swapped in (later requests give the tokens of an
  engine of the same geometry on the new weights, version 2), a
  ``/drain`` once SERVE_HTTP_AFTER more requests are admitted (all
  answered, then DRAINED); zero failed requests and the router's books
  closed exactly once; one ``/infer`` of the demo model.
* ``[serve_fleet]``: a ``ReplicaFleet`` of two generate-mode replica
  processes on the card (``--flagship``), SERVE_FLEET requests, one
  replica SIGKILLed mid-run: zero failed requests, streams equal to this
  process's engine, the exit a failure, the fleet healed to two.

The second observability slice adds three phases around the flagship's
training (full width, seed-0 weights; host and socket code, no kernel of
its own: flash_attn_fwd and xent_fwd run in each, quantize and dequantize
in the last), each phase's launch counts in ``obs_launches``:

* ``[obs_exporter]``: an NCCL world of one with ``HVD_TPU_METRICS_PORT``
  on a held free port, ``HVD_TPU_WATCHDOG_SECONDS=60`` and a timeline
  shard; TELEMETRY_STEPS AdamW steps inside TelemetryCallback while a
  thread scrapes ``/metrics`` at 10 Hz. Checks: ``init`` started the
  exporter; ``/metrics`` (parsed by the port's ``parse_prometheus``)
  counts every step in ``hvd_steps_total`` and the step-time histogram;
  ``/healthz`` is 200 with the last step and the watchdog armed;
  ``/debug/stacks`` taken by the scraper shows the training thread;
  ``/debug/flight`` holds ``init`` and a ``step_end`` a step;
  ``GET /debug/profile?steps=2`` after step OBS_PROFILE_AT arms a capture
  that opens at the next step and whose Chrome trace names both kernels;
  ``python -m horovod_tpu_torch.metrics top --once`` exits 0 with the step
  line; the watchdog never fires; a shard is written. Then OBS_PAIRS
  steps with and without the scraper, in turns, and the exporter's
  render ms.
* ``[obs_fleet_4rank]``: four gloo ranks (``--gloo-rank DIR obs_fleet``)
  on cuda:0 as the local ranks of one host (exporters at base + local
  rank), the fleet tree at arity 2 (1, 2 -> 0 and 3 -> 1) pushing every
  0.5 s, shards on; OBS_FLEET_STEPS data-parallel AdamW steps, each marked
  on the shard, then the tree flushed leaves first. Checks: rank 0's
  ``/metrics/fleet`` covers ranks 0-3 at depth 2 with ``hvd_steps_total``
  4 x the steps; each rank's clock offset finite and under 1 s; the
  ranks bit-identical; ``python -m horovod_tpu_torch.diagnostics merge``
  writes one process row a rank with its step marks; ``diagnostics
  timeline`` over the four flight dumps puts every rank's ``step_end``
  events on one timeline, in step order. It prints how long after the
  first push the view covered every rank.
* ``[obs_hang_autopsy]``: two gloo ranks (``--gloo-rank DIR obs_hang``),
  the watchdog at OBS_HANG_WATCHDOG_S, each step the flagship's forward
  and backward plus the eager int8 ``DistributedOptimizer`` sync; before
  the last step's sync rank 1 sleeps OBS_HANG_STALL timeouts and rank 0
  blocks in it. Checks: rank 0's ``/healthz`` goes 503 ``stalled``; each
  watchdog fires once; the bundle holds both ranks' stacks, flight,
  engine, metrics and summary files, ``merged_trace.json`` and
  ``peer_rank1_{stacks,flight,engine}`` fetched over ``/debug/*`` while
  rank 1 slept (its flight ends at step 2); rank 0's blocked frames name
  the port's collective; its flight has step_end 1-2 and one trigger;
  ``peers_fetched == [1]``; the last step completes on both ranks with
  bit-identical parameters. It prints the seconds from the trigger to a
  complete bundle and the bundle's bytes.

The launcher and elastic slice adds two phases, both on the flagship at
full width and depth (host, socket and process code: no kernel of its own;
flash_attn_fwd and xent_fwd run in every rank's step), each phase's launch
counts in ``hvdrun_launches`` and ``elastic_launches``:

* ``[hvdrun]``: ``python -m horovod_tpu_torch.runner.launch --tpu python
  tests/torch_port_elastic_worker.py static``, the host read from a fake
  GCE metadata server in this process (``FakeMetadata``, its
  ``worker-network-endpoints`` POD_ENDPOINTS, this host; one slot from
  the card count), an NCCL world of one taking TRAIN_STEPS AdamW steps of
  ``make_train_step(cfg, mesh)`` on ``entry()``'s batch. Checks: the
  metadata server was read; the launcher's identity reached
  the worker (rank 0, size 1, the rendezvous at 127.0.0.1 on a port, no
  elastic generation: a static launch); its losses equal ``[train]``'s to
  the bit when ``[train]`` repeated in this process is bit-equal to
  itself, else within DP_LOSS_TOL (the line says which); the kernels
  launched 4 and 1 times a step; a worker's exit code 3 comes back
  through ``hvdrun``.
* ``[elastic_recover]``: the port's ``ElasticDriver`` over ``FixedHosts``
  of three slots (min 2, max 3, a journal directory) runs three gloo ranks
  of the elastic worker on ``cuda:0`` (``--device cuda:0``: the ranks pick
  the card themselves), ELASTIC_ROWS rows each a step from an
  ``ElasticSampler`` under ``elastic.run`` with a ``TorchState``, a commit
  a step, gloo's timeout ELASTIC_GLOO_TIMEOUT_S. After its commit of
  step ELASTIC_KILL[1], rank ELASTIC_KILL[0] calls ``os._exit(1)``. Checks:
  the survivors keep their PIDs, one replacement boots, the world ends at
  3; each survivor's ``hvd_remesh_total`` >= 1 with all six phases, the
  replacement's none; the three parameter digests equal after the last
  step; the first step of the healed world against one process running
  from the committed state of that step on the three ranks' rows
  concatenated (loss within DP_LOSS_TOL, every gradient within
  DP_GRAD_TOL rel L2); the seconds from the kill to the healed world's
  first completed step, with every phase's seconds; the journal replays
  to the driver's final state.

The agent-transport slice adds two phases (host, socket and process code:
no kernel of its own; flash_attn_fwd and xent_fwd run in every rank's
step), the launches in ``agent_launches``:

* ``[nic_probe]``: two task services started as ``python -m
  horovod_tpu_torch.runner.task_server --index i`` with the secret on
  stdin (the remote half of ``probe_coordinator_address`` without the
  ``ssh``). Checks: both answer ``addresses`` (this host's interfaces)
  and ``probe`` (each reaches the other), a client with a wrong secret
  gets 403, ``pick_rendezvous_address`` over ``find_routable_interfaces``
  picks one of this host's addresses, not loopback where it has another
  IPv4 interface, and both exit 0 on ``shutdown``; prints the
  interfaces and the pick.
* ``[agent_elastic]``: ``run_agent_elastic`` over three host agents that
  ``tests/torch_port_elastic_worker.py``'s ``start_local_agents`` starts
  as processes (each its own process group, secrets on stdin), registered
  under the NIC probe's pick, where every world rendezvouses. The payload
  is the elastic trainer of the flagship at full width and depth on
  ``cuda:0`` (three gloo ranks, ELASTIC_ROWS rows a step, until the world
  is three again). After its commit of step ELASTIC_KILL[1], rank
  ELASTIC_KILL[0] SIGKILLs its process group: its agent dies with it. The
  heartbeat expires (``STALE_S``), the world shrinks to two in place, the
  respawned agent registers and the world grows back to three. Checks:
  the results come from the three ranks of the final world, the survivors
  keep their PIDs and the grown rank is the one new process; the digests
  equal; the healed world's first step against one process from the
  commit (DP_LOSS_TOL, DP_GRAD_TOL); both survivors re-meshed twice
  (``internal_error``, then ``hosts_updated``); both kernels launched on
  every final rank. Prints the heartbeat expiry and each re-mesh's
  seconds by phase.

The eager-collectives slice adds four phases (host, socket and ctypes
code: no kernel of its own), the C++ core built from ``cpp/`` with g++
beside the nvcc builds (``[build]``'s ``core_seconds``), each phase's
launch counts in ``eager_launches``:

* ``[hvd_torch]``: in an NCCL world of one, the reference idiom through
  ``horovod_tpu_torch.torch``: ``DistributedOptimizer(adamw(...),
  named_parameters=...)``, ``broadcast_parameters``,
  ``broadcast_optimizer_state``, then TRAIN_STEPS steps of
  ``loss.backward(); opt.step()`` from the seed-0 weights. Checks: the
  losses equal ``[train]``'s to the bit; the kernels launch 4 and 1 times
  a step.
* ``[eager_nccl]``: in that world, the ``torch.distributed`` eager plane
  (``ops.dist_backend.DistBackend``) over the NCCL group, every op on CUDA
  tensors in fp32, bf16, fp16, int32 and int64, equal to
  ``LocalBackend``'s and on the card.
* ``[eager_core_2rank]``: two ranks of this script (``--gloo-rank DIR
  eager``) launched by ``python -m horovod_tpu_torch.runner.launch -np 2
  -H localhost:2``, both on ``cuda:0``, gloo, the core as the eager
  engine. On CUDA tensors in fp32, bf16, fp16, int32 and int64: allreduce
  (sum, min, max, average), grouped allreduce, a ragged allgather, a
  broadcast, an uneven alltoall and reducescatter, each result on the
  card and equal to its host reference (fp16 within one unit in the last
  place: the core rounds ties up); a grouped allreduce of the flagship's
  gradient shapes in fp32 (116 MB), EAGER_FUSED_REPEATS times, timed with
  its host staging, and the same group through the ``torch.distributed``
  plane over gloo; ``quantized_grouped_allreduce`` of that group with
  ``Compression.int8`` (``quantize`` once and ``dequantize`` twice a leaf
  on each rank, never a plain version; within QUANT_TOL of the plain
  versions on the host); a registered process set a rank; the Adasum op
  within EAGER_ADASUM_RTOL of the combine on the host; ``join`` with rank
  1 reducing once more after rank 0 joined.
* ``[hvd_torch_2rank]``: the same two ranks, the idiom of ``[hvd_torch]``
  over the core, 4 rows a rank, EAGER_STEPS steps. Checks: step 1's mean
  loss within DP_LOSS_TOL of ``[train]``'s and its synced gradients within
  DP_GRAD_TOL rel L2 of one process's full batch; the replicas
  bit-identical after the last step; the response cache's hits rising
  after step 1 and ``cache_hit_rate`` above 0; ``hvd_engine_*`` on rank
  0's exporter; the kernels launch 4 and 1 times a step on each rank. It
  prints the step's milliseconds split into staging, wire and compute.

The self-healing slice adds six phases (host, socket and process code: no
kernel of its own), each under a fault plan (``HVD_TPU_FAULT_PLAN``), each
rank's launches in ``chaos_launches``; every training rank must launch
``flash_attn_fwd`` n_layers times and ``xent_fwd`` once a forward:

* ``[chaos_soak]``: three elastic gloo ranks of
  ``tests/torch_port_elastic_worker.py`` on ``cuda:0`` under the port's
  driver, the flagship at full width and depth, the guarded overlap step,
  rank 0 saving the model every 2 steps, under its ``soak_plan``: a grad
  NaN at step 3 on every rank (the guard skips it with the parameters and
  the optimizer state bit-equal), one ``checkpoint.write`` error on rank 0
  (its save fails with the injected error and the next save commits), a
  KV blackout over each arming's first two requests (ridden out by the
  retries), and rank 1 killed after step 3 with a ``{rank}`` marker
  (healed in place by a replacement that is not killed again). Checks:
  each process's ``hvd_chaos_injected_total`` equals the plan's schedule,
  the digests agree, the journal replays to the driver's final state; it
  prints the kill to the healed world's first step, by phase.
* ``[preempt_drain]``: the same trainer at depth 2 (``--layers 2``):
  a chaos ``preemption`` notice on rank 2 is published by its watcher at
  its first poll, the driver plans the world around it at the first
  commit (the exit ``DRAINED``, counted
  under ``hvd_drain_notices_total{source="chaos"}``, the survivors'
  ``failure_detect`` under DRAIN_DETECT_MAX_S, the slot reserved for
  DRAIN_COOLDOWN_S and then re-admitted); beside it on the card, the same
  run with rank 2 killed after that commit instead. It prints the handled
  drain and the kill to the end of the survivors' re-mesh (the healed
  world's first step done), the drain to the re-admitted process's first
  step, and each run's phases.
* ``[driver_chaos]``: ``python -m horovod_tpu_torch.runner.launch -H
  localhost:3 --min-np 3`` with the supervisor: the ``driver`` seam kills
  the driver at a poll tick inside training; the supervisor respawns it
  with ``--takeover``, the workers ride the outage out (no re-mesh, their
  PIDs unchanged), finish, and each wrote an autopsy during the outage
  whose ``driver_outage`` is set.
* ``[autopilot_straggler]``, run beside ``[driver_chaos]`` on the card:
  three elastic ranks each training its own
  replica at depth 2 (``--local``: no collective a step, a StepTimer
  around it), rank 2 stalled 1.2 s a step in its timed window for five
  steps; with ``HVD_TPU_AUTOPILOT=act`` the fleet tree's
  ``persistent_straggler`` finding fires ``straggler-drain``, the driver
  drains rank 2 and re-admits its slot. Checks: exactly one fired
  ``straggler-drain`` decision in ``actions_rank0.jsonl``, in
  ``hvd_autopilot_decisions_total`` and in ``python -m
  horovod_tpu_torch.metrics history --actions``; it prints finding to
  action and action to the healed step.
* ``[transport_chaos_2rank]``: two ranks of this script (``--gloo-rank
  DIR transport_chaos``) drive the C++ core directly on ``cuda:0`` tensors
  under ``tests/torch_port_chaos_worker.py``'s plan, after one flagship
  forward at depth 2 each: a ``transport.recv`` delay on rank 1 (counted
  by the core: 4) leaves the grouped allreduce equal to its host
  reference; a ``transport.send`` bit_flip fails the next collective,
  rank 0 naming peer 1 and the checksum (one failure counted; the port's
  ``core/transport.cc`` gives that error whether rank 0 was receiving or
  sending), rank 1 a closed or broken socket.
* ``[rollout_canary]``: a ``ReplicaFleet`` of two generate-mode flagship
  replicas over a store, behind a ``Router`` with closed-loop clients, a
  ``RolloutController`` whose promote/rollback hooks the autopilot drives
  (``HVD_TPU_AUTOPILOT=act``): a candidate whose canary slot answers its
  first ROLLOUT_POISON requests with an injected ``serving.request``
  error is rolled back (every slot pinned to the incumbent), then a
  clean candidate is promoted through every stage. Zero failed requests;
  the kernels never run (the decode path is plain torch).

The closing slice adds ``[examples]``: the documented scripts of
``horovod_tpu_torch/examples`` (``EXAMPLES``) each under ``python -m
horovod_tpu_torch.runner.launch -np 1`` on the card, the rank running the
unchanged script through ``--example-rank`` (which counts its launches):
``native/transformer_5d_parallel.py`` (a dp mesh of one, bf16, ten steps)
prints its ten ``step <i>: loss`` lines with the loss falling and launches
``flash_attn_fwd`` and ``xent_fwd``; ``torch/torch_synthetic_benchmark.py``
with its CPU test's argv prints ``Img/sec per process``. Launches in
``examples_launches``.

Independent worlds share the card side by side to keep the script well
inside its time: the three layout worlds; ``[zoo_dp_gloo_2rank]`` and
``[bert_tp_gloo_2rank]``; ``[obs_fleet_4rank]``, ``[obs_hang_autopsy]``
and ``[nic_probe]``; ``[hvdrun]``, ``[elastic_recover]`` and
``[agent_elastic]`` with the two ``[examples]``; ``[driver_chaos]`` and
``[autopilot_straggler]``.
Their checks hold whatever the load; their printed seconds are of a
shared card and host. Every phase prints one line; any failure raises and
exits non-zero, and nothing falls back to the CPU. The last lines are the card's name and
power limit, a JSON line with each kernel's numbers, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
``--straggler-rounds N`` runs only ``[driver_chaos]`` beside
``[autopilot_straggler]``, N times over, for a check of that pair.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

# the one rule for holding free ports is the port's test helper's
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_port_worker import reserve_port, reserve_ports  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
BF16_TENSOR_FLOPS = 989e12    # dense bf16 tensor cores
FP32_FLOPS = 67e12            # fp32 outside the tensor cores
TRAIN_STEPS = 5
QUANT_SHAPE = (64000, 256)    # the flagship embedding: 16,384,000 elements
# codes·scale, residuals, deltas and moments against the plain versions,
# absolute (both compute in fp32 from the same inputs)
QUANT_TOL = 1e-6
# EF int8 against plain AdamW, 5th loss, relative: some 30 times the gap
# measured on an H100, so a wrong carry or dequantize on a leaf shows
EF_LOSS_TOL = 1e-3
ADAM_PATHS = ("ef_adamw", "fused_adam")   # held to plain AdamW's loss
# long causal bf16 shapes timed beside SDPA: 68.7 GFLOP and 67.1 MB each
LONG_FLASH = ((4, 4096, 8, 64), (2, 4096, 8, 128))
# data-parallel step 1 against the one-process step on the same batch, in
# bf16 compute: the loss within one bf16 rounding (2^-8) relative;
DP_LOSS_TOL = 2.0 ** -8
# each synced gradient within 2e-2 relative (L2, per parameter) of the
# full-batch one: every weight gradient is a bf16 product rounded to 8 bits
# (3.9e-3 relative) over 4 rows instead of 8, then averaged, so the two
# differ by a few roundings, and more where a gradient sums to near zero
DP_GRAD_TOL = 2e-2
DP_INT8_TOL = 5e-2        # tests/test_overlap.py:186
GLOO_STEPS = 3
GLOO_TIMEOUT_S = 420
TELEMETRY_STEPS = 12
TELEMETRY_WINDOW = 5      # HVD_TPU_GOODPUT_WINDOW: two closed windows
TELEMETRY_PAIRS = 20      # steps with and without the callback, in turns
OBSERVED_STEPS = 3        # [telemetry_fused_adam], [telemetry_dp_int8]
# the card's FLOP count of a step against the CPU's: both add the same
# kernel formulas to FlopCounterMode's count, so they should be equal
FLOPS_TOL = 1e-3
# the tensor/sequence/expert slice: 4-rank gloo worlds on cuda:0 at the
# flagship's full width, 3 AdamW steps each; (moe, mesh sizes)
LAYOUT_PHASES = {"tp_sp": (False, {"sp": 2, "tp": 2}),
                 "moe_ep_sp": (True, {"ep": 2, "sp": 2}),
                 "pp_tp": (False, {"pp": 2, "tp": 2})}
LAYOUT_STEPS = 3
# the depth of the layout phases, the pipelines and [autotune]: their
# checks are of the sharding, the schedules and the plan search, which one
# layer a stage exercises as well as two, and their worlds price nothing a
# user runs; the cut pays for the agent transport's phases within the
# script's time. A pipeline takes LAYOUT_LAYERS layers a virtual stage
# (the interleaved schedule's four chunks over pp = 2 need four)
LAYOUT_LAYERS = 2
PP_MICRO = 2              # the flagship's microbatches under pp ([pp_tp])
# step 1's bf16 loss against the fp32 CPU loss of the layout, relative
# (2.3e-5 to 2.5e-5 on an H100: at init the loss sits near ln V and moves
# little, so the limit is tight), and each leaf's step-1 gradient against
# the one-process fp32 gradient (rel L2): bf16 products round to 8 bits,
# as for DP_GRAD_TOL
LAYOUT_LOSS_TOL = 1e-3
LAYOUT_GRAD_TOL = 2e-2
# the same gradient computed in fp32 on the ranks (the kernels' fp32 paths)
# against the fp32 reference: only the order of the sums differs. It is the
# check of the MoE layout: in bf16 the router sends some tokens to other
# experts than in fp32 (3 to 22 of 512 a group and layer, one process on an
# H100), so bf16 MoE gradients differ from fp32 by up to 10% in one process
# already, sharded or not; they are printed beside that one-process figure
LAYOUT_FP32_GRAD_TOL = 1e-3
# MoE's and pp's bf16 step-1 gradient, per leaf, in units of the floor:
# one process's bf16 (grouped) gradient against the fp32 one, from the
# same run. Against fp32, the layout may be no further than 1.5 floors
# (one process and the MoE layout see the same bf16 roundings and
# reroutings: 0.96 to 1.06 floors on an H100; under pp each microbatch's
# layer gradients are rounded to bf16 on their own where one process
# rounds their sum once: up to 1.33 floors, wk 2.1e-2 rel L2 where one
# process is 1.58e-2 off, so LAYOUT_GRAD_TOL does not apply there);
# against one process's bf16 gradient, no further than the two floors
# that both being within a floor of fp32 allows
LAYOUT_MOE_FLOOR_RATIO = 1.5
LAYOUT_MOE_PAIR_RATIO = 2.0
# the kernels on a layout rank's own inputs (its first bf16 ring blocks,
# the own block diagonal-causal and an earlier one full, and its logits),
# against the plain versions: o relative to its largest entry at
# phase_flash's bf16 tolerance (a bf16 rounding is 2^-8 of a value), the
# lse (fp32 in both) at the fp32 one, xent relative at phase_xent's
LAYOUT_FLASH_O_TOL = 2e-2
LAYOUT_FLASH_LSE_TOL = 1e-4
LAYOUT_XENT_TOL = 1e-5
ULYSSES_SHAPE = (8, 256, 8, 64)   # [B, S, H, D] bf16 over sp = 2
ULYSSES_TOL = 2e-2                # the bf16 flash_attn_fwd tolerance above
# make_pipeline_train_step over {pp:2}: schedule and chunks per rank
PIPELINE_PHASES = {"pipeline_1f1b": ("1f1b", 1),
                   "pipeline_interleaved": ("interleaved", 2)}
PIPELINE_MICRO = 4
PIPELINE_STEPS = 3
# the pipelined fp32 trajectory (3 losses, final parameters) against the
# pp = 1 step in one process, relative: the same fp32 sums in another
# order; and step 1's bf16 loss against that fp32 loss (LAYOUT_LOSS_TOL's
# reasoning)
PIPELINE_FP32_TOL = 1e-3
PIPELINE_LOSS_TOL = 1e-3
# [autotune]: make_overlap_train_step(autotune=...) over AUTOTUNE_PLANS
AUTOTUNE_BUDGET = 12
# [checkpoint]: run A takes steps 0 to CKPT_STEPS - 1 and commits every
# CKPT_EVERY steps (CheckpointCallback saves at step % every == 0, step 0
# included); run B resumes from the newest commit, CKPT_RESUME
CKPT_EVERY = 3
CKPT_STEPS = 9
CKPT_COMMITS = [0, 3, 6]
CKPT_RESUME = 6
CKPT_CORPUS = 12          # seeded batches: run A takes 9, prefetches 2 more
CKPT_PREFETCH = 2         # device_prefetch's buffer
CKPT_PAIRS = 6            # steps fed by device_prefetch / from host, in turns
CKPT_DP_STEPS = 3         # [checkpoint_2rank]
# [zoo]: name, constructor keywords, per-card batch, input, optimizer and
# its learning rate (bench.py's per-chip defaults and optimizers,
# bench.py:616-617, :623, :859-863, :880, :889, :906)
ZOO_MODELS = (("resnet50", {"stem": "conv"}, 256, 224, "sgd", 0.1),
              ("resnet50", {"stem": "s2d"}, 256, 224, "sgd", 0.1),
              ("vgg16", {"image_size": 224}, 128, 224, "sgd", 0.01),
              ("inception3", {}, 128, 299, "sgd", 0.1),
              ("bert_large", {}, 64, 128, "adamw", 1e-4))
ZOO_STEPS = 5
ZOO_CHECK_BATCH = 4       # the bf16-on-card vs fp32-on-CPU forward
ZOO_LOSS_TOL = 2e-2       # PERF.md §2's loss agreement
ZOO_LOGIT_TOL = 5e-2      # of the largest fp32 logit
# models whose bf16 logits are printed, not held to ZOO_LOGIT_TOL: a
# randomly initialised conv-BN-ReLU stack about 45 deep without residual
# connections multiplies each rounding difference (on the CPU, bf16 vs fp32
# at batch 4: 0.195 of the largest logit, the loss 1.7e-3 apart); their
# card forward is held in fp32 against the CPU's instead
ZOO_LOGITS_PRINTED = ("inception3",)
ZOO_FLOPS_TOL = 5e-2      # the counted FLOPs against bench.py's analytic
# bench.py:57-60: forward GMACs an image (224 input; inception3 at 299)
FWD_MACS_PER_IMG = {"resnet50": 4.09e9, "resnet101": 7.6e9,
                    "vgg16": 15.47e9, "inception3": 5.7e9}
ZOO_DP_ROWS, ZOO_DP_SIZE = 16, 224   # [zoo_dp_gloo_2rank]: images a rank
ZOO_DP_STEPS = 3
ZOO_DP_LOSS_TOL = 1e-4
ZOO_DP_GRAD_TOL = 1e-3    # rel L2, per leaf
ZOO_DP_STATS_TOL = 1e-4   # BN running mean and variance, max abs
BERT_TP_LAYERS = 2        # [bert_tp_gloo_2rank]: bert_large width, cut depth
BERT_TP_ROWS, BERT_TP_SEQ = 8, 128
BERT_TP_STEPS = 3
BERT_TP_LOSS_TOL = 1e-4
BERT_TP_GRAD_TOL = 1e-3
BERT_TP_GRAD_FLOOR = 1e-3  # of the largest leaf's gradient norm
BERT_TP_STEP_TOL = 1e-3
SERVE_SLOTS = 32          # [serve_*]: decode slots of every engine
SERVE_CHUNK = 32          # prefill chunk tokens
SERVE_REQUESTS = 64       # [serve_generate]: two waves of 32
SERVE_PROMPT = (8, 192)   # prompt tokens, both ends included
SERVE_NEW = (8, 64)       # max_new, both ends included
SERVE_CONTEXT = 256       # prompt + max_new at most: the flagship's max_seq
SERVE_WAVE_STEPS = 12     # engine steps between the two waves
SERVE_RERUNS = 8          # (b): requests rerun one at a time
SERVE_ORACLE = 4          # (c): requests held to reference_greedy_decode
SERVE_TIE_REL = 1e-4      # a near tie: top-two logit margin < this x max|logit|
SERVE_TIMED = 20          # decode steps timed, replayed and eager
SERVE_HTTP = 16           # [serve_http]: concurrent /generate requests
SERVE_HTTP_AFTER = 8      # requests after the swap, and again under the drain
SERVE_FLEET = 8           # [serve_fleet]: requests through the fleet
SERVE_TIMEOUT_S = 240     # every wait of the serving phases
OBS_SCRAPE_S = 0.1        # [obs_exporter]: the scraper's period (10 Hz)
OBS_PAIRS = 20            # steps with and without the scraper, in turns
OBS_PROFILE_STEPS = 2     # GET /debug/profile?steps=2
OBS_PROFILE_AT = 4        # ... requested after this step
OBS_FLEET_STEPS = 4       # [obs_fleet_4rank]
OBS_FLEET_ARITY = 2       # a tree of depth 2: 1, 2 -> 0 and 3 -> 1
OBS_FLEET_PUSH_S = 0.5
OBS_HANG_WATCHDOG_S = 5   # [obs_hang_autopsy]
OBS_HANG_STALL = 3        # rank 1 sleeps this many watchdog timeouts
OBS_HANG_STEPS = 3        # the stall comes before the last step's sync
HVDRUN_TIMEOUT_S = 300    # [hvdrun]: each launcher call
# [hvdrun]'s pod, as the metadata server's worker-network-endpoints: this
# host alone (<uuid>:<worker name>:<address>)
POD_ENDPOINTS = "smoke:w-0:127.0.0.1"
AGENT_TIMEOUT_S = 420     # [agent_elastic]: the whole agent-elastic run
NIC_PROBE_TIMEOUT_S = 30  # [nic_probe]: a task server's port line
ELASTIC_STEPS = 5         # [elastic_recover]: steps of the run
ELASTIC_KILL = (2, 3)     # rank 2 exits after its commit of step 3
ELASTIC_ROWS = 8          # rows a rank takes a step (the flagship's B)
ELASTIC_GLOO_TIMEOUT_S = 60   # the elastic world's collective timeout
ELASTIC_TIMEOUT_S = 420   # the whole driver run
EAGER_STEPS = 5           # [hvd_torch_2rank]: adapter steps, B 4 a rank
EAGER_FUSED_REPEATS = 3   # [eager_core_2rank]: the 116 MB grouped allreduce
EAGER_ADASUM_RTOL = 1e-5  # the core's Adasum against the host combine
EAGER_TIMEOUT_S = 600     # the hvdrun call of both two-rank phases
REMESH_PHASES = ("failure_detect", "drain", "rendezvous", "rebuild",
                 "restore", "first_step")
CHAOS_STEPS = 6           # [chaos_soak]: steps at full depth
CHAOS_LAYERS = 2          # the other self-healing phases' depth
DRAIN_STEPS = 10          # [preempt_drain]: steps of the drain run at least
DRAIN_COOLDOWN_S = 2      # HVD_TPU_DRAIN_COOLDOWN_S, read by the driver
DRAIN_DETECT_MAX_S = 0.05  # a planned drain's failure_detect (the JAX test)
DRAIN_POLL_S = 0.2        # HVD_TPU_PREEMPTION_POLL_S
DRIVER_CHAOS_STEPS = 16   # [driver_chaos]: steps at least, a quarter
DRIVER_CHAOS_AFTER = 8    # second's sleep each, and this many after the kill
STRAGGLER_STEPS = 12      # [autopilot_straggler]: local steps a rank at least
ROLLOUT_POISON = 12       # [rollout_canary]: injected errors on the canary
CHAOS_TIMEOUT_S = 300     # each driver run of the self-healing phases
# [examples]: documented scripts under hvdrun -np 1, each with the argv its
# CPU test gives it (tests/test_examples.py:63-66 for the benchmark)
EXAMPLES = {
    "transformer_5d_parallel": ("native/transformer_5d_parallel.py", ()),
    "torch_synthetic_benchmark": (
        "torch/torch_synthetic_benchmark.py",
        ("--batch-size", "8", "--image-size", "16", "--num-warmup-batches",
         "1", "--num-batches-per-iter", "2", "--num-iters", "2")),
}
EXAMPLE_TIMEOUT_S = 300   # each launcher call


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


_T0 = time.perf_counter()
_FIRST_SAID = {}  # phase -> seconds since the script began, at its 1st line


def say(phase: str, **kv) -> None:
    _FIRST_SAID.setdefault(phase, time.perf_counter() - _T0)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.
    A spin kernel holds the stream while the host queues the calls, so
    the host's time per call (Python, argument checks, the launch) does
    not leave the card idle inside the timed window."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # about 50 ms of clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_flash(torch, attention, dev):
    """flash_attn_fwd against plain_attention_with_lse; timed at the
    flagship's shape (B 8, S 256, H 8, D 64, bf16, causal)."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = [  # B, S, H, D, dtype, causal, tolerance
        (8, 256, 8, 64, torch.bfloat16, True, 2e-2),   # the main path's call
        (8, 256, 8, 64, torch.float32, True, 1e-4),
        (8, 256, 8, 64, torch.float32, False, 1e-4),
        (8, 200, 8, 64, torch.bfloat16, True, 2e-2),   # ragged S
        (8, 200, 8, 64, torch.float32, False, 1e-4),
        (4, 256, 8, 128, torch.bfloat16, True, 2e-2),  # D = 128
        (4, 200, 8, 128, torch.float32, True, 1e-4),
        (2, 4096, 8, 128, torch.bfloat16, True, 2e-2),  # a long sequence
    ]
    main_err = None
    for B, S, H, D, dt, causal, tol in cases:
        q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
                   for _ in range(3))
        scale = 1.0 / D ** 0.5
        o, lse = attention.flash_attn_fwd_cuda(q, k, v, causal, scale)
        o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal,
                                                            scale)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o, o_ref), max_err(lse, lse_ref)
        say("flash_attention_fwd", shape=f"{B}x{S}x{H}x{D}",
            dtype=str(dt).split(".")[-1], causal=causal, max_abs_err_o=e_o,
            max_abs_err_lse=e_lse, tol=tol)
        check(e_o <= tol and e_lse <= tol,
              f"flash_attn_fwd disagrees with the plain version at "
              f"{(B, S, H, D, dt, causal)}: {e_o}, {e_lse} > {tol}")
        if main_err is None:
            main_err = max(e_o, e_lse)

    B, S, H, D = 8, 256, 8, 64
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 1.0 / D ** 0.5
    ms = time_ms(lambda: attention.flash_attn_fwd_cuda(q, k, v, True, scale))
    plain = time_ms(lambda: attention.plain_attention_with_lse(q, k, v, True,
                                                               scale))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    n_bytes, n_ops = attention_cost(B, S, H, D)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    say("flash_attention_fwd", timed="8x256x8x64 bf16 causal", ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    for B, S, H, D in LONG_FLASH:
        timed_long_flash(torch, attention, g, dev, B, S, H, D)
    return dict(name="flash_attention_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces="horovod_tpu/ops/pallas_attention.py:41",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


# multi-head latent attention (models/deepseek.py) at its benchmark cell's
# shape: scores over 192 dims, values of 128, YaRN's softmax scale
MLA_SHAPE = (8, 4096, 16, 192, 128)
MLA_SCALE = 192 ** -0.5 * (0.1 * 0.707 * math.log(40.0) + 1.0) ** 2


def phase_flash_mla(torch, attention, dev):
    """The (192, 128) instance of flash_attn_fwd against
    plain_attention_with_lse, v a strided view of the fused up-projection
    as the model gives it, bf16 (causal, full, ragged) and fp32; then timed
    at the DeepSeek cell's 8x4096x16x(192/128) beside the plain version,
    SDPA and the operations bound."""
    g = torch.Generator(device=dev).manual_seed(7)
    cases = [  # B, S, H, dtype, causal, tolerance
        (8, 4096, 16, torch.bfloat16, True, 2e-2),     # the cell's call
        (2, 333, 16, torch.bfloat16, False, 2e-2),
        (2, 200, 4, torch.float32, True, 1e-4),
        (1, 4096, 16, torch.float32, True, 1e-4),
    ]
    main_err = None
    for B, S, H, dt, causal, tol in cases:
        q, k = (torch.randn(B, S, H, 192, generator=g, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(B, S, H, 256, generator=g, device=dev).to(dt)[
            ..., 128:]
        o, lse = attention.flash_attn_fwd_cuda(q, k, v, causal, MLA_SCALE)
        o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal,
                                                            MLA_SCALE)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o, o_ref), max_err(lse, lse_ref)
        del o_ref, lse_ref
        say("flash_mla", shape=f"{B}x{S}x{H}x192/128",
            dtype=str(dt).split(".")[-1], causal=causal, max_abs_err_o=e_o,
            max_abs_err_lse=e_lse, tol=tol)
        check(e_o <= tol and e_lse <= tol,
              f"flash_attn_fwd (192, 128) disagrees with the plain version "
              f"at {(B, S, H, dt, causal)}: {e_o}, {e_lse} > {tol}")
        if main_err is None:
            main_err = max(e_o, e_lse)
    B, S, H, D, Dv = MLA_SHAPE
    q, k = (torch.randn(B, S, H, D, generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    v = torch.randn(B, S, H, 2 * Dv, generator=g, device=dev,
                    dtype=torch.bfloat16)[..., Dv:]
    ms = time_ms(lambda: attention.flash_attn_fwd_cuda(q, k, v, True,
                                                       MLA_SCALE))
    plain = time_ms(lambda: attention.plain_attention_with_lse(
        q, k, v, True, MLA_SCALE), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=MLA_SCALE))
    n_ops = attention.flash_attn_fwd_flops(B, S, S, H, D, True, Dv)
    n_bytes = B * S * H * ((2 * D + 2 * Dv) * 2 + 4)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    say("flash_mla", timed=f"{B}x{S}x{H}x{D}/{Dv} bf16 causal", ms=ms,
        plain_ms=plain, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        tflops=n_ops / ms * 1e-9, library_tflops=n_ops / lib * 1e-9)
    return dict(name="flash_attention_fwd (192, 128)", route="cuda",
                source="horovod_tpu_torch/csrc/flash_attn_fwd.cu",
                replaces="none: MLA's value width differs from its key width",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def attention_cost(B, S, H, D):
    """Bytes (q, k, v in; o and the fp32 lse out) and operations (q.k and
    p.v, 2 each a multiply-add) of causal bf16 attention at [B, S, H, D]."""
    n_bytes = 4 * B * S * H * D * 2 + B * H * S * 4
    return n_bytes, B * H * (S * (S + 1) // 2) * D * 4


def timed_long_flash(torch, attention, g, dev, B, S, H, D):
    """flash_attn_fwd beside SDPA at a long causal bf16 shape, in TFLOP/s.
    The inputs (67 MB) do not fit in the 50 MB L2."""
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 1.0 / D ** 0.5
    ms = time_ms(lambda: attention.flash_attn_fwd_cuda(q, k, v, True, scale))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    n_bytes, n_ops = attention_cost(B, S, H, D)
    b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TENSOR_FLOPS)
    say("flash_attention_fwd", timed=f"{B}x{S}x{H}x{D} bf16 causal", ms=ms,
        library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        tflops=n_ops / ms * 1e-9, library_tflops=n_ops / lib * 1e-9)


def phase_xent(torch, xent, dev):
    """xent_fwd against plain_xent at the flagship's [2048, 32000], with
    labels -1 and V mixed in; timed in bf16."""
    N, V = 2048, 32000
    g = torch.Generator(device=dev).manual_seed(1)
    labels = torch.randint(0, V, (N,), generator=g, device=dev)
    labels[::97] = -1
    labels[5::89] = V
    tol = 1e-5   # relative: both compute in fp32 from the same inputs
    main_err = None
    for dt in (torch.bfloat16, torch.float32):
        logits = (torch.randn(N, V, generator=g, device=dev) * 2.0).to(dt)
        loss, lse = xent.xent_fwd_cuda(logits, labels)
        loss_ref, lse_ref = xent.plain_xent(logits, labels)
        torch.cuda.synchronize()
        e = max(max_err(loss, loss_ref), max_err(lse, lse_ref))
        rel = float(torch.maximum(
            ((loss - loss_ref).abs() / loss_ref.abs().clamp_min(1e-6)).max(),
            ((lse - lse_ref).abs() / lse_ref.abs()).max()))
        oor = (labels < 0) | (labels >= V)
        say("xent_fwd", shape=f"{N}x{V}", dtype=str(dt).split(".")[-1],
            max_abs_err=e, max_rel_err=rel, tol_rel=tol,
            out_of_range_labels=int(oor.sum()))
        check(rel <= tol, f"xent_fwd disagrees with the plain version in "
                          f"{dt}: relative {rel} > {tol}")
        check(bool(torch.equal(loss[oor], lse[oor])),
              "an out-of-range label must give loss = lse")
        if main_err is None:
            main_err = e

    logits = (torch.randn(N, V, generator=g, device=dev) * 2.0).to(
        torch.bfloat16)
    ms = time_ms(lambda: xent.xent_fwd_cuda(logits, labels))
    plain = time_ms(lambda: xent.plain_xent(logits, labels))
    lib = time_ms(lambda: torch.logsumexp(logits, dim=-1))
    n_bytes = N * V * 2 + N * 8 + 2 * N * 4     # logits, labels in; 2 out
    n_ops = N * V * 4                           # max, subtract, exp, add
    b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    say("xent_fwd", timed="2048x32000 bf16", ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=b_ms, bound_by=b_by)
    return dict(name="xent_fwd", route="cuda",
                source="horovod_tpu_torch/csrc/xent_fwd.cu",
                replaces="horovod_tpu/ops/pallas_xent.py:43",
                max_abs_err=main_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


# ResNet-50's batch norms at 224: (channels, side, layers), 53 layers,
# 11,113,984 elements an image (perfbench/bytes.py counts the same)
BN_RESNET50 = ((64, 112, 1), (64, 56, 6), (256, 56, 4), (128, 56, 1),
               (128, 28, 7), (512, 28, 5), (256, 28, 1), (256, 14, 11),
               (1024, 14, 7), (512, 14, 1), (512, 7, 5), (2048, 7, 4))
BN_BATCH = 256
BN_TIMED = {"stem": (64, 112), "stage1": (256, 56), "stage4": (2048, 7)}
# the kernels' fp64 sums against fp64 sums of the same values, as a share
# of Σ|term|: an element's term is off by at most a few fp32 roundings
# (x̂ is formed in fp32), and a term left out or a channel mixed up moves
# a sum by far more than this
BN_SUM_TOL = 1e-6


def bn_inputs(torch, C, side, dev, g, n=BN_BATCH):
    """bf16 channels_last activations of a ResNet-50 layer with a spread and
    an offset of their own in every channel, a cotangent that leans on x
    (so that neither Σdy nor Σdy·x̂ is near 0), and a scale and bias away
    from 1 and 0: ``(x, dy, scale, bias)``."""
    ch = dict(device=dev, dtype=torch.float32)
    spread = torch.linspace(0.5, 2.0, C, **ch).view(1, C, 1, 1)
    ramp = torch.linspace(-2.0, 2.0, C, **ch).view(1, C, 1, 1)
    lean = torch.linspace(-1.0, 1.5, C, **ch).view(1, C, 1, 1)
    x = torch.randn(n, C, side, side, generator=g, device=dev) * 1.5 \
        * spread + 0.3 + ramp
    dy = x * lean + 0.5 * torch.randn(n, C, side, side, generator=g,
                                      device=dev)
    x, dy = (t.to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last) for t in (x, dy))
    scale = torch.rand(C, generator=g, device=dev) + 0.5
    bias = torch.randn(C, generator=g, device=dev)
    return x, dy, scale, bias


def bn_check(torch, bn, x, dy, scale, bias) -> dict:
    """The four kernels at one layer against the plain stages: the sums
    within BN_SUM_TOL of fp64 sums of the same values, and from the
    kernels' own sums y, mean, var, rstd, the running averages and dx to
    the bit."""
    C, f64 = x.shape[1], torch.float64

    def off(got, want, bound):
        return float(((got - want).abs() / bound.clamp_min(1e-30)).max())

    st = bn.stats_cuda(x, 1)
    want = bn.plain_stats(x.to(f64), 1)
    ab = bn.plain_stats(x.to(f64).abs(), 1)
    e_stats = max(off(st[:C], want[:C], ab[:C]),
                  off(st[C:2 * C], want[C:2 * C], ab[C:2 * C]))
    runs = [bn.Running(torch.linspace(-1, 1, C, device=x.device),
                       torch.linspace(0.5, 2, C, device=x.device), 0.9, 0.1,
                       False) for _ in range(2)]
    y, mean, var, rstd = bn.normalize_cuda(x, st, scale, bias, 1e-5, 1,
                                           x.dtype, runs[0])
    ref = bn.plain_normalize(x, st, scale, bias, 1e-5, 1, x.dtype)
    bn.plain_update_running(runs[1], ref[1], ref[2], st[2 * C].float())
    same_fwd = all(torch.equal(a, b) for a, b in zip(
        (y, mean, var, rstd, runs[0].mean, runs[0].var),
        (*ref, runs[1].mean, runs[1].var)))
    del y, ref
    sums = bn.grad_sums_cuda(x, dy, mean, rstd, 1)
    xc = x.to(f64) - mean.to(f64).view(1, C, 1, 1)
    zero, r64 = torch.zeros_like(mean, dtype=f64), rstd.to(f64)
    want = bn.plain_grad_sums(xc, dy.to(f64), zero, r64, 1)
    ab = bn.plain_grad_sums(xc.abs(), dy.to(f64).abs(), zero, r64, 1)
    del xc
    e_grad = max(off(sums[:C], want[:C], ab[:C]),
                 off(sums[C:], want[C:], ab[C:]))
    dx = bn.grad_input_cuda(x, dy, mean, rstd, scale, sums, st[2 * C], 1)
    dx_ref = bn.plain_grad_input(x, dy, mean, rstd, scale, sums, st[2 * C], 1)
    same_dx = torch.equal(dx, dx_ref)
    # how far Σdy and Σdy·x̂ are from 0, as a share of Σ|term| (median over
    # the channels): sums near 0 would not show a term left out
    lean = min(float((want[:C].abs() / ab[:C]).median()),
               float((want[C:].abs() / ab[C:]).median()))
    return dict(stats_off=e_stats, grad_sums_off=e_grad,
                y_stats_running_same_bits=same_fwd, dx_same_bits=same_dx,
                grad_sum_share=lean, n=float(st[2 * C]))


def phase_bn(torch, dev):
    """csrc/batch_norm.cu at ResNet-50's shapes (bf16, channels_last, batch
    256): at every layer shape each kernel held to its plain stage
    (:func:`bn_check`), the zoo layer's four launches and its y and dx to
    the bit of the plain stages fed its kernels' sums; each stage's kernel
    time beside the bound of the five passes the layer needs (x read and y
    written forward, x and dy read and dx written backward, at 3.35 TB/s),
    the plain stages' time and cuDNN's batch norm (``torch.batch_norm``,
    which the port never calls); every layer shape's time, summed to a
    step's batch norm time. Registers and spills from ptxas."""
    from horovod_tpu_torch.models._flax import BatchNorm
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import batch_norm as bn
    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(11)

    # the zoo layer at the stem: its four launches, and y and dx as the
    # plain stages give them from the sums its kernels took
    x, dy, scale, bias = bn_inputs(torch, 64, 112, dev, g)
    m = BatchNorm(64, dtype=bf, device=dev)
    with torch.no_grad():
        m.scale.copy_(scale)
        m.bias.copy_(bias)
    before = bn.launch_kernel.launches
    xs = x.clone().requires_grad_()
    y = m(xs)
    y.backward(dy)
    torch.cuda.synchronize()
    launches = bn.launch_kernel.launches - before
    st = bn.stats_cuda(x, 1)
    ref = bn.plain_normalize(x, st, scale, bias, 1e-5, 1, bf)
    sums = bn.grad_sums_cuda(x, dy, ref[1], ref[3], 1)
    dx_ref = bn.plain_grad_input(x, dy, ref[1], ref[3], scale, sums,
                                 st[128], 1)
    same = torch.equal(y, ref[0]) and torch.equal(xs.grad, dx_ref)
    say("bn", check="zoo layer 256x64x112x112 bf16 channels_last",
        launches=launches, y_dx_same_bits=same)
    check(launches == 4, f"the zoo BN layer launched {launches}, not 4")
    check(same, "the zoo BN layer's y or dx differs from the plain stages "
                "fed its kernels' sums")
    del xs, y, ref, dx_ref, m

    timed = {}
    model_ms = 0.0
    for C, side, layers in BN_RESNET50:
        x, dy, scale, bias = bn_inputs(torch, C, side, dev, g)
        got = bn_check(torch, bn, x, dy, scale, bias)
        say("bn", check=f"{BN_BATCH}x{C}x{side}x{side}", **got,
            tol=BN_SUM_TOL)
        check(got["stats_off"] <= BN_SUM_TOL
              and got["grad_sums_off"] <= BN_SUM_TOL,
              f"batch norm kernels' sums at C {C}, side {side}: {got}")
        check(got["y_stats_running_same_bits"] and got["dx_same_bits"],
              f"batch norm kernels differ from the plain stages at C {C}, "
              f"side {side}: {got}")
        check(got["grad_sum_share"] >= 100 * BN_SUM_TOL,
              f"the cotangent's sums at C {C}, side {side} are too near 0 "
              f"to show a fault: {got}")
        run = bn.Running(torch.zeros(C, device=dev), torch.ones(C, device=dev),
                         0.9, 0.1, False)
        st = bn.stats_cuda(x, 1)
        _, mean, _, rstd = bn.normalize_cuda(x, st, scale, bias, 1e-5, 1, bf,
                                             run)

        def fwd():
            bn.normalize_cuda(x, bn.stats_cuda(x, 1), scale, bias, 1e-5, 1,
                              bf, run)

        def bwd():
            bn.grad_input_cuda(x, dy, mean, rstd, scale,
                               bn.grad_sums_cuda(x, dy, mean, rstd, 1),
                               st[2 * C], 1)

        f_ms, b_ms = time_ms(fwd), time_ms(bwd)
        model_ms += layers * (f_ms + b_ms)
        nbytes = x.numel() * 2
        name = next((k for k, v in BN_TIMED.items() if v == (C, side)), None)
        if name is None:
            say("bn", shape=f"{BN_BATCH}x{C}x{side}x{side}", layers=layers,
                fwd_ms=f_ms, bwd_ms=b_ms,
                bound_ms=5 * nbytes / HBM_BYTES_PER_S * 1e3)
            continue

        def plain_fwd():
            bn.plain_normalize(x, bn.plain_stats(x, 1), scale, bias, 1e-5,
                               1, bf)

        def plain_bwd():
            bn.plain_grad_input(x, dy, mean, rstd, scale,
                                bn.plain_grad_sums(x, dy, mean, rstd, 1),
                                st[2 * C], 1)

        rm, rv = torch.zeros(C, device=dev), torch.ones(C, device=dev)
        xr = x.detach().requires_grad_()
        try:
            yr = torch.batch_norm(xr, scale, bias, rm, rv, True, 0.1, 1e-5,
                                  True)
            lib_f = time_ms(lambda: torch.batch_norm(
                x, scale, bias, rm, rv, True, 0.1, 1e-5, True))
            lib_b = time_ms(lambda: torch.autograd.grad(yr, xr, dy,
                                                        retain_graph=True))
        except RuntimeError as e:   # a yardstick only: say why, go on
            lib_f = lib_b = f"failed: {str(e).splitlines()[0][:80]}"
            yr = None
        p_f, p_b = time_ms(plain_fwd, iters=5), time_ms(plain_bwd, iters=5)
        bound_f = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        bound_b = 3 * nbytes / HBM_BYTES_PER_S * 1e3
        timed[name] = dict(shape=f"{BN_BATCH}x{C}x{side}x{side}", fwd_ms=f_ms,
                           bwd_ms=b_ms, bound_fwd_ms=bound_f,
                           bound_bwd_ms=bound_b, plain_fwd_ms=p_f,
                           plain_bwd_ms=p_b, library_fwd_ms=lib_f,
                           library_bwd_ms=lib_b,
                           roofline_pct=100 * (bound_f + bound_b)
                           / (f_ms + b_ms))
        say("bn", timed=name, layers=layers, **timed[name])
        del xr, yr
    elements = sum(C * s * s * n for C, s, n in BN_RESNET50) * BN_BATCH
    bound = 5 * 2 * elements / HBM_BYTES_PER_S * 1e3
    say("bn", model="resnet50 b256 (53 layers, fwd+bwd)", kernel_ms=model_ms,
        bound_ms=bound, roofline_pct=100 * bound / model_ms)
    for kern, r in sorted(_build.ptxas_report("batch_norm").items()):
        if "nv_bfloat16" in kern and ("ILi0ELi8E" in kern or r.get(
                "spill_stores", 0)):
            say("ptxas", kernel=kern, **r)
    return dict(name="batch_norm", route="cuda",
                source="horovod_tpu_torch/csrc/batch_norm.cu",
                replaces="none: XLA-fused jnp (horovod_tpu/train/"
                         "sync_batch_norm.py)", launches_per_layer=launches,
                model_ms=model_ms, model_bound_ms=bound, **{
                    f"{k}_{f}": v[f] for k, v in timed.items()
                    for f in ("fwd_ms", "bwd_ms", "plain_fwd_ms",
                              "plain_bwd_ms", "library_fwd_ms",
                              "library_bwd_ms")})


def ulps(a, b) -> int:
    """The largest ULP distance between two fp32 tensors of one sign."""
    import torch
    return int((a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs().max())


# shape, row set to zero (None: none). [33, 128] is ragged against the
# Pallas 32-row tile; block 100 meets the JAX XLA path (its rows of fp32 take
# 16-byte vectors here); block 1030 is no multiple of 4, so it takes the
# kernels' scalar path, and longer than 1024, so the quantizers read it twice
QUANT_CASES = [(QUANT_SHAPE, None), ((33, 128), None), ((77, 100), None),
               ((6, 256), 3), ((5, 1030), None)]
_PALLAS = "horovod_tpu/ops/pallas_quantize.py"
_NO_LIBRARY = "none: no single PyTorch call computes it"


def _record(name, line, err, timing):
    return dict(name=name, route="cuda",
                source="horovod_tpu_torch/csrc/quantize.cu",
                replaces=f"{_PALLAS}:{line}", max_abs_err=err, **timing)


def _timing(name, kernel, plain, library, n_bytes, n_ops, why_none=None):
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    lib = time_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(n_bytes, n_ops, FP32_FLOPS)
    say(name, timed=f"{QUANT_SHAPE[0]}x{QUANT_SHAPE[1]} fp32", ms=ms,
        plain_ms=plain_ms, library_ms=lib if lib is not None else why_none,
        bound_ms=b_ms, bound_by=b_by)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by)


def phase_quantizers(torch, quantize, dev):
    """quantize and quantize_ef against plain_quantize(_ef). The kernels do
    the plain versions' IEEE operations in the same order (rintf, IEEE
    divisions, unfused products), so they are held to equality: no code
    differs, scales at 0 ULP, and codes·scale and the residual within
    QUANT_TOL on every element; then timed."""
    g = torch.Generator(device=dev).manual_seed(2)
    out = []
    for name, line, kernel, plain in (
            ("quantize", 38, quantize.quantize_cuda, quantize.plain_quantize),
            ("quantize_ef", 108, quantize.quantize_ef_cuda,
             quantize.plain_quantize_ef)):
        main_err = None
        for shape, zero_row in QUANT_CASES:
            dtypes = ((torch.float32, torch.bfloat16) if shape == QUANT_SHAPE
                      else (torch.float32,))
            for dt in dtypes:
                x = torch.randn(*shape, generator=g, device=dev).to(dt)
                if zero_row is not None:
                    x[zero_row] = 0.0
                got, ref = kernel(x), plain(x)
                torch.cuda.synchronize()
                code = (got[0].int() - ref[0].int()).abs()
                kv = dict(max_code_diff=int(code.max()),
                          codes_differing=int((code != 0).sum()),
                          scale_ulps=ulps(got[1], ref[1]),
                          max_abs_err_dequantized=max_err(
                              got[0].float() * got[1],
                              ref[0].float() * ref[1]))
                err = kv["max_abs_err_dequantized"]
                if name == "quantize_ef":
                    kv["max_abs_err_residual"] = max_err(got[2], ref[2])
                    err = max(err, kv["max_abs_err_residual"])
                say(name, shape=f"{shape[0]}x{shape[1]}",
                    dtype=str(dt).split(".")[-1], zero_row=zero_row,
                    tol=QUANT_TOL, **kv)
                check(kv["codes_differing"] == 0 and kv["scale_ulps"] == 0
                      and err <= QUANT_TOL,
                      f"{name} disagrees with the plain version at {shape} "
                      f"{dt}: {kv}")
                if zero_row is not None:
                    check(float(got[1][zero_row]) == 1.0
                          and not got[0][zero_row].any(),
                          f"{name}: an all-zero row must give scale 1 and "
                          f"zero codes")
                if main_err is None:
                    main_err = err
        x = torch.randn(*QUANT_SHAPE, generator=g, device=dev)
        n, rows = x.numel(), QUANT_SHAPE[0]
        n_bytes = n * 4 + n + rows * 4 + (n * 4 if name == "quantize_ef"
                                          else 0)
        timing = _timing(name, lambda: kernel(x), lambda: plain(x), None,
                         n_bytes, n * (6 if name == "quantize_ef" else 4),
                         _NO_LIBRARY + " (per-row absmax, divide, round)")
        out.append(_record(name, line, main_err, timing))
    return out


def phase_optimizer_kernels(torch, quantize, dev):
    """dequantize, fused_sgd0, fused_sgd and fused_adam against their plain
    versions on the same codes, scales and moments, at the main paths'
    hyperparameters: every output within QUANT_TOL; then timed."""
    from horovod_tpu_torch import fused_adam
    from horovod_tpu_torch.profile_step import (ADAM_LR, SGD_LR,
                                                SGD_MOMENTUM)
    g = torch.Generator(device=dev).manual_seed(3)
    spec = fused_adam(ADAM_LR)
    lr, b1, b2, eps = spec.lr, spec.b1, spec.b2, spec.eps
    t = 3
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    specs = (
        ("dequantize", 49, lambda a: quantize.dequantize_cuda(a[0], a[1]),
         lambda a: quantize.plain_dequantize(a[0], a[1])),
        ("fused_sgd0", 206,
         lambda a: quantize.fused_sgd0_cuda(a[0], a[1], SGD_LR),
         lambda a: quantize.plain_fused_sgd0(a[0], a[1], SGD_LR)),
        ("fused_sgd", 212,
         lambda a: quantize.fused_sgd_cuda(a[0], a[1], a[2], SGD_LR,
                                           SGD_MOMENTUM),
         lambda a: quantize.plain_fused_sgd(a[0], a[1], a[2], SGD_LR,
                                            SGD_MOMENTUM)),
        ("fused_adam", 221,
         lambda a: quantize.fused_adam_cuda(a[0], a[1], a[2], a[3], lr, b1,
                                            b2, eps, bc1, bc2),
         lambda a: quantize.plain_fused_adam(a[0], a[1], a[2], a[3], lr, b1,
                                             b2, eps, bc1, bc2)),
    )

    def operands(shape, zero_row):
        x = torch.randn(*shape, generator=g, device=dev)
        if zero_row is not None:
            x[zero_row] = 0.0
        vals, scales = quantize.plain_quantize(x)
        mom = torch.randn(*shape, generator=g, device=dev) * 0.1
        # a second moment of the same scale as the first, as Adam keeps it,
        # so the deltas stay near lr (a vanishing v would make them large)
        vel = (torch.randn(*shape, generator=g, device=dev) * 0.1).square() \
            + 1e-6
        return vals, scales, mom, vel

    out = []
    for name, line, kernel, plain in specs:
        main_err = None
        for shape, zero_row in QUANT_CASES:
            a = operands(shape, zero_row)
            got, ref = kernel(a), plain(a)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = [max_err(x, y) for x, y in zip(got, ref)]
            say(name, shape=f"{shape[0]}x{shape[1]}", zero_row=zero_row,
                max_abs_err=",".join(map(str, errs)), tol=QUANT_TOL)
            check(max(errs) <= QUANT_TOL, f"{name} disagrees with the plain "
                                          f"version at {shape}: {errs}")
            if main_err is None:
                main_err = max(errs)
        a = operands(QUANT_SHAPE, None)
        n, rows = a[0].numel(), QUANT_SHAPE[0]
        state = {"dequantize": 0, "fused_sgd0": 0, "fused_sgd": 1,
                 "fused_adam": 2}[name]
        # codes and scales in, the state read and written, one fp32 output
        n_bytes = n + rows * 4 + state * 2 * n * 4 + n * 4
        n_ops = n * {"dequantize": 1, "fused_sgd0": 2, "fused_sgd": 4,
                     "fused_adam": 14}[name]
        library, why = None, _NO_LIBRARY
        if name == "dequantize":
            library = lambda: torch.mul(a[0], a[1])          # noqa: E731
        elif name == "fused_adam":
            # one fused Adam step on the same (already dequantized) fp32
            # gradient: it skips the dequantize, a lower yardstick
            p = torch.nn.Parameter(torch.zeros(QUANT_SHAPE, device=dev))
            p.grad = quantize.plain_dequantize(a[0], a[1])
            adam = torch.optim.Adam([p], lr=lr, betas=(b1, b2), eps=eps,
                                    fused=True)
            library = adam.step
        timing = _timing(name, lambda: kernel(a), lambda: plain(a), library,
                         n_bytes, n_ops, why)
        out.append(_record(name, line, main_err, timing))
    return out


def drive_int8_path(torch, label, factory, pair, cfg, init_sd, batch,
                    counters, quant, phase="int8_"):
    """Five train steps of the flagship from the seed-0 weights through
    ``make_train_step`` with the optimizer ``factory`` builds; the counters
    are zeroed just before and read just after. Returns (losses, launches
    of ``quant``'s kernels by name, median step ms)."""
    from horovod_tpu_torch.models import (Transformer, init_opt_state,
                                          make_train_step)
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = init_opt_state(factory, model)
    step = make_train_step(cfg)
    for c in (*counters, *quant.values()):
        c.launches = 0
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss, _ = step(model, opt, *batch)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
    got = {name: fn.launches for name, fn in quant.items()}
    flash, xent = (c.launches for c in counters)
    timed = sorted(step_s[1:])
    med = timed[len(timed) // 2]
    n_leaves = len(list(model.parameters()))
    say(f"{phase}{label}", steps=TRAIN_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        step_ms=",".join(f"{1e3 * s:.3f}" for s in step_s),
        median_step_ms_after_warmup=1e3 * med,
        tokens_per_s=batch[0].numel() / med,
        launches=",".join(f"{k}:{v}" for k, v in got.items()),
        flash_attention_fwd=flash, xent_fwd=xent)
    check(all(map(math.isfinite, losses)), f"{label}: non-finite loss "
                                           f"{losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    want = {k: (n_leaves * TRAIN_STEPS if k in pair else 0) for k in quant}
    check(got == want, f"{label}: quantize kernels launched {got}, "
                       f"expected {want}")
    check((flash, xent) == (cfg.n_layers * TRAIN_STEPS, TRAIN_STEPS),
          f"{label}: flash/xent launched {(flash, xent)}")
    del model, opt
    return losses, got, 1e3 * med


def rel_l2(a, b, floor: float = 1e-30) -> float:
    """||a − b|| / max(||b||, floor) in fp64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(floor))


def grad_errors(grads, ref, floor: float = 1e-30) -> dict:
    """Per parameter: relative L2 distance (to the larger of the leaf's
    norm and ``floor``) and max abs error."""
    return {k: (rel_l2(grads[k], ref[k], floor), max_err(grads[k], ref[k]))
            for k in ref}


def params_digest(model) -> str:
    """sha256 over every parameter's bytes, in state_dict order."""
    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def drive_dp(torch, hvd, label, mesh, cfg, init_sd, batch, counters,
             quant, compression=None, no_sync=False):
    """Five AdamW steps of the overlap engine from the seed-0 weights, the
    counters zeroed just before and read just after. ``no_sync`` runs each
    guarded step with ``torch.cuda.set_sync_debug_mode("error")``: a host
    sync inside it raises. Returns (losses, step 1's synced gradients,
    launches by kernel name, median step ms)."""
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          lm_loss)
    from horovod_tpu_torch.profile_step import DP_MICRO
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = init_opt_state(adamw, model)
    step = hvd.make_overlap_train_step(lm_loss, mesh, "dp", n_micro=DP_MICRO,
                                       compression=compression)
    local = hvd.shard_batch(*batch, mesh)
    for c in (*counters, *quant.values()):
        c.launches = 0
    losses, step_s, grads1 = [], [], None
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_host_sync(torch, no_sync):
            _, _, loss = step(model, opt, local)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            grads1 = {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()}
    step.flush()
    launches = {"flash_attention_fwd": counters[0].launches,
                "xent_fwd": counters[1].launches,
                **{k: fn.launches for k, fn in quant.items()}}
    med = sorted(step_s[1:])[(len(step_s) - 1) // 2]
    say(label, steps=TRAIN_STEPS, n_micro=DP_MICRO,
        sync_debug_mode="error" if no_sync else "default",
        losses=",".join(f"{x:.6f}" for x in losses),
        step_ms=",".join(f"{1e3 * t:.3f}" for t in step_s),
        median_step_ms_after_warmup=1e3 * med,
        tokens_per_s=batch[0].numel() / med, skipped=step.skipped,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    check(all(map(math.isfinite, losses)), f"{label}: non-finite loss "
                                           f"{losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    check(step.skipped == 0, f"{label}: the guard skipped a step")
    del model, opt
    return losses, grads1, launches, 1e3 * med


class no_host_sync:
    """``torch.cuda.set_sync_debug_mode("error")`` inside the block (when
    ``on``): an operation that syncs the host with the card raises."""

    def __init__(self, torch, on: bool = True):
        self.torch, self.on = torch, on

    def __enter__(self):
        if self.on:
            self.torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        if self.on:
            self.torch.cuda.set_sync_debug_mode("default")


def reset_observability() -> None:
    """Fresh process-wide observability state: registry, flight ring,
    time series, goodput ledger, anomaly engine and profile manager."""
    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics import anomaly, goodput, timeseries
    from horovod_tpu_torch.metrics.registry import default_registry
    default_registry().clear()
    recorder().clear()
    timeseries.reset()
    goodput.reset()
    anomaly.reset()
    profiling.reset()


def observed_steps(cb, n, step_fn):
    """``n`` steps of ``step_fn`` (returning the loss tensor) inside the
    callback, the loss read inside the step; returns the losses."""
    losses = []
    for _ in range(n):
        cb.on_step_begin()
        losses.append(float(step_fn()))
        cb.on_step_end()
    return losses


def quartiles_ms(seconds) -> str:
    """First quartile, median and third quartile of ``seconds``, in ms."""
    s = sorted(seconds)
    return ",".join(f"{1e3 * s[(len(s) - 1) * k // 4]:.6f}" for k in (1, 2, 3))


def trace_kernel_names(path: str) -> list:
    """The device kernels a capture's Chrome trace names."""
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f).get("traceEvents", [])
    return sorted({e.get("name", "") for e in events
                   if e.get("cat") == "kernel"})


def phase_telemetry(torch, cfg, init_sd, batch, counters):
    """[telemetry]: the flagship's AdamW steps inside TelemetryCallback,
    every check of the module docstring. Returns the kernels' launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.metrics import anomaly, goodput, mfu, timeseries
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_grad_fn, make_train_step)
    from horovod_tpu_torch.profiling import attribution
    tokens, targets = batch
    knobs = ("HVD_TPU_GOODPUT_WINDOW", "HVD_TPU_OBS_DIR",
             "HVD_TPU_PROFILE_DIR")
    with tempfile.TemporaryDirectory(prefix="telemetry_") as tmp:
        obs, prof = os.path.join(tmp, "obs"), os.path.join(tmp, "profile")
        os.environ.update(zip(knobs, (str(TELEMETRY_WINDOW), obs, prof)))
        reset_observability()
        model = Transformer(cfg)
        model.load_state_dict(init_sd)
        opt = init_opt_state(adamw, model)
        step = make_train_step(cfg)
        grad_fn = make_grad_fn(cfg)
        cb = hvd.TelemetryCallback(
            units_per_step=tokens.numel(), unit="tokens",
            lowerable=lambda: (grad_fn, (model, tokens, targets)),
            profile_steps=2)
        for c in counters:
            c.launches = 0
        losses = observed_steps(cb, TELEMETRY_STEPS, lambda: step(
            model, opt, tokens, targets)[2])
        launches = {"flash_attention_fwd": counters[0].launches,
                    "xent_fwd": counters[1].launches}
        reg = hvd.metrics_snapshot()["registry"]
        gp = goodput.snapshot()
        windows = list(goodput.ledger().recent)
        points = [p for p in timeseries.read_series(obs) if "step" in p]
        caps = profiling.recent_captures()
        kernels = trace_kernel_names(caps[0]["path"]) if caps else []
        meta = Transformer(cfg, device="meta")
        cpu_flops = mfu.flops_per_step(make_grad_fn(cfg), meta,
                                       tokens.to("meta"), targets.to("meta"))
        card_flops = cb.timer.flops_per_step
        peak = mfu.device_peak_flops()
        mfu_v = reg.get("hvd_mfu", {}).get("value")
        att = attribution.attribute(gp, mfu=mfu_v)
        n_params = sum(p.numel() for p in model.parameters())
        analytic = mfu.analytic_flops(n_params, tokens.numel(), cfg.n_layers,
                                      tokens.shape[1], cfg.d_model)

        # the callback's cost: plain and observed steps in turns, which
        # goes first swapped every pair; the hooks' own host time apart,
        # and the StepTimer's MFU of each observed step
        plain_s, observed_s, hooks_s, step_mfus = [], [], [], []
        caps_before = len(profiling.recent_captures())
        findings_before = len(anomaly.recent_findings())
        for i in range(TELEMETRY_PAIRS):
            for observed in ((False, True) if i % 2 else (True, False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not observed:
                    float(step(model, opt, tokens, targets)[2])
                    plain_s.append(time.perf_counter() - t0)
                    continue
                cb.on_step_begin()
                t1 = time.perf_counter()
                float(step(model, opt, tokens, targets)[2])
                t2 = time.perf_counter()
                cb.on_step_end()
                t3 = time.perf_counter()
                observed_s.append(t3 - t0)
                hooks_s.append((t1 - t0) + (t3 - t2))
                step_mfus.append(cb.timer.last_mfu)
        pair_captures = len(profiling.recent_captures()) - caps_before
        pair_findings = [f["kind"] for f in
                         anomaly.recent_findings()[findings_before:]]
        for k in knobs:
            os.environ.pop(k)
    n_layers = cfg.n_layers
    flops_rel = (abs(card_flops - cpu_flops) / cpu_flops
                 if card_flops and cpu_flops else None)
    hbm_peak = reg.get("hvd_hbm_peak_bytes", {}).get("value")
    hbm_limit = reg.get("hvd_hbm_limit_bytes", {}).get("value")
    say("telemetry", steps=TELEMETRY_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        pairs=TELEMETRY_PAIRS, step_ms_plain_q1_med_q3=quartiles_ms(plain_s),
        step_ms_observed_q1_med_q3=quartiles_ms(observed_s),
        hooks_ms_q1_med_q3=quartiles_ms(hooks_s),
        mfu_median=sorted(step_mfus)[len(step_mfus) // 2]
        if None not in step_mfus else None,
        pair_captures=pair_captures, pair_findings=",".join(pair_findings),
        mfu=mfu_v, peak_flops=peak, flops_source=cb.flops_source,
        flops_per_step_card=card_flops, flops_per_step_cpu=cpu_flops,
        flops_rel=flops_rel, tol_rel=FLOPS_TOL, flops_analytic=analytic,
        goodput_windows=gp["windows"], books_violations=gp["books_violations"],
        goodput_seconds=json.dumps(gp["seconds"], separators=(",", ":")),
        goodput_fraction=gp["fraction"],
        mfu_attribution=json.dumps(att, separators=(",", ":")),
        series_points=len(points),
        captures=len(caps), capture_bytes=caps[0]["bytes"] if caps else None,
        trace_kernels=len(kernels), hbm_peak_bytes=hbm_peak,
        hbm_limit_bytes=hbm_limit,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"telemetry: losses {losses}")
    check(reg["hvd_steps_total"]["value"] == TELEMETRY_STEPS
          and reg["hvd_step_time_seconds"]["count"] == TELEMETRY_STEPS
          and reg["hvd_tokens_total"]["value"]
          == TELEMETRY_STEPS * tokens.numel(),
          f"telemetry: step/token counts {reg.get('hvd_steps_total')} "
          f"{reg.get('hvd_tokens_total')}")
    check(peak is not None and peak in dict(mfu.PEAK_BF16_FLOPS).values(),
          f"telemetry: no peak-table row for "
          f"{torch.cuda.get_device_name(0)!r}")
    check(mfu_v is not None and 0.0 < mfu_v <= 1.0,
          f"telemetry: hvd_mfu {mfu_v} not in (0, 1]")
    check(cb.flops_source == "counted" and flops_rel is not None
          and flops_rel <= FLOPS_TOL,
          f"telemetry: card FLOPs {card_flops} vs CPU {cpu_flops} "
          f"({cb.flops_source})")
    check(gp["windows"] == 2 and gp["books_violations"] == 0,
          f"telemetry: goodput {gp}")
    check(att is not None and att["kernel_inefficiency"] is not None,
          f"telemetry: MFU attribution {att}")
    for w in windows:
        check(abs(sum(w["seconds"].values()) - w["wall_s"])
              <= goodput.ledger().tolerance * w["wall_s"],
              f"telemetry: goodput window does not close: {w}")
    check(len(points) == TELEMETRY_STEPS,
          f"telemetry: {len(points)} series points")
    check(len(caps) == 1 and caps[0]["bytes"] > 0,
          f"telemetry: captures {caps}")
    for want in ("flash_fwd_kernel", "xent_fwd_kernel"):
        check(any(want in k for k in kernels),
              f"telemetry: the capture names no {want}: {kernels[:20]}")
    check(hbm_peak is not None and hbm_limit is not None
          and 0 < hbm_peak <= hbm_limit,
          f"telemetry: memory gauges {hbm_peak} / {hbm_limit}")
    # one forward more than the steps: the FLOP count runs the step's
    # forward and backward once on the card
    want = {"flash_attention_fwd": n_layers * (TELEMETRY_STEPS + 1),
            "xent_fwd": TELEMETRY_STEPS + 1}
    check(launches == want, f"telemetry: launches {launches}, expected "
                            f"{want}")
    del model, opt
    return launches


def phase_telemetry_fused_adam(torch, cfg, init_sd, batch, counters, quant):
    """[telemetry_fused_adam]: the fused int8 Adam path inside the
    callback; returns its kernels' launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import DistributedOptimizer, ErrorFeedback, fused_adam
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import Transformer, make_train_step
    from horovod_tpu_torch.profile_step import ADAM_LR
    reset_observability()
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = DistributedOptimizer(fused_adam(ADAM_LR), model.named_parameters(),
                               compression=ErrorFeedback(Compression.int8))
    step = make_train_step(cfg)
    cb = hvd.TelemetryCallback(units_per_step=batch[0].numel(),
                               unit="tokens")
    for c in (*counters, *quant.values()):
        c.launches = 0
    losses = observed_steps(cb, OBSERVED_STEPS,
                            lambda: step(model, opt, *batch)[2])
    got = {k: fn.launches for k, fn in quant.items()}
    reg = hvd.metrics_snapshot()["registry"]
    n_leaves = len(list(model.parameters()))
    say("telemetry_fused_adam", steps=OBSERVED_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        steps_total=reg["hvd_steps_total"]["value"],
        launches=",".join(f"{k}:{v}" for k, v in got.items()))
    check(reg["hvd_steps_total"]["value"] == OBSERVED_STEPS,
          "telemetry_fused_adam: step count")
    want = {k: (n_leaves * OBSERVED_STEPS
                if k in ("quantize_ef", "fused_adam") else 0) for k in quant}
    check(got == want, f"telemetry_fused_adam: launches {got}, expected "
                       f"{want}")
    del model, opt
    return got


def phase_dp_nccl(torch, cfg, init_sd, batch, train_losses, counters,
                  quant):
    """[dp_nccl], [dp_nccl_int8], [dp_nccl_fused_adam] and
    [telemetry_dp_int8] over an NCCL process group of world 1. Returns
    launches by phase and kernel, step 1's full-batch gradients, the
    bucket count and [telemetry_dp_int8]'s launches."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import (DistributedOptimizer, ErrorFeedback,
                                   fused_adam)
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import Transformer, make_grad_fn
    from horovod_tpu_torch.profile_step import ADAM_LR, DP_MICRO
    from horovod_tpu_torch.train.buckets import plan_buckets
    from horovod_tpu_torch.train.overlap import jax_ordered_parameters

    hvd.init()
    check(hvd.size() == 1 and dist.get_backend() == "nccl",
          f"expected an NCCL world of 1, got {hvd.size()} "
          f"{dist.get_backend()}")
    mesh = hvd.build_mesh(dp=1)
    ref_model = Transformer(cfg)
    ref_model.load_state_dict(init_sd)
    plan = plan_buckets(jax_ordered_parameters(ref_model)[1])
    say("dp_nccl", world=hvd.size(), backend=dist.get_backend(),
        buckets=plan.num_buckets,
        bucket_bytes=",".join(str(b.nbytes) for b in plan.buckets))
    _, _, ref_grads = make_grad_fn(cfg)(ref_model, *batch)
    del ref_model
    out = {}

    losses, grads1, out["dp_nccl"], _ = drive_dp(
        torch, hvd, "dp_nccl", mesh, cfg, init_sd, batch, counters, quant,
        no_sync=True)
    errs = grad_errors(grads1, ref_grads)
    worst = max(errs, key=lambda k: errs[k][0])
    rel = abs(losses[0] - train_losses[0]) / abs(train_losses[0])
    say("dp_nccl", step1_loss=losses[0], train_step1_loss=train_losses[0],
        rel=rel, tol_rel=DP_LOSS_TOL, worst_grad=worst,
        grad_rel_l2=errs[worst][0], grad_max_abs_err=errs[worst][1],
        tol_grad_rel_l2=DP_GRAD_TOL)
    check(rel <= DP_LOSS_TOL, f"dp_nccl: step 1 loss {losses[0]} is {rel} "
                              f"off the one-process {train_losses[0]}")
    check(errs[worst][0] <= DP_GRAD_TOL,
          f"dp_nccl: synced gradient of {worst} is {errs[worst][0]} off "
          f"the full-batch gradient")
    n_layers = cfg.n_layers
    want = {"flash_attention_fwd": n_layers * DP_MICRO * TRAIN_STEPS,
            "xent_fwd": DP_MICRO * TRAIN_STEPS, **{k: 0 for k in quant}}
    check(out["dp_nccl"] == want, f"dp_nccl: launches {out['dp_nccl']}, "
                                  f"expected {want}")
    base5 = losses[-1]

    losses, grads1, out["dp_nccl_int8"], _ = drive_dp(
        torch, hvd, "dp_nccl_int8", mesh, cfg, init_sd, batch, counters,
        quant, compression=Compression.int8)
    errs = grad_errors(grads1, ref_grads)
    worst = max(errs, key=lambda k: errs[k][0])
    rel = abs(losses[-1] - base5) / abs(base5)
    say("dp_nccl_int8", loss5=losses[-1], dp_nccl_loss5=base5, rel=rel,
        tol_rel=DP_INT8_TOL, worst_grad=worst, grad_rel_l2=errs[worst][0])
    check(rel <= DP_INT8_TOL, f"dp_nccl_int8: 5th loss {losses[-1]} is "
                              f"{rel} off dp_nccl's {base5}")
    per = plan.num_buckets * DP_MICRO * TRAIN_STEPS
    want = {"flash_attention_fwd": n_layers * DP_MICRO * TRAIN_STEPS,
            "xent_fwd": DP_MICRO * TRAIN_STEPS,
            **{k: (per if k in ("quantize", "dequantize") else 0)
               for k in quant}}
    check(out["dp_nccl_int8"] == want,
          f"dp_nccl_int8: launches {out['dp_nccl_int8']}, expected {want}")

    axis = mesh.axis("dp")
    path_losses, got, _ = drive_int8_path(
        torch, "fused_adam", lambda ps: DistributedOptimizer(
            fused_adam(ADAM_LR), ps,
            compression=ErrorFeedback(Compression.int8), axis=axis),
        ("quantize_ef", "dequantize"), cfg, init_sd, batch, counters, quant,
        phase="dp_nccl_")
    out["dp_nccl_fused_adam"] = {"flash_attention_fwd": counters[0].launches,
                                 "xent_fwd": counters[1].launches, **got}
    rel = abs(path_losses[-1] - train_losses[-1]) / abs(train_losses[-1])
    say("dp_nccl_fused_adam", loss5=path_losses[-1],
        adamw_loss5=train_losses[-1], rel=rel, tol_rel=EF_LOSS_TOL)
    check(rel <= EF_LOSS_TOL, f"dp_nccl_fused_adam: 5th loss "
                              f"{path_losses[-1]} is {rel} off AdamW's")
    observed = phase_telemetry_dp_int8(torch, hvd, mesh, cfg, init_sd, batch,
                                       counters, quant, plan)
    hvd.shutdown()
    return out, ref_grads, plan.num_buckets, observed


def phase_telemetry_dp_int8(torch, hvd, mesh, cfg, init_sd, batch, counters,
                            quant, plan):
    """[telemetry_dp_int8]: [dp_nccl_int8]'s step inside the callback. The
    plan gauges must equal the plan, and the int8 byte counters the bytes
    of the buckets' quantized slices: per bucket and microbatch, 4 bytes
    an fp32 element before, and a byte an element plus a 4-byte scale a
    block of the padded slice on the wire."""
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          lm_loss)
    from horovod_tpu_torch.profile_step import DP_MICRO
    from horovod_tpu_torch.train.overlap import jax_ordered_parameters
    reset_observability()
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = init_opt_state(adamw, model)
    step = hvd.make_overlap_train_step(lm_loss, mesh, "dp", n_micro=DP_MICRO,
                                       compression=Compression.int8)
    local = hvd.shard_batch(*batch, mesh)
    cb = hvd.TelemetryCallback(units_per_step=batch[0].numel(),
                               unit="tokens")
    for c in (*counters, *quant.values()):
        c.launches = 0
    losses = observed_steps(cb, OBSERVED_STEPS,
                            lambda: step(model, opt, local)[2])
    step.flush()
    launches = {"flash_attention_fwd": counters[0].launches,
                "xent_fwd": counters[1].launches,
                **{k: fn.launches for k, fn in quant.items()}}
    reg = hvd.metrics_snapshot()["registry"]
    leaves = jax_ordered_parameters(model)[1]
    block = Compression.int8.block_size
    calls = OBSERVED_STEPS * DP_MICRO
    numels = [sum(leaves[i].numel() for i in b.indices)
              for b in plan.buckets]
    want_pre = calls * sum(4 * n for n in numels)
    want_wire = calls * sum(-(-n // block) * (block + 4) for n in numels)
    pre = reg['hvd_compression_pre_bytes_total{codec="int8"}']["value"]
    wire = reg['hvd_compression_wire_bytes_total{codec="int8"}']["value"]
    ratio = reg['hvd_compression_ratio{codec="int8"}']["value"]
    count = reg["hvd_overlap_bucket_count"]["value"]
    nbytes = reg["hvd_overlap_bucket_bytes"]["value"]
    say("telemetry_dp_int8", steps=OBSERVED_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        bucket_count=count, bucket_bytes=nbytes, pre_bytes=pre,
        wire_bytes=wire, want_pre_bytes=want_pre, want_wire_bytes=want_wire,
        ratio=ratio, block=block,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    check(reg["hvd_steps_total"]["value"] == OBSERVED_STEPS,
          "telemetry_dp_int8: step count")
    check(count == plan.num_buckets and nbytes == plan.total_bytes,
          f"telemetry_dp_int8: plan gauges {count}, {nbytes} against "
          f"{plan.num_buckets}, {plan.total_bytes}")
    check(pre == want_pre and wire == want_wire,
          f"telemetry_dp_int8: int8 bytes {pre}/{wire}, expected "
          f"{want_pre}/{want_wire}")
    per = plan.num_buckets * calls
    check(launches["quantize"] == per and launches["dequantize"] == per,
          f"telemetry_dp_int8: launches {launches}")
    del model, opt
    return launches


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block and restore them after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run_gloo_ranks(out_dir: str, n: int, role: str, label: str,
                    backend: str = "GLOO", one_host: bool = False,
                    env_extra=None) -> None:
    """Start ``n`` ranks of this script (``--gloo-rank DIR ROLE``), gloo
    world (or ``backend``), all on ``cuda:0`` as one-card hosts (or, with
    ``one_host``, as the local ranks of one host: ``base + local_rank``
    ports apart), with ``env_extra`` and a timeout; kill their process
    groups on the way out, and fail ``label`` if a rank did. The ranks
    write their results to ``out_dir``."""
    reserved = reserve_port()
    port = reserved.getsockname()[1]
    procs, logs = [], []
    for r in range(n):
        env = dict(os.environ, HVD_TPU_RANK=str(r), HVD_TPU_SIZE=str(n),
                   HVD_TPU_LOCAL_RANK="0", HVD_TPU_LOCAL_SIZE="1",
                   HVD_TPU_CROSS_RANK=str(r), HVD_TPU_CROSS_SIZE=str(n),
                   HOROVOD_TPU_OPERATIONS=backend,
                   HVD_TPU_RENDEZVOUS_ADDR="127.0.0.1",
                   HVD_TPU_RENDEZVOUS_PORT=str(port),
                   HVD_TPU_GLOO_TIMEOUT_SECONDS=str(GLOO_TIMEOUT_S))
        if one_host:
            env.update(HVD_TPU_LOCAL_RANK=str(r), HVD_TPU_LOCAL_SIZE=str(n),
                       HVD_TPU_CROSS_RANK="0", HVD_TPU_CROSS_SIZE="1")
        env.update(env_extra or {})
        log = open(os.path.join(out_dir, f"rank{r}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-rank",
             out_dir, role], env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, GLOO_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        reserved.close()
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait(timeout=60)
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"{label}: rank {r} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")


def phase_dp_gloo(torch, ref_grads, n_buckets, n_layers):
    """[dp_gloo_2rank]: two ranks of this script over gloo on cuda:0, with
    a timeout; each writes its results to a file. Returns rank 0's
    launches of the train and overlap_int8 paths (the eager path's are
    checked here and printed)."""
    from horovod_tpu_torch.profile_step import DP_MICRO
    with tempfile.TemporaryDirectory(prefix="dp_gloo_") as out_dir:
        _run_gloo_ranks(out_dir, 2, "dp", "dp_gloo_2rank")
        res = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
        grads = [torch.load(os.path.join(out_dir, f"grads{r}.pt"))
                 for r in range(2)]
    ref = {k: v.cpu() for k, v in ref_grads.items()}
    errs = grad_errors(grads[0], ref)
    worst = max(errs, key=lambda k: errs[k][0])
    same_grads = all(torch.equal(grads[0][k], grads[1][k]) for k in ref)
    for key in ("train", "overlap_int8", "eager_int8"):
        say("dp_gloo_2rank", path=key, seconds=res[0]["seconds"],
            losses=",".join(f"{x:.6f}" for x in res[0][f"{key}_losses"]),
            step_ms=",".join(f"{x:.3f}" for x in res[0][f"{key}_step_ms"]),
            same_params_every_step=res[0][f"{key}_digests"]
            == res[1][f"{key}_digests"],
            launches=",".join(f"{k}:{v}" for k, v in
                              res[0][f"{key}_launches"].items()))
        for rr in res:
            ls = rr[f"{key}_losses"]
            check(all(map(math.isfinite, ls)) and ls[-1] < ls[0],
                  f"dp_gloo_2rank {key}: losses {ls}")
        check(res[0][f"{key}_digests"] == res[1][f"{key}_digests"],
              f"dp_gloo_2rank {key}: the ranks' parameters differ")
    say("dp_gloo_2rank", worst_grad=worst, grad_rel_l2=errs[worst][0],
        grad_max_abs_err=errs[worst][1], tol_grad_rel_l2=DP_GRAD_TOL,
        ranks_same_grads=same_grads)
    check(errs[worst][0] <= DP_GRAD_TOL,
          f"dp_gloo_2rank: synced gradient of {worst} is {errs[worst][0]} "
          f"off the full-batch gradient")
    check(same_grads, "dp_gloo_2rank: the ranks' synced gradients differ")
    per = n_buckets * DP_MICRO * GLOO_STEPS
    want_train = {"flash_attention_fwd": n_layers * GLOO_STEPS,
                  "xent_fwd": GLOO_STEPS}
    want_int8 = {"flash_attention_fwd": n_layers * DP_MICRO * GLOO_STEPS,
                 "xent_fwd": DP_MICRO * GLOO_STEPS, "quantize": per,
                 "quantize_ef": 0, "dequantize": 2 * per, "fused_sgd0": 0,
                 "fused_sgd": 0, "fused_adam": 0}
    for rr in res:
        check(rr["train_launches"] == want_train,
              f"dp_gloo_2rank train: launches {rr['train_launches']}, "
              f"expected {want_train}")
        check(rr["overlap_int8_launches"] == want_int8,
              f"dp_gloo_2rank overlap_int8: launches "
              f"{rr['overlap_int8_launches']}, expected {want_int8}")
    # the eager int8 sync gathers every rank's codes of every leaf and
    # dequantizes both; its bytes are each leaf's, every step
    n_leaves = len(ref)
    want_eager = {"flash_attention_fwd": n_layers * GLOO_STEPS,
                  "xent_fwd": GLOO_STEPS,
                  "quantize": n_leaves * GLOO_STEPS, "quantize_ef": 0,
                  "dequantize": 2 * n_leaves * GLOO_STEPS, "fused_sgd0": 0,
                  "fused_sgd": 0, "fused_adam": 0}
    block = 256
    want_pre = GLOO_STEPS * sum(4 * g.numel() for g in ref.values())
    want_wire = GLOO_STEPS * sum(-(-g.numel() // block) * (block + 4)
                                 for g in ref.values())
    for r, rr in enumerate(res):
        g = rr["eager_gauges"]
        exposed = g.get("hvd_overlap_exposed_comm_seconds")
        sync = g.get("hvd_overlap_sync_seconds")
        say("telemetry_dp_int8", path="eager DistributedOptimizer, "
            "dp_gloo_2rank", rank=r, exposed_comm_s=exposed, sync_s=sync,
            exposed_comm_total_s=g.get(
                "hvd_overlap_exposed_comm_seconds_total"),
            bucket_count=g.get("hvd_overlap_bucket_count"),
            pre_bytes=g.get('hvd_compression_pre_bytes_total{codec="int8"}'),
            wire_bytes=g.get(
                'hvd_compression_wire_bytes_total{codec="int8"}'),
            want_pre_bytes=want_pre, want_wire_bytes=want_wire)
        check(exposed is not None and sync is not None
              and 0 < exposed <= sync,
              f"telemetry_dp_int8: rank {r}'s eager sync gauges {g}")
        check(g.get('hvd_compression_pre_bytes_total{codec="int8"}')
              == want_pre and
              g.get('hvd_compression_wire_bytes_total{codec="int8"}')
              == want_wire, f"telemetry_dp_int8: rank {r}'s eager int8 "
                            f"bytes {g}, expected {want_pre}/{want_wire}")
        check(rr["eager_int8_launches"] == want_eager,
              f"dp_gloo_2rank eager_int8: launches "
              f"{rr['eager_int8_launches']}, expected {want_eager}")
    return {"dp_gloo_2rank": {k: res[0]["train_launches"].get(k, 0)
                              + res[0]["overlap_int8_launches"][k]
                              for k in want_int8}}


def phase_guard(torch, dev):
    """[guard]: guarded AdamW steps of a small model on the card, with a
    NaN batch between two clean ones, every step under the no-host-sync
    mode; the poisoned step is skipped (read one step late), and the
    parameters and optimizer state end bit-equal to two clean steps."""
    from horovod_tpu_torch.models import adamw
    from horovod_tpu_torch.train.guard import (GuardedStep, GuardSpec,
                                               guarded_apply)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(64, 256, generator=g, device=dev)

    def run(batches):
        torch.manual_seed(0)
        lin = torch.nn.Linear(256, 256).to(dev)
        opt = adamw(lin.parameters())

        def fn(m, o, b):
            o.zero_grad(set_to_none=True)
            loss = m(b).square().mean()
            loss.backward()
            return m, o, loss.detach(), guarded_apply(o, GuardSpec())

        step = GuardedStep(fn, GuardSpec())
        for b in batches:
            with no_host_sync(torch):
                step(lin, opt, b)
        step.flush()
        return lin, opt, step.skipped

    lin_a, opt_a, skipped = run([x, x * float("nan"), x])
    lin_b, opt_b, skipped_b = run([x, x])
    same_params = all(torch.equal(a, b) for a, b in
                      zip(lin_a.parameters(), lin_b.parameters()))
    same_state = all(
        torch.equal(torch.as_tensor(opt_a.state[a][k]),
                    torch.as_tensor(opt_b.state[b][k]))
        for a, b in zip(lin_a.parameters(), lin_b.parameters())
        for k in opt_b.state[b])
    say("guard", steps=3, poisoned_step=1, skipped=skipped,
        sync_debug_mode="error", same_params_as_clean_run=same_params,
        same_optimizer_state=same_state)
    check(skipped == 1 and skipped_b == 0,
          f"guard: skipped {skipped} (clean run {skipped_b}), expected 1")
    check(same_params and same_state,
          "guard: the skipped step changed the parameters or the state")


def layout_cfg(moe: bool, sizes=None, depth=None):
    """The flagship at full width (cut to ``depth`` layers when given);
    with 4 experts, top-2, capacity 1.25 (the dry run's MoE config) for an
    MoE phase, and PP_MICRO pipeline microbatches for a layout with pp."""
    from horovod_tpu_torch.entry import _flagship_cfg
    cfg = _flagship_cfg()
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if (sizes or {}).get("pp", 1) > 1:
        cfg = dataclasses.replace(cfg, n_microbatches=PP_MICRO)
    return dataclasses.replace(cfg, n_experts=4) if moe else cfg


def depth_flagship(torch, dev, depth):
    """``entry()``'s flagship at full width cut to ``depth`` layers, with
    the seed-0 weights of the cut configuration."""
    import numpy as np
    from horovod_tpu_torch.models import (Transformer, from_jax_params,
                                          init_params)
    cfg = layout_cfg(False, depth=depth)
    model = Transformer(cfg, dev)
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0), cfg)))
    return model


def flagship_batch(cfg):
    """The seed-1 batch of ``entry()``: B 8 at ``max_seq``, int64."""
    import numpy as np
    import torch
    from horovod_tpu_torch.entry import BATCH
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq))
    return (torch.from_numpy(tokens).long(),
            torch.from_numpy(np.roll(tokens, -1, 1)).long())


def ulysses_rank_check(torch, mesh, dev) -> dict:
    """[ulysses] on this rank: one forward and backward of
    ``ulysses_attention_spmd`` over sp at ULYSSES_SHAPE bf16, held to the
    plain attention in fp32 on the card (its block of the output, and of
    the gradients of ``sum(o * w)``)."""
    from horovod_tpu_torch.ops import attention
    from horovod_tpu_torch.parallel.ring_attention import _plain_attention
    from horovod_tpu_torch.parallel.ulysses import ulysses_attention_spmd
    sp = mesh.axis("sp")
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(*ULYSSES_SHAPE, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(3))
    w = torch.randn(*ULYSSES_SHAPE, generator=g, device=dev)
    n = ULYSSES_SHAPE[1] // sp.size
    blk = slice(sp.index * n, (sp.index + 1) * n)
    local = [x[:, blk].clone().requires_grad_() for x in (q, k, v)]
    before = attention.flash_attn_fwd_cuda.launches
    o = ulysses_attention_spmd(*local, sp, causal=True)
    (o.float() * w[:, blk]).sum().backward()
    launches = attention.flash_attn_fwd_cuda.launches - before
    full = [x.float().requires_grad_() for x in (q, k, v)]
    ref = _plain_attention(*full, causal=True)
    (ref * w).sum().backward()
    torch.cuda.synchronize()
    return {"max_abs_err_o": max_err(o, ref[:, blk]),
            "grad_rel_l2": {c: rel_l2(a.grad, b.grad[:, blk])
                            for c, a, b in zip("qkv", local, full)},
            "launches": launches}


class record_kernel_inputs:
    """Inside the block, the first bf16 ``flash_attn_fwd`` launch of each
    ring kind (``ring_diag``: causal, the rank's own block; ``ring_full``:
    an earlier block) and the first ``xent_fwd`` launch keep a copy of
    their inputs in ``out``. The launch itself is the kernel's, counted as
    before."""

    def __init__(self, out: dict):
        self.out = out

    def __enter__(self):
        import torch
        from horovod_tpu_torch.ops import attention, xent
        self.mods = (attention, xent)
        self.real = (attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda)
        real_attn, real_xent = self.real

        def attn(q, k, v, causal, scale):
            key = "ring_diag" if causal else "ring_full"
            if q.dtype == torch.bfloat16 and key not in self.out:
                self.out[key] = tuple(t.detach().clone() for t in (q, k, v)) \
                    + (causal, scale)
            return real_attn(q, k, v, causal, scale)

        def xe(logits, labels):
            if "xent" not in self.out:
                self.out["xent"] = (logits.detach().clone(), labels.clone())
            return real_xent(logits, labels)

        # a wrapper counts on the function its module's name holds: the
        # spies carry the counts in and out
        attn.launches, xe.launches = real_attn.launches, real_xent.launches
        attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda = attn, xe

    def __exit__(self, *exc):
        attention, xent = self.mods
        real_attn, real_xent = self.real
        real_attn.launches = attention.flash_attn_fwd_cuda.launches
        real_xent.launches = xent.xent_fwd_cuda.launches
        attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda = self.real


def kernels_on_rank_inputs(torch, recorded: dict) -> dict:
    """Each recorded launch run again through the kernel's wrapper and its
    plain version on the same inputs: the errors and their limits."""
    from horovod_tpu_torch.ops import attention, xent
    out = {}
    for key, rec in recorded.items():
        if key == "xent":
            logits, labels = rec
            loss, lse = xent.xent_fwd_cuda(logits, labels)
            loss_ref, lse_ref = xent.plain_xent(logits, labels)
            rel = float(torch.maximum(
                ((loss - loss_ref).abs()
                 / loss_ref.abs().clamp_min(1e-6)).max(),
                ((lse - lse_ref).abs() / lse_ref.abs()).max()))
            out[key] = {"shape": "x".join(map(str, logits.shape)),
                        "max_rel_err": rel, "ok": rel <= LAYOUT_XENT_TOL}
            continue
        q, k, v, causal, scale = rec
        o, lse = attention.flash_attn_fwd_cuda(q, k, v, causal, scale)
        o_ref, lse_ref = attention.plain_attention_with_lse(q, k, v, causal,
                                                            scale)
        e_o = max_err(o, o_ref) / float(o_ref.float().abs().max())
        e_lse = max_err(lse, lse_ref)
        out[key] = {"shape": "x".join(map(str, q.shape)), "causal": causal,
                    "max_rel_err_o": e_o, "max_abs_err_lse": e_lse,
                    "ok": e_o <= LAYOUT_FLASH_O_TOL
                    and e_lse <= LAYOUT_FLASH_LSE_TOL}
    torch.cuda.synchronize()
    return out


def layout_rank_main(out_dir: str, role: str) -> int:
    """One rank of a layout phase (``LAYOUT_PHASES[role]``): the seed-0
    weights sliced for this rank and the seed-1 batch sharded; the
    layout's fp32 loss on the CPU (plain versions); LAYOUT_STEPS AdamW
    steps of ``make_train_step(cfg, mesh)`` on the card with the kernel
    counters zeroed just before and read just after; step 1's synced
    gradients to ``grads<r>.pt``; losses, step ms, launches, this rank's
    mesh coordinates and a digest of each leaf after the last step to
    ``rank<r>.json``; before the steps, the same gradient with fp32
    compute on the card to ``grads32_<r>.pt``; the inputs of step 1's
    first kernel launches, run again through the kernels and their plain
    versions after the counted steps. The [tp_sp] ranks then run
    [ulysses]."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import (Transformer, adamw,
                                          forward_loss_spmd, init_opt_state,
                                          init_params, make_grad_fn,
                                          make_train_step, shard_params)
    from horovod_tpu_torch.ops import attention, mesh_collectives, xent
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r = hvd.rank()
    moe, sizes = LAYOUT_PHASES[role]
    cfg = layout_cfg(moe, sizes, LAYOUT_LAYERS)
    mesh = hvd.build_mesh(**sizes)
    dev = hvd.device()
    sd = shard_params(init_params(np.random.RandomState(0), cfg), cfg, mesh)
    tok, tgt = hvd.shard_batch(*flagship_batch(cfg), mesh)

    cpu_model = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                            "cpu", mesh)
    cpu_model.load_state_dict(sd)
    with torch.no_grad():
        cpu_loss, cpu_aux = forward_loss_spmd(cpu_model, tok, tgt, mesh)
    del cpu_model

    tok, tgt = tok.to(dev), tgt.to(dev)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = Transformer(cfg32, dev, mesh)
    model.load_state_dict(sd)
    _, _, grads32 = make_grad_fn(cfg32, mesh)(model, tok, tgt)
    torch.save({k: g.cpu() for k, g in grads32.items()},
               os.path.join(out_dir, f"grads32_{r}.pt"))
    del model, grads32

    model = Transformer(cfg, dev, mesh)
    model.load_state_dict(sd)
    opt = init_opt_state(adamw, model)
    step = make_train_step(cfg, mesh)
    counters = {"flash_attention_fwd": attention.flash_attn_fwd_cuda,
                "xent_fwd": xent.xent_fwd_cuda}
    for c in counters.values():
        c.launches = 0
    losses, ms, recorded, digests = [], [], {}, []
    for i in range(LAYOUT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (record_kernel_inputs(recorded) if i == 0
              else contextlib.nullcontext()):
            _, _, loss, _ = step(model, opt, tok, tgt)
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            torch.save({k: p.grad.detach().float().cpu()
                        for k, p in model.named_parameters()},
                       os.path.join(out_dir, f"grads{r}.pt"))
        digests.append({k: hashlib.sha256(
            p.detach().cpu().numpy().tobytes()).hexdigest()
            for k, p in model.state_dict().items()})
    res = {"rank": r, "losses": losses, "step_ms": ms,
           "cpu_loss": float(cpu_loss), "cpu_aux": float(cpu_aux),
           "launches": {k: c.launches for k, c in counters.items()},
           "kernel_checks": kernels_on_rank_inputs(torch, recorded),
           "coords": {a: mesh.axis(a).index for a in AXIS_ORDER},
           "digests": digests,
           "gloo_host_staged": list(mesh_collectives.GLOO_HOST_STAGED)}
    del model, opt
    if role == "tp_sp":
        res["ulysses"] = ulysses_rank_check(torch, mesh, dev)
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


class grouped_moe:
    """Inside the block, the model's MoE FFN splits its tokens into
    ``gb x gs`` groups of batch rows and sequence blocks and gates each on
    its own, with its own capacity, as a mesh of that many data shards
    does; the aux loss is the groups' mean."""

    def __init__(self, groups):
        self.groups = groups

    def __enter__(self):
        import torch
        from horovod_tpu_torch.models import transformer
        self.mod, self.real = transformer, transformer._moe_ffn
        gb, gs = self.groups

        def grouped(p, x, cfg, axes):
            rows, auxs = [], []
            for xb in x.chunk(gb, 0):
                outs = []
                for xg in xb.chunk(gs, 1):
                    y, aux = self.real(p, xg, cfg, axes)
                    outs.append(y)
                    auxs.append(aux)
                rows.append(torch.cat(outs, 1))
            return torch.cat(rows, 0), torch.stack(auxs).mean()

        transformer._moe_ffn = grouped

    def __exit__(self, *exc):
        self.mod._moe_ffn = self.real


def layout_reference_grads(torch, moe: bool, sizes: dict, dev,
                           dtype) -> dict:
    """The one-process gradient of the layout's loss on the card, with
    ``dtype`` compute: the full model over the full batch; for MoE the
    grouped reference (:class:`grouped_moe`), each group of tokens (batch
    rows over dp·ep, sequence blocks over sp) gated on its own, as the
    layout gates it."""
    import numpy as np
    from horovod_tpu_torch.models import (Transformer, forward_loss_spmd,
                                          from_jax_params, init_params)
    cfg = dataclasses.replace(layout_cfg(moe, depth=LAYOUT_LAYERS),
                              dtype=dtype)
    model = Transformer(cfg, dev)     # one stage: pp needs no grouping
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0), cfg)))
    tok, tgt = (x.to(dev) for x in flagship_batch(cfg))
    groups = (sizes.get("dp", 1) * sizes.get("ep", 1), sizes.get("sp", 1))
    # grouped_moe swaps a module attribute: only the MoE world may, since
    # the layout worlds compute their references side by side on threads
    with grouped_moe(groups) if moe else contextlib.nullcontext():
        loss, aux = forward_loss_spmd(model, tok, tgt, None)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss + 0.01 * aux, params)
    return {k: g.detach().float() for k, g in zip(names, grads)}


class record_routes:
    """Inside the block, each MoE gating call appends which experts took
    each token (``[G, E]`` bool) to ``out``."""

    def __init__(self, out: list):
        self.out = out

    def __enter__(self):
        from horovod_tpu_torch.parallel import moe
        self.moe, self.real = moe, moe.top_k_gating

        def spy(logits, k, capacity):
            dispatch, combine, metrics = self.real(logits, k, capacity)
            self.out.append((dispatch.detach().sum(-1) > 0).cpu())
            return dispatch, combine, metrics

        moe.top_k_gating = spy

    def __exit__(self, *exc):
        self.moe.top_k_gating = self.real


def _slice_for(t, key, cfg, sizes, coords):
    """The block of a full leaf (layers ``[1, L, ...]``) that the rank at
    ``coords`` holds; the layers viewed as ``[pp, L/pp, ...]`` first."""
    from types import SimpleNamespace
    from horovod_tpu_torch.models import param_shardings
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER
    mesh = SimpleNamespace(shape={a: sizes.get(a, 1) for a in AXIS_ORDER})
    pp = sizes.get("pp", 1)
    if key.startswith("layers."):
        t = t.reshape((pp, t.shape[1] // pp) + tuple(t.shape[2:]))
    for d, a in param_shardings(cfg, mesh)[key].items():
        n = t.shape[d] // sizes[a]
        t = t.narrow(d, coords[a] * n, n)
    return t


def phase_layout(torch, role: str, card: str, dev) -> list:
    """[tp_sp] / [moe_ep_sp] (and [ulysses] in the [tp_sp] world): the
    ranks of LAYOUT_PHASES[role] on cuda:0 over gloo, then every check of
    the module docstring. Returns each rank's kernel launches."""
    from horovod_tpu_torch.models import param_shardings
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER
    moe, sizes = LAYOUT_PHASES[role]
    n = math.prod(sizes.values())
    cfg = layout_cfg(moe, sizes, LAYOUT_LAYERS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"{role}_") as out_dir:
        _run_gloo_ranks(out_dir, n, role, role)
        res, grads, grads32 = [], [], []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
            grads.append(torch.load(os.path.join(out_dir, f"grads{r}.pt")))
            grads32.append(torch.load(os.path.join(out_dir,
                                                   f"grads32_{r}.pt")))
    world_s = time.perf_counter() - t0
    routes32, routes16 = [], []
    # only the MoE world gates: the other layout worlds run beside it on
    # other threads, and a spy of theirs would wrap, or on exit unwrap,
    # this world's spy of the one module attribute
    spy = record_routes if moe else contextlib.nullcontext
    with spy(routes32):
        ref = layout_reference_grads(torch, moe, sizes, dev, torch.float32)

    def per_leaf(rank_grads, full_grads):
        """Each leaf's worst rel L2 over the ranks against the matching
        slice of ``full_grads``."""
        out = {}
        for rr, g in zip(res, rank_grads):
            for k, full in full_grads.items():
                e = rel_l2(g[k], _slice_for(full, k, cfg, sizes,
                                            rr["coords"]).cpu())
                out[k] = max(out.get(k, 0.0), e)
        return out

    errs, errs32 = per_leaf(grads, ref), per_leaf(grads32, ref)
    with spy(routes16):
        one16 = layout_reference_grads(torch, moe, sizes, dev,
                                       torch.bfloat16)
    floor = {k: rel_l2(one16[k], ref[k]) for k in ref}
    errs_pair = per_leaf(grads, one16)
    # tokens a gating call (a group of a layer) sends to other experts in
    # one process in bf16 than in fp32
    rerouted = [int((a != b).any(-1).sum()) for a, b in zip(routes16,
                                                            routes32)]
    del ref, one16
    # in floors: the layout's bf16 gradient against fp32, and against one
    # process's bf16 gradient
    floors = {k: errs[k] / floor[k] for k in floor}
    floors_pair = {k: errs_pair[k] / floor[k] for k in floor}
    worst = max(errs, key=errs.get)
    worst32 = max(errs32, key=errs32.get)
    in_floors = moe or sizes.get("pp", 1) > 1

    def fmt(d):
        return ",".join(f"{k.split('.')[-1]}:{v:.3g}" for k, v in d.items())
    mesh_like = type("M", (), {"shape": {a: sizes.get(a, 1)
                                         for a in AXIS_ORDER}})
    specs = param_shardings(cfg, mesh_like)
    # after every step (under pp, the embedding and ln_f across the
    # stages too)
    replicated_same = True
    for k, spec in specs.items():
        for i in range(LAYOUT_STEPS):
            held = {}
            for rr in res:
                block = tuple(rr["coords"][a] for a in spec.values())
                held.setdefault(block, set()).add(rr["digests"][i][k])
            replicated_same &= all(len(d) == 1 for d in held.values())
    sp_size = sizes.get("sp", 1)
    pp_size = sizes.get("pp", 1)
    # a rank runs its stage's layers once a microbatch
    per_step = cfg.n_layers // pp_size * (cfg.n_microbatches
                                          if pp_size > 1 else 1)
    for rr in res:
        c = rr["coords"]
        # the causal ring: sp position i attends i + 1 blocks a layer
        want = {"flash_attention_fwd": per_step * LAYOUT_STEPS
                * (c["sp"] + 1 if sp_size > 1 else 1),
                "xent_fwd": LAYOUT_STEPS if sizes.get("tp", 1) == 1 else 0}
        rel = abs(rr["losses"][0] - rr["cpu_loss"]) / abs(rr["cpu_loss"])
        say(role, rank=rr["rank"], mesh=json.dumps(sizes).replace(" ", ""),
            coords=",".join(f"{a}{c[a]}" for a in AXIS_ORDER if a in sizes),
            width=f"V{cfg.vocab_size} M{cfg.d_model} H{cfg.n_heads}x"
            f"{cfg.head_dim} L{cfg.n_layers} F{cfg.d_ff} S{cfg.max_seq} B8 "
            + str(cfg.dtype).split(".")[-1]
            + (f" E{cfg.n_experts} top{cfg.moe_top_k} "
               f"cf{cfg.capacity_factor}" if moe else "")
            + (f" M{cfg.n_microbatches}" if pp_size > 1 else ""),
            losses=",".join(f"{x:.6f}" for x in rr["losses"]),
            step_ms=",".join(f"{x:.3f}" for x in rr["step_ms"]),
            cpu_fp32_loss=rr["cpu_loss"], step1_rel=rel,
            tol_rel=LAYOUT_LOSS_TOL,
            launches=",".join(f"{k}:{v}" for k, v in rr["launches"].items()),
            want_launches=",".join(f"{k}:{v}" for k, v in want.items()),
            gloo_host_staged=",".join(rr["gloo_host_staged"]) or "none",
            seconds=rr["seconds"], card=card)
        check(rr["losses"] == res[0]["losses"],
              f"{role}: rank {rr['rank']} reports losses {rr['losses']}, "
              f"rank 0 {res[0]['losses']}")
        check(all(map(math.isfinite, rr["losses"]))
              and rr["losses"][-1] < rr["losses"][0],
              f"{role}: loss did not fall: {rr['losses']}")
        check(rel <= LAYOUT_LOSS_TOL, f"{role}: step 1 loss "
              f"{rr['losses'][0]} is {rel} off the fp32 CPU loss "
              f"{rr['cpu_loss']}")
        check(rr["launches"] == want, f"{role}: rank {rr['rank']} launched "
                                      f"{rr['launches']}, expected {want}")
        for key, kc in rr["kernel_checks"].items():
            say(role, rank=rr["rank"], kernel_on_rank_inputs=key,
                **{k: v for k, v in kc.items() if k != "ok"},
                tol_o_rel=LAYOUT_FLASH_O_TOL, tol_lse=LAYOUT_FLASH_LSE_TOL,
                tol_xent_rel=LAYOUT_XENT_TOL)
            check(kc["ok"], f"{role}: rank {rr['rank']}'s {key} kernel "
                            f"launch disagrees with the plain version: {kc}")
    # the ranks together ran both ring kinds, and xent where tp is 1
    kinds = {k for rr in res for k in rr["kernel_checks"]}
    want_kinds = {"ring_diag"} | ({"ring_full"} if sp_size > 1 else set()) \
        | ({"xent"} if sizes.get("tp", 1) == 1 else set())
    check(kinds == want_kinds, f"{role}: kernels held on the ranks' inputs "
                               f"{sorted(kinds)}, expected "
                               f"{sorted(want_kinds)}")
    say(role, ranks=n, world_seconds=world_s,
        grad_reference="grouped one-process fp32" if moe
        else "one-process fp32",
        fp32_grad_rel_l2=fmt(errs32), fp32_worst=worst32,
        tol_fp32_grad_rel_l2=LAYOUT_FP32_GRAD_TOL,
        bf16_grad_rel_l2=fmt(errs), bf16_worst=worst,
        tol_bf16_grad_rel_l2=LAYOUT_GRAD_TOL if not in_floors
        else f"{LAYOUT_MOE_FLOOR_RATIO} floors",
        one_process_bf16_grad_rel_l2_floor=fmt(floor),
        bf16_grad_floors=fmt(floors),
        bf16_vs_one_process_bf16_rel_l2=fmt(errs_pair),
        bf16_vs_one_process_bf16_floors=fmt(floors_pair),
        tol_vs_one_process_bf16=f"{LAYOUT_MOE_PAIR_RATIO} floors"
        if in_floors else "none",
        one_process_bf16_rerouted_tokens=",".join(map(str, rerouted))
        + (f" of {routes32[0].shape[0]}" if routes32 else ""),
        replicated_leaves_bit_identical=replicated_same)
    check(errs32[worst32] <= LAYOUT_FP32_GRAD_TOL,
          f"{role}: fp32 step-1 gradient of {worst32} is {errs32[worst32]} "
          f"off the one-process fp32 gradient")
    check(in_floors or errs[worst] <= LAYOUT_GRAD_TOL,
          f"{role}: bf16 step-1 gradient of {worst} is {errs[worst]} off "
          f"the one-process fp32 gradient")
    check(not in_floors or max(floors.values()) <= LAYOUT_MOE_FLOOR_RATIO,
          f"{role}: bf16 step-1 gradient off the fp32 one by more than "
          f"{LAYOUT_MOE_FLOOR_RATIO} one-process floors: {fmt(floors)}")
    check(not in_floors
          or max(floors_pair.values()) <= LAYOUT_MOE_PAIR_RATIO,
          f"{role}: bf16 step-1 gradient off one process's bf16 one by "
          f"more than {LAYOUT_MOE_PAIR_RATIO} floors: {fmt(floors_pair)}")
    check(replicated_same, f"{role}: replicated leaves differ across the "
                           f"ranks that hold them")
    if role == "tp_sp":
        for rr in res:
            u = rr["ulysses"]
            say("ulysses", rank=rr["rank"], sp=sizes["sp"],
                shape="x".join(map(str, ULYSSES_SHAPE)) + " bf16 causal",
                max_abs_err_o=u["max_abs_err_o"],
                grad_rel_l2=",".join(f"{c}:{e}" for c, e in
                                     u["grad_rel_l2"].items()),
                tol=ULYSSES_TOL, flash_attention_fwd=u["launches"])
            check(u["max_abs_err_o"] <= ULYSSES_TOL
                  and max(u["grad_rel_l2"].values()) <= ULYSSES_TOL,
                  f"ulysses: rank {rr['rank']} off the plain attention: {u}")
            check(u["launches"] == 1, f"ulysses: rank {rr['rank']} launched "
                                      f"flash_attn_fwd {u['launches']} times")
    return [rr["launches"] for rr in res]


def pipeline_depth(role: str) -> int:
    """A pipeline phase's layers: LAYOUT_LAYERS a virtual stage."""
    return LAYOUT_LAYERS * PIPELINE_PHASES[role][1]


def pipeline_model(torch, dev, dtype, depth):
    """The flagship at full width, ``depth`` layers, as a layer-major
    model for
    ``make_pipeline_train_step``: ``layer_fn`` its block, ``loss_fn``
    ``ln_f``, the tied head (both held fixed) and the fused xent; the
    seed-0 weights and the seed-0 embedding of the seed-1 tokens.
    Returns ``(cfg, layer_fn, loss_fn, natural-order layers, batch)``."""
    import numpy as np
    from horovod_tpu_torch.models import init_params
    from horovod_tpu_torch.models.transformer import _block, _rmsnorm
    from horovod_tpu_torch.ops.xent import fused_softmax_xent
    cfg = dataclasses.replace(layout_cfg(False, depth=depth), dtype=dtype)
    p0 = init_params(np.random.RandomState(0), cfg)
    emb = torch.from_numpy(p0["embed"]).to(dev).to(dtype)
    ln_f = torch.from_numpy(p0["ln_f"]).to(dev)
    positions = torch.arange(cfg.max_seq, device=dev)
    axes = dict.fromkeys(("dp", "pp", "ep", "sp", "tp"))

    def layer_fn(lp, x):
        return _block(lp, x, positions, cfg, axes)[0]

    def loss_fn(y, t):
        return fused_softmax_xent(_rmsnorm(y, ln_f) @ emb.T, t).mean()

    layers = {k: v.reshape((cfg.n_layers,) + v.shape[2:])
              for k, v in p0["layers"].items()}
    tokens, targets = flagship_batch(cfg)
    x = torch.nn.functional.embedding(tokens.to(dev), emb)
    return cfg, layer_fn, loss_fn, layers, (x, targets.to(dev))


def pipeline_steps(torch, step, params, opt, batch, record=None):
    """PIPELINE_STEPS steps: (losses, step ms); the first step's kernel
    inputs into ``record`` when given."""
    losses, ms = [], []
    for i in range(PIPELINE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (record_kernel_inputs(record) if record is not None and i == 0
              else contextlib.nullcontext()):
            _, _, loss = step(params, opt, batch)
        losses.append(float(loss))
        ms.append(1e3 * (time.perf_counter() - t0))
    return losses, ms


AUTOTUNE_PLANS = (("psum", "none", 64 << 20), ("psum", "int8", 4 << 20),
                  ("ring", "none", 64 << 20))


def single_rank_main(out_dir: str) -> int:
    """The one-process references of the pipeline phases and [autotune],
    in an NCCL world of one: the flagship's blocks through
    ``make_pipeline_train_step`` with pp = 1 (the overlap engine),
    PIPELINE_STEPS steps in fp32 (losses, final parameters) and in bf16
    (losses, step ms), and in bf16 on a pipeline rank's share of the work
    (half the rows, as dp = 2 gives each card, in microbatches of the
    pipeline's two rows: the t(pp = 1) of the measured bubble); then
    ``make_overlap_train_step(lm_loss, ..., autotune=...)`` over
    AUTOTUNE_PLANS until it locks, and a second build over the same cache
    directory."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import adamw, lm_loss
    from horovod_tpu_torch.ops import attention, quantize, xent
    from horovod_tpu_torch.profile_step import DP_MICRO
    from horovod_tpu_torch.train.autotune import AutotuneOptions, Plan
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    dev = hvd.device()
    mesh = hvd.build_mesh(dp=1)
    res = {}
    for depth in sorted({pipeline_depth(role) for role in PIPELINE_PHASES}):
        ref = res[str(depth)] = {}
        for name, dtype in (("fp32", torch.float32),
                            ("bf16", torch.bfloat16)):
            cfg, layer_fn, loss_fn, layers, batch = pipeline_model(
                torch, dev, dtype, depth)
            step = make_pipeline_train_step(
                layer_fn, loss_fn, n_layers=cfg.n_layers, mesh=mesh, pp=1,
                n_micro=PIPELINE_MICRO, device=dev)
            p = step.prepare_params(layers)
            opt = adamw(p.parameters())
            ref[f"{name}_losses"], ref[f"{name}_step_ms"] = pipeline_steps(
                torch, step, p, opt, batch)
            if name == "fp32":
                torch.save({k: v.cpu() for k, v in
                            step.restore_params(p).items()},
                           os.path.join(out_dir,
                                        f"single_params_L{depth}.pt"))
        half = tuple(t[:t.shape[0] // 2] for t in batch)
        step = make_pipeline_train_step(
            layer_fn, loss_fn, n_layers=cfg.n_layers, mesh=mesh, pp=1,
            n_micro=PIPELINE_MICRO // 2, device=dev)
        p = step.prepare_params(layers)
        _, ref["share_step_ms"] = pipeline_steps(
            torch, step, p, adamw(p.parameters()), half)

    model = depth_flagship(torch, dev, LAYOUT_LAYERS)
    tokens, targets = (t.to(dev) for t in flagship_batch(model.cfg))
    counters = {"flash_attention_fwd": attention.flash_attn_fwd_cuda,
                "xent_fwd": xent.xent_fwd_cuda,
                **{fn.__name__[:-len("_cuda")]: fn
                   for fn in quantize.LAUNCHERS}}
    for c in counters.values():
        c.launches = 0
    plans = [Plan(b, a, c) for a, c, b in AUTOTUNE_PLANS]
    with tempfile.TemporaryDirectory(prefix="autotune_") as cache:
        opts = AutotuneOptions(plans=plans, budget_steps=AUTOTUNE_BUDGET,
                               steps_per_trial=2, cache_dir=cache,
                               log_path=os.path.join(cache, "trace.csv"))
        step = hvd.make_overlap_train_step(lm_loss, mesh, n_micro=DP_MICRO,
                                           autotune=opts)
        opt = adamw(model.parameters())
        losses, ms = [], []
        t0 = time.perf_counter()
        while not (step.autotune is not None and step.autotune.done) \
                and len(losses) < AUTOTUNE_BUDGET + 2:
            losses.append(float(step(model, opt, (tokens, targets))[2]))
        search_s = time.perf_counter() - t0
        ctl = step.autotune
        res["autotune"] = {
            "locked": ctl.locked_plan.key if ctl.done else None,
            "plans": [q.key for q in plans], "trials": ctl.trials,
            "steps_used": ctl.steps_used, "from_cache": ctl.from_cache,
            "best_ms": 1e3 * (ctl.best_seconds or float("nan")),
            "scores_ms": {q.key: 1e3 * v for q, v in ctl._scores.items()},
            "losses": losses, "search_s": search_s,
            "launches": {k: c.launches for k, c in counters.items()},
            "trace_rows": len(open(os.path.join(cache, "trace.csv"))
                              .read().strip().splitlines()) - 1}
        warm = hvd.make_overlap_train_step(lm_loss, mesh, n_micro=DP_MICRO,
                                           autotune=opts)
        warm(model, opt, (tokens, targets))
        res["autotune"].update(
            warm_from_cache=warm.autotune.from_cache,
            warm_trials=warm.autotune.trials,
            warm_locked=warm.autotune.locked_plan.key)
    with open(os.path.join(out_dir, "single.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def digest_params(params) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def pipeline_rank_main(out_dir: str, role: str) -> int:
    """One rank of [pipeline_1f1b] / [pipeline_interleaved]:
    ``make_pipeline_train_step`` over {pp:2} (gloo, both ranks on
    ``cuda:0``) with PIPELINE_PHASES[role]'s schedule, PIPELINE_MICRO
    microbatches and a fused AdamW: PIPELINE_STEPS steps in fp32 (losses;
    the gathered final parameters), then in bf16 with the kernel counters
    zeroed just before and read just after (losses, step ms, the inputs
    of step 1's first kernel launches run again through the kernels and
    their plain versions), then one step on a NaN batch whose guard
    decision and update run under ``set_sync_debug_mode("error")`` (the
    verdict's gloo allreduce over pp excepted: gloo stages CUDA tensors
    through the host)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import adamw
    from horovod_tpu_torch.ops import attention, mesh_collectives, xent
    from horovod_tpu_torch.train import guard
    from horovod_tpu_torch.train.pipeline import make_pipeline_train_step

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r = hvd.rank()
    dev = hvd.device()
    schedule, v = PIPELINE_PHASES[role]
    mesh = hvd.dp_pp_mesh(pp=2)

    def build(layer_fn, loss_fn, cfg):
        return make_pipeline_train_step(
            layer_fn, loss_fn, n_layers=cfg.n_layers, mesh=mesh,
            schedule=schedule, pp=2, n_micro=PIPELINE_MICRO,
            virtual_stages=v, device=dev)

    res = {"rank": r, "pp_index": mesh.axis("pp").index}
    depth = pipeline_depth(role)
    cfg, layer_fn, loss_fn, layers, batch = pipeline_model(torch, dev,
                                                           torch.float32,
                                                           depth)
    step = build(layer_fn, loss_fn, cfg)
    p = step.prepare_params(layers)
    res["fp32_losses"], _ = pipeline_steps(torch, step, p,
                                           adamw(p.parameters()), batch)
    full = step.restore_params(p)
    if r == 0:
        torch.save({k: t.cpu() for k, t in full.items()},
                   os.path.join(out_dir, "pipeline_params.pt"))
    del step, p, full

    cfg, layer_fn, loss_fn, layers, batch = pipeline_model(torch, dev,
                                                           torch.bfloat16,
                                                           depth)
    step = build(layer_fn, loss_fn, cfg)
    p = step.prepare_params(layers)
    opt = adamw(p.parameters())
    counters = {"flash_attention_fwd": attention.flash_attn_fwd_cuda,
                "xent_fwd": xent.xent_fwd_cuda}
    for c in counters.values():
        c.launches = 0
    recorded = {}
    res["losses"], res["step_ms"] = pipeline_steps(torch, step, p, opt,
                                                   batch, recorded)
    res["launches"] = {k: c.launches for k, c in counters.items()}
    step.flush()
    res["skipped"] = step.skipped
    res["kernel_checks"] = kernels_on_rank_inputs(torch, recorded)

    real_apply, real_preduce = guard.guarded_apply, mesh_collectives.preduce

    def gloo_preduce(*a, **kw):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real_preduce(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    def watched_apply(optimizer, spec, pp_axis=None):
        mesh_collectives.preduce = gloo_preduce
        try:
            with no_host_sync(torch):
                return real_apply(optimizer, spec, pp_axis)
        finally:
            mesh_collectives.preduce = real_preduce

    guard.guarded_apply = watched_apply
    try:
        nan_step = build(layer_fn, loss_fn, cfg)
    finally:
        guard.guarded_apply = real_apply
    before = digest_params(p)
    nan_step(p, opt, (batch[0] * float("nan"), batch[1]))
    nan_step.flush()
    res["nan_skipped"] = nan_step.skipped
    res["nan_unchanged"] = digest_params(p) == before
    res["digest"] = before
    res["gloo_host_staged"] = list(mesh_collectives.GLOO_HOST_STAGED)
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def phase_pipeline(torch, card: str) -> dict:
    """[pipeline_1f1b], [pipeline_interleaved] and [autotune]: the
    one-process references (``single_rank_main``, an NCCL world of one on
    the card), then each pipeline world of two gloo ranks, then every
    check of the module docstring. Returns each phase's kernel launches
    per rank."""
    from horovod_tpu_torch.parallel.pipeline import bubble_fraction
    from horovod_tpu_torch.train.pipeline import record_measured_bubble
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="single_") as out_dir:
        _run_gloo_ranks(out_dir, 1, "single", "single", backend="NCCL")
        with open(os.path.join(out_dir, "single.json")) as f:
            single = json.load(f)
        ref_params = {d: torch.load(os.path.join(
            out_dir, f"single_params_L{d}.pt")) for d in single
            if d.isdigit()}
    single_s = time.perf_counter() - t0
    launches = {}
    for role, (schedule, v) in PIPELINE_PHASES.items():
        depth = pipeline_depth(role)
        ref = single[str(depth)]
        t1 = sorted(ref["share_step_ms"][1:])[0]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix=f"{role}_") as out_dir:
            _run_gloo_ranks(out_dir, 2, role, role)
            res = []
            for r in range(2):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    res.append(json.load(f))
            params = torch.load(os.path.join(out_dir, "pipeline_params.pt"))
        world_s = time.perf_counter() - t0
        ref32 = ref["fp32_losses"]
        traj = max(abs(a - b) / abs(b) for a, b in zip(res[0]["fp32_losses"],
                                                       ref32))
        perr = {k: rel_l2(params[k], ref_params[str(depth)][k])
                for k in ref_params[str(depth)]}
        worst = max(perr, key=perr.get)
        rel1 = abs(res[0]["losses"][0] - ref32[0]) / abs(ref32[0])
        tpp = sorted(res[0]["step_ms"][1:])[0]
        measured = 1.0 - t1 / tpp
        record_measured_bubble(measured)
        analytic = bubble_fraction(schedule, 2, PIPELINE_MICRO, v)
        last = 1        # the last stage's chunk is on pp position 1
        for rr in res:
            is_last = rr["pp_index"] == last
            # a rank runs depth / pp layers a microbatch
            want = {"flash_attention_fwd": depth // 2 * PIPELINE_MICRO
                    * PIPELINE_STEPS,
                    "xent_fwd": PIPELINE_MICRO * PIPELINE_STEPS
                    if is_last else 0}
            say(role, rank=rr["rank"], schedule=schedule, pp=2,
                virtual_stages=v, microbatches=PIPELINE_MICRO,
                width=f"V32000 M512 H8x64 L{depth} F2048 S256 B8 bf16 "
                      f"(microbatch 2x256)",
                losses=",".join(f"{x:.6f}" for x in rr["losses"]),
                fp32_losses=",".join(f"{x:.6f}" for x in rr["fp32_losses"]),
                step_ms=",".join(f"{x:.3f}" for x in rr["step_ms"]),
                launches=",".join(f"{k}:{n}" for k, n in
                                  rr["launches"].items()),
                want_launches=",".join(f"{k}:{n}" for k, n in want.items()),
                nan_step_skipped=rr["nan_skipped"],
                nan_step_params_unchanged=rr["nan_unchanged"],
                sync_debug_mode="error (guard decision and update)",
                gloo_host_staged=",".join(rr["gloo_host_staged"]),
                seconds=rr["seconds"], card=card)
            check(rr["losses"] == res[0]["losses"]
                  and rr["fp32_losses"] == res[0]["fp32_losses"],
                  f"{role}: the ranks report different losses")
            check(all(map(math.isfinite, rr["losses"]))
                  and rr["losses"][-1] < rr["losses"][0],
                  f"{role}: loss did not fall: {rr['losses']}")
            check(rr["launches"] == want, f"{role}: rank {rr['rank']} "
                  f"launched {rr['launches']}, expected {want}")
            check(rr["skipped"] == 0, f"{role}: the guard skipped a clean "
                                      f"step")
            check(rr["nan_skipped"] == 1 and rr["nan_unchanged"],
                  f"{role}: rank {rr['rank']} did not skip the NaN step "
                  f"({rr['nan_skipped']} skipped, parameters unchanged "
                  f"{rr['nan_unchanged']})")
            kinds = set(rr["kernel_checks"])
            check(kinds == ({"ring_diag", "xent"} if is_last
                            else {"ring_diag"}),
                  f"{role}: rank {rr['rank']} held the kernels "
                  f"{sorted(kinds)} on its inputs")
            for key, kc in rr["kernel_checks"].items():
                say(role, rank=rr["rank"], kernel_on_rank_inputs=key,
                    **{k: val for k, val in kc.items() if k != "ok"},
                    tol_o_rel=LAYOUT_FLASH_O_TOL,
                    tol_lse=LAYOUT_FLASH_LSE_TOL,
                    tol_xent_rel=LAYOUT_XENT_TOL)
                check(kc["ok"], f"{role}: rank {rr['rank']}'s {key} kernel "
                                f"launch disagrees with the plain version")
        check(res[0]["digest"] != res[1]["digest"],
              f"{role}: both ranks hold the same stage")
        say(role, ranks=2, world_seconds=world_s,
            fp32_traj_max_rel=traj, fp32_params_worst_rel_l2=perr[worst],
            fp32_params_worst=worst, tol_fp32_rel=PIPELINE_FP32_TOL,
            bf16_step1_vs_one_process_fp32_rel=rel1,
            tol_bf16_step1_rel=PIPELINE_LOSS_TOL,
            one_process_fp32_losses=",".join(f"{x:.6f}" for x in ref32),
            step_ms_best=tpp, pp1_share_step_ms_best=t1,
            one_process_pp1_full_batch_step_ms=",".join(
                f"{x:.3f}" for x in ref["bf16_step_ms"]),
            measured_bubble=measured, analytic_bubble=analytic, card=card)
        check(traj <= PIPELINE_FP32_TOL, f"{role}: fp32 losses "
              f"{res[0]['fp32_losses']} are {traj} off one process's {ref32}")
        check(perr[worst] <= PIPELINE_FP32_TOL, f"{role}: final {worst} is "
              f"{perr[worst]} off one process's")
        check(rel1 <= PIPELINE_LOSS_TOL, f"{role}: step 1's bf16 loss is "
              f"{rel1} off one process's fp32 loss")
        launches[role] = [rr["launches"] for rr in res]

    a = single["autotune"]
    say("autotune", plans=",".join(a["plans"]), locked=a["locked"],
        trials=a["trials"], steps_used=a["steps_used"],
        budget=AUTOTUNE_BUDGET, scores_ms=",".join(
            f"{k}:{v:.3f}" for k, v in a["scores_ms"].items()),
        best_ms=a["best_ms"], search_seconds=a["search_s"],
        csv_rows=a["trace_rows"], warm_from_cache=a["warm_from_cache"],
        warm_trials=a["warm_trials"], warm_locked=a["warm_locked"],
        losses=",".join(f"{x:.6f}" for x in a["losses"]),
        launches=",".join(f"{k}:{n}" for k, n in a["launches"].items()),
        single_process_seconds=single_s, card=card)
    check(a["locked"] in a["plans"] and a["trials"] > 0
          and a["steps_used"] <= AUTOTUNE_BUDGET and not a["from_cache"],
          f"autotune: the search did not lock a plan within its budget: {a}")
    check(a["warm_from_cache"] and a["warm_trials"] == 0
          and a["warm_locked"] == a["locked"],
          f"autotune: the second build did not lock {a['locked']} from the "
          f"cache with zero trials: {a}")
    check(all(map(math.isfinite, a["losses"]))
          and a["losses"][-1] < a["losses"][0],
          f"autotune: the loss did not fall during the search: {a['losses']}")
    launches["autotune"] = [a["launches"]]
    return launches


def gloo_rank_main(out_dir: str) -> int:
    """One rank of [dp_gloo_2rank] (the launcher's identity in the
    environment): make_train_step over dp=2, then the overlap engine with
    int8, then the eager int8 ``DistributedOptimizer``, GLOO_STEPS AdamW
    steps each from the seed-0 weights, 4 rows a rank; losses, parameter
    digests after every step, launch counts and the eager sync's gauges to
    ``rank<r>.json``, step 1's synced gradients to ``grads<r>.pt``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          lm_loss, make_train_step)
    from horovod_tpu_torch.ops import attention, quantize, xent
    from horovod_tpu_torch.profile_step import DP_MICRO

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r = hvd.rank()
    _, (model, tokens, targets) = entry()
    init_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    mesh = hvd.build_mesh(dp=2)
    local = hvd.shard_batch(tokens, targets, mesh)
    counters = {"flash_attention_fwd": attention.flash_attn_fwd_cuda,
                "xent_fwd": xent.xent_fwd_cuda}
    quant = {fn.__name__[:-len("_cuda")]: fn for fn in quantize.LAUNCHERS}
    res = {"rank": r}

    def run(key, step_fn, with_quant):
        for c in (*counters.values(), *quant.values()):
            c.launches = 0
        losses, ms, digests = [], [], []
        for i in range(GLOO_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step_fn()))
            ms.append(1e3 * (time.perf_counter() - t0))
            if key == "train" and i == 0:
                torch.save({k: p.grad.detach().cpu()
                            for k, p in model.named_parameters()},
                           os.path.join(out_dir, f"grads{r}.pt"))
            digests.append(params_digest(model))
        launches = {k: c.launches for k, c in counters.items()}
        if with_quant:
            launches.update({k: c.launches for k, c in quant.items()})
        res.update({f"{key}_losses": losses, f"{key}_step_ms": ms,
                    f"{key}_digests": digests, f"{key}_launches": launches})

    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg, mesh)
    run("train", lambda: step(model, opt, *local)[2], False)

    model = Transformer(model.cfg)
    model.load_state_dict(init_sd)
    opt = init_opt_state(adamw, model)
    ostep = hvd.make_overlap_train_step(lm_loss, mesh, "dp", n_micro=DP_MICRO,
                                        compression=Compression.int8)
    run("overlap_int8", lambda: ostep(model, opt, local)[2], True)
    ostep.flush()
    res["skipped"] = ostep.skipped

    # the eager regime: DistributedOptimizer syncs the local gradients,
    # its buckets timed on the overlap gauges
    reset_observability()
    model = Transformer(model.cfg)
    model.load_state_dict(init_sd)
    eopt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                    named_parameters=model.named_parameters(),
                                    compression=Compression.int8)
    estep = make_train_step(model.cfg)
    run("eager_int8", lambda: estep(model, eopt, *local)[2], True)
    reg = hvd.metrics_snapshot()["registry"]
    res["eager_gauges"] = {k: reg[k]["value"] for k in (
        "hvd_overlap_exposed_comm_seconds", "hvd_overlap_sync_seconds",
        "hvd_overlap_exposed_comm_seconds_total", "hvd_overlap_bucket_count",
        'hvd_compression_pre_bytes_total{codec="int8"}',
        'hvd_compression_wire_bytes_total{codec="int8"}') if k in reg}
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def leaf_bits(t):
    """A tensor's bytes on the host (bf16 as its 16 bits)."""
    import torch
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def tree_sha(tree) -> dict:
    """sha256 of every tensor leaf's bytes, by its key path, and the
    other leaves as they are (the checkpoint's flatten)."""
    import torch
    from horovod_tpu_torch.common.tree import flatten_with_path, keystr
    return {keystr(p): (hashlib.sha256(leaf_bits(v)).hexdigest()
                        if isinstance(v, torch.Tensor) else v)
            for p, v in flatten_with_path(tree)}


def ckpt_corpus(cfg):
    """CKPT_CORPUS seeded batches of the flagship's shape (B 8 at
    max_seq), each a dict of int64 host tensors."""
    import numpy as np
    import torch
    from horovod_tpu_torch.entry import BATCH
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (CKPT_CORPUS, BATCH,
                                           cfg.max_seq + 1))
    return [{"tokens": torch.from_numpy(t[:, :-1].copy()),
             "targets": torch.from_numpy(t[:, 1:].copy())} for t in toks]


def ckpt_run(torch, cfg, sd, corpus, ckpt_dir, counters, resume=False,
             capture_at=None):
    """One run of [checkpoint]: the flagship's AdamW steps from the
    corpus through ShardedDataset and device_prefetch, under
    CheckpointCallback (every CKPT_EVERY steps) and TelemetryCallback (the
    goodput ledger), up to step CKPT_STEPS - 1. ``resume``: first restore
    the newest commit into a fresh state and go on from ``next_step``.
    Each saved state's data position is the cursor less the prefetcher's
    buffer. Returns the run's record; the model and optimizer stay on the
    card in it."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import (init_optimizer_state,
                                              load_model_state, model_state,
                                              optimizer_state)
    from horovod_tpu_torch.data import ShardedDataset, device_prefetch
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_train_step)
    from horovod_tpu_torch.train.callbacks import CheckpointCallback
    model = Transformer(cfg)
    model.load_state_dict(sd)
    opt = init_opt_state(adamw, model)
    ds = ShardedDataset(corpus, rank=0, size=1, seed=0)
    cb = CheckpointCallback(ckpt_dir, every_n_steps=CKPT_EVERY)
    rec = {"model": model, "opt": opt, "losses": {}, "batches": {},
           "stalls_ms": []}
    if resume:
        init_optimizer_state(opt)
        like = {"model": model_state(model),
                "optim": optimizer_state(opt, model),
                "data": ds.state_dict(), "step": -1}
        got = cb.on_train_begin(like)
        # digested now: the loaded optimizer shares these tensors
        rec["restored"] = tree_sha(got)
        rec["restore_s"] = cb.store.last_restore_s
        load_model_state(model, got["model"])
        opt.load_state_dict(got["optim"])
        ds.load_state_dict(got["data"])
    tel = hvd.TelemetryCallback(units_per_step=corpus[0]["tokens"].numel(),
                                unit="tokens")
    pf = device_prefetch(ds, buffer_size=CKPT_PREFETCH)
    step_fn = make_train_step(cfg)
    rec["first_step"] = cb.next_step
    for c in counters:
        c.launches = 0
    for step in range(cb.next_step, CKPT_STEPS):
        batch = next(pf)
        tel.on_step_begin()
        loss = step_fn(model, opt, batch["tokens"], batch["targets"])[2]
        rec["losses"][step] = float(loss)
        tel.on_step_end()
        rec["batches"][step] = hashlib.sha256(
            leaf_bits(batch["tokens"]) + leaf_bits(batch["targets"])
        ).hexdigest()
        data = ds.state_dict()
        data["cursor"] -= pf.buffered
        state = {"model": model_state(model),
                 "optim": optimizer_state(opt, model),
                 "data": data, "step": step}
        cb.on_step_end(step, state)
        if step % CKPT_EVERY == 0:
            rec["stalls_ms"].append(1e3 * cb.store.last_stall_s)
        if step == capture_at:
            rec["captured"] = tree_sha(state)
    rec["launches"] = {"flash_attention_fwd": counters[0].launches,
                       "xent_fwd": counters[1].launches}
    t0 = time.perf_counter()
    cb.on_train_end()          # drain the writer, no final save
    rec["drain_s"] = time.perf_counter() - t0
    rec["commits"] = cb.store.all_steps()
    rec["final"] = {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}
    cb.close()
    return rec


def ckpt_bytes(manifest) -> int:
    """The bytes a checkpoint's arrays hold, from its manifest."""
    import numpy as np
    from horovod_tpu_torch.checkpoint import format as fmt
    n = 0
    for rec in manifest["leaves"]:
        if rec["kind"] == "array":
            n += int(np.prod(rec["shape"])) * \
                fmt.torch_dtype(rec["dtype"]).itemsize
    return n


def phase_checkpoint(torch, cfg, init_sd, counters, card: str) -> dict:
    """[checkpoint]: the flagship saved asynchronously every CKPT_EVERY
    steps, killed, resumed from the newest commit with the same data
    position, held to the uninterrupted run; see the module docstring.
    Returns the kernels' launches in runs A and B."""
    import numpy as np

    from horovod_tpu_torch.checkpoint import (ShardedCheckpointer,
                                              model_state, optimizer_state)
    from horovod_tpu_torch.checkpoint import format as fmt
    from horovod_tpu_torch.data import device_prefetch
    from horovod_tpu_torch.metrics import goodput
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.models import from_jax_params, init_params
    t_phase = time.perf_counter()
    corpus = ckpt_corpus(cfg)
    knobs = {"HVD_TPU_GOODPUT_WINDOW": str(CKPT_EVERY),
             "HVD_TPU_ANOMALY": "0"}
    with tempfile.TemporaryDirectory(prefix="checkpoint_") as tmp:
        knobs.update(HVD_TPU_OBS_DIR=os.path.join(tmp, "obs"),
                     HVD_TPU_PROFILE_DIR=os.path.join(tmp, "profile"))
        os.environ.update(knobs)
        reset_observability()
        a_dir = os.path.join(tmp, "a")
        run_a = ckpt_run(torch, cfg, init_sd, corpus, a_dir, counters,
                         capture_at=CKPT_RESUME)
        windows = list(goodput.ledger().recent)
        tolerance = goodput.ledger().tolerance
        reg = default_registry().snapshot()
        manifest = fmt.read_manifest(a_dir, CKPT_RESUME)
        n_saves = len(run_a["stalls_ms"])
        save_s = reg["hvd_checkpoint_save_seconds"]
        saved_bytes = reg["hvd_checkpoint_save_bytes_total"]["value"]
        npz_bytes = os.path.getsize(os.path.join(
            fmt.step_dir(a_dir, CKPT_RESUME), fmt.shard_npz(0)))
        run_a2 = ckpt_run(torch, cfg, init_sd, corpus,
                          os.path.join(tmp, "a2"), counters)

        # the cut at full width on the card: every tensor of run A's state
        # updated in place right after save() returns
        state = {"model": model_state(run_a["model"]),
                 "optim": optimizer_state(run_a["opt"], run_a["model"]),
                 "step": CKPT_STEPS}
        want = tree_sha(state)
        tensors = [t for t in run_a["model"].parameters()] + [
            v for st in run_a["opt"].state.values() for v in st.values()]
        # what a blocking cut would hold the caller: the same bytes copied
        # to the host synchronously
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = [t.detach().cpu() for t in tensors]
        blocking_ms = 1e3 * (time.perf_counter() - t0)
        del host
        cut = ShardedCheckpointer(os.path.join(tmp, "cut"), rank=0,
                                  world_size=1)
        cut.save(CKPT_STEPS, state)     # the writer idle, pinned memory
        steady_ms = 1e3 * cut.last_stall_s   # cached by earlier saves
        with torch.no_grad():
            torch._foreach_mul_(tensors, -1.0)
        cut.wait()
        cut_ok = tree_sha(cut.restore(CKPT_STEPS)) == want
        cut.close()
        del run_a["model"], run_a["opt"], run_a2["model"], run_a2["opt"]

        other = from_jax_params(init_params(np.random.RandomState(5), cfg))
        run_b = ckpt_run(torch, cfg, other, corpus, a_dir, counters,
                         resume=True)
        restored_ok = run_b["restored"] == run_a["captured"]

        # device_prefetch beside host tensors copied in the step, in turns
        from horovod_tpu_torch.models import make_train_step
        step_fn = make_train_step(cfg)
        model, opt = run_b["model"], run_b["opt"]
        dev = model.embed.device
        pf = device_prefetch(iter(corpus * 4), buffer_size=CKPT_PREFETCH)
        host = iter(corpus * 4)
        fed = {"prefetch": [], "host": []}
        for i in range(2 * CKPT_PAIRS):
            for how in (("prefetch", "host") if i % 2 else
                        ("host", "prefetch")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if how == "prefetch":
                    b = next(pf)
                    tok, tgt = b["tokens"], b["targets"]
                else:
                    b = next(host)
                    tok, tgt = b["tokens"].to(dev), b["targets"].to(dev)
                float(step_fn(model, opt, tok, tgt)[2])
                fed[how].append(time.perf_counter() - t0)
        del run_b["model"], run_b["opt"], model, opt
        for k in knobs:
            os.environ.pop(k)
    reset_observability()

    # A repeat of run A bit-equal to A: B must be A to the bit; else within
    # the distance between the two runs of A
    steps_b = sorted(run_b["losses"])
    repeat_loss = max(abs(run_a2["losses"][s] - run_a["losses"][s])
                      for s in run_a["losses"])
    repeat_param = max(max_err(run_a2["final"][k], v)
                       for k, v in run_a["final"].items())
    b_loss = max(abs(run_b["losses"][s] - run_a["losses"][s])
                 for s in steps_b)
    b_param = max(max_err(run_b["final"][k], v)
                  for k, v in run_a["final"].items())
    bit_repeat = repeat_loss == 0.0 and repeat_param == 0.0
    n_layers = cfg.n_layers
    want_a = {"flash_attention_fwd": n_layers * CKPT_STEPS,
              "xent_fwd": CKPT_STEPS}
    want_b = {"flash_attention_fwd": n_layers * len(steps_b),
              "xent_fwd": len(steps_b)}
    closes = [abs(sum(w["seconds"].values()) - w["wall_s"])
              <= tolerance * w["wall_s"] for w in windows]
    stall_windows = [w["seconds"]["checkpoint_stall"] for w in windows]
    say("checkpoint", card=card, width="V32000 M512 H8x64 L4 F2048 S256 B8 "
        "bf16", steps_a=f"0-{CKPT_STEPS - 1}", commits=run_a["commits"],
        resumed_from=run_b["first_step"] - 1, steps_b=steps_b,
        bytes_per_checkpoint=ckpt_bytes(manifest), npz_bytes=npz_bytes,
        save_bytes_per_save=saved_bytes / max(1, n_saves),
        inline_stall_ms=",".join(f"{x:.3f}" for x in run_a["stalls_ms"]),
        idle_writer_stall_ms=steady_ms, blocking_copy_ms=blocking_ms,
        write_s_mean=save_s["sum"] / max(1, save_s["count"]),
        write_count=save_s["count"], drain_s=run_a["drain_s"],
        restore_s=run_b["restore_s"],
        goodput_checkpoint_stall_s=",".join(f"{x:.6f}"
                                            for x in stall_windows),
        books_close=all(closes), restored_equals_cut=restored_ok,
        cut_under_inplace_update=cut_ok,
        same_batches=all(run_b["batches"][s] == run_a["batches"][s]
                         for s in steps_b),
        repeat_bit_equal=bit_repeat, repeat_loss_dist=repeat_loss,
        repeat_param_dist=repeat_param, resumed_loss_dist=b_loss,
        resumed_param_dist=b_param,
        losses_a=",".join(f"{run_a['losses'][s]:.6f}"
                          for s in sorted(run_a["losses"])),
        losses_b=",".join(f"{run_b['losses'][s]:.6f}" for s in steps_b),
        launches_a=json.dumps(run_a["launches"], separators=(",", ":")),
        launches_b=json.dumps(run_b["launches"], separators=(",", ":")))
    say("checkpoint", card=card, step_ms_prefetch_q1_med_q3=quartiles_ms(
        fed["prefetch"]), step_ms_host_q1_med_q3=quartiles_ms(fed["host"]),
        pairs=2 * CKPT_PAIRS, seconds=time.perf_counter() - t_phase)
    check(run_a["commits"] == CKPT_COMMITS,
          f"checkpoint: run A committed {run_a['commits']}")
    check(run_b["first_step"] == CKPT_RESUME + 1 and
          steps_b == list(range(CKPT_RESUME + 1, CKPT_STEPS)),
          f"checkpoint: run B ran {steps_b}")
    check(restored_ok, "checkpoint: the restored state is not the state "
                       f"at save({CKPT_RESUME})")
    check(cut_ok, "checkpoint: the cut saw an in-place update made after "
                  "save() returned")
    check(all(run_b["batches"][s] == run_a["batches"][s] for s in steps_b),
          "checkpoint: run B's batches differ from run A's")
    check(all(map(math.isfinite, run_a["losses"].values())),
          f"checkpoint: losses {run_a['losses']}")
    if bit_repeat:
        check(b_loss == 0.0 and b_param == 0.0,
              f"checkpoint: the resumed run is {b_loss} (loss) and "
              f"{b_param} (parameters) off run A, which repeats to the bit")
    else:
        check(b_loss <= repeat_loss and b_param <= repeat_param,
              f"checkpoint: the resumed run is {b_loss}/{b_param} off run "
              f"A, two runs of A {repeat_loss}/{repeat_param}")
    check(run_a["launches"] == want_a and run_b["launches"] == want_b,
          f"checkpoint: launches {run_a['launches']} / {run_b['launches']},"
          f" expected {want_a} / {want_b}")
    check(len(windows) == CKPT_STEPS // CKPT_EVERY and all(closes)
          and all(x > 0 for x in stall_windows),
          f"checkpoint: goodput windows {windows}")
    want_bytes = 3 * sum(4 * v.numel() for v in init_sd.values())
    check(want_bytes <= ckpt_bytes(manifest) <= want_bytes + 4096
          and saved_bytes == n_saves * ckpt_bytes(manifest),
          f"checkpoint: {ckpt_bytes(manifest)} bytes in the manifest, "
          f"{saved_bytes} saved over {n_saves}, expected {want_bytes}")
    return {"checkpoint": [run_a["launches"], run_b["launches"]]}


def ckpt_rank_main(out_dir: str) -> int:
    """One rank of [checkpoint_2rank] (the launcher's identity in the
    environment): rank 1 starts from other weights, the broadcast callback
    makes both equal, CKPT_DP_STEPS dp steps of make_train_step, a commit
    of model and optimizer state (each rank its axis-0 slices), the
    metric average, and the canary on equal replicas and after rank 1
    moves one element. Results to ``rank<r>.json``."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.checkpoint import model_state, optimizer_state
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.models import (Transformer, adamw, from_jax_params,
                                          init_params, make_train_step)
    from horovod_tpu_torch.ops import attention, xent
    from horovod_tpu_torch.train.callbacks import (
        BroadcastGlobalVariablesCallback, MetricAverageCallback)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    r = hvd.rank()
    cfg = layout_cfg(False)
    model = Transformer(cfg)
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0 if r == 0 else 7), cfg)))
    opt = adamw(model.parameters())
    res = {"rank": r, "digest_before": hvd.param_digest(model)}
    BroadcastGlobalVariablesCallback(0).on_train_begin(model, opt)
    res["digest_after"] = hvd.param_digest(model)
    mesh = hvd.build_mesh(dp=2)
    tok, tgt = (t.to(hvd.device())
                for t in hvd.shard_batch(*flagship_batch(cfg), mesh))
    counters = (attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda)
    for c in counters:
        c.launches = 0
    step = make_train_step(cfg, mesh)
    losses = [float(step(model, opt, tok, tgt)[2])
              for _ in range(CKPT_DP_STEPS)]
    res["launches"] = {"flash_attention_fwd": counters[0].launches,
                       "xent_fwd": counters[1].launches}
    res["losses"] = losses
    state = {"model": model_state(model),
             "optim": optimizer_state(opt, model), "step": CKPT_DP_STEPS}
    store = hvd.ShardedCheckpointer(os.path.join(out_dir, "ckpt"),
                                    commit_timeout_s=GLOO_TIMEOUT_S)
    store.save(CKPT_DP_STEPS, state, wait=True)
    res["stall_ms"] = 1e3 * store.last_stall_s
    res["state_sha"] = tree_sha(state)
    torch.distributed.barrier()
    res["avg"] = MetricAverageCallback().on_epoch_end(
        {"value": float(10 * (r + 1)), "name": f"rank{r}"})
    canary = hvd.ReplicaCanary(every=1)
    res["clean_findings"] = len(canary.check(CKPT_DP_STEPS + 1, model))
    if r == 1:
        with torch.no_grad():
            model.embed.view(-1)[0] += 1.0
    res["odd_findings"] = len(canary.check(CKPT_DP_STEPS + 2, model))
    reg = hvd.metrics_snapshot()["registry"]
    res["canary_checks"] = reg["hvd_canary_checks_total"]["value"]
    res["canary_divergence"] = reg.get(
        "hvd_canary_divergence_total", {}).get("value", 0.0)
    res["mismatch_steps"] = [e["step"] for e in recorder().events()
                             if e["kind"] == "canary_mismatch"]
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def phase_checkpoint_2rank(torch, card: str) -> dict:
    """[checkpoint_2rank]: two gloo ranks of this script on cuda:0 (see the
    module docstring); this process, a world of one, restores their
    commit and holds it to rank 0's state to the bit."""
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.checkpoint import format as fmt
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="ckpt_2rank_") as out_dir:
        _run_gloo_ranks(out_dir, 2, "checkpoint", "checkpoint_2rank")
        res = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
        ckpt = os.path.join(out_dir, "ckpt")
        manifest = fmt.read_manifest(ckpt, CKPT_DP_STEPS)
        t1 = time.perf_counter()
        got = ShardedCheckpointer(ckpt, rank=0, world_size=1).restore(
            CKPT_DP_STEPS)
        restore_s = time.perf_counter() - t1
        restored = tree_sha(got)
    # each rank wrote exactly its axis-0 slice of every array leaf (0-d
    # leaves: rank 0 whole; a leaf of one row, as the layers' stage dim,
    # is the last rank's)
    slices_ok = True
    for rec in manifest["leaves"]:
        if rec["kind"] != "array":
            continue
        shape = rec["shape"]
        want = ([(0, [[0, d] for d in shape])] if not shape or not shape[0]
                else [(r, [[b, e]] + [[0, d] for d in shape[1:]])
                      for r, (b, e) in enumerate(fmt.shard_bounds(shape[0],
                                                                  2))
                      if e > b])
        got_sh = sorted((s["rank"], s["index"]) for s in rec["shards"])
        slices_ok &= got_sh == want
    equal = restored == res[0]["state_sha"]
    n_layers = layout_cfg(False).n_layers
    want_l = {"flash_attention_fwd": n_layers * CKPT_DP_STEPS,
              "xent_fwd": CKPT_DP_STEPS}
    say("checkpoint_2rank", card=card, ranks=2,
        digests_before=",".join(str(x["digest_before"]) for x in res),
        digests_after=",".join(str(x["digest_after"]) for x in res),
        losses=",".join(f"{x:.6f}" for x in res[0]["losses"]),
        world_size=manifest["world_size"], own_axis0_slices=slices_ok,
        world1_restore_equals_rank0=equal, restore_s=restore_s,
        stall_ms=",".join(f"{x['stall_ms']:.3f}" for x in res),
        metric_average=",".join(str(x["avg"]["value"]) for x in res),
        canary_clean_findings=[x["clean_findings"] for x in res],
        canary_divergence=[x["canary_divergence"] for x in res],
        canary_mismatch_steps=[x["mismatch_steps"] for x in res],
        launches=",".join(json.dumps(x["launches"], separators=(",", ":"))
                          for x in res),
        rank_seconds=",".join(f"{x['seconds']:.1f}" for x in res),
        seconds=time.perf_counter() - t0)
    check(res[0]["digest_before"] != res[1]["digest_before"]
          and res[0]["digest_after"] == res[1]["digest_after"],
          "checkpoint_2rank: the broadcast did not make the replicas equal")
    check(all(x["losses"] == res[0]["losses"] for x in res)
          and all(map(math.isfinite, res[0]["losses"])),
          f"checkpoint_2rank: losses {[x['losses'] for x in res]}")
    check(manifest["world_size"] == 2 and slices_ok,
          "checkpoint_2rank: the ranks did not write their axis-0 slices")
    check(equal, "checkpoint_2rank: the world-1 restore differs from rank "
                 "0's state")
    check(all(x["avg"] == {"value": 15.0, "name": f"rank{i}"}
              for i, x in enumerate(res)),
          f"checkpoint_2rank: metric average {[x['avg'] for x in res]}")
    for x in res:
        check(x["clean_findings"] == 0 and x["odd_findings"] == 0
              and x["canary_checks"] == 2.0
              and x["canary_divergence"] == 1.0
              and x["mismatch_steps"] == [CKPT_DP_STEPS + 2],
              f"checkpoint_2rank: canary on rank {x['rank']}: {x}")
        check(x["launches"] == want_l,
              f"checkpoint_2rank: launches {x['launches']}, expected "
              f"{want_l}")
    return {"checkpoint_2rank": [x["launches"] for x in res]}

# -- the model zoo ----------------------------------------------------------------------

def zoo_model(torch, name, kw, dev, mesh, dtype):
    """A zoo model of ``name`` (``models.MODEL_ZOO``) in ``dtype`` compute
    on ``dev``; BERT from its config."""
    from horovod_tpu_torch.models import bert, get_model
    if name.startswith("bert"):
        return bert.Bert(dataclasses.replace(get_model(name), dtype=dtype),
                         dev, mesh)
    return get_model(name, dtype=dtype, device=dev, mesh=mesh, **kw)


def zoo_batch(torch, name, rows, size, dev, seed):
    """Seeded inputs on ``dev``: images in [0, 1) and labels, or a BERT
    batch (rows padded to a length in [size/2, size], 15% of the kept
    tokens masked for MLM)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if not name.startswith("bert"):
        return (torch.rand(rows, 3, size, size, generator=g, device=dev),
                torch.randint(0, 1000, (rows,), generator=g, device=dev))
    vocab = 30522
    pos = torch.arange(size, device=dev)[None]
    lengths = torch.randint(size // 2, size + 1, (rows, 1), generator=g,
                            device=dev)
    mask = pos < lengths
    return {"input_ids": torch.randint(0, vocab, (rows, size), generator=g,
                                       device=dev),
            "token_type_ids": (pos >= size // 2).long().expand(rows, size)
            .contiguous(),
            "attention_mask": mask,
            "mlm_labels": torch.randint(0, vocab, (rows, size), generator=g,
                                        device=dev),
            "mlm_mask": (torch.rand(rows, size, generator=g, device=dev)
                         < 0.15).float() * mask,
            "nsp_labels": torch.randint(0, 2, (rows,), generator=g,
                                        device=dev)}


def zoo_loss(torch, name, model, batch, mesh=None):
    """``(loss, logits)`` of one forward (BERT: the MLM logits)."""
    from horovod_tpu_torch.models import bert
    if name.startswith("bert"):
        mlm, nsp = model(batch["input_ids"], batch["token_type_ids"],
                         batch["attention_mask"])
        return bert.pretrain_loss(mlm, nsp, batch["mlm_labels"],
                                  batch["mlm_mask"], batch["nsp_labels"],
                                  mesh, model.cfg.vocab_size), mlm
    logits = model(batch[0])
    return torch.nn.functional.cross_entropy(logits.float(),
                                             batch[1].long()), logits


def bert_loss_parts(torch, model, batch, mesh=None):
    """BERT's ``(masked-LM, next-sentence)`` terms of ``pretrain_loss``."""
    from horovod_tpu_torch.models import bert
    mlm, nsp = model(batch["input_ids"], batch["token_type_ids"],
                     batch["attention_mask"])
    total = bert.pretrain_loss(mlm, nsp, batch["mlm_labels"],
                               batch["mlm_mask"], batch["nsp_labels"], mesh,
                               model.cfg.vocab_size)
    nsp_term = float(torch.nn.functional.cross_entropy(
        nsp.float(), batch["nsp_labels"].long()))
    return float(total) - nsp_term, nsp_term


def zoo_step(name, model, mesh):
    """The model's ``make_*_train_step`` as ``step(model, opt, batch, i)``
    (``i`` the step index VGG's and Inception's dropout folds in)."""
    from horovod_tpu_torch.models import bert, inception, resnet, vgg
    if name.startswith("bert"):
        s = bert.make_bert_train_step(model, mesh)
        return lambda m, o, b, i: s(m, o, b)
    if name in ("vgg16", "inception3"):
        make = vgg.make_vgg_train_step if name == "vgg16" else \
            inception.make_inception_train_step
        s = make(model, mesh)
        return lambda m, o, b, i: s(m, o, *b, i)
    s = resnet.make_resnet_train_step(model, mesh)
    return lambda m, o, b, i: s(m, o, *b)


def zoo_optimizer(torch, name, model, kind, lr):
    from horovod_tpu_torch.models import bert
    if kind == "adamw":
        return bert.adamw(model.parameters(), lr)
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)


def zoo_forward_check(torch, name, kw, size, dev, init) -> dict:
    """The forward (train mode: batch statistics; dropout off) of the
    initial weights at ZOO_CHECK_BATCH rows: bf16 and fp32 on the card
    against fp32 on the CPU."""
    batch = zoo_batch(torch, name, ZOO_CHECK_BATCH, size, dev, seed=2)
    out = {}
    for tag, d, dtype in (("bf16", dev, torch.bfloat16),
                          ("fp32", dev, torch.float32),
                          ("cpu", torch.device("cpu"), torch.float32)):
        m = zoo_model(torch, name, kw, d, None, dtype)
        m.load_state_dict(init)
        m.train()
        if hasattr(m, "dropout"):
            m.dropout = 0.0
        b = batch if d == dev else (
            {k: v.cpu() for k, v in batch.items()} if isinstance(batch, dict)
            else tuple(t.cpu() for t in batch))
        with torch.no_grad():
            loss, logits = zoo_loss(torch, name, m, b)
        out[tag] = (float(loss), logits.float().cpu())
        del m
    ref_loss, ref_logits = out["cpu"]
    scale = float(ref_logits.abs().max())
    res = {"cpu_fp32_loss": ref_loss}
    for tag in ("bf16", "fp32"):
        loss, logits = out[tag]
        res[f"{tag}_loss"] = loss
        res[f"{tag}_loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        res[f"{tag}_logit_err"] = float((logits - ref_logits).abs().max()) \
            / scale
    return res


def device_breakdown(torch, fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall ms, the ms the
    card was busy (kernels, summed), the idle share, the launches, and the
    kernels' ms by ``profile_step.kernel_group``."""
    from horovod_tpu_torch.profile_step import kernel_group
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    groups: dict = {}
    for e in kernels:
        g = kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(groups.values())
    return {"profiled_step_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "launches": len(kernels),
            "device_ms_by_group": ";".join(
                f"{g}:{t:.3f}" for g, t in sorted(groups.items(),
                                                   key=lambda kv: -kv[1]))}


def phase_zoo_one(torch, name, kw, rows, size, opt_kind, lr, dev, mesh,
                  card) -> None:
    """One [zoo] line: the forward check, ZOO_STEPS steps of the model's
    train step on one seeded batch at full width (bf16 compute, fp32
    parameters), the FLOPs of a step counted against bench.py's, the
    throughput, MFU and peak memory."""
    from horovod_tpu_torch.metrics import mfu
    from horovod_tpu_torch.models._flax import BatchNorm, init_state
    from horovod_tpu_torch.ops import batch_norm as bn
    label = name + (f"_{kw['stem']}" if "stem" in kw else "")
    model = zoo_model(torch, name, kw, dev, mesh, torch.bfloat16)
    init_state(model, 0)
    bn_layers = sum(isinstance(b, BatchNorm) for b in model.modules())
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    fwd = zoo_forward_check(torch, name, kw, size, dev, init)
    batch = zoo_batch(torch, name, rows, size, dev, seed=1)
    step = zoo_step(name, model, mesh)

    def run():
        opt = zoo_optimizer(torch, name, model, opt_kind, lr)
        losses, secs, bn_launches = [], [], []
        for i in range(ZOO_STEPS):
            torch.cuda.synchronize()
            launches = bn.launch_kernel.launches
            t0 = time.perf_counter()
            _, _, loss = step(model, opt, batch, i)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
            bn_launches.append(bn.launch_kernel.launches - launches)
        return losses, secs, opt, bn_launches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, opt, bn_launches = run()
    peak = torch.cuda.max_memory_allocated()
    where = device_breakdown(torch,
                             lambda: step(model, opt, batch, ZOO_STEPS))
    checked = f"dropout {model.dropout}" if hasattr(model, "dropout") else \
        "as trained"
    fell = losses[-1] < losses[0]
    if not fell and name.startswith("bert"):
        # AdamW's first steps (each a sign step of every parameter) without
        # warmup overshoot the NSP head: every layer moves the [CLS] logits
        # together. The JAX step does the same from the same weights
        # (tests/torch_port_bert_large_trajectory.py). The fall is
        # then checked on the masked-LM term: the same steps again, the two
        # terms taken apart before each (printed)
        model.load_state_dict(init)
        opt = zoo_optimizer(torch, name, model, opt_kind, lr)
        parts = []
        for i in range(ZOO_STEPS):
            with torch.no_grad():
                parts.append(bert_loss_parts(torch, model, batch, mesh))
            step(model, opt, batch, i)
        checked = "the MLM term (" + ", ".join(
            f"mlm {m:.5f} nsp {n:.5f}" for m, n in parts) + ")"
        fell = parts[-1][0] < parts[0][0]
    if not fell and getattr(model, "dropout", 0.0):
        # dropout's noise may hide the fall: the same steps at dropout 0
        noisy = losses
        model.load_state_dict(init)
        model.dropout = 0.0
        losses = run()[0]
        checked = "dropout 0 (at dropout 0.5: " + ",".join(
            f"{x:.5f}" for x in noisy) + ")"
        fell = losses[-1] < losses[0]

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        zoo_loss(torch, name, model, batch, mesh)[0].backward()

    flops = mfu.flops_per_step(fwd_bwd)
    analytic = 6 * FWD_MACS_PER_IMG[name] * rows \
        if name in FWD_MACS_PER_IMG else None
    med = sorted(secs[1:])[len(secs[1:]) // 2]
    unit = "sequences_per_s" if name.startswith("bert") else "images_per_s"
    line = {"model": label, "batch": rows,
            "input": f"S{size}" if name.startswith("bert")
            else f"{size}x{size}",
            "optimizer": f"{opt_kind}:{lr}",
            "losses": ",".join(f"{x:.5f}" for x in losses),
            "loss_fall_checked": checked,
            "step_ms": ",".join(f"{1e3 * x:.3f}" for x in secs),
            "median_step_ms_2to5": 1e3 * med, unit: rows / med,
            "flops_per_step": flops, "analytic_flops": analytic,
            "flops_rel": None if analytic is None
            else abs(flops - analytic) / analytic,
            "mfu": mfu.mfu(flops, med), "peak_bytes_in_use": peak,
            "bn_layers": bn_layers,
            "bn_launches_a_step": ",".join(map(str, bn_launches)),
            **where, **fwd, "tol_loss_rel": ZOO_LOSS_TOL,
            "tol_logit": ZOO_LOGIT_TOL,
            "card": card}
    say("zoo", **line)
    check(all(map(math.isfinite, losses)), f"zoo {label}: non-finite loss "
                                           f"{losses}")
    # every batch norm of the step runs csrc/batch_norm.cu, two kernels
    # forward and two backward (212 a step for ResNet-50's 53)
    check(all(n == 4 * bn_layers for n in bn_launches),
          f"zoo {label}: {bn_launches} batch norm launches in the steps, "
          f"not 4 x {bn_layers}")
    check(fell, f"zoo {label}: the loss did not fall over {ZOO_STEPS} "
                f"steps ({checked}): {losses}")
    check(fwd["bf16_loss_rel"] <= ZOO_LOSS_TOL,
          f"zoo {label}: bf16 loss {fwd['bf16_loss']} is "
          f"{fwd['bf16_loss_rel']} off the CPU's fp32 {fwd['cpu_fp32_loss']}")
    check(fwd["fp32_logit_err"] <= ZOO_LOGIT_TOL,
          f"zoo {label}: fp32 logits on the card {fwd['fp32_logit_err']} "
          f"off the CPU's")
    if name not in ZOO_LOGITS_PRINTED:
        check(fwd["bf16_logit_err"] <= ZOO_LOGIT_TOL,
              f"zoo {label}: bf16 logits {fwd['bf16_logit_err']} of the "
              f"largest fp32 logit off the CPU's")
    if analytic is not None:
        check(line["flops_rel"] <= ZOO_FLOPS_TOL,
              f"zoo {label}: {flops} FLOPs a step, bench.py's analytic "
              f"{analytic}")
    del model, step, batch, opt
    torch.cuda.empty_cache()


def phase_zoo(torch, dev, card) -> None:
    """[zoo]: every ZOO_MODELS row in an NCCL world of one (its mesh's
    collectives still run: the gradient sync over dp)."""
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    hvd.init()
    mesh = hvd.build_mesh(dp=1)
    say("zoo", world=hvd.size(), backend=dist.get_backend(),
        steps=ZOO_STEPS, check_batch=ZOO_CHECK_BATCH)
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        for name, kw, rows, size, opt_kind, lr in ZOO_MODELS:
            phase_zoo_one(torch, name, kw, rows, size, opt_kind, lr, dev,
                          mesh, card)
    finally:
        torch.backends.cudnn.benchmark = bench
    hvd.shutdown()


def zoo_dp_rank_main(out_dir: str) -> int:
    """One rank of [zoo_dp_gloo_2rank]: ResNet-50 in fp32 over ``{dp: 2}``
    (gloo, on ``cuda:0``) from the weights and images in ``inputs.pt``,
    its block of ZOO_DP_ROWS images, ZOO_DP_STEPS SGD-momentum steps; step
    1's loss, synced gradients and BN statistics, and a digest of the
    state after each step, to ``zoo_dp<r>.pt``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hvd.init()
    dev = hvd.device()
    mesh = hvd.build_mesh(dp=2)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"))
    model = resnet.ResNet50(dtype=torch.float32, device=dev, mesh=mesh)
    model.load_state_dict(inp["state"])
    x, y = hvd.shard_batch(inp["images"].to(dev), inp["labels"].to(dev),
                           mesh)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    step = resnet.make_resnet_train_step(model, mesh)
    res = {"losses": [], "digests": [], "step_ms": []}
    for i in range(ZOO_DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, loss = step(model, opt, x, y)
        res["losses"].append(float(loss))
        res["step_ms"].append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            res["grads"] = {k: p.grad.detach().cpu().clone()
                            for k, p in model.named_parameters()}
            res["stats"] = {k: v.detach().cpu().clone()
                            for k, v in model.state_dict().items()
                            if k.endswith((".mean", ".var"))}
        res["digests"].append(params_digest(model))
    torch.save(res, os.path.join(out_dir, f"zoo_dp{hvd.rank()}.pt"))
    hvd.shutdown()
    return 0


def phase_zoo_dp(torch, dev, card) -> None:
    """[zoo_dp_gloo_2rank]: two gloo ranks of ResNet-50 (fp32, 224x224,
    ZOO_DP_ROWS images each) against one process on the same 32 images:
    step 1's loss, synced gradients and BN running statistics (the global
    batch's), bit-identical ranks after every step; and the distance a
    local BN (each rank normalizing its own block) would have given."""
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.models._flax import init_state
    model = resnet.ResNet50(dtype=torch.float32, device=dev)
    init_state(model, 0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    n = 2 * ZOO_DP_ROWS
    images = torch.rand(n, 3, ZOO_DP_SIZE, ZOO_DP_SIZE, generator=g,
                        device=dev)
    labels = torch.randint(0, 1000, (n,), generator=g, device=dev)
    with tempfile.TemporaryDirectory(prefix="zoo_dp_") as out_dir:
        torch.save({"state": init, "images": images.cpu(),
                    "labels": labels.cpu()},
                   os.path.join(out_dir, "inputs.pt"))
        t0 = time.perf_counter()
        _run_gloo_ranks(out_dir, 2, "zoo_dp", "zoo_dp_gloo_2rank")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"zoo_dp{r}.pt"))
                 for r in range(2)]

    def one_step(rows):
        model.load_state_dict(init)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        _, _, loss = resnet.make_resnet_train_step(model)(
            model, opt, images[rows], labels[rows])
        return (float(loss),
                {k: p.grad.detach().cpu().clone()
                 for k, p in model.named_parameters()},
                {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()
                 if k.endswith((".mean", ".var"))})

    loss, grads, stats = one_step(slice(0, n))
    halves = [one_step(slice(h * ZOO_DP_ROWS, (h + 1) * ZOO_DP_ROWS))
              for h in range(2)]
    local_grads = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in grads}
    local_err = grad_errors(local_grads, grads)
    r0 = ranks[0]
    errs = grad_errors(r0["grads"], grads)
    worst = max(errs, key=lambda k: errs[k][0])
    local_worst = max(local_err, key=lambda k: local_err[k][0])
    stats_err = max(max_err(r0["stats"][k], stats[k]) for k in stats)
    local_stats_err = max(max_err(halves[0][2][k], stats[k]) for k in stats)
    loss_rel = abs(r0["losses"][0] - loss) / abs(loss)
    same = r0["digests"] == ranks[1]["digests"]
    say("zoo_dp_gloo_2rank", model="resnet50", images_a_rank=ZOO_DP_ROWS,
        input=f"{ZOO_DP_SIZE}x{ZOO_DP_SIZE}",
        compute="fp32", seconds=wall,
        losses=",".join(f"{x:.6f}" for x in r0["losses"]),
        step_ms=",".join(f"{x:.1f}" for x in r0["step_ms"]),
        one_process_loss=loss, loss_rel=loss_rel, tol_loss=ZOO_DP_LOSS_TOL,
        worst_grad=worst, grad_rel_l2=errs[worst][0],
        tol_grad_rel_l2=ZOO_DP_GRAD_TOL, stats_max_abs=stats_err,
        tol_stats=ZOO_DP_STATS_TOL, bit_identical_every_step=same,
        local_bn_worst_grad=local_worst,
        local_bn_grad_rel_l2=local_err[local_worst][0],
        local_bn_stats_max_abs=local_stats_err, card=card)
    check(loss_rel <= ZOO_DP_LOSS_TOL, f"zoo_dp: step 1 loss "
          f"{r0['losses'][0]} is {loss_rel} off one process's {loss}")
    check(errs[worst][0] <= ZOO_DP_GRAD_TOL,
          f"zoo_dp: synced gradient of {worst} is {errs[worst][0]} off")
    check(stats_err <= ZOO_DP_STATS_TOL,
          f"zoo_dp: BN running statistics {stats_err} off the global ones")
    check(same, "zoo_dp: the two ranks' states differ after a step")
    check(all(ranks[1]["losses"][i] == r0["losses"][i]
              for i in range(ZOO_DP_STEPS)), "zoo_dp: the ranks' losses "
                                              "differ")
    del model
    torch.cuda.empty_cache()


def bert_tp_cfg(torch):
    from horovod_tpu_torch.models import bert
    return dataclasses.replace(bert.bert_large(torch.float32),
                               num_layers=BERT_TP_LAYERS)


def bert_tp_rank_main(out_dir: str) -> int:
    """One rank of [bert_tp_gloo_2rank]: BERT at bert_large width over
    ``{tp: 2}`` (gloo, on ``cuda:0``) from the full state in
    ``inputs.pt``, sliced for this rank: the loss and this rank's gradient
    shards of one forward and backward, then BERT_TP_STEPS AdamW steps'
    losses, to ``bert_tp<r>.pt``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import bert

    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    dev = hvd.device()
    mesh = hvd.build_mesh(dp=1, tp=2)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"))
    cfg = bert_tp_cfg(torch)
    model = bert.Bert(cfg, dev, mesh)
    model.load_state_dict(bert.shard_state_dict(inp["state"], cfg, mesh))
    batch = {k: v.to(dev) for k, v in inp["batch"].items()}
    loss, _ = zoo_loss(torch, "bert_large", model, batch, mesh)
    loss.backward()
    res = {"loss": float(loss.detach()),
           "grads": {k: p.grad.detach().cpu().clone()
                     for k, p in model.named_parameters()}}
    opt = bert.adamw(model.parameters(), 1e-4)
    step = bert.make_bert_train_step(model, mesh)
    res["losses"] = [float(step(model, opt, batch)[2])
                     for _ in range(BERT_TP_STEPS)]
    torch.save(res, os.path.join(out_dir, f"bert_tp{hvd.rank()}.pt"))
    hvd.shutdown()
    return 0


def phase_bert_tp(torch, dev, card) -> None:
    """[bert_tp_gloo_2rank]: BERT at bert_large width (hidden 1024, 16
    heads, FFN 4096, vocab 30522), depth cut to BERT_TP_LAYERS, S
    BERT_TP_SEQ, BERT_TP_ROWS rows, fp32 compute, on two gloo ranks over
    ``{tp: 2}`` against one process: the loss, each leaf's gradient
    reassembled from the ranks' shards, BERT_TP_STEPS AdamW steps."""
    from horovod_tpu_torch.models import bert
    cfg = bert_tp_cfg(torch)
    model = bert.Bert(cfg, dev)
    bert.init_bert(model, 0)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    batch = zoo_batch(torch, "bert_large", BERT_TP_ROWS, BERT_TP_SEQ, dev,
                      seed=4)
    with tempfile.TemporaryDirectory(prefix="bert_tp_") as out_dir:
        torch.save({"state": init,
                    "batch": {k: v.cpu() for k, v in batch.items()}},
                   os.path.join(out_dir, "inputs.pt"))
        t0 = time.perf_counter()
        _run_gloo_ranks(out_dir, 2, "bert_tp", "bert_tp_gloo_2rank")
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out_dir, f"bert_tp{r}.pt"))
                 for r in range(2)]
    loss, _ = zoo_loss(torch, "bert_large", model, batch)
    loss.backward()
    loss = float(loss.detach())
    grads = {k: p.grad.detach().cpu().clone()
             for k, p in model.named_parameters()}
    opt = bert.adamw(model.parameters(), 1e-4)
    step = bert.make_bert_train_step(model)
    losses = [float(step(model, opt, batch)[2]) for _ in range(BERT_TP_STEPS)]
    got = {}
    for k in grads:
        d = bert.tp_split_dim(k)
        parts = [r["grads"][k] for r in ranks]
        got[k] = parts[0] if d is None else torch.cat(parts, d)
    got["word_embeddings.embedding"] = \
        got["word_embeddings.embedding"][:cfg.vocab_size]
    # the key bias's true gradient is 0 (a per-query constant leaves the
    # softmax unchanged): both sides hold rounding noise there, so each
    # leaf's distance is taken relative to at least BERT_TP_GRAD_FLOOR of
    # the largest leaf's norm
    floor = BERT_TP_GRAD_FLOOR * max(float(g.double().norm())
                                     for g in grads.values())
    errs = grad_errors(got, grads, floor)
    worst = max(errs, key=lambda k: errs[k][0])
    loss_rel = max(abs(r["loss"] - loss) / abs(loss) for r in ranks)
    step_rel = max(abs(a - b) / abs(b) for r in ranks
                   for a, b in zip(r["losses"], losses))
    say("bert_tp_gloo_2rank", width="bert_large H1024 16x64 F4096 V30522",
        layers=f"{BERT_TP_LAYERS} (cut from 24)", seq=BERT_TP_SEQ,
        rows=BERT_TP_ROWS, compute="fp32", seconds=wall,
        loss=ranks[0]["loss"], one_process_loss=loss,
        loss_rel=loss_rel, tol_loss=BERT_TP_LOSS_TOL, worst_grad=worst,
        grad_rel_l2=errs[worst][0], grad_norm_floor=floor,
        tol_grad_rel_l2=BERT_TP_GRAD_TOL,
        step_losses=",".join(f"{x:.6f}" for x in ranks[0]["losses"]),
        one_process_step_losses=",".join(f"{x:.6f}" for x in losses),
        step_rel=step_rel, tol_step=BERT_TP_STEP_TOL, card=card)
    check(loss_rel <= BERT_TP_LOSS_TOL, f"bert_tp: loss {loss_rel} off")
    check(errs[worst][0] <= BERT_TP_GRAD_TOL,
          f"bert_tp: gradient of {worst} is {errs[worst][0]} off")
    check(step_rel <= BERT_TP_STEP_TOL, f"bert_tp: AdamW losses {step_rel} "
                                        f"off one process's")
    del model, opt
    torch.cuda.empty_cache()


def serve_requests(n: int, seed: int, vocab: int) -> list:
    """``n`` seeded ``(prompt, max_new)`` pairs: prompts of SERVE_PROMPT
    tokens, max_new in SERVE_NEW, prompt + max_new at most
    SERVE_CONTEXT."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        plen = int(rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        hi = min(SERVE_NEW[1], SERVE_CONTEXT - plen)
        out.append((rng.randint(0, vocab, plen).tolist(),
                    int(rng.randint(SERVE_NEW[0], hi + 1))))
    return out


def serve_engine(torch, dev, params, cfg):
    from horovod_tpu_torch.serving.generate import GenerateEngine
    return GenerateEngine(params, cfg, n_slots=SERVE_SLOTS,
                          prefill_chunk=SERVE_CHUNK, device=dev)


def serve_until_done(engine, reqs) -> None:
    from horovod_tpu_torch.serving.generate.scheduler import DONE
    n = 0
    while any(r.state != DONE for r in reqs):
        engine.step_once()
        n += 1
        check(n < 200_000, "a serving engine did not converge")


def serve_tokens(engine, jobs, prefix: str) -> list:
    """Token streams of ``jobs`` run together on ``engine``."""
    reqs = [engine.submit(f"{prefix}{i}", p, m)
            for i, (p, m) in enumerate(jobs)]
    serve_until_done(engine, reqs)
    return [r.tokens for r in reqs]


def serve_top_kernels(torch, fn, n: int = 6) -> str:
    """The ``n`` kernels of one ``fn`` call that take most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            t, c = by.get(e.name, (0.0, 0))
            by[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][0])[:n]
    return ";".join(f"{name[:60].replace(' ', '')}x{c}:{t:.4f}"
                    for name, (t, c) in top)


def serve_step_bytes(eng) -> tuple:
    """(bytes the decode step must move on the engine's current slot
    state, weights' share, bytes of the pages it gathers as written):
    every weight read once (the tied embedding for the logits), the K and
    V of the positions the active slots attend to (``length + 1`` each,
    every layer) and the K/V they write; the step as written gathers
    every slot's whole page table instead."""
    weights = sum(t.numel() * t.element_size() for t in
                  [eng.params["embed"], eng.params["ln_f"],
                   *eng.params["layers"].values()])
    k = eng._k_pages
    L, _, pt, width = k.shape
    row = 2 * L * width * k.element_size()      # K and V of one position
    active = eng._active != 0
    attended = int((eng._lengths[active] + 1).sum())
    gathered = row * eng.n_slots * eng.plan.pages_per_slot * pt
    return weights + row * (attended + int(active.sum())), weights, gathered


def phase_serve_generate(torch, dev, card) -> dict:
    """[serve_generate]: the flagship at full width (fp32, 32 slots, the
    default page bytes, prefill chunk 32) serves 64 seeded requests in two
    waves, the second while the first decodes, then (a) one capture of
    each step function over the whole phase, (b) 8 requests rerun one at
    a time equal to the bit, (c) 4 requests against the card's
    ``reference_greedy_decode`` up to the first near tie, (d) the
    request-level gang over the same requests: more decode steps, the
    same tokens, (e) the replayed decode step against the eager one on a
    churned slot state, tokens and pools to the bit (outside the scratch
    page, which masked lanes write in no fixed order)."""
    from horovod_tpu_torch.metrics.registry import default_registry
    from horovod_tpu_torch.models import reference_greedy_decode
    from horovod_tpu_torch.profiling import compile_watch
    from horovod_tpu_torch.serving.generate import (flagship_gen_setup,
                                                    request_level_generate)
    from horovod_tpu_torch.serving.ledger import quantile
    t_phase = time.perf_counter()
    params, cfg = flagship_gen_setup(device=dev)
    compile_watch.reset_counts()
    eng = serve_engine(torch, dev, params, cfg)
    plan = eng.plan
    # the default 64 KiB page: at the flagship's 16 KiB of K+V a token,
    # 4 tokens a page, 64 pages a slot, 2,049 pages with the scratch one
    token_bytes = 2 * cfg.n_layers * cfg.d_model * 4
    page_tokens = 65536 // token_bytes
    check((plan.page_tokens, plan.pages_per_slot, plan.total_pages + 1) ==
          (page_tokens, -(-cfg.max_seq // page_tokens),
           SERVE_SLOTS * -(-cfg.max_seq // page_tokens) + 1),
          f"[serve_generate]: the page plan is {plan}")
    jobs = serve_requests(SERVE_REQUESTS, 2, cfg.vocab_size)
    stamps = {}

    def submit(i, prefix="w"):
        times = stamps.setdefault(f"{prefix}{i}", [])
        return eng.submit(f"{prefix}{i}", jobs[i][0], jobs[i][1],
                          on_token=lambda _t, ts=times:
                          ts.append(time.monotonic()))

    # one warm-up request captures both step functions (the only captures
    # of the phase), so the waves below time the steady state
    t0 = time.monotonic()
    serve_until_done(eng, [eng.submit("warm", jobs[0][0][:SERVE_CHUNK + 1],
                                      2)])
    first_request_s = time.monotonic() - t0
    reg = default_registry()

    def engine_seconds():
        return [reg.counter(f"hvd_serving_{k}_seconds_total").value
                for k in ("decode", "prefill")]

    half = SERVE_REQUESTS // 2
    torch.cuda.synchronize()
    secs0 = engine_seconds()
    steps0, chunks0 = eng.decode_steps_total, eng.prefill_chunks_total
    t0 = time.monotonic()
    reqs = [submit(i) for i in range(half)]
    for _ in range(SERVE_WAVE_STEPS):
        eng.step_once()
    decoding_at_wave2 = len(eng.scheduler.decoding())
    check(decoding_at_wave2 > 0, "[serve_generate]: the second wave must "
                                 "arrive while the first decodes")
    reqs += [submit(i) for i in range(half, SERVE_REQUESTS)]
    serve_until_done(eng, reqs)
    wall = time.monotonic() - t0
    decode_s, prefill_s = (b - a for a, b in zip(secs0, engine_seconds()))
    steps = eng.decode_steps_total - steps0
    chunks = eng.prefill_chunks_total - chunks0
    tokens = sum(len(r.tokens) for r in reqs)
    check(all(len(r.tokens) == r.max_new and r.finish_reason == "length"
              for r in reqs), "[serve_generate]: a request fell short")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    itl = sorted(b - a for ts in stamps.values() for a, b in zip(ts, ts[1:]))
    occupancy = sum(r.decode_steps for r in reqs) / (steps * SERVE_SLOTS)
    check(eng.pool.in_use == 0, "[serve_generate]: pages leaked")
    high_water = eng.pool.high_water

    # (b) one at a time on the same engine: bit-identical streams
    for i in range(0, SERVE_REQUESTS, SERVE_REQUESTS // SERVE_RERUNS):
        lone = eng.submit(f"s{i}", jobs[i][0], jobs[i][1])
        serve_until_done(eng, [lone])
        check(lone.tokens == reqs[i].tokens,
              f"[serve_generate]: request {i} alone differs from its "
              f"continuous run")

    # (c) the oracle on the card, up to the first near tie
    ties = []
    for i in range(SERVE_ORACLE):
        ref, margins = reference_greedy_decode(
            params, cfg, jobs[i][0], jobs[i][1], device=dev,
            return_margins=True)
        tie = next((j for j, (m, mx) in enumerate(margins)
                    if m < SERVE_TIE_REL * mx), None)
        upto = len(ref) if tie is None else tie
        check(reqs[i].tokens[:upto] == ref[:upto],
              f"[serve_generate]: request {i} diverges from the oracle "
              f"before any near tie ({reqs[i].tokens} vs {ref})")
        if tie is not None:
            ties.append(f"{i}@{tie}:{margins[tie][0]:.3g}/"
                        f"{margins[tie][1]:.3g}")

    # (d) the request-level gang: strictly more decode steps, same tokens
    before = eng.decode_steps_total
    base = request_level_generate(eng, jobs)
    gang_steps = eng.decode_steps_total - before
    check(gang_steps > steps, f"[serve_generate]: gang {gang_steps} decode "
                              f"steps, continuous {steps}")
    check(all(b.tokens == r.tokens for b, r in zip(base, reqs)),
          "[serve_generate]: the gang's tokens differ")

    # (e) replayed against eager on a churned slot state, then timed
    # churned: sequences have finished and later ones took their slots,
    # while others still decode
    churn = [eng.submit(f"e{i}", jobs[i][0], jobs[i][1])
             for i in range(SERVE_SLOTS + SERVE_SLOTS // 2)]
    for _ in range(2_000):
        eng.step_once()
        if any(r.state == "done" for r in churn) and any(
                r.state == "decode" for r in churn[SERVE_SLOTS:]) and \
                len(eng.scheduler.decoding()) > 1:
            break
    check(any(r.state == "done" for r in churn)
          and any(r.state == "decode" for r in churn[SERVE_SLOTS:]),
          "[serve_generate]: no churned state to compare on")
    k0, v0 = eng._k_pages.clone(), eng._v_pages.clone()
    replayed = eng.decode_step_now()
    k1, v1 = eng._k_pages.clone(), eng._v_pages.clone()
    eng._k_pages.copy_(k0)
    eng._v_pages.copy_(v0)
    eager = eng.decode_step_now(eager=True)
    same = (replayed == eager).all() \
        and torch.equal(k1[:, :-1], eng._k_pages[:, :-1]) \
        and torch.equal(v1[:, :-1], eng._v_pages[:, :-1])
    check(bool(same), "[serve_generate]: the replayed decode step differs "
                      "from the eager one")
    check(not torch.equal(k1[:, :-1], k0[:, :-1]),
          "[serve_generate]: the decode step wrote no K")
    del k0, v0, k1, v1

    def host_ms(eager):
        out = []
        for _ in range(SERVE_TIMED):
            t = time.perf_counter()
            eng.decode_step_now(eager=eager)
            out.append(1e3 * (time.perf_counter() - t))
        return sorted(out)[SERVE_TIMED // 2]

    n_bytes, w_bytes, gathered_bytes = serve_step_bytes(eng)
    active_slots = int((eng._active != 0).sum())
    replay_ms, eager_ms = host_ms(False), host_ms(True)
    dev_in = eng._decode_fn.dev_in
    # device time of one replay: replays queued behind a spin kernel (the
    # prefill graph replays the last chunk it ran, into freed pages)
    replay_dev_ms = time_ms(lambda: eng._decode_fn.graph.replay())
    prefill_dev_ms = time_ms(lambda: eng._prefill_fn.graph.replay())
    eager_prof = device_breakdown(torch, lambda: eng._decode_body(dev_in))
    replay_prof = device_breakdown(torch,
                                   lambda: eng._decode_fn.graph.replay())
    top = serve_top_kernels(torch, lambda: eng._decode_body(dev_in))
    serve_until_done(eng, churn)

    # (a) over everything above: one capture of each step function
    counts = compile_watch.per_function_compiles()
    check(counts.get("gen_decode_step") == 1
          and counts.get("gen_prefill_chunk") == 1
          and eng.captures == {"gen_decode_step": 1,
                               "gen_prefill_chunk": 1},
          f"[serve_generate]: captures {counts} {eng.captures}")
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    say("serve_generate",
        model="flagship V32000 M512 H8x64 L4 F2048 max_seq256 fp32",
        slots=SERVE_SLOTS, prefill_chunk=SERVE_CHUNK,
        page_tokens=plan.page_tokens, pages=plan.total_pages + 1,
        requests=SERVE_REQUESTS, decoding_at_wave2=decoding_at_wave2,
        first_request_s_with_captures=first_request_s,
        tokens=tokens, seconds=wall, tokens_per_s=tokens / wall,
        decode_share=decode_s / wall, prefill_share=prefill_s / wall,
        ttft_p50_ms=1e3 * quantile(ttft, 0.5),
        ttft_p99_ms=1e3 * quantile(ttft, 0.99),
        itl_p50_ms=1e3 * quantile(itl, 0.5),
        itl_p99_ms=1e3 * quantile(itl, 0.99),
        decode_steps=steps, prefill_chunks=chunks, gang_decode_steps=gang_steps,
        mean_slot_occupancy=occupancy, pages_high_water=high_water,
        captures=",".join(f"{k}:{v}" for k, v in sorted(counts.items())),
        decode_step_ms_replayed=replay_ms, decode_step_ms_eager=eager_ms,
        device_ms_replayed=replay_dev_ms,
        prefill_chunk_device_ms_replayed=prefill_dev_ms,
        device_busy_ms_eager=eager_prof["device_busy_ms"],
        device_busy_ms_replay_profiled=replay_prof["device_busy_ms"],
        launches_per_eager_step=eager_prof["launches"],
        kernels_seen_in_replay=replay_prof["launches"],
        eager_device_ms_by_group=eager_prof["device_ms_by_group"],
        eager_top_kernels=top, timed_state_active_slots=active_slots,
        decode_step_bytes=n_bytes, weight_bytes=w_bytes,
        pages_gathered_bytes=gathered_bytes, bound_ms_at_3_35TBps=bound,
        reruns_equal=SERVE_RERUNS, oracle_equal=SERVE_ORACLE,
        near_ties=";".join(ties) or "none", tie_rel=SERVE_TIE_REL,
        replay_equals_eager=True, phase_s=time.perf_counter() - t_phase,
        card=card)
    return {"engine": eng, "cfg": cfg}


def phase_serve_http(torch, dev, card, served: dict) -> None:
    """[serve_http]: a generate-mode ``ReplicaServer`` on the card serves
    the flagship from a store holding one commit, behind an in-process
    ``Router``: SERVE_HTTP concurrent ``/generate`` requests plus two more
    copies of two ids, a second commit (seed-1 weights, step 2) written
    mid-run and swapped in, SERVE_HTTP_AFTER requests after the swap (the
    tokens of an engine of the same geometry on the new weights), then
    SERVE_HTTP_AFTER more with ``/drain`` posted once all are admitted.
    Checks: one token stream per id, zero failed requests, the books
    closed exactly once, DRAINED, every stream (those live at the swap
    too) the stream of the weights its version names; and one ``/infer``
    of the demo model."""
    import threading
    import urllib.request

    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.serving import ReplicaServer, Router
    from horovod_tpu_torch.serving.generate import flagship_gen_setup
    t_phase = time.perf_counter()
    ref, cfg = served["engine"], served["cfg"]
    w0, _ = flagship_gen_setup(seed=0, device="cpu")
    w1, _ = flagship_gen_setup(seed=1, device="cpu")
    lock = threading.Lock()
    results, errors = {}, []

    def fire(router, rid, prompt, max_new):
        try:
            doc = router.submit_generate(prompt, max_new=max_new,
                                         req_id=rid)
        except Exception as e:
            with lock:
                errors.append(f"{rid}: {e!r}")
            return
        with lock:
            results.setdefault(rid, []).append(doc)

    def wave(router, calls):
        threads = [threading.Thread(target=fire, args=(router, *c),
                                    daemon=True) for c in calls]
        for t in threads:
            t.start()
        return threads

    def join(threads):
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
        check(not any(t.is_alive() for t in threads),
              "[serve_http]: a request never returned")

    with tempfile.TemporaryDirectory(prefix="serve_http_") as store_dir:
        store = ShardedCheckpointer(store_dir, rank=0, world_size=1)
        store.save(1, {"params": w0}, wait=True)
        rep = ReplicaServer(mode="generate", gen_model=(w0, cfg),
                            store_dir=store_dir, swap_poll_s=0.1,
                            device=dev, replica_id="h0",
                            gen_kwargs={"n_slots": SERVE_SLOTS,
                                        "prefill_chunk": SERVE_CHUNK}
                            ).start()
        router = Router([("127.0.0.1", rep.port)], max_inflight=64,
                        hedge_ms=0, attempt_timeout_s=SERVE_TIMEOUT_S,
                        default_deadline_s=SERVE_TIMEOUT_S)
        try:
            check(rep._version == 1, "[serve_http]: step 1 not loaded")
            jobs_a = serve_requests(SERVE_HTTP, 3, cfg.vocab_size)
            calls = [(f"a{i}", p, m) for i, (p, m) in enumerate(jobs_a)]
            calls += [(f"a{i}", *jobs_a[i]) for i in (0, 1) for _ in (0, 1)]
            t_a = wave(router, calls)
            time.sleep(0.3)
            t_save = time.perf_counter()
            store.save(2, {"params": w1}, wait=True)
            join(t_a)
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            while rep._version != 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            swap_s = time.perf_counter() - t_save
            check(rep._version == 2, "[serve_http]: step 2 never swapped in")
            jobs_b = serve_requests(SERVE_HTTP_AFTER, 4, cfg.vocab_size)
            join(wave(router, [(f"b{i}", p, m)
                               for i, (p, m) in enumerate(jobs_b)]))
            jobs_c = serve_requests(SERVE_HTTP_AFTER, 5, cfg.vocab_size)
            t_c = wave(router, [(f"c{i}", p, m)
                                for i, (p, m) in enumerate(jobs_c)])
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            while time.monotonic() < deadline:
                # in flight or already answered (cached before its
                # in-flight entry goes): admitted past the engine's queue
                with rep._pending_lock:
                    admitted = len({k for k in (*rep._pending,
                                                *rep._resp_cache)
                                    if k.startswith("c")})
                if admitted == SERVE_HTTP_AFTER:
                    break
                time.sleep(0.002)
            req = urllib.request.Request(
                f"http://127.0.0.1:{rep.port}/drain", data=b"{}",
                method="POST")
            urllib.request.urlopen(req, timeout=10).read()
            join(t_c)
            drained = rep.wait_drained(SERVE_TIMEOUT_S)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rep.port}/healthz", timeout=10) as r:
                health = json.loads(r.read())
            acct = router.accounting()
        finally:
            router.close()
            rep.stop()
            store.close()
    check(not errors, f"[serve_http]: failed requests {errors[:3]}")
    check(admitted == SERVE_HTTP_AFTER, "[serve_http]: the drain came "
                                        "before every request was admitted")
    check(drained and health["drained"], "[serve_http]: not DRAINED")
    n_sent = len(calls) + 2 * SERVE_HTTP_AFTER
    check(acct["accepted"] == acct["answered_ok"] == n_sent
          and not acct["unanswered"] and not acct["answered_twice"]
          and acct["outcomes"].get("failed", 0) == 0,
          f"[serve_http]: the books {acct}")
    for i, (p, m) in enumerate(jobs_a):
        docs = results[f"a{i}"]
        check(len({(tuple(d["tokens"]), d["version"]) for d in docs}) == 1
              and all(d["tokens_emitted"] == m for d in docs)
              and len(docs) == (3 if i < 2 else 1),
              f"[serve_http]: id a{i} returned {len(docs)} copies or "
              f"several streams")
    # the first wave was live when step 2 landed: each of its streams must
    # be the stream of the weights its version names (the reference
    # engine holds the seed-0 weights, step 1's, until it loads w1)
    a_version = [results[f"a{i}"][0]["version"] for i in range(len(jobs_a))]
    check(set(a_version) <= {1, 2}, f"[serve_http]: versions {a_version}")

    def held_to(version, tag):
        idx = [i for i, v in enumerate(a_version) if v == version]
        want = serve_tokens(ref, [jobs_a[i] for i in idx], tag)
        for i, toks in zip(idx, want):
            check(results[f"a{i}"][0]["tokens"] == toks,
                  f"[serve_http]: a{i} is not the stream of version "
                  f"{version}'s weights")

    held_to(1, "ra1")
    ref.load_params(w1)
    held_to(2, "ra2")
    for tag, jobs in (("b", jobs_b), ("c", jobs_c)):
        want = serve_tokens(ref, jobs, f"r{tag}")
        for i in range(len(jobs)):
            doc = results[f"{tag}{i}"][0]
            check(doc["version"] == 2 and doc["tokens"] == want[i],
                  f"[serve_http]: {tag}{i} after the swap is not the new "
                  f"weights' stream (version {doc['version']})")
    ref.load_params(w0)
    # the request-level path of the demo model rides along
    inf = ReplicaServer(dim=16, device=dev, replica_id="i0").start()
    try:
        body = json.dumps({"id": "x0", "x": [float(i) for i in range(16)]})
        req = urllib.request.Request(
            f"http://127.0.0.1:{inf.port}/infer", data=body.encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            doc = json.loads(r.read())
    finally:
        inf.stop()
    infer_err = max(abs(y - 7.5) for y in doc["y"])
    check(infer_err < 1e-5 and doc["version"] == 0,
          f"[serve_http]: /infer gave {doc}")
    ttft_b = sorted(results[f"b{i}"][0]["ttft_s"]
                    for i in range(len(jobs_b)))
    say("serve_http", requests=n_sent, duplicate_ids=2,
        swapped_to=2, swap_seen_s=swap_s, drained=True,
        first_wave_versions=",".join(f"{v}:{a_version.count(v)}"
                                     for v in (1, 2)),
        accounting=json.dumps(acct["outcomes"], sort_keys=True),
        after_swap_equal=len(jobs_b) + len(jobs_c),
        ttft_p50_ms_after_swap=1e3 * ttft_b[len(ttft_b) // 2],
        infer_max_abs_err=infer_err, phase_s=time.perf_counter() - t_phase,
        card=card)


def phase_serve_fleet(torch, dev, card, served: dict) -> None:
    """[serve_fleet]: a ``ReplicaFleet`` of two generate-mode replica
    processes on the one card (the flagship, seed-0 weights, 32 slots,
    chunk 32) behind a ``Router``: SERVE_FLEET requests, one replica
    SIGKILLed mid-run. Zero failed requests, every stream equal to the
    same geometry's in this process, the exit classified a failure, and
    the fleet healed back to two."""
    import threading

    from horovod_tpu_torch.serving import ReplicaFleet, Router
    t_phase = time.perf_counter()
    ref, cfg = served["engine"], served["cfg"]
    jobs = serve_requests(SERVE_FLEET, 6, cfg.vocab_size)
    want = serve_tokens(ref, jobs, "rf")
    fleet = ReplicaFleet(size=2, mode="generate", device=str(dev),
                         poll_s=0.1,
                         extra_args=["--flagship", "--slots",
                                     str(SERVE_SLOTS), "--prefill-chunk",
                                     str(SERVE_CHUNK)])
    router = None
    results, errors = {}, []
    try:
        t0 = time.perf_counter()
        fleet.start(ready_timeout_s=SERVE_TIMEOUT_S)
        ready_s = time.perf_counter() - t0
        router = Router(fleet.endpoints, max_attempts=8, hedge_ms=0,
                        attempt_timeout_s=SERVE_TIMEOUT_S,
                        default_deadline_s=SERVE_TIMEOUT_S)

        def fire(i):
            try:
                results[i] = router.submit_generate(
                    jobs[i][0], max_new=jobs[i][1], req_id=f"q{i}")
            except Exception as e:
                errors.append(f"q{i}: {e!r}")

        threads = [threading.Thread(target=fire, args=(i,), daemon=True)
                   for i in range(SERVE_FLEET)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        victim = fleet._replicas[1]
        os.kill(victim.proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
        check(not any(t.is_alive() for t in threads),
              "[serve_fleet]: a request never returned")
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while time.monotonic() < deadline and not (
                fleet.live_count() == 2
                and any(e["outcome"] == "failure" for e in fleet.exits)):
            time.sleep(0.1)
        heal_s = time.perf_counter() - t_kill
        live = fleet.live_count()
        acct = router.accounting()
        exits = list(fleet.exits)
    finally:
        if router is not None:
            router.close()
        fleet.stop()
    check(not errors, f"[serve_fleet]: failed requests {errors[:3]}")
    check(live == 2, f"[serve_fleet]: the fleet healed to {live}")
    kills = [e for e in exits if e["outcome"] == "failure"]
    check(len(kills) == 1 and kills[0]["rc"] == -signal.SIGKILL,
          f"[serve_fleet]: exits {[(e['rc'], e['outcome']) for e in exits]}")
    check(acct["accepted"] == acct["answered_ok"] == SERVE_FLEET
          and not acct["unanswered"] and not acct["answered_twice"]
          and acct["outcomes"].get("failed", 0) == 0,
          f"[serve_fleet]: the books {acct}")
    check(all(results[i]["tokens"] == want[i] for i in range(SERVE_FLEET)),
          "[serve_fleet]: a stream differs from this process's engine")
    say("serve_fleet", replicas=2, requests=SERVE_FLEET,
        accounting=json.dumps(acct["outcomes"], sort_keys=True),
        killed_rc=kills[0]["rc"], ready_s=ready_s, healed_s=heal_s,
        streams_equal=SERVE_FLEET, phase_s=time.perf_counter() - t_phase,
        card=card)


def http_get(port: int, path: str, timeout: float = 30):
    """``(status, body)`` of one GET on this host, an HTTP error's too."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def repo_cli(*args, timeout: float = 120):
    """``python -m <args>`` from this checkout; returns (exit code,
    stdout, stderr)."""
    path = [os.path.dirname(os.path.abspath(__file__)),
            os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, path)))
    r = subprocess.run([sys.executable, "-m", *args], env=env,
                       capture_output=True, text=True, timeout=timeout)
    return r.returncode, r.stdout, r.stderr


class Scraper:
    """A thread scraping an exporter's ``/metrics`` every ``period``
    seconds while ``active`` is set, keeping each scrape's round-trip
    seconds and its parsed series, and one ``/debug/stacks`` answer taken
    while the training thread runs."""

    def __init__(self, port: int, period: float):
        import threading
        self.port, self.period = port, period
        self.active = threading.Event()
        self.done = threading.Event()
        self.seconds, self.series, self.errors = [], [], []
        self.stacks = None
        self._thread = threading.Thread(target=self._loop, name="scraper",
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        from horovod_tpu_torch.metrics.__main__ import parse_prometheus
        while not self.done.is_set():
            if not self.active.wait(0.05):
                continue
            t0 = time.perf_counter()
            try:
                code, body = http_get(self.port, "/metrics")
                self.seconds.append(time.perf_counter() - t0)
                self.series.append(parse_prometheus(body.decode()))
                if self.stacks is None:
                    self.stacks = http_get(self.port, "/debug/stacks")[1] \
                        .decode()
            except Exception as e:  # counted, and checked by the phase
                self.errors.append(repr(e))
            self.done.wait(max(0.0, self.period
                               - (time.perf_counter() - t0)))

    def stop(self):
        self.done.set()
        self._thread.join(timeout=30)


def phase_obs_exporter(torch, cfg, init_sd, batch, counters):
    """[obs_exporter]: an NCCL world of one with the worker exporter, the
    watchdog and a timeline shard; TELEMETRY_STEPS AdamW steps inside
    TelemetryCallback while a thread scrapes at 10 Hz, every check of the
    module docstring, then the step timed with and without the scraper,
    in turns. Returns the kernels' launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import profiling
    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.diagnostics import watchdog
    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.metrics.__main__ import parse_prometheus
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_train_step)
    tokens, targets = batch
    with tempfile.TemporaryDirectory(prefix="obs_exporter_") as tmp:
        os.makedirs(os.path.join(tmp, "timeline"))
        base, held = reserve_ports(1)
        with environ(HVD_TPU_METRICS_PORT=base, HVD_TPU_WATCHDOG_SECONDS=60,
                     HVD_TPU_TIMELINE=os.path.join(tmp, "timeline") + os.sep,
                     HVD_TPU_TIMELINE_ALL_RANKS=1,
                     HVD_TPU_PROFILE_DIR=os.path.join(tmp, "profile"),
                     HVD_TPU_AUTOPSY_DIR=os.path.join(tmp, "autopsy")):
            reset_observability()
            watchdog.reset()
            hvd.init()
            for sock in held:
                sock.close()
            exp = _state.metrics_exporter
            check(exp is not None and exp.port == base,
                  f"obs_exporter: init started no exporter on :{base}")
            model = Transformer(cfg)
            model.load_state_dict(init_sd)
            opt = init_opt_state(adamw, model)
            step = make_train_step(cfg)
            cb = hvd.TelemetryCallback(units_per_step=tokens.numel(),
                                       unit="tokens")
            check(cb.watchdog is not None and cb.watchdog.armed,
                  "obs_exporter: the callback armed no watchdog")
            scraper = Scraper(base, OBS_SCRAPE_S)
            for c in counters:
                c.launches = 0
            scraper.active.set()
            losses, planned = [], None
            for i in range(TELEMETRY_STEPS):
                cb.on_step_begin()
                losses.append(float(step(model, opt, tokens, targets)[2]))
                cb.on_step_end()
                if i + 1 == OBS_PROFILE_AT:
                    code, body = http_get(
                        base, f"/debug/profile?steps={OBS_PROFILE_STEPS}")
                    planned = json.loads(body) if code == 200 else None
            scraper.active.clear()
            launches = {"flash_attention_fwd": counters[0].launches,
                        "xent_fwd": counters[1].launches}
            m_code, m_body = http_get(base, "/metrics")
            series = parse_prometheus(m_body.decode())
            h_code, h_body = http_get(base, "/healthz")
            health = json.loads(h_body)
            f_code, f_body = http_get(base, "/debug/flight")
            flight = json.loads(f_body)["events"]
            top_rc, top_out, top_err = repo_cli(
                "horovod_tpu_torch.metrics", "top", "--url",
                f"http://127.0.0.1:{base}", "--once")
            caps = profiling.recent_captures()
            kernels = trace_kernel_names(caps[0]["path"]) if caps else []

            # the scraper's cost: steps with and without it, in turns
            # (which goes first swapped every pair)
            with_s, without_s = [], []
            for i in range(OBS_PAIRS):
                for scraped in ((True, False) if i % 2 else (False, True)):
                    (scraper.active.set if scraped
                     else scraper.active.clear)()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    cb.on_step_begin()
                    float(step(model, opt, tokens, targets)[2])
                    cb.on_step_end()
                    (with_s if scraped else without_s).append(
                        time.perf_counter() - t0)
            scraper.active.clear()
            scraper.stop()
            render_s = []
            for _ in range(20):
                t0 = time.perf_counter()
                exp.render()
                render_s.append(time.perf_counter() - t0)
            fired = cb.watchdog.trigger_count
            cb.on_train_end()
            hvd.shutdown()
            shard = os.path.join(tmp, "timeline", "timeline.rank0.json")
            shard_ok = os.path.exists(shard) and os.path.getsize(shard) > 0
            check(_state.metrics_exporter is None,
                  "obs_exporter: shutdown left the exporter running")
    steps_end = sorted(e["step"] for e in flight if e["kind"] == "step_end")
    top_line = [ln for ln in top_out.splitlines()
                if ln.startswith("steps total")]
    say("obs_exporter", steps=TELEMETRY_STEPS,
        losses=",".join(f"{x:.6f}" for x in losses),
        scrapes=len(scraper.series), scrape_errors=len(scraper.errors),
        scrape_ms_q1_med_q3=quartiles_ms(scraper.seconds),
        render_ms_q1_med_q3=quartiles_ms(render_s),
        metrics_bytes=len(m_body), pairs=OBS_PAIRS,
        step_ms_scraped_q1_med_q3=quartiles_ms(with_s),
        step_ms_unscraped_q1_med_q3=quartiles_ms(without_s),
        healthz=h_code, last_step=health.get("last_step"),
        watchdog_armed=health.get("watchdog", {}).get("armed"),
        flight_step_ends=len(steps_end), watchdog_fired=fired,
        profile_planned=bool(planned and planned.get("started")),
        captures=len(caps), trace_kernels=len(kernels),
        top=top_line[0] if top_line else None,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"obs_exporter: losses {losses}")
    check(not scraper.errors and len(scraper.series) >= 1,
          f"obs_exporter: {len(scraper.series)} scrapes, errors "
          f"{scraper.errors[:3]}")
    check(m_code == 200 and series.get("hvd_steps_total") == TELEMETRY_STEPS
          and series.get("hvd_step_time_seconds_count") == TELEMETRY_STEPS,
          f"obs_exporter: /metrics {m_code} counts "
          f"{series.get('hvd_steps_total')} "
          f"{series.get('hvd_step_time_seconds_count')}")
    check(h_code == 200 and health.get("status") == "ok"
          and health.get("last_step") == TELEMETRY_STEPS
          and health.get("watchdog", {}).get("armed") is True,
          f"obs_exporter: /healthz {h_code} {health}")
    check(scraper.stacks is not None
          and "phase_obs_exporter" in scraper.stacks,
          "obs_exporter: /debug/stacks does not show the training thread")
    check(f_code == 200 and any(e["kind"] == "init" for e in flight)
          and steps_end == list(range(1, TELEMETRY_STEPS + 1)),
          f"obs_exporter: /debug/flight step_ends {steps_end}")
    check(planned is not None and planned.get("started") is True
          and planned.get("steps") == OBS_PROFILE_STEPS,
          f"obs_exporter: /debug/profile answered {planned}")
    check(len(caps) == 1 and caps[0]["path"] == planned["path"]
          and caps[0]["steps"] == OBS_PROFILE_STEPS,
          f"obs_exporter: captures {caps}")
    for want in ("flash_fwd_kernel", "xent_fwd_kernel"):
        check(any(want in k for k in kernels),
              f"obs_exporter: the capture names no {want}: {kernels[:20]}")
    check(top_rc == 0 and top_line == [f"steps total     : "
                                       f"{TELEMETRY_STEPS}"],
          f"obs_exporter: metrics top exited {top_rc}: {top_out} "
          f"{top_err[-2000:]}")
    check(fired == 0 and not any(e["kind"] == "watchdog_trigger"
                                 for e in flight),
          f"obs_exporter: the watchdog fired {fired} time(s)")
    check(shard_ok, "obs_exporter: no timeline shard")
    want = {"flash_attention_fwd": cfg.n_layers * TELEMETRY_STEPS,
            "xent_fwd": TELEMETRY_STEPS}
    check(launches == want, f"obs_exporter: launches {launches}, expected "
                            f"{want}")
    del model, opt
    recorder().clear()
    return launches


def obs_rank_setup(torch):
    """One rank of an observability world: ``init``, the flagship from
    the seed-0 weights on ``cuda:0`` (every rank of the world shares the
    card), this rank's rows of the batch over ``{dp: size}``, the launch
    counters zeroed. Returns ``(hvd, model, mesh, local, counters)``."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.entry import entry
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    _, (model, tokens, targets) = entry(device=torch.device("cuda", 0))
    mesh = hvd.build_mesh(dp=hvd.size())
    local = hvd.shard_batch(tokens, targets, mesh)
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return hvd, model, mesh, local, counters


def obs_fleet_rank_main(out_dir: str) -> int:
    """One rank of [obs_fleet_4rank]: OBS_FLEET_STEPS data-parallel AdamW
    steps of the flagship inside TelemetryCallback, each step marked on
    the rank's timeline shard; then the tree flushed leaves first and
    rank 0's ``/metrics/fleet`` read. Rank 0 also watches its fleet view
    from init on: when the first push arrived and when it covered every
    rank. Writes ``rank<r>.json`` and the flight ring to
    ``flight/hvd_flight_rank<r>.json``."""
    import threading

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.diagnostics.flight_recorder import (recorder,
                                                               wall_offset)
    from horovod_tpu_torch.metrics.__main__ import parse_prometheus
    from horovod_tpu_torch.metrics.fleet import tree_depth
    from horovod_tpu_torch.models import adamw, init_opt_state, make_train_step
    import horovod_tpu_torch as hvd
    hvd.init()
    r, n = hvd.rank(), hvd.size()
    exp = _state.metrics_exporter
    fleet = exp.fleet
    seen, stop = {}, threading.Event()

    def watch():
        # seconds from init: the children push from their own init on
        t0 = time.perf_counter()
        while not stop.wait(0.02):
            if "first_push" not in seen and fleet.pushes_received > 0:
                seen["first_push"] = time.perf_counter() - t0
            if fleet.subtree_doc(consume_window=False)["covers"] \
                    == list(range(n)):
                seen["covered"] = time.perf_counter() - t0
                return

    watcher = threading.Thread(target=watch, daemon=True)
    if r == 0:
        watcher.start()
    hvd, model, mesh, local, counters = obs_rank_setup(torch)
    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg, mesh)
    cb = hvd.TelemetryCallback(units_per_step=local[0].numel(),
                               unit="tokens")
    losses = []
    for i in range(OBS_FLEET_STEPS):
        cb.on_step_begin()
        losses.append(float(step(model, opt, *local)[2]))
        cb.on_step_end()
        _state.timeline.instant("step_end", {"step": i + 1})
    cb.on_train_end()
    launches = {k: c.launches for k, c in counters.items()}
    # leaves first, so rank 0's view covers every rank's last step
    depth = tree_depth(r + 1, OBS_FLEET_ARITY)   # hops from r to rank 0
    for level in range(tree_depth(n, OBS_FLEET_ARITY), 0, -1):
        dist.barrier()
        if depth == level:
            fleet.flush()
    dist.barrier()
    res = {"rank": r, "losses": losses, "digest": params_digest(model),
           "offset_s": wall_offset(), "launches": launches,
           "children": fleet.children, "parent": fleet.parent,
           "pushes_sent": fleet.pushes_sent,
           "pushes_received": fleet.pushes_received}
    if r == 0:
        watcher.join(timeout=30)
        stop.set()
        code, body = http_get(exp.port, "/metrics/fleet")
        series = parse_prometheus(body.decode())
        res.update(fleet_code=code, fleet_series={
            k: v for k, v in series.items() if k.startswith(
                ("hvd_fleet_", "hvd_steps_total"))},
            covers=fleet.subtree_doc(consume_window=False)["covers"],
            first_push_s=seen.get("first_push"),
            covered_s=seen.get("covered"))
    os.makedirs(os.path.join(out_dir, "flight"), exist_ok=True)
    recorder().dump_to(os.path.join(out_dir, "flight",
                                    f"hvd_flight_rank{r}.json"))
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    hvd.shutdown()
    return 0


def phase_obs_fleet(torch, card: str) -> dict:
    """[obs_fleet_4rank]: four gloo ranks of this script on cuda:0 as the
    local ranks of one host (exporters at consecutive ports), the fleet
    tree at arity 2 pushing every OBS_FLEET_PUSH_S, timeline shards on;
    the checks of the module docstring. Returns rank 0's launches."""
    with tempfile.TemporaryDirectory(prefix="obs_fleet_") as out_dir:
        tl = os.path.join(out_dir, "timeline")
        os.makedirs(tl)
        base, held = reserve_ports(4)
        try:
            _run_gloo_ranks(out_dir, 4, "obs_fleet", "obs_fleet_4rank",
                            one_host=True, env_extra={
                                "HVD_TPU_METRICS_PORT": str(base),
                                "HVD_TPU_FLEET_ARITY": str(OBS_FLEET_ARITY),
                                "HVD_TPU_FLEET_PUSH_SECONDS":
                                    str(OBS_FLEET_PUSH_S),
                                "HVD_TPU_TIMELINE": tl + os.sep,
                                "HVD_TPU_TIMELINE_ALL_RANKS": "1",
                                "HVD_TPU_AUTOPSY_DIR":
                                    os.path.join(out_dir, "autopsy")})
        finally:
            for sock in held:
                sock.close()
        res = []
        for r in range(4):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
        merged = os.path.join(out_dir, "merged.json")
        m_rc, m_out, m_err = repo_cli("horovod_tpu_torch.diagnostics",
                                      "merge", "--dir", tl, "-o", merged)
        with open(merged) as f:
            mdoc = json.load(f)
        timeline = os.path.join(out_dir, "timeline_flight.json")
        t_rc, t_out, t_err = repo_cli(
            "horovod_tpu_torch.diagnostics", "timeline", "--dir",
            os.path.join(out_dir, "flight"), "-o", timeline)
        with open(timeline) as f:
            tdoc = json.load(f)
    rows = {e["pid"]: e["args"]["name"] for e in mdoc["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name"}
    marks = {}
    for e in mdoc["traceEvents"]:
        if e.get("name") == "step_end" and e.get("ph") == "i":
            marks.setdefault(e["pid"], []).append(e["args"]["step"])
    tracks = {e["pid"]: e["args"]["name"] for e in tdoc["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "process_name"}
    by_rank = {}
    for e in sorted((e for e in tdoc["traceEvents"]
                     if e.get("ph") == "i" and e.get("name") == "step_end"),
                    key=lambda e: e["ts"]):
        by_rank.setdefault(tracks[e["pid"]], []).append(e["args"]["step"])
    r0 = res[0]
    fs = r0["fleet_series"]
    say("obs_fleet_4rank", ranks=4, arity=OBS_FLEET_ARITY,
        push_s=OBS_FLEET_PUSH_S, tree_depth=fs.get("hvd_fleet_tree_depth"),
        fleet_steps_total=fs.get("hvd_steps_total"),
        ranks_reporting=fs.get("hvd_fleet_ranks_reporting"),
        covers=",".join(map(str, r0["covers"])),
        first_push_s=r0["first_push_s"], covered_all_s=r0["covered_s"],
        covered_after_first_push_s=(r0["covered_s"] - r0["first_push_s"]
                                    if r0["covered_s"] is not None
                                    and r0["first_push_s"] is not None
                                    else None),
        pushes_received=",".join(str(x["pushes_received"]) for x in res),
        offsets_s=",".join(f"{x['offset_s']:.6f}" for x in res),
        merged_rows=len(rows), timeline_tracks=len(by_rank),
        losses=",".join(f"{x:.6f}" for x in r0["losses"]), card=card)
    check(r0["fleet_code"] == 200 and r0["covers"] == [0, 1, 2, 3]
          and fs.get("hvd_fleet_ranks_reporting") == 4
          and fs.get("hvd_fleet_tree_depth") == 2,
          f"obs_fleet_4rank: /metrics/fleet {r0['fleet_code']} covers "
          f"{r0['covers']} {fs}")
    check(fs.get("hvd_steps_total") == 4 * OBS_FLEET_STEPS,
          f"obs_fleet_4rank: fleet hvd_steps_total "
          f"{fs.get('hvd_steps_total')}, expected {4 * OBS_FLEET_STEPS}")
    check([x["children"] for x in res] == [[1, 2], [3], [], []],
          f"obs_fleet_4rank: tree {[x['children'] for x in res]}")
    check(r0["covered_s"] is not None, "obs_fleet_4rank: the fleet view "
                                       "never covered every rank")
    for x in res:
        check(math.isfinite(x["offset_s"]) and abs(x["offset_s"]) < 1.0,
              f"obs_fleet_4rank: rank {x['rank']}'s clock offset "
              f"{x['offset_s']}")
        ls = x["losses"]
        check(all(map(math.isfinite, ls)) and ls[-1] < ls[0],
              f"obs_fleet_4rank: rank {x['rank']} losses {ls}")
        check(x["launches"]["flash_attention_fwd"] > 0
              and x["launches"]["xent_fwd"] > 0,
              f"obs_fleet_4rank: rank {x['rank']} launches {x['launches']}")
    check(len({x["digest"] for x in res}) == 1,
          "obs_fleet_4rank: the ranks' parameters differ")
    check(m_rc == 0 and sorted(rows.values())
          == [f"rank {r}" for r in range(4)]
          and all(marks.get(r) == list(range(1, OBS_FLEET_STEPS + 1))
                  for r in range(4)),
          f"obs_fleet_4rank: diagnostics merge rc {m_rc} rows {rows} "
          f"marks {marks} {m_err[-2000:]}")
    check(t_rc == 0 and sorted(by_rank) == [f"flight rank {r}"
                                            for r in range(4)]
          and all(v == list(range(1, OBS_FLEET_STEPS + 1))
                  for v in by_rank.values()),
          f"obs_fleet_4rank: diagnostics timeline rc {t_rc} step_ends "
          f"{by_rank} {t_err[-2000:]}")
    return r0["launches"]


def obs_hang_rank_main(out_dir: str) -> int:
    """One rank of [obs_hang_autopsy]: the flagship's steps with the eager
    int8 ``DistributedOptimizer`` sync inside TelemetryCallback, the
    watchdog at OBS_HANG_WATCHDOG_S; before the last step's sync rank 1
    sleeps OBS_HANG_STALL watchdog timeouts, and rank 0 blocks in that
    sync. Rank 0 polls its own ``/healthz`` meanwhile. One warm-up step
    runs before the callback arms the watchdog. Writes ``rank<r>.json``."""
    import threading

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.common.basics import _state
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.models import adamw, make_train_step
    hvd, model, mesh, local, counters = obs_rank_setup(torch)
    r = hvd.rank()
    port = _state.metrics_exporter.port
    opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                   named_parameters=model.named_parameters(),
                                   compression=Compression.int8)
    step = make_train_step(model.cfg)
    float(step(model, opt, *local)[2])          # warm-up, unobserved
    health, stop = [], threading.Event()

    def poll():
        while not stop.wait(0.25):
            code, body = http_get(port, "/healthz", timeout=10)
            health.append((code, json.loads(body).get("status")))

    poller = threading.Thread(target=poll, daemon=True)
    for c in counters.values():
        c.launches = 0
    cb = hvd.TelemetryCallback(units_per_step=local[0].numel(),
                               unit="tokens")
    if r == 0:
        poller.start()
    losses, stalled_s = [], None
    for i in range(OBS_HANG_STEPS):
        cb.on_step_begin()
        if r == 1 and i == OBS_HANG_STEPS - 1:
            t0 = time.perf_counter()
            time.sleep(OBS_HANG_STALL * OBS_HANG_WATCHDOG_S)
            stalled_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        losses.append(float(step(model, opt, *local)[2]))
        if i == OBS_HANG_STEPS - 1:
            stalled_s = stalled_s or time.perf_counter() - t0
        cb.on_step_end()
        _state.timeline.instant("step_end", {"step": i + 1})
    fired = cb.watchdog.trigger_count
    cb.on_train_end()
    stop.set()
    res = {"rank": r, "losses": losses, "digest": params_digest(model),
           "fired": fired, "health": health, "stalled_s": stalled_s,
           "launches": {k: c.launches for k, c in counters.items()}}
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    hvd.shutdown()
    return 0


def phase_obs_hang(torch, card: str) -> dict:
    """[obs_hang_autopsy]: two gloo ranks of this script on cuda:0, one
    stalled; the checks of the module docstring. Returns rank 0's
    launches."""
    with tempfile.TemporaryDirectory(prefix="obs_hang_") as out_dir:
        bundle = os.path.join(out_dir, "bundle")
        tl = os.path.join(out_dir, "timeline")
        os.makedirs(tl)
        base, held = reserve_ports(2)
        try:
            _run_gloo_ranks(out_dir, 2, "obs_hang", "obs_hang_autopsy",
                            one_host=True, env_extra={
                                "HVD_TPU_METRICS_PORT": str(base),
                                "HVD_TPU_WATCHDOG_SECONDS":
                                    str(OBS_HANG_WATCHDOG_S),
                                "HVD_TPU_AUTOPSY_DIR": bundle,
                                "HVD_TPU_TIMELINE": tl + os.sep,
                                "HVD_TPU_TIMELINE_ALL_RANKS": "1"})
        finally:
            for sock in held:
                sock.close()
        res = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                res.append(json.load(f))
        files = sorted(os.listdir(bundle))
        sizes = {f: os.path.getsize(os.path.join(bundle, f)) for f in files}

        def load(name):
            with open(os.path.join(bundle, name)) as f:
                return f.read() if name.endswith(".txt") else json.load(f)

        stacks0 = load("stacks_rank0.txt") \
            if "stacks_rank0.txt" in files else ""
        flight0 = load("flight_rank0.json")["events"] \
            if "flight_rank0.json" in files else []
        summary0 = load("summary_rank0.json") \
            if "summary_rank0.json" in files else {}
        peer_flight = load("peer_rank1_flight.json")["events"] \
            if "peer_rank1_flight.json" in files else []
        merged = load("merged_trace.json") \
            if "merged_trace.json" in files else {"traceEvents": []}
    # the main thread's section of rank 0's stacks (faulthandler lists it
    # last, after "Thread ... (most recent call first):")
    blocked = [sec for sec in stacks0.split("\n\n")
               if "obs_hang_rank_main" in sec]
    trig = [e for e in flight0 if e["kind"] == "watchdog_trigger"]
    to_bundle = (summary0["written_at"] - trig[0]["ts"]
                 if trig and summary0 else None)
    step_ends0 = [e["step"] for e in flight0 if e["kind"] == "step_end"]
    peer_steps = [e["step"] for e in peer_flight if e["kind"] == "step_end"]
    stalled = [s for c, s in res[0]["health"] if c == 503]
    say("obs_hang_autopsy", watchdog_s=OBS_HANG_WATCHDOG_S,
        stall_s=res[1]["stalled_s"], rank0_blocked_s=res[0]["stalled_s"],
        fired=",".join(str(x["fired"]) for x in res),
        healthz_503=len(stalled), healthz_polls=len(res[0]["health"]),
        trigger_to_bundle_s=to_bundle, bundle_files=len(files),
        bundle_bytes=sum(sizes.values()),
        peers_fetched=summary0.get("peers_fetched"),
        peer_flight_steps=peer_steps, flight_steps=step_ends0,
        merged_trace_events=len(merged["traceEvents"]), card=card)
    check(stalled and set(stalled) == {"stalled"},
          f"obs_hang_autopsy: rank 0's /healthz never went 503 stalled: "
          f"{res[0]['health']}")
    check([x["fired"] for x in res] == [1, 1],
          f"obs_hang_autopsy: watchdog fired {[x['fired'] for x in res]}")
    want = {f"{k}_rank{r}.{'txt' if k == 'stacks' else 'json'}"
            for r in (0, 1)
            for k in ("stacks", "flight", "engine", "metrics", "summary")}
    want |= {"merged_trace.json", "peer_rank1_stacks.txt",
             "peer_rank1_flight.json", "peer_rank1_engine.json"}
    check(want <= set(files), f"obs_hang_autopsy: bundle lacks "
                              f"{sorted(want - set(files))}")
    check(len(blocked) == 1 and ("mesh_collectives.py" in blocked[0]
                                 or "train/optimizer.py" in blocked[0]),
          f"obs_hang_autopsy: rank 0's blocked frames name no collective: "
          f"{blocked}")
    check(step_ends0 == [1, 2] and len(trig) == 1,
          f"obs_hang_autopsy: rank 0's flight step_ends {step_ends0}, "
          f"{len(trig)} trigger(s)")
    check(summary0.get("peers_fetched") == [1]
          and summary0.get("peers_unreachable") == [],
          f"obs_hang_autopsy: summary {summary0}")
    check(peer_steps == [1, 2], f"obs_hang_autopsy: rank 1's flight was "
                                f"not fetched mid-stall: {peer_steps}")
    check(any(e.get("ph") == "M" for e in merged["traceEvents"]),
          "obs_hang_autopsy: empty merged trace")
    for x in res:
        ls = x["losses"]
        check(len(ls) == OBS_HANG_STEPS and all(map(math.isfinite, ls)),
              f"obs_hang_autopsy: rank {x['rank']} losses {ls}")
        for k in ("flash_attention_fwd", "xent_fwd", "quantize",
                  "dequantize"):
            check(x["launches"][k] > 0, f"obs_hang_autopsy: rank "
                                        f"{x['rank']} launches {k} 0")
    check(res[0]["digest"] == res[1]["digest"],
          "obs_hang_autopsy: the ranks' parameters differ after the stall")
    return res[0]["launches"]


def phase_hvdrun(torch, cfg, init_sd, batch, train_losses) -> dict:
    """[hvdrun]: the launcher runs the static trainer as an NCCL world of
    one. Returns the worker's launches."""
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_train_step)
    # is [train] bit-repeatable? its steps once more, in this process
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = init_opt_state(adamw, model)
    step = make_train_step(cfg)
    again = [float(step(model, opt, *batch)[2]) for _ in range(TRAIN_STEPS)]
    del model, opt, step
    repeatable = again == train_losses
    repo = os.path.dirname(os.path.abspath(__file__))
    launch = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]
    with tempfile.TemporaryDirectory(prefix="hvdrun_") as out, \
            FakeMetadata(POD_ENDPOINTS) as metadata:
        # the host comes from the metadata server, its one slot from the
        # card count
        env = dict(os.environ, PYTHONPATH=repo,
                   HVD_TPU_METADATA_ENDPOINT=metadata.endpoint)
        t0 = time.perf_counter()
        r = subprocess.run(
            launch + ["--tpu", sys.executable,
                      os.path.join(repo, "tests",
                                   "torch_port_elastic_worker.py"),
                      "static", "--out", out, "--steps", str(TRAIN_STEPS)],
            cwd=repo, env=env, capture_output=True, text=True,
            timeout=HVDRUN_TIMEOUT_S)
        secs = time.perf_counter() - t0
        served = metadata.served
        check(r.returncode == 0, f"hvdrun: the launch exited {r.returncode}"
                                 f":\n{r.stdout[-3000:]}{r.stderr[-3000:]}")
        with open(os.path.join(out, "static.rank0.json")) as f:
            res = json.load(f)
    fail = subprocess.run(
        launch + ["-np", "1", sys.executable, "-c", "import sys; sys.exit(3)"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120)
    losses = res["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, train_losses))
    held = "bit" if repeatable else f"rel {DP_LOSS_TOL}"
    n_layers = cfg.n_layers
    want = {"flash_attention_fwd": n_layers * TRAIN_STEPS,
            "xent_fwd": TRAIN_STEPS}
    say("hvdrun", seconds=secs, hosts="--tpu", pod_endpoints=POD_ENDPOINTS,
        metadata_reads=served, rank=res["rank"], size=res["size"],
        rendezvous=f"{res['rendezvous_addr']}:{res['rendezvous_port']}",
        generation=res["generation"], backend=res["backend"],
        losses=",".join(f"{x:.6f}" for x in losses),
        train_losses=",".join(f"{x:.6f}" for x in train_losses),
        train_repeatable=repeatable, held_to=held, max_rel=rel,
        launches=",".join(f"{k}:{v}" for k, v in res["launches"].items()),
        failing_worker_rc=fail.returncode)
    check(served.get("worker-network-endpoints", 0) >= 1,
          f"hvdrun: --tpu never read the metadata server: {served}")
    check((res["rank"], res["size"], res["hvd_rank"], res["hvd_size"])
          == ("0", "1", 0, 1), f"hvdrun: identity {res}")
    check(res["rendezvous_addr"] == res["gloo_rendezvous_addr"]
          == "127.0.0.1" and int(res["rendezvous_port"]) > 0,
          f"hvdrun: rendezvous {res}")
    check(res["generation"] is None and res["backend"] == "nccl",
          f"hvdrun: generation/backend {res}")
    check(losses == train_losses if repeatable else rel <= DP_LOSS_TOL,
          f"hvdrun: losses {losses} vs [train] {train_losses} ({held})")
    check(res["launches"] == want,
          f"hvdrun: launches {res['launches']}, expected {want}")
    check(fail.returncode == 3,
          f"hvdrun: a worker's exit 3 came back as {fail.returncode}")
    return res["launches"]


class FakeMetadata:
    """A GCE metadata server on localhost for ``hvdrun --tpu``: serves
    ``instance/attributes/worker-network-endpoints`` (only with the
    ``Metadata-Flavor: Google`` header, as the real one) and counts the
    reads of each attribute in ``served``."""

    def __init__(self, endpoints: str):
        import http.server
        import threading
        outer = self
        self.served = {}
        attrs = {"worker-network-endpoints": endpoints}
        base = "/computeMetadata/v1/instance/attributes/"

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                name = self.path[len(base):] \
                    if self.path.startswith(base) else None
                if self.headers.get("Metadata-Flavor") != "Google" or \
                        name not in attrs:
                    self.send_error(403 if name in attrs else 404)
                    return
                outer.served[name] = outer.served.get(name, 0) + 1
                body = attrs[name].encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                       Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self.endpoint = f"http://127.0.0.1:{self._server.server_address[1]}"

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()


def phase_nic_probe(card: str) -> str:
    """[nic_probe]: two task services started as ``python -m
    horovod_tpu_torch.runner.task_server --index i`` with the secret on
    stdin (``probe_coordinator_address``'s remote half, without the
    ``ssh``), probed through ``find_routable_interfaces``. Returns the
    address ``pick_rendezvous_address`` picked."""
    import secrets
    import threading
    import urllib.error

    from horovod_tpu_torch.runner.service import (TaskClient,
                                                  find_routable_interfaces,
                                                  get_local_addresses,
                                                  pick_rendezvous_address)
    repo = os.path.dirname(os.path.abspath(__file__))
    secret = secrets.token_bytes(16)
    env = dict(os.environ, PYTHONPATH=repo)
    env.pop("HVD_TPU_SERVICE_SECRET", None)
    t0 = time.perf_counter()
    procs, clients = [], []
    try:
        for i in range(2):
            p = subprocess.Popen(
                [sys.executable, "-m", "horovod_tpu_torch.runner.task_server",
                 "--index", str(i), "--ttl", "120"], cwd=repo, env=env,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            procs.append(p)
            p.stdin.write(secret.hex() + "\n")
            p.stdin.flush()
        for p in procs:
            box = []
            th = threading.Thread(target=lambda: box.append(
                p.stdout.readline()), daemon=True)
            th.start()
            th.join(NIC_PROBE_TIMEOUT_S)
            line = box[0] if box else ""
            check(line.startswith("HVD_TASK_PORT="),
                  f"nic_probe: a task server printed {line!r}")
            clients.append(TaskClient("127.0.0.1",
                                      int(line.strip().split("=")[1]),
                                      secret))
        local = get_local_addresses()
        tables = [c.addresses() for c in clients]
        probes = [clients[i].probe("127.0.0.1", clients[1 - i].port)
                  for i in range(2)]
        evil = TaskClient("127.0.0.1", clients[0].port, b"x" * 16)
        try:
            evil.addresses()
            refused = None
        except urllib.error.HTTPError as e:
            refused = e.code
        routable = find_routable_interfaces(clients)
        pick = pick_rendezvous_address(routable)
        secs = time.perf_counter() - t0
    finally:
        for c in clients:
            c.shutdown()
        for p in procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    others = sorted(ip for ip in local.values() if not ip.startswith("127."))
    say("nic_probe", services=2, interfaces=json.dumps(local).replace(
        " ", ""), routable=json.dumps(routable).replace(" ", ""), pick=pick,
        probes=probes, wrong_secret_http=refused, seconds=secs, card=card,
        exit_codes=[p.returncode for p in procs])
    check(all(t == local for t in tables),
          f"nic_probe: the services' interfaces {tables} are not {local}")
    check(probes == [True, True], f"nic_probe: probes {probes}")
    check(refused == 403, f"nic_probe: a wrong secret got {refused}")
    check(pick in local.values(), f"nic_probe: {pick} is not local {local}")
    check(not others or not pick.startswith("127."),
          f"nic_probe: picked loopback {pick} though {others} exist")
    check([p.returncode for p in procs] == [0, 0],
          "nic_probe: a task server did not exit 0 on shutdown")
    return pick


def phase_agent_elastic(torch, cfg, card: str, host: str) -> dict:
    """[agent_elastic]: ``run_agent_elastic`` over three host agents that
    ``start_local_agents`` starts as processes of this host, registered
    under ``host`` (the NIC probe's pick, where the world rendezvouses);
    the payload is the elastic trainer of the flagship at full width and
    depth on ``cuda:0``. After its commit of step ELASTIC_KILL[1], rank
    ELASTIC_KILL[0] SIGKILLs its process group: its agent dies with it,
    the heartbeat expires, the world shrinks to two, the respawned agent
    registers and the world grows back to three. Returns each final
    rank's launches."""
    import threading

    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.models import Transformer, adamw, make_train_step
    from horovod_tpu_torch.runner.elastic import agent
    kill_rank, kill_step = ELASTIC_KILL
    with tempfile.TemporaryDirectory(prefix="agent_") as out:
        argv = ["--out", out, "--device", "cuda:0", "--steps", ELASTIC_STEPS,
                "--rows", ELASTIC_ROWS, "--kill-group",
                f"{kill_rank}:{kill_step}", "--save-commit", kill_step,
                "--until-size", 3]

        def shrunk() -> bool:
            return os.path.exists(os.path.join(out, "events.jsonl")) and \
                any(e["kind"] == "step" and e["size"] == 2
                    for e in worker.events(out))

        stats, box = {}, {}

        def run():
            try:
                box["results"] = agent.run_agent_elastic(
                    lambda ctx: worker.start_local_agents(
                        ctx, 3, host=host, hold=lambda: not shrunk(),
                        stats=stats),
                    worker.agent_payload, args=(argv,), num_proc=3,
                    min_np=2, max_np=3, reset_limit=3,
                    env={"HOROVOD_TPU_OPERATIONS": "GLOO",
                         "OMP_NUM_THREADS": "1",
                         "HVD_TPU_GLOO_TIMEOUT_SECONDS":
                         str(ELASTIC_GLOO_TIMEOUT_S),
                         "HVD_ELASTIC_SHRINK_WAIT_S": "60"})
            except Exception as e:   # raised again below, on this thread
                box["error"] = e

        t0 = time.perf_counter()
        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(AGENT_TIMEOUT_S)
        secs = time.perf_counter() - t0
        if th.is_alive():
            for pgid in stats.get("pgids", []):
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(pgid, signal.SIGKILL)
            th.join(30)
        evs = worker.events(out)
        check(not th.is_alive() and "error" not in box,
              f"agent_elastic: the run {box.get('error', 'timed out')}: "
              f"{_evsum(evs)}")
        results = box["results"]
        snap = torch.load(os.path.join(out, "commit.pt"),
                          map_location="cuda:0", weights_only=False)
        healed_grads = torch.load(os.path.join(out, "grads_healed.rank0.pt"))
    boots = [e for e in evs if e["kind"] == "boot"]
    kill = [e for e in evs if e["kind"] == "kill"]
    steps = [e for e in evs if e["kind"] == "step"]
    check(len(kill) == 1 and kill[0]["rank"] == kill_rank
          and kill[0].get("group"), f"agent_elastic: kills {kill}")
    first = {b["rank"]: b["pid"] for b in boots[:3]}
    check(len(boots) == 4 and sorted(first) == [0, 1, 2]
          and boots[3]["rank"] == kill_rank,
          f"agent_elastic: boots {_evsum(evs)}")
    check([r["rank"] for r in results] == [0, 1, 2]
          and all(r["size"] == 3 for r in results),
          f"agent_elastic: results {[(r['rank'], r['size']) for r in results]}")
    survivors = [r for r in range(3) if r != kill_rank]
    check(all(results[r]["pid"] == first[r] for r in survivors)
          and results[kill_rank]["pid"] == boots[3]["pid"],
          "agent_elastic: a survivor was restarted, or the grown rank is "
          "not the new process")
    digests = {r["digest"] for r in results}
    check(len(digests) == 1, f"agent_elastic: replicas differ {digests}")
    healed = [e for e in steps if e["step"] == kill_step + 1]
    check(len(healed) == 2 and all(e["size"] == 2 for e in healed)
          and len({e["loss"] for e in healed}) == 1,
          f"agent_elastic: first healed step {healed}")
    rows = healed[0]["rows"]
    n = 3 * ELASTIC_ROWS * ELASTIC_STEPS * 4
    tokens, targets = worker.corpus(cfg, n)
    dev = torch.device("cuda", 0)
    model = Transformer(cfg)
    model.load_state_dict(snap["torch_snaps"]["model"])
    opt = adamw(model.parameters())
    opt.load_state_dict(snap["torch_snaps"]["optimizer"])
    ref_loss = float(make_train_step(cfg)(
        model, opt, torch.from_numpy(tokens[rows]).to(dev),
        torch.from_numpy(targets[rows]).to(dev))[2])
    ref_grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
    del model, opt, snap
    errs = grad_errors(healed_grads, ref_grads)
    worst = max(errs, key=lambda k: errs[k][0])
    loss_rel = abs(healed[0]["loss"] - ref_loss) / abs(ref_loss)
    t_kill = kill[0]["t"]
    grown = [e for e in steps if e["size"] == 3 and e["step"] > kill_step]
    shrink = {r: ep for r in survivors for ep in
              results[r]["chaos"]["episodes"]
              if ep["trigger"] == "internal_error"}
    grow = {r: ep for r in survivors for ep in
            results[r]["chaos"]["episodes"]
            if ep["trigger"] == "hosts_updated"}
    launches = {r["rank"]: r["launches"] for r in results}
    say("agent_elastic", seconds=secs, card=card, host=host, world=3,
        kill=f"rank {kill_rank} and its agent after step {kill_step}",
        heartbeat_expiry_s=stats["stale_at"] - t_kill, stale_s=agent.STALE_S,
        kill_to_first_healed_step_s=min(e["t"] for e in healed) - t_kill,
        **{f"rank{r}_shrink_{ph}_s": ep.get(f"{ph}_s")
           for r, ep in shrink.items() for ph in REMESH_PHASES},
        respawn_after_kill_s=stats["respawned_at"] - t_kill,
        kill_to_first_grown_step_s=(min(e["t"] for e in grown) - t_kill
                                    if grown else None),
        **{f"rank{r}_grow_{ph}_s": ep.get(f"{ph}_s")
           for r, ep in grow.items() for ph in REMESH_PHASES},
        healed_loss=healed[0]["loss"], one_process_loss=ref_loss,
        loss_rel=loss_rel, tol_loss=DP_LOSS_TOL, worst_grad=worst,
        grad_rel_l2=errs[worst][0], tol_grad=DP_GRAD_TOL,
        sizes=",".join(f"{e['step']}:{e['size']}" for e in steps
                       if e["rank"] == 0),
        launches=";".join(f"{r}:{v['flash_attention_fwd']},"
                          f"{v['xent_fwd']}" for r, v in launches.items()))
    check(sorted(shrink) == survivors and sorted(grow) == survivors,
          f"agent_elastic: re-mesh episodes {shrink} {grow}")
    check(loss_rel <= DP_LOSS_TOL, f"agent_elastic: healed loss "
                                   f"{healed[0]['loss']} vs {ref_loss}")
    check(errs[worst][0] <= DP_GRAD_TOL, f"agent_elastic: gradient of "
                                         f"{worst} {errs[worst][0]} off")
    for r, got in launches.items():
        check(got["flash_attention_fwd"] > 0 and got["xent_fwd"] > 0,
              f"agent_elastic: a kernel did not run on rank {r}: {got}")
    return launches


def phase_elastic_recover(torch, cfg, card: str) -> dict:
    """[elastic_recover]: three gloo ranks under the port's driver lose
    one and heal in place. Returns each final rank's launches."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.models import Transformer, adamw, make_train_step
    from horovod_tpu_torch.runner.elastic import journal
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.hosts import HostInfo
    kill_rank, kill_step = ELASTIC_KILL
    with tempfile.TemporaryDirectory(prefix="elastic_") as out:
        cmd = worker.command(out, "--device", "cuda:0", "--steps",
                             ELASTIC_STEPS, "--rows", ELASTIC_ROWS,
                             "--kill", f"{kill_rank}:{kill_step}",
                             "--save-commit", kill_step)
        rc, driver, secs = worker.run_driver(
            FixedHosts([HostInfo("localhost", 3)]), cmd, out, min_np=2,
            max_np=3, reset_limit=3, timeout=ELASTIC_TIMEOUT_S,
            env={"HVD_TPU_GLOO_TIMEOUT_SECONDS":
                 str(ELASTIC_GLOO_TIMEOUT_S)})
        evs = worker.events(out)
        check(rc == 0, f"elastic_recover: the driver returned {rc}: {evs}")
        jstate = journal.load(os.path.join(out, "journal",
                                           journal.JOURNAL_NAME))
        snap = torch.load(os.path.join(out, "commit.pt"), map_location="cuda:0",
                          weights_only=False)
        healed_grads = torch.load(os.path.join(out, "grads_healed.rank0.pt"))
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    steps = [e for e in evs if e["kind"] == "step"]
    kill = [e for e in evs if e["kind"] == "kill"]
    check(len(kill) == 1 and kill[0]["rank"] == kill_rank,
          f"elastic_recover: kills {kill}")
    check(sorted(b["rank"] for b in boots) == [0, 1, 2, kill_rank],
          f"elastic_recover: boots {boots}")
    first_pid = {b["rank"]: b["pid"] for b in boots}
    survivors = [r for r in range(3) if r != kill_rank]
    replacement = [b for b in boots if b["rank"] == kill_rank][-1]
    check(sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 and d["step"] == ELASTIC_STEPS
        for d in dones.values()), f"elastic_recover: ends {dones}")
    for r in survivors:
        check(dones[r]["pid"] == first_pid[r],
              f"elastic_recover: rank {r} was restarted")
        rm = dones[r]["remesh"]
        check(rm["total"] >= 1 and set(rm["phases"]) >= set(REMESH_PHASES),
              f"elastic_recover: rank {r}'s re-mesh record {rm}")
    check(dones[kill_rank]["pid"] == replacement["pid"]
          and dones[kill_rank]["remesh"] == {"total": 0, "phases": {}},
          f"elastic_recover: the replacement {dones[kill_rank]}")
    digests = {d["digest"] for d in dones.values()}
    check(len(digests) == 1, f"elastic_recover: replicas differ {digests}")
    # the healed world's first step against one process from the commit
    healed = [e for e in steps if e["step"] == kill_step + 1]
    check(len(healed) == 3 and len({e["loss"] for e in healed}) == 1,
          f"elastic_recover: first healed step {healed}")
    rows = healed[0]["rows"]
    n = 3 * ELASTIC_ROWS * ELASTIC_STEPS
    tokens, targets = worker.corpus(cfg, n)
    dev = torch.device("cuda", 0)
    model = Transformer(cfg)
    model.load_state_dict(snap["torch_snaps"]["model"])
    opt = adamw(model.parameters())
    opt.load_state_dict(snap["torch_snaps"]["optimizer"])
    ref_loss = float(make_train_step(cfg)(
        model, opt, torch.from_numpy(tokens[rows]).to(dev),
        torch.from_numpy(targets[rows]).to(dev))[2])
    ref_grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
    del model, opt, snap
    errs = grad_errors(healed_grads, ref_grads)
    worst = max(errs, key=lambda k: errs[k][0])
    loss_rel = abs(healed[0]["loss"] - ref_loss) / abs(ref_loss)
    t_first = min(e["t"] for e in healed)
    phases = {r: dones[r]["remesh"]["phases"] for r in survivors}
    launches = {r: dones[r]["launches"] for r in sorted(dones)}
    say("elastic_recover", seconds=secs, card=card, world=3,
        kill=f"rank {kill_rank} after step {kill_step}",
        kill_to_first_healed_step_s=t_first - kill[0]["t"],
        **{f"rank{r}_{ph}_s": v for r, ps in phases.items()
           for ph, v in sorted(ps.items())},
        healed_loss=healed[0]["loss"], one_process_loss=ref_loss,
        loss_rel=loss_rel, tol_loss=DP_LOSS_TOL, worst_grad=worst,
        grad_rel_l2=errs[worst][0], tol_grad=DP_GRAD_TOL,
        losses=",".join(f"{e['step']}:{e['loss']:.6f}" for e in steps
                        if e["rank"] == 0),
        launches=";".join(f"{r}:{v['flash_attention_fwd']},"
                          f"{v['xent_fwd']}" for r, v in launches.items()),
        journal_world_gen=jstate.world_gen,
        final_generation=driver.final_generation)
    check(loss_rel <= DP_LOSS_TOL, f"elastic_recover: healed loss "
                                   f"{healed[0]['loss']} vs {ref_loss}")
    check(errs[worst][0] <= DP_GRAD_TOL, f"elastic_recover: gradient of "
                                         f"{worst} {errs[worst][0]} off")
    exits = {k: r["state"] for k, r in jstate.exits.items()}
    check(jstate.clean_exit == 0 and jstate.unknown == 0
          and jstate.world_gen == driver.final_generation
          and jstate.reset_count == driver._registry.reset_count
          and not jstate.live_workers() and jstate.blocklist == {}
          and exits.get((0, kill_rank)) == "FAILURE"
          and jstate.world["doc"]["size"] == 3,
          f"elastic_recover: the journal's replay {jstate.__dict__} does "
          f"not match the driver")
    for r, got in launches.items():
        check(got["flash_attention_fwd"] > 0 and got["xent_fwd"] > 0,
              f"elastic_recover: a kernel did not run on rank {r}: {got}")
    return launches


def _per_forward(label: str, launches: dict, n_layers: int,
                 min_forwards: dict) -> None:
    """Every rank launched ``flash_attn_fwd`` n_layers times and
    ``xent_fwd`` once a forward, at least ``min_forwards[rank]`` times."""
    for r, got in launches.items():
        f, x = got["flash_attention_fwd"], got["xent_fwd"]
        check(x >= min_forwards.get(r, 1) and f == n_layers * x,
              f"{label}: rank {r} launched flash {f} and xent {x} "
              f"(n_layers {n_layers}, at least {min_forwards.get(r, 1)} "
              f"forwards)")


def _elastic_chaos_run(worker, out: str, label: str, extra, env) -> tuple:
    """One driver run of the elastic trainer on ``cuda:0`` (three one-slot
    ranks of ``localhost``); fails ``label`` unless the driver returned 0.
    Returns the events, the driver and its seconds."""
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.hosts import HostInfo
    cmd = worker.command(out, "--device", "cuda:0", "--rows", ELASTIC_ROWS,
                         *extra)
    rc, driver, secs = worker.run_driver(
        FixedHosts([HostInfo("localhost", 3)]), cmd, out, min_np=2,
        max_np=3, reset_limit=4, timeout=CHAOS_TIMEOUT_S,
        env=dict({"HVD_TPU_GLOO_TIMEOUT_SECONDS":
                  str(ELASTIC_GLOO_TIMEOUT_S)}, **env))
    evs = worker.events(out)
    check(rc == 0, f"{label}: the driver returned {rc}: {evs[-20:]}")
    return evs, driver, secs


def _evsum(evs) -> str:
    """The trainer's events in brief (kind, rank, pid, step, generation,
    seconds from the first), for a failed check's message."""
    t0 = evs[0]["t"] if evs else 0.0
    return "; ".join(
        f"{e['kind']} r{e.get('rank')} p{e['pid']} s{e.get('step')} "
        f"g{e.get('generation')} +{e['t'] - t0:.2f}"
        for e in evs if e["kind"] != "tick")[-6000:]


def _first_t(label: str, evs, what: str, pred) -> float:
    """The time of the first event ``pred`` takes, or a failed check."""
    ts = [e["t"] for e in evs if pred(e)]
    check(bool(ts), f"{label}: no {what}: {_evsum(evs)}")
    return min(ts)


def _healed_after(label: str, evs, dones, first: dict, trigger: str):
    """When the last survivor's re-mesh of ``trigger`` ended (its flight
    record: the healed world's first step done), and when the slot's new
    process completed its first step."""
    survivors = {d["pid"] for d in dones.values()} & set(first.values())
    ends = [ep["ts"] for d in dones.values() if d["pid"] in survivors
            for ep in d["chaos"]["episodes"] if ep["trigger"] == trigger]
    check(len(ends) >= 2, f"{label}: {trigger} episodes {ends}: "
                          f"{_evsum(evs)}")
    full = _first_t(label, evs, "step of the re-admitted process",
                    lambda e: e["kind"] == "step"
                    and e["pid"] not in set(first.values()))
    return max(ends), full


def _first_pids(evs) -> dict:
    return {b["rank"]: b["pid"] for b in evs
            if b["kind"] == "boot" and b["generation"] == "0"}


def _episode_phases(dones, trigger: str) -> dict:
    """``{rank: {phase: s}}`` of each done rank's episodes of ``trigger``."""
    out = {}
    for r, d in dones.items():
        for ep in d["chaos"]["episodes"]:
            if ep["trigger"] == trigger:
                out[r] = {k[:-2]: ep[k] for k in ep
                          if k.endswith("_s") and ep[k] is not None}
    return out


def phase_chaos_soak(torch, card: str) -> dict:
    """[chaos_soak]: the module docstring's compound plan over three
    elastic gloo ranks at full width and depth. Returns each final rank's
    launches."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.runner.elastic import journal
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chaos_soak_") as out:
        evs, driver, secs = _elastic_chaos_run(
            worker, out, "chaos_soak",
            ["--steps", CHAOS_STEPS, "--guard", "--ckpt-every", 2],
            {"HVD_TPU_FAULT_PLAN": json.dumps(worker.soak_plan(out))})
        jstate = journal.load(os.path.join(out, "journal",
                                           journal.JOURNAL_NAME))
        latest = ShardedCheckpointer(os.path.join(out, "model_ckpt"),
                                     rank=0, world_size=1).latest_step()
    first = _first_pids(evs)
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    skips = [e for e in evs if e["kind"] == "guard_skip"]
    ckpts = [(e["step"], e["ok"]) for e in evs if e["kind"] == "ckpt"]
    check(sorted(first) == [0, 1, 2] and len(boots) == 4,
          f"chaos_soak: boots {boots}")
    check(sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 and d["step"] == CHAOS_STEPS
        for d in dones.values()), f"chaos_soak: ends {dones}")
    killed = set(first.values()) - {d["pid"] for d in dones.values()}
    check(killed == {first[1]}, f"chaos_soak: killed {killed}, first "
                                f"{first}, ends {dones}")
    ticks = [e for e in evs if e["kind"] == "tick" and e["pid"] in killed]
    check(ticks[-1]["step"] == 3, f"chaos_soak: rank 1 died after step "
                                  f"{ticks[-1]['step']}")
    check(sorted(e["rank"] for e in skips) == [0, 1, 2] and all(
        e["step"] == 3 and e["expected"] and e["same_state"] for e in skips),
        f"chaos_soak: guard skips {skips}")
    check(ckpts == [(2, False), (4, True), (6, True)] and latest == 6,
          f"chaos_soak: saves {ckpts}, latest commit {latest}")
    injected = {}
    for r, d in dones.items():
        # the plan's schedule, per process: the blackout's two requests
        # each time it armed the plan (a survivor renumbered in the heal
        # arms again), the NaN once a rank (the {rank} markers keep it
        # off the replacement), the write error on rank 0
        want = {"kv.request/blackout": 2 * d["chaos"]["armed"]}
        if d["pid"] in first.values():
            want["grad/nan"] = 1
        if r == 0:
            want["checkpoint.write/io_error"] = 1
        injected[r] = d["chaos"]["injected"]
        check(injected[r] == want, f"chaos_soak: rank {r} injected "
                                   f"{injected[r]}, the plan says {want}")
    digests = {d["digest"] for d in dones.values()}
    check(len(digests) == 1, f"chaos_soak: replicas differ {digests}")
    exits = sorted(r["state"] for r in jstate.exits.values())
    check(jstate.clean_exit == 0 and jstate.unknown == 0
          and jstate.world_gen == driver.final_generation
          and jstate.reset_count == driver._registry.reset_count
          and not jstate.live_workers() and jstate.blocklist == {}
          and exits.count("FAILURE") == 1 and set(exits) == {
              "FAILURE", "SUCCESS"} and jstate.world["doc"]["size"] == 3,
          f"chaos_soak: the journal's replay {jstate.__dict__} does not "
          f"match the driver")
    t_kill = ticks[-1]["t"]
    healed = [e for e in evs if e["kind"] == "step" and e["step"] == 4]
    check(len(healed) == 3, f"chaos_soak: healed steps {healed}")
    launches = {r: d["launches"] for r, d in sorted(dones.items())}
    _per_forward("chaos_soak", launches, 4,
                 {r: (3 if d["pid"] not in first.values() else CHAOS_STEPS)
                  for r, d in dones.items()})
    phases = _episode_phases(dones, "internal_error")
    say("chaos_soak", seconds=secs, card=card, world=3,
        width="V32000 M512 H8x64 L4 F2048 S256", rows_a_rank=ELASTIC_ROWS,
        faults="grad/nan@3,checkpoint.write/io_error,kv.request/blackout,"
               "step/kill rank1@3",
        injected=json.dumps(injected, sort_keys=True),
        guard_skips_bit_equal=len(skips), saves=ckpts,
        kill_to_first_healed_step_s=min(e["t"] for e in healed) - t_kill,
        **{f"rank{r}_{ph}_s": v for r, ps in sorted(phases.items())
           for ph, v in sorted(ps.items())
           if ph in REMESH_PHASES},
        launches=";".join(f"{r}:{v['flash_attention_fwd']},"
                          f"{v['xent_fwd']}" for r, v in launches.items()),
        journal_world_gen=jstate.world_gen,
        phase_s=time.perf_counter() - t_phase)
    return launches


def _concurrently(*fns) -> list:
    """Run ``fns`` side by side on threads; their results, in order. The
    first failure is raised once every one has ended."""
    import threading
    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:   # raised on the caller's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def phase_preempt_drain(torch, card: str) -> tuple:
    """[preempt_drain]: a planned drain against a reactive kill at the same
    step (the first commit), the flagship at depth CHAOS_LAYERS, the two
    runs side by side on the card. Returns each run's final ranks'
    launches and the seconds from the drain run's start to its first
    step."""
    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.diagnostics.flight_recorder import recorder
    from horovod_tpu_torch.runner.elastic import journal
    t_phase = time.perf_counter()
    t_wall = time.time()
    depth = ["--layers", CHAOS_LAYERS, "--steps", DRAIN_STEPS, "--sleep", 0.1]

    def run(prefix, plan, extra, env):
        with tempfile.TemporaryDirectory(prefix=prefix) as out:
            plan = json.loads(json.dumps(plan).replace("OUT", out))
            evs, _driver, secs = _elastic_chaos_run(
                worker, out, f"preempt_drain ({prefix[:-1]})", depth + extra,
                dict(env, HVD_TPU_FAULT_PLAN=json.dumps(plan)))
            return evs, secs, journal.load(os.path.join(
                out, "journal", journal.JOURNAL_NAME))

    # the notice fires at the watcher's first poll and the driver plans
    # the drain once every listener registered (the first commit); the
    # kill comes after that same commit
    notice = {"faults": [{"seam": "preemption", "kind": "notice",
                          "rank": 2, "marker": "OUT/noticed_{rank}"}]}
    kill = {"faults": [{"seam": "step", "kind": "kill", "rank": 2,
                        "start": 1, "stop": 2,
                        "marker": "OUT/killed_{rank}"}]}
    with environ(HVD_TPU_DRAIN_COOLDOWN_S=DRAIN_COOLDOWN_S):
        (evs, secs, jstate), (evs2, secs2, jstate2) = _concurrently(
            lambda: run("drain_", notice, ["--until-size", 3,
                                           "--min-generation", 2],
                        {"HVD_TPU_PREEMPTION_POLL_S": str(DRAIN_POLL_S)}),
            lambda: run("kill_", kill, [], {}))
    handled = [e["ts"] for e in recorder().events()
               if e["kind"] == "drain_notice_handled" and e["ts"] > t_wall]
    first = _first_pids(evs)
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    notices = [e for e in evs if e["kind"] == "drain_notice"]
    exits = sorted(r["state"] for r in jstate.exits.values())
    check(len(notices) == 1 and notices[0]["pid"] == first[2]
          and notices[0]["counted"] == 1 and len(handled) == 1,
          f"preempt_drain: notices {notices}, handled {handled}")
    check("DRAINED" in exits and "FAILURE" not in exits
          and jstate.blocklist == {}, f"preempt_drain: exits {exits}, "
                                      f"blocklist {jstate.blocklist}")
    check(len(boots) == 4 and sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 for d in dones.values()) and first[2] not in {
        d["pid"] for d in dones.values()}, f"preempt_drain: boots {boots}, "
                                           f"ends {dones}")
    planned = _episode_phases({r: dones[r] for r in dones
                               if dones[r]["pid"] in first.values()},
                              "preemption_drain")
    check(len(planned) == 2 and all(
        p.get("failure_detect", 0.0) <= DRAIN_DETECT_MAX_S
        for p in planned.values()), f"preempt_drain: planned episodes "
                                    f"{planned}")
    readmit = [b for b in boots if b["pid"] not in first.values()][0]
    check(readmit["t"] - handled[0] >= DRAIN_COOLDOWN_S,
          f"preempt_drain: the slot came back {readmit['t'] - handled[0]} s "
          f"after the drain, inside the {DRAIN_COOLDOWN_S} s cooldown")
    healed, full = _healed_after("preempt_drain", evs, dones, first,
                                 "preemption_drain")
    drained_steps = [e["step"] for e in evs if e["kind"] == "step"
                     and e["pid"] == first[2]]
    first2 = _first_pids(evs2)
    dones2 = {e["rank"]: e for e in evs2 if e["kind"] == "done"}
    exits2 = sorted(r["state"] for r in jstate2.exits.values())
    check("FAILURE" in exits2 and sorted(dones2) == [0, 1, 2],
          f"preempt_drain (kill): exits {exits2}, ends {dones2}")
    killed = [e for e in evs2 if e["kind"] == "tick"
              and e["pid"] == first2[2]]
    check(killed and killed[-1]["step"] == 1, f"preempt_drain (kill): "
                                              f"{_evsum(evs2)}")
    healed2, _full2 = _healed_after("preempt_drain (kill)", evs2, dones2,
                                    first2, "internal_error")
    reactive = _episode_phases({r: dones2[r] for r in dones2
                                if dones2[r]["pid"] in first2.values()},
                               "internal_error")
    launches = {"drain": {r: d["launches"] for r, d in sorted(dones.items())},
                "kill": {r: d["launches"] for r, d in sorted(dones2.items())}}
    for label, got in launches.items():
        _per_forward(f"preempt_drain ({label})", got, CHAOS_LAYERS, {})
    boot_s = _first_t("preempt_drain", evs, "step",
                      lambda e: e["kind"] == "step") - t_wall
    say("preempt_drain", card=card, world=3, depth=CHAOS_LAYERS,
        width="V32000 M512 H8x64 F2048 S256", runs="side by side",
        drain_seconds=secs, kill_seconds=secs2, exits=",".join(exits),
        drained_after_steps=",".join(map(str, drained_steps)),
        notice_to_handled_s=handled[0] - notices[0]["at"],
        handled_to_healed_s=healed - handled[0],
        handled_to_readmitted_step_s=full - handled[0],
        kill_to_healed_s=healed2 - killed[-1]["t"],
        **{f"drain_rank{r}_{ph}_s": v for r, ps in sorted(planned.items())
           for ph, v in sorted(ps.items()) if ph in REMESH_PHASES},
        **{f"kill_rank{r}_{ph}_s": v for r, ps in sorted(reactive.items())
           for ph, v in sorted(ps.items()) if ph in REMESH_PHASES},
        phase_s=time.perf_counter() - t_phase)
    return launches, boot_s


def phase_driver_chaos(torch, card: str, boot_s: float) -> dict:
    """[driver_chaos]: the launcher's supervised driver killed by the chaos
    ``driver`` seam at a poll tick a quarter plus six seconds past the
    workers' boot (``boot_s``, [preempt_drain]'s at the same depth: a host
    that boots slowly boots slowly in both). Returns each rank's
    launches."""
    import datetime

    import torch_port_elastic_worker as worker

    from horovod_tpu_torch.runner.elastic import journal
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    tick = int(math.ceil((1.25 * boot_s + 6.0) / 0.25))
    with tempfile.TemporaryDirectory(prefix="driver_chaos_") as out:
        marker = os.path.join(out, "driver_killed")
        plan = {"seed": 7, "faults": [{"seam": "driver", "kind": "kill",
                                       "start": tick, "stop": tick + 1,
                                       "marker": marker}]}
        jdir = os.path.join(out, "journal")
        env = dict(os.environ, PYTHONPATH=repo,
                   HVD_TPU_FAULT_PLAN=json.dumps(plan),
                   HVD_TPU_DRIVER_OUTAGE_GRACE_S="120",
                   HVD_ELASTIC_CKPT=os.path.join(out, "ckpt"),
                   HOROVOD_TPU_OPERATIONS="GLOO", OMP_NUM_THREADS="1",
                   HVD_TPU_GLOO_TIMEOUT_SECONDS=str(ELASTIC_GLOO_TIMEOUT_S))
        cmd = [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
               "-H", "localhost:3", "--min-np", "3", "-np", "3",
               "--driver-journal-dir", jdir, "--"] + worker.command(
            out, "--device", "cuda:0", "--layers", CHAOS_LAYERS, "--steps",
            DRIVER_CHAOS_STEPS, "--rows", ELASTIC_ROWS, "--sleep", 0.25,
            "--outage-autopsy", "--until-marker",
            f"{marker}:{DRIVER_CHAOS_AFTER}")
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=CHAOS_TIMEOUT_S, cwd=repo)
        evs = worker.events(out)
        check(r.returncode == 0, f"driver_chaos: the launcher exited "
                                 f"{r.returncode}:\n{r.stderr[-4000:]}")
        t_kill = os.path.getmtime(marker) if os.path.exists(marker) \
            else None
        jstate = journal.load(os.path.join(jdir, journal.JOURNAL_NAME))
    took = [line for line in r.stderr.splitlines()
            if "driver takeover complete" in line]
    check(t_kill is not None and took and
          "respawning into journal takeover" in r.stderr
          and jstate.takeovers and jstate.clean_exit == 0,
          f"driver_chaos: no takeover ({t_kill}, {jstate.takeovers}):\n"
          f"{r.stderr[-3000:]}")
    t_took = datetime.datetime.strptime(
        took[0][1:24], "%Y-%m-%d %H:%M:%S,%f").timestamp()
    first = _first_pids(evs)
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    steps = [e for e in evs if e["kind"] == "step"]
    check(len(boots) == 3 and sorted(dones) == [0, 1, 2] and all(
        d["pid"] == first[rk] and d["size"] == 3
        and d["step"] >= DRIVER_CHAOS_STEPS
        and d["remesh"] == {"total": 0, "phases": {}}
        for rk, d in dones.items()), f"driver_chaos: boots {boots}, "
                                     f"ends {dones}")
    for rk in range(3):
        seq = [e["step"] for e in steps if e["rank"] == rk]
        check(seq == list(range(1, dones[rk]["step"] + 1)),
              f"driver_chaos: rank {rk}'s steps {seq}")
    # training began at the first step's tick: its step event comes after
    # that step's commit, which a kill in the step makes wait on the KV
    began = _first_t("driver_chaos", evs, "tick",
                     lambda e: e["kind"] == "tick")
    check(began < t_kill < max(e["t"] for e in steps),
          f"driver_chaos: the kill at tick {tick} fell outside training: "
          f"{t_kill - began} s after the first step began: {_evsum(evs)}")
    autopsies = [e for e in evs if e["kind"] == "outage_autopsy"]
    check(autopsies and all(a["driver_outage"] is not None
                            for a in autopsies),
          f"driver_chaos: outage autopsies {autopsies}")
    launches = {rk: d["launches"] for rk, d in sorted(dones.items())}
    _per_forward("driver_chaos", launches, CHAOS_LAYERS,
                 {rk: DRIVER_CHAOS_STEPS for rk in dones})
    during = [e["step"] for e in steps if t_kill < e["t"] < t_took]
    say("driver_chaos", card=card, world=3, depth=CHAOS_LAYERS,
        kill_tick=tick, kill_to_takeover_s=t_took - t_kill,
        steps_during_outage=len(during), remesh=0,
        outage_autopsies=len(autopsies),
        driver_outage=json.dumps(autopsies[0]["driver_outage"]),
        launches=";".join(f"{rk}:{v['flash_attention_fwd']},"
                          f"{v['xent_fwd']}" for rk, v in launches.items()),
        phase_s=time.perf_counter() - t_phase)
    return launches


def phase_autopilot_straggler(torch, card: str) -> dict:
    """[autopilot_straggler]: the fleet tree's straggler finding acted on
    by the autopilot under ``act``. Returns each final rank's launches."""
    import glob

    import torch_port_elastic_worker as worker
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="straggler_") as out:
        base, held = reserve_ports(3)
        obs = os.path.join(out, "obs")
        plan = {"faults": [{"seam": "step", "kind": "stall", "rank": 2,
                            "start": 1, "stop": 6, "stall_s": 1.2}]}
        try:
            with environ(HVD_TPU_DRAIN_COOLDOWN_S=DRAIN_COOLDOWN_S):
                evs, _driver, secs = _elastic_chaos_run(
                    worker, out, "autopilot_straggler",
                    ["--layers", CHAOS_LAYERS, "--steps", STRAGGLER_STEPS,
                     "--local", "--sleep", 0.05, "--until-size", 3,
                     "--min-generation", 2],
                    {"HVD_TPU_FAULT_PLAN": json.dumps(plan),
                     "HVD_TPU_AUTOPILOT": "act", "HVD_TPU_OBS_DIR": obs,
                     "HVD_TPU_METRICS_PORT": str(base),
                     "HVD_TPU_FLEET_PUSH_SECONDS": "0.4",
                     "HVD_TPU_ANOMALY_STRAGGLER_WINDOWS": "2",
                     "HVD_TPU_PROFILE_ON_ANOMALY": "0",
                     # unsynchronized ranks end a few steps apart
                     "HVD_TPU_SHUTDOWN_GRACE_S": "2"})
        finally:
            for sock in held:
                sock.close()
        decisions = []
        for f in sorted(glob.glob(os.path.join(obs, "actions_rank*.jsonl"))):
            with open(f) as fh:
                decisions += [json.loads(line) for line in fh]
        # the CLI's own entry point (python -m horovod_tpu_torch.metrics)
        import io
        from contextlib import redirect_stdout

        from horovod_tpu_torch.metrics.__main__ import main as metrics_main
        buf = io.StringIO()
        with redirect_stdout(buf):
            hist_rc = metrics_main(["history", "--actions", "--dir", obs])
        hist_out = buf.getvalue()
    first = _first_pids(evs)
    boots = [e for e in evs if e["kind"] == "boot"]
    dones = {e["rank"]: e for e in evs if e["kind"] == "done"}
    fired = [d for d in decisions if d["policy"] == "straggler-drain"
             and d["outcome"] == "fired"]
    check(len(fired) == 1 and fired[0]["target_rank"] == 2
          and fired[0]["rank"] == 0, f"autopilot_straggler: decisions "
          f"{decisions}; rank 0's findings "
          f"{dones.get(0, {}).get('chaos', {}).get('findings')}")
    counted = dones[0]["chaos"]["autopilot"].get(
        'hvd_autopilot_decisions_total{outcome="fired",'
        'policy="straggler-drain"}')
    rows = [line for line in hist_out.splitlines()
            if "straggler-drain" in line and "fired" in line]
    check(hist_rc == 0 and len(rows) == 1 and counted == 1.0,
          f"autopilot_straggler: history --actions {hist_out[-2000:]}, "
          f"counter {counted}")
    check(len(boots) == 4 and sorted(dones) == [0, 1, 2] and all(
        d["size"] == 3 for d in dones.values()) and first[2] not in {
        d["pid"] for d in dones.values()}, f"autopilot_straggler: boots "
                                           f"{boots}, ends {dones}")
    finding = [f for f in dones[0]["chaos"]["findings"]
               if f["kind"] == "persistent_straggler"
               and f["trace"] == fired[0].get("trace")]
    check(len(finding) == 1 and finding[0]["rank"] == 2,
          f"autopilot_straggler: the finding {dones[0]['chaos']['findings']}")
    t_fired = fired[0]["ts"]
    healed, full = _healed_after("autopilot_straggler", evs, dones, first,
                                 "preemption_drain")
    launches = {r: d["launches"] for r, d in sorted(dones.items())}
    _per_forward("autopilot_straggler", launches, CHAOS_LAYERS, {})
    drained = _episode_phases({r: dones[r] for r in dones
                               if dones[r]["pid"] in first.values()},
                              "preemption_drain")
    say("autopilot_straggler", card=card, world=3, depth=CHAOS_LAYERS,
        seconds=secs, stall="rank 2, steps 1-5, 1.2 s",
        rank0_findings=",".join(f"{f['kind']}:{f.get('rank')}"
                                for f in dones[0]["chaos"]["findings"]),
        finding_to_action_s=t_fired - finding[0]["ts"],
        action_to_healed_s=healed - t_fired,
        action_to_readmitted_step_s=full - t_fired,
        decisions=",".join(f"{d['policy']}:{d['outcome']}"
                           for d in decisions),
        **{f"rank{r}_{ph}_s": v for r, ps in sorted(drained.items())
           for ph, v in sorted(ps.items()) if ph in REMESH_PHASES},
        phase_s=time.perf_counter() - t_phase)
    return launches


def transport_chaos_rank_main(out_dir: str) -> int:
    """One rank of [transport_chaos_2rank]: a flagship forward at depth
    CHAOS_LAYERS on ``cuda:0``, then the core under the transport plan
    (``torch_port_chaos_worker.run``); the failed collective leaves the
    core's ring broken, so the rank leaves at once."""
    import numpy as np
    import torch

    import torch_port_chaos_worker as chaos_worker

    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import (Transformer, from_jax_params,
                                          init_params, make_forward)
    from horovod_tpu_torch.ops import attention, xent
    rank = int(os.environ["HVD_TPU_RANK"])
    cfg = dataclasses.replace(_flagship_cfg(False), n_layers=CHAOS_LAYERS)
    model = Transformer(cfg, torch.device("cuda", 0))
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0), cfg)))
    tokens, targets = flagship_batch(cfg)
    counters = (attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda)
    for c in counters:
        c.launches = 0
    loss = float(make_forward(cfg)(model, tokens.cuda(), targets.cuda()))
    launches = {"flash_attention_fwd": counters[0].launches,
                "xent_fwd": counters[1].launches}
    res = chaos_worker.run("port", out_dir, "cuda:0")
    with open(os.path.join(out_dir, f"launches{rank}.json"), "w") as f:
        json.dump({"launches": launches, "loss": loss}, f)
    sys.stdout.flush()
    os._exit(0 if res["grouped_equal"] else 1)


def phase_transport_chaos(torch, card: str) -> dict:
    """[transport_chaos_2rank]: the core's transport seams on the card.
    Returns each rank's launches."""
    import torch_port_chaos_worker as chaos_worker
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="transport_chaos_") as out:
        base, held = reserve_ports(1)
        try:
            _run_gloo_ranks(out, 2, "transport_chaos",
                            "transport_chaos_2rank", env_extra={
                                "HVD_TPU_FAULT_PLAN":
                                    json.dumps(chaos_worker.PLAN),
                                "HVD_TPU_COORD_ADDR": "127.0.0.1",
                                "HVD_TPU_COORD_PORT": str(base)})
        finally:
            for sock in held:
                sock.close()
        res, launches = [], {}
        for r in range(2):
            with open(os.path.join(out, f"port.rank{r}.json")) as f:
                res.append(json.load(f))
            with open(os.path.join(out, f"launches{r}.json")) as f:
                launches[r] = json.load(f)["launches"]
    _per_forward("transport_chaos_2rank", launches, CHAOS_LAYERS, {})
    check(all(x["grouped_equal"] for x in res),
          f"transport_chaos_2rank: the grouped allreduce {res}")
    check(res[1]["chaos_injected"] == 4 and res[0]["chaos_injected"] == 0,
          f"transport_chaos_2rank: delays counted "
          f"{[x['chaos_injected'] for x in res]}")
    err = res[0]["error"] or ""
    # rank 0 names the checksum; the sender's error is a race (the
    # worker's docstring)
    classes = [chaos_worker.error_class(x["error"]) for x in res]
    check(res[0]["checksum_failures"] == 1 and all(
        c in chaos_worker.ERROR_CLASSES["port"][r]
        for r, c in enumerate(classes)),
          f"transport_chaos_2rank: the bit flip surfaced as {res}")
    say("transport_chaos_2rank", card=card, world=2,
        delayed_frames=res[1]["chaos_injected"],
        grouped_s=",".join(f"{x['grouped_s']:.4f}" for x in res),
        grouped_equal=True, checksum_failures=res[0]["checksum_failures"],
        errors=",".join(classes), rank0_error=json.dumps(err[:80]),
        launches=";".join(f"{r}:{v['flash_attention_fwd']},{v['xent_fwd']}"
                          for r, v in launches.items()),
        phase_s=time.perf_counter() - t_phase)
    return launches


def example_rank_main(out_path: str, script: str, argv) -> int:
    """``chip_smoke.py --example-rank OUT SCRIPT [ARGS...]``, the command
    ``[examples]`` gives ``hvdrun``: the script run as ``__main__`` with its
    own argv, as ``python SCRIPT ARGS`` runs it, then this rank's kernel
    launches written to OUT as JSON."""
    import runpy
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    sys.argv = [script, *argv]
    runpy.run_path(script, run_name="__main__")
    with open(out_path, "w") as f:
        json.dump({k: c.launches for k, c in counters.items()}, f)
    return 0


def phase_example(name: str, card: str) -> dict:
    """[examples]: one documented script of ``horovod_tpu_torch/examples``
    under the port's ``hvdrun -np 1`` on the card, its printed lines
    checked. Returns its rank's launches."""
    rel, argv = EXAMPLES[name]
    repo = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(repo, "horovod_tpu_torch", "examples", rel)
    with tempfile.TemporaryDirectory(prefix="example_") as out:
        launches_path = os.path.join(out, "launches.json")
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.runner.launch",
             "-np", "1", sys.executable, os.path.abspath(__file__),
             "--example-rank", launches_path, script, *argv],
            cwd=out, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        check(r.returncode == 0, f"examples: {rel} exited {r.returncode}:\n"
                                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        with open(launches_path) as f:
            launches = json.load(f)
    lines = r.stdout.splitlines()
    if name == "transformer_5d_parallel":
        losses = [float(m.group(1)) for m in
                  (re.match(r"step \d+: loss (\S+) aux \S+$", x)
                   for x in lines) if m]
        check(len(losses) == 10 and all(map(math.isfinite, losses)),
              f"examples: {rel} printed {lines[-12:]}")
        check(losses[-1] < losses[0],
              f"examples: {rel}'s loss did not fall: {losses}")
        check(launches["flash_attention_fwd"] > 0 and
              launches["xent_fwd"] > 0,
              f"examples: {rel} launched {launches}")
        fields = {"mesh": json.dumps(next(
            (x[len("mesh: "):] for x in lines if x.startswith("mesh: ")),
            "")), "losses": ",".join(f"{x:.4f}" for x in losses)}
    else:
        rate = [x for x in lines if x.startswith("Img/sec per process: ")]
        check(len(rate) == 1, f"examples: {rel} printed {lines[-6:]}")
        fields = {"img_sec": json.dumps(
            rate[0][len("Img/sec per process: "):])}
    say("examples", script=rel, card=card, seconds=secs, **fields,
        launches=",".join(f"{k}:{v}" for k, v in launches.items() if v))
    return launches


def phase_rollout_canary(torch, dev, card: str) -> None:
    """[rollout_canary]: a poisoned candidate rolled back and a clean one
    promoted by the autopilot over a fleet of two flagship replicas."""
    import random
    import threading
    import urllib.error
    import urllib.request

    from horovod_tpu_torch import autopilot
    from horovod_tpu_torch.checkpoint import ShardedCheckpointer
    from horovod_tpu_torch.metrics import anomaly
    from horovod_tpu_torch.serving import ReplicaFleet, Router
    from horovod_tpu_torch.serving.generate import flagship_gen_setup
    from horovod_tpu_torch.serving.rollout import (RolloutConfig,
                                                   RolloutController)
    t_phase = time.perf_counter()
    plan = {"faults": [{"seam": "serving.request", "kind": "error",
                        "rank": 0, "count": ROLLOUT_POISON}]}
    stop, errors, rng = threading.Event(), [], random.Random(3)

    def client(router, k):
        i = 0
        while not stop.is_set():
            prompt = [rng.randrange(cfg.vocab_size) for _ in range(16)]
            try:
                router.submit_generate(prompt, max_new=8,
                                       req_id=f"c{k}-{i}")
            except Exception as e:
                errors.append(f"c{k}-{i}: {e!r}")
            i += 1

    def until(ctl, state, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and ctl.state != state:
            ctl.evaluate()
            time.sleep(0.1)
        check(ctl.state == state, f"rollout_canary: {ctl.status()}")

    with tempfile.TemporaryDirectory(prefix="rollout_") as store_dir, \
            environ(HVD_TPU_AUTOPILOT="act", HVD_TPU_PROFILE_ON_ANOMALY=0):
        autopilot.reset()
        anomaly.reset()
        store = ShardedCheckpointer(store_dir, rank=0, world_size=1)
        for step, seed in ((1, 0), (2, 1), (3, 2)):
            params, cfg = flagship_gen_setup(seed=seed, device="cpu")
            store.save(step, {"params": params}, wait=True)
        fleet = ReplicaFleet(
            size=2, mode="generate", device=str(dev), store_dir=store_dir,
            poll_s=0.1, extra_env={"HVD_TPU_FAULT_PLAN": json.dumps(plan)},
            extra_args=["--flagship", "--slots", str(SERVE_SLOTS),
                        "--prefill-chunk", str(SERVE_CHUNK),
                        "--pin-version", "1"])
        router = None
        threads = []
        try:
            t0 = time.perf_counter()
            fleet.start(ready_timeout_s=SERVE_TIMEOUT_S)
            ready_s = time.perf_counter() - t0
            router = Router(fleet.endpoints, max_attempts=8, hedge_ms=0,
                            attempt_timeout_s=SERVE_TIMEOUT_S,
                            default_deadline_s=SERVE_TIMEOUT_S)
            ctl = RolloutController(
                fleet, router, RolloutConfig(
                    canary_pct=50, expand_pct=50, window_s=0.5,
                    min_requests=8, max_p99_ratio=4.0,
                    max_error_rate=0.05),
                store_dir=store_dir).register_autopilot_hooks()
            t_rb = time.perf_counter()
            ctl.begin(candidate=2, incumbent=1)
            poisoned_trace = ctl.trace.trace_id
            threads = [threading.Thread(target=client, args=(router, k),
                                        daemon=True) for k in range(4)]
            for t in threads:
                t.start()
            until(ctl, "rolled_back", SERVE_TIMEOUT_S)
            rollback_s = time.perf_counter() - t_rb
            pins_after_rollback = fleet.pins()
            # the canary slot's rule has errors left only if the verdict
            # came before all were spent: spend them off the router's
            # books (a direct request each), so the clean candidate's
            # canary starts clean
            port0 = fleet._replicas[0].read_port()
            left = 0
            for i in range(ROLLOUT_POISON):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{port0}/generate",
                    data=json.dumps({"id": f"flush{i}", "prompt": [1, 2],
                                     "max_new": 1}).encode(), method="POST")
                try:
                    urllib.request.urlopen(req, timeout=60).read()
                    break
                except urllib.error.HTTPError:
                    left += 1
            t_pr = time.perf_counter()
            ctl.begin(candidate=3, incumbent=1)
            clean_trace = ctl.trace.trace_id
            until(ctl, "promoted", SERVE_TIMEOUT_S)
            promote_s = time.perf_counter() - t_pr
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            while time.monotonic() < deadline and not all(
                    v == 3 for v in fleet.versions().values()):
                time.sleep(0.1)
            versions = fleet.versions()
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=SERVE_TIMEOUT_S)
            if router is not None:
                acct = router.accounting()
                router.close()
            fleet.stop()
            store.close()
        decisions = autopilot.recent_decisions()
        history = list(ctl.history)
        autopilot.reset()
        anomaly.reset()
    check(not errors, f"rollout_canary: failed requests {errors[:3]}")
    check(acct["accepted"] == acct["answered_ok"] > 0
          and not acct["unanswered"] and not acct["answered_twice"]
          and acct["outcomes"].get("failed", 0) == 0,
          f"rollout_canary: the books {acct}")
    check(pins_after_rollback == {0: 1, 1: 1},
          f"rollout_canary: pins after the rollback {pins_after_rollback}")
    check(all(v == 3 for v in versions.values()),
          f"rollout_canary: versions after the promotion {versions}")
    rb = [d for d in decisions if d["policy"] == "rollout-rollback"
          and d["outcome"] == "fired"]
    pr = [d for d in decisions if d["policy"] == "rollout-promote"
          and d["outcome"] == "fired"]
    check(len(rb) == 1 and rb[0]["trace"] == poisoned_trace
          and len(pr) == 2 and all(d["trace"] == clean_trace for d in pr),
          f"rollout_canary: decisions {decisions}")
    by_version = acct.get("by_version", {})
    stages = ",".join(f"{h['to']}@{h['ts'] - history[0]['ts']:.3f}"
                      for h in history)
    say("rollout_canary", card=card, replicas=2, serving="fp32 flagship",
        ready_s=ready_s, begin_to_rolled_back_s=rollback_s,
        begin_to_promoted_s=promote_s, stages=stages,
        poison_errors_left=left,
        accounting=json.dumps(acct["outcomes"], sort_keys=True),
        by_version=json.dumps(by_version, sort_keys=True),
        phase_s=time.perf_counter() - t_phase)


def kernel_counters():
    """The launch counters of the eight kernels, by kernel name."""
    from horovod_tpu_torch.ops import attention, quantize, xent
    return {"flash_attention_fwd": attention.flash_attn_fwd_cuda,
            "xent_fwd": xent.xent_fwd_cuda,
            **{fn.__name__[:-len("_cuda")]: fn
               for fn in quantize.LAUNCHERS}}


def adapter_step(torch, hvd_torch, model, opt, tokens, targets, be=None):
    """One step of the reference idiom (``loss.backward(); opt.step()``,
    the hooks enqueueing each gradient during the backward pass), split
    in three parts, each ended by a device sync: the forward and backward
    pass with the hooks, the wait in ``synchronize``, the optimizer's
    apply. Returns ``(loss, ms)``: ``step``; ``staging`` (the core's host
    copies, down in the hooks and back in the wait; 0 without ``be``);
    ``wire`` (the wait less its copies back); ``compute`` (the rest)."""
    from horovod_tpu_torch.models.transformer import forward_loss_spmd

    def staged():
        return be.staging_s if be is not None else 0.0
    torch.cuda.synchronize()
    s0, t0 = staged(), time.perf_counter()
    opt.zero_grad(set_to_none=True)
    loss, aux = forward_loss_spmd(model, tokens, targets)
    (loss + 0.01 * aux).backward()
    torch.cuda.synchronize()
    s1, t1 = staged(), time.perf_counter()
    opt.synchronize()
    torch.cuda.synchronize()
    s2, t2 = staged(), time.perf_counter()
    with opt.skip_synchronize():
        opt.step()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    ms = {"step": 1e3 * (t3 - t0), "staging": 1e3 * (s2 - s0),
          "wire": 1e3 * ((t2 - t1) - (s2 - s1))}
    ms["compute"] = ms["step"] - ms["staging"] - ms["wire"]
    return float(loss.detach()), ms


def phase_hvd_torch(torch, cfg, init_sd, batch, train_losses):
    """[hvd_torch] and [eager_nccl] in an NCCL world of one: the reference
    idiom through ``horovod_tpu_torch.torch`` for TRAIN_STEPS AdamW steps
    (the losses are [train]'s to the bit: the hooks enqueue nothing in a
    world of one), then the ``torch.distributed`` eager plane built over
    the world-of-one NCCL group, held against ``LocalBackend`` on CUDA
    tensors. Returns the kernels' launches of the training steps."""
    import torch.distributed as dist

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models import Transformer, adamw
    from horovod_tpu_torch.ops.backend import LocalBackend
    from horovod_tpu_torch.ops.dist_backend import DistBackend
    from horovod_tpu_torch.ops.reduce_op import ReduceOp
    tokens, targets = batch
    hvd.init()
    torch.cuda.set_device(hvd.local_rank())
    group_backend = dist.get_backend()
    check(hvd.size() == 1 and group_backend == "nccl",
          f"hvd_torch: expected an NCCL world of one, got {hvd.size()} "
          f"{group_backend}")
    model = Transformer(cfg)
    model.load_state_dict(init_sd)
    opt = hvd.DistributedOptimizer(adamw(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    every = kernel_counters()
    for c in every.values():
        c.launches = 0
    losses, split = [], []
    for _ in range(TRAIN_STEPS):
        loss, ms = adapter_step(torch, hvd, model, opt, tokens, targets)
        losses.append(loss)
        split.append(ms)
    launches = {k: c.launches for k, c in every.items()}
    med = sorted(s["step"] for s in split[1:])[(TRAIN_STEPS - 1) // 2]
    say("hvd_torch", world=hvd.size(), backend=dist.get_backend(),
        losses=",".join(f"{x:.6f}" for x in losses),
        train_losses=",".join(f"{x:.6f}" for x in train_losses),
        bit_equal=losses == train_losses, median_step_ms_after_warmup=med,
        launches=",".join(f"{k}:{v}" for k, v in launches.items()))
    check(losses == train_losses, f"hvd_torch: losses {losses} are not "
                                  f"[train]'s {train_losses} to the bit")
    want = {k: 0 for k in every}
    want.update(flash_attention_fwd=cfg.n_layers * TRAIN_STEPS,
                xent_fwd=TRAIN_STEPS)
    check(launches == want, f"hvd_torch: launches {launches}, expected "
                            f"{want}")
    del model, opt

    # the eager data plane over the NCCL group, against LocalBackend
    dev = torch.device("cuda", 0)
    plane, local = DistBackend(), LocalBackend()
    g = torch.Generator(device=dev).manual_seed(5)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
               torch.int64):
        x = (torch.randn(4, 33, generator=g, device=dev) * 50).to(dt)
        ops = [ReduceOp.SUM, ReduceOp.MIN, ReduceOp.MAX]
        if dt.is_floating_point:
            ops += [ReduceOp.AVERAGE, ReduceOp.ADASUM] \
                if dt == torch.float32 else [ReduceOp.AVERAGE]
        pairs = [(plane.allreduce_async("x", x, op).wait(),
                  local.allreduce_async("x", x, op).wait()) for op in ops]
        pairs.append((plane.grouped_allreduce_async(
            ["a", "b"], [x, x[0]], ReduceOp.SUM).wait()[1],
            local.grouped_allreduce_async(
                ["a", "b"], [x, x[0]], ReduceOp.SUM).wait()[1]))
        pairs += [(plane.allgather_async("g", x).wait(), x),
                  (plane.broadcast_async("b", x, 0).wait(), x),
                  (plane.alltoall_async("t", x, [4]).wait()[0], x),
                  (plane.reducescatter_async("r", x, ReduceOp.SUM).wait(),
                   x)]
        for got, want_t in pairs:
            check(got.device == dev and got.dtype == dt
                  and got.shape == want_t.shape,
                  f"eager_nccl: {dt} result {got.device} {got.dtype} "
                  f"{tuple(got.shape)}")
            worst = max(worst, max_err(got.double(), want_t.double()))
    plane.shutdown()
    hvd.shutdown()
    say("eager_nccl", world=1, backend=group_backend,
        dtypes="fp32,bf16,fp16,int32,int64", max_abs_err=worst, tol=0.0)
    check(worst == 0.0, f"eager_nccl: the NCCL plane is {worst} off "
                        f"LocalBackend")
    return launches


EAGER_DTYPES = ("float32", "bfloat16", "float16", "int32", "int64")


def eager_inputs(torch, rank: int, dt: str, dev):
    """A rank's seeded inputs of [eager_core_2rank] for one dtype: a
    [17, 9] tensor, a ragged [rank + 3, 5] one, an uneven alltoall
    send of ``sum(splits)`` rows and its splits."""
    import numpy as np
    rng = np.random.RandomState(100 * rank + EAGER_DTYPES.index(dt))
    tdt = getattr(torch, dt)

    def make(*shape):
        x = torch.from_numpy(rng.randn(*shape) * 20)
        return x.to(tdt).to(dev)
    splits = [rank + 1, 2 - rank]
    return make(17, 9), make(rank + 3, 5), make(sum(splits), 4), splits


def eager_host_refs(torch, dt: str, n: int):
    """The host reference of every [eager_core_2rank] result: each rank's
    inputs made again on the CPU, reduced on the host."""
    cpu = torch.device("cpu")
    ins = [eager_inputs(torch, r, dt, cpu) for r in range(n)]
    xs = [i[0] for i in ins]
    f32 = [x.float() if x.is_floating_point() else x for x in xs]
    total = f32[0] + f32[1]
    out = {"sum": total.to(xs[0].dtype),
           "min": torch.minimum(xs[0], xs[1]),
           "max": torch.maximum(xs[0], xs[1]),
           "ragged": torch.cat([i[1] for i in ins])}
    if xs[0].is_floating_point():
        out["avg"] = (total * 0.5).to(xs[0].dtype)
    for r in range(n):
        blocks = []
        for src in range(n):
            sends, splits = ins[src][2], ins[src][3]
            off = sum(splits[:r])
            blocks.append(sends[off:off + splits[r]])
        out[f"a2a{r}"] = torch.cat(blocks)
    return out


def eager_rank_main(out_dir: str) -> int:
    """One rank of [eager_core_2rank] and [hvd_torch_2rank], started by
    the port's hvdrun (two slots of localhost, gloo, both on ``cuda:0``,
    the core as the eager engine): every eager op on CUDA tensors, then
    the reference idiom through the adapter. Writes ``rank<r>.json`` and
    step 1's synced gradients (``grads<r>.pt``)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as hvd_torch
    from horovod_tpu_torch.common.basics import _state, backend, eager_backend
    from horovod_tpu_torch.compression import (BlockInt8Quantizer,
                                               Compression)
    from horovod_tpu_torch.entry import _flagship_cfg
    from horovod_tpu_torch.models import Transformer, adamw
    from horovod_tpu_torch.models.transformer import (from_jax_params,
                                                      init_params)
    from horovod_tpu_torch.ops.adasum import adasum_combine
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()
    hvd.init()
    rank, n = hvd.rank(), hvd.size()
    be = eager_backend()
    res = {"rank": rank, "size": n, "engine": type(be).__name__,
           "backend": backend(), "errors": []}
    errors = res["errors"]

    def mark(what):
        print(f"[eager rank {rank}] {what} at "
              f"{time.perf_counter() - t_start:.3f} s", flush=True)

    def expect(ok, msg):
        if not ok:
            errors.append(msg)

    def same(name, got, want):
        """Equal to the host reference; fp16 within one unit in the last
        place (the core's F32ToF16 rounds ties up, torch's to even)."""
        expect(got.device == dev, f"{name}: on {got.device}, not {dev}")
        expect(got.dtype == want.dtype and got.shape == want.shape,
               f"{name}: {got.dtype} {tuple(got.shape)} vs "
               f"{want.dtype} {tuple(want.shape)}")
        if got.shape != want.shape:
            return
        g, w = got.cpu().double(), want.double()
        if want.dtype == torch.float16:
            err = float(((g - w).abs() / w.abs().clamp_min(2.0 ** -14)
                         ).max())
            expect(err <= 2.0 ** -10, f"{name}: {err} relative off the "
                                      f"host reference (one fp16 ulp)")
        else:
            err = max_err(g, w)
            expect(err == 0.0, f"{name}: {err} off the host reference")

    mark("the core started")
    # -- every eager op, on CUDA tensors
    every = kernel_counters()
    for c in every.values():
        c.launches = 0
    for dt in EAGER_DTYPES:
        mark(f"ops over {dt}")
        x, ragged, sends, splits = eager_inputs(torch, rank, dt, dev)
        ref = eager_host_refs(torch, dt, n)
        same(f"sum.{dt}", hvd.allreduce(x, op=hvd.Sum, name=f"s.{dt}"),
             ref["sum"])
        same(f"min.{dt}", hvd.allreduce(x, op=hvd.Min, name=f"mn.{dt}"),
             ref["min"])
        same(f"max.{dt}", hvd.allreduce(x, op=hvd.Max, name=f"mx.{dt}"),
             ref["max"])
        if "avg" in ref:
            same(f"avg.{dt}", hvd.allreduce(x, name=f"a.{dt}"), ref["avg"])
        got = hvd.grouped_allreduce([x, x[:3]], op=hvd.Sum, name=f"g.{dt}")
        same(f"grouped.{dt}", got[0], ref["sum"])
        same(f"grouped1.{dt}", got[1], ref["sum"][:3])
        same(f"allgather.{dt}", hvd.allgather(ragged, name=f"ag.{dt}"),
             ref["ragged"])
        same(f"broadcast.{dt}", hvd.broadcast(x, root_rank=1,
                                              name=f"b.{dt}"),
             eager_inputs(torch, 1, dt, torch.device("cpu"))[0])
        out, recv = hvd.alltoall(sends, splits, name=f"t.{dt}")
        same(f"alltoall.{dt}", out, ref[f"a2a{rank}"])
        want_recv = [eager_inputs(torch, src, dt, "cpu")[3][rank]
                     for src in range(n)]
        expect(recv.tolist() == want_recv, f"alltoall.{dt}: received "
                                           f"splits {recv.tolist()}")
        same(f"reducescatter.{dt}", hvd.reducescatter(
            x[:16], op=hvd.Sum, name=f"rs.{dt}"),
            ref["sum"][:16][8 * rank:8 * rank + 8])

    mark("the 116 MB group")
    # the flagship's gradient shapes in fp32 (116 MB), one fused group
    cfg = _flagship_cfg()
    shapes = {k: v.shape for k, v in Transformer(
        cfg, device="meta").state_dict().items()}
    names = sorted(shapes)
    gen = torch.Generator(device=dev)

    def grads_of(r):
        gen.manual_seed(1000 + r)
        return [torch.randn(shapes[k], generator=gen, device=dev)
                for k in names]

    mine = grads_of(rank)
    mb = sum(t.numel() * 4 for t in mine) / 1e6
    want = [(a + b) * 0.5 for a, b in zip(grads_of(0), grads_of(1))]
    fused = []
    for i in range(EAGER_FUSED_REPEATS):
        torch.cuda.synchronize()
        s0 = be.staging_s
        t0 = time.perf_counter()
        outs = hvd.grouped_allreduce(mine, name="fused116")
        torch.cuda.synchronize()
        fused.append((1e3 * (time.perf_counter() - t0),
                      1e3 * (be.staging_s - s0)))
    err = max(max_err(o, w) for o, w in zip(outs, want))
    expect(all(o.device == dev for o in outs) and err == 0.0,
           f"fused116: {err} off (a + b) / 2")
    # the same group through the torch.distributed plane over this gloo
    # world, beside the core (the dist backend a user gets with
    # HVD_TPU_EAGER_BACKEND=dist)
    from horovod_tpu_torch.ops.dist_backend import DistBackend
    from horovod_tpu_torch.ops.reduce_op import ReduceOp
    plane = DistBackend()
    plane_ms = []
    for i in range(EAGER_FUSED_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pouts = plane.grouped_allreduce_async(names, mine,
                                              ReduceOp.AVERAGE).wait()
        torch.cuda.synchronize()
        plane_ms.append(1e3 * (time.perf_counter() - t0))
    perr = max(max_err(o, w) for o, w in zip(pouts, want))
    expect(perr == 0.0, f"fused116 over gloo: {perr} off (a + b) / 2")
    plane.shutdown()
    res["fused"] = {"mbytes": mb, "leaves": len(names),
                    "op_ms": [f[0] for f in fused],
                    "staging_ms": [f[1] for f in fused], "max_abs_err": err,
                    "gloo_plane_ms": plane_ms}
    del pouts

    mark("int8")
    # int8 over the wire: the quantize and dequantize kernels, never a
    # plain version (a CUDA tensor reaches the wrappers' kernels only)
    q0 = {k: every[k].launches for k in ("quantize", "dequantize")}
    qouts = hvd.quantized_grouped_allreduce(mine, Compression.int8,
                                            name="q116")
    torch.cuda.synchronize()
    q = {k: every[k].launches - q0[k] for k in q0}
    plain = BlockInt8Quantizer()
    qerr = 0.0
    for o, g0, g1 in zip(qouts, grads_of(0), grads_of(1)):
        ref_q = (plain.qdq(g0.cpu()) + plain.qdq(g1.cpu())) / 2
        qerr = max(qerr, max_err(o.cpu(), ref_q))
    expect(all(o.device == dev for o in qouts) and qerr <= QUANT_TOL,
           f"q116: {qerr} off the plain versions' host reference")
    expect(q == {"quantize": len(names), "dequantize": n * len(names)},
           f"q116: launches {q}")
    res["quantized"] = {"launches": q, "max_abs_err": qerr}
    del mine, want, outs, qouts

    mark("sets, adasum, join")
    # a registered process set per rank, the Adasum op, join
    sets = [hvd.add_process_set([0]), hvd.add_process_set([1])]
    x = eager_inputs(torch, rank, "float32", dev)[0]
    same("pset", hvd.allreduce(x, op=hvd.Sum, name="ps",
                               process_set=sets[rank]), x.cpu())
    a = eager_inputs(torch, 0, "float32", torch.device("cpu"))[0]
    b = eager_inputs(torch, 1, "float32", torch.device("cpu"))[0]
    ada = hvd.allreduce(x, op=hvd.Adasum, name="adasum")
    want_ada = adasum_combine(a.double(), b.double())
    ada_err = max_err(ada.cpu().double(), want_ada) / float(
        want_ada.abs().max())
    expect(ada.device == dev and ada_err <= EAGER_ADASUM_RTOL,
           f"adasum: {ada_err} (of the largest element) off the host "
           f"combine")
    if rank == 1:   # uneven work: rank 1 reduces once more after 0 joined
        extra = hvd.allreduce(x, op=hvd.Sum, name="after_join")
        same("after_join", extra, x.cpu())
    last = hvd.join()
    expect(last == 1, f"join: last joiner {last}, expected 1")
    res["eager"] = {"adasum_rel": ada_err, "join_last": last,
                    "launches": {k: c.launches for k, c in every.items()}}

    mark("the adapter")
    # -- [hvd_torch_2rank]: the reference idiom through the adapter
    model = Transformer(cfg, dev)
    model.load_state_dict(from_jax_params(init_params(
        np.random.RandomState(0), cfg)))
    tokens, targets = flagship_batch(cfg)
    rows = tokens.shape[0] // n
    tok = tokens[rank * rows:(rank + 1) * rows].to(dev)
    tgt = targets[rank * rows:(rank + 1) * rows].to(dev)
    opt = hvd_torch.DistributedOptimizer(
        adamw(model.parameters()), named_parameters=model.named_parameters())
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd_torch.broadcast_optimizer_state(opt, root_rank=0)
    for c in every.values():
        c.launches = 0
    losses, split, hits = [], [], []
    for step in range(EAGER_STEPS):
        loss, ms = adapter_step(torch, hvd_torch, model, opt, tok, tgt, be)
        losses.append(loss)
        split.append(ms)
        hits.append(hvd.counters()["cache_hits"])
        if step == 0:
            torch.save({k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()},
                       os.path.join(out_dir, f"grads{rank}.pt"))
    snap = hvd.metrics_snapshot()
    text = ""
    if _state.metrics_exporter is not None:
        import urllib.request
        with urllib.request.urlopen(
                f"http://127.0.0.1:{_state.metrics_exporter.port}/metrics",
                timeout=30) as r:
            text = r.read().decode()
    res["adapter"] = {
        "losses": losses, "split_ms": split, "cache_hits": hits,
        "cache_hit_rate": snap["derived"].get("cache_hit_rate"),
        "engine": snap["engine"], "digest": params_digest(model),
        "exporter_engine_lines": sorted(
            line.split(" ")[0] for line in text.splitlines()
            if line.startswith("hvd_engine_")),
        "launches": {k: c.launches for k, c in every.items()}}
    hvd.barrier()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    hvd.shutdown()
    return 0


def phase_eager_2rank(torch, cfg, ref_grads, train_losses) -> dict:
    """[eager_core_2rank] and [hvd_torch_2rank]: two ranks of this script
    launched by hvdrun (``-np 2 -H localhost:2``, gloo, the core), every
    check of the module docstring. Returns each phase's launches by
    rank."""
    repo = os.path.dirname(os.path.abspath(__file__))
    launch = [sys.executable, "-m", "horovod_tpu_torch.runner.launch"]
    with tempfile.TemporaryDirectory(prefix="eager_") as out:
        base, held = reserve_ports(2)
        env = dict(os.environ, PYTHONPATH=repo, HOROVOD_TPU_OPERATIONS="GLOO",
                   HVD_TPU_EAGER_BACKEND="core",
                   HVD_TPU_METRICS_PORT=str(base),
                   HVD_TPU_GLOO_TIMEOUT_SECONDS=str(GLOO_TIMEOUT_S),
                   HVD_TPU_AUTOPSY_DIR=os.path.join(out, "autopsy"),
                   PYTHONFAULTHANDLER="1")
        logs = os.path.join(out, "logs")
        t0 = time.perf_counter()
        r = subprocess.run(
            launch + ["-np", "2", "-H", "localhost:2", "--output-filename",
                      logs, sys.executable, os.path.abspath(__file__),
                      "--gloo-rank", out, "eager"], cwd=repo, env=env,
            capture_output=True, text=True, timeout=EAGER_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for sock in held:
            sock.close()
        if r.returncode != 0:
            tails = []
            for rk in range(2):
                for stream in ("stdout", "stderr"):
                    path = os.path.join(logs, f"rank.{rk}", stream)
                    if os.path.exists(path):
                        with open(path) as f:
                            tails.append(f"-- rank {rk} {stream}:\n"
                                         f"{f.read()[-4000:]}")
            check(False, f"eager_core_2rank: hvdrun exited {r.returncode}:"
                         f"\n{r.stdout[-2000:]}{r.stderr[-2000:]}\n"
                         + "\n".join(tails))
        res = []
        for rk in range(2):
            with open(os.path.join(out, f"rank{rk}.json")) as f:
                res.append(json.load(f))
        grads = [torch.load(os.path.join(out, f"grads{rk}.pt"))
                 for rk in range(2)]
    for rr in res:
        check(not rr["errors"], f"eager_core_2rank: rank {rr['rank']}: "
                                f"{rr['errors']}")
        check(rr["engine"] == "CoreBackend" and rr["backend"] == "gloo",
              f"eager_core_2rank: engine {rr['engine']}, process group "
              f"{rr['backend']}")
    f0 = res[0]["fused"]
    op_ms, st_ms = f0["op_ms"][1:], f0["staging_ms"][1:]
    say("eager_core_2rank", seconds=secs, launcher="hvdrun -np 2",
        engine=res[0]["engine"], group=res[0]["backend"],
        dtypes=",".join(EAGER_DTYPES),
        ops="allreduce(sum,min,max,avg),grouped,allgather(ragged),"
            "broadcast,alltoall(uneven),reducescatter,pset,adasum,join",
        fused_mbytes=f0["mbytes"], fused_leaves=f0["leaves"],
        fused_op_ms=",".join(f"{x:.3f}" for x in f0["op_ms"]),
        fused_staging_ms=",".join(f"{x:.3f}" for x in f0["staging_ms"]),
        fused_median_op_ms=sorted(op_ms)[len(op_ms) // 2],
        fused_median_staging_ms=sorted(st_ms)[len(st_ms) // 2],
        fused_max_abs_err=f0["max_abs_err"],
        fused_gloo_plane_ms=",".join(f"{x:.3f}" for x in
                                     f0["gloo_plane_ms"]),
        int8_launches=",".join(f"{k}:{v}" for k, v in
                               res[0]["quantized"]["launches"].items()),
        int8_max_abs_err=res[0]["quantized"]["max_abs_err"],
        adasum_rel=res[0]["eager"]["adasum_rel"],
        join_last=res[0]["eager"]["join_last"])
    # [hvd_torch_2rank]
    a = [rr["adapter"] for rr in res]
    ref = {k: v.cpu() for k, v in ref_grads.items()}
    errs = grad_errors(grads[0], ref)
    worst = max(errs, key=lambda k: errs[k][0])
    loss1 = (a[0]["losses"][0] + a[1]["losses"][0]) / 2
    rel = abs(loss1 - train_losses[0]) / abs(train_losses[0])
    split = a[0]["split_ms"][1:]

    def med(key):
        return sorted(s[key] for s in split)[len(split) // 2]
    say("hvd_torch_2rank", steps=EAGER_STEPS, rows_per_rank=4,
        losses=",".join(f"{x:.6f}" for x in a[0]["losses"]),
        step1_mean_loss=loss1, train_step1_loss=train_losses[0], rel=rel,
        tol_rel=DP_LOSS_TOL, worst_grad=worst, grad_rel_l2=errs[worst][0],
        tol_grad_rel_l2=DP_GRAD_TOL,
        replicas_bit_identical=a[0]["digest"] == a[1]["digest"],
        cache_hits=",".join(str(h) for h in a[0]["cache_hits"]),
        cache_hit_rate=a[0]["cache_hit_rate"],
        exporter_engine_gauges=len(a[0]["exporter_engine_lines"]),
        step_ms=",".join(f"{s['step']:.3f}" for s in a[0]["split_ms"]),
        median_step_ms=med("step"), median_staging_ms=med("staging"),
        median_wire_ms=med("wire"), median_compute_ms=med("compute"),
        launches=",".join(f"{k}:{v}" for k, v in a[0]["launches"].items()))
    check(rel <= DP_LOSS_TOL, f"hvd_torch_2rank: step 1 loss {loss1} is "
                              f"{rel} off [train]'s {train_losses[0]}")
    check(errs[worst][0] <= DP_GRAD_TOL,
          f"hvd_torch_2rank: synced gradient of {worst} is "
          f"{errs[worst][0]} off the full-batch one")
    check(a[0]["digest"] == a[1]["digest"],
          "hvd_torch_2rank: the replicas differ after the last step")
    check(a[0]["cache_hits"][-1] > a[0]["cache_hits"][0],
          f"hvd_torch_2rank: the response cache did not take over after "
          f"step 1: hits {a[0]['cache_hits']}")
    check((a[0]["cache_hit_rate"] or 0) > 0,
          f"hvd_torch_2rank: cache_hit_rate {a[0]['cache_hit_rate']}")
    check("hvd_engine_cache_hits" in a[0]["exporter_engine_lines"],
          f"hvd_torch_2rank: no hvd_engine_* on the exporter: "
          f"{a[0]['exporter_engine_lines']}")
    want = {k: 0 for k in a[0]["launches"]}
    want.update(flash_attention_fwd=cfg.n_layers * EAGER_STEPS,
                xent_fwd=EAGER_STEPS)
    for rr in a:
        check(rr["launches"] == want, f"hvd_torch_2rank: launches "
                                      f"{rr['launches']}, expected {want}")
    return {"eager_core_2rank": [rr["eager"]["launches"] for rr in res],
            "hvd_torch_2rank": [x["launches"] for x in a]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.entry import entry
    from horovod_tpu_torch.models import (Transformer, adamw, init_opt_state,
                                          make_forward, make_train_step)
    from horovod_tpu_torch.ops import _build, attention, quantize, xent
    from horovod_tpu_torch.profile_step import OPTIMIZERS

    # full fp32 in every fp32 comparison (cuBLAS would otherwise be free to
    # pick TF32 for the plain versions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)

    # -- build: one nvcc per kernel source, all started together, and the
    # eager core's g++ build (cpp/) beside them
    import threading

    from horovod_tpu_torch import core
    t0 = time.perf_counter()
    core_build = {}

    def build_core():
        try:
            core_build["path"] = core.library_path()
        except Exception as e:   # raised again below, on this thread
            core_build["error"] = e
        core_build["seconds"] = time.perf_counter() - t0

    builder = threading.Thread(target=build_core, daemon=True)
    builder.start()
    _build.build_all()
    nvcc_s = time.perf_counter() - t0
    builder.join()
    if "error" in core_build:
        raise core_build["error"]
    say("build", kernels=",".join(_build.ENTRIES), seconds=nvcc_s,
        core=os.path.relpath(core_build["path"], os.path.dirname(
            os.path.abspath(__file__))), core_seconds=core_build["seconds"])
    for kern, r in _build.ptxas_report("flash_attn_fwd").items():
        say("ptxas", kernel=kern, **r)

    # -- each kernel against its plain version, and timed
    kernels = [phase_flash(torch, attention, dev),
               phase_xent(torch, xent, dev),
               *phase_quantizers(torch, quantize, dev),
               *phase_optimizer_kernels(torch, quantize, dev)]
    # a kernel the port adds, with no Pallas kernel behind it
    added = [phase_bn(torch, dev), phase_flash_mla(torch, attention, dev)]

    # -- the main path: entry() forward, then the trainer
    counters = (attention.flash_attn_fwd_cuda, xent.xent_fwd_cuda)
    for c in counters:
        c.launches = 0
    fn, (model, tokens, targets) = entry()
    check(tokens.is_cuda and next(model.parameters()).is_cuda,
          "entry() did not put the model on the card")
    t0 = time.perf_counter()
    loss = float(fn(model, tokens, targets))
    fwd_s = time.perf_counter() - t0
    after_entry = [c.launches for c in counters]
    n_layers = model.cfg.n_layers
    check(after_entry == [n_layers, 1],
          f"entry forward launched {after_entry}, expected [{n_layers}, 1]")
    check(math.isfinite(loss), f"entry loss {loss} is not finite")

    cfg32 = dataclasses.replace(model.cfg, dtype=torch.float32)
    ref_model = Transformer(cfg32, device="cpu")
    ref_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    ref = float(make_forward(cfg32)(ref_model, tokens.cpu(), targets.cpu()))
    rel = abs(loss - ref) / abs(ref)
    say("entry", width="V32000 M512 H8x64 L4 F2048 S256 B8 bf16", loss=loss,
        cpu_fp32_loss=ref, rel_err=rel, tol_rel=2e-2, first_call_s=fwd_s)
    check(rel <= 2e-2, f"entry loss {loss} vs CPU fp32 {ref}: {rel} > 2e-2")

    # the int8 paths below start from the same seed-0 weights
    init_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = init_opt_state(adamw, model)
    step = make_train_step(model.cfg)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, l, _ = step(model, opt, tokens, targets)
        losses.append(float(l))
        step_s.append(time.perf_counter() - t0)
    launches = [c.launches for c in counters]
    forwards = 1 + TRAIN_STEPS
    timed = sorted(step_s[1:])                       # after the warm-up step
    med = timed[len(timed) // 2]
    tokens_per_s = tokens.numel() / med
    say("train", steps=TRAIN_STEPS, losses=",".join(f"{x:.6f}" for x in losses),
        step_ms=",".join(f"{1e3 * s:.3f}" for s in step_s),
        median_step_ms_after_warmup=1e3 * med, tokens_per_s=tokens_per_s)
    check(all(map(math.isfinite, losses)), f"non-finite train loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} "
                                  f"steps: {losses}")
    check(launches == [n_layers * forwards, forwards],
          f"main path launched {launches}, expected "
          f"[{n_layers * forwards}, {forwards}]")
    for k, n in zip(kernels, launches):
        check(n > 0, f"{k['name']} was never launched on the main path")
        k["launches"] = n
    say("main_path", flash_attention_fwd_launches=launches[0],
        xent_fwd_launches=launches[1], forwards=forwards)
    del opt

    # -- the int8 error-feedback paths, each from the seed-0 weights
    quant = {"quantize": quantize.quantize_cuda,
             "quantize_ef": quantize.quantize_ef_cuda,
             "dequantize": quantize.dequantize_cuda,
             "fused_sgd0": quantize.fused_sgd0_cuda,
             "fused_sgd": quantize.fused_sgd_cuda,
             "fused_adam": quantize.fused_adam_cuda}
    quant_launches = {}
    for label, (factory, pair) in OPTIMIZERS.items():
        if not pair:
            continue
        path_losses, got, _ = drive_int8_path(
            torch, label, factory, pair, model.cfg, init_sd,
            (tokens, targets), counters, quant)
        for k in pair:
            quant_launches[k] = got[k]
        if label in ADAM_PATHS:
            rel = abs(path_losses[-1] - losses[-1]) / abs(losses[-1])
            say(f"int8_{label}", loss5=path_losses[-1],
                adamw_loss5=losses[-1], rel=rel, tol_rel=EF_LOSS_TOL)
            check(rel <= EF_LOSS_TOL,
                  f"{label}: 5th loss {path_losses[-1]} is {rel} off plain "
                  f"AdamW's {losses[-1]}")
    for k in kernels[2:]:
        k["launches"] = quant_launches[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never ran on its path")

    # -- the train loop observed, from the seed-0 weights
    observed = {
        "telemetry": phase_telemetry(torch, model.cfg, init_sd,
                                     (tokens, targets), counters),
        "telemetry_fused_adam": phase_telemetry_fused_adam(
            torch, model.cfg, init_sd, (tokens, targets), counters, quant)}

    # -- data parallelism over torch.distributed, from the seed-0 weights
    dp_launches, ref_grads, n_buckets, observed["telemetry_dp_int8"] = \
        phase_dp_nccl(torch, model.cfg, init_sd, (tokens, targets), losses,
                      counters, quant)
    dp_launches.update(phase_dp_gloo(torch, ref_grads, n_buckets, n_layers))
    for k in kernels:
        k["dp_launches"] = {ph: got.get(k["name"], 0)
                            for ph, got in dp_launches.items()}
        k["telemetry_launches"] = {ph: got.get(k["name"], 0)
                                   for ph, got in observed.items()}
    for name in ("flash_attention_fwd", "xent_fwd", "quantize", "dequantize",
                 "quantize_ef"):
        check(any(got.get(name, 0) > 0 for got in dp_launches.values()),
              f"{name} never ran on a data-parallel path")
    for name in ("flash_attention_fwd", "xent_fwd", "quantize", "dequantize",
                 "fused_adam"):
        check(any(got.get(name, 0) > 0 for got in observed.values()),
              f"{name} never ran inside an observed step")

    # -- the guard selects on the card, without a host sync
    phase_guard(torch, dev)

    # -- tensor, sequence and expert parallelism: 4-rank gloo worlds on the
    # card at full width ([ulysses] runs in the [tp_sp] world)
    card = smi.replace(", ", "/").replace(" ", "_")
    # the three worlds side by side (their checks are of the sharding; the
    # step times of gloo ranks sharing one card price no layout)
    layout_launches = dict(zip(LAYOUT_PHASES, _concurrently(*(
        lambda role=role: phase_layout(torch, role, card, dev)
        for role in LAYOUT_PHASES))))
    for k in kernels:
        k["layout_launches"] = {role: [got.get(k["name"], 0) for got in ranks]
                                for role, ranks in layout_launches.items()}
    check(all(n > 0 for ranks in layout_launches.values()
              for n in (got["flash_attention_fwd"] for got in ranks)),
          "flash_attn_fwd did not run on every rank of a layout phase")
    check(all(got["xent_fwd"] > 0 for got in layout_launches["moe_ep_sp"]),
          "xent_fwd did not run on every [moe_ep_sp] rank")

    # -- pipeline parallelism: the composed dp x pp step over {pp:2} (two
    # gloo ranks on the card), its one-process references, and the plan
    # search of the overlap step
    pp_launches = {"pp_tp": layout_launches["pp_tp"],
                   **phase_pipeline(torch, card)}
    for k in kernels:
        k["pp_launches"] = {ph: [got.get(k["name"], 0) for got in ranks]
                            for ph, ranks in pp_launches.items()}
    for ph in ("pp_tp", *PIPELINE_PHASES):
        check(all(got["flash_attention_fwd"] > 0
                  for got in pp_launches[ph]),
              f"flash_attn_fwd did not run on every rank of [{ph}]")
    for ph in PIPELINE_PHASES:
        check(any(got["xent_fwd"] > 0 for got in pp_launches[ph]),
              f"xent_fwd did not run on the last stage of [{ph}]")

    # -- durable checkpoints: save, kill and resume the flagship on the
    # card; a two-rank commit restored at world 1, the broadcast, the
    # metric average and the replica canary
    ckpt_launches = {**phase_checkpoint(torch, model.cfg, init_sd, counters,
                                        card),
                     **phase_checkpoint_2rank(torch, card)}
    for k in kernels:
        k["ckpt_launches"] = {ph: [got.get(k["name"], 0) for got in runs]
                              for ph, runs in ckpt_launches.items()}
    for ph, runs in ckpt_launches.items():
        check(all(got["flash_attention_fwd"] > 0 and got["xent_fwd"] > 0
                  for got in runs), f"a kernel did not run in every run of "
                                    f"[{ph}]")

    # -- the model zoo: ResNet-50 (both stems), VGG-16, Inception V3 and
    # BERT-Large at full width on the card; ResNet-50 over two gloo ranks
    # with the global batch's BN statistics; BERT over tp
    phase_zoo(torch, dev, card)
    # the two gloo worlds side by side (their checks are numerical)
    _concurrently(lambda: phase_zoo_dp(torch, dev, card),
                  lambda: phase_bert_tp(torch, dev, card))

    # -- the serving plane: the flagship decoded by the continuous engine
    # (one CUDA graph capture per step function), a replica behind the
    # router through duplicates, a hot swap and a drain, and a fleet of
    # two replica processes that loses one. None of the eight kernels is
    # on this path (the decode math is plain fp32 torch, as the JAX
    # package's is XLA code): each in-process phase counts their launches
    # from 0 and must read 0 (the fleet's replicas are other processes
    # running the same engine)
    every = {"flash_attention_fwd": counters[0], "xent_fwd": counters[1],
             **quant}
    serve_launches = {}

    def serve_phase(name, fn, *args):
        for c in every.values():
            c.launches = 0
        out = fn(torch, dev, card, *args)
        serve_launches[name] = {k: c.launches for k, c in every.items()}
        return out

    served = serve_phase("serve_generate", phase_serve_generate)
    serve_phase("serve_http", phase_serve_http, served)
    phase_serve_fleet(torch, dev, card, served)
    del served
    torch.cuda.empty_cache()
    for k in kernels:
        k["serve_launches"] = {ph: got[k["name"]]
                               for ph, got in serve_launches.items()}
    check(all(n == 0 for got in serve_launches.values()
              for n in got.values()),
          f"a kernel ran on the serving path: {serve_launches}")

    # -- the live observability plane around the flagship's training: the
    # worker exporter in an NCCL world of one, the fleet tree over four
    # gloo ranks, and a hang caught by the watchdog with its autopsy
    # bundle over two (rank 0's launches for the gloo worlds)
    for c in every.values():
        c.launches = 0
    obs_launches = {"obs_exporter": phase_obs_exporter(
        torch, model.cfg, init_sd, (tokens, targets), counters)}
    # the fleet tree and the hang, two independent worlds side by side,
    # and beside them the agent transport's NIC probe (its pick is where
    # [agent_elastic]'s worlds rendezvous, below)
    obs_launches["obs_fleet_4rank"], obs_launches["obs_hang_autopsy"], \
        pick = _concurrently(lambda: phase_obs_fleet(torch, card),
                             lambda: phase_obs_hang(torch, card),
                             lambda: phase_nic_probe(card))
    for k in kernels:
        k["obs_launches"] = {ph: got.get(k["name"], 0)
                             for ph, got in obs_launches.items()}
    for ph, got in obs_launches.items():
        check(got["flash_attention_fwd"] > 0 and got["xent_fwd"] > 0,
              f"flash_attn_fwd or xent_fwd did not run in [{ph}]: {got}")
    check(all(obs_launches["obs_hang_autopsy"][k] > 0
              for k in ("quantize", "dequantize")),
          f"quantize or dequantize did not run in [obs_hang_autopsy]: "
          f"{obs_launches['obs_hang_autopsy']}")

    # -- the launcher and elastic training, side by side (independent
    # worlds on the card): hvdrun's NCCL world of one; three gloo ranks
    # that lose one and heal in place; and the agent transport: three
    # ranks that host agents run, rendezvousing at the NIC probe's pick,
    # losing an agent with its worker and growing back
    # beside them, the documented examples under hvdrun -np 1
    hvdrun_launches, elastic_launches, agent_launches, *example_launches = \
        _concurrently(
            lambda: phase_hvdrun(torch, model.cfg, init_sd,
                                 (tokens, targets), losses),
            lambda: phase_elastic_recover(torch, model.cfg, card),
            lambda: phase_agent_elastic(torch, model.cfg, card, pick),
            *(lambda name=name: phase_example(name, card)
              for name in EXAMPLES))
    example_launches = dict(zip(EXAMPLES, example_launches))
    for k in kernels:
        k["examples_launches"] = {ex: got.get(k["name"], 0)
                                  for ex, got in example_launches.items()}
        k["hvdrun_launches"] = hvdrun_launches.get(k["name"], 0)
        k["elastic_launches"] = {r: got.get(k["name"], 0)
                                 for r, got in elastic_launches.items()}
        k["agent_launches"] = {r: got.get(k["name"], 0)
                               for r, got in agent_launches.items()}

    # -- the eager collectives and the horovod.torch adapter: the reference
    # idiom in an NCCL world of one (and the NCCL eager plane there), then
    # hvdrun's two gloo ranks on the card over the core
    eager_launches = {"hvd_torch": phase_hvd_torch(
        torch, model.cfg, init_sd, (tokens, targets), losses)}
    eager_launches.update(phase_eager_2rank(torch, model.cfg, ref_grads,
                                            losses))
    for k in kernels:
        k["eager_launches"] = {
            ph: (got[k["name"]] if isinstance(got, dict)
                 else [g[k["name"]] for g in got])
            for ph, got in eager_launches.items()}
    check(all(eager_launches["hvd_torch_2rank"][r][name] > 0
              for r in range(2) for name in ("flash_attention_fwd",
                                             "xent_fwd")),
          "flash_attn_fwd or xent_fwd did not run on both adapter ranks")
    check(all(eager_launches["eager_core_2rank"][r][name] > 0
              for r in range(2) for name in ("quantize", "dequantize")),
          "quantize or dequantize did not run on both eager ranks")

    # -- the self-healing loop: a compound fault plan healed at full depth,
    # a planned drain against a reactive kill, the driver's takeover, the
    # autopilot draining a straggler, the core's transport seams, and a
    # rollout the autopilot rolls back and then promotes (each training
    # rank's launches; the rollout's in this process, counted from 0)
    chaos_launches = {}
    chaos_launches["chaos_soak"] = phase_chaos_soak(torch, card)
    drained, boot_s = phase_preempt_drain(torch, card)
    chaos_launches["preempt_drain"] = drained["drain"]
    chaos_launches["preempt_kill"] = drained["kill"]
    # two independent depth-2 runs, side by side on the card
    chaos_launches["driver_chaos"], chaos_launches["autopilot_straggler"] = \
        _concurrently(lambda: phase_driver_chaos(torch, card, boot_s),
                      lambda: phase_autopilot_straggler(torch, card))
    chaos_launches["transport_chaos_2rank"] = phase_transport_chaos(
        torch, card)
    for c in every.values():
        c.launches = 0
    phase_rollout_canary(torch, dev, card)
    chaos_launches["rollout_canary"] = {
        0: {k: c.launches for k, c in every.items()}}
    check(all(n == 0 for n in chaos_launches["rollout_canary"][0].values()),
          f"a kernel ran on the rollout's path: "
          f"{chaos_launches['rollout_canary']}")
    for k in kernels:
        k["chaos_launches"] = {ph: [got[r].get(k["name"], 0)
                                    for r in sorted(got)]
                               for ph, got in chaos_launches.items()}

    # where the run's time goes: from each phase's first line to the next
    # phase's (the kernel phases print several lines, concurrent phases in
    # the order they finished)
    marks = sorted(_FIRST_SAID.items(), key=lambda kv: kv[1])
    say("timing", total_s=f"{time.perf_counter() - _T0:.1f}",
        **{name: f"{nxt - t:.1f}" for (name, t), (_, nxt)
           in zip(marks, marks[1:] + [("end", time.perf_counter() - _T0)])})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "dp_launches", "telemetry_launches", "layout_launches",
            "pp_launches", "ckpt_launches", "serve_launches",
            "obs_launches", "hvdrun_launches", "elastic_launches",
            "agent_launches", "eager_launches", "chaos_launches",
            "examples_launches")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"added_kernels": added}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def straggler_rounds_main(rounds: int, boot_s: float) -> int:
    """``chip_smoke.py --straggler-rounds N [BOOT_S]``: build the kernels,
    then run ``[driver_chaos]`` beside ``[autopilot_straggler]`` N times, as
    the full run does once (``BOOT_S``: the workers' boot that
    ``[preempt_drain]`` would measure). Each phase prints its line and each
    round one ``[straggler_round]`` line; a failed check's message goes to
    stderr. Exits 1 if a round failed, and prints no result line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from horovod_tpu_torch.ops import _build
    _build.build_all()
    card = torch.cuda.get_device_name(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    failed = 0
    for i in range(rounds):
        t0 = time.perf_counter()
        try:
            _concurrently(lambda: phase_driver_chaos(torch, card, boot_s),
                          lambda: phase_autopilot_straggler(torch, card))
            ok = True
        except Exception as e:
            ok, failed = False, failed + 1
            print(f"chip_smoke: round {i}: {e}", file=sys.stderr, flush=True)
        say("straggler_round", round=i, ok=ok,
            seconds=time.perf_counter() - t0)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--straggler-rounds"]:
        sys.exit(straggler_rounds_main(
            int(sys.argv[2]),
            float(sys.argv[3]) if len(sys.argv) > 3 else 29.0))
    if sys.argv[1:2] == ["--example-rank"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        sys.exit(example_rank_main(sys.argv[2], sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["--gloo-rank"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        role = sys.argv[3] if len(sys.argv) > 3 else "dp"
        if role == "dp":
            sys.exit(gloo_rank_main(sys.argv[2]))
        if role == "single":
            sys.exit(single_rank_main(sys.argv[2]))
        if role == "checkpoint":
            sys.exit(ckpt_rank_main(sys.argv[2]))
        if role == "zoo_dp":
            sys.exit(zoo_dp_rank_main(sys.argv[2]))
        if role == "bert_tp":
            sys.exit(bert_tp_rank_main(sys.argv[2]))
        if role == "obs_fleet":
            sys.exit(obs_fleet_rank_main(sys.argv[2]))
        if role == "obs_hang":
            sys.exit(obs_hang_rank_main(sys.argv[2]))
        if role == "eager":
            sys.exit(eager_rank_main(sys.argv[2]))
        if role == "transport_chaos":
            sys.exit(transport_chaos_rank_main(sys.argv[2]))
        if role in PIPELINE_PHASES:
            sys.exit(pipeline_rank_main(sys.argv[2], role))
        sys.exit(layout_rank_main(sys.argv[2], role))
    sys.exit(main())
