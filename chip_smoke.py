"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each of which raises on failure:

1. device: the card's name and power limit; CUDA must be present;
2. build: every CUDA C++ kernel of the served path, from ``ai4e_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at the
   served shapes and at ragged ones (normalize bit for bit at buckets 1,
   16 and 64, ragged, misaligned and C in {1, 3, 4, 8}), then timed
   (kernel, plain version, one-call library yardstick; for normalize also
   ``torch.empty(..., float32).copy_(x)``, a bandwidth yardstick of
   another function) with CUDA events, median of 25 runs (5 for
   the flash kernel's plain version, which materialises 8.6 GB of scores
   at the served shape and runs in batch chunks). The flash forward is
   also held and timed on the served model's own layout, strided views of
   a fused (B, S, 3, H, D) projection, and timed with lse at the training
   shape; its registers, spills and shared memory come from the build
   log. First the kernel harness (``ops.validate.validate_kernels``):
   every kernel, the flash backward too, against a float64 oracle at the
   JAX harness's shapes, each shared-memory mirror equal to the kernel's
   own report at every head dim, registers x threads within an SM; a
   row that is not ok fails the phase, and it prints a ``validate: {...}``
   line (each kernel row of the kernels line carries its rows);
4. end to end: the land-cover worker of ``deploy/specs/models.json`` (tile
   256, widths 64..512, buckets 1/16/64, random weights from seed 0) built
   and served by the same ``build_worker``/``serve`` code that
   ``python -m ai4e_tpu_torch worker`` runs, on a loopback port, driven over
   HTTP with sequential sync requests and concurrent async ones. Every
   histogram is checked against the plain ops applied on the card, both
   kernels must equal their plain versions on the served UNet's own logits,
   and each kernel must have launched during the run;
5. end to end: the long-context SeqFormer of ``deploy/specs/models.json``
   (``longcontext``: S 4096, dim 256, depth 4, heads 2, vocab 32768,
   buckets 1/16/64, random weights from seed 0) served the same way, driven
   with sequential sync and concurrent async requests of uint16 token ids.
   Every answer is checked against the same weights run on the card with
   plain full attention, the flash kernel against its plain version on the
   served model's own layer-0 q/k/v, and the kernel must have launched at
   least depth times per executed batch;
5b. separate processes: the port's control plane (``python -m ai4e_tpu_torch
   control-plane``: gateway, task store over HTTP, broker, dispatchers) and
   its worker (``worker --device cuda`` with ``"taskstore"``) as two child
   processes serving land cover and longcontext as in phases 4 and 5, with
   ``deploy/specs/routes.json``'s routes (``autoscale`` included). This
   process drives 4 sync and 64 async requests a model through the gateway
   only, long-polls each task to ``completed`` and reads its result from
   the task store; every answer is checked as in phases 4 and 5, no
   delivery may fail, the worker must log ``cuda``, exit 0 on SIGTERM and
   report each served kernel launched at least once while serving. It
   prints each model's async requests/s, task p50/p95 and sync p50 (as
   the client sees them), 503 redeliveries and batch sizes beside the
   card's name and power limit;
6. train then serve: the flash-attention backward (one C call: the
   preparation pass, the fused bf16 kernel ``flash_bwd_wgmma`` and the dQ
   conversion; CUDA-core kernels for float32) against its plain version on
   the card at the training shape (8, 2, 4096, 128) bf16, at S_q = 129
   and at ragged, causal and cross shapes in both types; under
   ``torch.use_deterministic_algorithms(True)`` (dQ's adds ordered) two
   calls must give bit-equal dq, dk and dv, within the tolerance of the
   plain version, at the training shape and at S = 1000 for every head
   dim, causal and not; the full-width
   SeqFormer's parameter gradients on one training batch with ``flash``
   against ``full`` attention; ``train_longcontext`` (S 4096, dim 256,
   depth 4, heads 2, vocab 32768, batch 8, 200 steps, float32 masters) on
   the card through the forward and the backward, each launched at least
   depth x steps times, with loss, step phases, sequences/s and peak
   memory recorded; ``make_checkpoint``'s ``.npz`` restored by
   ``build_worker`` and served over HTTP, sync and async, on the trainer's
   held-out sequences, whose served accuracy must be at least 0.5 and
   within 2 of 64 sequences of the trainer's eval; then the backward timed
   at the training shape: the whole call by CUDA events, each of its three
   kernels by ``torch.profiler``, with the fused kernel's registers,
   spills and shared memory from the build log, and the whole call and
   the fused kernel again under the deterministic flag
   (``deterministic_ms``);
7. the runtime (phases 4 to 6 already serve through its CUDA graphs, one
   per (model, bucket)): (a) each bucket's replay against an eager call on
   the same batch, with the port's kernels one replay runs counted in a
   ``torch.profiler`` trace and held against the launches the graph adds
   to the counters, and eager against replay ms; (b) land cover with
   pipeline depth 2 and the double buffer under phase 4's requests over
   HTTP, then the async examples submitted to the batcher at once
   (overlap ratio > 0); (c) longcontext reloaded to phase 6's ``.npz`` in
   the middle of an async burst, with the 409 and 403 refusals; (d) a
   derived ladder; (e) a drain under a burst, then resume. It prints a
   ``runtime: {...}`` line;
8. the camera-trap ensemble of ``deploy/specs/models.json``
   (``megadetector``: CenterNet at 512 px, widths 64/128/256, buckets 1/8,
   its crops handed under the same TaskId to ``species``: ResNet at 224
   px, stages 2/2/2, width 32, buckets 1/16/64; random weights from seed
   0): (a) normalize bit for bit at the two models' bucket shapes and a
   5-crop stack, timed at (8, 512, 512, 3) and (64, 224, 224, 3) beside
   its bound and the ``copy_`` yardstick; (b) each bucket's replay
   against eager, with eager and replay ms and the graphs' pool; (c) the
   port's control plane and worker as two child processes with
   routes.json's three camera-trap routes and the spec's ``pipeline_to``
   pointed at the child worker: 32 async ``/detect-async`` requests of
   512 px scenes long-polled to ``completed``, each final result the
   species batch of min(16, detections) crops with no failure, the
   ``?stage=megadetector`` detections held to a recompute on the card with
   the plain normalize (``tests/test_torch_detector.py``'s rule) and every
   species class to a recompute on the port's own crops wherever the
   top-two gap exceeds 1e-2, normalize launched for both models in the
   worker; then a sync batch of 64 crops timed alone and again beside an
   async 64-item stack and 16 interactive species requests (their p50
   printed, checked for completion only). It prints a ``camera_trap:
   {...}`` line;
9. the MoE and ViT families: (a) the flash forward at the moe buckets'
   shapes (1/16/64, 1, 1024, 128) and the backward at its training shape
   (16, 1, 1024, 128) bf16 against their plain versions (phases 3 and 6's
   tolerances; the backward twice under the deterministic flag,
   bit-equal), timed beside SDPA and the bound; (b) ``train_moe`` at JAX's
   recipe geometry (the deployed ``moe`` entry: S 1024, dim 128, depth 2,
   one head, 8 experts, vocab 8192; batch 16, 200 steps, dense dispatch)
   through the flash forward with lse and the backward (each launched at
   least depth x steps times), evaluated with the capacity dispatch and
   saved by ``make_checkpoint`` as ``build/chip_smoke/moe.npz``; (c) that
   ``.npz`` restored into the deployed entry: each bucket's replay against
   eager bit for bit, then served by the port's control plane and worker
   as two child processes with routes.json's two moe routes: 4 sync and
   64 async requests of the trainer's held-out
   sequences, every answer held to the plain ops on the card (full
   attention) as in phase 5, served accuracy at least 0.5 and within 2 of
   64 of the trainer's eval, no failed delivery, at least depth flash
   launches a batch in the worker; it prints a ``moe: {...}`` line; (d)
   ViT-S/16 at ``build_vit``'s defaults (seed-0 weights) through the
   port's worker in process, 4 sync and 64 async float32 images, each class
   held to an eager apply where its top-two gap exceeds 1e-2, each
   bucket's replay bit-equal to eager, timed;
10. the deploy spec as written, from the port's own checkpoints: (a) the
   spec's three image recipes (``landcover``: UNet 64/128/256/512 at tile
   64; ``megadetector`` at 512 px, 300 steps, its batches the recipe's
   own draws made ahead by a child process from the build on
   (``DetectorBatchesAhead``, ``train_megadetector_on``); ``species`` at
   224 px; the two the spec
   does not serve, ``landcover128`` and ``species_fine``, are no longer
   trained here) trained on the card, each to
   ``make_checkpoints.MIN_EVAL`` (0.85) or the phase raises, with its step
   ms split into forward, backward and optimizer, its peak memory, eval
   and the host's share of the loop spent drawing batches, saved by
   ``make_checkpoint`` into ``build/chip_smoke`` beside phases 6 and 9's
   ``.npz`` (the manifest's kwargs held to deploy/specs/models.json's),
   and one land-cover step's device time by kernel (layout copies,
   GroupNorm); (b) the port's control plane and worker as two child
   processes fed deploy/specs/routes.json and models.json as written but
   for the hosts (loopback), ``AI4E_RUNTIME_CHECKPOINT_DIR`` naming that
   directory, so every ``"checkpoint"`` resolves to a trained ``.npz``:
   4 sync and 64 async held-out land-cover tiles at 256 (histograms within
   phase 4's 1% of the plain ops on the trained weights, pixel accuracy at
   least 0.85, both kernels equal to their plain versions on those tiles
   and logits), 64 held-out species images through the async route and
   the batch API (accuracy at least 0.85 and within 2 of 64 of the
   trainer's eval), the trainer's 32 eval scenes through ``detect-async``
   (served detection accuracy within 2 objects of the trainer's, the
   crops handed to species under one TaskId), then a backlog of 1,500
   land-cover tasks, during which the control plane's
   ``ai4e_autoscale_replicas`` for the route must rise above its starting
   4 with decisions counted and no task failed; normalize must launch in
   the worker for all three image models and argmax+histogram for land
   cover. It prints a ``deploy: {...}`` line;
11. observability on the card: phase 10b's control plane and worker again,
   from the same checkpoints, with ``AI4E_PLATFORM_OBSERVABILITY``,
   ``AI4E_OBSERVABILITY_HOP_LEDGER``, ``_VITALS``, spans to a JSONL file
   (``_TRACE_EXPORT_PATH``) and a latency and a goodput SLO on the
   land-cover routes: 4 sync + 64 async land-cover tiles and longcontext
   sequences, 64 async moe sequences, 16 camera-trap scenes. Every task's
   ``?ledger=1`` timeline must hold its hops in order (``admitted`` ...
   ``d2h``, ``completed``; a camera-trap task its ``stage`` handoff and
   the species stage's device events), each device event inside its
   ``batched`` -> ``completed`` span within ``CLOCK_SLACK_S``, ``t`` never
   falling within a hop; the ledgers' backpressure events must equal the
   control plane's ``ai4e_dispatch_total{outcome="backpressure"}`` delta;
   ``trace --url`` must exit 0 and print every hop; a land-cover task's
   gateway, dispatcher and worker spans must share one trace id, each
   the parent of the next; the flight dump, the e2e exemplar, both burn
   rates, the depth gauges and both processes' vitals must be there;
   every answer is checked as in phases 5b, 9c and 10b and each kernel of
   the path must launch in the worker. It prints each model's per-hop
   p50/p95 and an ``observability: {...}`` line with the sync split
   (gateway against the worker's span) and the land-cover async rate with
   spans to the JSONL file (the turns with JAX's tracing defaults and with
   tracing off were cut for the time limit);
12. the streaming LM (``seqformer-lm``) at the widths of the deployed
   SeqFormer (vocab 32768, dim 256, depth 4, 2 heads; ``kv_max_len`` its
   4,096, 64 slots, prompt buckets 1/16/64 and 4,096; seed-0 weights):
   (a) each prefill bucket's CUDA graph and the whole-pool step's against
   an eager run of the module, tokens and caches ``torch.equal``, at that
   geometry and at JAX's verify geometry (vocab 64, max_len 48, dim 32),
   with eager and replay ms; (b) 128 streams (30% of 256 new tokens, the
   rest 8; prompts of 4-1,024 tokens) offered at once to a
   ``DecodeEngine``, continuous and ``continuous=False``: tokens/s, TTFT
   and inter-token p50/p95, step and prefill ms, occupancy and each
   graph's replays, every sequence equal to a plain eager greedy decode
   on the card up to its first top-two logit gap below 1e-3; (c)
   ``build_worker`` serving it over HTTP in process: a ``.npz`` reload
   while 16 streams decode (each re-prefilled, its tokens the old
   weights' before and the new weights' after), then a drain that lets 8
   streams finish, answers 503 and serves again after resume; (d) the
   port's control plane and an LM worker as child processes, 4 stream
   tasks one after another and 64 at once through the gateway, each
   ``completed - N tokens`` with the plain decode's tokens, one ``chunk``
   stamp in its hop ledger, rendered by ``trace``, no failed delivery.
   It prints ``lm 12a``, ``lm 12c``, ``lm 12d`` and ``lm: {...}`` lines;
13. the compressed wires and admission control, from phase 10's
   checkpoints: (a) land cover (256, widths 64..512), megadetector (512)
   and species (224) each on rgb8, yuv420 and dct on one runtime, with
   the C++ host encoders required (``native/*.cpp``, built with the host
   compiler): each wire's bytes per example, every bucket's replay
   against eager (phases 7a and 8b's rules), the decode alone captured
   and ``torch.equal`` to its eager run, replay and decode ms by CUDA
   events, host encode ms (C++ and numpy), and the JAX tests' gates
   (land cover: at most 5% of pixels change class against rgb8; species:
   rgb8's labels on ``species_batch(default_rng(42), 8)``; megadetector:
   rgb8's objects less one on yuv420, and on dct by centre and class, its
   box-extent hits printed); (b) the three models behind the control
   plane (two child processes) with land cover on yuv420, species on dct
   and megadetector on yuv420 handing its crops on: tiles per second and
   task p50/p95 of each, no failed delivery, every handoff under one
   TaskId, the argmax kernel launched on the wire path and normalize on
   none, the served land-cover histograms within 5% of a tile's pixels of
   the rgb8 servable's in this process (the served rgb8 turn was cut for
   the time limit); (c) land cover with ``AI4E_PLATFORM_ADMISSION=1``
   (async backlog 16): 4 waves of 32 sync and 32 async requests in mixed
   priorities, every 4th with a 5 ms deadline (the turn with admission
   off was cut for the time limit): 503/429 counts and their
   Retry-After, expiries by hop, the limit's path, goodput; every
   admitted task terminal, the card's rows plus the batcher's drops
   equal to the examples that entered it, background shed before
   interactive. It prints ``wires 13a``, ``13b``, ``13c`` lines;
14. subscription keys, rate limits and quotas, and the result cache, from
   phases 9 and 10's checkpoints: (a) land cover behind the control plane
   with ``AI4E_GATEWAY_API_KEYS=k-open,k-rate,k-quota``, ``k-rate=20:10``
   and ``k-quota=16/3600``, its worker keyed to the task store with
   ``k-open`` (two child processes): requests without a key and with a
   wrong one all 401, a burst of 64 async tiles under each key (polled
   and fetched under ``k-open``), ``k-open`` never refused, ``k-rate``
   admitted at most its burst plus its refill over the burst plus one,
   ``k-quota`` exactly 16 and 403 after, the card's rows equal to the
   admitted tiles, each key's batches times one replay's launches
   summing to the worker's own count, the worker's reload, drain and
   resume 401 without the key and 200 with it; (b) land cover and moe behind a
   control plane with ``AI4E_PLATFORM_RESULT_CACHE=1`` (a child process)
   and the worker in this process: 8 tiles and 8 sequences, 8 copies
   each, sent at once three times (the third with ``X-Cache-Bypass``),
   then rounds of 16 sync POSTs: the first wave executes exactly 8
   examples a model, the second is all hits with no row and no kernel
   launch, the third executes all 128, the first sync round 8 examples
   and every later one only hits, every hit's and coalesced request's
   result the executed answer byte for byte, no task failed; task
   p50/p95 by ``X-Cache`` outcome, this process's GC pauses and event
   loop stalls a round (the client shares it with the worker), one more
   hit round with a full collection forced in this process as it goes
   out and that collection's ms, the ``ai4e_rescache_*`` series and
   ``request_key``'s ms on a 256 px and a 512 px body; (c)
   ``LocalPlatform(result_cache=True)`` and a worker given its cache in
   this process (reload keyed): the 8 tiles' answers cached under seed-0 weights, land cover reloaded to phase
   10's ``.npz`` (401 without the key): its entries gone, moe's kept, the
   tiles executed again with the trained answers (equal to a bypass
   request's, at least one changed), then a burst across a reload back
   to seed 0 in which no request sent after the 200 gets the old answer.
   It prints ``cache 14a``, ``14b``, ``14c`` lines;
15. C8, result offload, the native cores and the rescue, from phase 10's
   checkpoints: (a) 64 held-out land-cover tiles through
   ``ModelRuntime.run_batch`` at bucket 64, as 4 x 16 and one at a time,
   with the repaired GroupNorm and with the form before it on the same
   weights: tiles whose counts differ between each pair of buckets and
   the largest difference (held to 0.1% of a tile's pixels, ROADMAP C8's
   bound on the card; the first convolution input or output that differs,
   when one does), and
   the bucket-64 replay of both timed in turns beside phase 7a's; (b)
   the three image models of the deploy spec behind the control plane
   (two child processes, the observability layer on), with
   ``AI4E_PLATFORM_RESULT_DIR`` and ``AI4E_SERVICE_RESULT_DIR`` on one
   directory at 96 B with a 15 s terminal retention: 64 async land-cover
   tiles and 16 camera-trap scenes, answers as phase 10b, one ``.bin``
   per result at or over the threshold (none for land cover) holding the
   bytes ``GET /v1/taskstore/result`` serves, the ledger's per-hop
   p50/p95, and the blobs gone after eviction; (c) land cover (4 sync +
   64 async) behind a control plane on the C++ store and broker (the turn
   on the Python ones beside it was cut for the script's time), in front
   of one
   worker: answers as phase 10b, requests/s and task p50/p95, each kernel
   launched; (d) land cover behind a control plane whose reaper
   rescues tasks running 3 s and whose broker dead-letters after 3
   deliveries: the worker SIGKILLed while every unfinished task is
   running, 8 tasks sent while it is down, its restart on the same port,
   ``python -m ai4e_tpu_torch redrive``, every task completed with phase
   10's answer and at least one ``requeued`` rescue a task running at the
   kill. It prints ``c8 15a``, ``offload 15b``, ``cores 15c`` and ``rescue
   15d`` lines;
16. the journaled control plane and its HA pair, land cover from phase
   10's checkpoint: (a) behind one control plane journaled with
   ``AI4E_TASKSTORE_FSYNC=always``, 64 async tiles, the control plane
   SIGKILLed once some tasks are completed and some are not, restarted
   on the same journal: every result read before the kill reads back
   byte-equal, the unfinished tasks are re-seeded (as many as the journal
   holds, read offline) and every task completes with phase 10's answer;
   the kill to the first completion after the restart, the journal's
   stats and fsyncs; (b) a primary and a standby (``replicate_from``,
   failover every 0.5 s, down after 3) with the worker's ``taskstore``
   the pair: 64 tiles, the primary SIGKILLed mid-burst, the standby
   promoted and the worker's store client rotated to it without a
   restart, every task completed with phase 10's answer and each task
   the standby never received (404 there) counted and resubmitted (one
   answered before the kill only if its first record in the primary's
   journal ends past the bytes the standby had absorbed); the
   kill to the promotion and to the first completion, the replication
   lag before the kill; then the old primary restarted from its stale
   config: fenced to the new epoch by the new primary's prober, rejoined
   as its follower, its writes 503 with ``X-Not-Primary``, its journal
   caught up with the new primary's. Normalize and argmax launched in
   each worker. It prints ``restart 16a``, ``failover 16b`` and ``phase
   16`` lines;
17. the sharded task store, land cover from phase 10's checkpoint on one
   worker (a child process, the hop ledger on): (a) behind a control
   plane (a child process, the observability layer on) journaled with
   ``AI4E_PLATFORM_TASK_SHARDS=4`` and one replica a shard (the route at
   routes.json's concurrency, an ``autoscale`` route being refused
   there), behind a 1-shard one, and behind a 4-shard one without
   replicas, one turn each: 64 async tiles
   with long polls each turn, every answer phase 10's, every task's
   ledger whole, the startup line naming the native CRC-32C; on 4 shards
   ``GET /v1/taskstore/shards`` with every shard at epoch 0, a task on
   every shard and each replica at its primary's chain head after the
   burst; tasks/s, task p50/p95, ``published``->``popped`` p50/p95 and
   backpressure redeliveries by turn and their medians by arm;
   (b) a 4-shard journaled control plane served on its own loop in a
   thread of this process: mid-burst, one shard primary killed (on the
   control plane's loop) and a slot holding unfinished tasks moved to a
   third shard (from another thread, under load): every task completed
   with phase 10's answer, none lost, each result read before the kill
   byte-equal after it, the killed shard promoted at the next epoch, the
   moved tasks held by their new owner alone, other shards' tasks
   completing after the kill; the kill to the promotion and to the first
   completion on the killed shard. Normalize and argmax launched in the
   worker. It prints ``shards 17a turn``, ``shards 17b`` and ``phase 17``
   lines.
18. the push transport, weighted canary backends, typed API definitions
   and the request reporter, land cover from phase 10's checkpoint on
   workers A (generation 1) and B (generation 2), each reporting to a
   reporter: (a) control planes in turns queue, push on A alone; (b) one caching control plane fed weighted routes and a
   ``definitions`` route; (c) the reporter sampled through (b)'s burst.
   It prints ``push 18a turn``, ``canary 18b``, ``reporter 18c`` and
   ``phase 18`` lines;
19. resilience and orchestration, land cover from phase 10's checkpoint on
   workers A and B (child processes; SIGUSR1 makes a worker log its
   launches so far, so a killed start is counted too): (a) admission and
   resilience on: B SIGKILLed mid-burst (every task completed with phase
   10's answer, the reaper rescuing what B held; failovers, B's
   ejections and its breaker's opening counted), B restarted (a probe
   closes its breaker, B serves again), A SIGSTOPped for 2 s under sync
   load, A drained under load (ejected, its breaker untouched, nothing
   lost); (b) orchestration, the SLO ladder and the result cache on, A
   the cheap tier: 5 ms deadlines climb the degradation ladder to
   ``shed_default`` (background refused ``brownout at <hop>``, a cached
   tile still answered), the idle platform steps it back to ``normal``,
   each step's time from the control plane's log; deadline-free tasks
   all placed on A; A killed, deadline tasks go to B; A restarted, one
   ``probe`` stamp; (c) deploy/specs/routes.json as written on a 4-shard
   store with orchestration (a ``ShardedAutoscaleController`` a
   ``autoscale`` route), a backlog until one meets a tick (the raw-depth
   turn on one store beside it was cut for the script's time): the first
   scale-up,
   ``published``->``popped`` p50/p95, no failed task. Normalize and argmax launched in every worker start
   that served. It prints ``19a``, ``19b``, ``scale 19c`` and ``phase 19``
   lines.
20. tenancy and pipeline DAGs: (a) on phase 19's workers, a control plane
   with admission, resilience, orchestration (A cheap) and tenancy
   (``noisy`` weight 1, ``alpha`` 4, ``beta`` 1 at 5 rps, burst 5; label
   top-2): noisy's 192 tiles, alpha's 32 just after, beta's 32, every
   admitted task with phase 10's answer, alpha's p50 below noisy's, beta
   refused past its bucket with 429 and ``tenant-quota at gateway``,
   each label's outcomes and cost against its completions and its
   deliveries by host; the same with tenancy off, alpha's p50 beside;
   (b) the DAG ``survey`` (land cover and species, both sinks of the
   original PNG) on a pipeline platform with the result cache in this
   process, over 16 512² scenes: every root the multi-sink document,
   each part its ``?stage=`` result and within the models' own routes'
   answers, each task's SSE events in order (half attached at once,
   half after completion), the repeat wave from the stage cache with no
   launch, the bypass wave run again. The LM's token chunks (20c) run in
   phase 12 as 12e: 32 stream tasks through a pipeline platform's
   gateway, chunks equal to the stored tokens, a late replay truncated,
   a one-stage DAG's chunks under its root id. It prints ``tenancy
   20a``, ``dag 20b``, ``lm 12e`` and ``phase 20`` lines;
21. chaos, the load client, the fleet view and the timeline, on phase
   19's workers A and B, in this process: (a) 64 held-out tiles through
   ``tests/test_chaos.py``'s platform config at worker A, a clean turn,
   then one under seeded 5xx, lost responses, refused connections,
   latency and duplicate publishes with the dispatcher killed and
   restarted: 5xx, lost responses and duplicate publishes each drawn,
   zero invariant violations, every answer within ``C8_CARD_BOUND`` of
   the clean turn's, normalize and argmax launched;
   (b) the port's open loop (48 tiles/s) and closed loop (16 in flight)
   on a clean platform; (c) a ``FleetCollector`` over the control plane
   and both workers and ``top --once`` as a child process naming all
   three with a request rate on A; (d) ``timeline`` as a child process
   over (a)'s ledgers and chaos times, one slice a task and both
   instants. It prints ``chaos 21a``, ``load 21b``, ``fleet 21c``,
   ``timeline 21d`` and ``phase 21`` lines;
22. the parallel plane on the one card, two ``torch.distributed`` ranks
   over gloo: (a) in two ranks this script starts as ``chip_smoke.py
   --mesh-rank``, ring and Ulysses attention at longcontext's width (8, 2,
   4096, 128) bf16, sp=2, causal and not, each rank's output chunk held
   against one device's flash kernel and the plain version on the whole
   sequence (within ``MESH_OUT_TOL`` flash tolerances), the flash launches
   a call counted from 0 (a ring call 2 a rank, r + 1 causal; Ulysses 1),
   ms and host-copy bytes a call; (c) in the same ranks, the deployed
   longcontext at sp=2, moe at ep=2 and ViT-S/16 at tp=2, forward only,
   eager, against one device's graphs (logits within
   ``MESH_LOGIT_ATOL``, classes where the top two are apart); (b) the
   control plane and a two-rank sp=2 longcontext worker (``--device
   cuda``, ``AI4E_RUNTIME_MESH_SPEC=sp=2``) as child processes, 4 sync
   and 32 async requests through the gateway against one device's
   answers, ``/v1/models``' mesh entry, the follower out on the shutdown
   sentinel; (d) training over the mesh, in the same two ranks after
   (c): ViT-S/16 with a float32 body at tp=2, three steps on one seeded
   batch, losses within ``MESH_TRAIN_RTOL`` of one device's ``Trainer``
   in rank 0, the second below the first, the qkv and out shards and
   their AdamW moments half-width; longcontext at its deployed width
   (bf16 body, float32 masters, flash) at dp=2, three steps on 8 seeded
   sequences (4 a rank), parameters bit-equal on both ranks after every
   step (sha256), losses within ``LC_TRAIN_RTOL`` of one device's on the
   whole batch, the flash forward and backward launched depth times a
   rank a step; the ViT saved by ``save_trainer`` after its third step
   (rank 0 writes ``build/chip_smoke/mesh_ckpt/3``), a fourth step in the
   ranks, then this process resumes the checkpoint into a one-device
   ``Trainer`` on the card: step 3, params and moments bit-equal to the
   gathered ones, the next loss within ``MESH_TRAIN_RTOL`` of the ranks'
   fourth; (e) training under sp and ep, in the same two ranks after
   (d): longcontext at its deployed width at sp = 2, three steps with ring
   and three with Ulysses attention on 8 seeded sequences (the whole
   batch on each rank), and the deployed MoE (capacity dispatch) at
   ep = 2, three steps on 16, every turn and its reference under the
   deterministic flag: the replicated parameters bit-equal on both
   ranks after every step, losses within ``SP_TRAIN_RTOL`` (longcontext)
   and ``EP_TRAIN_RTOL`` (the MoE) of one device's on the whole batch,
   each rank's flash forward and backward launches and collectives a step
   as predicted (``SP_EP_LAUNCHES``, ``SP_EP_CALLS``), host-copy bytes and
   step ms recorded. It prints ``mesh 22a``, ``mesh 22c``, ``mesh 22d``,
   ``mesh 22e``, ``mesh 22b`` and ``mesh`` lines and adds the ring's
   launches and ms and (d)'s and (e)'s launches a step to the flash rows;
23. the multi-process rig (no model, no kernel: its worker is the CPU
   echo worker, as in JAX's), ``python -m ai4e_tpu_torch.rig up`` as a
   child process on a block of 100 free ports, each run under its own
   wall-clock limit: (a) 2 gateways, 2 shards with a replica each, one
   dispatcher, worker and loadgen, seed 20260803, 8 s of load with the
   seeded chaos timeline (gateway kill, dispatcher kill, ``move_slot``,
   shard-primary SIGKILL), the verdict ``ok`` with every fault fired,
   and one ``top --once --spec`` frame naming every role while the fleet
   is up; (b) ``make upgrade``'s bad-canary rollout (``--no-chaos
   --rollout bad-canary --rollout-steps 25,50,100``): rolled back before
   the canary's share passes 50%, ``rollback`` stamps on the marker
   task's ledger, the rollout gate ok. It prints ``rig 23a``, ``rig 23b``
   and ``rig`` lines;
24. the examples on the port (``python -m ai4e_tpu_torch.examples.<name>``)
   as child processes, the three parts at once: (a) the echo service, one
   sync and one async request, then SIGTERM and exit 0; (b) one task
   through the async platform to ``completed``, then the load generator
   against it for 2 s (no failed task, no client error); (c) the
   streaming pipeline's two LMs on the card: both stages' chunks, each
   before its stage's completion, then the terminal line. It prints an
   ``examples`` line.

Phases 2-6 run alone, so the kernels are timed on an otherwise idle card.
Then two streams of phases share the card: this process runs 7-11, 13, 15
and 16, while a child process (``SECOND_STREAM``) runs 5b, 12, 22, 23
and 24, and then, once phase 10 hands its checkpoints
over, 14 and 17-21. Its lines come through this process's output, and a
failure in either stream fails the script. Device times read in phases
7-24 are read beside the other stream's work.

Every process the script starts is stopped before it ends: each phase
stops its own children, SIGTERM ends the run through those same paths, and
the script and the second stream, each the subreaper of its descendants,
SIGKILL and reap whatever is still below them at the end and print it. A
``seconds: {...}`` line gives each phase's wall seconds, the second
stream's phases and the whole script's; each phase's end also goes to
standard error with the seconds since the start. The last two lines of
output are the kernels' JSON record and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
N_SYNC = 8
N_ASYNC = 192
COUNT_TOLERANCE = 0.01      # per-class share of a tile's pixels, see phase 4
FLASH_SERVED = (64, 2, 4096, 128)  # bucket 64 of longcontext, one layer
PLAIN_CHUNK = 8                    # sequences per plain-version call
N_LC_SYNC = 4
N_LC_ASYNC = 64
N_TOPO_SYNC = 4
N_TOPO_ASYNC = 64
TOPOLOGY_MODELS = ("landcover", "longcontext")  # routes /v1/<model>/...
TOPOLOGY_RETRY_DELAY = 0.05  # s; the platform's default of 60 s is for a fleet
LC_GAP = 1e-2    # class must agree where the reference's top-two gap exceeds it
LC_CONF_ATOL = 1e-2
BWD_TRAIN = (8, 2, 4096, 128)  # a longcontext training batch, one layer
# Largest relative gap, ||g_flash - g_full|| / ||g_full||, allowed between a
# parameter's gradient through the flash kernels and through plain full
# attention (which takes its softmax in bf16) on one training batch.
MODEL_GRAD_RTOL = 5e-2
N_TRAIN_SYNC = 4
SERVED_ACC_SLACK = 2  # of 64 held-out sequences: bucket shapes differ
MIN_SERVED_ACC = 0.5  # eight times chance (1/16)


CARD: dict = {}  # the card's nvidia-smi name and power limit (phase 1)


LOG_LOCK = threading.Lock()  # log() runs in the second stream's echo too


def log(msg: str) -> None:
    with LOG_LOCK:
        sys.stdout.write(msg + "\n")
        sys.stdout.flush()


# -- timing --------------------------------------------------------------


def device_ms(fn, reps: int = 25) -> float:
    """Median device time of one ``fn()`` call, in ms. A spin kernel keeps
    the card busy while the host enqueues ``fn``'s launches, so the events
    bracket device work only, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 1: device -----------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    CARD["smi"] = smi
    log(smi)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    return kind


# -- phase 2: build ------------------------------------------------------


def phase_build() -> None:
    from ai4e_tpu_torch.ops import _native

    t0 = time.perf_counter()
    per_source = _native.build()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in per_source.items())})")
    for name in _native.SOURCES:
        for line in _native.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# -- phase 3: kernels ----------------------------------------------------


def check_normalize(shape, mean, std, gen, misaligned=False) -> float:
    """The kernel equals the plain version bit for bit (``torch.equal``);
    ``misaligned`` takes a view one byte into its storage."""
    from ai4e_tpu_torch.ops import image_preprocess as ip

    n = int(np.prod(shape))
    flat = torch.randint(0, 256, (n + int(misaligned),), dtype=torch.uint8,
                         generator=gen).cuda()
    x = flat[int(misaligned):].view(shape)
    got = ip.normalize_image(x, mean, std)
    scale, bias = ip.channel_affine(mean, std, shape[-1])
    want = ip.normalize_image_plain(x, scale, bias)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != torch.float32:
        raise AssertionError(f"normalize {shape}: {got.shape} {got.dtype}")
    if not torch.equal(got, want):
        raise AssertionError(f"normalize {shape}: {int((got != want).sum())} "
                             f"of {n} differ from the plain version")
    log(f"  normalize {tuple(shape)}{' misaligned' if misaligned else ''}: "
        f"exact")
    return float((got - want).abs().max())


def plant_ties_and_nans(logits: torch.Tensor, gen) -> torch.Tensor:
    """Ties between classes 0/1 and 2/3, a NaN at class 0 (wins) and NaNs
    at classes 1..3 (never win), on random pixels."""
    b, h, w, c = logits.shape
    flat = logits.view(-1, c)
    idx = torch.randperm(flat.shape[0], generator=gen)[:4 * 997]
    ties0, ties2, nan0, nan_rest = idx.view(4, -1)
    flat[ties0, 1] = flat[ties0, 0]
    flat[ties2, 3] = flat[ties2, 2]
    flat[nan0, 0] = float("nan")
    flat[nan_rest, 1 + torch.arange(len(nan_rest)) % (c - 1)] = float("nan")
    return logits


def check_seg(shape, dtype, with_classmap, gen, plant=False) -> float:
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    logits = torch.randn(shape, generator=gen)
    if plant:
        plant_ties_and_nans(logits, gen)
    logits = logits.to(dtype).cuda()
    got = sp.fused_seg_postprocess(logits, with_classmap=with_classmap)
    want = sp.fused_seg_postprocess_plain(logits, with_classmap=with_classmap)
    torch.cuda.synchronize()
    if set(got) != set(want):
        raise AssertionError(f"seg {shape}: keys {set(got)} != {set(want)}")
    for key in want:
        if not torch.equal(got[key], want[key]):
            bad = int((got[key] != want[key]).sum())
            raise AssertionError(f"seg {shape} {dtype} {key}: {bad} differ")
    if int(got["counts"].sum()) != shape[0] * shape[1] * shape[2]:
        raise AssertionError(f"seg {shape}: counts do not sum to B*H*W")
    log(f"  seg {tuple(shape)} {str(dtype)[6:]} classmap={with_classmap}"
        f"{' ties+NaN' if plant else ''}: exact")
    return 0.0


#: ``validate_kernels()``'s rows that each kernel of the kernels line
#: carries (phase 3's harness).
VALIDATED = {"normalize_image": ("normalize_image",),
             "fused_seg_postprocess": ("segmentation_argmax",),
             "flash_attention": ("flash_attention", "flash_attention_bf16"),
             "flash_attention_bwd": ("flash_attention_bwd",
                                     "flash_attention_bwd_bf16")}
VALIDATE: dict = {}  # phase 3's validate_kernels() result


def phase_validate() -> dict:
    """The kernel harness (``ops.validate.validate_kernels``): every kernel
    against a float64 oracle at the JAX harness's shapes, each
    shared-memory mirror against the kernel's own report, registers x
    threads within an SM. Prints the ``validate`` line; raises unless
    every row is ok."""
    from ai4e_tpu_torch.ops.validate import validate_kernels

    t0 = time.perf_counter()
    result = validate_kernels()
    result["seconds"] = time.perf_counter() - t0
    log(f"validate: {json.dumps(result)}")
    bad = [k for k, v in result.items() if isinstance(v, dict)
           and v.get("ok") is False]
    bad += [k for k, v in result["smem_mirrors"].items() if not v["ok"]]
    if bad or not result["all_ok"]:
        raise AssertionError(f"validate: not ok: {bad}")
    VALIDATE.update(result)
    return result


def phase_kernels() -> list[dict]:
    from ai4e_tpu_torch.ops import image_preprocess as ip
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    phase_validate()
    gen = torch.Generator().manual_seed(SEED)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    norm_err = max(
        [check_normalize((b, 256, 256, 3), None, None, gen)
         for b in (1, 16, 64)]
        + [check_normalize((64, 256, 256, 3), mean, std, gen),
           check_normalize((3, 250, 250, 3), mean, std, gen),
           check_normalize((1, 7, 5, 3), mean, std, gen),  # n % 16 != 0
           check_normalize((2, 31, 29, 3), mean, std, gen, misaligned=True)]
        + [check_normalize((2, 33, 17, c), tuple(np.linspace(0.1, 0.8, c)),
                           tuple(np.linspace(0.2, 0.9, c)), gen)
           for c in (1, 4, 8)])
    seg_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for with_map in (False, True):
            seg_err = max(seg_err, check_seg((64, 256, 256, 4), dtype,
                                             with_map, gen))
            seg_err = max(seg_err, check_seg((3, 250, 250, 4), dtype,
                                             with_map, gen, plant=True))

    # Timing at the served shapes: bucket 64, default mean/std, counts only.
    x = torch.randint(0, 256, (64, 256, 256, 3), dtype=torch.uint8,
                      generator=gen).cuda()
    scale, bias = ip.channel_affine(None, None, 3)
    n = x.numel()
    norm_bound, norm_by = bound_ms(n * 1 + n * 4, 2 * n)
    norm = {
        "name": "normalize_image",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/image_preprocess.cu",
        "replaces": "ai4e_tpu/ops/pallas/image_preprocess.py:24 "
                    "(_normalize_kernel)",
        "shape": [64, 256, 256, 3],
        "ms": device_ms(lambda: ip.normalize_image(x)),
        "plain_ms": device_ms(lambda: ip.normalize_image_plain(x, scale, bias)),
        # No single PyTorch call widens uint8 and applies a per-channel
        # affine: the plain version is already the shortest library form.
        "library_ms": None,
        # Bandwidth yardstick, another function: one PyTorch call that
        # widens the same uint8 tensor and moves the same bytes, no affine.
        "copy_yardstick_ms": device_ms(lambda: torch.empty(
            x.shape, dtype=torch.float32, device=x.device).copy_(x)),
        "bound_ms": norm_bound,
        "bound_by": norm_by,
        "max_abs_err": norm_err,
    }
    logits = torch.randn((64, 256, 256, 4), generator=gen).cuda()
    b, h, w, c = logits.shape
    seg_bound, seg_by = bound_ms(logits.numel() * 4 + b * c * 4,
                                 b * h * w * (c - 1))
    seg = {
        "name": "fused_seg_postprocess",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/seg_postprocess.cu",
        "replaces": "ai4e_tpu/ops/pallas/seg_postprocess.py:34 "
                    "(_argmax_kernel; with class_histogram :74)",
        "shape": [64, 256, 256, 4],
        "ms": device_ms(
            lambda: sp.fused_seg_postprocess(logits, with_classmap=False)),
        "plain_ms": device_ms(
            lambda: sp.fused_seg_postprocess_plain(logits, with_classmap=False)),
        # Yardstick only (argmax without the histogram); the port never
        # calls it, since torch.argmax lets a NaN win.
        "library_ms": device_ms(lambda: torch.argmax(logits, dim=-1)),
        "bound_ms": seg_bound,
        "bound_by": seg_by,
        "max_abs_err": seg_err,
    }
    for k in (norm, seg):
        log(f"  {k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} "
            f"ms, library {k['library_ms']} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']})")
    log(f"  normalize_image: copy_ yardstick {norm['copy_yardstick_ms']:.4f} ms")
    return [norm, seg]


def flash_plain_chunked(q, k, v, causal=False, return_lse=False):
    """The flash kernel's plain version, PLAIN_CHUNK sequences at a time:
    its float32 scores of the whole served batch would take 8.6 GB."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention_plain

    outs = [flash_attention_plain(q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK],
                                  v[i:i + PLAIN_CHUNK], causal, return_lse)
            for i in range(0, q.shape[0], PLAIN_CHUNK)]
    if return_lse:
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def flash_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max error in units of the kernel's tolerance,
    ``ops.flash_attention.tolerance``)."""
    from ai4e_tpu_torch.ops.flash_attention import tolerance

    err = (got.float() - want.float()).abs()
    return float(err.max()), float((err / tolerance(want)).max())


def check_flash(q, k, v, causal: bool, what: str) -> tuple[float, float]:
    """The flash kernel against its plain version on the same tensors;
    returns (output, lse) max abs errors."""
    from ai4e_tpu_torch.ops.flash_attention import LSE_ATOL, flash_attention

    got, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want, want_lse = flash_plain_chunked(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != q.dtype:
        raise AssertionError(f"flash {what}: {got.shape} {got.dtype}")
    err, of_tol = flash_err(got, want)
    lse_err = float((lse - want_lse).abs().max())
    if not (of_tol <= 1 and lse_err <= LSE_ATOL):
        raise AssertionError(f"flash {what}: max abs err {err} ({of_tol:.3g} "
                             f"of the tolerance), lse {lse_err} (tolerance "
                             f"{LSE_ATOL})")
    log(f"  flash {what}: max abs err {err:.3g} ({of_tol:.3g} of the "
        f"tolerance), lse {lse_err:.3g} (tolerance {LSE_ATOL})")
    return err, lse_err


def flash_kernel_report(kernel: str = "flash_fwd_wgmma") -> dict:
    """A Hopper flash kernel (``kernel``) at each head dim, from ``nvcc
    -Xptxas -v``: registers a thread (the launch bound's cap; the consumer
    warpgroups raise theirs with setmaxnreg) and spill bytes, beside its
    dynamic shared memory a CTA (the kernel's own report,
    ``ops.validate.flash_attrs``). A second instantiation on a bool (the
    backward's ordered dQ) reports under its head dim's ``"ordered"``."""
    import re

    from ai4e_tpu_torch.ops import _native
    from ai4e_tpu_torch.ops.validate import flash_attrs

    report, cur = {}, None
    for line in _native.build_log("flash_attention").splitlines():
        if "Compiling entry function" in line:
            found = re.search(kernel + r"ILi(\d+)E(?:Lb([01])E)?", line)
            cur = None
            if found:
                d = int(found.group(1))
                cur = report.setdefault(d, {})
                if found.group(2) == "1":
                    cur = cur.setdefault("ordered", {})
                else:
                    cur["smem_bytes"] = flash_attrs(
                        kernel, d)["dynamic_smem_bytes"]
        elif cur is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            cur["spill_bytes"] = int(stores) + int(loads)
        elif cur is not None and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
    if sorted(report) != [16, 32, 64, 128]:
        raise AssertionError(f"{kernel} missing from the build log: "
                             f"{sorted(report)}")
    return report


def phase_flash() -> dict:
    """Flash attention: parity at the served shape (contiguous and as the
    served model's strided view of its fused projection), at ragged and
    cross shapes in both types, causal and not; then timing at the served
    shape in both layouts and, with lse, at the training shape."""
    import torch.nn.functional as F

    from ai4e_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def qkv(b, h, s_q, s_k, d, dtype):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(dtype) for s in (s_q, s_k, s_k))

    errs = []
    b, h, s, d = FLASH_SERVED
    served = qkv(b, h, s, s, d, torch.bfloat16)
    errs.append(check_flash(*served, False, f"served {FLASH_SERVED} bf16"))
    fused = torch.randn((b, s, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    strided = tuple(fused[:, :, i].transpose(1, 2) for i in range(3))
    errs.append(check_flash(*strided, False,
                            f"served {FLASH_SERVED} bf16, (B, S, 3, H, D) view"))
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            errs.append(check_flash(
                *qkv(2, 3, 1000, 1000, 64, dtype), causal,
                f"(2, 3, 1000, 64) {str(dtype)[6:]} causal={causal}"))
        errs.append(check_flash(*qkv(2, 3, 192, 320, 64, dtype), False,
                                f"cross 192x320 d64 {str(dtype)[6:]}"))

    q, k, v = served
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read, out written
    flops = 4 * b * h * s * s * d              # QK^T and PV, non-causal
    bound, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    b8 = BWD_TRAIN[0]
    flash = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ai4e_tpu/ops/pallas/flash_attention.py:73 "
                    "(_flash_kernel)",
        "shape": list(FLASH_SERVED),
        "ms": device_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": device_ms(lambda: flash_plain_chunked(q, k, v), reps=5),
        # Yardstick only: the port never calls it.
        "library_ms": device_ms(
            lambda: F.scaled_dot_product_attention(q, k, v)),
        "bound_ms": bound,
        "bound_by": by,
        "bound_peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s",
        "max_abs_err": max(e for e, _ in errs),
        "lse_max_abs_err": max(e for _, e in errs),
        # The served model's own layout, and the training step's call.
        "strided_ms": device_ms(lambda: flash_attention(*strided)),
        "lse_train_shape": list(BWD_TRAIN),
        "lse_train_ms": device_ms(lambda: flash_attention(
            q[:b8], k[:b8], v[:b8], return_lse=True)),
        "ptxas": flash_kernel_report(),
    }
    flash["tflops"] = flops / flash["ms"] / 1e9
    flash["strided_tflops"] = flops / flash["strided_ms"] / 1e9
    flash["lse_train_tflops"] = flops * b8 / b / flash["lse_train_ms"] / 1e9
    log(f"  flash_attention {FLASH_SERVED} bf16: kernel {flash['ms']:.4f} ms "
        f"({flash['tflops']:.1f} TFLOP/s), (B, S, 3, H, D) view "
        f"{flash['strided_ms']:.4f} ms ({flash['strided_tflops']:.1f} "
        f"TFLOP/s), plain {flash['plain_ms']:.4f} ms, library (SDPA) "
        f"{flash['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    log(f"  flash_attention {BWD_TRAIN} bf16 with lse: "
        f"{flash['lse_train_ms']:.4f} ms ({flash['lse_train_tflops']:.1f} "
        f"TFLOP/s)")
    for dd, rep in sorted(flash["ptxas"].items()):
        log(f"  flash_fwd_wgmma D={dd}: {rep['registers']} registers, "
            f"{rep['spill_bytes']} spill bytes, {rep['smem_bytes']} bytes "
            f"of shared memory a CTA")
    return flash


# -- phase 4: end to end -------------------------------------------------


def landcover_spec() -> dict:
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = dict(next(m for m in spec["models"] if m["name"] == "landcover"))
    model.pop("checkpoint")  # no weights in the repository: seed-0 random
    return {"service_name": spec["service_name"], "prefix": spec["prefix"],
            "models": [model]}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def reference_counts(servable, images: np.ndarray) -> np.ndarray:
    """The served function on the card through the plain ops, in batches
    of the largest bucket."""
    from ai4e_tpu_torch.ops.image_preprocess import (channel_affine,
                                                     normalize_image_plain)
    from ai4e_tpu_torch.ops.seg_postprocess import fused_seg_postprocess_plain

    scale, bias = channel_affine(None, None, 3)
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), servable.max_bucket):
            x = torch.from_numpy(images[i:i + servable.max_bucket]).cuda()
            logits = servable.module(normalize_image_plain(x, scale, bias))
            out.append(fused_seg_postprocess_plain(
                logits, with_classmap=False)["counts"].cpu().numpy())
    return np.concatenate(out)


def check_served_logits(servable, images: np.ndarray) -> None:
    """Both kernels against their plain versions on what the served path
    feeds them for one largest-bucket batch: the uint8 tiles, then the
    UNet's own float32 logits of those tiles. Exact."""
    from ai4e_tpu_torch.ops import image_preprocess as ip
    from ai4e_tpu_torch.ops import seg_postprocess as sp

    x = torch.from_numpy(images[:servable.max_bucket]).cuda()
    scale, bias = ip.channel_affine(None, None, 3)
    with torch.inference_mode():
        normalized = ip.normalize_image(x)
        if not torch.equal(normalized, ip.normalize_image_plain(x, scale, bias)):
            raise AssertionError("normalize differs on the served tiles")
        logits = servable.module(normalized)
        got = sp.fused_seg_postprocess(logits, with_classmap=True)
        want = sp.fused_seg_postprocess_plain(logits, with_classmap=True)
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"seg {key} differs on the served logits")
    log(f"e2e: kernels equal their plain versions on the served "
        f"{tuple(logits.shape)} {logits.dtype} logits")


def check_histogram(result: dict, want: np.ndarray, pixels: int) -> int:
    """Served JSON against reference counts: same schema, zero classes left
    out, sum == H*W; returns the largest per-class difference."""
    hist = {int(k): v for k, v in result["class_histogram"].items()}
    if set(result) != {"class_histogram"}:
        raise AssertionError(f"response keys {set(result)}")
    if sum(hist.values()) != pixels or 0 in hist.values():
        raise AssertionError(f"histogram {hist} does not cover {pixels} px")
    got = np.array([hist.get(c, 0) for c in range(len(want))])
    diff = int(np.abs(got - want).max())
    # bf16 logits of one tile depend on cuDNN's algorithm for the batch
    # shape it rode in, so a near-tie pixel can flip class: allow 1%.
    if diff > COUNT_TOLERANCE * pixels:
        raise AssertionError(f"histogram {got} vs reference {want}")
    return diff


OCTET = {"Content-Type": "application/octet-stream"}


@contextlib.asynccontextmanager
async def serving(worker, batcher, port: int):
    """``serve`` ``worker`` on a loopback port until the block ends; yields
    an HTTP session and the service's base URL, once it answers."""
    import aiohttp

    from ai4e_tpu_torch.cli import serve

    stop = asyncio.Event()
    server = asyncio.create_task(serve(worker, batcher, "127.0.0.1", port, stop))
    base = f"http://127.0.0.1:{port}/{worker.service.prefix.strip('/')}"
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            for _ in range(100):
                try:
                    async with http.get(base + "/") as r:
                        if r.status == 200:
                            break
                except aiohttp.ClientConnectionError:
                    pass
                await asyncio.sleep(0.05)
            yield http, base
    finally:
        stop.set()
        await server


async def submit_task(http, url: str, body: bytes) -> tuple[str, int]:
    """POST ``body`` to an async path, again after each 503; returns the
    task id and the 503s met."""
    retries = 0
    while True:
        async with http.post(url, data=body, headers=OCTET) as r:
            if r.status == 503:
                retries += 1
                await asyncio.sleep(0.02)
                continue
            if r.status != 200:
                raise AssertionError(f"async {r.status}: {await r.text()}")
            return (await r.json())["TaskId"], retries


async def await_task(http, base: str, task_id: str, done: str) -> str:
    """Poll a task until it completes (its status must be ``done``);
    raises if it fails."""
    while True:
        async with http.get(f"{base}/task/{task_id}") as r:
            status = (await r.json())["Status"]
        if status.startswith("completed"):
            if status != done:
                raise AssertionError(status)
            return task_id
        if status.startswith("failed"):
            raise AssertionError(f"task {task_id}: {status}")
        await asyncio.sleep(0.01)


async def post_sync(http, url: str, body: bytes) -> dict:
    async with http.post(url, data=body, headers=OCTET) as r:
        if r.status != 200:
            raise AssertionError(f"sync {r.status}: {await r.text()}")
        return await r.json()


async def drive(worker, batcher, port: int, bodies: list[bytes], n_sync: int,
                route: tuple[str, str, str], kernels: dict) -> dict:
    """Serve ``worker`` on a loopback port and post ``bodies`` to it
    (``post_requests``)."""
    async with serving(worker, batcher, port) as (http, base):
        return await post_requests(http, base, worker, bodies, n_sync, route,
                                   kernels)


async def post_requests(http, base: str, worker, bodies: list[bytes],
                        n_sync: int, route: tuple[str, str, str],
                        kernels: dict) -> dict:
    """Post ``bodies`` to the served ``worker`` at ``base``: the first
    ``n_sync`` one after another to the sync path, the rest at once to the
    async path, each polled until its status reads ``done``. ``route`` is
    (sync path, async path, done); ``kernels`` maps each kernel's name to
    the module holding its launch count, set to 0 just before the requests
    and read just after."""
    sync_path, async_path, done = route
    for module in kernels.values():
        module.launches = 0
    sync_ms, sync_results = [], []
    for body in bodies[:n_sync]:
        t0 = time.perf_counter()
        sync_results.append(await post_sync(http, base + sync_path, body))
        sync_ms.append((time.perf_counter() - t0) * 1e3)

    async def one_async(body: bytes) -> tuple[str, int]:
        task_id, retries = await submit_task(http, base + async_path, body)
        await await_task(http, base, task_id, done)
        return task_id, retries

    t0 = time.perf_counter()
    tasks = await asyncio.gather(*(one_async(b) for b in bodies[n_sync:]))
    async_s = time.perf_counter() - t0
    launches = {name: module.launches for name, module in kernels.items()}
    async with http.get(base + "/models") as r:
        listing = await r.json()
    async with http.get(base[:base.index("/", len("http://"))]
                        + "/metrics") as r:
        metrics_text = await r.text()
    async_results = [json.loads(worker.store.get_result(t)[0])
                     for t, _ in tasks]
    return {"sync_ms": sync_ms, "sync_results": sync_results,
            "async_results": async_results, "async_s": async_s,
            "retries_503": sum(r for _, r in tasks), "launches": launches,
            "listing": listing, "metrics": metrics_text}


def batches_over(metrics_text: str, size: int) -> int:
    """Executed batches with more than ``size`` examples, from the
    ``ai4e_batch_size`` histogram of the worker's /metrics."""
    total = above = 0
    for line in metrics_text.splitlines():
        if line.startswith("ai4e_batch_size_bucket"):
            le = line.split('le="')[1].split('"')[0]
            count = int(float(line.rsplit(" ", 1)[1]))
            if le != "+Inf" and float(le) <= size:
                above = max(above, count)  # cumulative count up to ``size``
            if le == "+Inf":
                total = count
    return total - above


def phase_end_to_end() -> dict:
    from ai4e_tpu_torch.cli import build_worker

    spec = landcover_spec()
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(spec, device="cuda")
    log(f"e2e: worker built and warmed (buckets 1/16/64) in "
        f"{time.perf_counter() - t0:.1f}s")
    servable = worker.runtime.models["landcover"]
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (N_SYNC + N_ASYNC, 256, 256, 3), np.uint8)
    from ai4e_tpu_torch.ops import image_preprocess, seg_postprocess

    out = asyncio.run(drive(
        worker, batcher, free_port(), [npy_bytes(img) for img in images],
        N_SYNC, ("/classify", "/classify-async", "completed - class_histogram"),
        {"normalize_image": image_preprocess,
         "fused_seg_postprocess": seg_postprocess}))

    check_served_logits(servable, images)
    want = reference_counts(servable, images)
    pixels = 256 * 256
    diffs = [check_histogram(r, want[i], pixels)
             for i, r in enumerate(out["sync_results"] + out["async_results"])]
    exact = sum(d == 0 for d in diffs)
    big = batches_over(out["metrics"], 16)
    if big < 1:
        raise AssertionError("no batch reached bucket 64")
    for name, n in out["launches"].items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if [m["name"] for m in out["listing"]["models"]] != ["landcover"]:
        raise AssertionError(f"/models: {out['listing']}")

    _, _, phases = worker.runtime.run_batch_phases(
        "landcover", np.zeros((64, 256, 256, 3), np.uint8))
    e2e = {
        "sync_p50_ms": statistics.median(out["sync_ms"]),
        "async_tiles_per_s": N_ASYNC / out["async_s"],
        "async_requests": N_ASYNC,
        "retries_503": out["retries_503"],
        "batches_in_bucket_64": big,
        "histograms_exact": f"{exact}/{len(diffs)}",
        "max_count_diff_px": max(diffs),
        "bucket64_phases_ms": {k: v * 1e3 for k, v in phases.items()},
        "launches": out["launches"],
    }
    log(f"e2e: {json.dumps(e2e)}")
    return e2e


# -- phase 5: long-context end to end ------------------------------------


def longcontext_spec() -> dict:
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = dict(next(m for m in spec["models"] if m["name"] == "longcontext"))
    model.pop("checkpoint")  # no weights in the repository: seed-0 random
    return {"service_name": spec["service_name"], "prefix": spec["prefix"],
            "models": [model]}


def reference_logits(servable, config: dict, seqs: np.ndarray) -> np.ndarray:
    """The served weights on the card with plain full attention, 16
    sequences at a time."""
    from ai4e_tpu_torch.models import create_seqformer

    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_classes",
            "vocab_size")
    ref = create_seqformer(**{k: config[k] for k in keys}, attention="full",
                           device="cuda")
    ref.load_state_dict(servable.module.state_dict())
    with torch.inference_mode():
        return torch.cat([
            ref(torch.from_numpy(seqs[i:i + 16].astype(np.int32)).cuda())
            for i in range(0, len(seqs), 16)]).cpu().numpy()


def check_served_attention(servable, seqs: np.ndarray) -> float:
    """The flash kernel against its plain version on what the served model
    feeds its first layer for one largest-bucket batch; returns the max abs
    error."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention

    module = servable.module
    block = module.blocks[0]
    with torch.inference_mode():
        x = torch.from_numpy(seqs[:servable.max_bucket].astype(np.int32)).cuda()
        h = module.embed(x) + module.pos_emb
        b, s, dim = h.shape
        heads = block.attn.heads
        qkv = block.attn.qkv(block.ln1(h)).view(b, s, 3, heads, dim // heads)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        got = flash_attention(q, k, v)
        want = flash_plain_chunked(q, k, v)
    err, of_tol = flash_err(got, want)
    if not of_tol <= 1:
        raise AssertionError(f"flash on the served layer-0 q/k/v: max abs "
                             f"err {err} ({of_tol:.3g} of the tolerance)")
    log(f"lc: flash equals its plain version on the served layer-0 "
        f"{tuple(q.shape)} q/k/v within {err:.3g} ({of_tol:.3g} of the "
        f"tolerance)")
    return err


def check_classes(results: list[dict],
                  logits: np.ndarray) -> tuple[int, float]:
    """Served classes against a reference's logits: the same class wherever
    the reference's top two are more than LC_GAP apart. Returns how many
    agree and the largest confidence gap."""
    agree, gap = 0, 0.0
    for result, row in zip(results, logits):
        probs = np.exp(row.astype(np.float64) - row.max())
        probs /= probs.sum()
        top, second = np.sort(probs)[::-1][:2]
        same = result["class_id"] == int(np.argmax(probs))
        agree += same
        if not same and top - second > LC_GAP:
            raise AssertionError(f"class {result['class_id']} vs reference "
                                 f"{int(np.argmax(probs))} (gap {top - second})")
        gap = max(gap, abs(result["confidence"] - top))
    return agree, gap


def check_scores(results: list[dict], logits: np.ndarray) -> int:
    """Served JSON against the full-attention reference: same schema, the
    same class wherever the reference's top two are more than LC_GAP apart,
    confidence within LC_CONF_ATOL. Returns how many classes agree."""
    agree = 0
    for result, row in zip(results, logits):
        if set(result) != {"class_id", "confidence"}:
            raise AssertionError(f"response keys {set(result)}")
        probs = np.exp(row.astype(np.float64) - row.max())
        probs /= probs.sum()
        top, second = np.sort(probs)[::-1][:2]
        same = result["class_id"] == int(np.argmax(probs))
        agree += same
        if not same and top - second > LC_GAP:
            raise AssertionError(f"class {result['class_id']} vs reference "
                                 f"{int(np.argmax(probs))} (gap {top - second})")
        if abs(result["confidence"] - top) > LC_CONF_ATOL:
            raise AssertionError(f"confidence {result['confidence']} vs "
                                 f"reference {top}")
    return agree


def phase_longcontext() -> dict:
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.ops import flash_attention

    spec = longcontext_spec()
    config = spec["models"][0]
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(spec, device="cuda")
    log(f"lc: worker built and warmed (buckets "
        f"{'/'.join(map(str, config['buckets']))}) in "
        f"{time.perf_counter() - t0:.1f}s")
    servable = worker.runtime.models["longcontext"]
    rng = np.random.default_rng(SEED)
    seqs = rng.integers(0, config["vocab_size"],
                        (N_LC_SYNC + N_LC_ASYNC, config["seq_len"]),
                        dtype=np.uint16)
    out = asyncio.run(drive(
        worker, batcher, free_port(), [npy_bytes(s) for s in seqs], N_LC_SYNC,
        (config["sync_path"], config["async_path"],
         "completed - class_id, confidence"),
        {"flash_attention": flash_attention}))

    served_err = check_served_attention(servable, seqs)
    agree = check_scores(out["sync_results"] + out["async_results"],
                         reference_logits(servable, config, seqs))
    batches = sum(int(float(line.rsplit(" ", 1)[1]))
                  for line in out["metrics"].splitlines()
                  if line.startswith("ai4e_batch_size_count"))
    big = batches_over(out["metrics"], 16)
    if big < 1:
        raise AssertionError("no batch reached bucket 64")
    launches = out["launches"]["flash_attention"]
    if launches < config["depth"] * batches:
        raise AssertionError(f"flash launched {launches} times for {batches} "
                             f"batches of depth {config['depth']}")
    if [m["name"] for m in out["listing"]["models"]] != ["longcontext"]:
        raise AssertionError(f"/models: {out['listing']}")

    _, _, phases = worker.runtime.run_batch_phases(
        "longcontext", np.zeros((64, config["seq_len"]), np.int32))
    lc = {
        "sync_p50_ms": statistics.median(out["sync_ms"]),
        "async_sequences_per_s": N_LC_ASYNC / out["async_s"],
        "async_requests": N_LC_ASYNC,
        "retries_503": out["retries_503"],
        "batches": batches,
        "batches_in_bucket_64": big,
        "classes_agree_with_full_attention":
            f"{agree}/{N_LC_SYNC + N_LC_ASYNC}",
        "served_layer0_flash_err": served_err,
        "bucket64_phases_ms": {k: v * 1e3 for k, v in phases.items()},
        "launches": out["launches"],
    }
    log(f"lc: {json.dumps(lc)}")
    return lc


# -- phase 5b: the async main path as separate processes -------------------


def topology_specs(store_url: str, worker_url: str) -> tuple[dict, dict]:
    """deploy/specs' landcover and longcontext at full width and depth
    (random weights from seed 0) behind the control plane at ``store_url``,
    and their routes, ``autoscale`` included, to the worker at
    ``worker_url``."""
    from urllib.parse import urlparse

    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    models = []
    for model in spec["models"]:
        if model["name"] in TOPOLOGY_MODELS:
            model = dict(model)
            model.pop("checkpoint")
            models.append(model)
    routes = json.loads((ROOT / "deploy/specs/routes.json").read_text())
    apis = []
    for api in routes["apis"]:
        if api.get("prefix", "").startswith(
                tuple(f"/v1/{m}/" for m in TOPOLOGY_MODELS)):
            api["backend"] = worker_url + urlparse(api["backend"]).path
            apis.append(api)
    return ({"service_name": spec["service_name"], "prefix": spec["prefix"],
             "taskstore": store_url, "models": models}, {"apis": apis})


def start_child(args: list[str], log_path: Path, env: dict) -> subprocess.Popen:
    with open(log_path, "wb") as out:
        return subprocess.Popen([sys.executable, "-m", "ai4e_tpu_torch", *args],
                                cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT)


# -- the script's own processes ------------------------------------------


PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the reaper of its orphaned descendants, so a
    grandchild whose parent died first (a compiler a killed child had
    started) stays below this process, where ``stop_leftovers`` finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"prctl(PR_SET_CHILD_SUBREAPER): {os.strerror(err)}")


def descendants() -> list[tuple[int, str]]:
    """``(pid, command line)`` of every live process below this one, read
    from ``/proc``."""
    children: dict[int, list[int]] = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            stat = Path(f"/proc/{entry}/stat").read_text()
        except OSError:
            continue  # ended while we read
        state, ppid = stat.rsplit(")", 1)[1].split()[:2]
        if state != "Z":
            children.setdefault(int(ppid), []).append(int(entry))
    found, todo = [], list(children.get(os.getpid(), []))
    while todo:
        pid = todo.pop()
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes()
        except OSError:
            cmd = b""
        found.append((pid, cmd.replace(b"\0", b" ").decode(
            errors="replace").strip()[:200]))
        todo += children.get(pid, [])
    return found


def stop_leftovers() -> list[tuple[int, str]]:
    """SIGKILL every process still below this one, then reap every child
    (adopted orphans and zombies too); returns what was still running."""
    import signal

    left = descendants()
    for pid, _ in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break  # no child left
        if pid == 0:
            time.sleep(0.02)
    return left


def on_sigterm(signum, frame) -> None:
    """SIGTERM ends the run as an exception, so every phase's ``finally``
    stops its children and ``main`` sweeps what is left."""
    raise SystemExit(128 + signum)


def tail(path: Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:]


async def wait_healthy(http, url: str, proc: subprocess.Popen, log_path: Path,
                       timeout: float = 300.0) -> None:
    import aiohttp

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{url}: the process exited "
                                 f"{proc.returncode}:\n{tail(log_path)}")
        try:
            async with http.get(url) as r:
                if r.status == 200:
                    return
        except aiohttp.ClientConnectionError:
            pass
        await asyncio.sleep(0.1)
    raise AssertionError(f"{url} never came up:\n{tail(log_path)}")


async def drive_gateway(http, gateway: str, route: str, bodies: list[bytes],
                        n_sync: int, done: str, worker: str) -> dict:
    """Through the gateway only: the first ``n_sync`` bodies one after
    another to the sync route, the rest at once to the async route, each
    task long-polled to ``done`` and its result read from the task store.
    The worker's /metrics is read just before and just after the async
    requests."""
    from ai4e_tpu_torch.taskstore import TaskStatus

    headers = {"Content-Type": "application/octet-stream"}
    sync_ms, results = [], []
    for body in bodies[:n_sync]:
        t0 = time.perf_counter()
        async with http.post(gateway + route, data=body, headers=headers) as r:
            if r.status != 200:
                raise AssertionError(f"sync {route} {r.status}: {await r.text()}")
            results.append(await r.json())
        sync_ms.append((time.perf_counter() - t0) * 1e3)

    async def one(body: bytes) -> tuple[float, float, str]:
        t0 = time.perf_counter()
        async with http.post(gateway + route + "-async", data=body,
                             headers=headers) as r:
            if r.status != 200:
                raise AssertionError(f"async {route} {r.status}: "
                                     f"{await r.text()}")
            task_id = (await r.json())["TaskId"]
        while True:
            async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                                params={"wait": "60"}) as r:
                record = await r.json()
            if TaskStatus.canonical(record["Status"]) in TaskStatus.TERMINAL:
                break
        t1 = time.perf_counter()
        if record["Status"] != done:
            raise AssertionError(f"task {task_id}: {record}")
        return t0, t1, task_id

    async with http.get(worker + "/metrics") as r:
        metrics_before = await r.text()
    runs = await asyncio.gather(*(one(b) for b in bodies[n_sync:]))
    async with http.get(worker + "/metrics") as r:
        metrics_after = await r.text()
    for _, _, task_id in runs:
        async with http.get(gateway + "/v1/taskstore/result",
                            params={"taskId": task_id}) as r:
            if r.status != 200:
                raise AssertionError(f"result of {task_id}: {r.status}")
            results.append(json.loads(await r.read()))
    latency_ms = sorted((t1 - t0) * 1e3 for t0, t1, _ in runs)
    span = max(t1 for _, t1, _ in runs) - min(t0 for t0, _, _ in runs)
    return {"sync_ms": sync_ms, "results": results, "async_s": span,
            "task_ids": [task_id for _, _, task_id in runs],
            "metrics": (metrics_before, metrics_after),
            "async_requests_per_s": len(runs) / span,
            "task_min_ms": latency_ms[0],
            "task_p50_ms": statistics.median(latency_ms),
            "task_p95_ms": float(np.percentile(latency_ms, 95)),
            "sync_p50_ms": statistics.median(sync_ms) if sync_ms else None}


def metric_sum(metrics_text: str, name: str, **labels: str) -> float:
    """Sum of the ``name`` series whose labels include ``labels``."""
    total = 0.0
    for line in metrics_text.splitlines():
        if line.startswith(name + "{") or line.startswith(name + " "):
            if all(f'{k}="{v}"' in line for k, v in labels.items()):
                total += float(line.rsplit(" ", 1)[1])
    return total


def metric_delta(texts: tuple[str, str], name: str, **labels: str) -> float:
    return metric_sum(texts[1], name, **labels) - metric_sum(texts[0], name,
                                                             **labels)


def batch_sizes(metrics_text: str, model: str) -> dict:
    """Executed batches per size bucket (``le``) for ``model``, from the
    worker's ``ai4e_batch_size`` histogram."""
    cum = {}
    for line in metrics_text.splitlines():
        if (line.startswith("ai4e_batch_size_bucket")
                and f'model="{model}"' in line):
            le = line.split('le="')[1].split('"')[0]
            cum[le] = int(float(line.rsplit(" ", 1)[1]))
    out, prev = {}, 0
    for le, n in cum.items():
        if n - prev:
            out[le] = n - prev
        prev = n
    return out


async def drive_topology(gateway: str, worker: str, procs: dict,
                         logs: dict, work: dict) -> dict:
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        log(f"topology: worker up in {time.perf_counter() - t0:.1f}s")
        out = {}
        for model, (route, bodies, n_sync, done) in work.items():
            out[model] = await drive_gateway(http, gateway, route, bodies,
                                             n_sync, done, worker)
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
        async with http.get(worker + "/metrics") as r:
            out["wk_metrics"] = await r.text()
    return out


def stop_child(proc: subprocess.Popen, log_path: Path, what: str) -> None:
    """SIGTERM, then the exit code must be 0."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        code = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what} did not stop:\n{tail(log_path)}")
    if code != 0:
        raise AssertionError(f"{what} exited {code}:\n{tail(log_path)}")


def served_launches(log_text: str) -> dict:
    marker = "kernel launches while serving "
    lines = [line for line in log_text.splitlines() if marker in line]
    if not lines:
        raise AssertionError("the worker logged no kernel launches")
    return json.loads(lines[-1].split(marker, 1)[1])


def phase_topology() -> dict:
    """The port's control plane and its worker (``--device cuda``) as two
    child processes joined by HTTP; this process is the client, through the
    gateway only."""
    import gc
    import os

    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = topology_specs(gateway, worker)
    (out_dir / "topology_models.json").write_text(json.dumps(models))
    (out_dir / "topology_routes.json").write_text(json.dumps(routes))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY))
    logs = {"cp": out_dir / "control_plane.log", "wk": out_dir / "worker.log"}
    config = {m["name"]: m for m in models["models"]}
    rng = np.random.default_rng(SEED)
    n = N_TOPO_SYNC + N_TOPO_ASYNC
    images = rng.integers(0, 256, (n, 256, 256, 3), np.uint8)
    seqs = rng.integers(0, config["longcontext"]["vocab_size"],
                        (n, config["longcontext"]["seq_len"]), dtype=np.uint16)
    work = {
        "landcover": ("/v1/landcover/classify", [npy_bytes(x) for x in images],
                      N_TOPO_SYNC, "completed - class_histogram"),
        "longcontext": ("/v1/longcontext/score", [npy_bytes(x) for x in seqs],
                        N_TOPO_SYNC, "completed - class_id, confidence"),
    }
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / "topology_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "topology_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             "cuda"], logs["wk"], env)
        out = asyncio.run(drive_topology(gateway, worker, procs, logs, work))
        stop_child(procs["wk"], logs["wk"], "worker")
        stop_child(procs["cp"], logs["cp"], "control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wk_log = logs["wk"].read_text(errors="replace")
    if "serving ['landcover', 'longcontext'] on cuda" not in wk_log:
        raise AssertionError(f"the worker did not serve on cuda:\n{wk_log[-4000:]}")
    launches = served_launches(wk_log)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} never launched in the worker")
    failed = metric_sum(out["cp_metrics"], "ai4e_dispatch_total",
                        outcome="failed") + metric_sum(
        out["cp_metrics"], "ai4e_dispatch_total", outcome="dead_letter")
    if failed:
        raise AssertionError(f"{failed} deliveries failed")

    # Every answer against the same seed-0 weights on the card, with the
    # limits of phases 4 and 5.
    runtime = ModelRuntime(device="cuda")
    lc_spec = {k: v for k, v in config["longcontext"].items()
               if k not in ("family", "sync_path", "async_path")}
    unet_spec = {k: v for k, v in config["landcover"].items()
                 if k not in ("family", "sync_path", "async_path")}
    unet = runtime.register(build_servable("unet", **unet_spec))
    want = reference_counts(unet, images)
    diffs = [check_histogram(r, want[i], 256 * 256)
             for i, r in enumerate(out["landcover"]["results"])]
    seqformer = runtime.register(build_servable("seqformer", **lc_spec))
    agree = check_scores(out["longcontext"]["results"],
                         reference_logits(seqformer, config["longcontext"], seqs))
    del unet, seqformer, runtime

    report = {"card": CARD["smi"], "clients": "another process",
              "launches_while_serving": launches}
    for model, (route, _, _, _) in work.items():
        queue = "/v1/models/" + route.rsplit("/", 1)[1] + "-async"
        got = out[model]
        report[model] = {
            "async_requests_per_s": got["async_requests_per_s"],
            "task_p50_ms": got["task_p50_ms"],
            "task_p95_ms": got["task_p95_ms"],
            "sync_p50_ms": got["sync_p50_ms"],
            "redeliveries_503": metric_sum(
                out["cp_metrics"], "ai4e_dispatch_total",
                outcome="backpressure", queue=queue),
            "async_requests": N_TOPO_ASYNC,
            "route_concurrency": next(
                a.get("concurrency") for a in routes["apis"]
                if a["backend"].endswith(queue)),
            "batch_sizes": batch_sizes(out["wk_metrics"], model),
        }
        # The async requests' share of the worker: its batches' execute
        # time (host clock around each batch, to the results on the host)
        # over the async span, and the mean wait for a batch.
        texts = got["metrics"]
        exec_s = metric_delta(texts, "ai4e_batch_exec_seconds_sum",
                              model=model)
        waits = metric_delta(texts, "ai4e_batch_queue_wait_seconds_count",
                             model=model)
        report[model].update(
            async_batches=metric_delta(texts, "ai4e_batch_size_count",
                                       model=model),
            async_batch_exec_s=exec_s,
            async_batch_exec_share=exec_s / got["async_s"],
            async_mean_queue_wait_ms=1e3 * metric_delta(
                texts, "ai4e_batch_queue_wait_seconds_sum",
                model=model) / max(waits, 1))
    report["landcover"]["max_count_diff_px"] = max(diffs)
    report["longcontext"]["classes_agree_with_full_attention"] = (
        f"{agree}/{len(out['longcontext']['results'])}")
    log(f"topology: {json.dumps(report)}")
    return report


# -- phase 6: train then serve --------------------------------------------


def flash_bwd_plain_chunked(q, k, v, out, lse, do, causal=False,
                            parts="qkv"):
    """The backward kernels' plain version, PLAIN_CHUNK sequences at a
    time; (dq, dk, dv), None where ``parts`` leaves one out."""
    from ai4e_tpu_torch.ops.flash_attention import flash_attention_bwd_plain

    outs = [flash_attention_bwd_plain(
        q[i:i + PLAIN_CHUNK], k[i:i + PLAIN_CHUNK], v[i:i + PLAIN_CHUNK],
        out[i:i + PLAIN_CHUNK], lse[i:i + PLAIN_CHUNK], do[i:i + PLAIN_CHUNK],
        causal, parts) for i in range(0, q.shape[0], PLAIN_CHUNK)]
    return tuple(None if part[0] is None else torch.cat(part)
                 for part in zip(*outs))


def check_flash_bwd(q, k, v, do, causal: bool,
                    what: str) -> tuple[float, float]:
    """The backward against its plain version on the same tensors (out and
    lse from the forward kernel); returns the max abs errors of (dK/dV,
    dQ)."""
    from ai4e_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_bwd,
                                                    grad_tolerance)

    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = flash_bwd_plain_chunked(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    errs, notes = {}, []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"flash bwd {what} {name}: {g.shape} {g.dtype}")
        err = (g.float() - w.float()).abs()
        of_tol = float((err / grad_tolerance(w)).max())
        errs[name] = float(err.max())
        notes.append(f"{name} {errs[name]:.3g} ({of_tol:.3g} of the tolerance)")
        if not of_tol <= 1:
            raise AssertionError(f"flash bwd {what} {name}: max abs err "
                                 f"{errs[name]} ({of_tol:.3g} of the tolerance)")
    log(f"  flash bwd {what}: {', '.join(notes)}")
    return max(errs["dk"], errs["dv"]), errs["dq"]


def phase_flash_bwd_parity() -> tuple[float, float]:
    """The backward at the training shape, at S_q = 129 (one row past two
    of the fused kernel's 64-row query tiles) and at ragged, causal and
    cross shapes in both types; returns the max abs errors."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)

    def tensors(b, h, s_q, s_k, d, dtype):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(dtype) for s in (s_q, s_k, s_k, s_q))

    b, h, s, d = BWD_TRAIN
    errs = [check_flash_bwd(*tensors(b, h, s, s, d, torch.bfloat16), False,
                            f"training {BWD_TRAIN} bf16"),
            check_flash_bwd(*tensors(2, 3, 129, 200, d, torch.bfloat16),
                            False, "S_q 129 x S_k 200 d128 bf16")]
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            errs.append(check_flash_bwd(
                *tensors(2, 3, 1000, 1000, 64, dtype), causal,
                f"(2, 3, 1000, 64) {str(dtype)[6:]} causal={causal}"))
        errs.append(check_flash_bwd(*tensors(2, 3, 192, 320, 64, dtype), False,
                                    f"cross 192x320 d64 {str(dtype)[6:]}"))
    return max(e for e, _ in errs), max(e for _, e in errs)


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside, the caller's
    setting restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def check_flash_bwd_ordered(q, k, v, do, causal: bool, what: str) -> None:
    """Under PyTorch's deterministic flag the bf16 backward orders its dQ
    adds: two calls must give bit-equal dq, dk and dv, each within
    ``grad_tolerance`` of the plain version (computed outside the flag,
    whose cuBLAS products would refuse to run under it)."""
    from ai4e_tpu_torch.ops.flash_attention import (flash_attention,
                                                    flash_attention_bwd,
                                                    grad_tolerance)

    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    want = flash_bwd_plain_chunked(q, k, v, out, lse, do, causal)
    with deterministic_algorithms():
        first = flash_attention_bwd(q, k, v, out, lse, do, causal)
        second = flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
    notes = []
    for name, a, b, w in zip(("dq", "dk", "dv"), first, second, want):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"flash bwd ordered {what} {name}: {bad} of "
                                 f"{a.numel()} differ between two calls")
        of_tol = float(((a.float() - w.float()).abs() / grad_tolerance(w))
                       .max())
        notes.append(f"{name} {of_tol:.3g}")
        if not of_tol <= 1:
            raise AssertionError(f"flash bwd ordered {what} {name}: "
                                 f"{of_tol:.3g} of the tolerance")
    log(f"  flash bwd ordered {what}: two calls bit-equal; of the tolerance "
        f"{', '.join(notes)}")


def phase_flash_bwd_ordered() -> None:
    """The deterministic bf16 backward at the training shape and at a
    ragged S for every head dim, causal and not."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def tensors(b, h, s, d):
        return tuple(torch.randn((b, h, s, d), generator=gen, device="cuda")
                     .to(torch.bfloat16) for _ in range(4))

    for causal in (False, True):
        check_flash_bwd_ordered(*tensors(*BWD_TRAIN), causal,
                                f"training {BWD_TRAIN} causal={causal}")
        for d in (16, 32, 64, 128):
            check_flash_bwd_ordered(*tensors(2, 2, 1000, d), causal,
                                    f"(2, 2, 1000, {d}) causal={causal}")


def longcontext_config() -> dict:
    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_classes",
            "vocab_size")
    return {k: longcontext_spec()["models"][0][k] for k in keys}


def phase_model_grad() -> dict:
    """The full-width SeqFormer (float32 masters, bf16 body) on one
    training batch: every parameter's gradient through the flash kernels
    against the same through plain full attention."""
    from ai4e_tpu_torch.models import create_seqformer
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch
    from ai4e_tpu_torch.train.step import cross_entropy_loss

    config = longcontext_config()
    toks, labels = longcontext_batch(np.random.default_rng(SEED), 8,
                                     config["seq_len"], config["vocab_size"],
                                     config["num_classes"])
    x, y = torch.from_numpy(toks).cuda(), torch.from_numpy(labels).cuda()
    grads, losses = {}, {}
    for attention in ("flash", "full"):
        model = create_seqformer(**config, attention=attention,
                                 param_dtype=torch.float32, device="cuda")
        params = dict(model.named_parameters())
        loss = cross_entropy_loss(model(x), y)
        grads[attention] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        losses[attention] = float(loss.detach())
        del model, params, loss
    worst_name, worst = "", 0.0
    for name, want in grads["full"].items():
        gap = float((grads["flash"][name] - want).norm()
                    / want.norm().clamp_min(1e-30))
        if gap > worst:
            worst_name, worst = name, gap
    del grads
    torch.cuda.empty_cache()
    if not worst <= MODEL_GRAD_RTOL:
        raise AssertionError(f"model gradient {worst_name}: flash vs full "
                             f"relative gap {worst} > {MODEL_GRAD_RTOL}")
    log(f"train: model gradients, flash against full attention on one "
        f"batch: worst relative gap {worst:.3g} ({worst_name}; tolerance "
        f"{MODEL_GRAD_RTOL}), loss {losses['flash']:.6f} vs "
        f"{losses['full']:.6f}")
    return {"worst_relative_gap": worst, "worst_param": worst_name,
            "loss_flash": losses["flash"], "loss_full": losses["full"]}


def phase_train() -> dict:
    """``train_longcontext`` at its defaults on the card; the launch counts
    are set to 0 just before and read just after."""
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.train.make_checkpoints import train_longcontext

    config = longcontext_config()
    fa.launches = fa.bwd_launches = 0
    result = train_longcontext(device="cuda")
    launches = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    steps = len(result["losses"])
    for name, n in launches.items():
        if n < config["depth"] * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps of depth {config['depth']}")
    losses = result["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training loss is not finite: {losses}")
    phases = result["phases_ms"][1:]  # the first step pays one-off costs
    step_ms = [sum(p.values()) for p in phases]
    median_ms = statistics.median(step_ms)
    batch = result["batch"]
    train = {
        "steps": steps,
        "batch": batch,
        "loss_first": losses[0],
        "loss_last": losses[-1],
        "loss_every_25": losses[::25],
        "step_ms_median": median_ms,
        "phase_ms_median": {k: statistics.median(p[k] for p in phases)
                            for k in phases[0]},
        "sequences_per_s": batch * 1e3 / median_ms,
        "loop_sequences_per_s": steps * batch / result["loop_seconds"],
        "peak_memory_gib": result["peak_bytes"] / 2 ** 30,
        "eval_accuracy": result["eval"]["accuracy"],
        "reached_min_eval_0.85": result["eval"]["accuracy"] >= 0.85,
        "launches": launches,
    }
    log(f"train: {json.dumps(train)}")
    return {"record": train, "result": result}


def phase_serve_trained(result: dict) -> dict:
    """The trained weights through ``make_checkpoint`` and ``build_worker``,
    served over HTTP on the trainer's held-out sequences."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.ops import flash_attention
    from ai4e_tpu_torch.train.make_checkpoints import (longcontext_batch,
                                                       make_checkpoint)

    entry = make_checkpoint("longcontext", str(ROOT / "build" / "chip_smoke"),
                            min_eval=MIN_SERVED_ACC, result=result)
    spec = longcontext_spec()
    config = spec["models"][0]
    config["checkpoint"] = entry["path"]
    worker, batcher, _ = build_worker(spec, device="cuda")
    # The trainer's eval set: 4 batches of 16 drawn from seed + 1.
    rng = np.random.default_rng(SEED + 1)
    seqs, labels = zip(*(longcontext_batch(rng, 16, config["seq_len"],
                                           config["vocab_size"],
                                           config["num_classes"])
                         for _ in range(4)))
    seqs, labels = np.concatenate(seqs), np.concatenate(labels)
    out = asyncio.run(drive(
        worker, batcher, free_port(),
        [npy_bytes(s.astype(np.uint16)) for s in seqs], N_TRAIN_SYNC,
        (config["sync_path"], config["async_path"],
         "completed - class_id, confidence"),
        {"flash_attention": flash_attention}))
    served = np.array([r["class_id"]
                       for r in out["sync_results"] + out["async_results"]])
    if out["launches"]["flash_attention"] < config["depth"]:
        raise AssertionError(f"flash launched {out['launches']} times "
                             f"serving the trained weights")
    hits = int((served == labels).sum())
    train_hits = round(result["eval"]["accuracy"] * len(labels))
    if abs(hits - train_hits) > SERVED_ACC_SLACK:
        raise AssertionError(f"served {hits}/{len(labels)} right, the "
                             f"trainer's eval {train_hits}")
    if hits < MIN_SERVED_ACC * len(labels):
        raise AssertionError(f"served accuracy {hits}/{len(labels)} < "
                             f"{MIN_SERVED_ACC}")
    serve = {"npz": entry["path"],
             "served_accuracy": hits / len(labels),
             "trainer_eval_accuracy": result["eval"]["accuracy"],
             "sync_p50_ms": statistics.median(out["sync_ms"]),
             "async_sequences_per_s": (len(seqs) - N_TRAIN_SYNC) / out["async_s"],
             "launches": out["launches"]}
    log(f"serve trained: {json.dumps(serve)}")
    return serve


def kernel_device_ms(fn, names: tuple[str, ...], reps: int = 25) -> dict:
    """Mean device time a call of ``fn`` spends in the kernels whose names
    contain each of ``names``, in ms, from a ``torch.profiler`` trace of
    ``reps`` calls after warm-up. Raises if one of them did not run."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        for name in names:
            if name in event.key:
                times[name] += event.self_device_time_total / reps / 1e3
    missing = [name for name, ms in times.items() if ms <= 0]
    if missing:
        raise AssertionError(f"no device time for {missing} in the trace")
    return times


def phase_flash_bwd_timing(errs: tuple[float, float],
                           launches: dict) -> list[dict]:
    """The backward timed at the training shape: the whole call
    (``flash_attention_bwd``) by CUDA events, each of its kernels by
    ``torch.profiler``, beside the plain version and, as a yardstick only,
    SDPA's backward."""
    import torch.nn.functional as F

    from ai4e_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    b, h, s, d = BWD_TRAIN
    q, k, v, do = (torch.randn(BWD_TRAIN, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
    # Yardstick only, the whole backward (dq, dk, dv): the port never calls it.
    library = device_ms(lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do, retain_graph=True))

    def call():
        return fa.flash_attention_bwd(q, k, v, out, lse, do)

    parts = kernel_device_ms(call, ("flash_bwd_prep", "flash_bwd_wgmma",
                                    "flash_bwd_dq_convert"))
    c_out, c_lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def causal_call():
        return fa.flash_attention_bwd(q, k, v, c_out, c_lse, do, True)

    causal_ms = device_ms(causal_call)
    with deterministic_algorithms():  # dQ's adds ordered
        ordered_ms = device_ms(call)
        ordered_parts = kernel_device_ms(call, ("flash_bwd_wgmma",))
        ordered_causal_ms = device_ms(causal_call)
    # q, k, v, out, do read and dq, dk, dv written once in bf16, lse read in
    # float32; five products (S, dP, dV, dK, dQ), two flops a multiply-add.
    flops = 2 * 5 * b * h * s * s * d
    bound, by = bound_ms(8 * b * h * s * d * 2 + b * h * s * 4, flops,
                         BF16_OPS_PER_S)
    entry = {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "ai4e_tpu_torch/csrc/flash_attention.cu",
        "replaces": "ai4e_tpu/ops/pallas/flash_attention.py:160 "
                    "(_flash_bwd_dkv_kernel) and :197 (_flash_bwd_dq_kernel)",
        "shape": list(BWD_TRAIN),
        # The whole call: preparation pass, fused kernel, dQ conversion.
        "ms": device_ms(call),
        "fused_kernel_ms": parts["flash_bwd_wgmma"],
        "causal_ms": causal_ms,
        # Under torch.use_deterministic_algorithms(True): the whole call
        # (with PyTorch's NaN fill of the fresh outputs and scratch, which
        # the flag turns on) and its fused kernel; bit-equal from call to
        # call.
        "deterministic_ms": ordered_ms,
        "deterministic_fused_kernel_ms": ordered_parts["flash_bwd_wgmma"],
        "deterministic_causal_ms": ordered_causal_ms,
        "prep_ms": parts["flash_bwd_prep"],
        "convert_ms": parts["flash_bwd_dq_convert"],
        "plain_ms": device_ms(lambda: flash_bwd_plain_chunked(
            q, k, v, out, lse, do), reps=5),
        "library_ms": library,
        "library": "F.scaled_dot_product_attention backward (dq, dk, dv)",
        "bound_ms": bound,
        "bound_by": by,
        "bound_peak": "bf16 tensor cores 989 TFLOP/s, HBM 3.35 TB/s",
        "max_abs_err": max(errs),
        "dkv_max_abs_err": errs[0],
        "dq_max_abs_err": errs[1],
        "launches": launches["flash_attention_bwd"],
        "ptxas": flash_kernel_report("flash_bwd_wgmma"),
    }
    entry["tflops"] = flops / entry["ms"] / 1e9
    entry["fused_kernel_tflops"] = flops / entry["fused_kernel_ms"] / 1e9
    log(f"  flash_attention_bwd {BWD_TRAIN} bf16: whole call "
        f"{entry['ms']:.4f} ms ({entry['tflops']:.1f} TFLOP/s; fused kernel "
        f"{entry['fused_kernel_ms']:.4f} ms, {entry['fused_kernel_tflops']:.1f}"
        f" TFLOP/s; prep {entry['prep_ms']:.4f}, convert "
        f"{entry['convert_ms']:.4f}), plain {entry['plain_ms']:.4f} ms, SDPA "
        f"backward {library:.4f} ms, bound {bound:.4f} ms ({by}); "
        f"deterministic: whole call {ordered_ms:.4f} ms, fused kernel "
        f"{entry['deterministic_fused_kernel_ms']:.4f} ms")
    for dd, rep in sorted(entry["ptxas"].items()):
        log(f"  flash_bwd_wgmma D={dd}: {rep['registers']} registers, "
            f"{rep['spill_bytes']} spill bytes, {rep['smem_bytes']} bytes of "
            f"shared memory a CTA; ordered: {rep.get('ordered')}")
    return [entry]


def phase_train_then_serve() -> tuple[list[dict], str]:
    log("train: backward kernels against their plain version on the card")
    errs = phase_flash_bwd_parity()
    phase_flash_bwd_ordered()
    phase_model_grad()
    train = phase_train()
    served = phase_serve_trained(train["result"])
    return (phase_flash_bwd_timing(errs, train["record"]["launches"]),
            served["npz"])


# -- phase 7: the runtime ---------------------------------------------------

N_TIMING = 10          # CUDA-event timings per bucket, median taken
RELOAD_WAVES = 8       # phase 7c's async burst in waves; the reload after half
LADDER_SIZE = 24       # phase 7d's demand, outside the factory ladder 1/16/64


def stream_ms(fn, reps: int = N_TIMING) -> float:
    """Median time of one ``fn()`` call between two CUDA events recorded
    around it on the current stream, in ms: the host's launches are inside
    the window (no spin kernel ahead), as a served batch sees them."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: Each launch counter's kernel, by the name a profiler trace gives it.
KERNEL_NAMES = {"normalize_image": "normalize_u8_kernel",
                "fused_seg_postprocess": "seg_postprocess_kernel",
                "flash_attention": "flash_fwd_"}


def trace_replay(graph) -> tuple[dict[str, int], int]:
    """The port's kernels one replay of ``graph`` runs, counted by name in a
    ``torch.profiler`` trace of the card (the launch counters are left
    alone), and the kernel records the trace holds in all."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The first kernels after a trace starts have gone unrecorded now
        # and then (a replay's first node, normalize, most often): a spin
        # kernel takes that place.
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        graph.graph.replay()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    records = 0
    for event in prof.key_averages():
        records += event.count
        for counter, kernel in KERNEL_NAMES.items():
            if kernel in event.key:
                counts[counter] += event.count
    return {k: n for k, n in counts.items() if n}, records


def replay_kernels(graph, label: str,
                   tries: int = 3) -> tuple[dict[str, int], int]:
    """``trace_replay`` held against the launches ``graph`` adds to the
    counters; returns the traced counts and the traces taken. A trace has
    lost a kernel's record now and then (a replay's outputs still equal
    eager's), so up to ``tries`` replays are traced and one must hold
    exactly the graph's launches; a kernel traced more often than the
    graph adds fails at once."""
    for attempt in range(1, tries + 1):
        traced, records = trace_replay(graph)
        if any(n > graph.launches.get(k, 0) for k, n in traced.items()):
            break
        if traced == graph.launches:
            return traced, attempt
    raise AssertionError(f"{label}: a replay ran {traced} of the port's "
                         f"kernels (trace {attempt}, {records} records in "
                         f"all); its graph adds {graph.launches}")


def model_kwargs(spec: dict) -> dict:
    model = dict(spec["models"][0])
    for key in ("family", "sync_path", "async_path",
                "maximum_concurrent_requests"):
        model.pop(key, None)
    return model


def same_outputs(got: dict, want: dict) -> bool:
    return got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in got)


def phase_graphs() -> dict:
    """7a: each bucket's replay against an eager ``apply_fn`` on the same
    batch, for land cover (counts, and class map on a second servable) and
    longcontext (logits), and their execute times."""
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    runtime = ModelRuntime("cuda")
    lc = model_kwargs(landcover_spec())
    seq = model_kwargs(longcontext_spec())
    runtime.register(build_servable("unet", **lc))
    runtime.register(build_servable("unet", **{
        **lc, "name": "landcover_classmap", "return_classmap": True}))
    runtime.register(build_servable("seqformer", **seq))
    t0 = time.perf_counter()
    runtime.warmup()
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 70)
    record: dict = {"warmup_and_capture_s": warm_s, "buckets": {}}
    cudnn_differs = []
    for name, servable in runtime.models.items():
        for bucket in servable.batch_buckets:
            if servable.input_dtype == np.uint8:
                x = rng.integers(0, 256, (bucket, *servable.input_shape),
                                 np.uint8)
            else:
                x = rng.integers(0, seq["vocab_size"],
                                 (bucket, *servable.input_shape)).astype(np.int32)
            graph = runtime.graphs[(name, bucket)]
            want_launches = ({"normalize_image": 1, "fused_seg_postprocess": 1}
                             if servable.input_dtype == np.uint8 else
                             {"flash_attention": seq["depth"]})
            if graph.launches != want_launches:
                raise AssertionError(f"{name} bucket {bucket} captured "
                                     f"{graph.launches}, not {want_launches}")
            traced, traces = replay_kernels(graph, f"{name} bucket {bucket}")
            got = runtime.run_batch(name, x)
            dev = torch.from_numpy(x).cuda()
            with torch.inference_mode():
                eager_out = servable.apply_fn(servable.module, dev)
            if not isinstance(eager_out, dict):
                got, eager_out = {"logits": got}, {"logits": eager_out}
            want = {k: v.cpu().numpy() for k, v in eager_out.items()}
            if not same_outputs(got, want):
                if servable.input_dtype != np.uint8:
                    raise AssertionError(f"{name} bucket {bucket}: replay "
                                         "logits differ from eager")
                # cuDNN chose another algorithm under capture: phase 4's
                # tolerance, per class.
                diff = int(np.abs(got["counts"].astype(np.int64)
                                  - want["counts"]).max())
                pixels = int(np.prod(servable.input_shape[:2]))
                if diff > COUNT_TOLERANCE * pixels:
                    raise AssertionError(f"{name} bucket {bucket}: replay "
                                         f"counts off by {diff} px")
                cudnn_differs.append(f"{name}/{bucket}: {diff} px")
            graph.static_in.copy_(dev)

            def eager():
                with torch.inference_mode():
                    servable.apply_fn(servable.module, dev)

            record["buckets"][f"{name}/{bucket}"] = {
                "eager_ms": stream_ms(eager),
                "replay_ms": stream_ms(graph.graph.replay),
                "replay_kernels": traced,
                "traces": traces,
            }
    # The other design against two batches of one bucket in flight: a
    # graph per staging-ring slot. What a second graph of land cover's
    # largest bucket adds to the shared pool (the runtime copies each
    # batch into one static input instead).
    servable = runtime.models["landcover"]
    largest = runtime.graphs[("landcover", servable.max_bucket)]
    before = runtime.graph_pool_bytes()
    second = torch.cuda.CUDAGraph()
    with torch.inference_mode(), torch.cuda.graph(
            second, pool=runtime.graph_pool, stream=runtime.exec_stream):
        servable.apply_fn(servable.module, largest.static_in.clone())
    record["second_slot_graph_mib"] = (
        runtime.graph_pool_bytes() - before) / 2 ** 20
    record["static_input_mib"] = largest.static_in.nbytes / 2 ** 20
    del second
    record["replay_equals_eager"] = (
        "bit for bit" if not cudnn_differs else
        "bit for bit but land cover within phase 4's 1%: " +
        ", ".join(cudnn_differs))
    record["graph_pool_mib"] = runtime.graph_pool_bytes() / 2 ** 20
    record["memory_reserved_mib"] = torch.cuda.memory_reserved() / 2 ** 20
    record["graphs"] = len(runtime.graphs)
    log(f"runtime 7a: graphs against eager: {json.dumps(record)}")
    del runtime
    torch.cuda.empty_cache()
    return record


def lc_answers(logits: np.ndarray) -> list[tuple[int, float, float]]:
    """(class, confidence, top-two gap) of each row of logits."""
    out = []
    for row in logits:
        p = np.exp(row.astype(np.float64) - row.max())
        p /= p.sum()
        top, second = np.sort(p)[::-1][:2]
        out.append((int(np.argmax(p)), float(top), float(top - second)))
    return out


def answer_matches(result: dict, ref: tuple[int, float, float]) -> bool:
    """Phase 5's rule: the class wherever the reference's top two are more
    than LC_GAP apart, the confidence within LC_CONF_ATOL."""
    cls, conf, gap = ref
    return ((result["class_id"] == cls or gap <= LC_GAP)
            and abs(result["confidence"] - conf) <= LC_CONF_ATOL)


def eager_logits(module, seqs: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return torch.cat([module(torch.from_numpy(
            seqs[i:i + 16].astype(np.int32)).cuda())
            for i in range(0, len(seqs), 16)]).cpu().numpy()


def phase_reload(trained_npz: str) -> dict:
    """7c: a longcontext worker on random seed-0 weights, its checkpoint
    directory ``build/chip_smoke``, under the trainer's held-out sequences
    (4 sync, then 64 async in waves) with phase 6's ``.npz`` reloaded in
    the middle of the burst."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.config import FrameworkConfig
    from ai4e_tpu_torch.convert import (load_npz, save_npz,
                                        unet_flax_from_state_dict)
    from ai4e_tpu_torch.models import create_seqformer, create_unet
    from ai4e_tpu_torch.ops import flash_attention
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch

    ckpt_dir = ROOT / "build" / "chip_smoke"
    config = FrameworkConfig.from_env(
        {"AI4E_RUNTIME_CHECKPOINT_DIR": str(ckpt_dir)})
    spec = longcontext_spec()
    model = spec["models"][0]
    worker, batcher, _ = build_worker(spec, device="cuda", config=config)
    servable = worker.runtime.models["longcontext"]
    rng = np.random.default_rng(SEED + 1)  # phase 6's held-out sequences
    seqs, labels = zip(*(longcontext_batch(rng, 16, model["seq_len"],
                                           model["vocab_size"],
                                           model["num_classes"])
                         for _ in range(4)))
    seqs, labels = np.concatenate(seqs), np.concatenate(labels)
    old = lc_answers(eager_logits(servable.module, seqs))
    trained = create_seqformer(**longcontext_config(), attention="flash",
                               device="cuda")
    trained.load_state_dict(servable.state_dict_from_flax(
        load_npz(trained_npz)))
    new = lc_answers(eager_logits(trained, seqs))
    del trained
    wrong = str(ckpt_dir / "landcover_small.npz")
    save_npz(unet_flax_from_state_dict(create_unet(
        widths=(8, 16), device="cpu").state_dict()), wrong)
    done = "completed - class_id, confidence"
    per_wave = len(seqs) // RELOAD_WAVES

    async def burst():
        async with serving(worker, batcher, free_port()) as (http, base):
            url = base + "/models/longcontext/reload"
            flash_attention.launches = 0
            sync = [await post_sync(http, base + model["sync_path"],
                                    npy_bytes(s.astype(np.uint16)))
                    for s in seqs[:N_LC_SYNC]]
            tasks, t_reload = [], {}
            for wave in range(RELOAD_WAVES):
                if wave == RELOAD_WAVES // 2:
                    t_reload["post"] = time.perf_counter()
                    async with http.post(url, json={
                            "checkpoint": trained_npz}) as r:
                        t_reload["answer"] = time.perf_counter()
                        reload = (r.status, await r.json())
                    t_reload["pending_at_answer"] = batcher.pending_count
                for i in range(wave * per_wave, (wave + 1) * per_wave):
                    task_id, _ = await submit_task(
                        http, base + model["async_path"],
                        npy_bytes(seqs[i].astype(np.uint16)))
                    tasks.append((i, wave, task_id))
                await asyncio.sleep(0.01)
            await asyncio.gather(*(await_task(http, base, t, done)
                                   for _, _, t in tasks))
            launches = flash_attention.launches
            batches = metric_sum(worker.service.metrics.render_prometheus(),
                                 "ai4e_batch_size_count")
            async with http.post(url, json={"checkpoint": wrong}) as r:
                mismatch = (r.status, await r.json())
            async with http.post(url, json={
                    "checkpoint": str(ROOT / "outside.npz")}) as r:
                outside = r.status
            after = await post_sync(http, base + model["sync_path"],
                                    npy_bytes(seqs[0].astype(np.uint16)))
            async with http.get(base + "/models") as r:
                listing = await r.json()
        return sync, tasks, reload, t_reload, (launches, batches), \
            mismatch, outside, after, listing

    (sync, tasks, reload, t_reload, (launches, batches), mismatch, outside,
     after, listing) = asyncio.run(burst())
    if reload != (200, {"model": "longcontext",
                        "checkpoint": os.path.realpath(trained_npz),
                        "params_version": 2, "generation": 1}):
        raise AssertionError(f"reload answered {reload}")
    for i, result in enumerate(sync):
        if not answer_matches(result, old[i]):
            raise AssertionError(f"sync {i} before the reload: {result} vs "
                                 f"{old[i]}")
    on_old = on_new = 0
    after_hits = after_n = 0
    for i, wave, task_id in tasks:
        result = json.loads(worker.store.get_result(task_id)[0])
        is_new, is_old = answer_matches(result, new[i]), answer_matches(
            result, old[i])
        if not (is_new or is_old):
            raise AssertionError(f"sequence {i}: {result} is neither "
                                 f"weights' answer ({old[i]}, {new[i]})")
        on_new += is_new and not is_old
        on_old += is_old and not is_new
        if wave >= RELOAD_WAVES // 2:  # submitted after the 200
            if not is_new:
                raise AssertionError(f"sequence {i}, submitted after the "
                                     f"reload, got the old weights' answer")
            after_n += 1
            after_hits += result["class_id"] == labels[i]
    if after_hits < MIN_SERVED_ACC * after_n:
        raise AssertionError(f"accuracy after the reload {after_hits}/"
                             f"{after_n} < {MIN_SERVED_ACC}")
    if mismatch[0] != 409 or not mismatch[1]["error"].startswith(
            "checkpoint tree does not match the served model"):
        raise AssertionError(f"land-cover .npz on longcontext: {mismatch}")
    if not answer_matches(after, new[0]):
        raise AssertionError("serving changed after the refused reload")
    if listing["models"][0]["params_version"] != 2:
        raise AssertionError(f"/models after the 409: {listing}")
    if outside != 403:
        raise AssertionError(f"a path outside the checkpoint directory: "
                             f"{outside}")
    if launches < model["depth"] * batches:
        raise AssertionError(f"flash launched {launches} times in "
                             f"{batches} batches")
    record = {
        "reload_ms": (t_reload["answer"] - t_reload["post"]) * 1e3,
        "pending_at_answer": t_reload["pending_at_answer"],
        "answers_only_old_weights": on_old,
        "answers_only_new_weights": on_new,
        "accuracy_after_reload": after_hits / after_n,
        "refusals": {"tree_mismatch": mismatch[0], "outside_root": outside},
        "launches": {"flash_attention": launches},
    }
    log(f"runtime 7c: reload under load: {json.dumps(record)}")
    return record


def phase_served_runtime(e2e: dict) -> dict:
    """7b, 7d and 7e on one land-cover worker, served once: depth 2 and the
    double buffer under phase 4's requests, then under the async examples
    submitted to the batcher at once, then a derived ladder, then a drain
    under a burst. Over HTTP in this process the host, not the card, sets
    the pace (the card idles between batches, so no copy need overlap an
    execution); submitted at once, the examples queue and each bucket-64
    batch's copy runs while the one before it executes."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.config import FrameworkConfig
    from ai4e_tpu_torch.ops import image_preprocess, seg_postprocess

    config = FrameworkConfig.from_env({
        "AI4E_RUNTIME_BATCH_PIPELINE_DEPTH": "2",
        "AI4E_RUNTIME_BATCH_DOUBLE_BUFFER": "1"})
    worker, batcher, _ = build_worker(landcover_spec(), device="cuda",
                                      config=config, measure_phases=True)
    if not (batcher._double and batcher.pipeline_depth == 2):
        raise AssertionError("the batcher is not double-buffered at depth 2")
    servable = worker.runtime.models["landcover"]
    overlap_gauge = batcher.metrics.gauge("ai4e_batch_overlap_ratio", "")
    rng = np.random.default_rng(SEED + 71)
    images = rng.integers(0, 256, (N_SYNC + N_ASYNC, 256, 256, 3), np.uint8)
    burst = rng.integers(0, 256, (N_LC_ASYNC, 256, 256, 3), np.uint8)
    want, want_burst = (reference_counts(servable, x) for x in (images, burst))

    async def main():
        async with serving(worker, batcher, free_port()) as (http, base):
            out = await post_requests(
                http, base, worker, [npy_bytes(img) for img in images],
                N_SYNC, ("/classify", "/classify-async",
                         "completed - class_histogram"),
                {"normalize_image": image_preprocess,
                 "fused_seg_postprocess": seg_postprocess})
            http_ratio = overlap_gauge.value()
            t0 = time.perf_counter()
            queued = await asyncio.gather(*(
                batcher.submit("landcover", img) for img in images[N_SYNC:]))
            out["queued_s"] = time.perf_counter() - t0
            out["queued_results"] = list(queued)
            out["http_overlap_ratio"] = http_ratio
            ladder = await asyncio.to_thread(derive_ladder_at, worker)
            drain = await drain_under_burst(http, base, worker, batcher,
                                            burst)
        return out, ladder, drain

    out, ladder, drain = asyncio.run(main())
    diffs = [check_histogram(r, want[i], 256 * 256)
             for i, r in enumerate(out["sync_results"] + out["async_results"])]
    diffs += [check_histogram(r, want[N_SYNC + i], 256 * 256)
              for i, r in enumerate(out["queued_results"])]
    for name, n in out["launches"].items():
        if n < 1:
            raise AssertionError(f"kernel {name} never launched (7b)")
    ratio = overlap_gauge.value()
    if not ratio > 0:
        raise AssertionError(f"ai4e_batch_overlap_ratio {ratio}: no h2d "
                             "overlapped an execution")
    pipelined = {
        "async_tiles_per_s": N_ASYNC / out["async_s"],
        "phase4_async_tiles_per_s": e2e["async_tiles_per_s"],
        "sync_p50_ms": statistics.median(out["sync_ms"]),
        "phase4_sync_p50_ms": e2e["sync_p50_ms"],
        "overlap_ratio": ratio,
        "overlap_ratio_after_http": out["http_overlap_ratio"],
        "queued_tiles_per_s": N_ASYNC / out["queued_s"],
        "batches_in_bucket_64": batches_over(out["metrics"], 16),
        "retries_503": out["retries_503"],
        "max_count_diff_px": max(diffs),
        "launches": out["launches"],
    }
    log(f"runtime 7b: pipelined, double-buffered: {json.dumps(pipelined)}")
    log(f"runtime 7d: ladder: {json.dumps(ladder)}")
    (drained, drain_ms, refused, status, resumed, served, results,
     in_flight) = drain
    if drained[0] != 200 or drained[1]["state"] != "drained" or \
            not drained[1]["clean"]:
        raise AssertionError(f"drain answered {drained}")
    if refused != [(503, "1"), (503, "1")]:
        raise AssertionError(f"while drained: {refused}")
    if status["state"] != "drained" or resumed != {"state": "active"}:
        raise AssertionError(f"drain status {status}, resume {resumed}")
    if in_flight < 1:
        raise AssertionError("no batch was on the card when the drain began")
    for i, r in enumerate(results):
        check_histogram(r, want_burst[i], 256 * 256)
    check_histogram(served, want_burst[0], 256 * 256)
    drain_record = {"drain_ms": drain_ms, "retired": drained[1]["retired"],
                    "batches_in_flight_at_drain": in_flight,
                    "tasks_completed": len(results)}
    log(f"runtime 7e: drain: {json.dumps(drain_record)}")
    return {"pipelined": pipelined, "ladder": ladder, "drain": drain_record}


def derive_ladder_at(worker) -> dict:
    """7d: a demand concentrated at LADDER_SIZE, outside land cover's factory
    ladder, through the ladder manager: the new bucket's graph is captured
    before the swap and serves as ``execute``, equal to eager."""
    from ai4e_tpu_torch.runtime.ladder import LadderManager

    runtime = worker.runtime
    manager = LadderManager(runtime, min_observations=4, dwell_s=0.0,
                            period_s=1e9, metrics=worker.service.metrics,
                            persist_path=str(ROOT / "build" / "chip_smoke"
                                             / "ladders.json"))
    for _ in range(16):
        manager.observe_cut("landcover", LADDER_SIZE)
    t0 = time.perf_counter()
    outcome = manager.derive_now("landcover")
    derive_s = time.perf_counter() - t0
    servable = runtime.models["landcover"]
    if outcome != "swapped" or LADDER_SIZE not in servable.batch_buckets:
        raise AssertionError(f"derive: {outcome}, {servable.batch_buckets}")
    if ("landcover", LADDER_SIZE) not in runtime.graphs:
        raise AssertionError("the derived bucket has no graph")
    x = np.random.default_rng(SEED + 72).integers(
        0, 256, (LADDER_SIZE, 256, 256, 3), np.uint8)
    got, _, phases = runtime.run_batch_phases("landcover", x)
    if "execute" not in phases:
        raise AssertionError(f"the derived bucket ran as {phases}")
    with torch.inference_mode():
        want = servable.apply_fn(servable.module, torch.from_numpy(x).cuda())
    want = {k: v.cpu().numpy() for k, v in want.items()}
    exact = same_outputs(got, want)
    if not exact and (np.abs(got["counts"].astype(np.int64) - want["counts"])
                      .max() > COUNT_TOLERANCE * 256 * 256):
        raise AssertionError("the derived bucket's counts differ from eager")
    return {"ladder": list(servable.batch_buckets), "derive_s": derive_s,
            "execute_ms": phases["execute"] * 1e3,
            "equal_to_eager": "bit for bit" if exact else "within 1%"}


async def drain_under_burst(http, base: str, worker, batcher,
                            images: np.ndarray) -> tuple:
    """7e: ``POST /worker/drain`` once an async burst is all cut and a batch
    is on the card; then a sync and an async request (refused), ``GET``
    (drained), the burst's tasks (completed), ``POST /worker/resume`` and
    one sync request."""
    done = "completed - class_histogram"
    tasks = [t for t, _ in await asyncio.gather(*(
        submit_task(http, base + "/classify-async", npy_bytes(img))
        for img in images))]
    # Every request is in the batcher once its task reads running (the
    # submit follows with no await between); once none is pending, the
    # last cut has just gone to the card.
    deadline = time.perf_counter() + 60
    while (batcher.pending_count
           or any(worker.store.get(t).status == "created" for t in tasks)):
        if time.perf_counter() > deadline:
            raise AssertionError("the burst never left the queue")
        await asyncio.sleep(0.001)
    in_flight = len(batcher._inflight_execs)
    t0 = time.perf_counter()
    async with http.post(base + "/worker/drain") as r:
        drained = (r.status, await r.json())
    drain_ms = (time.perf_counter() - t0) * 1e3
    refused = []
    for path in ("/classify", "/classify-async"):
        async with http.post(base + path, data=npy_bytes(images[0]),
                             headers=OCTET) as r:
            refused.append((r.status, r.headers.get("X-Draining")))
    async with http.get(base + "/worker/drain") as r:
        status = await r.json()
    await asyncio.gather(*(await_task(http, base, t, done) for t in tasks))
    async with http.post(base + "/worker/resume") as r:
        resumed = await r.json()
    served = await post_sync(http, base + "/classify", npy_bytes(images[0]))
    results = [json.loads(worker.store.get_result(t)[0]) for t in tasks]
    return (drained, drain_ms, refused, status, resumed, served, results,
            in_flight)


def phase_runtime(e2e: dict, trained_npz: str) -> dict:
    log("runtime: CUDA graphs, pipelining, reload, ladder, drain")
    graphs = phase_graphs()
    served = phase_served_runtime(e2e)
    torch.cuda.empty_cache()
    reload = phase_reload(trained_npz)
    record = {"card": CARD["smi"], "graphs": graphs, **served,
              "reload": reload}
    log(f"runtime: {json.dumps(record)}")
    return record


# -- phase 8: the camera-trap ensemble ---------------------------------------

CT_MODELS = ("megadetector", "species")
N_CT_TASKS = 32        # async /detect-async requests, 512 px scenes
N_CT_INTERACTIVE = 16  # interactive species requests beside the batch API
CT_SHAPES = {"megadetector": (1, 8), "species": (1, 16, 64)}
# tests/test_torch_detector.py's rule: scores within SCORE_TOL and boxes
# within BOX_TOL px, except where the reference's own decision (threshold,
# top-k cut, 3x3 peak NMS) lies within SCORE_TOL.
CT_SCORE_TOL = 0.0125
CT_BOX_TOL = 0.6
CT_THRESHOLD = 0.2
CT_GAP = 1e-2        # species class must agree where the top-two gap exceeds it
CT_CONF_ATOL = 1e-2
CT_LOGIT_ATOL = 5e-3  # a species logit, replay against eager (cuDNN's choice)


def scenes(n: int, seed: int, size: int = 512) -> np.ndarray:
    """uint8 camera-trap-like images made from ``seed``: a smooth
    background with 2-5 coloured rectangles, so detections vary."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        img = np.empty((size, size, 3), np.float32)
        for c in range(3):
            fy, fx, phase = rng.uniform(0.5, 2), rng.uniform(0.5, 2), \
                rng.uniform(0, 6)
            img[..., c] = 80 + 60 * np.sin(2 * np.pi * (fy * yy + fx * xx)
                                           + phase)
        for _ in range(rng.integers(2, 6)):
            h, w = rng.integers(size // 16, size // 3, 2)
            y, x = rng.integers(0, size - h), rng.integers(0, size - w)
            img[y:y + h, x:x + w] = rng.integers(0, 256, 3)
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


def camera_trap_models() -> list[dict]:
    """deploy/specs/models.json's megadetector and species entries, without
    their checkpoints (seed-0 random weights)."""
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    models = []
    for model in spec["models"]:
        if model["name"] in CT_MODELS:
            model = json.loads(json.dumps(model))
            model.pop("checkpoint")
            models.append(model)
    return models


def check_normalize_camera_trap() -> dict:
    """8a: normalize bit for bit at the camera-trap shapes (the detector's
    buckets 1 and 8 at 512 px, the species' buckets 1, 16 and 64 at 224 px,
    a 16-crop stack being bucket 16), timed at the largest of each beside
    its bound and the ``copy_`` yardstick."""
    from ai4e_tpu_torch.ops import image_preprocess as ip

    gen = torch.Generator().manual_seed(SEED + 80)
    for b in CT_SHAPES["megadetector"]:
        check_normalize((b, 512, 512, 3), None, None, gen)
    for b in CT_SHAPES["species"] + (5,):
        check_normalize((b, 224, 224, 3), None, None, gen)
    scale, bias = ip.channel_affine(None, None, 3)
    out = {}
    for shape in ((8, 512, 512, 3), (64, 224, 224, 3)):
        x = torch.randint(0, 256, shape, dtype=torch.uint8,
                          generator=gen).cuda()
        n = x.numel()
        bound, by = bound_ms(n * 1 + n * 4, 2 * n)
        out["x".join(map(str, shape))] = {
            "ms": device_ms(lambda: ip.normalize_image(x)),
            "plain_ms": device_ms(
                lambda: ip.normalize_image_plain(x, scale, bias)),
            "copy_yardstick_ms": device_ms(lambda: torch.empty(
                x.shape, dtype=torch.float32, device=x.device).copy_(x)),
            "bound_ms": bound, "bound_by": by}
    log(f"camera_trap 8a: normalize {json.dumps(out)}")
    return out


def same_detector_or_species(name: str, got, want) -> str:
    """A replay's outputs against eager's: ``"exact"``, or within the
    tests' rules (cuDNN may pick another algorithm under capture); raises
    otherwise."""
    if not isinstance(got, dict):
        got, want = {"logits": got}, {"logits": want}
    if same_outputs(got, want):
        return "exact"
    if "logits" in got:
        diff = float(np.abs(got["logits"] - want["logits"]).max())
        if diff > CT_LOGIT_ATOL:
            raise AssertionError(f"{name}: replay logits off by {diff}")
        return f"logits within {diff}"
    diff = float(np.abs(np.sort(got["scores"], axis=1)
                        - np.sort(want["scores"], axis=1)).max())
    if diff > CT_SCORE_TOL:
        raise AssertionError(f"{name}: replay scores off by {diff}")
    return f"scores within {diff}"


def phase_camera_trap_graphs() -> dict:
    """8b: each camera-trap bucket's replay against eager on the same
    batch, deployed widths, seed-0 weights; eager and replay ms."""
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    runtime = ModelRuntime("cuda")
    for model in camera_trap_models():
        kwargs = {k: v for k, v in model.items() if k not in (
            "family", "async_path", "pipeline_to", "batch")}
        runtime.register(build_servable(model["family"], **kwargs))
    t0 = time.perf_counter()
    runtime.warmup()
    record: dict = {"warmup_and_capture_s": time.perf_counter() - t0,
                    "buckets": {}}
    rng = np.random.default_rng(SEED + 81)
    for name, servable in runtime.models.items():
        if servable.batch_buckets != CT_SHAPES[name]:
            raise AssertionError(f"{name} buckets {servable.batch_buckets}")
        for bucket in servable.batch_buckets:
            graph = runtime.graphs[(name, bucket)]
            if graph.launches != {"normalize_image": 1}:
                raise AssertionError(f"{name} bucket {bucket} captured "
                                     f"{graph.launches}")
            traced, traces = replay_kernels(graph, f"{name} bucket {bucket}")
            size = servable.input_shape[0]
            x = (scenes(bucket, SEED + bucket) if size == 512 else
                 rng.integers(0, 256, (bucket, size, size, 3), np.uint8))
            got = runtime.run_batch(name, x)
            dev = torch.from_numpy(x).cuda()
            with torch.inference_mode():
                eager_out = servable.apply_fn(servable.module, dev)
            want = ({k: v.cpu().numpy() for k, v in eager_out.items()}
                    if isinstance(eager_out, dict) else eager_out.cpu().numpy())
            same = same_detector_or_species(f"{name}/{bucket}", got, want)
            graph.static_in.copy_(dev)

            def eager():
                with torch.inference_mode():
                    servable.apply_fn(servable.module, dev)

            record["buckets"][f"{name}/{bucket}"] = {
                "eager_ms": stream_ms(eager),
                "replay_ms": stream_ms(graph.graph.replay),
                "replay_equals_eager": same,
                "replay_kernels": traced, "traces": traces}
    record["graph_pool_mib"] = runtime.graph_pool_bytes() / 2 ** 20
    record["graphs"] = len(runtime.graphs)
    log(f"camera_trap 8b: graphs against eager: {json.dumps(record)}")
    del runtime
    torch.cuda.empty_cache()
    return record


def camera_trap_specs(store_url: str, worker_url: str) -> tuple[dict, dict]:
    """The two models behind the control plane at ``store_url``, the
    detector's crops handed to the species batch endpoint of the worker at
    ``worker_url``, and routes.json's three camera-trap routes to it, as
    written but for the host."""
    from urllib.parse import urlparse

    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    models = camera_trap_models()
    for model in models:
        if "pipeline_to" in model:
            handoff = model["pipeline_to"]
            handoff["endpoint"] = worker_url + urlparse(
                handoff["endpoint"]).path
    routes = json.loads((ROOT / "deploy/specs/routes.json").read_text())
    apis = []
    for api in routes["apis"]:
        path = urlparse(api["backend"]).path
        if (api.get("prefix", "").startswith("/v1/camera-trap/")
                or path.endswith("/classify-species-batch-async")):
            api["backend"] = worker_url + path
            apis.append(api)
    return ({"service_name": spec["service_name"], "prefix": spec["prefix"],
             "taskstore": store_url, "models": models}, {"apis": apis})


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x.astype(np.float64)))


def detector_reference(servable, images: np.ndarray) -> list[dict]:
    """Each image's detections recomputed on the card with the plain
    normalize and the same weights, eagerly, in batches of 8, with what
    the comparison needs: each row's peak (row, col, class), the sigmoid
    heatmap, the offsets and the top-k cut's score."""
    from ai4e_tpu_torch.models import decode_detections
    from ai4e_tpu_torch.ops.image_preprocess import (channel_affine,
                                                     normalize_image_plain)

    scale, bias = channel_affine(None, None, 3)
    out = []
    with torch.inference_mode():
        for i in range(0, len(images), 8):
            x = normalize_image_plain(torch.from_numpy(images[i:i + 8]).cuda(),
                                      scale, bias)
            heads = servable.module(x)
            dec = decode_detections(heads)
            zeros = torch.zeros_like(heads["wh"])
            peaks = decode_detections({"heatmap": heads["heatmap"],
                                       "wh": zeros, "offset": zeros})
            host = {k: v.cpu().numpy() for k, v in dec.items()}
            boxes = peaks["boxes"].cpu().numpy()
            pix = np.stack([boxes[..., 0] / 8, boxes[..., 1] / 8,
                            peaks["classes"].cpu().numpy()],
                           axis=-1).round().astype(int)
            heat = sigmoid_np(heads["heatmap"].cpu().numpy())
            offset = heads["offset"].cpu().numpy()
            for j in range(len(host["scores"])):
                result = servable.postprocess(
                    {k: v[j] for k, v in host.items()})
                out.append({"detections": result["detections"],
                            "pixels": pix[j], "heat": heat[j],
                            "offset": offset[j],
                            "cut": float(host["scores"][j, -1])})
    return out


def ct_ambiguous(ref: dict, pixel) -> bool:
    """Whether the reference's decisions on a peak are within
    ``CT_SCORE_TOL``: its score against the threshold or the top-k cut,
    or against a 3x3 neighbour's (the NMS)."""
    y, x, c = pixel
    heat = ref["heat"]
    s = heat[y, x, c]
    if (abs(s - CT_THRESHOLD) <= CT_SCORE_TOL
            or abs(s - ref["cut"]) <= CT_SCORE_TOL):
        return True
    window = heat[max(y - 1, 0):y + 2, max(x - 1, 0):x + 2, c]
    return bool((np.sort(np.abs(window - s).ravel())[1:]
                 <= CT_SCORE_TOL).any())


def served_pixel(ref: dict, det: dict):
    """The peak a served detection decodes: the pixel of its class whose
    reference offset puts the box's centre within ``CT_BOX_TOL``."""
    y0, x0, y1, x1 = det["box"]
    cy, cx = (y0 + y1) / 16, (x0 + x1) / 16
    h, w = ref["offset"].shape[:2]
    rows, cols = np.mgrid[0:h, 0:w]
    near = ((np.abs(cy - rows - ref["offset"][..., 0]) <= CT_BOX_TOL / 8)
            & (np.abs(cx - cols - ref["offset"][..., 1]) <= CT_BOX_TOL / 8))
    hits = np.argwhere(near)
    if len(hits) == 0:
        raise AssertionError(f"served detection {det} decodes no peak")
    best = min(hits, key=lambda p: abs(
        ref["heat"][p[0], p[1], det["class_id"]] - det["score"]))
    return (int(best[0]), int(best[1]), det["class_id"])


def check_detections(served: list[dict], ref: dict) -> int:
    """The served list against the reference under the tests' rule;
    returns the detections held."""
    index = {tuple(int(v) for v in ref["pixels"][k]): k
             for k in range(len(ref["detections"]))}
    held = 0
    for det in served:
        pixel = served_pixel(ref, det)
        if ct_ambiguous(ref, pixel):
            continue
        if pixel not in index:
            raise AssertionError(f"served {det} at {pixel}: not in the "
                                 "reference's list")
        want = ref["detections"][index[pixel]]
        if (abs(want["score"] - det["score"]) > CT_SCORE_TOL
                or np.abs(np.subtract(want["box"], det["box"])).max()
                > CT_BOX_TOL):
            raise AssertionError(f"served {det} vs reference {want}")
        held += 1
    served_pixels = {served_pixel(ref, d) for d in served}
    for k, want in enumerate(ref["detections"]):
        pixel = tuple(int(v) for v in ref["pixels"][k])
        if not ct_ambiguous(ref, pixel) and pixel not in served_pixels:
            raise AssertionError(f"reference {want} at {pixel} not served")
    return held


def species_reference(servable, stacks: list[np.ndarray]) -> list[np.ndarray]:
    """Logits of each crop stack on the card, plain normalize, eager."""
    from ai4e_tpu_torch.ops.image_preprocess import (channel_affine,
                                                     normalize_image_plain)

    scale, bias = channel_affine(None, None, 3)
    with torch.inference_mode():
        return [servable.module(normalize_image_plain(
            torch.from_numpy(s).cuda(), scale, bias)).cpu().numpy()
            for s in stacks]


async def await_terminal(http, gateway: str, task_id: str,
                         headers: dict | None = None) -> dict:
    from ai4e_tpu_torch.taskstore import TaskStatus

    while True:
        async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                            params={"wait": "60"}, headers=headers) as r:
            if r.status != 200:
                raise AssertionError(f"poll of {task_id}: {r.status} "
                                     f"{await r.text()}")
            record = await r.json()
        if TaskStatus.canonical(record["Status"]) in TaskStatus.TERMINAL:
            return record


async def task_result(http, gateway: str, task_id: str,
                      stage: str | None = None):
    params = {"taskId": task_id, **({"stage": stage} if stage else {})}
    async with http.get(gateway + "/v1/taskstore/result",
                        params=params) as r:
        if r.status != 200:
            raise AssertionError(f"result of {task_id} ({stage}): {r.status}")
        return json.loads(await r.read())


async def species_interactive(http, worker: str, crops: np.ndarray) -> list:
    """``N_CT_INTERACTIVE`` sync species requests at once to the worker;
    each one's ms."""
    async def one(crop) -> float:
        t0 = time.perf_counter()
        await post_sync(http, worker + "/v1/models/species", npy_bytes(crop))
        return (time.perf_counter() - t0) * 1e3

    return list(await asyncio.gather(*(one(c) for c in crops)))


async def drive_camera_trap(gateway: str, worker: str, procs: dict,
                            logs: dict, images: np.ndarray,
                            crops: np.ndarray) -> dict:
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        log(f"camera_trap: worker up in {time.perf_counter() - t0:.1f}s")

        async def one(img: np.ndarray) -> tuple[float, float, str, dict]:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/camera-trap/detect-async",
                                 data=npy_bytes(img), headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"detect-async {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            record = await await_terminal(http, gateway, task_id)
            return t0, time.perf_counter(), task_id, record

        runs = await asyncio.gather(*(one(img) for img in images))
        out = {"runs": runs, "stage": [], "final": []}
        for _, _, task_id, _ in runs:
            out["stage"].append(await task_result(http, gateway, task_id,
                                                  "megadetector"))
            out["final"].append(await task_result(http, gateway, task_id))

        # The batch API beside interactive requests: a sync stack of 64
        # crops alone, then again with an async 64-item stack and
        # N_CT_INTERACTIVE interactive requests running beside it.
        batch_url = worker + "/v1/models/species-batch"
        body = npy_bytes(crops)
        out["interactive_alone_ms"] = await species_interactive(
            http, worker, crops[:N_CT_INTERACTIVE])
        t0 = time.perf_counter()
        alone = await post_sync(http, batch_url, body)
        out["batch_alone_ms"] = (time.perf_counter() - t0) * 1e3
        async with http.post(
                worker + "/v1/models/classify-species-batch-async",
                data=body, headers=OCTET) as r:
            if r.status != 200:
                raise AssertionError(f"batch-async {r.status}")
            stack_task = (await r.json())["TaskId"]
        t0 = time.perf_counter()
        beside, interactive = await asyncio.gather(
            post_sync(http, batch_url, body),
            species_interactive(http, worker, crops[:N_CT_INTERACTIVE]))
        out["batch_beside_ms"] = (time.perf_counter() - t0) * 1e3
        out["interactive_beside_ms"] = interactive
        out["stack_task"] = await await_terminal(http, gateway, stack_task)
        for got in (alone, beside):
            if got["count"] != len(crops) or got["failed"]:
                raise AssertionError(f"species batch: {got['count']} items, "
                                     f"{got['failed']} failed")
        out["batch_alone"] = alone
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
        async with http.get(worker + "/metrics") as r:
            out["wk_metrics"] = await r.text()
    return out


def launches_by_model(log_text: str) -> dict:
    marker = "kernel launches by model while serving "
    lines = [line for line in log_text.splitlines() if marker in line]
    if not lines:
        raise AssertionError("the worker logged no per-model launches")
    return json.loads(lines[-1].split(marker, 1)[1])


def phase_camera_trap(kernels: list[dict]) -> dict:
    """Phase 8: normalize at the camera-trap shapes (a), each bucket's
    graph against eager (b), then the ensemble as separate processes (c):
    the port's control plane and worker serving megadetector -> crops ->
    species under one TaskId; this process is the client, through the
    gateway for the pipeline."""
    import gc

    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.handoffs import crops_handoff

    norm = next(k for k in kernels if k["name"] == "normalize_image")
    norm["camera_trap_shapes"] = check_normalize_camera_trap()
    graphs = phase_camera_trap_graphs()

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = camera_trap_specs(gateway, worker)
    (out_dir / "camera_trap_models.json").write_text(json.dumps(models))
    (out_dir / "camera_trap_routes.json").write_text(json.dumps(routes))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY))
    logs = {"cp": out_dir / "camera_trap_control_plane.log",
            "wk": out_dir / "camera_trap_worker.log"}
    images = scenes(N_CT_TASKS, SEED + 82)
    crops = np.random.default_rng(SEED + 83).integers(
        0, 256, (64, 224, 224, 3), np.uint8)
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes",
             str(out_dir / "camera_trap_routes.json"), "--port",
             str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "camera_trap_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             "cuda"], logs["wk"], env)
        out = asyncio.run(drive_camera_trap(gateway, worker, procs, logs,
                                            images, crops))
        stop_child(procs["wk"], logs["wk"], "camera-trap worker")
        stop_child(procs["cp"], logs["cp"], "camera-trap control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wk_log = logs["wk"].read_text(errors="replace")
    if "serving ['megadetector', 'species'] on cuda" not in wk_log:
        raise AssertionError(f"the worker did not serve on cuda:\n"
                             f"{wk_log[-4000:]}")
    by_model = launches_by_model(wk_log)
    for model in CT_MODELS:
        if by_model.get(model, {}).get("normalize_image", 0) < 1:
            raise AssertionError(f"normalize never launched for {model}: "
                                 f"{by_model}")
    launches = served_launches(wk_log)
    failed = metric_sum(out["cp_metrics"], "ai4e_dispatch_total",
                        outcome="failed") + metric_sum(
        out["cp_metrics"], "ai4e_dispatch_total", outcome="dead_letter")
    if failed:
        raise AssertionError(f"{failed} deliveries failed")
    if not out["stack_task"]["Status"].startswith("completed - 64 images, 0"):
        raise AssertionError(f"async stack: {out['stack_task']}")

    # Every answer against the same seed-0 weights on the card.
    kwargs = {m["name"]: {k: v for k, v in m.items() if k not in (
        "family", "async_path", "pipeline_to", "batch")}
        for m in models["models"]}
    detector = build_servable("detector", **kwargs["megadetector"])
    detector.module.cuda()
    species = build_servable("resnet", **kwargs["species"])
    species.module.cuda()
    refs = detector_reference(detector, images)
    handoff = crops_handoff("x", crop_size=224, max_crops=16)
    held = classes_held = 0
    counts = []
    for i, ((_, _, task_id, record), stage, final) in enumerate(
            zip(out["runs"], out["stage"], out["final"])):
        dets = stage["detections"]
        if not dets:
            raise AssertionError(f"task {task_id}: no detection >= 0.2")
        want_count = min(16, len(dets))
        if record["Status"] != f"completed - {want_count} images, 0 errors":
            raise AssertionError(f"task {task_id}: {record}")
        if final["count"] != want_count or final["failed"]:
            raise AssertionError(f"task {task_id}: final {final['count']} "
                                 f"items, {final['failed']} failed")
        held += check_detections(dets, refs[i])
        _, body = handoff(stage, images[i])
        logits, = species_reference(species, [np.load(io.BytesIO(body))])
        for item, row in zip(final["items"], logits):
            top2 = np.sort(row)[-2:]
            probs = np.exp(row - row.max()) / np.exp(row - row.max()).sum()
            result = item["result"]
            if abs(result["confidence"] - probs.max()) > CT_CONF_ATOL:
                raise AssertionError(f"task {task_id} item {item['index']}: "
                                     f"{result} vs {probs}")
            if top2[1] - top2[0] > CT_GAP:
                if result["class_id"] != int(row.argmax()):
                    raise AssertionError(f"task {task_id} item "
                                         f"{item['index']}: {result}")
                classes_held += 1
        counts.append(final["count"])
    del detector, species
    torch.cuda.empty_cache()

    latency = sorted((t1 - t0) * 1e3 for t0, t1, _, _ in out["runs"])
    span = (max(t1 for _, t1, _, _ in out["runs"])
            - min(t0 for t0, _, _, _ in out["runs"]))
    report = {
        "card": CARD["smi"], "clients": "another process",
        "detect_tasks": N_CT_TASKS,
        "detect_tasks_per_s": N_CT_TASKS / span,
        "task_p50_ms": statistics.median(latency),
        "task_p95_ms": float(np.percentile(latency, 95)),
        "crops_per_task": statistics.mean(counts),
        "batch_sizes": {m: batch_sizes(out["wk_metrics"], m)
                        for m in CT_MODELS},
        "graph_pool_mib": graphs["graph_pool_mib"],
        "redeliveries_503": metric_sum(out["cp_metrics"],
                                       "ai4e_dispatch_total",
                                       outcome="backpressure"),
        "detections_held": held, "species_classes_held": classes_held,
        "species_batch64_alone_ms": out["batch_alone_ms"],
        "species_batch_images_per_s": 64e3 / out["batch_alone_ms"],
        "species_batch64_beside_ms": out["batch_beside_ms"],
        "interactive_p50_alone_ms": statistics.median(
            out["interactive_alone_ms"]),
        "interactive_p50_beside_stack_ms": statistics.median(
            out["interactive_beside_ms"]),
        "launches_while_serving": launches,
        "launches_by_model": by_model,
    }
    norm["launches_camera_trap"] = by_model
    log(f"camera_trap: {json.dumps(report)}")
    return {"graphs": graphs, "served": report}


# -- phase 9: the MoE and ViT families -----------------------------------------

MOE_BUCKETS = (1, 16, 64)          # deploy/specs/models.json's moe buckets
MOE_HEAD = (1, 1024, 128)          # (H, S, D) of its attention
MOE_TRAIN = (16, *MOE_HEAD)        # train_moe's batch, one layer
N_MOE_SYNC = 4
N_MOE_ASYNC = 64
VIT_ROUTE = ("/classify", "/classify-async", "completed - class_id")


def moe_model() -> dict:
    """deploy/specs/models.json's moe entry, as it is."""
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    return json.loads(json.dumps(next(m for m in spec["models"]
                                      if m["name"] == "moe")))


def phase_moe_kernels(kernels: list[dict]) -> None:
    """9a: the flash forward at the moe buckets' shapes and the backward
    at its training shape against their plain versions (phases 3 and 6's
    tolerances; the backward twice under the deterministic flag,
    bit-equal), each timed by CUDA events beside SDPA and its bound. The
    records land on the two flash rows of the kernels line."""
    import torch.nn.functional as F

    from ai4e_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 90)

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    fwd = {}
    for b in MOE_BUCKETS:
        shape = (b, *MOE_HEAD)
        q, k, v = (rand(shape) for _ in range(3))
        err, lse_err = check_flash(q, k, v, False, f"moe {shape} bf16")
        flops = 4 * b * MOE_HEAD[0] * MOE_HEAD[1] ** 2 * MOE_HEAD[2]
        bound, by = bound_ms(4 * q.numel() * q.element_size(), flops,
                             BF16_OPS_PER_S)
        rec = {"ms": device_ms(lambda: fa.flash_attention(q, k, v)),
               "plain_ms": device_ms(lambda: flash_plain_chunked(q, k, v),
                                     reps=5),
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v)),
               "bound_ms": bound, "bound_by": by, "max_abs_err": err,
               "lse_max_abs_err": lse_err,
               # One CTA per (b*h, 128 query rows), against 132 SMs.
               "ctas": b * MOE_HEAD[0] * MOE_HEAD[1] // 128}
        if shape == MOE_TRAIN:
            rec["lse_ms"] = device_ms(lambda: fa.flash_attention(
                q, k, v, return_lse=True))
        fwd["x".join(map(str, shape))] = rec
    q, k, v, do = (rand(MOE_TRAIN) for _ in range(4))
    errs = check_flash_bwd(q, k, v, do, False, f"moe training {MOE_TRAIN}")
    check_flash_bwd_ordered(q, k, v, do, False, f"moe training {MOE_TRAIN}")
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)
    b, h, s, d = MOE_TRAIN
    bound, by = bound_ms(8 * b * h * s * d * 2 + b * h * s * 4,
                         2 * 5 * b * h * s * s * d, BF16_OPS_PER_S)
    bwd = {"ms": device_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                         do)),
           "plain_ms": device_ms(lambda: flash_bwd_plain_chunked(
               q, k, v, out, lse, do), reps=5),
           "library_ms": device_ms(lambda: torch.autograd.grad(
               sdpa_out, (qg, kg, vg), do, retain_graph=True)),
           "bound_ms": bound, "bound_by": by,
           "dkv_max_abs_err": errs[0], "dq_max_abs_err": errs[1]}
    with deterministic_algorithms():
        bwd["deterministic_ms"] = device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, out, lse, do))
    rows = {k["name"]: k for k in kernels}
    rows["flash_attention"]["moe_shapes"] = fwd
    rows["flash_attention_bwd"]["moe_training_shape"] = {
        "x".join(map(str, MOE_TRAIN)): bwd}
    log(f"moe 9a: flash forward {json.dumps(fwd)}")
    log(f"moe 9a: flash backward {json.dumps(bwd)}")


def phase_moe_train() -> dict:
    """9b: ``train_moe`` at its defaults (JAX's recipe geometry, the
    deployed entry's widths) on the card, dense dispatch through the flash
    forward with lse and the backward; the launch counts are set to 0 just
    before and read just after. Evaluated with the capacity dispatch;
    saved by ``make_checkpoint`` as ``build/chip_smoke/moe.npz``."""
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.train.make_checkpoints import (MIN_EVAL,
                                                       make_checkpoint,
                                                       train_moe)

    deployed = moe_model()
    fa.launches = fa.bwd_launches = 0
    result = train_moe(device="cuda")
    launches = {"flash_attention": fa.launches,
                "flash_attention_bwd": fa.bwd_launches}
    kwargs, losses = result["kwargs"], result["losses"]
    for key, value in kwargs.items():
        if deployed.get(key, value) != value:
            raise AssertionError(f"train_moe's {key}={value}, the deployed "
                                 f"entry's {deployed[key]}")
    steps, depth = len(losses), kwargs["depth"]
    for name, n in launches.items():
        if n < depth * steps:
            raise AssertionError(f"{name} launched {n} times in {steps} "
                                 f"steps of depth {depth}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training loss is not finite: {losses}")
    entry = make_checkpoint("moe", str(ROOT / "build" / "chip_smoke"),
                            min_eval=MIN_SERVED_ACC, result=result)
    phases = result["phases_ms"][1:]  # the first step pays one-off costs
    median_ms = statistics.median(sum(p.values()) for p in phases)
    record = {
        "steps": steps, "batch": result["batch"],
        "loss_every_25": losses[::25], "loss_last": losses[-1],
        "step_ms_median": median_ms,
        "phase_ms_median": {k: statistics.median(p[k] for p in phases)
                            for k in phases[0]},
        "sequences_per_s": result["batch"] * 1e3 / median_ms,
        "loop_sequences_per_s": steps * result["batch"]
        / result["loop_seconds"],
        "peak_memory_gib": result["peak_bytes"] / 2 ** 30,
        "eval_accuracy_capacity_dispatch": result["eval"]["accuracy"],
        f"reached_min_eval_{MIN_EVAL}": result["eval"]["accuracy"] >= MIN_EVAL,
        "launches": launches, "npz": entry["path"]}
    log(f"moe 9b: train {json.dumps(record)}")
    return record


def moe_held_out(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The first ``n`` sequences (and labels) drawn as ``train_moe``'s
    eval draws them (batches of 16 from seed + 1): the first 64 are its
    eval set."""
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch

    model = moe_model()
    rng = np.random.default_rng(SEED + 1)
    draws = [longcontext_batch(rng, 16, model["seq_len"], model["vocab_size"],
                               model["num_classes"])
             for _ in range(-(-n // 16))]
    seqs, labels = (np.concatenate(x)[:n] for x in zip(*draws))
    return seqs, labels


def phase_moe_graphs(npz: str) -> dict:
    """9c, in process: the deployed entry with 9b's ``.npz`` in a
    ``ModelRuntime``; each bucket's replay against an eager apply on the
    same held-out batch (``torch.equal``), the graph's launches (depth flash
    calls) checked by a profiler trace of one replay, eager and replay
    ms."""
    from ai4e_tpu_torch.cli import restore_checkpoint
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    model = moe_model()
    kwargs = {k: v for k, v in model.items() if k not in (
        "family", "sync_path", "async_path", "checkpoint")}
    runtime = ModelRuntime("cuda")
    servable = build_servable("moe", **kwargs)
    restore_checkpoint(servable, npz)
    runtime.register(servable)
    t0 = time.perf_counter()
    runtime.warmup()
    record: dict = {"warmup_and_capture_s": time.perf_counter() - t0,
                    "buckets": {}}
    seqs, _ = moe_held_out(max(MOE_BUCKETS))
    for bucket in servable.batch_buckets:
        graph = runtime.graphs[("moe", bucket)]
        if graph.launches != {"flash_attention": model["depth"]}:
            raise AssertionError(f"moe bucket {bucket} captured "
                                 f"{graph.launches}")
        traced, traces = replay_kernels(graph, f"moe bucket {bucket}")
        x = seqs[:bucket]
        got = runtime.run_batch("moe", x)
        dev = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            want = servable.apply_fn(servable.module, dev).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"moe bucket {bucket}: replay logits differ "
                                 "from eager")
        graph.static_in.copy_(dev)

        def eager():
            with torch.inference_mode():
                servable.apply_fn(servable.module, dev)

        record["buckets"][str(bucket)] = {
            "eager_ms": stream_ms(eager),
            "replay_ms": stream_ms(graph.graph.replay),
            "replay_kernels": traced, "traces": traces}
    record["replay_equals_eager"] = "bit for bit"
    record["graph_pool_mib"] = runtime.graph_pool_bytes() / 2 ** 20
    log(f"moe 9c: graphs against eager: {json.dumps(record)}")
    del runtime, servable
    torch.cuda.empty_cache()
    return record


def moe_reference_logits(npz: str, seqs: np.ndarray) -> np.ndarray:
    """The trained weights on the card with the plain ops (full attention,
    capacity dispatch), 16 sequences at a time."""
    from ai4e_tpu_torch.checkpoint import load_params
    from ai4e_tpu_torch.convert import moe_state_dict_from_flax
    from ai4e_tpu_torch.models import create_moe

    model = moe_model()
    keys = ("seq_len", "input_dim", "dim", "depth", "heads", "num_experts",
            "num_classes", "vocab_size", "dispatch", "capacity_factor")
    ref = create_moe(**{k: model[k] for k in keys}, attention="full",
                     device="cuda")
    ref.load_state_dict(moe_state_dict_from_flax(load_params(npz)))
    with torch.inference_mode():
        out = torch.cat([ref(torch.from_numpy(seqs[i:i + 16].astype(
            np.int32)).cuda()) for i in range(0, len(seqs), 16)])
    return out.cpu().numpy()


def moe_specs(store_url: str, worker_url: str,
              npz: str) -> tuple[dict, dict]:
    """The deployed moe entry with 9b's checkpoint behind the control plane
    at ``store_url``, and routes.json's two moe routes, ``autoscale``
    included, to the worker at ``worker_url``."""
    from urllib.parse import urlparse

    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    model = moe_model()
    model["checkpoint"] = npz
    routes = json.loads((ROOT / "deploy/specs/routes.json").read_text())
    apis = []
    for api in routes["apis"]:
        if api.get("prefix", "").startswith("/v1/moe/"):
            api["backend"] = worker_url + urlparse(api["backend"]).path
            apis.append(api)
    return ({"service_name": spec["service_name"], "prefix": spec["prefix"],
             "taskstore": store_url, "models": [model]}, {"apis": apis})


def phase_moe_served(npz: str, train_eval: float) -> dict:
    """9c, as the platform serves it: the port's control plane and worker
    (``--device cuda``) as two child processes, the deployed entry
    restored from 9b's ``.npz``; this process sends 4 sync requests, then
    64 async at once, of the trainer's held-out sequences as uint16 ids,
    through the gateway only."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "chip_smoke"
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = moe_specs(gateway, worker, npz)
    (out_dir / "moe_models.json").write_text(json.dumps(models))
    (out_dir / "moe_routes.json").write_text(json.dumps(routes))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY))
    logs = {"cp": out_dir / "moe_control_plane.log",
            "wk": out_dir / "moe_worker.log"}
    seqs, labels = moe_held_out(N_MOE_SYNC + N_MOE_ASYNC)
    work = {"moe": ("/v1/moe/route",
                    [npy_bytes(s.astype(np.uint16)) for s in seqs],
                    N_MOE_SYNC, "completed - class_id, confidence")}
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / "moe_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "moe_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             "cuda"], logs["wk"], env)
        out = asyncio.run(drive_topology(gateway, worker, procs, logs, work))
        stop_child(procs["wk"], logs["wk"], "moe worker")
        stop_child(procs["cp"], logs["cp"], "moe control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wk_log = logs["wk"].read_text(errors="replace")
    if "serving ['moe'] on cuda" not in wk_log:
        raise AssertionError(f"the moe worker did not serve on cuda:\n"
                             f"{wk_log[-4000:]}")
    if f"restored moe params from {npz}" not in wk_log:
        raise AssertionError(f"the moe worker did not restore {npz}")
    failed = metric_sum(out["cp_metrics"], "ai4e_dispatch_total",
                        outcome="failed") + metric_sum(
        out["cp_metrics"], "ai4e_dispatch_total", outcome="dead_letter")
    if failed:
        raise AssertionError(f"{failed} deliveries failed")
    got = out["moe"]
    batches = metric_sum(out["wk_metrics"], "ai4e_batch_size_count",
                         model="moe")
    launches = served_launches(wk_log)["flash_attention"]
    depth = moe_model()["depth"]
    if launches < depth * batches:
        raise AssertionError(f"flash launched {launches} times in the worker "
                             f"for {batches} batches of depth {depth}")
    agree = check_scores(got["results"], moe_reference_logits(npz, seqs))
    served = np.array([r["class_id"] for r in got["results"]])
    hits = int((served[:64] == labels[:64]).sum())
    train_hits = round(train_eval * 64)
    if abs(hits - train_hits) > SERVED_ACC_SLACK:
        raise AssertionError(f"served {hits}/64 right, the trainer's eval "
                             f"{train_hits}/64")
    if hits < MIN_SERVED_ACC * 64:
        raise AssertionError(f"served accuracy {hits}/64 < {MIN_SERVED_ACC}")
    queue = "/v1/models/route-async"
    report = {
        "card": CARD["smi"], "clients": "another process",
        "async_requests_per_s": got["async_requests_per_s"],
        "task_p50_ms": got["task_p50_ms"], "task_p95_ms": got["task_p95_ms"],
        "sync_p50_ms": got["sync_p50_ms"],
        "redeliveries_503": metric_sum(out["cp_metrics"],
                                       "ai4e_dispatch_total",
                                       outcome="backpressure", queue=queue),
        "route_concurrency": next(a.get("concurrency") for a in routes["apis"]
                                  if a["backend"].endswith(queue)),
        "batch_sizes": batch_sizes(out["wk_metrics"], "moe"),
        "batches": batches, "flash_launches_while_serving": launches,
        "served_accuracy": hits / 64, "trainer_eval_accuracy": train_eval,
        "classes_agree_with_plain_ops": f"{agree}/{len(seqs)}"}
    return report


def phase_vit() -> dict:
    """9d: ViT-S/16 at ``build_vit``'s defaults (224 px, patch 16, dim 384,
    depth 12, 6 heads, 1000 classes, buckets 1/16/64; seed-0 weights)
    through the port's worker on a loopback port: 4 sync and 64 async float32
    images, each class held to an eager apply on the card wherever its
    top-two gap exceeds 1e-2; each bucket's replay against eager, timed."""
    from ai4e_tpu_torch.cli import build_worker

    spec = {"service_name": "vit-worker", "prefix": "v1/models", "models": [
        {"family": "vit", "name": "vit", "sync_path": VIT_ROUTE[0],
         "async_path": VIT_ROUTE[1]}]}
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(spec, device="cuda")
    warm_s = time.perf_counter() - t0
    runtime = worker.runtime
    servable = runtime.models["vit"]
    if servable.batch_buckets != (1, 16, 64) or servable.input_shape != (
            224, 224, 3):
        raise AssertionError(f"vit: {servable.batch_buckets} "
                             f"{servable.input_shape}")
    rng = np.random.default_rng(SEED + 91)
    images = rng.random((N_MOE_SYNC + N_MOE_ASYNC, 224, 224, 3),
                        dtype=np.float32)
    out = asyncio.run(drive(worker, batcher, free_port(),
                            [npy_bytes(x) for x in images], N_MOE_SYNC,
                            VIT_ROUTE, {}))
    results = out["sync_results"] + out["async_results"]
    with torch.inference_mode():
        logits = torch.cat([servable.apply_fn(
            servable.module, torch.from_numpy(images[i:i + 16]).cuda())
            for i in range(0, len(images), 16)]).cpu().numpy()
    held = 0
    for result, row in zip(results, logits):
        if set(result) != {"class_id"}:
            raise AssertionError(f"vit response keys {set(result)}")
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > LC_GAP:
            if result["class_id"] != int(row.argmax()):
                raise AssertionError(f"vit class {result} vs {row.argmax()}")
            held += 1
    record: dict = {"warmup_and_capture_s": warm_s, "buckets": {}}
    for bucket in servable.batch_buckets:
        graph = runtime.graphs[("vit", bucket)]
        x = images[:bucket]
        got = runtime.run_batch("vit", x)
        dev = torch.from_numpy(x).cuda()
        with torch.inference_mode():
            want = servable.apply_fn(servable.module, dev).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"vit bucket {bucket}: replay logits differ "
                                 "from eager")
        graph.static_in.copy_(dev)

        def eager():
            with torch.inference_mode():
                servable.apply_fn(servable.module, dev)

        record["buckets"][str(bucket)] = {
            "eager_ms": stream_ms(eager),
            "replay_ms": stream_ms(graph.graph.replay)}
    record.update(
        card=CARD["smi"], replay_equals_eager="bit for bit",
        classes_held=f"{held}/{len(results)}",
        sync_p50_ms=statistics.median(out["sync_ms"]),
        async_images_per_s=N_MOE_ASYNC / out["async_s"],
        retries_503=out["retries_503"],
        graph_pool_mib=runtime.graph_pool_bytes() / 2 ** 20)
    log(f"vit 9d: {json.dumps(record)}")
    del worker, batcher, runtime, servable
    torch.cuda.empty_cache()
    return record


def phase_moe_vit(kernels: list[dict]) -> dict:
    """Phase 9: 9a kernels at the moe shapes, 9b training, 9c serving the
    trained ``.npz`` (graphs in process, then the platform as two child
    processes), 9d ViT-S/16."""
    log("moe: flash kernels at the moe shapes, train, serve; then vit")
    phase_moe_kernels(kernels)
    train = phase_moe_train()
    graphs = phase_moe_graphs(train["npz"])
    served = phase_moe_served(train["npz"],
                              train["eval_accuracy_capacity_dispatch"])
    served["buckets"] = graphs["buckets"]
    served["graph_pool_mib"] = graphs["graph_pool_mib"]
    rows = {k["name"]: k for k in kernels}
    rows["flash_attention"]["launches_moe_training"] = \
        train["launches"]["flash_attention"]
    rows["flash_attention"]["launches_moe_served"] = \
        served["flash_launches_while_serving"]
    rows["flash_attention_bwd"]["launches_moe_training"] = \
        train["launches"]["flash_attention_bwd"]
    log(f"moe: {json.dumps(served)}")
    vit = phase_vit()
    return {"train": train, "served": served, "vit": vit}


# -- phase 10: the deploy spec as written, from the port's own checkpoints --

# The image recipes deploy/specs/models.json serves; ``landcover128`` and
# ``species_fine`` (not in the spec) were cut for time.
IMAGE_RECIPES = ("landcover", "megadetector", "species")
N_DEPLOY_SYNC = 4       # land-cover sync requests before the async ones
N_DEPLOY_ASYNC = 64     # held-out land-cover tiles and species images
N_BACKLOG = 1500        # land-cover tasks: an autoscaler tick's backlog,
#                         more than 5 s of draining on the fastest host
BACKLOG_SUBMITTERS = 128
BACKLOG_TILES = 16      # distinct tiles the backlog cycles through
DEPLOY_SLACK = 2        # of 64 images, or objects: served against trained
LC_QUEUE = "/v1/models/classify-async"
LC_START_REPLICAS = 4   # routes.json's land-cover concurrency


def train_step_copies(steps: int = 3) -> dict:
    """One land-cover training step's device time by kernel (tile 64,
    batch 8, full widths, float32 masters), from a ``torch.profiler`` trace
    of ``steps`` steps after two warm-up steps: the total, the layout and
    type copies (kernels named ``copy``, GroupNorm's float32 NCHW copies
    among them), GroupNorm's own kernels and the ten largest."""
    from torch.profiler import ProfilerActivity, profile

    from ai4e_tpu_torch.models import create_unet
    from ai4e_tpu_torch.train import Trainer, segmentation_loss
    from ai4e_tpu_torch.train.make_checkpoints import landcover_batch
    from ai4e_tpu_torch.train.step import adamw

    model = create_unet(param_dtype=torch.float32, device="cuda")
    tr = Trainer(model, segmentation_loss,
                 optimizer=lambda p: adamw(p, 1e-3, weight_decay=1e-5),
                 device="cuda")
    rng = np.random.default_rng(SEED + 100)
    batches = [landcover_batch(rng, 8, 64) for _ in range(steps + 2)]
    for x, y in batches[:2]:
        tr.train_step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, y in batches[2:]:
            tr.train_step(x, y)
        torch.cuda.synchronize()
    kernels = {}
    for event in prof.key_averages():
        ms = event.self_device_time_total / steps / 1e3
        if ms > 0:
            kernels[event.key] = kernels.get(event.key, 0.0) + ms
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    total = sum(kernels.values())
    copies = sum(ms for k, ms in kernels.items() if "copy" in k.lower())
    norm = sum(ms for k, ms in kernels.items()
               if any(s in k for s in ("GroupNorm", "RowwiseMoments",
                                       "ComputeFusedParams",
                                       "Compute1dBackward",
                                       "ComputeInternalGradients")))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    del tr, model
    torch.cuda.empty_cache()
    return {"step_device_ms": total, "copy_kernels_ms": copies,
            "copy_share": copies / total, "groupnorm_kernels_ms": norm,
            "top_kernels_ms": {k[:90]: ms for k, ms in top}}


def check_manifest_against_spec(out_dir: Path) -> dict:
    """Every ``"checkpoint"`` of deploy/specs/models.json has a manifest
    entry whose kwargs agree with the spec's keys; ``image_size`` must be
    in both and equal (species and megadetector serve at their trained
    size only)."""
    manifest = json.loads((out_dir / "MANIFEST.json").read_text())
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    checked = {}
    for model in spec["models"]:
        entry = manifest[model["checkpoint"]]
        kwargs = entry["kwargs"]
        if "image_size" in kwargs and "image_size" not in model:
            raise AssertionError(f"{model['name']}: trained at "
                                 f"{kwargs['image_size']}, spec silent")
        for key, value in kwargs.items():
            if key in model and model[key] != value:
                raise AssertionError(f"{model['name']}: {key} {model[key]} "
                                     f"in the spec, {value} trained")
        checked[model["name"]] = entry["eval"]
    return checked


def phase_deploy_train() -> dict:
    """10a: the spec's image recipes on the card at their production sizes
    (``FULL_OVERRIDES``, else the recipe defaults), each held to
    ``MIN_EVAL`` by ``make_checkpoint`` and saved into
    ``build/chip_smoke`` beside phases 6 and 9's ``.npz`` with its
    ``MANIFEST.json``; then one land-cover step's device time by kernel."""
    import gc

    from ai4e_tpu_torch.train import make_checkpoints as mc

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    report, results = {}, {}
    for name in IMAGE_RECIPES:
        overrides = mc.FULL_OVERRIDES.get(name, {})
        ahead = DETECTOR_AHEAD[0] if (name == "megadetector"
                                      and DETECTOR_AHEAD) else None
        t0 = time.perf_counter()
        if ahead is not None:
            result = mc.train_megadetector_on(ahead, device="cuda",
                                              **overrides)
            ahead.close()
        else:
            result = mc.RECIPES[name](device="cuda", **overrides)
        wall_s = time.perf_counter() - t0
        losses = result["losses"]
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name}: training loss is not finite")
        (metric, value), = result["eval"].items()
        record = {"card": CARD["smi"], "steps": len(losses),
                  "batch": result["batch"], "overrides": overrides,
                  "eval": result["eval"],
                  "reached_min_eval": value >= mc.MIN_EVAL}
        phases = result["phases_ms"][1:]  # the first step pays one-off costs
        record.update(
            loss_first=losses[0], loss_last=losses[-1],
            step_ms_median=statistics.median(sum(p.values())
                                             for p in phases),
            phase_ms_median={k: statistics.median(p[k] for p in phases)
                             for k in phases[0]},
            peak_memory_gib=result["peak_bytes"] / 2 ** 30,
            loop_s=result["loop_seconds"], data_s=result["data_seconds"],
            host_data_share=result["data_seconds"] / result["loop_seconds"],
            recipe_wall_s=wall_s)
        if "eval_objects" in result:
            record["eval_objects"] = result["eval_objects"]
        if ahead is not None:
            record["batches_drawn_ahead_s"] = t0 - ahead.started
        log(f"deploy 10a: {name} {json.dumps(record)}")
        # Raises below MIN_EVAL: the gate is not lowered.
        entry = mc.make_checkpoint(name, str(out_dir), result=result)
        record["path"] = entry["path"]
        report[name] = record
        results[name] = {k: v for k, v in result.items()
                         if k != "state_dict"}
        del result
        gc.collect()
        torch.cuda.empty_cache()
    report["manifest_evals"] = check_manifest_against_spec(out_dir)
    report["landcover_step_kernels"] = train_step_copies()
    log(f"deploy 10a: landcover step by kernel "
        f"{json.dumps(report['landcover_step_kernels'])}")
    return {"report": report, "results": results, "dir": out_dir}


def write_detector_batches(seed: int, batch: int, size: int,
                           steps: int) -> None:
    """The megadetector recipe's training batches
    (``make_checkpoints.detector_batches``), in order, pickled to standard
    output: ``chip_smoke.py --detector-batches SEED BATCH SIZE STEPS``, the
    child process of ``DetectorBatchesAhead``."""
    import pickle

    from ai4e_tpu_torch.train.make_checkpoints import detector_batches

    out = sys.stdout.buffer
    for item in detector_batches(seed, batch, size, steps):
        pickle.dump(item, out, protocol=pickle.HIGHEST_PROTOCOL)
    out.flush()


class DetectorBatchesAhead:
    """Phase 10a's megadetector batches at ``FULL_OVERRIDES``' size, drawn
    ahead by a child process from the recipe's own seed (the same arrays,
    in the same order): the 512 px scenes cost the host about 0.2 s each,
    most of the recipe's time on an H100's host (PERF.md section 6), and
    the child draws them while phases 3-9 run, on one host core and no
    card; a thread of this
    process reads them off its pipe as they come, and the recipe trains
    on them (``train_megadetector_on``). Started after the build."""

    def __init__(self, seed: int = 0, batch: int = 8):
        import queue
        import threading

        from ai4e_tpu_torch.train import make_checkpoints as mc

        full = mc.FULL_OVERRIDES["megadetector"]
        self.steps = full["steps"]
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--detector-batches",
             str(seed), str(batch), str(full["image_size"]), str(self.steps)],
            cwd=ROOT, stdout=subprocess.PIPE)
        self.started = time.perf_counter()
        self.batches: queue.Queue = queue.Queue()
        self.taken = 0
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        import pickle

        try:
            for _ in range(self.steps):
                self.batches.put(pickle.load(self.proc.stdout))
        except Exception as exc:  # handed to the consumer, which raises
            self.batches.put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        if self.taken == self.steps:
            raise StopIteration
        self.taken += 1
        item = self.batches.get(timeout=600)
        if isinstance(item, Exception):
            raise RuntimeError("the megadetector's batches ended early: "
                               f"child exit {self.proc.poll()}") from item
        return item

    def close(self) -> None:
        if self.proc.wait(timeout=60) != 0:
            raise AssertionError(f"the megadetector's batch child exited "
                                 f"{self.proc.returncode}")


DETECTOR_AHEAD: list = []  # run_phases' DetectorBatchesAhead, if started


def deploy_specs(store_url: str, worker_url: str) -> tuple[dict, dict]:
    """deploy/specs/models.json and routes.json as written, but for the
    hosts: the task store, every backend and the detector's handoff point
    at the control plane and the worker on loopback. The ``"checkpoint"``
    values stay: they name ``.npz`` files under the worker's
    ``AI4E_RUNTIME_CHECKPOINT_DIR``."""
    from urllib.parse import urlparse

    models = json.loads((ROOT / "deploy/specs/models.json").read_text())
    models["taskstore"] = store_url
    for model in models["models"]:
        if "pipeline_to" in model:
            handoff = model["pipeline_to"]
            handoff["endpoint"] = worker_url + urlparse(
                handoff["endpoint"]).path
    routes = json.loads((ROOT / "deploy/specs/routes.json").read_text())
    for api in routes["apis"]:
        api["backend"] = worker_url + urlparse(api["backend"]).path
    return models, routes


def uint8_images(images: np.ndarray) -> np.ndarray:
    """[0, 1] float images as the uint8 pixels a client ships."""
    return np.clip(np.round(images * 255), 0, 255).astype(np.uint8)


def autoscale_replicas(metrics_text: str) -> float | None:
    for line in metrics_text.splitlines():
        if (line.startswith("ai4e_autoscale_replicas{")
                and f'endpoint="{LC_QUEUE}"' in line):
            return float(line.rsplit(" ", 1)[1])
    return None


async def drive_backlog(http, gateway: str, bodies: list[bytes]) -> dict:
    """``N_BACKLOG`` land-cover tasks through the gateway, submitted by
    ``BACKLOG_SUBMITTERS`` at a time, waited for on the task store's depths;
    the control plane's replica gauge for the route sampled meanwhile."""
    async def depths() -> dict:
        async with http.get(gateway + "/v1/taskstore/depths") as r:
            return (await r.json()).get(LC_QUEUE, {})

    async def metrics() -> str:
        async with http.get(gateway + "/metrics") as r:
            return await r.text()

    before = await depths()
    done_before = sum(before.get(s, 0) for s in ("completed", "failed",
                                                 "expired"))
    samples = []
    queue = asyncio.Queue()
    for i in range(N_BACKLOG):
        queue.put_nowait(bodies[i % len(bodies)])

    async def submitter() -> None:
        while not queue.empty():
            body = queue.get_nowait()
            async with http.post(gateway + "/v1/landcover/classify-async",
                                 data=body, headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"backlog submit {r.status}: "
                                         f"{await r.text()}")
                await r.read()

    t0 = time.perf_counter()
    submit = asyncio.gather(*(submitter() for _ in range(BACKLOG_SUBMITTERS)))
    submitted_s = None
    while True:
        await asyncio.sleep(0.5)
        if submitted_s is None and submit.done():
            await submit
            submitted_s = time.perf_counter() - t0
        now = await depths()
        replicas = autoscale_replicas(await metrics())
        samples.append((round(time.perf_counter() - t0, 2), replicas,
                        now.get("created", 0) + now.get("running", 0)))
        done = sum(now.get(s, 0) for s in ("completed", "failed", "expired"))
        if done - done_before >= N_BACKLOG and submitted_s is not None:
            break
        if time.perf_counter() - t0 > 300:
            raise AssertionError(f"backlog not drained: {now}")
    span = time.perf_counter() - t0
    return {"span_s": span, "submitted_s": submitted_s,
            "tasks_per_s": N_BACKLOG / span, "depths": now,
            "failed": now.get("failed", 0) - before.get("failed", 0)
            + now.get("expired", 0) - before.get("expired", 0),
            "samples": samples}


async def drive_deploy(gateway: str, worker: str, procs: dict, logs: dict,
                       work: dict) -> dict:
    """10b's client: land cover (4 sync, 64 async), species (64 async,
    then the 64 as one batch), megadetector (32 async scenes, stage and
    final results), then the land-cover backlog."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=900)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        out = {"worker_up_s": time.perf_counter() - t0}
        log(f"deploy 10b: worker up in {out['worker_up_s']:.1f}s")
        out["landcover"] = await drive_gateway(
            http, gateway, "/v1/landcover/classify", work["landcover"], 4,
            "completed - class_histogram", worker)
        out["species"] = await drive_gateway(
            http, gateway, "/v1/camera-trap/classify-species",
            work["species"], 0, "completed - class_id, label, confidence",
            worker)
        t1 = time.perf_counter()
        out["species_batch"] = await post_sync(
            http, worker + "/v1/models/species-batch", work["species_stack"])
        out["species_batch_ms"] = (time.perf_counter() - t1) * 1e3

        async def detect(body: bytes) -> tuple[float, float, str, dict]:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/camera-trap/detect-async",
                                 data=body, headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"detect-async {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            record = await await_terminal(http, gateway, task_id)
            return t0, time.perf_counter(), task_id, record

        runs = await asyncio.gather(*(detect(b) for b in work["scenes"]))
        out["detect"] = {"runs": runs, "stage": [], "final": []}
        for _, _, task_id, record in runs:
            out["detect"]["stage"].append(await task_result(
                http, gateway, task_id, "megadetector"))
            out["detect"]["final"].append(await task_result(
                http, gateway, task_id))
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics_before_backlog"] = await r.text()
        out["backlog"] = await drive_backlog(http, gateway,
                                             work["backlog"])
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
        async with http.get(worker + "/metrics") as r:
            out["wk_metrics"] = await r.text()
    return out


def served_detection_accuracy(stage: list[dict], targets: dict) -> tuple:
    """``detection_accuracy`` of the served detection lists (score >= 0.2,
    the served threshold) against the scenes' targets."""
    from ai4e_tpu_torch.train.make_checkpoints import detection_accuracy

    out = {"boxes": [], "classes": [], "scores": []}
    for result in stage:
        dets = result["detections"]
        out["boxes"].append(np.array([d["box"] for d in dets],
                                     np.float32).reshape(-1, 4))
        out["classes"].append(np.array([d["class_id"] for d in dets]))
        out["scores"].append(np.array([d["score"] for d in dets],
                                      np.float32))
    return detection_accuracy(out, targets)


def check_normalize_on(images: np.ndarray, what: str) -> None:
    """The normalize kernel equals its plain version on ``images``."""
    from ai4e_tpu_torch.ops import image_preprocess as ip

    scale, bias = ip.channel_affine(None, None, 3)
    for i in range(0, len(images), 16):
        x = torch.from_numpy(images[i:i + 16]).cuda()
        if not torch.equal(ip.normalize_image(x),
                           ip.normalize_image_plain(x, scale, bias)):
            raise AssertionError(f"normalize differs on the {what}")


def phase_deploy_serve(train: dict, kernels: list[dict]) -> dict:
    """10b: the port's control plane and worker as two child processes fed
    deploy/specs/routes.json and models.json as written (``autoscale``
    included) but for the hosts, the worker restoring every model from the
    checkpoint directory of 10a (and phases 6 and 9); every answer checked
    against the trained weights on the card."""
    import gc

    from ai4e_tpu_torch.cli import restore_checkpoint
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.train import make_checkpoints as mc

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = train["dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = deploy_specs(gateway, worker)
    (out_dir / "deploy_models.json").write_text(json.dumps(models))
    (out_dir / "deploy_routes.json").write_text(json.dumps(routes))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY),
               AI4E_RUNTIME_CHECKPOINT_DIR=str(out_dir))
    logs = {"cp": out_dir / "deploy_control_plane.log",
            "wk": out_dir / "deploy_worker.log"}

    # Held-out data from the recipes' generators, as uint8 pixels.
    n_lc = N_DEPLOY_SYNC + N_DEPLOY_ASYNC
    lc_img, lc_lab = mc.landcover_batch(np.random.default_rng(SEED + 1),
                                        n_lc, 256)
    lc_img = uint8_images(lc_img)
    sp_img, sp_lab = mc.species_batch(np.random.default_rng(SEED + 1),
                                      N_DEPLOY_ASYNC, 224)
    sp_img = uint8_images(sp_img)
    eval_rng = np.random.default_rng(SEED + 1)  # the trainer's eval scenes
    det_batches = [mc.detector_batch(eval_rng, 8, 512) for _ in range(4)]
    det_img = uint8_images(np.concatenate([b[0] for b in det_batches]))
    det_targets = {k: np.concatenate([b[1][k] for b in det_batches])
                   for k in det_batches[0][1]}
    work = {"landcover": [npy_bytes(x) for x in lc_img],
            "species": [npy_bytes(x) for x in sp_img],
            "species_stack": npy_bytes(sp_img),
            "scenes": [npy_bytes(x) for x in det_img],
            "backlog": [npy_bytes(x) for x in lc_img[:BACKLOG_TILES]]}
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / "deploy_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "deploy_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             "cuda"], logs["wk"], env)
        out = asyncio.run(drive_deploy(gateway, worker, procs, logs, work))
        stop_child(procs["wk"], logs["wk"], "deploy worker")
        stop_child(procs["cp"], logs["cp"], "deploy control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wk_log = logs["wk"].read_text(errors="replace")
    names = [m["name"] for m in models["models"]]
    if f"serving {names} on cuda" not in wk_log:
        raise AssertionError(f"the deploy worker did not serve {names} on "
                             f"cuda:\n{wk_log[-4000:]}")
    for m in models["models"]:
        path = out_dir / (m["checkpoint"] + ".npz")
        if f"restored {m['name']} params from {path}" not in wk_log:
            raise AssertionError(f"{m['name']} was not restored from {path}")
    cp_log = logs["cp"].read_text(errors="replace")
    by_model = launches_by_model(wk_log)
    for model in ("landcover", "megadetector", "species"):
        if by_model.get(model, {}).get("normalize_image", 0) < 1:
            raise AssertionError(f"normalize never launched for {model}: "
                                 f"{by_model}")
    if by_model["landcover"].get("fused_seg_postprocess", 0) < 1:
        raise AssertionError(f"argmax+histogram never launched: {by_model}")
    failed = metric_sum(out["cp_metrics"], "ai4e_dispatch_total",
                        outcome="failed") + metric_sum(
        out["cp_metrics"], "ai4e_dispatch_total", outcome="dead_letter")
    if failed or out["backlog"]["failed"]:
        raise AssertionError(f"{failed} deliveries failed, "
                             f"{out['backlog']['failed']} backlog tasks")

    # The autoscaler: the route's replicas above the starting 4, decisions
    # counted.
    peak = max((r for _, r, _ in out["backlog"]["samples"] if r is not None),
               default=None)
    decisions = {d: metric_sum(out["cp_metrics"],
                               "ai4e_autoscale_decisions_total",
                               endpoint=LC_QUEUE, direction=d)
                 for d in ("up", "down")}
    if peak is None or peak <= LC_START_REPLICAS or decisions["up"] < 1:
        raise AssertionError(f"land-cover replicas peaked at {peak} with "
                             f"decisions {decisions}: "
                             f"{out['backlog']['samples']}")

    # Land cover against the trained weights on the card.
    lc_kwargs = {k: v for k, v in next(
        m for m in models["models"] if m["name"] == "landcover").items()
        if k not in ("family", "sync_path", "async_path", "checkpoint",
                     "name")}
    unet = build_servable("unet", name="landcover", **lc_kwargs)
    restore_checkpoint(unet, "landcover", str(out_dir))
    unet.module.cuda()
    check_served_logits(unet, lc_img)
    want = reference_counts(unet, lc_img)
    lc_results = out["landcover"]["results"]
    diffs = [check_histogram(r, want[i], 256 * 256)
             for i, r in enumerate(lc_results)]
    from ai4e_tpu_torch.ops.image_preprocess import (channel_affine,
                                                     normalize_image_plain)
    scale, bias = channel_affine(None, None, 3)
    hits = 0
    with torch.inference_mode():
        for i in range(0, n_lc, 16):
            x = normalize_image_plain(torch.from_numpy(
                lc_img[i:i + 16]).cuda(), scale, bias)
            pred = unet.module(x).argmax(-1).cpu().numpy()
            hits += int((pred == lc_lab[i:i + 16]).sum())
    pixel_acc = hits / lc_lab.size
    if pixel_acc < mc.MIN_EVAL:
        raise AssertionError(f"land-cover pixel accuracy {pixel_acc} at 256")
    true_counts = np.stack([np.bincount(lab.ravel(), minlength=4)
                            for lab in lc_lab])
    served = np.stack([[r["class_histogram"].get(str(c), 0)
                        for c in range(4)] for r in lc_results])
    label_gap = np.abs(served - true_counts).sum(1) / (2 * 256 * 256)
    del unet

    # Species: served accuracy, async and batch, against the trainer's.
    sp_served = np.array([r["class_id"] for r in out["species"]["results"]])
    batch = out["species_batch"]
    if batch["count"] != N_DEPLOY_ASYNC or batch["failed"]:
        raise AssertionError(f"species batch: {batch['count']} items, "
                             f"{batch['failed']} failed")
    sp_batch = np.array([item["result"]["class_id"]
                         for item in batch["items"]])
    trained_hits = train["results"]["species"]["eval"]["accuracy"] * 64
    species = {}
    for what, got in (("async", sp_served), ("batch", sp_batch)):
        n = int((got == sp_lab).sum())
        if n < mc.MIN_EVAL * 64 or abs(n - trained_hits) > DEPLOY_SLACK:
            raise AssertionError(f"species {what}: {n}/64 right, the "
                                 f"trainer's eval {trained_hits}/64")
        species[what] = n / 64
    check_normalize_on(sp_img, "species images")

    # Megadetector: served detection accuracy against the trainer's eval,
    # and the crops handed to species under one TaskId.
    det = out["detect"]
    served_hits, total = served_detection_accuracy(det["stage"], det_targets)
    want_hits = train["results"]["megadetector"]["eval_objects"]["hits"]
    if abs(served_hits - want_hits) > DEPLOY_SLACK:
        raise AssertionError(f"megadetector served {served_hits}/{total} "
                             f"objects, the trainer {want_hits}")
    handed = 0
    for (_, _, task_id, record), stage, final in zip(
            det["runs"], det["stage"], det["final"]):
        n = min(16, len(stage["detections"]))
        if n == 0:
            if record["Status"] != "completed - detections":
                raise AssertionError(f"task {task_id}: {record}")
            continue
        if record["Status"] != f"completed - {n} images, 0 errors":
            raise AssertionError(f"task {task_id}: {record}")
        if final["count"] != n or final["failed"]:
            raise AssertionError(f"task {task_id}: final {final['count']} "
                                 f"items, {final['failed']} failed")
        handed += 1
    check_normalize_on(det_img, "detector scenes")
    latency = sorted((t1 - t0) * 1e3 for t0, t1, _, _ in det["runs"])

    backlog = out["backlog"]
    report = {
        "card": CARD["smi"], "clients": "another process",
        "checkpoints": str(out_dir), "worker_up_s": out["worker_up_s"],
        "landcover": {
            "async_requests_per_s": out["landcover"]["async_requests_per_s"],
            "task_p50_ms": out["landcover"]["task_p50_ms"],
            "task_p95_ms": out["landcover"]["task_p95_ms"],
            "sync_p50_ms": out["landcover"]["sync_p50_ms"],
            "pixel_accuracy_256": pixel_acc,
            "max_count_diff_px": max(diffs),
            "histogram_gap_from_labels_mean": float(label_gap.mean()),
            "histogram_gap_from_labels_max": float(label_gap.max())},
        "species": {"served_accuracy": species,
                    "trainer_eval_accuracy":
                        train["results"]["species"]["eval"]["accuracy"],
                    "async_requests_per_s":
                        out["species"]["async_requests_per_s"],
                    "task_p50_ms": out["species"]["task_p50_ms"],
                    "batch64_ms": out["species_batch_ms"]},
        "megadetector": {"served_objects": f"{served_hits}/{total}",
                         "trainer_objects": f"{want_hits}/"
                         f"{train['results']['megadetector']['eval_objects']['total']}",
                         "tasks_handed_to_species": handed,
                         "task_p50_ms": statistics.median(latency),
                         "task_p95_ms": float(np.percentile(latency, 95))},
        "autoscaler": {
            "route": "/v1/landcover/classify-async", "queue": LC_QUEUE,
            "starting_replicas": LC_START_REPLICAS, "replicas_peak": peak,
            "decisions": decisions,
            "replicas_before_backlog": autoscale_replicas(
                out["cp_metrics_before_backlog"]),
            "backlog_tasks": N_BACKLOG, "backlog_span_s": backlog["span_s"],
            "backlog_submitted_s": backlog["submitted_s"],
            "backlog_tasks_per_s": backlog["tasks_per_s"],
            "samples_s_replicas_depth": backlog["samples"][::4],
            "redeliveries_503": metric_sum(
                out["cp_metrics"], "ai4e_dispatch_total",
                outcome="backpressure", queue=LC_QUEUE),
            "autoscale_log_lines": sum(
                "autoscale " in line for line in cp_log.splitlines())},
        "batch_sizes": {m: batch_sizes(out["wk_metrics"], m)
                        for m in ("landcover", "megadetector", "species")},
        "launches_by_model": by_model,
    }
    rows = {k["name"]: k for k in kernels}
    rows["normalize_image"]["launches_deploy_spec"] = {
        m: by_model[m]["normalize_image"]
        for m in ("landcover", "megadetector", "species")}
    rows["fused_seg_postprocess"]["launches_deploy_spec"] = \
        by_model["landcover"]["fused_seg_postprocess"]
    log(f"deploy: {json.dumps(report)}")
    # Phase 11 serves the same checkpoints on the same inputs.
    first = slice(0, N_OBS_DETECT)
    handoff = {"out_dir": out_dir, "models": models, "routes": routes,
               "env": env, "landcover": (work["landcover"], want),
               "scenes": work["scenes"][first],
               "scene_targets": {k: v[first] for k, v in det_targets.items()},
               "scene_hits_10b": served_detection_accuracy(
                   det["stage"][first],
                   {k: v[first] for k, v in det_targets.items()})[0]}
    return report, handoff


def phase_deploy(kernels: list[dict]) -> tuple[dict, dict]:
    """Phase 10: train the image recipes (a), then serve the deploy spec as
    written from the port's checkpoints (b)."""
    log("deploy: the image recipes on the card, then the deploy spec")
    train = phase_deploy_train()
    served, handoff = phase_deploy_serve(train, kernels)
    return {"train": train["report"], "served": served}, handoff


# -- phase 11: observability on the card ------------------------------------

N_OBS_SYNC = 4      # land-cover and longcontext sync requests
N_OBS_ASYNC = 64    # async tasks each of land cover, longcontext and moe
N_OBS_DETECT = 16   # camera-trap scenes through detect-async
N_OBS_BURSTS = 2    # further 64-task land-cover bursts, timed only
SLO_OBJECTIVES = ("/v1/landcover/classify-async=1000:99,"
                  "/v1/landcover/classify=goodput:99")
# The device events' epoch times are perf_counter windows mapped through
# one (time.time(), perf_counter()) pair read at stamping; the two reads
# are microseconds apart.
CLOCK_SLACK_S = 1e-3
STAGE_EVENTS = ("admitted", "published", "popped", "delivered", "batched",
                "h2d", "execute", "d2h")
ONE_STAGE = STAGE_EVENTS + ("completed",)
TWO_STAGES = STAGE_EVENTS + ("stage", "popped", "delivered", "batched", "h2d",
                             "execute", "d2h", "completed")
DEVICE_EVENTS = ("h2d", "compile", "execute", "d2h")


def in_order(want: tuple, names: list[str]) -> bool:
    """Whether ``want`` is a subsequence of ``names``."""
    it = iter(names)
    return all(any(n == w for n in it) for w in want)


def check_timeline(task_id: str, events: list[dict], want: tuple) -> None:
    """A task's ledger, in the order the store kept it: ``want`` in order;
    each device event inside its batch's ``batched`` -> ``completed``
    span (``CLOCK_SLACK_S``); ``t`` never falling within a hop."""
    names = [e["e"] for e in events]
    if not in_order(want, names):
        raise AssertionError(f"task {task_id}: ledger {names} lacks {want}")
    completed = next(e["t"] for e in events if e["e"] == "completed")
    batched = None
    for e in events:
        if e["e"] == "batched":
            batched = e["t"]
        if e["e"] in DEVICE_EVENTS:
            if (batched is None or e["t"] < batched - CLOCK_SLACK_S
                    or e["t"] + e["ms"] / 1e3 > completed + CLOCK_SLACK_S):
                raise AssertionError(f"task {task_id}: {e} outside "
                                     f"batched {batched} -> {completed}")
    for hop in {e["h"] for e in events}:
        ts = [e["t"] for e in events if e["h"] == hop]
        if any(b < a for a, b in zip(ts, ts[1:])):
            raise AssertionError(f"task {task_id}: hop {hop} goes back in "
                                 f"time: {ts}")


def stage_deltas(events: list[dict], start: int, out: dict,
                 suffix: str = "") -> int:
    """The ms of one stage's hops from ``events[start]`` on (its
    ``popped``-> ... -> ``d2h``; the device phases summed over the stage's
    batches) into ``out``; returns the index after the stage's last device
    event."""
    def at(name: str, i: int) -> int:
        return next(j for j in range(i, len(events))
                    if events[j]["e"] == name)

    pop = at("popped", start)
    dlv = at("delivered", pop)
    pop = max(j for j in range(pop, dlv) if events[j]["e"] == "popped")
    bat = at("batched", dlv)
    end = bat
    while end < len(events) and events[end]["e"] in (
            ("batched",) + DEVICE_EVENTS):
        end += 1
    device = events[bat:end]
    t = [e["t"] for e in events]
    out["popped->delivered" + suffix] = (t[dlv] - t[pop]) * 1e3
    out["delivered->batched" + suffix] = (t[bat] - t[dlv]) * 1e3
    for phase in ("h2d", "execute", "d2h"):
        out[phase + suffix] = sum(e.get("ms", 0.0) for e in device
                                  if e["e"] == phase)
    last = device[-1]
    out["_end"] = last["t"] + last["ms"] / 1e3
    return end


def hop_deltas(events: list[dict]) -> dict:
    """One task's hop deltas in ms: admitted -> published -> popped ->
    delivered -> batched, h2d/execute/d2h, d2h -> completed; a camera-trap
    task adds its ``stage`` handoff and the species stage's hops."""
    t = {e["e"]: e["t"] for e in reversed(events)}  # each event's first t
    out = {"admitted->published": (t["published"] - t["admitted"]) * 1e3,
           "published->popped": (t["popped"] - t["published"]) * 1e3}
    i = stage_deltas(events, 0, out)
    stage = next((e for e in events[i:] if e["e"] == "stage"), None)
    if stage is not None:
        out["d2h->stage"] = (stage["t"] - out["_end"]) * 1e3
        j = events.index(stage)
        nxt = next(e for e in events[j:] if e["e"] == "popped")
        out["stage->popped"] = (nxt["t"] - stage["t"]) * 1e3
        stage_deltas(events, j, out, suffix=" (species)")
    completed = next(e for e in events if e["e"] == "completed")
    out["d2h->completed"] = (completed["t"] - out.pop("_end")) * 1e3
    out["end_to_end"] = (completed["t"] - t["admitted"]) * 1e3
    return out


def deltas_summary(timelines: list[list[dict]]) -> dict:
    """Median and p95 of each hop delta over a model's tasks."""
    per = [hop_deltas(evs) for evs in timelines]
    return {k: {"p50": statistics.median(d[k] for d in per),
                "p95": float(np.percentile([d[k] for d in per], 95))}
            for k in per[0]}


def check_span_tree(spans: list[dict], task_id: str, service: str) -> dict:
    """A task's spans in the JSONL log: the gateway's ``create_task``,
    the dispatcher's ``dispatch`` and the worker's endpoint span under one
    trace id, each the parent of the next."""
    from ai4e_tpu_torch.observability.traceview import select_traces

    mine = select_traces(spans, task_id=task_id)
    by_id = {s["span_id"]: s for s in mine}
    worker = [s for s in mine if s["service"] == service
              and s.get("task_id") == task_id]
    if len(worker) != 1:
        raise AssertionError(f"task {task_id}: worker spans {worker}")
    dispatch = by_id.get(worker[0].get("parent_id"))
    gateway = dispatch and by_id.get(dispatch.get("parent_id"))
    if (dispatch is None or dispatch["name"] != "dispatch"
            or gateway is None or gateway["name"] != "create_task"
            or gateway["service"] != "gateway"
            or gateway.get("parent_id")
            or len({worker[0]["trace_id"], dispatch["trace_id"],
                    gateway["trace_id"]}) != 1):
        raise AssertionError(f"task {task_id}: spans not linked: {mine}")
    return {s["service"]: s["duration"] * 1e3
            for s in (gateway, dispatch, worker[0])}


async def drive_observability(gateway: str, worker: str, procs: dict,
                              logs: dict, work: dict, checked: bool) -> dict:
    """11's client. ``checked``: land cover (4 sync + 64 async),
    longcontext (4 + 64), moe (64 async), 16 camera-trap scenes, each
    task's ``?ledger=1`` record, the flight dump and both /metrics; then
    ``N_OBS_BURSTS`` more land-cover bursts. Else land cover only: the
    checked drive's first burst and as many more."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=900)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])

        async def metrics(url: str) -> str:
            async with http.get(url + "/metrics") as r:
                return await r.text()

        out = {"cp_before": await metrics(gateway)}
        lc_route = "/v1/landcover/classify"
        lc_done = "completed - class_histogram"
        out["landcover"] = await drive_gateway(
            http, gateway, lc_route, work["landcover"], N_OBS_SYNC, lc_done,
            worker)
        if checked:
            scores = "completed - class_id, confidence"
            out["longcontext"] = await drive_gateway(
                http, gateway, "/v1/longcontext/score", work["longcontext"],
                N_OBS_SYNC, scores, worker)
            out["moe"] = await drive_gateway(
                http, gateway, "/v1/moe/route", work["moe"], 0, scores,
                worker)

            async def detect(body: bytes) -> str:
                async with http.post(gateway + "/v1/camera-trap/detect-async",
                                     data=body, headers=OCTET) as r:
                    if r.status != 200:
                        raise AssertionError(f"detect-async {r.status}: "
                                             f"{await r.text()}")
                    return (await r.json())["TaskId"]

            ids = await asyncio.gather(*(detect(b) for b in work["scenes"]))
            out["detect"] = {"task_ids": ids, "records": [
                await await_terminal(http, gateway, t) for t in ids]}
            out["detect"]["stage"] = [
                await task_result(http, gateway, t, "megadetector")
                for t in ids]
            out["detect"]["final"] = [await task_result(http, gateway, t)
                                      for t in ids]
            out["cp_after"] = await metrics(gateway)
            out["records"] = {}
            for model in ("landcover", "longcontext", "moe"):
                ids = out[model]["task_ids"]
                out["records"][model] = [await fetch_record(http, gateway, t)
                                         for t in ids]
            out["records"]["camera_trap"] = [
                await fetch_record(http, gateway, t)
                for t in out["detect"]["task_ids"]]
            async with http.get(gateway + "/v1/debug/flight") as r:
                if r.status != 200:
                    raise AssertionError(f"/v1/debug/flight {r.status}")
                out["flight"] = await r.json()
        out["bursts"] = [
            (await drive_gateway(http, gateway, lc_route,
                                 work["landcover"][N_OBS_SYNC:], 0, lc_done,
                                 worker))["async_requests_per_s"]
            for _ in range(N_OBS_BURSTS)]
        out["cp_metrics"] = await metrics(gateway)
        out["wk_metrics"] = await metrics(worker)
    return out


async def fetch_record(http, gateway: str, task_id: str) -> dict:
    async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                        params={"ledger": "1"}) as r:
        return await r.json()


def serve_observed(handoff: dict, env: dict, work: dict, tag: str,
                   checked: bool) -> tuple[dict, str, str]:
    """The deploy spec's control plane and worker as child processes under
    ``env``, driven by ``drive_observability``; returns its output and the
    two logs."""
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = deploy_specs(gateway, worker)
    (out_dir / f"{tag}_models.json").write_text(json.dumps(models))
    (out_dir / f"{tag}_routes.json").write_text(json.dumps(routes))
    logs = {"cp": out_dir / f"{tag}_control_plane.log",
            "wk": out_dir / f"{tag}_worker.log"}
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / f"{tag}_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / f"{tag}_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             "cuda"], logs["wk"], env)
        out = asyncio.run(drive_observability(gateway, worker, procs, logs,
                                              work, checked))
        out["gateway"] = gateway
        if checked:
            out["trace_verb"] = trace_verb(
                ["--task-id", out["landcover"]["task_ids"][0], "--url",
                 gateway], env)
        stop_child(procs["wk"], logs["wk"], f"{tag} worker")
        stop_child(procs["cp"], logs["cp"], f"{tag} control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return (out, logs["cp"].read_text(errors="replace"),
            logs["wk"].read_text(errors="replace"))


def trace_verb(args: list[str], env: dict) -> str:
    """``python -m ai4e_tpu_torch trace ...`` as a child process; raises
    unless it exits 0."""
    done = subprocess.run([sys.executable, "-m", "ai4e_tpu_torch", "trace",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    if done.returncode != 0:
        raise AssertionError(f"trace {args} exited {done.returncode}: "
                             f"{done.stderr[-2000:]}")
    return done.stdout


def served_references(handoff: dict, work: dict, out: dict) -> dict:
    """Every answer of the checked drive against the trained weights on the
    card, as phases 5b, 9c and 10b check them."""
    from ai4e_tpu_torch.cli import restore_checkpoint
    from ai4e_tpu_torch.runtime.families import build_servable

    out_dir = handoff["out_dir"]
    _, want = handoff["landcover"]
    diffs = [check_histogram(r, want[i], 256 * 256)
             for i, r in enumerate(out["landcover"]["results"])]
    entry = next(m for m in handoff["models"]["models"]
                 if m["name"] == "longcontext")
    kwargs = {k: v for k, v in entry.items()
              if k not in ("family", "sync_path", "async_path", "checkpoint",
                           "name")}
    lc = build_servable("seqformer", name="longcontext", **kwargs)
    restore_checkpoint(lc, "longcontext", str(out_dir))
    # As phase 6 holds the trained weights: accuracy on the trainer's
    # held-out sequences, and the class of plain full attention wherever
    # its top-two gap exceeds LC_GAP. Its confidence is not held to
    # LC_CONF_ATOL here: on trained weights full attention's bf16 softmax
    # over 4,096 keys moves a confidence by more (0.026 on the H100).
    lc_results = out["longcontext"]["results"]
    lc_agree, lc_conf_gap = check_classes(
        lc_results, reference_logits(lc, entry, work["lc_seqs"]))
    del lc
    lc_hits = sum(r["class_id"] == y
                  for r, y in zip(lc_results, work["lc_labels"]))
    if lc_hits < MIN_SERVED_ACC * len(lc_results):
        raise AssertionError(f"longcontext served {lc_hits}/"
                             f"{len(lc_results)} held-out sequences right")
    moe_agree = check_scores(out["moe"]["results"], moe_reference_logits(
        str(out_dir / "moe.npz"), work["moe_seqs"]))
    hits, total = served_detection_accuracy(out["detect"]["stage"],
                                            handoff["scene_targets"])
    if abs(hits - handoff["scene_hits_10b"]) > DEPLOY_SLACK:
        raise AssertionError(f"megadetector served {hits}/{total} objects, "
                             f"phase 10b {handoff['scene_hits_10b']}")
    for record, stage, final in zip(out["detect"]["records"],
                                    out["detect"]["stage"],
                                    out["detect"]["final"]):
        n = min(16, len(stage["detections"]))
        want_status = (f"completed - {n} images, 0 errors" if n
                       else "completed - detections")
        if record["Status"] != want_status or (n and (
                final["count"] != n or final["failed"])):
            raise AssertionError(f"camera trap: {record} {final}")
    return {"landcover_max_count_diff_px": max(diffs),
            "longcontext_classes_agree": f"{lc_agree}/{len(work['lc_seqs'])}",
            "longcontext_held_out_right": f"{lc_hits}/{len(lc_results)}",
            "longcontext_max_confidence_gap_to_full_attention": lc_conf_gap,
            "moe_classes_agree": f"{moe_agree}/{len(work['moe_seqs'])}",
            "megadetector_objects": f"{hits}/{total}",
            "megadetector_objects_10b": handoff["scene_hits_10b"]}


def phase_observability(handoff: dict, kernels: list[dict]) -> dict:
    """Phase 11: the deploy spec served from phase 10's checkpoints with the
    observability layer on (ledger, spans to a JSONL log, flight recorder,
    SLOs, vitals, depth gauges), every task's timeline and the debug
    surfaces checked."""
    import gc
    import tempfile

    from ai4e_tpu_torch.observability.traceview import load_spans

    log("observability: the deploy spec with the layer on")
    gc.collect()
    torch.cuda.empty_cache()
    lc_bodies, _ = handoff["landcover"]
    entry = next(m for m in handoff["models"]["models"]
                 if m["name"] == "longcontext")
    # The trainer's held-out draws (seed + 1, batches of 16), as phase 6.
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch
    rng = np.random.default_rng(SEED + 1)
    draws = [longcontext_batch(rng, 16, entry["seq_len"], entry["vocab_size"],
                               entry["num_classes"]) for _ in range(5)]
    n_lc = N_OBS_SYNC + N_OBS_ASYNC
    lc_seqs, lc_labels = (np.concatenate(x)[:n_lc] for x in zip(*draws))
    lc_seqs = lc_seqs.astype(np.uint16)
    moe_seqs, _ = moe_held_out(N_OBS_ASYNC)
    work = {"landcover": lc_bodies, "lc_seqs": lc_seqs, "moe_seqs": moe_seqs,
            "lc_labels": lc_labels,
            "longcontext": [npy_bytes(s) for s in lc_seqs],
            "moe": [npy_bytes(s.astype(np.uint16)) for s in moe_seqs],
            "scenes": handoff["scenes"]}
    tmp = Path(tempfile.mkdtemp(prefix="ai4e_spans_"))
    spans_path = tmp / "spans.jsonl"
    env = dict(handoff["env"])
    env.update(AI4E_PLATFORM_OBSERVABILITY="1",
               AI4E_OBSERVABILITY_HOP_LEDGER="1",
               AI4E_OBSERVABILITY_VITALS="1",
               AI4E_OBSERVABILITY_TRACE_EXPORT_PATH=str(spans_path),
               AI4E_PLATFORM_SLO_OBJECTIVES=SLO_OBJECTIVES,
               # Ticks short against the phase, so every series exists
               # before /metrics is read.
               AI4E_PLATFORM_SLO_TICK_S="1",
               AI4E_OBSERVABILITY_VITALS_INTERVAL="0.25",
               AI4E_OBSERVABILITY_QUEUE_DEPTH_INTERVAL="1",
               AI4E_OBSERVABILITY_PROCESS_DEPTH_INTERVAL="1")
    out, cp_log, wk_log = serve_observed(handoff, env, work, "observed", True)
    if "observability ON, SLO engine ON (2 objectives), vitals ON" \
            not in cp_log or "vitals ON, hop ledger ON" not in wk_log:
        raise AssertionError(f"posture lines:\n{cp_log[-2000:]}\n"
                             f"{wk_log[-2000:]}")

    # Whole timelines, and the backpressure events all counted.
    timelines, backpressure = {}, 0
    for model, records in out["records"].items():
        want = TWO_STAGES if model == "camera_trap" else ONE_STAGE
        timelines[model] = []
        for record in records:
            events = record["Ledger"]
            check_timeline(record["TaskId"], events, want)
            backpressure += sum(e["e"] == "backpressure" for e in events)
            timelines[model].append(events)
    counted = (metric_sum(out["cp_after"], "ai4e_dispatch_total",
                          outcome="backpressure")
               - metric_sum(out["cp_before"], "ai4e_dispatch_total",
                            outcome="backpressure"))
    if backpressure != counted:
        raise AssertionError(f"{backpressure} backpressure events in the "
                             f"ledgers, {counted} counted")
    hops = {model: deltas_summary(evs) for model, evs in timelines.items()}

    # The trace verb printed every hop of its task.
    lc_task = out["landcover"]["task_ids"][0]
    for e in out["records"]["landcover"][0]["Ledger"]:
        if e["e"] not in out["trace_verb"]:
            raise AssertionError(f"trace verb lacks {e['e']}:\n"
                                 f"{out['trace_verb']}")

    # The span log: a land-cover task's spans linked; the sync split.
    spans = load_spans(str(spans_path))
    service = handoff["models"]["service_name"]
    span_ms = check_span_tree(spans, lc_task, service)
    log_tree = trace_verb(["--export", str(spans_path), "--task-id",
                           lc_task], env)
    if "create_task" not in log_tree or "dispatch" not in log_tree:
        raise AssertionError(f"trace over the span log:\n{log_tree}")
    sync = {}
    for model, route, path in (
            ("landcover", "/v1/landcover/classify", "/classify"),
            ("longcontext", "/v1/longcontext/score", "/score")):
        worker_ms = [s["duration"] * 1e3 for s in spans
                     if s["service"] == service and s["name"] == path]
        gw_count = metric_sum(out["cp_metrics"],
                              "ai4e_request_e2e_seconds_count", route=route)
        gw_sum = metric_sum(out["cp_metrics"], "ai4e_request_e2e_seconds_sum",
                            route=route)
        if len(worker_ms) != N_OBS_SYNC or gw_count != N_OBS_SYNC:
            raise AssertionError(f"{model}: {len(worker_ms)} worker sync "
                                 f"spans, {gw_count} gateway observations")
        sync[model] = {"client_p50_ms": out[model]["sync_p50_ms"],
                       "gateway_mean_ms": gw_sum / gw_count * 1e3,
                       "worker_span_p50_ms": statistics.median(worker_ms)}

    # The debug surfaces.
    entries = out["flight"]["entries"]
    if not entries or not all(e.get("reason") for e in entries):
        raise AssertionError(f"flight dump: {out['flight']}")
    cp_text, wk_text = out["cp_metrics"], out["wk_metrics"]
    needed = {
        "an e2e exemplar": "# exemplar ai4e_request_e2e_seconds_bucket",
        "the latency burn rate": 'ai4e_slo_burn_rate{kind="latency",'
                                 'route="/v1/landcover/classify-async"',
        "the goodput burn rate": 'ai4e_slo_burn_rate{kind="goodput",'
                                 'route="/v1/landcover/classify"',
        "the depth gauges": "ai4e_task_depth{",
        "the control plane's vitals": "ai4e_process_loop_lag_seconds_count",
        "the span metrics": 'ai4e_span_seconds_count{name="dispatch"'}
    for what, text in needed.items():
        if text not in cp_text:
            raise AssertionError(f"control-plane /metrics lacks {what}")
    for what in ("ai4e_process_loop_lag_seconds_count",
                 "ai4e_process_rss_bytes", "ai4e_device_phase_seconds"):
        if what not in wk_text:
            raise AssertionError(f"worker /metrics lacks {what}")

    # Every answer, and every kernel of the path launched in the worker.
    answers = served_references(handoff, work, out)
    by_model = launches_by_model(wk_log)
    need = {("landcover", "normalize_image"),
            ("landcover", "fused_seg_postprocess"),
            ("megadetector", "normalize_image"),
            ("species", "normalize_image"),
            ("longcontext", "flash_attention"), ("moe", "flash_attention")}
    for model, kernel in need:
        if by_model.get(model, {}).get(kernel, 0) < 1:
            raise AssertionError(f"{kernel} never launched for {model}: "
                                 f"{by_model}")

    # The land-cover rates with spans to the JSONL log, reported, not
    # gated (the turns with JAX's tracing defaults and with tracing off
    # were cut for the script's time limit).
    rates = [out["landcover"]["async_requests_per_s"]] + out["bursts"]

    rows = {k["name"]: k for k in kernels}
    rows["normalize_image"]["launches_observability"] = {
        m: by_model[m]["normalize_image"]
        for m in ("landcover", "megadetector", "species")}
    rows["fused_seg_postprocess"]["launches_observability"] = \
        by_model["landcover"]["fused_seg_postprocess"]
    rows["flash_attention"]["launches_observability"] = {
        m: by_model[m]["flash_attention"] for m in ("longcontext", "moe")}
    for model, summary in hops.items():
        log(f"observability hops {model} (ms): {json.dumps(summary)}")
    report = {
        "card": CARD["smi"], "clients": "another process",
        "tasks": {m: len(t) for m, t in timelines.items()},
        "backpressure_events": backpressure,
        "sync_split": sync, "landcover_task_span_ms": span_ms,
        "landcover_async_requests_per_s": rates,
        "span_log_lines": sum(1 for _ in spans_path.open()),
        "rate_median": statistics.median(rates),
        "flight": {"entries": len(entries),
                   "by_reason": out["flight"]["by_reason"]},
        "answers": answers, "launches_by_model": by_model}
    log(f"observability: {json.dumps(report)}")
    return report


# -- phase 12: the streaming LM ---------------------------------------------

LM_SLOTS = 64                    # the longcontext entry's top batch bucket
LM_PROMPT_BUCKETS = (1, 16, 64)  # ladder.DECODE_PROMPT_BUCKETS; + max_len
LM_SMALL = {"vocab_size": 64, "max_len": 48, "dim": 32, "depth": 2,
            "heads": 2, "eos_id": 63}  # JAX's verify geometry
LM_SMALL_SLOTS, LM_SMALL_BUCKETS = 2, (8,)
N_LM_STREAMS = 128      # 12b's load, offered at once to the 64 slots
LM_SHORT_NEW, LM_LONG_NEW, LM_LONG_SHARE = 8, 256, 0.3
LM_PROMPT_RANGE = (4, 1024)
LM_TIE_GAP = 1e-3       # ids agree up to the plain decode's first gap below it
N_LM_REF, LM_REF_PROMPT, LM_REF_NEW = 8, 512, 32  # 12b's float64 check
N_LM_RELOAD = 16        # 12c: long streams active across the reload
LM_RUNWAY_NEW = 2048    # 12c: their tokens, seconds of decode on the card
N_LM_AFTER = 8          # 12c: streams sent after it
N_LM_DRAIN = 8          # 12c: long streams active across the drain
N_LM_SEQ, N_LM_ASYNC = 4, 64  # 12d: one after another, then at once
LM_ROUTE = "/v1/lm/stream-async"
LM_BACKEND = "/v1/lm/lm-stream-async"


def lm_geometry() -> dict:
    """The streaming LM at the widths of the SeqFormer that
    deploy/specs/models.json deploys (``longcontext``): its vocabulary,
    width, depth and heads, and its sequence length as the cache length."""
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    lc = next(m for m in spec["models"] if m["name"] == "longcontext")
    return {"vocab_size": lc["vocab_size"], "max_len": lc["seq_len"],
            "dim": lc["dim"], "depth": lc["depth"], "heads": lc["heads"],
            "eos_id": lc["vocab_size"] - 1}


def lm_streams(n: int, seed: int, vocab: int,
               long_share: float = LM_LONG_SHARE,
               long_new: int | None = None) -> list[tuple]:
    """``n`` (prompt, max_new_tokens) pairs of the bench's mix: a
    ``long_share`` of ``long_new`` (default ``LM_LONG_NEW``) tokens, the
    rest ``LM_SHORT_NEW``; prompt lengths log-uniform over
    ``LM_PROMPT_RANGE``."""
    long_new = long_new or LM_LONG_NEW
    rng = np.random.default_rng(seed)
    long = set(rng.choice(n, int(round(long_share * n)),
                          replace=False).tolist())
    lo, hi = np.log(LM_PROMPT_RANGE[0]), np.log(LM_PROMPT_RANGE[1])
    out = []
    for i in range(n):
        length = int(np.exp(rng.uniform(lo, hi)))
        out.append((rng.integers(0, vocab, length).tolist(),
                    long_new if i in long else LM_SHORT_NEW))
    return out


def lm_plain_greedy(module, streams, eos_id, max_len: int,
                    chunk: int = 64) -> list[tuple[list[int], list[float]]]:
    """A plain greedy decode of each (prompt, max_new) on the module's
    device, eagerly: each prompt prefilled unpadded through the blocks,
    then ``chunk`` sequences stepped together over a cache of their own,
    under the engine's stop rule (EOS, the token budget, a full cache).
    Returns each sequence's tokens and each token's top-two logit gap."""
    dev = module.pos_emb.device
    hd = module.dim // module.heads
    out = []
    with torch.inference_mode():
        for c in range(0, len(streams), chunk):
            batch = streams[c:c + chunk]
            length = min(max_len, max(len(p) + n for p, n in batch))
            shape = (module.depth, len(batch), module.heads, length, hd)
            k = torch.zeros(shape, device=dev)
            v = torch.zeros(shape, device=dev)
            toks: list[list[int]] = [[] for _ in batch]
            gaps: list[list[float]] = [[] for _ in batch]
            done = [False] * len(batch)
            pos = [len(p) for p, _ in batch]

            def take(rows, logits):
                """Each row's argmax (first index on ties) and top-two
                gap, read to the host in one transfer."""
                top = torch.topk(logits, 2, dim=-1).values
                ids = torch.argmax(logits, dim=-1).tolist()
                gap = (top[:, 0] - top[:, 1]).tolist()
                for i in rows:
                    toks[i].append(ids[i])
                    gaps[i].append(gap[i])
                    if (len(toks[i]) >= batch[i][1] or ids[i] == eos_id
                            or pos[i] >= max_len):
                        done[i] = True

            last = []
            for i, (prompt, _) in enumerate(batch):
                x = torch.tensor([prompt], device=dev)
                h = module.embed(x) + module.pos_emb[None, :len(prompt)]
                mask = torch.ones_like(x, dtype=torch.bool)
                for layer, block in enumerate(module.blocks):
                    h, kb, vb = block.prefill(h, mask)
                    k[layer, i, :, :len(prompt)] = kb[0]
                    v[layer, i, :, :len(prompt)] = vb[0]
                last.append(h[0, -1])
            take(range(len(batch)), module.logits(torch.stack(last)))
            while not all(done):
                live = [i for i in range(len(batch)) if not done[i]]
                x = torch.tensor([toks[i][-1] if not done[i] else 0
                                  for i in range(len(batch))], device=dev)
                p = torch.tensor([pos[i] if not done[i] else 0
                                  for i in range(len(batch))], device=dev)
                h = module.embed(x) + module.pos_emb[p]
                for layer, block in enumerate(module.blocks):
                    h = block.step(h, k[layer], v[layer], p)
                for i in live:
                    pos[i] += 1
                take(live, module.logits(h))
            out += list(zip(toks, gaps))
    return out


def lm_reference_greedy(module, streams, eos_id, max_len: int,
                        n_new: int) -> list[tuple[list[int], list[float]]]:
    """A greedy decode that shares no code with the module: its weights in
    float64 on the CPU, each token from a full causal forward over the
    whole sequence so far, written out here from the state dict (flax's
    LayerNorm eps, the tanh gelu, the tied head). At most ``n_new`` tokens
    a stream, under the engine's stop rule. Returns each sequence's tokens
    and each token's top-two logit gap."""
    import math

    import torch.nn.functional as F

    w = {k: t.detach().to("cpu", torch.float64)
         for k, t in module.state_dict().items()}
    dim, heads = w["pos_emb"].shape[1], module.heads
    hd = dim // heads

    def norm(x, name):
        return F.layer_norm(x, (dim,), w[name + ".weight"],
                            w[name + ".bias"], 1e-6)

    def last_logits(ids: list[int]) -> torch.Tensor:
        t = len(ids)
        h = w["embed.weight"][torch.tensor(ids)] + w["pos_emb"][:t]
        causal = torch.ones((t, t), dtype=torch.bool).tril()
        for i in range(module.depth):
            b = f"blocks.{i}."
            qkv = (norm(h, b + "ln1") @ w[b + "qkv.weight"].T).view(
                t, 3, heads, hd)
            q, k, v = (qkv[:, j].transpose(0, 1) for j in range(3))
            s = (q @ k.transpose(1, 2) / math.sqrt(hd)).masked_fill(
                ~causal, float("-inf"))
            o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1)
            h = h + o.reshape(t, dim) @ w[b + "proj.weight"].T
            u = (norm(h, b + "ln2") @ w[b + "mlp_up.weight"].T
                 + w[b + "mlp_up.bias"])
            h = h + (F.gelu(u, approximate="tanh") @ w[b + "mlp_down.weight"].T
                     + w[b + "mlp_down.bias"])
        return norm(h[-1], "ln_f") @ w["embed.weight"].T

    out = []
    with torch.inference_mode():
        for prompt, max_new in streams:
            ids, toks, gaps = list(prompt), [], []
            while True:
                logits = last_logits(ids)
                top = torch.topk(logits, 2).values
                toks.append(int(torch.argmax(logits)))
                gaps.append(float(top[0] - top[1]))
                if (len(toks) >= min(max_new, n_new) or toks[-1] == eos_id
                        or len(ids) >= max_len):
                    break
                ids.append(toks[-1])
            out.append((toks, gaps))
    return out


def lm_agrees(got: list[int], want: list[int], gaps: list[float],
              what: str) -> bool:
    """``got`` equals the plain decode's ``want`` up to its first token
    whose top-two gap is below ``LM_TIE_GAP`` (past it the two may fork),
    else raises; True when they are equal all the way."""
    close = [i for i, g in enumerate(gaps) if g < LM_TIE_GAP]
    upto = close[0] if close else len(want)
    if got[:upto] != want[:upto]:
        first = next(i for i in range(upto)
                     if i >= len(got) or got[i] != want[i])
        raise AssertionError(
            f"{what}: token {first} is {got[first:first + 3]}, the plain "
            f"decode's {want[first:first + 3]} (gap {gaps[first]:.3g})")
    if not close and got != want:
        raise AssertionError(f"{what}: {len(got)} tokens, the plain decode "
                             f"{len(want)}")
    return got == want


def lm_program_ms(rt) -> dict:
    """Each captured program's replay against an eager run of the module
    on the same static inputs, in ms (``stream_ms``)."""
    out = {}
    with torch.inference_mode():
        for key, graph in rt.graphs.items():
            if key[0] == "prefill":
                def fn(g=graph):
                    rt.module.prefill(*g.inputs)
            else:
                k, v = rt.k_cache.clone(), rt.v_cache.clone()

                def fn(g=graph, k=k, v=v):
                    rt.module.decode_step(g.inputs[0], k, v, g.inputs[1])
            out[lm_program(key)] = {"eager_ms": stream_ms(fn),
                                    "replay_ms": stream_ms(graph.graph.replay)}
    return out


def lm_program(key: tuple) -> str:
    return "step" if key[0] == "step" else f"prefill_{key[1]}"


def lm_graphs_equal_eager(rt, seed: int) -> dict:
    """12a: each prefill bucket's replay (through ``prefill_into``) and the
    step's (through ``step``, one slot idle at position 0) against an eager
    run of the module on the same inputs: the tokens and the caches
    ``torch.equal``."""
    rng = np.random.default_rng(seed)
    vocab, dev = rt.servable.vocab_size, rt.device
    with torch.inference_mode():
        for bucket in rt.prompt_buckets:
            n = min(bucket, rt.max_len - 1)
            slot = bucket % rt.slots
            prompt = rng.integers(0, vocab, n).tolist()
            got = rt.prefill_into(slot, prompt)
            padded = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
            padded[0, :n] = torch.tensor(prompt, device=dev)
            want, k, v = rt.module.prefill(padded,
                                           torch.tensor([n], device=dev))
            if (got != int(want[0])
                    or not torch.equal(rt.k_cache[:, slot, :, :bucket],
                                       k[:, 0])
                    or not torch.equal(rt.v_cache[:, slot, :, :bucket],
                                       v[:, 0])):
                raise AssertionError(f"prefill bucket {bucket} of "
                                     f"{rt.max_len}: replay differs from "
                                     "eager")
        tokens = rng.integers(0, vocab, rt.slots).tolist()
        positions = rng.integers(1, rt.max_len, rt.slots).tolist()
        positions[0] = 0
        k, v = rt.k_cache.clone(), rt.v_cache.clone()
        if dev.type == "cuda":
            torch.cuda.synchronize()  # the clones before the step's writes
        got = rt.step(tokens, positions, [False] + [True] * (rt.slots - 1))
        want, _, _ = rt.module.decode_step(
            torch.tensor(tokens, device=dev), k, v,
            torch.tensor(positions, device=dev))
        if (got != want.tolist() or not torch.equal(rt.k_cache, k)
                or not torch.equal(rt.v_cache, v)):
            raise AssertionError(f"step over {rt.slots} slots of "
                                 f"{rt.max_len}: replay differs from eager")
    rt.reset_cache()
    return {"programs": [lm_program(k) for k in rt.graphs], "equal": True}


class LMRecorder:
    """Wraps a runtime's ``prefill_into``, ``step`` and ``reset_cache``
    (the engine calls them on its executor thread): host ms of each call,
    to its tokens on the host; each prefill's bucket, tokens and the
    weights' version after it; each step's active slots."""

    def __init__(self, rt):
        self.rt = rt
        self.prefills: list[tuple[int, float]] = []
        self.steps: list[tuple[int, float]] = []
        self.histories: list[tuple[int, list[int]]] = []
        self.resets = 0
        self._wrapped = (rt.prefill_into, rt.step, rt.reset_cache)
        rt.prefill_into, rt.step, rt.reset_cache = (
            self.prefill_into, self.step, self.reset_cache)

    def restore(self) -> None:
        (self.rt.prefill_into, self.rt.step,
         self.rt.reset_cache) = self._wrapped

    def prefill_into(self, slot, tokens):
        t0 = time.perf_counter()
        out = self._wrapped[0](slot, tokens)
        self.prefills.append((self.rt.bucket_for(len(tokens)),
                              (time.perf_counter() - t0) * 1e3))
        self.histories.append((self.rt.params_version, list(tokens)))
        return out

    def step(self, tokens, positions, active):
        t0 = time.perf_counter()
        out = self._wrapped[1](tokens, positions, active)
        self.steps.append((sum(active), (time.perf_counter() - t0) * 1e3))
        return out

    def reset_cache(self):
        self.resets += 1
        return self._wrapped[2]()

    def summary(self) -> dict:
        step_ms = [ms for _, ms in self.steps]
        by_bucket: dict = {}
        for bucket, ms in self.prefills:
            by_bucket.setdefault(bucket, []).append(ms)
        return {
            "steps": len(self.steps),
            "step_ms_p50": statistics.median(step_ms),
            "step_ms_p95": pct(step_ms, 95),
            "prefill_ms_p50_by_bucket": {
                str(b): statistics.median(v)
                for b, v in sorted(by_bucket.items())},
            "prefills_by_bucket": {str(b): len(v)
                                   for b, v in sorted(by_bucket.items())},
            "occupancy": (statistics.mean(n for n, _ in self.steps)
                          / self.rt.slots)}


def pct(values: list[float], q: float) -> float:
    return float(np.percentile(values, q))


async def lm_engine_run(rt, streams, continuous: bool) -> dict:
    """12b: every stream submitted at once to a fresh engine over ``rt``;
    returns each stream's tokens and the client-side timings."""
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.runtime.decode import DecodeEngine

    engine = DecodeEngine(rt, max_pending=len(streams),
                          continuous=continuous, metrics=MetricsRegistry())
    await engine.start()
    stamps: list[list[float]] = [[] for _ in streams]

    async def one(i, prompt, max_new):
        t0 = time.perf_counter()
        tokens = await engine.submit(
            prompt, max_new,
            on_token=lambda _, __, s=stamps[i]: s.append(time.perf_counter()))
        return t0, tokens

    t0 = time.perf_counter()
    try:
        runs = await asyncio.gather(*(one(i, p, n)
                                      for i, (p, n) in enumerate(streams)))
    finally:
        await engine.stop()
    wall = time.perf_counter() - t0
    engine.pool.check_conservation()
    ttft = [(s[0] - t) * 1e3 for (t, _), s in zip(runs, stamps)]
    gaps = [(b - a) * 1e3 for s in stamps for a, b in zip(s, s[1:])]
    n_tokens = sum(len(t) for _, t in runs)
    return {"tokens": [t for _, t in runs], "report": {
        "continuous": continuous, "streams": len(streams),
        "tokens": n_tokens, "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p95": pct(ttft, 95),
        "intertoken_ms_p50": pct(gaps, 50),
        "intertoken_ms_p95": pct(gaps, 95)}}


def lm_module(geo: dict, seed: int, device):
    """The LM of ``build_lm_servable`` on seed ``seed``, on ``device``."""
    from ai4e_tpu_torch.runtime.kvcache import build_lm_servable

    return build_lm_servable(
        name="lm", generator=torch.Generator().manual_seed(seed),
        **geo).module.to(device)


def lm_runtime(geo: dict, slots: int, buckets, device) -> tuple:
    """A warmed ``PagedDecodeRuntime`` on seed-0 weights over a
    ``ModelRuntime`` of its own, as the worker builds it (its lock,
    execute stream and graph pool), and its warm seconds."""
    from ai4e_tpu_torch.runtime.kvcache import (PagedDecodeRuntime,
                                                build_lm_servable)
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    lm = build_lm_servable(name="lm", generator=torch.Generator()
                           .manual_seed(SEED), **geo)
    rt = PagedDecodeRuntime(lm, ModelRuntime(device), slots=slots,
                            prompt_buckets=buckets)
    t0 = time.perf_counter()
    rt.warm()
    return rt, time.perf_counter() - t0


def phase_lm_in_process(geo: dict, device: str = "cuda") -> dict:
    """12a at JAX's verify geometry and at ``geo``, then 12b on the wide
    runtime."""
    small, warm_s = lm_runtime(LM_SMALL, LM_SMALL_SLOTS, LM_SMALL_BUCKETS,
                               device)
    report = {"12a_small": {**lm_graphs_equal_eager(small, SEED),
                            "warm_s": warm_s}}
    del small
    rt, warm_s = lm_runtime(geo, LM_SLOTS, LM_PROMPT_BUCKETS, device)
    want_bytes = (2 * geo["depth"] * LM_SLOTS * geo["max_len"] * geo["dim"]
                  * 4)
    if rt.cache_nbytes() != want_bytes:
        raise AssertionError(f"cache_nbytes {rt.cache_nbytes()} != "
                             f"{want_bytes}")
    report["12a_wide"] = {**lm_graphs_equal_eager(rt, SEED + 1),
                          "warm_s": warm_s, "cache_bytes": rt.cache_nbytes()}
    if device == "cuda":
        report["12a_wide"]["programs_ms"] = lm_program_ms(rt)
        rt.reset_cache()
    log(f"lm 12a: {json.dumps(report)}")

    streams = lm_streams(N_LM_STREAMS, SEED, geo["vocab_size"])
    runs = {}
    for continuous in (True, False):
        before = {k: g.replays for k, g in rt.graphs.items()}
        recorder = LMRecorder(rt)
        try:
            run = asyncio.run(lm_engine_run(rt, streams, continuous))
        finally:
            recorder.restore()
        rt.reset_cache()
        run["report"].update(recorder.summary())
        run["report"]["replays"] = {
            lm_program(k): g.replays - before[k] for k, g in rt.graphs.items()}
        if device == "cuda" and not run["report"]["replays"]["step"]:
            raise AssertionError("12b: the step's graph never replayed")
        runs["continuous" if continuous else "whole_batch"] = run
    t0 = time.perf_counter()
    plain = lm_plain_greedy(rt.module, streams, geo["eos_id"], rt.max_len)
    report["plain_decode_s"] = time.perf_counter() - t0
    for mode, run in runs.items():
        equal = sum(lm_agrees(got, want, gaps, f"12b {mode} stream {i}")
                    for i, (got, (want, gaps)) in enumerate(
                        zip(run["tokens"], plain)))
        report[f"12b_{mode}"] = {**run["report"],
                                 "equal_all_the_way": f"{equal}/"
                                                      f"{len(streams)}"}
    report["12b_near_ties"] = sum(g < LM_TIE_GAP for _, gaps in plain
                                  for g in gaps)
    # The plain decode runs the module's own blocks; the LM's arithmetic at
    # this geometry is held against a float64 forward written apart.
    picks = [i for i, (p, _) in enumerate(streams)
             if len(p) <= LM_REF_PROMPT][:N_LM_REF]
    t0 = time.perf_counter()
    ref = lm_reference_greedy(rt.module, [streams[i] for i in picks],
                              geo["eos_id"], rt.max_len, LM_REF_NEW)
    report["reference_decode_s"] = time.perf_counter() - t0
    for mode, run in runs.items():
        equal = sum(lm_agrees(run["tokens"][i][:len(want)], want, gaps,
                              f"12b {mode} stream {i} against float64")
                    for i, (want, gaps) in zip(picks, ref))
        report[f"12b_{mode}"]["float64_equal_all_the_way"] = (
            f"{equal}/{len(picks)}")
    t0 = time.perf_counter()
    report["12e"] = asyncio.run(lm_chunks_drive(rt, geo, device))
    report["12e"]["seconds"] = time.perf_counter() - t0
    report["12e"]["phase12_ttft_ms_p50"] = (
        report["12b_continuous"]["ttft_ms_p50"])
    log(f"lm 12e: {json.dumps(report['12e'])}")
    del rt
    return report


async def lm_chunks_drive(rt, geo: dict, device: str) -> dict:
    """20c, run as 12e on 12b's engine and graphs: the LM served in this
    process by an ``InferenceWorker`` whose ``event_hub`` is a pipeline
    platform's hub. 32 stream tasks through the platform's gateway, each
    watched on its SSE stream from its creation; one long task read after
    its completion (a replay past ``pipeline_chunk_replay``); then a
    one-stage DAG whose stage is the LM."""
    import aiohttp
    from aiohttp import web

    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.ops import flash_attention as flash
    from ai4e_tpu_torch.pipeline import PipelineSpec, StageSpec
    from ai4e_tpu_torch.platform_assembly import (LocalPlatform,
                                                  PlatformConfig)
    from ai4e_tpu_torch.runtime.batcher import MicroBatcher
    from ai4e_tpu_torch.runtime.decode import DecodeEngine
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.runtime.worker import InferenceWorker

    platform = LocalPlatform(PlatformConfig(pipeline=True, retry_delay=0.05,
                                            dispatcher_concurrency=64),
                             metrics=MetricsRegistry())
    engine = DecodeEngine(rt, max_pending=2 * N_CHUNK_STREAMS,
                          metrics=MetricsRegistry())
    side = ModelRuntime(device)
    worker = InferenceWorker(
        "lmsvc", side, MicroBatcher(side, metrics=MetricsRegistry()),
        task_manager=platform.task_manager, prefix="v1/lm",
        metrics=MetricsRegistry(), store=platform.store)
    worker.serve_stream(engine, event_hub=platform.task_events)
    wk_port, gw_port = free_port(), free_port()
    backend = f"http://127.0.0.1:{wk_port}{LM_BACKEND}"
    gateway = f"http://127.0.0.1:{gw_port}"
    platform.publish_async_api(LM_ROUTE, backend)
    platform.register_pipeline(PipelineSpec("lmdag", "/v1/pipelines/lm", [
        StageSpec("lm", backend)]))
    runners = []
    for app, port in ((worker.service.app, wk_port),
                      (platform.gateway.app, gw_port)):
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        runners.append(runner)
    await engine.start()
    await platform.start()
    streams = [(p, CHUNK_NEW) for p, _ in lm_streams(
        N_CHUNK_STREAMS, SEED + 12, geo["vocab_size"], long_share=0.0)]
    # Whether the LM's prefill reaches the flash kernel: counted either way.
    out: dict = {"flash_launches_before": flash.launches}
    try:
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0),
                timeout=aiohttp.ClientTimeout(total=600)) as http:

            async def one(path: str, prompt: list, new: int,
                          late: bool = False) -> dict:
                t0 = time.monotonic()
                async with http.post(gateway + path, data=json.dumps(
                        {"prompt": prompt, "max_new_tokens": new})) as r:
                    task_id = (await r.json())["TaskId"]
                url = f"{gateway}/v1/taskmanagement/task/{task_id}/events"
                if late:
                    await http_json(http, "GET", f"{gateway}/v1/task"
                                    f"management/task/{task_id}",
                                    params={"wait": "120"})
                events = await sse_read(http, url)
                stored = json.loads(platform.store.get_result(task_id)[0])
                chunks = [e for e in events if e["event"] == "chunk"]
                return {"id": task_id, "stored": stored["tokens"],
                        "kinds": [e["event"] for e in events],
                        "chunks": [(e["data"]["stage"], e["data"]["index"],
                                    e["data"]["data"]["token"])
                                   for e in chunks],
                        "ttft_ms": ((chunks[0]["at"] - t0) * 1e3
                                    if chunks else None)}

            runs = await asyncio.gather(*(one(LM_ROUTE, p, n)
                                          for p, n in streams))
            for r in runs:
                want = [("lm", i, t) for i, t in enumerate(r["stored"])]
                if r["chunks"] != want:
                    raise AssertionError(f"12e: chunks of {r['id']} "
                                         f"{r['chunks'][:8]}... vs stored "
                                         f"{r['stored'][:8]}...")
                if r["kinds"][0] != "status" or r["kinds"][-1] != "terminal":
                    raise AssertionError(f"12e: events {r['kinds']}")
            late = await one(LM_ROUTE, streams[0][0], CHUNK_LONG_NEW,
                             late=True)
            n_late = len(late["stored"])
            if n_late > 128:
                kept = late["chunks"]
                if ("truncated" not in late["kinds"]
                        or [c[1] for c in kept] != list(range(n_late - 128,
                                                              n_late))
                        or [c[2] for c in kept] != late["stored"][-128:]):
                    raise AssertionError(f"12e: late replay {late['kinds']}"
                                         f" of {n_late} tokens")
            dag = await one("/v1/pipelines/lm", streams[1][0], CHUNK_NEW)
            if dag["chunks"] != [("lm", i, t)
                                 for i, t in enumerate(dag["stored"])]:
                raise AssertionError(f"12e: the DAG's chunks {dag}")
            subscribers = platform.task_events.subscriber_count
            if subscribers:
                raise AssertionError(f"12e: {subscribers} subscribers left")
    finally:
        await platform.stop()
        await engine.stop()
        for runner in runners:
            await runner.cleanup()
    ttft = [r["ttft_ms"] for r in runs]
    out.update({"streams": len(runs),
                "tokens": sum(len(r["stored"]) for r in runs),
                "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p95": pct(ttft, 95),
                "late_tokens": n_late,
                "late_replay": "truncated" in late["kinds"],
                "dag_chunks": len(dag["chunks"]), "dag_root": dag["id"],
                "flash_launches": flash.launches
                - out.pop("flash_launches_before")})
    return out


# -- 12c: the worker in process, a reload and a drain mid-stream


def lm_worker_env(geo: dict) -> dict:
    """The decode knobs of the worker that serves ``geo``."""
    return {"AI4E_RUNTIME_DECODE_ENABLE": "1",
            "AI4E_RUNTIME_KV_SLOTS": str(LM_SLOTS),
            "AI4E_RUNTIME_KV_MAX_LEN": str(geo["max_len"]),
            "AI4E_RUNTIME_DECODE_PROMPT_BUCKETS": ",".join(
                map(str, LM_PROMPT_BUCKETS)),
            "AI4E_RUNTIME_DECODE_MAX_PENDING": str(N_LM_STREAMS)}


def lm_worker_spec(geo: dict, taskstore: str | None = None) -> dict:
    """One ``seqformer-lm`` model at ``geo`` (its ``max_len`` from
    ``AI4E_RUNTIME_KV_MAX_LEN``), seed-0 weights."""
    model = {"family": "seqformer-lm", "name": "lm",
             **{k: v for k, v in geo.items() if k != "max_len"}}
    spec = {"service_name": "lm-worker", "prefix": "v1/lm",
            "models": [model]}
    if taskstore:
        spec["taskstore"] = taskstore
    return spec


async def until(cond, what: str, timeout: float = 300.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.005)


async def lm_submit(http, url: str, prompt: list[int],
                    max_new: int) -> tuple[str, int]:
    """POST one stream request, again after each 503; its task id and the
    503s met."""
    retries = 0
    while True:
        async with http.post(url, json={"prompt": prompt,
                                        "max_new_tokens": max_new}) as r:
            if r.status == 503:
                retries += 1
                await asyncio.sleep(0.02)
                continue
            if r.status != 200:
                raise AssertionError(f"stream {r.status}: {await r.text()}")
            return (await r.json())["TaskId"], retries


async def lm_finish(http, base: str, worker, task_id: str) -> list[int]:
    """Poll the task to ``completed - N tokens``; its stored tokens."""
    while True:
        async with http.get(f"{base}/task/{task_id}") as r:
            status = (await r.json())["Status"]
        if not status.startswith(("created", "running")):
            break
        await asyncio.sleep(0.01)
    result = json.loads(worker.store.get_result(task_id)[0])
    if status != f"completed - {result['count']} tokens":
        raise AssertionError(f"task {task_id}: {status}")
    return result["tokens"]


async def drive_lm_worker(worker, batcher, port: int, npz: str,
                          geo: dict) -> dict:
    engine, = worker.decode_engines
    counter = worker.service.metrics.counter
    tokens_total = counter("ai4e_decode_tokens_total")
    reprefills = counter("ai4e_decode_reprefills_total")
    vocab = geo["vocab_size"]
    pre = lm_streams(N_LM_RELOAD, SEED + 2, vocab, 1.0, LM_RUNWAY_NEW)
    after = lm_streams(N_LM_AFTER, SEED + 3, vocab)
    drained = lm_streams(N_LM_DRAIN, SEED + 4, vocab, 1.0, LM_RUNWAY_NEW)
    resumed = lm_streams(1, SEED + 5, vocab)
    out: dict = {}
    async with serving(worker, batcher, port) as (http, base):
        url = base + "/lm-stream-async"
        pre_ids = [(await lm_submit(http, url, p, n))[0] for p, n in pre]
        await until(lambda: engine.active_count == N_LM_RELOAD
                    and not engine.pending_count
                    and tokens_total.value(model="lm") >= 8 * N_LM_RELOAD,
                    "the streams before the reload")
        before = reprefills.value(model="lm")
        async with http.post(base + "/models/lm/reload",
                             json={"checkpoint": npz}) as r:
            out["reload"] = (r.status, await r.json())
        if out["reload"][0] != 200 or out["reload"][1][
                "params_version"] != 2:
            raise AssertionError(f"12c reload: {out['reload']}")
        await until(lambda: reprefills.value(model="lm") - before
                    >= N_LM_RELOAD, "the re-prefills")
        after_ids = [(await lm_submit(http, url, p, n))[0] for p, n in after]
        out["pre"] = [await lm_finish(http, base, worker, t) for t in pre_ids]
        out["after"] = [await lm_finish(http, base, worker, t)
                        for t in after_ids]
        out["reprefills"] = reprefills.value(model="lm") - before

        drain_ids = [(await lm_submit(http, url, p, n))[0]
                     for p, n in drained]
        await until(lambda: engine.active_count == N_LM_DRAIN,
                    "the streams before the drain")

        async def post_drain() -> dict:
            async with http.post(base + "/worker/drain",
                                 json={"timeout_ms": 120000}) as r:
                return await r.json()

        drain = asyncio.create_task(post_drain())
        await until(lambda: worker.drain_state.is_draining, "draining")
        async with http.post(url, json={"prompt": [1]}) as r:
            out["refused"] = (r.status, r.headers.get("X-Draining"))
        out["drain"] = await drain
        out["drained"] = [await lm_finish(http, base, worker, t)
                          for t in drain_ids]
        async with http.post(base + "/worker/resume") as r:
            out["resume"] = (await r.json())["state"]
        task_id, _ = await lm_submit(http, url, *resumed[0])
        out["resumed"] = [await lm_finish(http, base, worker, task_id)]
        async with http.get(base.rsplit("/v1", 1)[0] + "/metrics") as r:
            out["metrics"] = await r.text()
    out["streams"] = {"pre": pre, "after": after, "drained": drained,
                      "resumed": resumed}
    return out


def phase_lm_worker(geo: dict, device: str = "cuda") -> dict:
    """12c: ``build_worker`` serving the LM at ``geo`` in process over
    HTTP: a ``.npz`` reload while streams decode, then a drain."""
    import gc

    from ai4e_tpu_torch import convert
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.config import FrameworkConfig

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    new = lm_module(geo, SEED + 1, "cpu")
    npz = str(out_dir / "lm_seed1.npz")
    convert.save_npz(convert.seqformer_lm_flax_from_state_dict(
        new.state_dict()), npz)
    config = FrameworkConfig.from_env({
        **lm_worker_env(geo), "AI4E_RUNTIME_CHECKPOINT_DIR": str(out_dir)})
    t0 = time.perf_counter()
    worker, batcher, _ = build_worker(lm_worker_spec(geo), device=device,
                                      config=config)
    boot_s = time.perf_counter() - t0
    backend = worker.decode_engines[0].backend
    recorder = LMRecorder(backend)
    try:
        out = asyncio.run(drive_lm_worker(worker, batcher, free_port(), npz,
                                          geo))
    finally:
        recorder.restore()
    del worker, batcher, backend
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    if out["refused"] != (503, "1"):
        raise AssertionError(f"12c: a stream while draining got "
                             f"{out['refused']}")
    drain = out["drain"]
    if not (drain["clean"] and drain["forced"] == 0
            and drain["state"] == "drained" and out["resume"] == "active"):
        raise AssertionError(f"12c drain: {drain}, resume {out['resume']}")
    failed = metric_sum(out["metrics"], "ai4e_decode_sequences_total",
                        outcome="failed")
    if failed or out["reprefills"] < N_LM_RELOAD or recorder.resets < 1:
        raise AssertionError(f"12c: {failed} failed, {out['reprefills']} "
                             f"re-prefills, {recorder.resets} cache resets")

    # Tokens: before its re-prefill a stream decodes on the old weights
    # (seed 0), after it on the new (seed 1) from the history it had. The
    # step just before the re-prefill may have run on the new weights over
    # the old cache (the swap lands between two ticks), so that one token
    # is checked only as part of the history.
    old, new = lm_module(geo, SEED, device), new.to(device)
    eos, max_len = geo["eos_id"], geo["max_len"]
    old_ref = lm_plain_greedy(old, out["streams"]["pre"], eos, max_len)
    tails, equal, n = [], 0, 0
    for i, ((prompt, max_new), got) in enumerate(zip(out["streams"]["pre"],
                                                     out["pre"])):
        history = next((h for v, h in recorder.histories
                        if v == 2 and len(h) > len(prompt)
                        and h[:len(prompt)] == prompt), None)
        if history is None:
            raise AssertionError(f"12c stream {i} was not re-prefilled")
        cut = len(history) - len(prompt)
        if history[len(prompt):] != got[:cut]:
            raise AssertionError(f"12c stream {i}: re-prefill history is "
                                 "not its tokens")
        want, gaps = old_ref[i]
        lm_agrees(got[:cut - 1], want[:cut - 1], gaps[:cut - 1],
                  f"12c stream {i} before the reload")
        tails.append(((history, max_new - cut), got[cut:]))
    checks = tails + [
        ((p, m), got) for key in ("after", "drained", "resumed")
        for (p, m), got in zip(out["streams"][key], out[key])]
    new_ref = lm_plain_greedy(new, [s for s, _ in checks], eos, max_len)
    for ((_, _), got), (want, gaps) in zip(checks, new_ref):
        equal += lm_agrees(got, want, gaps, "12c on the new weights")
        n += 1
    report = {"boot_s": boot_s, "reload": out["reload"][1],
              "reprefills": out["reprefills"], "cache_resets": recorder.resets,
              "refused_while_draining": out["refused"][0],
              "drain": drain, "failed": failed,
              "equal_all_the_way_new_weights": f"{equal}/{n}"}
    log(f"lm 12c: {json.dumps(report)}")
    return report


# -- 12d: behind the control plane


async def drive_lm_gateway(gateway: str, worker: str, procs: dict,
                           logs: dict, streams) -> dict:
    import aiohttp

    from ai4e_tpu_torch.taskstore import TaskStatus

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/lm/", procs["wk"], logs["wk"])
        boot_s = time.perf_counter() - t0

        async def one(prompt, max_new) -> tuple:
            t0 = time.perf_counter()
            async with http.post(gateway + LM_ROUTE,
                                 json={"prompt": prompt,
                                       "max_new_tokens": max_new}) as r:
                if r.status != 200:
                    raise AssertionError(f"{LM_ROUTE} {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            while True:
                async with http.get(
                        f"{gateway}/v1/taskmanagement/task/{task_id}",
                        params={"wait": "60"}) as r:
                    record = await r.json()
                if TaskStatus.canonical(record["Status"]) in \
                        TaskStatus.TERMINAL:
                    break
            t1 = time.perf_counter()
            result = await task_result(http, gateway, task_id)
            if record["Status"] != f"completed - {result['count']} tokens":
                raise AssertionError(f"task {task_id}: {record['Status']}")
            return t0, t1, task_id, result["tokens"]

        seq = [await one(p, n) for p, n in streams[:N_LM_SEQ]]
        runs = await asyncio.gather(*(one(p, n)
                                      for p, n in streams[N_LM_SEQ:]))
        ledgers = [await fetch_record(http, gateway, t)
                   for _, _, t, _ in seq + list(runs)]
        async with http.get(gateway + "/metrics") as r:
            cp_metrics = await r.text()
    latency = [(t1 - t0) * 1e3 for t0, t1, _, _ in runs]
    span = max(t1 for _, t1, _, _ in runs) - min(t0 for t0, _, _, _ in runs)
    return {"boot_s": boot_s, "tokens": [t for *_, t in seq + list(runs)],
            "task_ids": [t for _, _, t, _ in seq + list(runs)],
            "ledgers": ledgers, "cp_metrics": cp_metrics,
            "seq_ms": [(t1 - t0) * 1e3 for t0, t1, _, _ in seq],
            "task_p50_ms": statistics.median(latency),
            "task_p95_ms": pct(latency, 95),
            "tasks_per_s": len(runs) / span}


def dispatch_outcomes(metrics_text: str) -> dict:
    return family_outcomes(metrics_text, "ai4e_dispatch_total")


def phase_lm_control_plane(geo: dict, device: str = "cuda") -> dict:
    """12d: the port's control plane and an LM worker as child processes;
    this process is the client, through the gateway only."""
    import os

    out_dir = ROOT / "build" / "chip_smoke"
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    (out_dir / "lm_models.json").write_text(json.dumps(
        lm_worker_spec(geo, taskstore=gateway)))
    (out_dir / "lm_routes.json").write_text(json.dumps({"apis": [
        {"prefix": LM_ROUTE, "backend": worker + LM_BACKEND,
         "mode": "async", "concurrency": 8}]}))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY),
               AI4E_PLATFORM_OBSERVABILITY="1",
               AI4E_OBSERVABILITY_HOP_LEDGER="1", **lm_worker_env(geo))
    logs = {"cp": out_dir / "lm_control_plane.log",
            "wk": out_dir / "lm_worker.log"}
    streams = lm_streams(N_LM_SEQ + N_LM_ASYNC, SEED + 6, geo["vocab_size"])
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / "lm_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "lm_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             device], logs["wk"], env)
        out = asyncio.run(drive_lm_gateway(gateway, worker, procs, logs,
                                           streams))
        trace = trace_verb(["--task-id", out["task_ids"][0], "--url",
                            gateway], env)
        stop_child(procs["wk"], logs["wk"], "lm worker")
        stop_child(procs["cp"], logs["cp"], "lm control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    wk_log = logs["wk"].read_text(errors="replace")
    if f"on {device}, hop ledger ON, streaming decode ON (lm)" not in wk_log:
        raise AssertionError(f"the worker did not serve the LM on {device}:"
                             f"\n{wk_log[-4000:]}")
    outcomes = dispatch_outcomes(out["cp_metrics"])
    if outcomes.get("failed") or outcomes.get("dead_letter"):
        raise AssertionError(f"12d deliveries: {outcomes}")
    for record in out["ledgers"]:
        chunks = [e for e in record.get("Ledger") or [] if e["e"] == "chunk"]
        if len(chunks) != 1 or chunks[0]["h"] != "decode":
            raise AssertionError(f"task {record['TaskId']}: chunk stamps "
                                 f"{chunks}")
    if "chunk" not in trace:
        raise AssertionError(f"trace shows no chunk:\n{trace}")
    ttft = [next(e["ms"] for e in r["Ledger"] if e["e"] == "chunk")
            for r in out["ledgers"]]
    ref = lm_plain_greedy(lm_module(geo, SEED, device), streams,
                          geo["eos_id"], geo["max_len"])
    equal = sum(lm_agrees(got, want, gaps, f"12d task {i}")
                for i, (got, (want, gaps)) in enumerate(zip(out["tokens"],
                                                            ref)))
    report = {"card": CARD.get("smi"), "worker_boot_s": out["boot_s"],
              "sequential_ms": out["seq_ms"],
              "tasks": N_LM_ASYNC, "tasks_per_s": out["tasks_per_s"],
              "task_p50_ms": out["task_p50_ms"],
              "task_p95_ms": out["task_p95_ms"],
              "ledger_ttft_ms_p50": statistics.median(ttft),
              "ledger_ttft_ms_p95": pct(ttft, 95),
              "dispatch_outcomes": outcomes,
              "equal_all_the_way": f"{equal}/{len(streams)}"}
    log(f"lm 12d: {json.dumps(report)}")
    return report


def phase_lm(device: str = "cuda") -> dict:
    """Phase 12: the streaming LM at the deployed SeqFormer's widths."""
    geo = lm_geometry()
    t0 = time.perf_counter()
    report = {"card": CARD.get("smi"), "geometry": geo,
              "slots": LM_SLOTS, "prompt_buckets": LM_PROMPT_BUCKETS,
              **phase_lm_in_process(geo, device)}
    report["12c"] = phase_lm_worker(geo, device)
    report["12d"] = phase_lm_control_plane(geo, device)
    report["seconds"] = time.perf_counter() - t0
    log(f"lm: {json.dumps(report)}")
    return report


# -- phase 13: the compressed wires, and admission control -------------------

WIRE_MODELS = ("landcover", "megadetector", "species")
WIRES = ("rgb8", "yuv420", "dct")
#: 13b's wire per model, in a temporary copy of deploy/specs/models.json.
SERVED_WIRES = {"landcover": "yuv420", "species": "dct",
                "megadetector": "yuv420"}
WIRE_PIXEL_CHANGE = 0.05   # land cover: share of pixels whose class moves
N_WIRE_TILES = 64          # held-out land-cover tiles for 13a's gate
N_ENCODE = 20              # host encodes timed per (wire, size), median
ADMISSION_INITIAL = 8      # AI4E_PLATFORM_ADMISSION_INITIAL_LIMIT (default)
ADMISSION_BACKLOG = 16     # AI4E_PLATFORM_ADMISSION_MAX_BACKLOG in 13c
SHORT_DEADLINE_MS = 5      # under one land-cover replay; every 4th request
BURST_WAVES = 4            # 13c's burst, repeated: the limiter learns
PRIORITIES = ("interactive", "default", "background")


def wire_specs() -> dict[str, dict]:
    """deploy/specs/models.json's three image models, by name."""
    spec = json.loads((ROOT / "deploy/specs/models.json").read_text())
    return {m["name"]: m for m in spec["models"] if m["name"] in WIRE_MODELS}


def wire_servable(spec: dict, wire: str, out_dir: Path):
    """The spec's servable on ``wire``, named ``<model>_<wire>``, restored
    from the checkpoint directory."""
    from ai4e_tpu_torch.cli import restore_checkpoint
    from ai4e_tpu_torch.runtime.families import build_servable

    kwargs = {k: v for k, v in spec.items() if k not in (
        "family", "sync_path", "async_path", "checkpoint", "pipeline_to",
        "batch", "maximum_concurrent_requests")}
    servable = build_servable(spec["family"], **{
        **kwargs, "name": f"{spec['name']}_{wire}", "wire": wire})
    restore_checkpoint(servable, spec["checkpoint"], str(out_dir))
    return servable


def wire_encode(wire: str):
    """The host encoder of ``wire`` (rgb8: the pixels as they are)."""
    from ai4e_tpu_torch.ops import dct, yuv

    return {"rgb8": lambda x: x, "yuv420": yuv.rgb_to_yuv420,
            "dct": dct.rgb_to_dct}[wire]


def wire_batch(wire: str, images: np.ndarray) -> np.ndarray:
    encode = wire_encode(wire)
    return np.stack([encode(x) for x in images])


def wire_decode(wire: str, x: torch.Tensor, size: int) -> torch.Tensor:
    """The servable's first step on the card: the wire's decode, or the
    normalize kernel on rgb8."""
    from ai4e_tpu_torch.ops import dct, normalize_image, yuv

    if wire == "rgb8":
        return normalize_image(x)
    decode = yuv.yuv420_to_rgb if wire == "yuv420" else dct.dct_to_rgb
    return decode(x, size, size)


def host_encode_ms() -> dict:
    """Median ms of one host encode of a served tile per wire, size and
    encoder (the C++ build and numpy), on one core of the card's host."""
    from ai4e_tpu_torch.ops import dct, yuv

    rng = np.random.default_rng(SEED + 130)
    out = {}
    for size in (224, 256, 512):
        img = rng.integers(0, 256, (size, size, 3), np.uint8)
        for wire, fns in (("yuv420", (yuv.rgb_to_yuv420,
                                      yuv._rgb_to_yuv420_numpy)),
                          ("dct", (dct.rgb_to_dct, dct._rgb_to_dct_numpy))):
            for label, fn in zip(("cpp", "numpy"), fns):
                times = []
                for _ in range(N_ENCODE):
                    t0 = time.perf_counter()
                    fn(img)
                    times.append((time.perf_counter() - t0) * 1e3)
                out[f"{wire}/{size}/{label}"] = statistics.median(times)
    return out


def reset_launches() -> None:
    """Every kernel's launch counter to 0."""
    from ai4e_tpu_torch import ops

    ops.add_launches({k: -n for k, n in ops.launch_counts().items()})


def check_wire_replay(name: str, pixels: int, got, want) -> str:
    """A bucket's replay against eager on one wire payload, by the rules
    of phases 7a and 8b (cuDNN may choose another algorithm under
    capture)."""
    if isinstance(got, dict) and "counts" in got:
        if same_outputs(got, want):
            return "exact"
        diff = int(np.abs(got["counts"].astype(np.int64)
                          - want["counts"]).max())
        if diff > COUNT_TOLERANCE * pixels:
            raise AssertionError(f"{name}: replay counts off by {diff} px")
        return f"counts within {diff} px"
    return same_detector_or_species(name, got, want)


def phase_wires_in_process(out_dir: Path, device: str = "cuda") -> dict:
    """13a: land cover, megadetector and species at the deployed widths
    from phase 10's checkpoints, each on rgb8, yuv420 and dct, on one
    runtime: wire bytes, every bucket's replay against eager, the decode's
    own replay against its eager run (``torch.equal``), replay and decode
    ms, host encode ms, and the JAX tests' fidelity gates."""
    from ai4e_tpu_torch.ops import dct, yuv
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.train import make_checkpoints as mc

    encoders = {"yuv420": yuv.encoder(), "dct": dct.encoder()}
    if set(encoders.values()) != {"cpp"}:
        raise AssertionError(f"the C++ host encoders did not load: {encoders}")
    specs = wire_specs()
    runtime = ModelRuntime(device)
    for spec in specs.values():
        for wire in WIRES:
            runtime.register(wire_servable(spec, wire, out_dir))
    t0 = time.perf_counter()
    runtime.warmup()
    report: dict = {"card": CARD.get("smi"), "encoders": encoders,
                    "warmup_and_capture_s": time.perf_counter() - t0,
                    "wire_bytes": {}, "buckets": {}, "decode": {}}
    cuda = device == "cuda"
    rng = np.random.default_rng(SEED + 131)
    for model, spec in specs.items():
        size = spec.get("tile", spec.get("image_size"))
        for wire in WIRES:
            name = f"{model}_{wire}"
            servable = runtime.models[name]
            report["wire_bytes"][name] = int(
                np.prod(servable.input_shape)
                * np.dtype(servable.input_dtype).itemsize)
            for bucket in servable.batch_buckets:
                images = (scenes(bucket, SEED + bucket, size) if size == 512
                          else rng.integers(0, 256, (bucket, size, size, 3),
                                            np.uint8))
                x = wire_batch(wire, images)
                got = runtime.run_batch(name, x)
                dev = torch.from_numpy(x).to(device)
                with torch.inference_mode():
                    eager_out = servable.apply_fn(servable.module, dev)
                want = ({k: v.cpu().numpy() for k, v in eager_out.items()}
                        if isinstance(eager_out, dict)
                        else eager_out.cpu().numpy())
                row = {"replay_equals_eager": check_wire_replay(
                    f"{name}/{bucket}", size * size, got, want)}
                if cuda:
                    graph = runtime.graphs[(name, bucket)]
                    graph.static_in.copy_(dev)
                    row["replay_ms"] = stream_ms(graph.graph.replay)
                report["buckets"][f"{name}/{bucket}"] = row
            # The decode alone at the largest bucket: its graph against its
            # eager run bit for bit, and its time beside the replay's.
            bucket = servable.max_bucket
            dev = torch.from_numpy(wire_batch(wire, rng.integers(
                0, 256, (bucket, size, size, 3), np.uint8))).to(device)
            with torch.inference_mode():
                eager = wire_decode(wire, dev, size)
            row = {"bucket": bucket}
            if cuda:
                graph = torch.cuda.CUDAGraph()
                with torch.inference_mode(), torch.cuda.graph(graph):
                    captured = wire_decode(wire, dev, size)
                graph.replay()
                torch.cuda.synchronize()
                if wire != "rgb8" and not torch.equal(captured, eager):
                    raise AssertionError(f"{name}: the decode's replay "
                                         "differs from its eager run")
                row["graph_equals_eager"] = bool(torch.equal(captured,
                                                             eager))
                row["ms"] = stream_ms(graph.replay)
                replay = report["buckets"][f"{name}/{bucket}"]["replay_ms"]
                row["share_of_replay"] = row["ms"] / replay
                del graph, captured
            report["decode"][name] = row
    report["host_encode_ms"] = host_encode_ms()

    # The JAX tests' fidelity gates, on the trained weights; the launch
    # counters from 0 across these serving runs.
    reset_launches()
    before_models = {k: dict(v) for k, v in runtime.model_launches.items()}
    fidelity = {}
    lc = specs["landcover"]
    tiles, _ = mc.landcover_batch(np.random.default_rng(SEED + 1),
                                  N_WIRE_TILES, lc["tile"])
    tiles = uint8_images(tiles)
    classes = {}
    for wire in WIRES:
        servable = runtime.models[f"landcover_{wire}"]
        preds = []
        for i in range(0, N_WIRE_TILES, 16):
            x = torch.from_numpy(wire_batch(wire, tiles[i:i + 16])).to(device)
            with torch.inference_mode():
                preds.append(servable.module(wire_decode(wire, x, lc["tile"]))
                             .argmax(-1).cpu().numpy())
            runtime.run_batch(servable.name, x.cpu().numpy())
        classes[wire] = np.concatenate(preds)
    fidelity["landcover_pixels_changed"] = {
        wire: float((classes[wire] != classes["rgb8"]).mean())
        for wire in ("yuv420", "dct")}
    sp = specs["species"]
    img, labels = mc.species_batch(np.random.default_rng(42), 8,
                                   sp["image_size"])
    img = uint8_images(img)
    species = {w: np.asarray(runtime.run_batch(
        f"species_{w}", np.concatenate([wire_batch(w, img)] * 2))
        ).argmax(-1)[:8] for w in WIRES}
    fidelity["species_labels"] = {w: species[w].tolist() for w in WIRES}
    fidelity["species_true_labels"] = labels.tolist()
    md = specs["megadetector"]
    img, targets = mc.detector_batch(np.random.default_rng(5), 8,
                                     md["image_size"])
    img = uint8_images(img)
    hits, centres = {}, {}
    for wire in WIRES:
        out = runtime.run_batch(f"megadetector_{wire}", wire_batch(wire, img))
        hits[wire], total = mc.detection_accuracy(out, targets,
                                                  wh_rel_tolerance=0.5)
        centres[wire], _ = mc.detection_accuracy(out, targets)
    fidelity["megadetector_hits"] = {**hits, "objects": total}
    fidelity["megadetector_centres"] = centres
    report["fidelity"] = fidelity
    from ai4e_tpu_torch import ops
    report["launches"] = ops.launch_counts()
    report["launches_by_servable"] = {
        k: {kk: n - before_models.get(k, {}).get(kk, 0)
            for kk, n in v.items()}
        for k, v in runtime.model_launches.items()}
    del runtime
    if cuda:
        torch.cuda.empty_cache()
    log(f"wires 13a: {json.dumps(report)}")
    check_wire_fidelity(fidelity)
    return report


def check_wire_fidelity(fidelity: dict) -> None:
    """The JAX package's gates: land cover moves at most 5% of pixels on
    each wire, species keeps rgb8's labels on each wire, the megadetector
    finds at least rgb8's objects less one (box extents within 0.5) on
    yuv420, the wire 13b deploys it on. On dct the megadetector is held
    to rgb8's objects less one by centre and class; its box extents at
    512 px miss JAX's 0.5 tolerance on most of the port's trained
    checkpoints (``PERF.md``), so ``megadetector_hits["dct"]`` is printed,
    not gated."""
    for wire, share in fidelity["landcover_pixels_changed"].items():
        if share > WIRE_PIXEL_CHANGE:
            raise AssertionError(f"land cover on {wire}: {share:.4f} of "
                                 "pixels changed class against rgb8")
    labels = fidelity["species_labels"]
    for wire in ("yuv420", "dct"):
        if labels[wire] != labels["rgb8"]:
            raise AssertionError(f"species on {wire}: {labels[wire]} against "
                                 f"rgb8's {labels['rgb8']}")
    hits = fidelity["megadetector_hits"]
    if hits["yuv420"] < hits["rgb8"] - 1:
        raise AssertionError(f"megadetector on yuv420: {hits['yuv420']} "
                             f"objects against rgb8's {hits['rgb8']}")
    centres = fidelity["megadetector_centres"]
    if centres["dct"] < centres["rgb8"] - 1:
        raise AssertionError(f"megadetector on dct: {centres['dct']} "
                             f"objects found against rgb8's "
                             f"{centres['rgb8']}")


def wire_deploy_specs(gateway: str, worker: str,
                      wires: dict | None) -> tuple[dict, dict]:
    """Phase 10's deploy spec cut to the three image models and their
    routes, each model on ``wires[name]`` (None: rgb8 as written)."""
    models, routes = deploy_specs(gateway, worker)
    models["models"] = [dict(m, **({"wire": wires[m["name"]]} if wires
                                   else {}))
                        for m in models["models"] if m["name"] in WIRE_MODELS]
    keep = ("/v1/landcover/", "/v1/camera-trap/")
    routes["apis"] = [a for a in routes["apis"]
                      if a.get("prefix", "").startswith(keep)
                      or "classify-species-batch" in a["backend"]]
    return models, routes


@contextlib.contextmanager
def control_plane_and_worker(out_dir: Path, tag: str, models: dict,
                             routes: dict, env: dict, cp_port: int,
                             wk_port: int, device: str):
    """The port's control plane and worker as two child processes on the
    given specs (written beside the checkpoints); both stopped, and every
    process killed that did not stop, when the block ends."""
    (out_dir / f"{tag}_models.json").write_text(json.dumps(models))
    (out_dir / f"{tag}_routes.json").write_text(json.dumps(routes))
    logs = {"cp": out_dir / f"{tag}_control_plane.log",
            "wk": out_dir / f"{tag}_worker.log"}
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / f"{tag}_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / f"{tag}_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             device], logs["wk"], env)
        yield procs, logs
        stop_child(procs["wk"], logs["wk"], f"{tag} worker")
        stop_child(procs["cp"], logs["cp"], f"{tag} control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


async def drive_wire_deploy(gateway: str, worker: str, procs: dict,
                            logs: dict, work: dict) -> dict:
    """13b's client: land cover (4 sync, 64 async), species (64 async),
    the camera-trap scenes through detect-async, each task's stage and
    final results."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        out = {"worker_up_s": time.perf_counter() - t0}
        out["landcover"] = await drive_gateway(
            http, gateway, "/v1/landcover/classify", work["landcover"], 4,
            "completed - class_histogram", worker)
        out["species"] = await drive_gateway(
            http, gateway, "/v1/camera-trap/classify-species",
            work["species"], 0, "completed - class_id, label, confidence",
            worker)

        async def detect(body: bytes) -> tuple:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/camera-trap/detect-async",
                                 data=body, headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"detect-async {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            record = await await_terminal(http, gateway, task_id)
            return t0, time.perf_counter(), task_id, record

        runs = await asyncio.gather(*(detect(b) for b in work["scenes"]))
        out["detect"] = {"runs": runs, "stage": [], "final": []}
        for _, _, task_id, record in runs:
            final = await task_result(http, gateway, task_id)
            # Nothing detected: the detector completed the task itself, and
            # its result is the final one.
            out["detect"]["stage"].append(
                final if record["Status"] == "completed - detections" else
                await task_result(http, gateway, task_id, "megadetector"))
            out["detect"]["final"].append(final)
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
        async with http.get(worker + "/metrics") as r:
            out["wk_metrics"] = await r.text()
    return out


def check_handoffs(det: dict) -> int:
    """Every detect task completed under its one TaskId: the stage result
    readable there, the species stack's count the detections' (at most
    16), no item failed. Returns the tasks handed to species."""
    handed = 0
    for (_, _, task_id, record), stage, final in zip(
            det["runs"], det["stage"], det["final"]):
        n = min(16, len(stage["detections"]))
        if n == 0:
            if record["Status"] != "completed - detections":
                raise AssertionError(f"task {task_id}: {record}")
            continue
        if (record["TaskId"] != task_id
                or record["Status"] != f"completed - {n} images, 0 errors"
                or final["count"] != n or final["failed"]):
            raise AssertionError(f"task {task_id}: {record}, final "
                                 f"{final.get('count')} items, "
                                 f"{final.get('failed')} failed")
        handed += 1
    return handed


def phase_wires_served(handoff: dict, device: str = "cuda") -> dict:
    """13b: the three image models behind the port's control plane with
    land cover on yuv420, species on dct and megadetector on yuv420 (its
    crops handed to species decode on the host first); the served
    land-cover histograms against the rgb8 servable's in this process (the
    served rgb8 turn was cut for the script's time limit)."""
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.train import make_checkpoints as mc

    out_dir = handoff["out_dir"]
    specs = wire_specs()
    tile = specs["landcover"]["tile"]
    sp_img, _ = mc.species_batch(np.random.default_rng(SEED + 1),
                                 N_DEPLOY_ASYNC, specs["species"]["image_size"])
    work = {"landcover": handoff["landcover"][0],
            "species": [npy_bytes(x) for x in uint8_images(sp_img)],
            "scenes": handoff["scenes"]}
    report: dict = {"card": CARD.get("smi"), "wires": SERVED_WIRES,
                    "wire": []}
    histograms: dict = {"wire": []}
    turn, tag, wires = 0, "wire", SERVED_WIRES
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = wire_deploy_specs(gateway, worker, wires)
    with control_plane_and_worker(out_dir, f"wires_{turn}_{tag}", models,
                                  routes, handoff["env"], cp_port,
                                  wk_port, device) as (procs, logs):
        out = asyncio.run(drive_wire_deploy(gateway, worker, procs, logs,
                                            work))
    wk_log = logs["wk"].read_text(errors="replace")
    if f"on {device}" not in wk_log:
        raise AssertionError(f"the {tag} worker did not serve on "
                             f"{device}:\n{wk_log[-4000:]}")
    failed = sum(metric_sum(out["cp_metrics"], "ai4e_dispatch_total",
                            outcome=o)
                 for o in ("failed", "dead_letter", "expired"))
    if failed:
        raise AssertionError(f"{tag}: {failed} deliveries failed")
    handed = check_handoffs(out["detect"])
    by_model = launches_by_model(wk_log)
    latency = sorted((t1 - t0) * 1e3 for t0, t1, _, _
                     in out["detect"]["runs"])
    histograms[tag].append([r["class_histogram"] for r in
                            out["landcover"]["results"]])
    report[tag].append({
        "turn": turn, "worker_up_s": out["worker_up_s"],
        "landcover_tiles_per_s": out["landcover"]["async_requests_per_s"],
        "landcover_task_p50_ms": out["landcover"]["task_p50_ms"],
        "landcover_task_p95_ms": out["landcover"]["task_p95_ms"],
        "landcover_sync_p50_ms": out["landcover"]["sync_p50_ms"],
        "species_per_s": out["species"]["async_requests_per_s"],
        "species_task_p50_ms": out["species"]["task_p50_ms"],
        "species_task_p95_ms": out["species"]["task_p95_ms"],
        "detect_task_p50_ms": statistics.median(latency),
        "detect_task_p95_ms": float(np.percentile(latency, 95)),
        "tasks_handed_to_species": handed,
        "failed_deliveries": failed,
        "redeliveries_503": metric_sum(out["cp_metrics"],
                                       "ai4e_dispatch_total",
                                       outcome="backpressure"),
        "h2d_bytes": metric_sum(out["wk_metrics"],
                                "ai4e_batch_h2d_bytes_total"),
        "launches_by_model": by_model})
    if tag == "wire" and device == "cuda":
        if by_model.get("landcover", {}).get(
                "fused_seg_postprocess", 0) < 1:
            raise AssertionError(f"argmax never launched on the wire "
                                 f"path: {by_model}")
        if any(v.get("normalize_image") for v in by_model.values()):
            raise AssertionError(f"normalize launched on a wire path "
                                 f"(the decode replaces it): {by_model}")
    # The served land-cover histograms on the wire against the rgb8
    # servable's on the same tiles: within the wire's noise.
    ref_rt = ModelRuntime(device)
    ref = ref_rt.register(wire_servable(specs["landcover"], "rgb8", out_dir))
    tiles = np.stack([decode_npy(b) for b in work["landcover"]])
    want = np.concatenate([
        np.asarray(ref_rt.run_batch(ref.name, tiles[i:i + ref.max_bucket])
                   ["counts"]) for i in range(0, len(tiles), ref.max_bucket)])
    del ref, ref_rt
    moved = [sum(abs(int(a.get(str(c), a.get(c, 0))) - int(row[c]))
                 for c in range(len(row))) / 2 / tile ** 2
             for wire_run in histograms["wire"]
             for a, row in zip(wire_run, want)]
    report["landcover_histogram_moved_max"] = max(moved)
    if max(moved) > WIRE_PIXEL_CHANGE:
        raise AssertionError(f"served land cover moved {max(moved)} of a "
                             "tile's pixels on yuv420")
    log(f"wires 13b: {json.dumps(report)}")
    return report


async def admission_burst(gateway: str, bodies: list[bytes]) -> dict:
    """``BURST_WAVES`` waves, each 4x the initial limit at once through the
    sync route and as many through the async route, priorities in turn,
    every 4th with a deadline under one replay (the rest 60 s); the
    limiter's limit sampled from /metrics meanwhile; each async task
    awaited to its terminal status before the next wave."""
    import aiohttp

    n = 4 * ADMISSION_INITIAL

    def headers(i: int) -> dict:
        return {**OCTET, "X-Priority": PRIORITIES[i % 3],
                "X-Deadline-Ms": str(SHORT_DEADLINE_MS if i % 4 == 3
                                     else 60000)}

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=300)) as http:
        samples, stop = [], asyncio.Event()

        async def sample() -> None:
            t0 = time.perf_counter()
            while not stop.is_set():
                async with http.get(gateway + "/metrics") as r:
                    text = await r.text()
                samples.append((round(time.perf_counter() - t0, 3),
                                metric_sum(text, "ai4e_admission_limit",
                                           scope="gateway_sync")))
                await asyncio.sleep(0.02)

        async def sync(i: int) -> dict:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/landcover/classify",
                                 data=bodies[i % len(bodies)],
                                 headers=headers(i)) as r:
                body = await r.read()
                return {"i": i, "status": r.status,
                        "text": body.decode(errors="replace")
                        if r.status != 200 else "",
                        "retry_after": r.headers.get("Retry-After"),
                        "reason": r.headers.get("X-Shed-Reason"),
                        "ms": (time.perf_counter() - t0) * 1e3}

        async def task(i: int) -> dict:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/landcover/classify-async",
                                 data=bodies[i % len(bodies)],
                                 headers=headers(i)) as r:
                out = {"i": i, "status": r.status,
                       "retry_after": r.headers.get("Retry-After"),
                       "reason": r.headers.get("X-Shed-Reason")}
                if r.status != 200:
                    return out
                task_id = (await r.json())["TaskId"]
            record = await await_terminal(http, gateway, task_id)
            return {**out, "task_id": task_id, "final": record["Status"],
                    "ms": (time.perf_counter() - t0) * 1e3}

        sampler = asyncio.create_task(sample())
        t0 = time.perf_counter()
        syncs, tasks = [], []
        for wave in range(BURST_WAVES):
            ids = range(wave * n, (wave + 1) * n)
            results = await asyncio.gather(*(sync(i) for i in ids),
                                           *(task(i) for i in ids))
            syncs += results[:n]
            tasks += results[n:]
        span = time.perf_counter() - t0
        stop.set()
        await sampler
        async with http.get(gateway + "/metrics") as r:
            cp_metrics = await r.text()
    return {"sync": syncs, "async": tasks, "span_s": span,
            "limit_samples": samples, "cp_metrics": cp_metrics}


def burst_summary(burst: dict, wk_metrics: tuple[str, str]) -> dict:
    """Counts of a burst: answers by status, sheds by class, expiries by
    hop (client, control plane and worker), goodput, the limit's path."""
    sync, tasks = burst["sync"], burst["async"]
    cp = burst["cp_metrics"]

    def deadline_ms(i: int) -> float:
        return SHORT_DEADLINE_MS if i % 4 == 3 else 60000.0

    # Pressure sheds by class (a deadline-feasibility shed refuses a
    # request for its own budget, whatever its class).
    shed = {p: 0 for p in PRIORITIES}
    for r in sync + tasks:
        if r["status"] in (429, 503) and "pressure" in (r["reason"] or ""):
            shed[PRIORITIES[r["i"] % 3]] += 1
    good = sum(1 for r in sync if r["status"] == 200
               and r["ms"] <= deadline_ms(r["i"]))
    good += sum(1 for r in tasks if r.get("final", "").startswith(
        "completed") and r["ms"] <= deadline_ms(r["i"]))
    hops = ("gateway", "gateway_sync", "dispatcher")
    return {
        "sync_status": {s: sum(r["status"] == s for r in sync)
                        for s in sorted({r["status"] for r in sync})},
        "async_submit_status": {s: sum(r["status"] == s for r in tasks)
                                for s in sorted({r["status"]
                                                 for r in tasks})},
        "async_final": {f: sum(r.get("final") == f for r in tasks)
                        for f in sorted({r["final"] for r in tasks
                                         if "final" in r})},
        "refusals_retry_after": sorted(
            {r["retry_after"] for r in sync + tasks
             if r["status"] in (429, 503) and r["retry_after"]}),
        "shed_reasons": sorted({r["reason"] for r in sync + tasks
                                if r["reason"]}),
        "shed_by_priority": shed,
        "expired_by_hop": {
            **{h: metric_sum(cp, "ai4e_admission_expired_total", hop=h)
               for h in hops},
            **{h: metric_delta(wk_metrics, "ai4e_admission_expired_total",
                               hop=h) for h in ("worker", "batcher")}},
        "goodput_per_s": good / burst["span_s"], "in_deadline": good,
        "span_s": burst["span_s"],
        "limit_path": [v for k, (_, v) in enumerate(burst["limit_samples"])
                       if k == 0 or v != burst["limit_samples"][k - 1][1]],
        "limit_samples": burst["limit_samples"][::10]}


async def admission_run(gateway: str, worker: str, procs: dict, logs: dict,
                        bodies: list[bytes]) -> dict:
    import aiohttp

    async with aiohttp.ClientSession() as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        async with http.get(worker + "/metrics") as r:
            before = await r.text()
    burst = await admission_burst(gateway, bodies)
    async with aiohttp.ClientSession() as http:
        async with http.get(worker + "/metrics") as r:
            after = await r.text()
    return {"burst": burst, "wk_metrics": (before, after)}


def check_admission(run: dict, summary: dict) -> dict:
    """13c's gates: every admitted task terminal (none lost); no expired
    example on the card (the batcher's drops plus the rows the card ran
    equal the examples that entered the batcher); background shed before
    interactive."""
    burst = run["burst"]
    lost = [r for r in burst["async"] if r["status"] == 200
            and "final" not in r]
    if lost:
        raise AssertionError(f"{len(lost)} admitted tasks never ended")
    from ai4e_tpu_torch.taskstore import TaskStatus
    for r in burst["async"]:
        if (r["status"] == 200 and TaskStatus.canonical(r["final"])
                not in (TaskStatus.COMPLETED, TaskStatus.EXPIRED)):
            raise AssertionError(f"task {r['task_id']}: {r['final']}")
    rows = metric_delta(run["wk_metrics"], "ai4e_batch_size_sum",
                        model="landcover")
    ran = (sum(r["status"] == 200 for r in burst["sync"])
           + sum(r.get("final", "").startswith("completed")
                 for r in burst["async"]))
    # The proxy answers with the worker's status and body (not its
    # headers): the batcher's 504 says "while queued".
    at_batcher = (sum(r["status"] == 504 and "while queued" in r["text"]
                      for r in burst["sync"])
                  + sum(r.get("final", "").endswith("at batcher")
                        for r in burst["async"]))
    dropped = summary["expired_by_hop"]["batcher"]
    if rows != ran or dropped != at_batcher:
        raise AssertionError(f"the card ran {rows} rows for {ran} answers; "
                             f"the batcher dropped {dropped} for "
                             f"{at_batcher} answered expired there")
    shed = summary["shed_by_priority"]
    if not shed["background"] > shed["interactive"]:
        raise AssertionError(f"background was not shed before interactive "
                             f"work: {shed}")
    return {"device_rows": rows, "entered_batcher": ran + at_batcher,
            "batcher_drops": dropped}


def phase_admission(handoff: dict, device: str = "cuda") -> dict:
    """13c: land cover behind the control plane with
    ``AI4E_PLATFORM_ADMISSION=1`` (and a backlog of 16 for the async
    edge); the turn with admission off was cut for the script's time
    limit."""
    out_dir = handoff["out_dir"]
    bodies = handoff["landcover"][0][:16]
    report: dict = {"card": CARD.get("smi"),
                    "initial_limit": ADMISSION_INITIAL,
                    "max_backlog": ADMISSION_BACKLOG,
                    "burst": 4 * ADMISSION_INITIAL, "waves": BURST_WAVES,
                    "short_deadline_ms": SHORT_DEADLINE_MS}
    tag, extra = "on", {"AI4E_PLATFORM_ADMISSION": "1",
                        "AI4E_PLATFORM_ADMISSION_MAX_BACKLOG":
                            str(ADMISSION_BACKLOG)}
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = wire_deploy_specs(gateway, worker, None)
    models["models"] = [m for m in models["models"]
                        if m["name"] == "landcover"]
    routes["apis"] = [a for a in routes["apis"]
                      if a.get("prefix", "").startswith("/v1/landcover/")]
    with control_plane_and_worker(
            out_dir, f"admission_{tag}", models, routes,
            {**handoff["env"], **extra}, cp_port, wk_port,
            device) as (procs, logs):
        run = asyncio.run(admission_run(gateway, worker, procs, logs,
                                        bodies))
    summary = burst_summary(run["burst"], run["wk_metrics"])
    cp_log = logs["cp"].read_text(errors="replace")
    if "admission control ON" not in cp_log:
        raise AssertionError(f"admission {tag}: the startup line says "
                             f"otherwise:\n{cp_log[-2000:]}")
    summary["gates"] = check_admission(run, summary)
    report[tag] = summary
    log(f"wires 13c: {json.dumps(report)}")
    return report


def phase_wires(handoff: dict, kernels: list[dict],
                device: str = "cuda") -> dict:
    """Phase 13: the compressed wires in process (a) and behind the control
    plane (b), then admission control (c)."""
    import gc

    log("wires: yuv420 and dct for the image models, then admission")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report = {"13a": phase_wires_in_process(handoff["out_dir"], device),
              "13b": phase_wires_served(handoff, device),
              "13c": phase_admission(handoff, device)}
    report["seconds"] = time.perf_counter() - t0
    rows = {k["name"]: k for k in kernels}
    if "fused_seg_postprocess" in rows:
        rows["fused_seg_postprocess"]["launches_wire_paths"] = {
            "13a": {w: report["13a"]["launches_by_servable"].get(
                f"landcover_{w}", {}).get("fused_seg_postprocess", 0)
                for w in WIRES},
            "13b_landcover_yuv420": [
                run["launches_by_model"]["landcover"]["fused_seg_postprocess"]
                for run in report["13b"]["wire"]]}
    log(f"wires: {json.dumps({k: report[k] for k in ('seconds',)})}")
    return report


# -- phase 14: subscription keys, rate limits and quotas; the result cache ---

KEYS = ("k-open", "k-rate", "k-quota")
RATE_RPS, RATE_BURST = 20.0, 10.0  # AI4E_GATEWAY_RATE_LIMITS=k-rate=20:10
QUOTA_REQUESTS = 16                # AI4E_GATEWAY_QUOTAS=k-quota=16/3600
N_KEY_BURST = 64      # 14a: land-cover async requests sent at once a key
N_BAD_KEY = 4         # 14a: requests of each route without a key, and wrong
ADMIN_KEY = "k-admin"  # 14c: the in-process worker's admin key
N_CACHE_TILES = 8     # 14b/14c: distinct land-cover tiles and moe sequences
N_CACHE_COPIES = 8    # 14b: copies of each in one wave
N_HASH = 50           # request_key timings a body size, median taken
N_SYNC_HIT_ROUNDS = 4  # 14b: sync rounds of 16 hits after the first round
N_AFTER_RELOAD = 16   # 14c: requests the straddling burst sends after the 200
STRADDLE_GAP_S = 0.01  # 14c: between the burst's requests
LC_ASYNC, LC_SYNC = "/v1/landcover/classify-async", "/v1/landcover/classify"
MOE_ASYNC = "/v1/moe/route-async"
CACHE_MODELS = ("landcover", "moe")


def keyed(key: str | None) -> dict:
    return {"Ocp-Apim-Subscription-Key": key} if key else {}


def cache_specs(gateway: str, worker: str,
                names: tuple[str, ...]) -> tuple[dict, dict]:
    """Phase 10's deploy spec cut to ``names`` and their public routes."""
    models, routes = deploy_specs(gateway, worker)
    models["models"] = [m for m in models["models"] if m["name"] in names]
    prefixes = tuple(f"/v1/{n}/" for n in names)
    routes["apis"] = [a for a in routes["apis"]
                      if a.get("prefix", "").startswith(prefixes)]
    return models, routes


async def result_bytes(http, gateway: str, task_id: str,
                       headers: dict | None = None) -> bytes:
    async with http.get(gateway + "/v1/taskstore/result",
                        params={"taskId": task_id}, headers=headers) as r:
        if r.status != 200:
            raise AssertionError(f"result of {task_id}: {r.status}")
        return await r.read()


def class_counts(body: bytes, num_classes: int) -> np.ndarray:
    counts = np.zeros(num_classes, np.int64)
    for cls, n in json.loads(body)["class_histogram"].items():
        counts[int(cls)] = n
    return counts


def pcts(values: list[float]) -> dict:
    return ({"n": len(values), "p50_ms": pct(values, 50),
             "p95_ms": pct(values, 95)} if values else {"n": 0})


async def keys_run(gateway: str, worker: str, procs: dict, logs: dict,
                   bodies: list[bytes]) -> dict:
    """14a's client: requests without a key and with a wrong one, then a
    burst of ``N_KEY_BURST`` land-cover tasks under each key in turn, each
    admitted task polled and fetched under ``k-open``, the worker's rows
    read before and after each burst; then the worker's admin verbs with
    no key, a wrong one and a right one."""
    import aiohttp

    out: dict = {"refused": [], "keys": {}}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        for headers in ({}, keyed("k-wrong")):
            for i in range(N_BAD_KEY):
                for method, path in (("POST", LC_ASYNC), ("POST", LC_SYNC),
                                     ("GET", "/v1/taskmanagement/task/x")):
                    async with http.request(
                            method, gateway + path, headers={**OCTET,
                                                             **headers},
                            data=bodies[i] if method == "POST" else None) as r:
                        out["refused"].append(r.status)
        for key in KEYS:
            async with http.get(worker + "/metrics") as r:
                before = await r.text()
            t0 = time.perf_counter()

            async def submit(i: int, key: str = key) -> dict:
                async with http.post(gateway + LC_ASYNC,
                                     data=bodies[i % len(bodies)],
                                     headers={**OCTET, **keyed(key)}) as r:
                    answer = {"status": r.status,
                              "retry_after": r.headers.get("Retry-After"),
                              "s": time.perf_counter() - t0}
                    if r.status == 200:
                        answer["task_id"] = (await r.json())["TaskId"]
                    return answer

            answers = await asyncio.gather(*(submit(i)
                                             for i in range(N_KEY_BURST)))
            ids = [a["task_id"] for a in answers if "task_id" in a]
            records = await asyncio.gather(*(
                await_terminal(http, gateway, t, keyed("k-open"))
                for t in ids))
            for t in ids:
                await result_bytes(http, gateway, t, keyed("k-open"))
            async with http.get(worker + "/metrics") as r:
                after = await r.text()
            out["keys"][key] = {
                "answers": answers, "span_s": max(a["s"] for a in answers),
                "finals": [rec["Status"] for rec in records],
                "wk_metrics": (before, after)}
        out["admin"] = {}
        for verb, path, body in (
                ("reload", "/v1/models/models/landcover/reload", {}),
                ("drain", "/v1/models/worker/drain", {}),
                ("resume", "/v1/models/worker/resume", {})):
            codes = []
            for headers in ({}, keyed("k-wrong"), keyed("k-quota")):
                async with http.post(worker + path, json=body,
                                     headers=headers) as r:
                    codes.append(r.status)
            out["admin"][verb] = codes
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
    return out


def replay_launches(log_text: str, model: str) -> dict:
    """The kernel launches one replay of each of ``model``'s captured
    buckets makes, from the worker's capture log lines."""
    import ast

    marker = f"captured {model} bucket "
    out = {}
    for line in log_text.splitlines():
        if marker in line:
            rest = line.split(marker, 1)[1]
            bucket = int(rest.split(" ", 1)[0])
            out[bucket] = ast.literal_eval(
                rest.split("kernel launches a replay: ", 1)[1].rstrip(")"))
    if not out:
        raise AssertionError(f"the worker logged no {model} capture")
    return out


def check_keys(run: dict, wk_log: str, device: str) -> dict:
    """14a's gates and per-key report. The worker is a child process, so
    its launch counter is read once, at its exit; a key's share is its
    batches (counted around its burst) times one replay's launches (the
    same for every land-cover bucket, from the worker's capture lines),
    and the shares must sum to the worker's own count."""
    refused = run["refused"]
    if set(refused) != {401}:
        raise AssertionError(f"without a valid key: {refused}")
    per_batch = {}
    if device == "cuda":
        per_replay = replay_launches(wk_log, "landcover")
        if len({json.dumps(v, sort_keys=True)
                for v in per_replay.values()}) != 1:
            raise AssertionError(f"buckets launch differently: {per_replay}")
        per_batch = next(iter(per_replay.values()))
    report = {}
    for key, burst in run["keys"].items():
        answers = burst["answers"]
        status = {s: sum(a["status"] == s for a in answers)
                  for s in sorted({a["status"] for a in answers})}
        admitted = status.get(200, 0)
        texts = burst["wk_metrics"]
        rows = metric_delta(texts, "ai4e_batch_size_sum", model="landcover")
        batches = metric_delta(texts, "ai4e_batch_size_count",
                               model="landcover")
        report[key] = {
            "status": status, "tasks_created": admitted,
            "retry_after": sorted({a["retry_after"] for a in answers
                                   if a["retry_after"]}, key=int),
            "burst_span_s": burst["span_s"], "rows_on_card": rows,
            "batches": batches,
            "kernel_launches_from_batches": {k: n * batches
                                             for k, n in per_batch.items()}}
        if any(not f.startswith("completed") for f in burst["finals"]):
            raise AssertionError(f"{key}: {burst['finals']}")
        if rows != admitted:
            raise AssertionError(f"{key}: {rows} rows on the card for "
                                 f"{admitted} admitted")
    if report["k-open"]["status"] != {200: N_KEY_BURST}:
        raise AssertionError(f"k-open refused: {report['k-open']}")
    rate = report["k-rate"]
    most = RATE_BURST + RATE_RPS * rate["burst_span_s"] + 1
    if not (set(rate["status"]) <= {200, 429}
            and rate["tasks_created"] <= most and 429 in rate["status"]):
        raise AssertionError(f"k-rate admitted {rate['status']}, at most "
                             f"{most:.1f}")
    quota = report["k-quota"]
    if quota["status"] != {200: QUOTA_REQUESTS,
                           403: N_KEY_BURST - QUOTA_REQUESTS}:
        raise AssertionError(f"k-quota: {quota['status']}")
    if not all(3500 <= int(v) <= 3600 for v in quota["retry_after"]):
        raise AssertionError(f"k-quota Retry-After: {quota['retry_after']}")
    # The worker's store calls carried k-open: every 401 the control plane
    # counted is one of this process's.
    unauthorized = metric_sum(run["cp_metrics"],
                              "ai4e_gateway_requests_total",
                              route="unauthorized")
    if unauthorized != len(refused):
        raise AssertionError(f"{unauthorized} refusals counted for "
                             f"{len(refused)} sent without a valid key")
    for verb, codes in run["admin"].items():
        if codes != [401, 401, 200]:
            raise AssertionError(f"worker {verb}: {codes}")
    served = launches_by_model(wk_log).get("landcover", {})
    summed = {k: sum(r["kernel_launches_from_batches"][k]
                     for r in report.values()) for k in per_batch}
    if summed != {k: served.get(k, 0) for k in per_batch}:
        raise AssertionError(f"launches by key {summed} against the "
                             f"worker's {served}")
    return {"by_key": report, "refused_401": len(refused),
            "admin": run["admin"], "launches_while_serving": served}


def phase_keys(handoff: dict, device: str = "cuda") -> dict:
    """14a: the control plane with subscription keys, a rate limit and a
    quota, its worker keyed to its task store, as two child processes."""
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = cache_specs(gateway, worker, ("landcover",))
    env = {**handoff["env"],
           "AI4E_GATEWAY_API_KEYS": ",".join(KEYS),
           "AI4E_GATEWAY_RATE_LIMITS":
               f"k-rate={RATE_RPS:g}:{RATE_BURST:g}",
           "AI4E_GATEWAY_QUOTAS": f"k-quota={QUOTA_REQUESTS}/3600",
           "AI4E_SERVICE_TASKSTORE_API_KEY": "k-open"}
    bodies = handoff["landcover"][0][:16]
    with control_plane_and_worker(out_dir, "keys", models, routes, env,
                                  cp_port, wk_port, device) as (procs, logs):
        run = asyncio.run(keys_run(gateway, worker, procs, logs, bodies))
    report = check_keys(run, logs["wk"].read_text(errors="replace"),
                        device)
    log(f"cache 14a: {json.dumps({'card': CARD.get('smi'), **report})}")
    return report


def hash_ms() -> dict:
    """The gateway's ``request_key`` on a land-cover tile's body (256 px)
    and a megadetector scene's (512 px), on this host's CPU."""
    from ai4e_tpu_torch.rescache import request_key

    out = {}
    for size in (256, 512):
        body = npy_bytes(np.random.default_rng(SEED).integers(
            0, 256, (size, size, 3), np.uint8))
        times = []
        for _ in range(N_HASH):
            t0 = time.perf_counter()
            request_key("/v1/models/classify-async", body,
                        "application/octet-stream")
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"{size}px"] = {"bytes": len(body),
                            "ms": statistics.median(times)}
    return out


@contextlib.contextmanager
def gc_pauses(out: dict):
    """Record this process's garbage-collector pauses while the block runs
    into ``out``: collections, their total and longest ms, and how many
    were of the oldest generation (the client and an in-process worker
    share them)."""
    import gc

    pauses: list[list] = []

    def on_gc(phase: str, info: dict) -> None:
        if phase == "start":
            pauses.append([info["generation"], -time.perf_counter()])
        elif pauses:
            pauses[-1][1] += time.perf_counter()

    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)
        ms = [p[1] * 1e3 for p in pauses if p[1] > 0]
        out.update(n=len(ms), ms=sum(ms), max_ms=max(ms, default=0.0),
                   gen2=sum(p[0] == 2 for p in pauses))


@contextlib.asynccontextmanager
async def loop_stalls(out: dict):
    """Record into ``out`` how long this process's event loop went without
    running a 1 ms ticker while the block ran: the longest gap past the
    tick and the gaps over 50 ms (a GC pause, or a thread holding the
    GIL, shows here)."""
    gaps: list[float] = []

    async def tick() -> None:
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(0.001)
            gaps.append((time.perf_counter() - t0 - 0.001) * 1e3)

    ticker = asyncio.create_task(tick())
    try:
        yield
    finally:
        ticker.cancel()
        out.update(max_ms=max(gaps, default=0.0),
                   over_50ms=sum(g > 50 for g in gaps))


def worker_counts(worker) -> dict:
    """Rows each model ran and each kernel's launches so far, in this
    process."""
    from ai4e_tpu_torch import ops

    text = worker.service.metrics.render_prometheus()
    return {"rows": {m: metric_sum(text, "ai4e_batch_size_sum", model=m)
                     for m in CACHE_MODELS},
            "launches": dict(ops.launch_counts())}


def counts_delta(before: dict, after: dict) -> dict:
    return {part: {k: after[part][k] - before[part].get(k, 0)
                   for k in after[part]} for part in after}


async def cache_wave(http, gateway: str, work: list[tuple],
                     headers: dict | None = None) -> list[dict]:
    """Every ``(model, route, tile, body)`` of ``work`` posted at once, each
    task long-polled to its end and its result fetched."""
    async def one(model: str, route: str, i: int, body: bytes) -> dict:
        t0 = time.perf_counter()
        async with http.post(gateway + route, data=body,
                             headers={**OCTET, **(headers or {})}) as r:
            if r.status != 200:
                raise AssertionError(f"{route}: {r.status} {await r.text()}")
            xcache = r.headers.get("X-Cache")
            task_id = (await r.json())["TaskId"]
        record = await await_terminal(http, gateway, task_id)
        ms = (time.perf_counter() - t0) * 1e3
        return {"model": model, "i": i, "x": xcache, "task_id": task_id,
                "status": record["Status"], "ms": ms,
                "result": await result_bytes(http, gateway, task_id)}

    return list(await asyncio.gather(*(one(*w) for w in work)))


async def sync_round(http, gateway: str, bodies: list[bytes]) -> list[dict]:
    """Each body posted twice, all at once, to the land-cover sync route."""
    async def one(i: int) -> dict:
        t0 = time.perf_counter()
        async with http.post(gateway + LC_SYNC, data=bodies[i % len(bodies)],
                             headers=OCTET) as r:
            if r.status != 200:
                raise AssertionError(f"sync {r.status}: {await r.text()}")
            return {"i": i % len(bodies), "x": r.headers.get("X-Cache"),
                    "body": await r.read(),
                    "ms": (time.perf_counter() - t0) * 1e3}

    return list(await asyncio.gather(*(one(i)
                                       for i in range(2 * len(bodies)))))


async def cache_run(gateway: str, cp, cp_log: Path, worker, batcher,
                    wk_port: int, bodies: dict) -> dict:
    """14b's client, with the worker served from this process: waves 1-3
    and the two sync rounds, the worker's rows and this process's kernel
    launches read around each."""
    import aiohttp

    work = [(m, route, i, bodies[m][i]) for _ in range(N_CACHE_COPIES)
            for i in range(N_CACHE_TILES)
            for m, route in (("landcover", LC_ASYNC), ("moe", MOE_ASYNC))]
    out: dict = {}
    async with serving(worker, batcher, wk_port):
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0),
                timeout=aiohttp.ClientTimeout(total=600)) as http:
            await wait_healthy(http, gateway + "/healthz", cp, cp_log)
            async def timed(name: str, round_) -> None:
                before, gcs, stalls = worker_counts(worker), {}, {}
                t0 = time.perf_counter()
                with gc_pauses(gcs):
                    async with loop_stalls(stalls):
                        answers = await round_
                out[name] = {"answers": answers,
                             "s": time.perf_counter() - t0, "client_gc": gcs,
                             "loop_stalls": stalls,
                             "counts": counts_delta(before,
                                                    worker_counts(worker))}

            for name, headers in (("wave1", None), ("wave2", None),
                                  ("wave3", {"X-Cache-Bypass": "1"})):
                await timed(name, cache_wave(http, gateway, work, headers))
            tiles = bodies["landcover"][:N_CACHE_TILES]
            for n in range(1 + N_SYNC_HIT_ROUNDS):
                await timed(f"sync{n + 1}", sync_round(http, gateway, tiles))

            async def with_full_collection() -> list[dict]:
                # A hit round with a full collection of this process's
                # heap started once its requests are out: what a pause of
                # the client's process alone does to a hit's time.
                import gc

                round_ = asyncio.ensure_future(
                    sync_round(http, gateway, tiles))
                await asyncio.sleep(0.002)
                t0 = time.perf_counter()
                gc.collect()
                out["full_collection_ms"] = (time.perf_counter() - t0) * 1e3
                return await round_

            await timed("sync_collected", with_full_collection())
            async with http.get(gateway + "/metrics") as r:
                out["cp_metrics"] = await r.text()
    return out


def check_cache(run: dict, device: str) -> dict:
    """14b's gates and report."""
    per = N_CACHE_TILES * N_CACHE_COPIES
    report: dict = {"waves": {}}
    executed: dict = {}
    for answer in run["wave1"]["answers"]:
        if answer["x"] == "miss":
            executed.setdefault(answer["model"], {})[answer["i"]] = \
                answer["result"]
    for name in ("wave1", "wave2", "wave3"):
        wave = run[name]
        answers = wave["answers"]
        bad = [a for a in answers if not a["status"].startswith("completed")]
        if bad:
            raise AssertionError(f"{name}: {bad[0]['status']}")
        outcomes = {m: {x: sum(a["x"] == x for a in answers
                               if a["model"] == m)
                        for x in sorted({a["x"] for a in answers
                                         if a["model"] == m})}
                    for m in CACHE_MODELS}
        report["waves"][name] = {
            "x_cache": outcomes, "s": wave["s"], **wave["counts"],
            "client_gc": wave["client_gc"], "loop_stalls": wave["loop_stalls"],
            "task_ms": {x: pcts([a["ms"] for a in answers if a["x"] == x])
                        for x in sorted({a["x"] for a in answers})}}
        rows = wave["counts"]["rows"]
        launches = wave["counts"]["launches"]
        if name == "wave1":
            for m in CACHE_MODELS:
                if (rows[m] != N_CACHE_TILES
                        or outcomes[m].get("miss") != N_CACHE_TILES
                        or set(outcomes[m]) - {"miss", "coalesced", "hit"}):
                    raise AssertionError(f"wave 1 {m}: {outcomes[m]}, "
                                         f"{rows[m]} rows")
        elif name == "wave2":
            if (any(set(o) != {"hit"} for o in outcomes.values())
                    or any(rows.values()) or any(launches.values())):
                raise AssertionError(f"wave 2: {outcomes}, {rows}, "
                                     f"{launches}")
        else:
            if (any(set(o) != {"bypass"} for o in outcomes.values())
                    or any(rows[m] != per for m in CACHE_MODELS)):
                raise AssertionError(f"wave 3: {outcomes}, {rows}")
            if device == "cuda" and not all(
                    launches[k] > 0 for k in ("normalize_image",
                                              "fused_seg_postprocess",
                                              "flash_attention")):
                raise AssertionError(f"wave 3 launched {launches}")
        if name != "wave3":
            for a in answers:
                if a["result"] != executed[a["model"]][a["i"]]:
                    raise AssertionError(
                        f"{name}: a {a['x']} {a['model']} answer differs "
                        f"from the executed one for its input {a['i']}")
    wave3 = run["wave3"]["answers"]
    report["waves"]["wave3"]["same_bytes_as_wave1"] = sum(
        a["result"] == executed[a["model"]][a["i"]] for a in wave3)
    first = run["sync1"]
    misses = {a["i"]: a["body"] for a in first["answers"] if a["x"] == "miss"}
    if (len(misses) != N_CACHE_TILES
            or first["counts"]["rows"]["landcover"] != N_CACHE_TILES
            or any(a["body"] != misses[a["i"]] for a in first["answers"])):
        raise AssertionError(f"sync 1: {[a['x'] for a in first['answers']]}, "
                             f"{first['counts']}")
    hit_rounds = [f"sync{n + 2}" for n in range(N_SYNC_HIT_ROUNDS)]
    for name in hit_rounds + ["sync_collected"]:
        hits = run[name]
        if (any(a["x"] != "hit" or a["body"] != misses[a["i"]]
                for a in hits["answers"])
                or any(hits["counts"]["rows"].values())
                or any(hits["counts"]["launches"].values())):
            raise AssertionError(f"{name}: "
                                 f"{[a['x'] for a in hits['answers']]}, "
                                 f"{hits['counts']}")
    for name in ["sync1"] + hit_rounds + ["sync_collected"]:
        answers = run[name]["answers"]
        report[name] = {
            "x_cache": {x: sum(a["x"] == x for a in answers)
                        for x in sorted({a["x"] for a in answers})},
            **run[name]["counts"], "client_gc": run[name]["client_gc"],
            "loop_stalls": run[name]["loop_stalls"],
            "ms": pcts([a["ms"] for a in answers])}
    report["sync_collected"]["full_collection_ms"] = \
        run["full_collection_ms"]
    cp = run["cp_metrics"]
    report["rescache"] = {
        **{f"requests_{o}": metric_sum(cp, "ai4e_rescache_requests_total",
                                       outcome=o)
           for o in ("hit", "miss", "coalesced", "bypass")},
        "entries": metric_sum(cp, "ai4e_rescache_entries"),
        "bytes": metric_sum(cp, "ai4e_rescache_bytes"),
        "dispatch_cache_hit": metric_sum(cp, "ai4e_dispatch_total",
                                         outcome="cache_hit")}
    return report


def phase_cache_served(handoff: dict, device: str = "cuda"):
    """14b: the control plane with ``AI4E_PLATFORM_RESULT_CACHE=1`` as a
    child process, land cover and moe served by ``build_worker`` in this
    process (so each wave's kernel launches are read here). Returns the
    report, the worker and the inputs for 14c."""
    from ai4e_tpu_torch.cli import build_worker
    from ai4e_tpu_torch.config import FrameworkConfig

    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker_url = (f"http://127.0.0.1:{cp_port}",
                           f"http://127.0.0.1:{wk_port}")
    models, routes = cache_specs(gateway, worker_url, CACHE_MODELS)
    (out_dir / "cache_routes.json").write_text(json.dumps(routes))
    seqs, _ = moe_held_out(N_CACHE_TILES)
    bodies = {"landcover": handoff["landcover"][0][:N_CACHE_TILES],
              "moe": [npy_bytes(s.astype(np.uint16)) for s in seqs]}
    cp_log = out_dir / "cache_control_plane.log"
    cp = start_child(["control-plane", "--routes",
                      str(out_dir / "cache_routes.json"), "--port",
                      str(cp_port)], cp_log,
                     {**handoff["env"], "AI4E_PLATFORM_RESULT_CACHE": "1"})
    try:
        t0 = time.perf_counter()
        worker, batcher, _ = build_worker(
            models, device=device, config=FrameworkConfig.from_env(
                {"AI4E_RUNTIME_CHECKPOINT_DIR": str(out_dir)}))
        build_s = time.perf_counter() - t0
        run = asyncio.run(cache_run(gateway, cp, cp_log, worker, batcher,
                                    wk_port, bodies))
        stop_child(cp, cp_log, "cache control plane")
    finally:
        if cp.poll() is None:
            cp.kill()
            cp.wait(timeout=30)
    report = {"card": CARD.get("smi"), "worker_build_s": build_s,
              **check_cache(run, device), "hash": hash_ms()}
    log(f"cache 14b: {json.dumps(report)}")
    return report, worker, bodies


async def invalidation_run(platform, worker, batcher, ports: tuple,
                           bodies: dict, npz: dict) -> dict:
    """14c's client against the in-process platform and worker."""
    import aiohttp
    from aiohttp import web

    from ai4e_tpu_torch.rescache import request_key

    cp_port, wk_port = ports
    gateway = f"http://127.0.0.1:{cp_port}"
    runner = web.AppRunner(platform.gateway.app)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", cp_port).start()
    await platform.start()
    cache = platform.result_cache
    out: dict = {}

    def keys(model: str, backend: str) -> list[str]:
        return [request_key(backend, b, "application/octet-stream")
                for b in bodies[model]]

    lc_keys = keys("landcover", "/v1/models/classify-async")
    moe_keys = keys("moe", "/v1/models/route-async")

    async def one_by_one(headers=None) -> list[dict]:
        answers = []
        for i, body in enumerate(bodies["landcover"]):
            answers += await cache_wave(http, gateway,
                                        [("landcover", LC_ASYNC, i, body)],
                                        headers)
        return answers

    try:
        async with serving(worker, batcher, wk_port) as (_, base), \
                aiohttp.ClientSession(
                    connector=aiohttp.TCPConnector(limit=0),
                    timeout=aiohttp.ClientTimeout(total=600)) as http:
            async def reload(path: str, key: str | None) -> int:
                async with http.post(base + "/models/landcover/reload",
                                     json={"checkpoint": path},
                                     headers=keyed(key)) as r:
                    return r.status

            if await reload(npz["seed0"], ADMIN_KEY) != 200:
                raise AssertionError("reload to the seed-0 weights failed")
            out["seed0"] = await one_by_one()
            await cache_wave(http, gateway,
                             [("moe", MOE_ASYNC, i, b)
                              for i, b in enumerate(bodies["moe"])])
            out["cached_before"] = {
                "landcover": sum(map(cache.peek, lc_keys)),
                "moe": sum(map(cache.peek, moe_keys))}
            out["reload_codes"] = [await reload(npz["trained"], None),
                                   await reload(npz["trained"], "k-wrong"),
                                   await reload(npz["trained"], ADMIN_KEY)]
            out["cached_after"] = {
                "landcover": sum(map(cache.peek, lc_keys)),
                "moe": sum(map(cache.peek, moe_keys))}
            before = worker_counts(worker)
            out["trained"] = await one_by_one()
            out["trained_counts"] = counts_delta(before, worker_counts(worker))
            out["bypass"] = await one_by_one({"X-Cache-Bypass": "1"})

            # The straddling burst: requests every STRADDLE_GAP_S, the reload
            # back to the seed-0 weights issued a third of the way in, until
            # N_AFTER_RELOAD requests went out after its 200.
            done: dict = {}

            async def reloader() -> None:
                await asyncio.sleep(N_AFTER_RELOAD * STRADDLE_GAP_S)
                status = await reload(npz["seed0"], ADMIN_KEY)
                done.update(status=status, t=time.perf_counter())

            async def one(j: int) -> dict:
                i = j % len(bodies["landcover"])
                sent = time.perf_counter()
                answer, = await cache_wave(
                    http, gateway,
                    [("landcover", LC_ASYNC, i, bodies["landcover"][i])])
                return {**answer, "after_200": "t" in done
                        and sent > done["t"]}

            reload_task = asyncio.create_task(reloader())
            sends, after = [], 0
            while after < N_AFTER_RELOAD and len(sends) < 4096:
                after += "t" in done
                sends.append(asyncio.create_task(one(len(sends))))
                await asyncio.sleep(STRADDLE_GAP_S)
            await reload_task
            out["straddle"] = list(await asyncio.gather(*sends))
            out["straddle_reload"] = done["status"]
    finally:
        await platform.stop()
        await runner.cleanup()
    return out


def check_invalidation(run: dict, num_classes: int, pixels: int) -> dict:
    """14c's gates."""
    report = {"reload_codes": run["reload_codes"],
              "cached_before": run["cached_before"],
              "cached_after": run["cached_after"],
              "trained_x_cache": sorted({a["x"] for a in run["trained"]}),
              "trained_counts": run["trained_counts"]}
    want = {"landcover": N_CACHE_TILES, "moe": N_CACHE_TILES}
    if run["reload_codes"] != [401, 401, 200] or run["cached_before"] != want:
        raise AssertionError(f"14c: {report}")
    if run["cached_after"] != {"landcover": 0, "moe": N_CACHE_TILES}:
        raise AssertionError(f"the reload left {run['cached_after']} cached")
    if (report["trained_x_cache"] != ["miss"]
            or run["trained_counts"]["rows"]["landcover"] != N_CACHE_TILES):
        raise AssertionError(f"after the reload: {report}")
    trained = [a["result"] for a in run["trained"]]
    if trained != [a["result"] for a in run["bypass"]]:
        raise AssertionError("after the reload a tile's answer differs from "
                             "a bypass request's")
    seed0 = [a["result"] for a in run["seed0"]]
    changed = sum(a != b for a, b in zip(seed0, trained))
    if not changed:
        raise AssertionError("no tile's answer changed with the reload: the "
                             "phase proves nothing")
    # The burst: an answer is stale when it is nearer the trained weights'
    # answer (before the reload) than the seed-0 weights' (after it). Only
    # tiles whose two answers differ tell them apart.
    old = [class_counts(b, num_classes) for b in trained]
    new = [class_counts(b, num_classes) for b in seed0]
    telling = {i for i in range(len(old))
               if np.abs(old[i] - new[i]).sum() > 4 * COUNT_TOLERANCE
               * pixels}
    if not telling:
        raise AssertionError("no tile tells the two weights apart")
    stale = {"before_200": 0, "after_200": 0}
    sent = {"before_200": 0, "after_200": 0}
    for a in run["straddle"]:
        side = "after_200" if a["after_200"] else "before_200"
        sent[side] += 1
        if not a["status"].startswith("completed"):
            raise AssertionError(f"straddle: {a['status']}")
        if a["i"] in telling:
            got = class_counts(a["result"], num_classes)
            stale[side] += int(np.abs(got - old[a["i"]]).sum()
                               <= np.abs(got - new[a["i"]]).sum())
    report.update(changed_tiles=changed, telling_tiles=len(telling),
                  straddle_sent=sent, straddle_stale=stale,
                  straddle_reload=run["straddle_reload"])
    if run["straddle_reload"] != 200 or sent["after_200"] < N_AFTER_RELOAD:
        raise AssertionError(f"straddle: {report}")
    if stale["after_200"]:
        raise AssertionError(f"{stale['after_200']} requests sent after the "
                             f"reload's 200 got a pre-reload answer")
    return report


def phase_invalidation(handoff: dict, worker, bodies: dict,
                       device: str = "cuda") -> dict:
    """14c: ``LocalPlatform(result_cache=True)`` and a worker in this
    process given its cache (so its reloads invalidate it), on 14b's
    runtime (its graphs), its reload gated by a key."""
    from ai4e_tpu_torch.convert import save_npz
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
    from ai4e_tpu_torch.runtime.batcher import MicroBatcher
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.worker import InferenceWorker
    from ai4e_tpu_torch.taskstore.http import make_app

    out_dir = handoff["out_dir"]
    runtime = worker.runtime
    lc = runtime.models["landcover"]
    spec = next(m for m in cache_specs("", "", ("landcover",))[0]["models"])
    fresh = build_servable("unet", **model_kwargs({"models": [
        {k: v for k, v in spec.items() if k != "checkpoint"}]}))
    npz = {"seed0": str(out_dir / "landcover_seed0.npz"),
           "trained": str(out_dir / (spec["checkpoint"] + ".npz"))}
    save_npz(fresh.flax_from_state_dict(fresh.module.state_dict()),
             npz["seed0"])
    del fresh
    metrics = MetricsRegistry()
    platform = LocalPlatform(PlatformConfig(
        retry_delay=TOPOLOGY_RETRY_DELAY, result_cache=True), metrics=metrics)
    make_app(platform.store, app=platform.gateway.app)  # the result reads
    cp_port, wk_port = free_port(), free_port()
    batcher = MicroBatcher(runtime, metrics=metrics)
    inproc = InferenceWorker(
        "gpu-worker", runtime, batcher, task_manager=platform.task_manager,
        prefix="v1/models", metrics=metrics, store=platform.store,
        checkpoint_root=str(out_dir), result_cache=platform.result_cache,
        admin_api_keys={ADMIN_KEY})
    inproc.serve_model(lc, sync_path="/classify", async_path="/classify-async")
    inproc.serve_model(runtime.models["moe"], sync_path="/route",
                       async_path="/route-async")
    wk = f"http://127.0.0.1:{wk_port}"
    platform.publish_async_api(LC_ASYNC, wk + "/v1/models/classify-async")
    platform.publish_async_api(MOE_ASYNC, wk + "/v1/models/route-async")
    run = asyncio.run(invalidation_run(platform, inproc, batcher,
                                       (cp_port, wk_port), bodies, npz))
    report = check_invalidation(run, spec["num_classes"],
                                spec["tile"] ** 2)
    log(f"cache 14c: {json.dumps({'card': CARD.get('smi'), **report})}")
    return report


def phase_cache(handoff: dict, kernels: list[dict],
                device: str = "cuda") -> dict:
    """Phase 14: keys, rate limits and quotas (a), the result cache through
    the control plane (b), invalidation on reload in one process (c)."""
    import gc

    log("cache: subscription keys, limits and quotas, then the result cache")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report = {"14a": phase_keys(handoff, device)}
    report["14b"], worker, bodies = phase_cache_served(handoff, device)
    report["14c"] = phase_invalidation(handoff, worker, bodies, device)
    del worker
    report["seconds"] = time.perf_counter() - t0
    rows = {k["name"]: k for k in kernels}
    waves = report["14b"]["waves"]
    for name in ("normalize_image", "fused_seg_postprocess",
                 "flash_attention"):
        if name in rows:
            rows[name]["launches_cache_waves"] = {
                w: waves[w]["launches"][name] for w in waves}
    for name in ("normalize_image", "fused_seg_postprocess"):
        if name in rows:
            # The worker's own count over 14a (its exit line).
            rows[name]["launches_keys_14a"] = (
                report["14a"]["launches_while_serving"].get(name, 0))
    log(f"cache: {json.dumps({'seconds': report['seconds']})}")
    return report


# -- phase 15: C8 on the card, result offload, the native cores, the rescue --

N_C8_TILES = 64            # 15a: held-out land-cover tiles
C8_SIZES = (64, 16, 1)     # 15a: batch sizes, each its own bucket
# 15a: ROADMAP C8's bound on the card. cuDNN picks a convolution algorithm
# per batch shape (a strided convolution's output differs for equal
# inputs), so a tile's per-class counts may move between buckets by at
# most this share of its pixels (phase 4's 1% is ten times looser).
C8_CARD_BOUND = 0.001
# 15b: bytes; over a camera-trap result with one detection or more (112 B
# for one), never a land-cover histogram (69 B at most).
OFFLOAD_LOW = 96
OFFLOAD_RETENTION_S = 15   # 15b: the low-threshold turn's terminal retention
RESCUE_TIMEOUT_S = 3       # 15d: AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT
RESCUE_MAX_DELIVERY = 3    # 15d: AI4E_PLATFORM_MAX_DELIVERY_COUNT
N_DEAD_LETTER = 8          # 15d: tasks sent while the worker is down
RESCUE_TRIES = 8           # 15d: bursts tried until one is caught all running
LC_DONE = "completed - class_histogram"


def decode_npy(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body))


def landcover_entry(handoff: dict) -> dict:
    entry = next(m for m in handoff["models"]["models"]
                 if m["name"] == "landcover")
    return {k: v for k, v in entry.items()
            if k not in ("family", "sync_path", "async_path", "checkpoint")}


def lc_pixels(handoff: dict) -> int:
    return landcover_entry(handoff)["tile"] ** 2


def c8_counts(runtime, name: str, tiles: np.ndarray) -> tuple[dict, dict]:
    """Each tile's counts run in batches of each size of ``C8_SIZES`` (a
    bucket each), and for each pair of sizes the tiles whose counts differ
    and the largest count difference."""
    by = {size: np.concatenate([
        np.asarray(runtime.run_batch(name, tiles[i:i + size])["counts"])
        for i in range(0, len(tiles), size)]).astype(np.int64)
        for size in C8_SIZES}
    pairs = {}
    for i, a in enumerate(C8_SIZES):
        for b in C8_SIZES[i + 1:]:
            d = np.abs(by[a] - by[b])
            pairs[f"{a} vs {b}"] = {
                "tiles_differ": int((d.max(axis=1) > 0).sum()),
                "max_count_diff": int(d.max())}
    return by, pairs


def localize_batch_dependence(servable, tiles: np.ndarray, row: int) -> dict:
    """Where a tile's answer first depends on its batch: every convolution's
    input and output for ``tiles[row]`` eagerly in the batch of all the
    tiles and alone, in execution order; the first tensor that differs and
    by how much."""
    seen: dict[str, list] = {}
    handles = []

    def keep(name):
        def pre(_m, inputs):
            seen.setdefault(name + " in", []).append(
                inputs[0][row_of[0]:row_of[0] + 1].float().clone())

        def post(_m, _inputs, out):
            seen.setdefault(name + " out", []).append(
                out[row_of[0]:row_of[0] + 1].float().clone())
        return pre, post

    row_of = [row]
    dev = next(servable.module.parameters()).device
    for name, mod in servable.module.named_modules():
        if isinstance(mod, torch.nn.Conv2d):
            pre, post = keep(name)
            handles.append(mod.register_forward_pre_hook(pre))
            handles.append(mod.register_forward_hook(post))
    try:
        with torch.inference_mode():
            servable.apply_fn(servable.module,
                              torch.from_numpy(tiles).to(dev))
            row_of[0] = 0
            servable.apply_fn(servable.module,
                              torch.from_numpy(tiles[row:row + 1]).to(dev))
    finally:
        for h in handles:
            h.remove()
    last_equal = None
    for name, (batched, alone) in seen.items():
        diff = float((batched - alone).abs().max())
        if diff > 0:
            # Between ``last_equal`` and ``name`` lies the op at fault: the
            # convolution itself (its "in" equal, its "out" not), or what
            # runs between two convolutions (GroupNorm, gelu, the skips).
            return {"first_differs": name, "last_equal": last_equal,
                    "max_abs_diff": diff, "tensors_checked": len(seen)}
        last_equal = name
    return {"first_differs": None, "tensors_checked": len(seen)}


def phase_c8(handoff: dict, replay_7a_ms: float | None,
             device: str = "cuda") -> dict:
    """15a: land cover's answer against the batch it rides in, on the
    trained ``.npz``: 64 held-out tiles through ``ModelRuntime.run_batch``
    in one batch of 64, as 4 x 16 and one at a time; the kernels' launches
    in that run (the counters set to 0 before the warmup), and the
    bucket-64 replay timed beside phase 7a's."""
    from ai4e_tpu_torch import ops
    from ai4e_tpu_torch.cli import restore_checkpoint
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    bodies, _ = handoff["landcover"]
    tiles = np.stack([decode_npy(b) for b in bodies[-N_C8_TILES:]])
    runtime = ModelRuntime(device)
    servable = build_servable("unet", **landcover_entry(handoff))
    restore_checkpoint(servable, "landcover", str(handoff["out_dir"]))
    runtime.register(servable)
    report: dict = {"card": CARD.get("smi"), "tiles": len(tiles)}
    reset_launches()
    runtime.warmup()
    counts, report["buckets"] = c8_counts(runtime, servable.name, tiles)
    report["launches"] = ops.launch_counts()
    if device == "cuda":
        for kernel in ("normalize_image", "fused_seg_postprocess"):
            if report["launches"][kernel] < 1:
                raise AssertionError(f"15a: {kernel} never launched")
        graph = runtime.graphs[(servable.name, 64)].graph
        ms = [stream_ms(graph.replay) for _ in range(2)]
        report["replay_64_ms"] = ms
        report["replay_64_ms_phase_7a"] = replay_7a_ms
        if replay_7a_ms:
            report["replay_over_phase_7a"] = (statistics.median(ms)
                                              / replay_7a_ms)
    pixels = int(np.prod(runtime.models[servable.name].input_shape[:2]))
    worst = max(p["max_count_diff"] for p in report["buckets"].values())
    if worst:
        d = np.abs(counts[64] - counts[1]).max(axis=1)
        row = int(np.argmax(d))
        if d[row]:
            report["localized"] = localize_batch_dependence(
                runtime.models[servable.name], tiles, row)
    report["bound_px"] = C8_CARD_BOUND * pixels
    log(f"c8 15a: {json.dumps(report)}")
    if worst > C8_CARD_BOUND * pixels:
        raise AssertionError(f"15a: a tile's counts moved by {worst} px "
                             f"between buckets: {report}")
    del runtime
    if device == "cuda":
        torch.cuda.empty_cache()
    return report


def ledger_hops(records: list[dict], want: tuple) -> dict:
    timelines = []
    for record in records:
        check_timeline(record["TaskId"], record["Ledger"], want)
        timelines.append(record["Ledger"])
    return deltas_summary(timelines)


async def offload_drive(gateway: str, worker: str, procs: dict, logs: dict,
                        work: dict, result_dir: Path | None) -> dict:
    """15b's client: 64 async land-cover tiles, then the camera-trap scenes
    at once through detect-async; each task's stage and final results (the
    raw bytes too), its ``?ledger=1`` record, and what lies on disk."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        out = {"landcover": await drive_gateway(
            http, gateway, "/v1/landcover/classify", work["landcover"], 0,
            LC_DONE, worker)}

        async def detect(body: bytes) -> tuple:
            t0 = time.perf_counter()
            async with http.post(gateway + "/v1/camera-trap/detect-async",
                                 data=body, headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"detect-async {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            record = await await_terminal(http, gateway, task_id)
            return t0, time.perf_counter(), task_id, record

        async def raw(task_id: str, stage: str | None = None) -> bytes:
            params = {"taskId": task_id, **({"stage": stage} if stage
                                            else {})}
            async with http.get(gateway + "/v1/taskstore/result",
                                params=params) as r:
                if r.status != 200:
                    raise AssertionError(f"result of {task_id} ({stage}): "
                                         f"{r.status}")
                return await r.read()

        runs = await asyncio.gather(*(detect(b) for b in work["scenes"]))
        det = {"runs": runs, "stage_raw": [], "final_raw": []}
        for _, _, task_id, record in runs:
            det["final_raw"].append(await raw(task_id))
            det["stage_raw"].append(
                det["final_raw"][-1]
                if record["Status"] == "completed - detections"
                else await raw(task_id, "megadetector"))
        det["stage"] = [json.loads(b) for b in det["stage_raw"]]
        det["final"] = [json.loads(b) for b in det["final_raw"]]
        latency = sorted((t1 - t0) * 1e3 for t0, t1, _, _ in runs)
        det["task_p50_ms"] = statistics.median(latency)
        det["task_p95_ms"] = float(np.percentile(latency, 95))
        out["detect"] = det
        out["lc_results_raw"] = [await raw(t)
                                 for t in out["landcover"]["task_ids"]]
        out["records"] = {
            "landcover": [await fetch_record(http, gateway, t)
                          for t in out["landcover"]["task_ids"]],
            "camera_trap": [await fetch_record(http, gateway, t)
                            for _, _, t, _ in runs]}
        if result_dir is not None:
            out["files"] = {p.name: p.read_bytes()
                            for p in sorted(result_dir.iterdir())}
    return out


def offload_turn(handoff: dict, tag: str, extra: dict, result_dir,
                 device: str) -> dict:
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = wire_deploy_specs(gateway, worker, None)
    env = {**handoff["env"], "AI4E_PLATFORM_OBSERVABILITY": "1",
           "AI4E_OBSERVABILITY_HOP_LEDGER": "1", **extra}
    bodies, _ = handoff["landcover"]
    work = {"landcover": bodies[-N_DEPLOY_ASYNC:],
            "scenes": handoff["scenes"]}
    with control_plane_and_worker(out_dir, tag, models, routes, env,
                                  cp_port, wk_port, device) as (procs, logs):
        out = asyncio.run(offload_drive(gateway, worker, procs, logs, work,
                                        result_dir))
        if extra.get("AI4E_PLATFORM_REAPER_TERMINAL_RETENTION"):
            # Eviction deletes the blobs with the records.
            deadline = time.monotonic() + 3 * OFFLOAD_RETENTION_S
            while any(result_dir.iterdir()):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"15b: blobs left after eviction: "
                        f"{sorted(p.name for p in result_dir.iterdir())}")
                time.sleep(0.5)
            out["evicted_after_s"] = time.monotonic() - (
                deadline - 3 * OFFLOAD_RETENTION_S)
    out["by_model"] = launches_by_model(logs["wk"].read_text(
        errors="replace"))
    return out


def check_offload_answers(handoff: dict, out: dict, tag: str) -> None:
    """Land cover's histograms against phase 10's plain ops, each camera
    trap task completed under its TaskId with its species stack, and the
    megadetector's objects within phase 10b's slack."""
    _, want = handoff["landcover"]
    for i, result in enumerate(out["landcover"]["results"]):
        check_histogram(result, want[len(want) - N_DEPLOY_ASYNC + i],
                        lc_pixels(handoff))
    det = out["detect"]
    check_handoffs(det)
    hits, total = served_detection_accuracy(det["stage"],
                                            handoff["scene_targets"])
    if abs(hits - handoff["scene_hits_10b"]) > DEPLOY_SLACK:
        raise AssertionError(f"15b {tag}: megadetector served {hits}/{total} "
                             f"objects, phase 10b {handoff['scene_hits_10b']}")


def phase_offload(handoff: dict, device: str = "cuda") -> dict:
    """15b: the three image models of the deploy spec behind the control
    plane (two child processes, the observability layer on) with a result
    directory at ``OFFLOAD_LOW`` bytes and a short terminal retention; 64
    land-cover tiles and 16 camera-trap scenes. (At the default 1 MiB no
    result of these models reaches the directory:
    ``tests/test_torch_offload.py`` holds that. No turn without a
    directory runs beside it, for the script's time: the offload's cost
    stayed inside the spread between such turns.)"""
    from urllib.parse import quote

    result_dir = handoff["out_dir"] / "results" / "low"
    result_dir.mkdir(parents=True, exist_ok=True)
    for p in result_dir.iterdir():
        p.unlink()
    turns = {"low": ({
        "AI4E_PLATFORM_RESULT_DIR": str(result_dir),
        "AI4E_SERVICE_RESULT_DIR": str(result_dir),
        "AI4E_PLATFORM_RESULT_OFFLOAD_THRESHOLD": str(OFFLOAD_LOW),
        "AI4E_SERVICE_RESULT_OFFLOAD_THRESHOLD": str(OFFLOAD_LOW),
        "AI4E_PLATFORM_REAPER_TERMINAL_RETENTION": str(OFFLOAD_RETENTION_S),
        "AI4E_PLATFORM_REAPER_INTERVAL": "1"}, result_dir)}
    outs = {tag: offload_turn(handoff, f"offload_{tag}", env, result_dir,
                              device)
            for tag, (env, result_dir) in turns.items()}
    report: dict = {"card": CARD.get("smi"), "turns": {}}
    for tag, out in outs.items():
        check_offload_answers(handoff, out, tag)
        det = out["detect"]
        sizes = ([len(b) for b in det["stage_raw"]]
                 + [len(b) for b in det["final_raw"]])
        lc_sizes = [len(b) for b in out["lc_results_raw"]]
        row = {"camera_trap_result_bytes": [min(sizes), max(sizes)],
               "landcover_result_bytes": [min(lc_sizes), max(lc_sizes)],
               "landcover_requests_per_s":
                   out["landcover"]["async_requests_per_s"],
               "landcover_task_p50_ms": out["landcover"]["task_p50_ms"],
               "landcover_task_p95_ms": out["landcover"]["task_p95_ms"],
               "detect_task_p50_ms": det["task_p50_ms"],
               "detect_task_p95_ms": det["task_p95_ms"],
               "hops_camera_trap": ledger_hops(out["records"]["camera_trap"],
                                               TWO_STAGES),
               "hops_landcover": ledger_hops(out["records"]["landcover"],
                                             ONE_STAGE)}
        files = out.get("files")
        if files is not None:
            bins = {n: b for n, b in files.items() if n.endswith(".bin")}
            row["files"] = len(files)
            row["bin_bytes"] = sorted(len(b) for b in bins.values())
            threshold = OFFLOAD_LOW
            # One blob per camera-trap result at or over the threshold,
            # none for land cover, each the bytes the store serves.
            want = {}
            for (_, _, task_id, record), stage, final in zip(
                    det["runs"], det["stage_raw"], det["final_raw"]):
                if record["Status"] == "completed - detections":
                    keys = [(task_id, final)]
                else:
                    keys = [(f"{task_id}:megadetector", stage),
                            (task_id, final)]
                for key, body in keys:
                    if len(body) >= threshold:
                        want[quote(key, safe="") + ".bin"] = body
            if bins != want:
                raise AssertionError(
                    f"15b {tag}: {len(bins)} blobs on disk, {len(want)} "
                    f"results at or over {threshold} B; names "
                    f"{sorted(set(bins) ^ set(want))[:4]}")
            if not bins:
                raise AssertionError(f"15b {tag}: nothing was offloaded")
            if "evicted_after_s" in out:
                row["blobs_gone_after_s"] = out["evicted_after_s"]
        report["turns"][tag] = row
        log(f"offload 15b {tag} hops camera trap (ms): "
            f"{json.dumps(row['hops_camera_trap'])}")
    report["launches_by_model"] = {t: o["by_model"] for t, o in outs.items()}
    for tag, out in outs.items():
        if device != "cuda":
            break  # the CPU runs the plain versions
        for model, kernel in (("landcover", "normalize_image"),
                              ("landcover", "fused_seg_postprocess"),
                              ("megadetector", "normalize_image"),
                              ("species", "normalize_image")):
            if out["by_model"].get(model, {}).get(kernel, 0) < 1:
                raise AssertionError(f"15b {tag}: {kernel} never launched "
                                     f"for {model}")
    log(f"offload 15b: {json.dumps({t: {k: v for k, v in r.items() if not k.startswith('hops')} for t, r in report['turns'].items()})}")
    return report


async def native_drive(gateway: str, worker: str, procs: dict, logs: dict,
                       work: dict) -> dict:
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        # Which store answers: the native one has no result refs.
        async with http.post(gateway + "/v1/taskstore/result-ref",
                             json={"TaskId": "probe"}) as r:
            probe = (r.status, (await r.json()).get("error"))
        out = {"store_probe": probe}
        out["landcover"] = await drive_gateway(
            http, gateway, "/v1/landcover/classify", work["landcover"],
            N_DEPLOY_SYNC, LC_DONE, worker)
    return out


#: 15c's turns: the control plane's env for each. The turn on the Python
#: store and broker beside the C++ ones (a comparison, unresolved in
#: PERF.md section 7; every other phase runs the Python cores) was cut for
#: the script's time.
CORE_TURNS = (("native", {"AI4E_PLATFORM_NATIVE_STORE": "1",
                          "AI4E_PLATFORM_NATIVE_BROKER": "1"}),)


def phase_native_cores(handoff: dict, device: str = "cuda") -> dict:
    """15c: land cover (4 sync + 64 async) behind a control plane on each
    of ``CORE_TURNS``' cores (the C++ store and broker), a child process on
    one port in front of one land-cover worker (a child process too),
    answers checked as phase 10b checks them. Land cover alone, one worker:
    the whole script must stay inside its time limit."""
    from ai4e_tpu_torch.broker import native as broker_native
    from ai4e_tpu_torch.taskstore import native as store_native

    t0 = time.perf_counter()
    built = [store_native.build_library(), broker_native.build_library()]
    build_s = time.perf_counter() - t0
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    work = {"landcover": bodies}
    cp_port = free_port()
    gateway = f"http://127.0.0.1:{cp_port}"
    w = {"tag": "cores", "port": free_port(), "out_dir": out_dir,
         "models": out_dir / "cores_models.json"}
    w["url"] = f"http://127.0.0.1:{w['port']}"
    models, routes = cache_specs(gateway, w["url"], ("landcover",))
    w["models"].write_text(json.dumps(models))
    routes_path = out_dir / "cores_routes.json"
    routes_path.write_text(json.dumps(routes))
    outs = {}
    start_res_worker(w, handoff["env"], device)
    try:
        asyncio.run(wait_all_healthy([(w["url"] + "/v1/models/", w["proc"],
                                       w["log"])]))
        w["mark"] = launches_now(w)
        for tag, extra in CORE_TURNS:
            logs = {"cp": out_dir / f"cores_{tag}_control_plane.log",
                    "wk": w["log"]}
            procs = {"cp": start_child(
                ["control-plane", "--routes", str(routes_path), "--port",
                 str(cp_port)], logs["cp"], {**handoff["env"], **extra}),
                "wk": w["proc"]}
            try:
                outs[tag] = asyncio.run(native_drive(gateway, w["url"],
                                                     procs, logs, work))
                stop_child(procs["cp"], logs["cp"], f"15c {tag} control plane")
            finally:
                if procs["cp"].poll() is None:
                    procs["cp"].kill()
                    procs["cp"].wait(timeout=30)
            outs[tag]["by_model"] = {"landcover": launches_delta(w)}
        stop_child(w["proc"], w["log"], "15c worker")
    finally:
        if w["proc"].poll() is None:
            w["proc"].kill()
            w["proc"].wait(timeout=30)
    report: dict = {"card": CARD.get("smi"), "build_s": build_s,
                    "libraries": [Path(p).name for p in built]}
    for tag, out in outs.items():
        probe_native = out["store_probe"] == (
            400, "store does not support result refs")
        if probe_native != (tag == "native"):
            raise AssertionError(f"15c {tag}: the store answered "
                                 f"{out['store_probe']}")
        for i, result in enumerate(out["landcover"]["results"]):
            check_histogram(result, want[i], lc_pixels(handoff))
        for kernel in ("normalize_image", "fused_seg_postprocess"):
            if device == "cuda" and out["by_model"].get(
                    "landcover", {}).get(kernel, 0) < 1:
                raise AssertionError(f"15c {tag}: {kernel} never launched "
                                     f"for landcover")
        report[tag] = {"landcover": {
            "requests_per_s": out["landcover"]["async_requests_per_s"],
            "task_p50_ms": out["landcover"]["task_p50_ms"],
            "task_p95_ms": out["landcover"]["task_p95_ms"],
            "sync_p50_ms": out["landcover"]["sync_p50_ms"]},
            "launches_by_model": out["by_model"]}
    log(f"cores 15c: {json.dumps(report)}")
    return report


async def http_json(http, method: str, url: str, **kw) -> tuple[int, dict]:
    async with http.request(method, url, **kw) as r:
        return r.status, (await r.json() if r.content_type ==
                          "application/json" else await r.text())


async def rescue_drive(gateway: str, worker: str, procs: dict, logs: dict,
                       restart, bodies: list[bytes], env: dict) -> dict:
    """15d's client: land-cover bursts until one is caught with every
    unfinished task in ``running``; then the worker is killed, tasks are
    sent while it is down (dead-lettered), the reaper's rescues counted,
    the worker restarted on its port, the dead letters redriven with the
    ``redrive`` verb, and every task awaited to ``completed``."""
    import aiohttp
    import signal

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])

        async def submit(body: bytes) -> str:
            async with http.post(gateway + LC_ASYNC, data=body,
                                 headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"{LC_ASYNC} {r.status}: "
                                         f"{await r.text()}")
                return (await r.json())["TaskId"]

        async def depths() -> dict:
            _, d = await http_json(http, "GET",
                                   gateway + "/v1/taskstore/depths")
            return d.get(LC_QUEUE, {})

        sent: list[tuple[str, int]] = []
        caught = None
        for attempt in range(RESCUE_TRIES):
            ids = await asyncio.gather(*(submit(b) for b in bodies))
            sent += [(t, i) for i, t in enumerate(ids)]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                d = await depths()
                if d.get("created", 0) == 0 and d.get("running", 0) > 0:
                    # Every unfinished task is running in the worker, none
                    # in a delivery: kill it now.
                    procs["wk"].send_signal(signal.SIGKILL)
                    procs["wk"].wait(timeout=30)
                    caught = {"attempt": attempt,
                              "running_at_kill": (await depths())["running"]}
                    break
                if d.get("created", 0) == 0 and d.get("running", 0) == 0:
                    break  # the burst finished before it was caught
                await asyncio.sleep(0.002)
            if caught:
                break
        if not caught:
            raise AssertionError(f"15d: no burst of {RESCUE_TRIES} was caught "
                                 "with tasks running")
        t_kill = time.monotonic()
        # Sent while the worker is down: each exhausts its deliveries.
        down = await asyncio.gather(*(submit(b)
                                      for b in bodies[:N_DEAD_LETTER]))
        sent += [(t, i) for i, t in enumerate(down)]
        requeued = 0.0
        deadline = t_kill + 60
        while time.monotonic() < deadline:
            async with http.get(gateway + "/metrics") as r:
                requeued = metric_sum(await r.text(),
                                      "ai4e_reaper_actions_total",
                                      outcome="requeued")
            if requeued >= caught["running_at_kill"]:
                break
            await asyncio.sleep(0.25)
        caught["rescued_after_s"] = time.monotonic() - t_kill
        # The rescued tasks, redelivered to no worker, and the tasks sent
        # while it was down: all dead-lettered before it comes back.
        deadline = time.monotonic() + 60
        while (await depths()).get("created", 0) or (
                await depths()).get("running", 0):
            if time.monotonic() > deadline:
                raise AssertionError(f"15d: tasks never left created/"
                                     f"running: {await depths()}")
            await asyncio.sleep(0.25)
        caught["dead_lettered"] = (await depths()).get("failed", 0)
        t0 = time.monotonic()
        procs["wk"] = restart()
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        caught["worker_back_s"] = time.monotonic() - t0
        caught["redrive"] = await asyncio.to_thread(redrive_verb, gateway,
                                                    env)
        finals = {}
        for task_id, i in sent:
            finals[task_id] = (i, await await_terminal(http, gateway,
                                                       task_id))
        results = {}
        for task_id, (i, record) in finals.items():
            if record["Status"] != LC_DONE:
                raise AssertionError(f"15d: task {task_id} ended "
                                     f"{record['Status']}")
            results[task_id] = (i, json.loads(await result_bytes(
                http, gateway, task_id)))
        async with http.get(gateway + "/metrics") as r:
            caught["cp_metrics"] = await r.text()
        caught["requeued"] = metric_sum(caught["cp_metrics"],
                                        "ai4e_reaper_actions_total",
                                        outcome="requeued")
        caught["results"] = results
        caught["tasks"] = len(sent)
    return caught


def redrive_verb(gateway: str, env: dict) -> dict:
    """``python -m ai4e_tpu_torch redrive --store GATEWAY`` as a child
    process; its JSON answer."""
    done = subprocess.run([sys.executable, "-m", "ai4e_tpu_torch", "redrive",
                           "--store", gateway], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    if done.returncode != 0:
        raise AssertionError(f"redrive exited {done.returncode}: "
                             f"{done.stdout[-1000:]} {done.stderr[-1000:]}")
    return json.loads(done.stdout)


def phase_rescue(handoff: dict, device: str = "cuda") -> dict:
    """15d: land cover behind a control plane whose reaper rescues tasks
    left ``running`` for ``RESCUE_TIMEOUT_S`` (sweeps every second) and
    whose broker dead-letters after ``RESCUE_MAX_DELIVERY`` deliveries;
    the worker SIGKILLed holding running tasks, and restarted."""
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = cache_specs(gateway, worker, ("landcover",))
    env = {**handoff["env"],
           "AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT": str(RESCUE_TIMEOUT_S),
           "AI4E_PLATFORM_REAPER_INTERVAL": "1",
           "AI4E_PLATFORM_MAX_DELIVERY_COUNT": str(RESCUE_MAX_DELIVERY)}
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    restarted_log = out_dir / "rescue_worker_restarted.log"
    with control_plane_and_worker(out_dir, "rescue", models, routes, env,
                                  cp_port, wk_port, device) as (procs, logs):
        def restart():
            # The control-plane-and-worker block stops whichever worker
            # ``procs`` holds, with its log.
            logs["wk"] = restarted_log
            return start_child(
                ["worker", "--models", str(out_dir / "rescue_models.json"),
                 "--host", "127.0.0.1", "--port", str(wk_port), "--device",
                 device], restarted_log, env)

        run = asyncio.run(rescue_drive(gateway, worker, procs, logs, restart,
                                       bodies, env))
    for task_id, (i, result) in run.pop("results").items():
        check_histogram(result, want[i], lc_pixels(handoff))
    redriven = run.pop("redrive")["redriven"]
    if redriven != run["dead_lettered"]:
        raise AssertionError(f"15d: redrove {redriven} of "
                             f"{run['dead_lettered']} dead letters")
    run["redriven"] = redriven
    if run["requeued"] < run["running_at_kill"]:
        raise AssertionError(f"15d: {run['requeued']} rescues for "
                             f"{run['running_at_kill']} running tasks")
    by_model = launches_by_model(restarted_log.read_text(errors="replace"))
    run.pop("cp_metrics")
    run["launches_by_model_after_restart"] = by_model
    run["card"] = CARD.get("smi")
    log(f"rescue 15d: {json.dumps(run)}")
    return run


def phase_15(handoff: dict, kernels: list[dict], replay_7a_ms=None,
             device: str = "cuda") -> dict:
    """Phase 15: C8 on the card (a), result offload through the camera
    trap (b), the native cores on the main path (c), the reaper's rescue
    and the redrive verb (d)."""
    import gc

    log("phase 15: C8, result offload, the native cores, the rescue")
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report: dict = {"seconds_by_part": {}}
    for part, run in (("15a", lambda: phase_c8(handoff, replay_7a_ms,
                                               device)),
                      ("15b", lambda: phase_offload(handoff, device)),
                      ("15c", lambda: phase_native_cores(handoff, device)),
                      ("15d", lambda: phase_rescue(handoff, device))):
        t = time.perf_counter()
        report[part] = run()
        report["seconds_by_part"][part] = time.perf_counter() - t
    report["seconds"] = time.perf_counter() - t0
    by_run = {"15b " + tag: counts
              for tag, counts in report["15b"]["launches_by_model"].items()}
    for tag, _ in CORE_TURNS:
        by_run["15c " + tag] = report["15c"][tag]["launches_by_model"]
    by_run["15d after restart"] = \
        report["15d"]["launches_by_model_after_restart"]
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess",
                 "flash_attention"):
        if name in rows:
            rows[name]["launches_phase15"] = {
                "15a in process": report["15a"]["launches"].get(name, 0),
                **{run: sum(m.get(name, 0) for m in counts.values())
                   for run, counts in by_run.items()}}
    log(f"phase 15: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'card': CARD.get('smi')})}")
    return report


# -- phase 16: the journaled control plane and its HA pair ------------------

HA_FSYNC = "always"          # 16a: AI4E_TASKSTORE_FSYNC
FAILOVER_INTERVAL_S = 0.5    # 16b: AI4E_PLATFORM_FAILOVER_INTERVAL
FAILOVER_DOWN_AFTER = 3      # 16b: AI4E_PLATFORM_FAILOVER_DOWN_AFTER
HA_TRIES = 4                 # bursts tried until one is caught mid-way
HA_DEADLINE_S = 120          # a part's tasks all terminal within this
# Each client request's bound. One request to a SIGKILLed control plane
# hung for 63 s on the card (the sum of a connect's SYN retransmits),
# which held the whole failover behind one client.
HA_CONNECT_S = 2.0


async def ha_submit(http, base: str, body: bytes, deadline: float) -> str:
    """One tile to ``base``'s async route; a standby's 503 +
    ``X-Not-Primary`` or a refused connection is retried until
    ``deadline``."""
    import aiohttp

    timeout = aiohttp.ClientTimeout(total=30, sock_connect=HA_CONNECT_S)
    while True:
        try:
            async with http.post(base + LC_ASYNC, data=body, headers=OCTET,
                                 timeout=timeout) as r:
                if r.status == 200:
                    return (await r.json())["TaskId"]
                if not (r.status == 503 and r.headers.get("X-Not-Primary")):
                    raise AssertionError(f"{base}{LC_ASYNC} {r.status}: "
                                         f"{await r.text()}")
        except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"{base}: no primary took the task")
        await asyncio.sleep(0.05)


async def ha_watch(http, bases: list[str], task: dict,
                   deadline: float, outage: str | None = None) -> None:
    """Long-poll ``task["id"]`` at ``bases[0]`` to terminal, moving down
    ``bases`` when one refuses the connection (a single base is retried:
    it restarts); on completion its result is read at once. A 404 marks
    the task ``lost`` (the replica that answers never received it).
    ``outage`` (16a: the control plane's ``host:port``) accepts one path
    without a result, C12's: the worker's store write was refused while
    the control plane was down and its service shell then failed the task
    on the restarted one (``failed: Cannot connect to host <outage> ...``,
    ``tests/test_torch_restart.py``); the task's record goes to
    ``task["outage_failed"]`` for its caller to resubmit."""
    import aiohttp

    from ai4e_tpu_torch.taskstore import TaskStatus

    poll = aiohttp.ClientTimeout(total=15, sock_connect=HA_CONNECT_S)
    at = 0
    while time.monotonic() < deadline:
        base = bases[min(at, len(bases) - 1)]
        try:
            async with http.get(f"{base}/v1/taskmanagement/task/"
                                f"{task['id']}", params={"wait": "10"},
                                timeout=poll) as r:
                if r.status == 404:
                    task["lost"] = True
                    return
                if r.status != 200:
                    await asyncio.sleep(0.05)
                    continue
                record = await r.json()
            if TaskStatus.canonical(record["Status"]) not in \
                    TaskStatus.TERMINAL:
                continue
            task["status"] = record["Status"]
            async with http.get(base + "/v1/taskstore/result",
                                params={"taskId": task["id"]},
                                timeout=poll) as r:
                if r.status == 200:
                    task["raw"] = await r.read()
                else:
                    missing = r.status
            if "raw" not in task:
                # A completed task without its result: the record (and
                # ledger, where one is kept) go into the message, so the
                # run shows which path lost it.
                async with http.get(f"{base}/v1/taskmanagement/task/"
                                    f"{task['id']}", params={"ledger": "1"},
                                    timeout=poll) as r:
                    record_now = await r.text()
                if outage is not None and task["status"].startswith(
                        f"failed: Cannot connect to host {outage} "):
                    task["outage_failed"] = record_now
                    return
                raise AssertionError(f"result of {task['id']} at {base}: "
                                     f"{missing}; the task now: "
                                     f"{record_now[:4000]}")
            task["done_at"] = time.monotonic()
            task["base"] = base
            return
        except (aiohttp.ClientConnectionError, aiohttp.ClientPayloadError,
                asyncio.TimeoutError):
            at += 1
            await asyncio.sleep(0.05)
    raise AssertionError(f"task {task['id']} never finished: {task}")


async def ha_burst(http, base: str, bodies: list[bytes], first: int,
                   bases: list[str], deadline: float,
                   outage: str | None = None):
    """The bodies at once to ``base``; returns each task's dict and the
    watchers polling them (``outage``: ``ha_watch``'s)."""
    ids = await asyncio.gather(*(ha_submit(http, base, b, deadline)
                                 for b in bodies))
    tasks = [{"id": t, "i": first + i} for i, t in enumerate(ids)]
    watchers = [asyncio.create_task(ha_watch(http, bases, t, deadline,
                                             outage))
                for t in tasks]
    return tasks, watchers


HA_UNFINISHED = 4   # unfinished tasks a kill needs: the last batch may land


async def ha_catch(http, base: str, tasks: list[dict]) -> bool:
    """Wait until some task's result is read; then True when the store at
    ``base`` still holds ``HA_UNFINISHED`` unfinished tasks, False when
    the burst got too far first."""
    while True:
        if any("raw" in t for t in tasks):
            _, d = await http_json(http, "GET", base + "/v1/taskstore/depths")
            d = d.get(LC_QUEUE, {})
            return d.get("created", 0) + d.get("running", 0) >= HA_UNFINISHED
        await asyncio.sleep(0.002)


def journal_offline(path: Path, scratch: Path) -> dict:
    """What a restart replays from a copy of the journal at ``path``."""
    import shutil

    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.taskstore.store import JournaledTaskStore

    copy = scratch / (path.name + ".offline")
    shutil.copyfile(path, copy)
    store = JournaledTaskStore(str(copy), metrics=MetricsRegistry())
    try:
        return {"unfinished": {t.task_id for t in store.unfinished_tasks()},
                "results": {t: store.get_result(t)
                            for t in store.replayed_task_ids},
                "salvages": store.journal_stats()["salvages"]}
    finally:
        store.close()
        copy.unlink()


def logged_json(log_text: str, marker: str) -> dict:
    lines = [line for line in log_text.splitlines() if marker in line]
    if not lines:
        raise AssertionError(f"no {marker!r} line in the log")
    return json.loads(lines[-1].split(marker, 1)[1])


async def restart_drive(gateway: str, worker: str, procs: dict, logs: dict,
                        restart, bodies: list[bytes], journal: Path) -> dict:
    """16a's client: bursts until one is caught with tasks completed and
    others not; the control plane SIGKILLed and restarted on its journal;
    every task awaited through the restart."""
    import aiohttp
    import signal

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        deadline = time.monotonic() + HA_DEADLINE_S
        outage = gateway.split("//", 1)[1]
        tasks, watchers = [], []
        for attempt in range(HA_TRIES):
            burst, ws = await ha_burst(http, gateway, bodies, 0, [gateway],
                                       deadline, outage)
            tasks += burst
            watchers += ws
            if await ha_catch(http, gateway, burst):
                break
            await asyncio.gather(*ws)
        else:
            raise AssertionError(f"16a: no burst of {HA_TRIES} was caught "
                                 "mid-way")
        procs["cp"].send_signal(signal.SIGKILL)
        procs["cp"].wait(timeout=30)
        t_kill = time.monotonic()
        before = {t["id"]: t["raw"] for t in tasks if "raw" in t}
        offline = await asyncio.to_thread(journal_offline, journal,
                                          journal.parent)
        procs["cp"] = restart()
        await wait_healthy(http, gateway + "/healthz", procs["cp"],
                           logs["cp"])
        back_s = time.monotonic() - t_kill
        await asyncio.gather(*watchers)
        resubmitted = []
        for t in tasks:
            record = t.pop("outage_failed", None)
            if record is None:
                continue
            # C12: failed by its worker's refused store write; the same
            # body again, now held like every other task.
            log(f"16a: {t['id']} failed by a store write refused during "
                f"the restart (C12), resubmitted; the task: {record[:2000]}")
            resubmitted.append(t["id"])
            t.pop("status")
            t["id"] = await ha_submit(http, gateway, bodies[t["i"]],
                                      deadline)
            await ha_watch(http, [gateway], t, deadline)
        reread = {t: await result_bytes(http, gateway, t) for t in before}
        async with http.get(gateway + "/metrics") as r:
            cp_metrics = await r.text()
    after = [t["done_at"] - t_kill for t in tasks if t["done_at"] > t_kill]
    return {"tasks": tasks, "before": before, "reread": reread,
            "offline": offline, "attempt": attempt,
            "resubmitted_after_refused_write": resubmitted,
            "kill_to_healthy_s": back_s,
            "kill_to_first_completion_s": min(after) if after else None,
            "cp_metrics": cp_metrics}


def phase_restart(handoff: dict, device: str = "cuda") -> dict:
    """16a: land cover behind one control plane journaled with
    ``HA_FSYNC``, SIGKILLed mid-burst and restarted on its journal."""
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = cache_specs(gateway, worker, ("landcover",))
    journal = out_dir / "restart_journal.jsonl"
    for p in (journal, out_dir / "restart_journal.jsonl.salvage.json"):
        p.unlink(missing_ok=True)
    env = {**handoff["env"], "AI4E_PLATFORM_JOURNAL_PATH": str(journal),
           "AI4E_TASKSTORE_FSYNC": HA_FSYNC}
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    restarted_log = out_dir / "restart_control_plane_restarted.log"
    with control_plane_and_worker(out_dir, "restart", models, routes, env,
                                  cp_port, wk_port, device) as (procs, logs):
        first_log = logs["cp"]

        def restart():
            logs["cp"] = restarted_log
            return start_child(
                ["control-plane", "--routes",
                 str(out_dir / "restart_routes.json"), "--port",
                 str(cp_port)], restarted_log, env)

        run = asyncio.run(restart_drive(gateway, worker, procs, logs,
                                        restart, bodies, journal))
    cp_log = restarted_log.read_text(errors="replace")
    tasks = run.pop("tasks")
    for t in tasks:
        if t.get("status") != LC_DONE:
            raise AssertionError(f"16a: task {t['id']} ended {t}")
        check_histogram(json.loads(t["raw"]), want[t["i"]],
                        lc_pixels(handoff))
    before, reread = run.pop("before"), run.pop("reread")
    offline = run.pop("offline")
    if not before:
        raise AssertionError("16a: no result was read before the kill")
    for task_id, raw in before.items():
        if reread[task_id] != raw:
            raise AssertionError(f"16a: {task_id}'s result changed across "
                                 "the restart")
        if offline["results"].get(task_id, (None,))[0] != raw:
            raise AssertionError(f"16a: the journal lacks {task_id}'s "
                                 "acknowledged result")
    reseed = [line for line in cp_log.splitlines()
              if "re-seeded" in line and "unfinished" in line]
    if not reseed:
        raise AssertionError("16a: the restarted control plane logged no "
                             "re-seed")
    reseeded = int(reseed[-1].split("re-seeded ", 1)[1].split()[0])
    if reseeded != len(offline["unfinished"]) or reseeded < 1:
        raise AssertionError(f"16a: re-seeded {reseeded}, the journal holds "
                             f"{len(offline['unfinished'])} unfinished")
    stats = logged_json(cp_log, "journal stats ")
    cp_metrics = run.pop("cp_metrics")
    run.update({
        "tasks": len(tasks), "read_before_kill": len(before),
        "unfinished_at_kill": len(offline["unfinished"]),
        "reseeded": reseeded, "salvaged_at_restart": offline["salvages"],
        "journal_stats_restarted": stats,
        "fsyncs_restarted": metric_sum(cp_metrics,
                                       "ai4e_journal_fsyncs_total",
                                       policy=HA_FSYNC),
        "appends_restarted": metric_sum(cp_metrics,
                                        "ai4e_journal_append_seconds_count"),
        "posture": next((line.split("control plane on ", 1)[1]
                         for line in first_log.read_text(
                             errors="replace").splitlines()
                         if "control plane on " in line), None),
        "launches_by_model": launches_by_model(
            logs["wk"].read_text(errors="replace")),
        "card": CARD.get("smi")})
    # The worker's store client gives a replica set this long before a
    # write fails.
    from ai4e_tpu_torch.service.task_manager import (FAILOVER_CYCLES,
                                                     FAILOVER_DELAY_S)

    window = FAILOVER_CYCLES * FAILOVER_DELAY_S
    slow = run["kill_to_first_completion_s"]
    run["over_store_window"] = slow is not None and slow > window
    log(f"restart 16a: {json.dumps(run)}")
    return run


@contextlib.contextmanager
def ha_pair_and_worker(out_dir: Path, models: dict, routes: dict, envs: dict,
                       wk_port: int, device: str):
    """The HA pair's two control planes and the worker as child processes;
    every one still running stopped when the block ends (SIGTERM, exit 0),
    any that did not stop killed."""
    (out_dir / "ha_models.json").write_text(json.dumps(models))
    (out_dir / "ha_routes.json").write_text(json.dumps(routes))
    logs = {name: out_dir / f"ha_{name}.log"
            for name in ("primary", "standby", "wk")}
    procs = {}
    try:
        for name in ("primary", "standby"):
            procs[name] = start_child(
                ["control-plane", "--routes", str(out_dir / "ha_routes.json"),
                 "--port", envs[name]["port"]], logs[name], envs[name]["env"])
        procs["wk"] = start_child(
            ["worker", "--models", str(out_dir / "ha_models.json"),
             "--host", "127.0.0.1", "--port", str(wk_port), "--device",
             device], logs["wk"], envs["wk"]["env"])
        yield procs, logs
        for name in ("wk", "old", "standby"):
            if name in procs and procs[name].poll() is None:
                stop_child(procs[name], logs[name], f"16b {name}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)


async def role_of(http, base: str) -> dict:
    _, role = await http_json(http, "GET", base + "/v1/taskstore/role")
    return role


def journal_first_record_ends(path: Path, task_ids: list[str]) -> dict:
    """For each task, the byte offset in the journal at ``path`` where the
    first line naming it ends (None: no line names it)."""
    ends: dict = dict.fromkeys(task_ids)
    offset = 0
    with open(path, "rb") as f:
        for line in f:
            offset += len(line)
            for tid in task_ids:
                if ends[tid] is None and tid.encode() in line:
                    ends[tid] = offset
    return ends


async def failover_drive(primary: str, standby: str, worker: str,
                         procs: dict, logs: dict, restart_old,
                         bodies: list[bytes], primary_journal: Path) -> dict:
    """16b's client: a burst to the primary, the primary SIGKILLed
    mid-burst, every task awaited at the standby (resubmitted there when it
    never arrived), then the old primary restarted and fenced.
    ``primary_journal`` is the primary's journal, read after the kill."""
    import aiohttp
    import signal

    out: dict = {}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        for name, url in (("primary", primary), ("standby", standby)):
            await wait_healthy(http, url + "/healthz", procs[name],
                               logs[name])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        deadline = time.monotonic() + HA_DEADLINE_S
        # One task first, and the standby caught up with it: a standby
        # that never synced does not promote (its first long poll of an
        # empty journal returns only with the first record).
        tasks, _ = await ha_burst(http, primary, bodies[:1], 0, [primary],
                                  deadline)
        await asyncio.gather(*_)
        while True:
            async with http.get(standby + "/metrics") as r:
                text = await r.text()
            if (metric_sum(text, "ai4e_replication_offset_bytes") > 0
                    and metric_sum(text, "ai4e_replication_lag_bytes") == 0):
                break
            if time.monotonic() > deadline:
                raise AssertionError("16b: the standby never synced:\n"
                                     + tail(logs["standby"]))
            await asyncio.sleep(0.05)
        watchers = []
        for attempt in range(HA_TRIES):
            burst, ws = await ha_burst(http, primary, bodies, 0,
                                       [primary, standby], deadline)
            tasks += burst
            watchers += ws
            if await ha_catch(http, primary, burst):
                break
            await asyncio.gather(*ws)
        else:
            raise AssertionError(f"16b: no burst of {HA_TRIES} was caught "
                                 "mid-way")
        async with http.get(standby + "/metrics") as r:
            standby_metrics = await r.text()
        # The gauge moves only when a poll returns; the primary's journal
        # size says what the standby has not seen.
        async with http.get(primary + "/v1/taskstore/journal",
                            params={"offset": "0", "wait": "0",
                                    "limit": "1"}) as r:
            out["primary_journal_bytes_at_kill"] = int(
                r.headers["X-Journal-Size"])
        procs["primary"].send_signal(signal.SIGKILL)
        procs["primary"].wait(timeout=30)
        t_kill = time.monotonic()
        out["lag_bytes_before_kill"] = metric_sum(
            standby_metrics, "ai4e_replication_lag_bytes")
        out["offset_bytes_before_kill"] = metric_sum(
            standby_metrics, "ai4e_replication_offset_bytes")
        out["completed_before_kill"] = sum("raw" in t for t in tasks)
        while (await role_of(http, standby)).get("role") != "primary":
            if time.monotonic() > deadline:
                raise AssertionError("16b: the standby never promoted:\n"
                                     + tail(logs["standby"]))
            await asyncio.sleep(0.02)
        out["kill_to_promotion_s"] = time.monotonic() - t_kill
        await asyncio.gather(*watchers)
        # A task the primary answered before the kill may never have
        # reached the standby (replication is asynchronous): lost to lag,
        # but only if its first journal record ends past the bytes the
        # standby had absorbed before the kill. One the standby had
        # absorbed, or the primary never journaled, is a fault.
        answered_then_lost = []
        for t in tasks:
            if "raw" in t and not t.get("lost"):
                async with http.get(f"{standby}/v1/taskmanagement/task/"
                                    f"{t['id']}") as r:
                    if r.status == 404:
                        answered_then_lost.append(t)
        ends = journal_first_record_ends(
            primary_journal, [t["id"] for t in answered_then_lost])
        absorbed = out["offset_bytes_before_kill"]
        unexplained = {tid: end for tid, end in ends.items()
                       if end is None or end <= absorbed}
        if unexplained:
            raise AssertionError(
                f"16b: tasks answered before the kill and unknown to the new "
                f"primary, whose first journal record ends at or before the "
                f"{absorbed} bytes the standby had absorbed (None: never "
                f"journaled): {unexplained}")
        for t in answered_then_lost:
            t["lost"] = True
        out["answered_before_kill_then_lost"] = len(answered_then_lost)
        out["answered_then_lost_record_ends"] = sorted(ends.values())
        # Tasks the standby never received: the client sends them again.
        lost = [t for t in tasks if t.get("lost")]
        again = []
        for t in lost:
            new_id = await ha_submit(http, standby, bodies[t["i"]], deadline)
            again.append({"id": new_id, "i": t["i"], "was": t["id"]})
        await asyncio.gather(*(ha_watch(http, [standby], t, deadline)
                               for t in again))
        out["lost_to_lag"] = len(lost)
        out["tasks"] = [t for t in tasks if not t.get("lost")] + again
        after = [t["done_at"] - t_kill for t in out["tasks"]
                 if t["done_at"] > t_kill]
        out["kill_to_first_completion_s"] = min(after) if after else None
        out["completed_after_kill"] = len(after)
        out["worker_restarted"] = procs["wk"].poll() is not None
        # The old primary, from its stale config, on its old port.
        t0 = time.monotonic()
        procs["old"] = restart_old()
        await wait_healthy(http, primary + "/healthz", procs["old"],
                           logs["old"])
        out["old_healthy_s"] = time.monotonic() - t0
        new_role = await role_of(http, standby)
        while True:
            role = await role_of(http, primary)
            if role.get("role") == "follower" and role.get("replicating"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"16b: the old primary was never "
                                     f"fenced: {role}\n{tail(logs['old'])}")
            await asyncio.sleep(0.02)
        out["restart_to_fenced_s"] = time.monotonic() - t0
        out["old_epoch"] = role["epoch"]
        out["new_epoch"] = new_role["epoch"]
        writes = {}
        for path, kw in (("/v1/taskstore/upsert",
                          {"json": {"TaskId": "stale", "Endpoint": "/v1/x"}}),
                         (LC_ASYNC, {"data": bodies[0], "headers": OCTET})):
            async with http.post(primary + path, **kw) as r:
                writes[path] = (r.status, r.headers.get("X-Not-Primary"),
                                r.headers.get("X-Store-Epoch"))
        out["old_writes"] = writes
        # Caught up: the old primary's replica head is the new primary's
        # journal head and its lag is 0.
        while True:
            role = await role_of(http, primary)
            new_role = await role_of(http, standby)
            async with http.get(primary + "/metrics") as r:
                old_metrics = await r.text()
            lag = metric_sum(old_metrics, "ai4e_replication_lag_bytes")
            if (role.get("replica_chain_head") == new_role["chain_head"]
                    and lag == 0):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"16b: the old primary never caught "
                                     f"up: {role} {new_role} lag {lag}")
            await asyncio.sleep(0.05)
        out["restart_to_caught_up_s"] = time.monotonic() - t0
        out["old_offset_bytes"] = metric_sum(old_metrics,
                                             "ai4e_replication_offset_bytes")
        async with http.get(standby + "/v1/taskstore/journal",
                            params={"offset": "0", "wait": "0",
                                    "limit": "1"}) as r:
            out["new_primary_journal_bytes"] = int(
                r.headers["X-Journal-Size"])
        # Deliveries the stale primary made before its fence landed.
        out["stale_deliveries"] = metric_sum(old_metrics,
                                             "ai4e_dispatch_total")
        # Every task terminal again (a stale delivery runs a task once
        # more), each result read from the new primary.
        deadline = time.monotonic() + 60
        while True:
            _, d = await http_json(http, "GET",
                                   standby + "/v1/taskstore/depths")
            d = d.get(LC_QUEUE, {})
            if d.get("created", 0) + d.get("running", 0) == 0:
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"16b: tasks left unfinished: {d}")
            await asyncio.sleep(0.1)
        out["final"] = {t["id"]: (t["i"], await http_json(
            http, "GET", f"{standby}/v1/taskmanagement/task/{t['id']}"))
            for t in out["tasks"]}
        out["final_raw"] = {}
        missing = []
        for t in out["tasks"]:
            async with http.get(standby + "/v1/taskstore/result",
                                params={"taskId": t["id"]}) as r:
                status, raw = r.status, await r.read()
            if status != 200:
                await failover_missing_result(http, primary, standby, t,
                                              status, old_metrics)
                missing.append(t)
                continue
            out["final_raw"][t["id"]] = raw
        # A completed task whose result the new primary lacks (C10, JAX's
        # design as well: the worker's result client still wrote to the
        # restarted, not yet fenced old primary): sent again, and the
        # resubmission held to the same answer as every other task.
        again = []
        for t in missing:
            new_id = await ha_submit(http, standby, bodies[t["i"]],
                                     time.monotonic() + HA_DEADLINE_S)
            again.append({"id": new_id, "i": t["i"], "was": t["id"]})
        await asyncio.gather(*(ha_watch(http, [standby], t,
                                        time.monotonic() + HA_DEADLINE_S)
                               for t in again))
        for t in again:
            out["final"][t["id"]] = (t["i"], await http_json(
                http, "GET", f"{standby}/v1/taskmanagement/task/{t['id']}"))
            out["final_raw"][t["id"]] = t["raw"]
            del out["final"][t["was"]]
        out["results_lost_to_stale_primary"] = [t["was"] for t in again]
        out["tasks"] = [t for t in out["tasks"] if t not in missing] + again
        out["attempt"] = attempt
    return out


async def failover_missing_result(http, old: str, new: str, task: dict,
                                  status: int, old_metrics: str) -> None:
    """C10's evidence for a task whose result the new primary does not
    answer: its record and ledger, both control planes' depths and the
    stale primary's deliveries on the task's queue. Raises unless the
    record is completed (the loss C10 names, which the caller resubmits)."""
    record = await fetch_record(http, new, task["id"])
    depths = {name: (await http_json(http, "GET",
                                     url + "/v1/taskstore/depths"))[1]
              for name, url in (("old", old), ("new", new))}
    queue = (record.get("Endpoint") or LC_QUEUE) if isinstance(
        record, dict) else LC_QUEUE
    path = "/" + queue.split("://", 1)[-1].split("/", 1)[-1]
    stale = [line for line in old_metrics.splitlines()
             if line.startswith("ai4e_dispatch_total")
             and (path in line or LC_QUEUE in line)]
    log(f"failover 16b: the result of task {task['id']} (tile "
        f"{task['i']}{', resubmitted for ' + task['was'] if 'was' in task else ''})"
        f" answered {status}; record with ledger "
        f"{json.dumps(record)}; depths {json.dumps(depths)}; the stale "
        f"primary's deliveries {json.dumps(stale)}")
    if not (isinstance(record, dict)
            and str(record.get("Status", "")).startswith("completed")):
        raise AssertionError(f"16b: result of {task['id']}: {status}")


def phase_failover(handoff: dict, device: str = "cuda") -> dict:
    """16b: land cover behind a primary and a standby control plane, the
    worker's ``taskstore`` the pair; the primary SIGKILLed mid-burst, then
    restarted from its stale config."""
    out_dir = handoff["out_dir"]
    ports = {name: free_port() for name in ("primary", "standby", "wk")}
    urls = {name: f"http://127.0.0.1:{port}" for name, port in ports.items()}
    models, routes = cache_specs(urls["primary"], urls["wk"], ("landcover",))
    models["taskstore"] = f"{urls['primary']},{urls['standby']}"
    envs = {}
    for name in ("primary", "standby"):
        journal = out_dir / f"ha_{name}.jsonl"
        journal.unlink(missing_ok=True)
        env = {**handoff["env"],
               "AI4E_PLATFORM_JOURNAL_PATH": str(journal),
               "AI4E_PLATFORM_ADVERTISE_URL": urls[name],
               "AI4E_PLATFORM_FAILOVER_INTERVAL": str(FAILOVER_INTERVAL_S),
               "AI4E_PLATFORM_FAILOVER_DOWN_AFTER": str(FAILOVER_DOWN_AFTER)}
        if name == "standby":
            env["AI4E_PLATFORM_REPLICATE_FROM"] = urls["primary"]
        envs[name] = {"env": env, "port": str(ports[name])}
    envs["wk"] = {"env": handoff["env"]}
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    with ha_pair_and_worker(out_dir, models, routes, envs, ports["wk"],
                            device) as (procs, logs):
        def restart_old():
            logs["old"] = out_dir / "ha_primary_restarted.log"
            return start_child(
                ["control-plane", "--routes", str(out_dir / "ha_routes.json"),
                 "--port", str(ports["primary"])], logs["old"],
                envs["primary"]["env"])

        run = asyncio.run(failover_drive(urls["primary"], urls["standby"],
                                         urls["wk"], procs, logs,
                                         restart_old, bodies,
                                         out_dir / "ha_primary.jsonl"))
    pixels = lc_pixels(handoff)
    for task_id, (i, (status, record)) in run.pop("final").items():
        if status != 200 or record["Status"] != LC_DONE:
            raise AssertionError(f"16b: task {task_id} ended {record}")
        check_histogram(json.loads(run["final_raw"][task_id]), want[i],
                        pixels)
    for t in run["tasks"]:
        check_histogram(json.loads(t["raw"]), want[t["i"]], pixels)
    run.pop("final_raw")
    run["tasks"] = len(run["tasks"])
    if run["worker_restarted"]:
        raise AssertionError("16b: the worker exited during the failover")
    if run["completed_after_kill"] < 1:
        raise AssertionError("16b: no task completed after the kill")
    if run["old_epoch"] != run["new_epoch"] or run["new_epoch"] < 1:
        raise AssertionError(f"16b: old primary at epoch {run['old_epoch']},"
                             f" the new primary at {run['new_epoch']}")
    for path, (status, not_primary, _) in run["old_writes"].items():
        if status != 503 or not_primary != "1":
            raise AssertionError(f"16b: the fenced primary answered {path} "
                                 f"{status} (X-Not-Primary {not_primary})")
    standby_log = logs["standby"].read_text(errors="replace")
    if "promoted to primary" not in standby_log:
        raise AssertionError("16b: the standby logged no promotion")
    run["launches_by_model"] = launches_by_model(
        logs["wk"].read_text(errors="replace"))
    run["card"] = CARD.get("smi")
    log(f"failover 16b: {json.dumps(run)}")
    return run


def phase_16(handoff: dict, kernels: list[dict],
             device: str = "cuda") -> dict:
    """Phase 16: the journaled control plane's restart (a), the HA pair's
    failover and fencing (b)."""
    log("phase 16: the journaled control plane and its HA pair")
    t0 = time.perf_counter()
    report: dict = {"seconds_by_part": {}}
    for part, run in (("16a", lambda: phase_restart(handoff, device)),
                      ("16b", lambda: phase_failover(handoff, device))):
        t = time.perf_counter()
        report[part] = run()
        report["seconds_by_part"][part] = time.perf_counter() - t
    report["seconds"] = time.perf_counter() - t0
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess"):
        counts = {part: report[part]["launches_by_model"].get(
            "landcover", {}).get(name, 0) for part in ("16a", "16b")}
        if device == "cuda" and min(counts.values()) < 1:
            raise AssertionError(f"phase 16: {name} never launched in a "
                                 f"worker: {counts}")
        if name in rows:
            rows[name]["launches_phase16"] = counts
    log(f"phase 16: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'card': CARD.get('smi')})}")
    return report


# -- phase 17: the sharded task store ----------------------------------------

SHARDS = 4
# 17a's turns, (shards, replicas a shard): 4 shards with their replicas,
# 1 shard, and 4 shards without replicas, which parts what the sharding
# costs from what the replicas' absorbs cost. One turn each: the whole
# script must stay inside its time limit.
SHARD_TURNS = ((SHARDS, 1), (1, 0), (SHARDS, 0))
SHARD_DEADLINE_S = 120       # a part's tasks all terminal within this
SHARD_CAUGHT_UP_S = 30       # 17a: replicas at their primaries' heads
# 17b's long polls: a poll parked on a shard's feed when its slot moves
# hears the terminal event on the new owner's feed only after it times out
# and reads the store again.
SHARD_POLL_S = "2"


def shard_specs(gateway: str, worker: str) -> tuple[dict, dict]:
    """Land cover of the deploy spec behind ``gateway``, its async route at
    routes.json's fixed concurrency: an ``autoscale`` route is refused on a
    sharded platform without orchestration."""
    models, routes = cache_specs(gateway, worker, ("landcover",))
    for api in routes["apis"]:
        api.pop("autoscale", None)
    return models, routes


def shard_owners(task_ids: list[str], slots: list[int]) -> dict:
    """Each task's shard under the ring's slot table."""
    from ai4e_tpu_torch.taskstore.sharding import stable_hash

    return {t: slots[stable_hash(t) % len(slots)] for t in task_ids}


def posture_line(log_text: str) -> str:
    line = next((x for x in log_text.splitlines()
                 if "control plane on " in x), None)
    if line is None:
        raise AssertionError("the control plane logged no startup line")
    return line.split("control plane on ", 1)[1]


async def shard_turn_drive(gateway: str, worker: str, procs: dict,
                           logs: dict, bodies: list[bytes],
                           shards: int) -> dict:
    """17a's client for one turn: the 64 tiles at once with long polls, each
    task's ledger; on a sharded store the topology once every replica (if
    any) reached its primary's chain head."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"],
                           logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        out = await drive_gateway(http, gateway, LC_SYNC, bodies, 0, LC_DONE,
                                  worker)
        t_done = time.monotonic()
        out["records"] = [await fetch_record(http, gateway, t)
                          for t in out["task_ids"]]
        if shards > 1:
            while True:
                _, topo = await http_json(http, "GET",
                                          gateway + "/v1/taskstore/shards")
                if all(set(g["replica_chain_heads"]) <= {g["chain_head"]}
                       for g in topo["groups"]):
                    break
                if time.monotonic() > t_done + SHARD_CAUGHT_UP_S:
                    raise AssertionError(f"17a: replicas never caught up: "
                                         f"{topo}")
                await asyncio.sleep(0.05)
            out["replicas_caught_up_s"] = time.monotonic() - t_done
            out["topology"] = topo
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
    return out


def check_shard_turn(handoff: dict, run: dict, cp_log: str, shards: int,
                     replicas: int, want: np.ndarray) -> dict:
    """17a's gates for one turn; returns its record."""
    pixels = lc_pixels(handoff)
    for i, result in enumerate(run["results"]):
        check_histogram(result, want[i], pixels)
    hops = ledger_hops(run["records"], ONE_STAGE)
    posture = posture_line(cp_log)
    if "crc32c=native" not in posture:
        raise AssertionError(f"17a: the journal checksum is not the native "
                             f"one: {posture}")
    if (shards > 1) != (f"task store sharded x{shards}" in posture):
        raise AssertionError(f"17a: startup line {posture!r} for {shards} "
                             "shards")
    outcomes = dispatch_outcomes(run["cp_metrics"])
    if outcomes.get("failed") or outcomes.get("dead_letter"):
        raise AssertionError(f"17a: deliveries {outcomes}")
    out = {"shards": shards, "replicas": replicas,
           "tasks": len(run["results"]),
           "tasks_per_s": run["async_requests_per_s"],
           "task_p50_ms": run["task_p50_ms"],
           "task_p95_ms": run["task_p95_ms"],
           "published_popped_ms": hops["published->popped"],
           "hops": hops, "backpressure": outcomes.get("backpressure", 0.0),
           "deliveries": outcomes}
    if shards > 1:
        topo = run["topology"]
        groups = topo["groups"]
        if topo["shards"] != shards or len(groups) != shards:
            raise AssertionError(f"17a: topology {topo}")
        for g in groups:
            if (g["epoch"] != 0 or g["dead"] or g["replicas"] != replicas
                    or not g["chain_head"]):
                raise AssertionError(f"17a: shard {g}")
        owners = shard_owners(run["task_ids"], topo["slots"])
        by_shard = [sum(o == s for o in owners.values())
                    for s in range(shards)]
        if min(by_shard) < 1:
            raise AssertionError(f"17a: a shard holds no task: {by_shard}")
        out.update({"tasks_by_shard": by_shard,
                    "feed_seq": [g["feed_seq"] for g in groups],
                    "chain_heads": [g["chain_head"] for g in groups],
                    "replicas_caught_up_s": run["replicas_caught_up_s"]})
    return out


def phase_shard_pair(handoff: dict, wk: dict, cp_port: int) -> dict:
    """17a: land cover behind journaled control planes (the observability
    layer on) of 4 shards with one replica each, of 1 shard, and of 4
    shards without replicas, in turns ``SHARD_TURNS`` on one worker, each a
    child process."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    turns = []
    for k, (shards, replicas) in enumerate(SHARD_TURNS):
        t0 = time.perf_counter()
        journal = out_dir / f"shards_{k}.journal"
        for p in out_dir.glob(journal.name + "*"):
            p.unlink()
        env = {**handoff["env"], "AI4E_PLATFORM_TASK_SHARDS": str(shards),
               "AI4E_PLATFORM_TASK_SHARD_REPLICAS": str(replicas),
               "AI4E_PLATFORM_JOURNAL_PATH": str(journal),
               "AI4E_PLATFORM_OBSERVABILITY": "1"}
        logs = {"cp": out_dir / f"shards_{k}_control_plane.log",
                "wk": wk["log"]}
        procs = {"cp": start_child(
            ["control-plane", "--routes", str(wk["routes"]), "--port",
             str(cp_port)], logs["cp"], env), "wk": wk["proc"]}
        try:
            run = asyncio.run(shard_turn_drive(
                wk["gateway"], wk["url"], procs, logs, bodies, shards))
            stop_child(procs["cp"], logs["cp"], f"17a turn {k}")
        finally:
            if procs["cp"].poll() is None:
                procs["cp"].kill()
                procs["cp"].wait(timeout=30)
        turn = check_shard_turn(handoff, run,
                                logs["cp"].read_text(errors="replace"),
                                shards, replicas, want)
        turn["seconds"] = time.perf_counter() - t0
        log(f"shards 17a turn {k}: {json.dumps({x: y for x, y in turn.items() if x != 'hops'})}")
        turns.append(turn)

    def arm(turn: dict) -> str:
        return (str(turn["shards"]) if turn["shards"] == 1 or turn["replicas"]
                else f"{turn['shards']} without replicas")

    pair = {}
    for key, q in (("tasks_per_s", None), ("task_p50_ms", None),
                   ("task_p95_ms", None), ("published_popped_ms", "p50"),
                   ("published_popped_ms", "p95"), ("backpressure", None)):
        by_arm: dict = {}
        for t in turns:
            by_arm.setdefault(arm(t), []).append(t[key][q] if q else t[key])
        med = {a: statistics.median(v) for a, v in by_arm.items()}
        one = med["1"]
        pair[key if q is None else f"{key}_{q}"] = {
            a: {"median": m, "vs_1": m / one if one else None}
            for a, m in med.items()}
    return {"turns": turns, "pair": pair}


class ThreadedControlPlane:
    """The port's control plane, built by its own ``build_control_plane``
    from ``env`` and ``routes`` (or ``platform``, assembled by the caller
    with the task store's HTTP surface on its gateway), served on an event
    loop of its own in a thread of this process (17b reaches into its
    store); started on entry, stopped and its store closed on exit."""

    def __init__(self, env: dict, routes: dict, port: int, platform=None):
        import threading

        from ai4e_tpu_torch.cli import build_control_plane
        from ai4e_tpu_torch.config import FrameworkConfig

        if platform is None:
            config = FrameworkConfig.from_env(env)
            config.gateway.host, config.gateway.port = "127.0.0.1", port
            platform = build_control_plane(config, routes)
        self.platform = platform
        self.port = port
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.runner = None

    def call(self, fn, *args):
        """``fn(*args)`` on the control plane's loop, as its handlers run."""
        async def on_loop():
            return fn(*args)
        return asyncio.run_coroutine_threadsafe(on_loop(),
                                                self.loop).result(60)

    def run(self, coro):
        """Await ``coro`` on the control plane's loop."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(60)

    async def _start(self) -> None:
        from aiohttp import web

        self.runner = web.AppRunner(self.platform.gateway.app)
        await self.runner.setup()
        await web.TCPSite(self.runner, "127.0.0.1", self.port).start()
        await self.platform.start()

    async def _stop(self) -> None:
        await self.platform.stop()
        if self.runner is not None:
            await self.runner.cleanup()
        self.platform.store.close()

    def __enter__(self):
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self._start(),
                                         self.loop).result(60)
        return self

    def __exit__(self, *exc) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self._stop(),
                                             self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


async def shard_watch(http, gateway: str, task: dict,
                      deadline: float) -> None:
    """Long-poll one task to terminal in ``SHARD_POLL_S`` s polls, then
    read its result; a 404 is a lost task."""
    import aiohttp

    from ai4e_tpu_torch.taskstore import TaskStatus

    poll = aiohttp.ClientTimeout(total=15, sock_connect=HA_CONNECT_S)
    while time.monotonic() < deadline:
        try:
            async with http.get(f"{gateway}/v1/taskmanagement/task/"
                                f"{task['id']}", params={"wait": SHARD_POLL_S},
                                timeout=poll) as r:
                if r.status != 200:
                    raise AssertionError(f"17b: task {task['id']} answered "
                                         f"{r.status}: {await r.text()}")
                record = await r.json()
            if TaskStatus.canonical(record["Status"]) not in \
                    TaskStatus.TERMINAL:
                continue
            task["done_at"] = time.monotonic()
            task["status"] = record["Status"]
            task["raw"] = await result_bytes(http, gateway, task["id"])
            return
        except (aiohttp.ClientConnectionError, asyncio.TimeoutError):
            await asyncio.sleep(0.05)
    raise AssertionError(f"17b: task {task['id']} never finished: {task}")


def shard_target(store, tasks: list[dict]):
    """``(victim, slot, src, dest)`` once some task's result was read while
    one shard holds ``HA_UNFINISHED`` unfinished tasks of the burst and a
    slot of another shard at least one; else None."""
    from ai4e_tpu_torch.taskstore import TaskStatus

    unfinished = []
    for t in tasks:
        try:
            rec = store.get(t["id"])
        except KeyError:
            continue
        if rec.canonical_status not in TaskStatus.TERMINAL:
            unfinished.append(t["id"])
    by_shard = {}
    for tid in unfinished:
        by_shard.setdefault(store.shard_for(tid), []).append(tid)
    if not by_shard:
        return None
    victim = max(by_shard, key=lambda s: len(by_shard[s]))
    if len(by_shard[victim]) < HA_UNFINISHED:
        return None
    slots = {}
    for tid in unfinished:
        slot = store.ring.slot_for(tid)
        if store.ring.shard_of_slot(slot) != victim:
            slots[slot] = slots.get(slot, 0) + 1
    if not slots:
        return None
    slot = max(slots, key=slots.get)
    src = store.ring.shard_of_slot(slot)
    dest = next(s for s in range(store.ring.shards) if s not in (src, victim))
    return victim, slot, src, dest


async def shard_chaos_drive(cp: ThreadedControlPlane, worker: str, wk: dict,
                            bodies: list[bytes]) -> dict:
    """17b's client: bursts until one is caught mid-way, then a shard
    primary killed (on the control plane's loop, as a SIGKILL between two
    requests) and a slot holding unfinished tasks moved to a third shard
    (from another thread, under load); every task awaited."""
    import aiohttp

    store = cp.platform.store
    gateway = f"http://127.0.0.1:{cp.port}"
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", wk["proc"],
                           wk["log"])
        deadline = time.monotonic() + SHARD_DEADLINE_S
        tasks, watchers, target = [], [], None
        for attempt in range(HA_TRIES):
            ids = await asyncio.gather(*(ha_submit(http, gateway, b, deadline)
                                         for b in bodies))
            burst = [{"id": t, "i": i} for i, t in enumerate(ids)]
            ws = [asyncio.create_task(shard_watch(http, gateway, t,
                                                  deadline)) for t in burst]
            tasks += burst
            watchers += ws
            while not any("raw" in t for t in burst):
                await asyncio.sleep(0.002)
            target = shard_target(store, burst)
            if target is not None:
                break
            await asyncio.gather(*ws)
        else:
            raise AssertionError(f"17b: no burst of {HA_TRIES} was caught "
                                 "mid-way")
        victim, slot, src, dest = target
        before = {t["id"]: t["raw"] for t in tasks if "raw" in t}
        old = store.groups[victim].active
        pre_epoch = store.groups[victim].epoch
        in_slot = [t["id"] for t in tasks
                   if store.ring.slot_for(t["id"]) == slot]
        async def promoted() -> float:
            # The next write routed to the dead shard promotes inline.
            while (store.groups[victim].active is old
                   or store.groups[victim].dead):
                if time.monotonic() > deadline:
                    raise AssertionError("17b: the killed shard never "
                                         "promoted")
                await asyncio.sleep(0.001)
            return time.monotonic()

        t_kill = time.monotonic()
        cp.call(store.kill_shard_primary, victim)
        promotion = asyncio.create_task(promoted())
        moved = await asyncio.to_thread(store.move_slot, slot, dest)
        t_moved = time.monotonic()
        t_promoted = await promotion
        await asyncio.gather(*watchers)
        reread = {t: await result_bytes(http, gateway, t) for t in before}
        _, topo = await http_json(http, "GET",
                                  gateway + "/v1/taskstore/shards")
    owner = {t["id"]: store.shard_for(t["id"]) for t in tasks}
    on_victim = [t["done_at"] - t_kill for t in tasks
                 if owner[t["id"]] == victim and t["done_at"] > t_kill]
    others = [t["done_at"] for t in tasks
              if owner[t["id"]] != victim and t["done_at"] > t_kill]
    return {"tasks": tasks, "before": before, "reread": reread,
            "attempt": attempt, "victim": victim, "slot": slot, "src": src,
            "dest": dest, "moved": moved, "in_slot": in_slot,
            "epochs": (pre_epoch, store.groups[victim].epoch),
            "promoted_role": store.groups[victim].active.role,
            "topology": topo,
            "kill_to_moved_s": t_moved - t_kill,
            "kill_to_promotion_s": t_promoted - t_kill,
            "kill_to_first_completion_on_victim_s":
                min(on_victim) if on_victim else None,
            "other_shards_completed_after_kill": len(others),
            "other_shards_completed_during_promotion": sum(
                d <= t_promoted for d in others),
            "unfinished_at_kill": len(tasks) - len(before)}


def phase_shard_chaos(handoff: dict, wk: dict, cp_port: int) -> dict:
    """17b: a 4-shard journaled platform in this process, the worker a
    child: a shard primary killed and a slot moved mid-burst."""
    from ai4e_tpu_torch.taskstore.journal import crc32c_impl

    out_dir = handoff["out_dir"]
    journal = out_dir / "shards_chaos.journal"
    for p in out_dir.glob(journal.name + "*"):
        p.unlink()
    env = {**handoff["env"], "AI4E_PLATFORM_TASK_SHARDS": str(SHARDS),
           "AI4E_PLATFORM_JOURNAL_PATH": str(journal)}
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    routes = json.loads(wk["routes"].read_text())
    with ThreadedControlPlane(env, routes, cp_port) as cp:
        if crc32c_impl() != "native":
            raise AssertionError("17b: the journal checksum is the Python "
                                 "loop")
        run = asyncio.run(shard_chaos_drive(cp, wk["url"], wk, bodies))
        store = cp.platform.store
        lost = []
        for t in run["tasks"]:
            try:
                store.get(t["id"])
            except KeyError:
                lost.append(t["id"])
        new_owner = {t: (store.shard_for(t),
                         t in store.groups[run["dest"]].active._tasks,
                         t in store.groups[run["src"]].active._tasks)
                     for t in run["in_slot"]}
    pixels = lc_pixels(handoff)
    tasks = run.pop("tasks")
    for t in tasks:
        if t.get("status") != LC_DONE:
            raise AssertionError(f"17b: task {t['id']} ended {t}")
        check_histogram(json.loads(t["raw"]), want[t["i"]], pixels)
    before, reread = run.pop("before"), run.pop("reread")
    if not before:
        raise AssertionError("17b: no result was read before the kill")
    for task_id, raw in before.items():
        if reread[task_id] != raw:
            raise AssertionError(f"17b: {task_id}'s result changed across "
                                 "the kill")
    if lost:
        raise AssertionError(f"17b: tasks lost at the kill: {lost}")
    pre, post = run["epochs"]
    if post != pre + 1 or run["promoted_role"] != "primary":
        raise AssertionError(f"17b: the killed shard at epoch {pre} -> "
                             f"{post}, role {run['promoted_role']}")
    group = run["topology"]["groups"][run["victim"]]
    if group["epoch"] != post or group["dead"]:
        raise AssertionError(f"17b: topology of the killed shard {group}")
    if not run["in_slot"] or run["moved"] < 1:
        raise AssertionError(f"17b: the moved slot held {run['in_slot']}")
    for t, (shard, on_dest, on_src) in new_owner.items():
        if shard != run["dest"] or not on_dest or on_src:
            raise AssertionError(f"17b: moved task {t} on shard {shard} "
                                 f"(dest {on_dest}, src {on_src})")
    if run["other_shards_completed_after_kill"] < 1:
        raise AssertionError("17b: no other shard's task completed after "
                             "the kill")
    if run["kill_to_first_completion_on_victim_s"] is None:
        raise AssertionError("17b: no task of the killed shard completed "
                             "after the kill")
    run.pop("topology")
    run.update({"tasks": len(tasks), "read_before_kill": len(before),
                "moved_slot_tasks": len(run.pop("in_slot")),
                "crc32c": "native", "card": CARD.get("smi")})
    log(f"shards 17b: {json.dumps(run)}")
    return run


def phase_17(handoff: dict, kernels: list[dict],
             device: str = "cuda") -> dict:
    """Phase 17: land cover behind the sharded task store: the 4-shard
    and 1-shard turns (a), a shard primary killed and a slot moved
    mid-burst (b); one worker, a child process, serves both."""
    log("phase 17: the sharded task store")
    t0 = time.perf_counter()
    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    wk = {"gateway": f"http://127.0.0.1:{cp_port}",
          "url": f"http://127.0.0.1:{wk_port}",
          "log": out_dir / "shards_worker.log",
          "routes": out_dir / "shards_routes.json"}
    models, routes = shard_specs(wk["gateway"], wk["url"])
    (out_dir / "shards_models.json").write_text(json.dumps(models))
    wk["routes"].write_text(json.dumps(routes))
    wk["proc"] = start_child(
        ["worker", "--models", str(out_dir / "shards_models.json"),
         "--host", "127.0.0.1", "--port", str(wk_port), "--device", device],
        wk["log"], {**handoff["env"], "AI4E_OBSERVABILITY_HOP_LEDGER": "1"})
    report: dict = {"seconds_by_part": {}}
    try:
        for part, run in (("17a", lambda: phase_shard_pair(handoff, wk,
                                                           cp_port)),
                          ("17b", lambda: phase_shard_chaos(handoff, wk,
                                                            cp_port))):
            t = time.perf_counter()
            report[part] = run()
            report["seconds_by_part"][part] = time.perf_counter() - t
        stop_child(wk["proc"], wk["log"], "17 worker")
    finally:
        if wk["proc"].poll() is None:
            wk["proc"].kill()
            wk["proc"].wait(timeout=30)
    report["seconds"] = time.perf_counter() - t0
    by_model = launches_by_model(wk["log"].read_text(errors="replace"))
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess"):
        count = by_model.get("landcover", {}).get(name, 0)
        if device == "cuda" and count < 1:
            raise AssertionError(f"phase 17: {name} never launched in the "
                                 f"worker: {by_model}")
        if name in rows:
            rows[name]["launches_phase17"] = count
    log(f"phase 17: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'pair': report['17a']['pair'], 'launches': by_model.get('landcover'), 'card': CARD.get('smi')})}")
    return report


# -- phase 18: the push transport, weighted canary backends, typed API
# definitions, rollout generations and the request reporter ------------------

PUSH_TURNS = ("queue", "push")  # 18a, worker A alone
N_CANARY_WAVES = 2           # 18b: waves of the 64 held-out tiles
CANARY_WEIGHTS = (3, 1)      # 18b: A:B on the weighted async route
N_CANARY_SYNC = 16           # 18b: on the 1:1 and the A:1, B:0 sync routes
N_REPEATS = 3                # 18b: identical requests a route
REPORTER_SETTLE_S = 10.0     # 18c: the reporter back at 0 within this
REPORTER_CLUSTER = "h100"
WK_ASYNC, WK_SYNC = "/v1/models/classify-async", "/v1/models/classify"
CANARY_ASYNC, CANARY_SYNC = "/v1/canary/classify-async", "/v1/canary/classify"
DRAINED_SYNC = "/v1/drained/classify"
SINGLE_SYNC = "/v1/single/classify"  # registered through ``definitions``


def family_outcomes(metrics_text: str, name: str) -> dict:
    """``{outcome: count}`` of one counter family, summed over its other
    labels."""
    out: dict = {}
    for line in metrics_text.splitlines():
        if line.startswith(name + "{"):
            outcome = line.split('outcome="')[1].split('"')[0]
            out[outcome] = out.get(outcome, 0) + float(line.rsplit(" ", 1)[1])
    return out


def push_routes(worker: str) -> dict:
    """18a's routes.json: land cover's async and sync routes to worker A,
    without ``autoscale`` or ``concurrency``, which push refuses with
    JAX's text (the queue turns take the fan-out from the environment)."""
    _, routes = cache_specs("", worker, ("landcover",))
    for api in routes["apis"]:
        api.pop("autoscale", None)
        api.pop("concurrency", None)
    return routes


def canary_routes(a: str, b: str) -> dict:
    """18b's routes.json: the weighted async route A:3 B:1, the sync routes
    at 1:1 and at A:1 B:0, and a one-backend sync route to A registered
    through ``definitions``."""
    def pair(path: str, wa: float, wb: float) -> list:
        return [{"uri": a + path, "weight": wa}, {"uri": b + path,
                                                  "weight": wb}]
    return {"apis": [
        {"prefix": CANARY_ASYNC, "mode": "async",
         "backends": pair(WK_ASYNC, *CANARY_WEIGHTS)},
        {"prefix": CANARY_SYNC, "mode": "sync",
         "backends": pair(WK_SYNC, 1, 1)},
        {"prefix": DRAINED_SYNC, "mode": "sync",
         "backends": pair(WK_SYNC, 1, 0)}],
        "definitions": [{"organization": "single", "api": "classify",
                         "backend_host": a, "backend_path": WK_SYNC,
                         "mode": "sync"}]}


async def push_turn_drive(gateway: str, worker: str, procs: dict, logs: dict,
                          bodies: list[bytes]) -> dict:
    """18a's client for one turn: the 64 tiles at once to the async route,
    each long-polled, then the control plane's /metrics."""
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"],
                           logs["cp"])
        await wait_healthy(http, worker + "/v1/models/", procs["wk"],
                           logs["wk"])
        out = await drive_gateway(http, gateway, LC_SYNC, bodies, 0, LC_DONE,
                                  worker)
        async with http.get(gateway + "/metrics") as r:
            out["cp_metrics"] = await r.text()
    return out


def check_push_turn(handoff: dict, transport: str, run: dict, cp_log: str,
                    want: np.ndarray) -> dict:
    """18a's gates for one turn: every answer phase 10's, the startup line
    naming the transport; on push every task delivered once and no dead
    letter; on the queue no failed or dead-lettered delivery."""
    pixels = lc_pixels(handoff)
    for i, result in enumerate(run["results"]):
        check_histogram(result, want[i], pixels)
    posture = posture_line(cp_log)
    if not posture.split("(", 1)[1].startswith(
            f"2 routes, transport {transport}"):
        raise AssertionError(f"18a: startup line {posture!r}")
    cp = run["cp_metrics"]
    before, after = (batch_sizes(t, "landcover") for t in run["metrics"])
    out = {"transport": transport, "tasks": len(run["results"]),
           "tasks_per_s": run["async_requests_per_s"],
           "task_min_ms": run["task_min_ms"],
           "task_p50_ms": run["task_p50_ms"],
           "task_p95_ms": run["task_p95_ms"],
           # The worker's batches in this turn, by size bucket.
           "batches": {le: n - before.get(le, 0) for le, n in after.items()
                       if n != before.get(le, 0)},
           "startup": posture}
    if transport == "push":
        deliveries = family_outcomes(cp, "ai4e_push_deliveries_total")
        forwards = family_outcomes(cp, "ai4e_webhook_forwards_total")
        if (deliveries.get("delivered") != len(run["results"])
                or deliveries.get("dead_letter")):
            raise AssertionError(f"18a: push deliveries {deliveries}, "
                                 f"webhook forwards {forwards}")
        out.update(deliveries=deliveries, retries=deliveries.get("retry", 0),
                   webhook_forwards=forwards,
                   pending=metric_sum(cp, "ai4e_push_pending"))
    else:
        deliveries = dispatch_outcomes(cp)
        if deliveries.get("failed") or deliveries.get("dead_letter"):
            raise AssertionError(f"18a: queue deliveries {deliveries}")
        out["deliveries"] = deliveries
    return out


def phase_push(handoff: dict, wk: dict, cp_port: int) -> dict:
    """18a: land cover on worker A behind the port's control plane, a child
    process, on the queue and the push transport in turns ``PUSH_TURNS``."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    routes = out_dir / "push_routes.json"
    routes.write_text(json.dumps(push_routes(wk["A"]["url"])))
    turns = []
    for k, transport in enumerate(PUSH_TURNS):
        t0 = time.perf_counter()
        env = {**handoff["env"], "AI4E_PLATFORM_TRANSPORT": transport,
               "AI4E_PLATFORM_DISPATCHER_CONCURRENCY": "4"}
        logs = {"cp": out_dir / f"push_{k}_control_plane.log",
                "wk": wk["A"]["log"]}
        procs = {"cp": start_child(
            ["control-plane", "--routes", str(routes), "--port",
             str(cp_port)], logs["cp"], env), "wk": wk["A"]["proc"]}
        try:
            run = asyncio.run(push_turn_drive(wk["gateway"], wk["A"]["url"],
                                              procs, logs, bodies))
            stop_child(procs["cp"], logs["cp"], f"18a turn {k}")
        finally:
            if procs["cp"].poll() is None:
                procs["cp"].kill()
                procs["cp"].wait(timeout=30)
        turn = check_push_turn(handoff, transport, run,
                               logs["cp"].read_text(errors="replace"), want)
        turn["seconds"] = time.perf_counter() - t0
        log(f"push 18a turn {k}: {json.dumps(turn)}")
        turns.append(turn)
    arms = {}
    for key in ("tasks_per_s", "task_p50_ms", "task_p95_ms"):
        med = {t: statistics.median(x[key] for x in turns
                                    if x["transport"] == t)
               for t in ("queue", "push")}
        arms[key] = {**med, "push_vs_queue": med["push"] / med["queue"]}
    return {"turns": turns, "arms": arms}


async def post_and_wait(http, gateway: str, route: str,
                        body: bytes) -> dict:
    """One async request through the gateway, long-polled to terminal: its
    ``X-Cache`` header, task id, latency and result."""
    from ai4e_tpu_torch.taskstore import TaskStatus

    t0 = time.perf_counter()
    async with http.post(gateway + route, data=body, headers={
            "Content-Type": "application/octet-stream"}) as r:
        if r.status != 200:
            raise AssertionError(f"async {route} {r.status}: "
                                 f"{await r.text()}")
        xcache = r.headers.get("X-Cache")
        task_id = (await r.json())["TaskId"]
    while True:
        async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                            params={"wait": "60"}) as r:
            record = await r.json()
        if TaskStatus.canonical(record["Status"]) in TaskStatus.TERMINAL:
            break
    if record["Status"] != LC_DONE:
        raise AssertionError(f"task {task_id}: {record}")
    return {"xcache": xcache, "task_id": task_id,
            "ms": (time.perf_counter() - t0) * 1e3,
            "result": json.loads(await result_bytes(http, gateway, task_id))}


async def sync_post(http, gateway: str, route: str, body: bytes) -> tuple:
    async with http.post(gateway + route, data=body, headers={
            "Content-Type": "application/octet-stream"}) as r:
        if r.status != 200:
            raise AssertionError(f"sync {route} {r.status}: "
                                 f"{await r.text()}")
        return r.headers.get("X-Cache"), await r.json()


async def canary_drive(gateway: str, wk: dict, reporter: str, procs: dict,
                       logs: dict, bodies: list[bytes]) -> dict:
    """18b and 18c's client: the weighted async burst (the reporter sampled
    meanwhile, then until it settles), the 1:1 and the drained sync
    routes, and identical requests repeated on each route; both workers'
    and the control plane's /metrics around each part."""
    import aiohttp

    async def metrics(url: str) -> str:
        async with http.get(url + "/metrics") as r:
            return await r.text()

    async def snapshot() -> dict:
        return {"A": await metrics(wk["A"]["url"]),
                "B": await metrics(wk["B"]["url"]),
                "cp": await metrics(gateway)}

    async def current() -> int:
        async with http.get(reporter + "/v1/processing", params={
                "cluster": REPORTER_CLUSTER, "path": WK_ASYNC}) as r:
            return (await r.json())["CurrentRequests"]

    out: dict = {}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"],
                           logs["cp"])
        samples: list[int] = []
        stop = asyncio.Event()

        async def sample() -> None:
            while not stop.is_set():
                samples.append(await current())
                await asyncio.sleep(0.005)

        before = await snapshot()
        sampler = asyncio.get_running_loop().create_task(sample())
        t0 = time.perf_counter()
        runs = []
        try:
            for _ in range(N_CANARY_WAVES):
                # A wave of 64 fits each worker's 64-request cap whatever
                # the split, so no delivery is refused and re-picked.
                runs += await asyncio.gather(*(post_and_wait(
                    http, gateway, CANARY_ASYNC, b) for b in bodies))
        finally:
            stop.set()
            await sampler
        out["async_s"] = time.perf_counter() - t0
        out["async"] = (before, await snapshot(), runs)
        t_end, settled = time.monotonic(), None
        while time.monotonic() < t_end + REPORTER_SETTLE_S:
            if await current() == 0:
                settled = time.monotonic() - t_end
                break
            await asyncio.sleep(0.02)
        out["reporter"] = {"samples": samples, "settled_s": settled}
        for key, route in (("sync", CANARY_SYNC), ("drained", DRAINED_SYNC)):
            before = await snapshot()
            answers = [await sync_post(http, gateway, route, b)
                       for b in bodies[:N_CANARY_SYNC]]
            out[key] = (before, await snapshot(), answers)
        repeats = {}
        for route in (SINGLE_SYNC, CANARY_SYNC):
            repeats[route] = [(await sync_post(http, gateway, route,
                                               bodies[0]))[0]
                              for _ in range(N_REPEATS)]
        repeats[CANARY_ASYNC] = [(await post_and_wait(
            http, gateway, CANARY_ASYNC, bodies[0]))["xcache"]
            for _ in range(N_REPEATS)]
        out["repeats"] = repeats
        async with http.get(reporter + "/metrics") as r:
            out["reporter"]["metrics"] = [
                line for line in (await r.text()).splitlines()
                if line.startswith("ai4e_current_requests")]
    return out


def worker_ok(texts: tuple, worker: str, generation: str) -> float:
    """A worker's ``ai4e_rollout_outcomes_total{outcome="ok"}`` delta for
    ``generation`` between two snapshots."""
    return metric_delta((texts[0][worker], texts[1][worker]),
                        "ai4e_rollout_outcomes_total", generation=generation,
                        outcome="ok")


def check_canary(handoff: dict, run: dict, wk: dict, want: np.ndarray) -> dict:
    """18b and 18c's gates."""
    from urllib.parse import urlparse

    pixels = lc_pixels(handoff)
    before, after, runs = run["async"]
    texts = (before, after)
    a, b = worker_ok(texts, "A", "1"), worker_ok(texts, "B", "2")
    n = len(runs)
    for i, r in enumerate(runs):
        check_histogram(r["result"], want[i % len(want)], pixels)
    if a + b != n or min(a, b) < 1:
        raise AssertionError(f"18b: A served {a}, B {b} of {n}")
    p = CANARY_WEIGHTS[1] / sum(CANARY_WEIGHTS)
    sigma = (n * p * (1 - p)) ** 0.5
    if abs(b - n * p) > 4 * sigma:
        raise AssertionError(f"18b: B served {b} of {n}, beyond 4 sigma "
                             f"({sigma:.2f}) of {n * p}")
    delivered = {tag: metric_delta(
        (before["cp"], after["cp"]), "ai4e_dispatch_total",
        outcome="delivered", backend=urlparse(wk[tag]["url"]).netloc)
        for tag in ("A", "B")}
    if delivered != {"A": a, "B": b}:
        raise AssertionError(f"18b: the dispatcher delivered {delivered}, "
                             f"the workers served A {a}, B {b}")
    if any(r["xcache"] is not None for r in runs):
        raise AssertionError("18b: the weighted async route answered from "
                             "the cache")
    out = {"async": {"tasks": n, "A": a, "B": b, "expected_B": n * p,
                     "sigma": sigma, "z": (b - n * p) / sigma,
                     "dispatch_delivered": delivered,
                     "dispatch": family_outcomes(after["cp"],
                                                 "ai4e_dispatch_total"),
                     "tasks_per_s": n / run["async_s"],
                     "task_p50_ms": statistics.median(r["ms"] for r in runs),
                     "task_p95_ms": float(np.percentile(
                         [r["ms"] for r in runs], 95))}}
    for key in ("sync", "drained"):
        before, after, answers = run[key]
        texts = (before, after)
        served = {"A": worker_ok(texts, "A", "1"),
                  "B": worker_ok(texts, "B", "2")}
        for i, (xcache, result) in enumerate(answers):
            check_histogram(result, want[i], pixels)
            if xcache is not None:
                raise AssertionError(f"18b: {key} answered X-Cache {xcache}")
        if sum(served.values()) != len(answers):
            raise AssertionError(f"18b {key}: served {served}")
        if key == "sync" and min(served.values()) < 1:
            raise AssertionError(f"18b: the 1:1 route served {served}")
        if key == "drained" and served["B"] != 0:
            raise AssertionError(f"18b: B at weight 0 served {served}")
        out[key] = served
    repeats = run["repeats"]
    if repeats != {SINGLE_SYNC: ["miss"] + ["hit"] * (N_REPEATS - 1),
                   CANARY_SYNC: [None] * N_REPEATS,
                   CANARY_ASYNC: [None] * N_REPEATS}:
        raise AssertionError(f"18b: X-Cache on repeats {repeats}")
    out["repeats_xcache"] = repeats
    rep = run["reporter"]
    peak = max(rep["samples"], default=0)
    if peak < 1 or rep["settled_s"] is None:
        raise AssertionError(f"18c: reporter peak {peak}, settled "
                             f"{rep['settled_s']}")
    out["reporter"] = {"peak": peak, "samples": len(rep["samples"]),
                       "settled_s": rep["settled_s"],
                       "gauge": rep["metrics"]}
    return out


def phase_canary(handoff: dict, wk: dict, cp_port: int) -> dict:
    """18b and 18c: workers A (generation 1) and B (generation 2) behind
    the port's control plane on the queue transport with the result cache
    on, a child process fed ``canary_routes``; the reporter sampled during
    the weighted burst."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    routes = out_dir / "canary_routes.json"
    routes.write_text(json.dumps(canary_routes(wk["A"]["url"],
                                               wk["B"]["url"])))
    env = {**handoff["env"], "AI4E_PLATFORM_RESULT_CACHE": "1",
           "AI4E_PLATFORM_DISPATCHER_CONCURRENCY": "4"}
    logs = {"cp": out_dir / "canary_control_plane.log"}
    procs = {"cp": start_child(["control-plane", "--routes", str(routes),
                                "--port", str(cp_port)], logs["cp"], env)}
    try:
        run = asyncio.run(canary_drive(wk["gateway"], wk, wk["reporter"],
                                       procs, logs, bodies))
        stop_child(procs["cp"], logs["cp"], "18b control plane")
    finally:
        if procs["cp"].poll() is None:
            procs["cp"].kill()
            procs["cp"].wait(timeout=30)
    out = check_canary(handoff, run, wk, want)
    log(f"canary 18b: {json.dumps({k: v for k, v in out.items() if k != 'reporter'})}")
    log(f"reporter 18c: {json.dumps(out['reporter'])}")
    return out


def phase_18(handoff: dict, kernels: list[dict],
             device: str = "cuda") -> dict:
    """Phase 18: land cover from phase 10's checkpoint on two workers,
    generations 1 (A) and 2 (B), each reporting to a request reporter;
    push against queue on A alone (a), the weighted canary routes and
    ``definitions`` (b), the reporter's gauge (c). Every process is a
    child of this one."""
    log("phase 18: push transport, canary backends, definitions, reporter")
    t0 = time.perf_counter()
    out_dir = handoff["out_dir"]
    cp_port, rp_port = free_port(), free_port()
    reporter = f"http://127.0.0.1:{rp_port}"
    wk = {"gateway": f"http://127.0.0.1:{cp_port}", "reporter": reporter}
    models, _ = cache_specs(wk["gateway"], "", ("landcover",))
    (out_dir / "canary_models.json").write_text(json.dumps(models))
    procs = {"rp": start_child(["reporter", "--port", str(rp_port)],
                               out_dir / "canary_reporter.log",
                               handoff["env"])}
    report: dict = {"seconds_by_part": {}}
    try:
        for tag, generation in (("A", 1), ("B", 2)):
            port = free_port()
            wk[tag] = {"url": f"http://127.0.0.1:{port}",
                       "log": out_dir / f"canary_worker_{tag}.log"}
            wk[tag]["proc"] = procs[tag] = start_child(
                ["worker", "--models", str(out_dir / "canary_models.json"),
                 "--host", "127.0.0.1", "--port", str(port), "--device",
                 device], wk[tag]["log"],
                {**handoff["env"],
                 "AI4E_ROLLOUT_GENERATION": str(generation),
                 "AI4E_SERVICE_REPORTER_URI": reporter,
                 "AI4E_SERVICE_CLUSTER": REPORTER_CLUSTER})
        asyncio.run(wait_all_healthy(
            [(reporter + "/healthz", procs["rp"],
              out_dir / "canary_reporter.log")]
            + [(wk[t]["url"] + "/v1/models/", wk[t]["proc"], wk[t]["log"])
               for t in ("A", "B")]))
        report["workers_up_s"] = time.perf_counter() - t0
        for part, run in (("18a", lambda: phase_push(handoff, wk, cp_port)),
                          ("18bc", lambda: phase_canary(handoff, wk,
                                                        cp_port))):
            t = time.perf_counter()
            report[part] = run()
            report["seconds_by_part"][part] = time.perf_counter() - t
        for tag in ("A", "B"):
            stop_child(wk[tag]["proc"], wk[tag]["log"], f"18 worker {tag}")
        stop_child(procs["rp"], out_dir / "canary_reporter.log",
                   "18 reporter")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    report["seconds"] = time.perf_counter() - t0
    launches = {tag: launches_by_model(
        wk[tag]["log"].read_text(errors="replace")).get("landcover", {})
        for tag in ("A", "B")}
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess"):
        counts = {tag: launches[tag].get(name, 0) for tag in ("A", "B")}
        if device == "cuda" and min(counts.values()) < 1:
            raise AssertionError(f"phase 18: {name} never launched in a "
                                 f"worker: {launches}")
        if name in rows:
            rows[name]["launches_phase18"] = sum(counts.values())
            rows[name]["launches_phase18_by_worker"] = counts
    log(f"phase 18: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'workers_up_s': report['workers_up_s'], 'push_arms': report['18a']['arms'], 'launches': launches, 'card': CARD.get('smi')})}")
    return report


# -- phase 19: resilience and orchestration -----------------------------------

RES_ASYNC, RES_SYNC = "/v1/res/classify-async", "/v1/res/classify"
ONE_SYNC = "/v1/one/classify"  # worker A alone: a cacheable route
RES_RECOVERY_S = 2.0     # AI4E_PLATFORM_RESILIENCE_RECOVERY_SECONDS
RES_THRESHOLD = 3        # AI4E_PLATFORM_RESILIENCE_FAILURE_THRESHOLD
RES_DRAIN_TTL_S = 3.0    # AI4E_ROLLOUT_DRAIN_EJECT_TTL_S
RES_RESCUE_S = 3         # AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT: B's adopted tasks
RES_KILL_AFTER = 16      # 19a: tasks completed before B is killed
N_RES_SYNC = 16          # 19a: sync requests after the kill
RES_SYNC_WIDTH = 4       # ... in flight at a time (admission's initial cap: 8)
N_STALL_SYNC = 8         # 19a: sync requests at once while A is stopped
RES_STALL_S = 2.0        # 19a: how long A stays stopped
N_DRAIN = 32             # 19a: tasks of the burst the drain meets, and again
LADDER_HOLD_S = 0.5      # 19b: AI4E_PLATFORM_ORCHESTRATION_LADDER_HOLD_S
N_PLACE = 32             # 19b: deadline-free tasks, all on the cheap tier
N_DEADLINE = 16          # 19b: deadline-carrying tasks while A is down
DEADLINE_MS = "10000"    # ... their budget
TIGHT_MS = "5"           # 19b: the climb's deadline, 13c's (no tile makes it)
TIGHT_EVERY_S = 0.3      # 19b: a tight task (two background requests at
#                          shed_background and above) this often
KNOCK_EVERY_S = 0.25     # 19b: the idle platform's requests on the way down
LADDER_WAIT_S = 40.0     # 19b: the climb and the descent each end within this
N_SCALE = 768            # 19c: the backlog (under the default class's
#                          share of admission's 1024-task backlog, 870)
SCALE_SUBMITTERS = 32
SCALE_ROUNDS = 3         # 19c: backlogs sent until one meets a tick
#: 19c's turns. The raw-depth turn on one store (a comparison: the
#: scalers tied at the first tick, PERF.md section 7) was cut for the
#: script's time; its gates are the sharded turn's.
SCALE_TURNS = (("sharded_predictive", 4),)
SCALE_TICK_WAIT_S = 12.0  # 19c: every autoscale route ticks within this
LAUNCH_MARKER = "kernel launches by model so far "
OCTET = {"Content-Type": "application/octet-stream"}


def res_routes(a: str, b: str) -> dict:
    """19a and 19b's routes.json: the async and the sync route over workers
    A and B at 1:1, and a sync route to A alone (cacheable)."""
    def pair(path: str) -> list:
        return [{"uri": a + path, "weight": 1}, {"uri": b + path,
                                                 "weight": 1}]
    return {"apis": [
        {"prefix": RES_ASYNC, "mode": "async", "backends": pair(WK_ASYNC)},
        {"prefix": RES_SYNC, "mode": "sync", "backends": pair(WK_SYNC)},
        {"prefix": ONE_SYNC, "mode": "sync", "backend": a + WK_SYNC}]}


def start_res_worker(w: dict, env: dict, device: str) -> None:
    """(Re)start worker ``w`` on its own port, each start with its own
    log; the start's launches are counted from 0."""
    w["starts"] = w.get("starts", 0) + 1
    w["log"] = w["out_dir"] / f"res_worker_{w['tag']}{w['starts']}.log"
    w["proc"] = start_child(
        ["worker", "--models", str(w["models"]), "--host", "127.0.0.1",
         "--port", str(w["port"]), "--device", device], w["log"], env)
    w["mark"] = {}


def launches_now(w: dict) -> dict:
    """SIGUSR1 makes the worker log its launches so far: land cover's."""
    return launches_by_model_now(w).get("landcover", {})


def launches_by_model_now(w: dict) -> dict:
    """SIGUSR1: the worker's launches so far, by model."""
    import signal

    seen = w["log"].read_text(errors="replace").count(LAUNCH_MARKER)
    w["proc"].send_signal(signal.SIGUSR1)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        lines = [line for line in
                 w["log"].read_text(errors="replace").splitlines()
                 if LAUNCH_MARKER in line]
        if len(lines) > seen:
            return json.loads(lines[-1].split(LAUNCH_MARKER, 1)[1])
        time.sleep(0.02)
    raise AssertionError(f"worker {w.get('tag', '')} logged no launches:\n"
                         f"{tail(w['log'])}")


def take_launches(w: dict, part: str, book: dict) -> None:
    """This start's launches since its last reading, into ``book[part]``
    under the start's name (``A1``, ``B2``, ...)."""
    book.setdefault(part, {})[f"{w['tag']}{w['starts']}"] = \
        launches_delta(w)


def launches_delta(w: dict) -> dict:
    """Worker ``w``'s launches since its mark, by kernel; moves the mark."""
    now = launches_now(w)
    out = {k: n - w["mark"].get(k, 0) for k, n in now.items()}
    w["mark"] = now
    return out


def kill_worker(w: dict, part: str, book: dict) -> None:
    """Read the start's launches, then SIGKILL it."""
    take_launches(w, part, book)
    w["proc"].kill()
    w["proc"].wait(timeout=30)


async def res_task(http, gateway: str, route: str, body: bytes,
                   headers: dict | None = None) -> dict:
    """One async request: a refusal's status and ``X-Shed-Reason``, or the
    task long-polled to terminal, with its result when it completed."""
    from ai4e_tpu_torch.taskstore import TaskStatus

    t0 = time.perf_counter()
    async with http.post(gateway + route, data=body,
                         headers={**OCTET, **(headers or {})}) as r:
        if r.status != 200:
            return {"status": r.status, "shed": r.headers.get(
                "X-Shed-Reason"), "ms": (time.perf_counter() - t0) * 1e3}
        task_id = (await r.json())["TaskId"]
    while True:
        async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                            params={"wait": "60"}) as r:
            record = await r.json()
        if TaskStatus.canonical(record["Status"]) in TaskStatus.TERMINAL:
            break
    out = {"status": 200, "task_id": task_id, "record": record,
           "ms": (time.perf_counter() - t0) * 1e3}
    if record["Status"] == LC_DONE:
        out["result"] = json.loads(await result_bytes(http, gateway,
                                                      task_id))
    return out


async def res_sync(http, gateway: str, route: str, body: bytes,
                   headers: dict | None = None) -> dict:
    t0 = time.perf_counter()
    async with http.post(gateway + route, data=body,
                         headers={**OCTET, **(headers or {})}) as r:
        out = {"status": r.status, "shed": r.headers.get("X-Shed-Reason"),
               "xcache": r.headers.get("X-Cache")}
        if r.status == 200:
            out["result"] = await r.json()
        else:
            out["text"] = await r.text()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    return out


async def ledger_of(http, gateway: str, task_id: str) -> list:
    async with http.get(f"{gateway}/v1/taskmanagement/task/{task_id}",
                        params={"ledger": "1"}) as r:
        return (await r.json()).get("Ledger", [])


async def metrics_of(http, url: str) -> str:
    async with http.get(url + "/metrics") as r:
        return await r.text()


def check_served(runs: list[dict], want: np.ndarray, pixels: int,
                 what: str) -> None:
    """Every run answered with phase 10's histogram of its tile: run ``i``
    sent tile ``i % len(want)``."""
    for i, run in enumerate(runs):
        if run.get("status") != 200 or "result" not in run:
            raise AssertionError(f"{what}: request {i}: {run}")
        check_histogram(run["result"], want[i % len(want)], pixels)


def host_of(url: str) -> str:
    return url.split("://", 1)[1]


def stamps_by(ledgers: list[list], event: str) -> dict:
    """``{reason: count}`` of one hop-ledger event over tasks' ledgers."""
    out: dict = {}
    for ledger in ledgers:
        for stamp in ledger:
            if stamp["e"] == event:
                out[stamp.get("r")] = out.get(stamp.get("r"), 0) + 1
    return out


async def resilience_drive(gateway: str, wk: dict, cp: dict, bodies: list,
                           want: np.ndarray, pixels: int, env: dict,
                           device: str, book: dict) -> dict:
    """19a's client: B killed mid-burst, B restarted, A stalled, A
    drained; the control plane's /metrics around each part."""
    import signal

    import aiohttp

    a, b = wk["A"], wk["B"]
    ha, hb = host_of(a["url"]), host_of(b["url"])
    out: dict = {}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", cp["proc"], cp["log"])
        m0 = await metrics_of(http, gateway)
        # Failover: B dies under a burst; the sync route runs meanwhile.
        finished = asyncio.Event()
        count = [0]

        async def one(i: int) -> dict:
            run = await res_task(http, gateway, RES_ASYNC, bodies[i])
            count[0] += 1
            if count[0] >= RES_KILL_AFTER:
                finished.set()
            return run

        t0 = time.perf_counter()
        burst = [asyncio.ensure_future(one(i)) for i in range(len(bodies))]
        await asyncio.wait_for(finished.wait(), 300)
        await asyncio.to_thread(kill_worker, b, "19a", book)
        killed_at = time.perf_counter() - t0
        gate = asyncio.Semaphore(RES_SYNC_WIDTH)

        async def gated(i: int) -> dict:
            async with gate:
                return await res_sync(http, gateway, RES_SYNC, bodies[i])

        sync = await asyncio.gather(*(gated(i) for i in range(N_RES_SYNC)))
        runs = await asyncio.gather(*burst)
        burst_s = time.perf_counter() - t0
        m1 = await metrics_of(http, gateway)
        check_served(runs, want, pixels, "19a burst")
        check_served(sync, want, pixels, "19a sync after the kill")
        texts = (m0, m1)
        out["failover"] = {
            "tasks": len(runs), "killed_after_s": killed_at,
            "burst_s": burst_s, "sync": len(sync),
            "sync_p50_ms": pct([s["ms"] for s in sync], 50),
            "failovers_dispatcher": metric_delta(
                texts, "ai4e_resilience_failovers_total",
                component="dispatcher"),
            "failovers_gateway_sync": metric_delta(
                texts, "ai4e_resilience_failovers_total",
                component="gateway_sync"),
            "retries": metric_delta(texts, "ai4e_resilience_retries_total"),
            "ejections_B": metric_delta(
                texts, "ai4e_resilience_ejections_total", backend=hb),
            "opened_B": metric_delta(
                texts, "ai4e_resilience_transitions_total", backend=hb,
                state="open"),
            "breaker_B": metric_sum(m1, "ai4e_resilience_breaker_state",
                                    backend=hb),
            "rescued": metric_delta(texts, "ai4e_reaper_actions_total",
                                    outcome="requeued"),
            "dispatch": {k: v for k, v in family_outcomes(
                m1, "ai4e_dispatch_total").items()}}
        f = out["failover"]
        # A host's breakers (one a backend URI: the async and the sync
        # path) share the gauge's label, so the transitions decide.
        if f["opened_B"] < 1:
            raise AssertionError(f"19a: B's breaker never opened: {f}")
        if f["failovers_dispatcher"] + f["failovers_gateway_sync"] < 1:
            raise AssertionError(f"19a: no failover: {f}")
        # Recovery: B back on its port; after the cooldown one probe closes
        # its breaker and B serves again.
        t1 = time.perf_counter()
        start_res_worker(b, env, device)
        await wait_healthy(http, b["url"] + "/v1/models/", b["proc"],
                           b["log"])
        up_s = time.perf_counter() - t1
        # Waves on both routes until a probe closed a breaker of B's and B
        # took deliveries, then one more in which no pick routed around B:
        # every breaker of B's admits traffic again.
        waves, recovered, m_wave = 0, False, m1
        while waves < 6:
            waves += 1
            wave = await asyncio.gather(*(res_task(
                http, gateway, RES_ASYNC, bodies[i]) for i in range(16)))
            sync_wave = await asyncio.gather(*(gated(i) for i in range(8)))
            check_served(wave, want, pixels, "19a recovery")
            check_served(sync_wave, want, pixels, "19a recovery, sync")
            m2 = await metrics_of(http, gateway)
            if recovered and metric_delta(
                    (m_wave, m2), "ai4e_resilience_ejections_total",
                    backend=hb) == 0:
                break
            recovered = (
                metric_delta((m1, m2), "ai4e_resilience_probe_total",
                             backend=hb, outcome="success") > 0
                and metric_delta((m1, m2), "ai4e_dispatch_total",
                                 outcome="delivered", backend=hb) > 0)
            m_wave = m2
        else:
            raise AssertionError("19a: B was still routed around after "
                                 f"{waves} waves")
        texts = (m1, m2)
        out["recovery"] = {
            "restart_up_s": up_s, "waves": waves,
            "probes_B": {o: metric_delta(texts, "ai4e_resilience_probe_total",
                                         backend=hb, outcome=o)
                         for o in ("success", "failure")},
            "closed_B": metric_delta(texts,
                                     "ai4e_resilience_transitions_total",
                                     backend=hb, state="closed"),
            "breaker_B": metric_sum(m2, "ai4e_resilience_breaker_state",
                                    backend=hb),
            "delivered_B": metric_delta(texts, "ai4e_dispatch_total",
                                        outcome="delivered", backend=hb)}
        r = out["recovery"]
        if (r["probes_B"]["success"] < 1 or r["closed_B"] < 1
                or r["delivered_B"] < 1):
            raise AssertionError(f"19a: B did not recover: {r}")
        # A stalled backend: SIGSTOP A under sync load, SIGCONT later.
        os.kill(a["proc"].pid, signal.SIGSTOP)
        t2 = time.perf_counter()
        stalled = [asyncio.ensure_future(res_sync(http, gateway, RES_SYNC,
                                                  bodies[i]))
                   for i in range(N_STALL_SYNC)]
        await asyncio.sleep(RES_STALL_S)
        os.kill(a["proc"].pid, signal.SIGCONT)
        stall_runs = await asyncio.gather(*stalled)
        stall_s = time.perf_counter() - t2
        m3 = await metrics_of(http, gateway)
        check_served(stall_runs, want, pixels, "19a stall")
        texts = (m2, m3)
        waited = [s["ms"] for s in stall_runs
                  if s["ms"] >= RES_STALL_S * 1e3 / 2]
        out["stall"] = {
            "sync": len(stall_runs), "seconds": stall_s,
            "waited_for_A": len(waited),
            "max_ms": max(s["ms"] for s in stall_runs),
            "p50_ms": pct([s["ms"] for s in stall_runs], 50),
            "failovers_gateway_sync": metric_delta(
                texts, "ai4e_resilience_failovers_total",
                component="gateway_sync"),
            "opened_A": metric_delta(texts,
                                     "ai4e_resilience_transitions_total",
                                     backend=ha, state="open")}
        # Drain: A leaves under load; it is ejected, its breaker untouched.
        t3 = time.perf_counter()
        drain_burst = [asyncio.ensure_future(res_task(
            http, gateway, RES_ASYNC, bodies[i])) for i in range(N_DRAIN)]
        await asyncio.sleep(0.05)
        async with http.post(a["url"] + "/v1/models/worker/drain",
                             json={"timeout_ms": 30000}) as resp:
            drain_status, summary = resp.status, await resp.json()
        after_drain = await asyncio.gather(*(res_task(
            http, gateway, RES_ASYNC, bodies[i]) for i in range(N_DRAIN)))
        drain_runs = await asyncio.gather(*drain_burst)
        m4 = await metrics_of(http, gateway)
        check_served(drain_runs, want, pixels, "19a drain")
        check_served(after_drain, want, pixels, "19a after the drain")
        texts = (m3, m4)
        async with http.post(a["url"] + "/v1/models/worker/resume") as resp:
            resumed = resp.status
        out["drain"] = {
            "tasks": len(drain_runs) + len(after_drain),
            "seconds": time.perf_counter() - t3,
            "drain_status": drain_status, "summary": summary,
            "resume_status": resumed,
            "drain_ejections_A": metric_delta(
                texts, "ai4e_rollout_drain_ejections_total", backend=ha),
            "opened_A": metric_delta(texts,
                                     "ai4e_resilience_transitions_total",
                                     backend=ha, state="open"),
            "breaker_A": metric_sum(m4, "ai4e_resilience_breaker_state",
                                    backend=ha),
            "delivered": {tag: metric_delta(texts, "ai4e_dispatch_total",
                                            outcome="delivered", backend=h)
                          for tag, h in (("A", ha), ("B", hb))}}
        d = out["drain"]
        if (drain_status != 200 or resumed != 200
                or d["drain_ejections_A"] < 1 or d["opened_A"] != 0
                or d["breaker_A"] != 0):
            raise AssertionError(f"19a drain: {d}")
        out["dispatch"] = family_outcomes(m4, "ai4e_dispatch_total")
        if out["dispatch"].get("failed") or out["dispatch"].get(
                "dead_letter"):
            raise AssertionError(f"19a: deliveries {out['dispatch']}")
    return out


def series_of(metrics_text: str, name: str) -> dict:
    """``{"{labels}": value}`` of one family's samples."""
    return {line[len(name):].rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in metrics_text.splitlines()
            if line.startswith(name + "{")}


def ladder_log(log_text: str) -> list:
    """The control plane's logged ladder steps, each with its time in
    seconds after the first: ``[(s, from, to, pressure)]``."""
    import datetime

    steps = []
    for line in log_text.splitlines():
        if "degradation ladder " not in line:
            continue
        stamp = datetime.datetime.strptime(line[:23],
                                           "%Y-%m-%d %H:%M:%S,%f")
        move = line.split("degradation ladder ", 1)[1]
        frm, rest = move.split(" -> ", 1)
        to, rest = rest.split(" (", 1)
        pressure = float(rest.rsplit(" ", 1)[1].rstrip(")"))
        steps.append((stamp.timestamp(), frm, to, pressure))
    return [(t - steps[0][0], frm, to, p) for t, frm, to, p in steps]


def ladder_level(metrics_text: str) -> int:
    return int(metric_sum(metrics_text, "ai4e_orchestration_ladder_level"))


async def orchestration_drive(gateway: str, wk: dict, cp: dict, bodies: list,
                              want: np.ndarray, pixels: int, env: dict,
                              device: str, book: dict) -> dict:
    """19b's client: the ladder's climb under tight deadlines (background
    refused, cache hits answered) and its descent on an idle platform,
    first, while no other deadline evidence is in its rates; then
    placement on the cheap tier, deadlines while A is down and A's probe
    after its restart."""
    import aiohttp

    a, b = wk["A"], wk["B"]
    ha, hb = host_of(a["url"]), host_of(b["url"])
    out: dict = {}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", cp["proc"], cp["log"])
        # The cacheable route's fill, at level 0.
        fill = await res_sync(http, gateway, ONE_SYNC, bodies[0])
        check_served([fill], want, pixels, "19b cache fill")
        m0 = await metrics_of(http, gateway)
        # The climb: a tight task and a background pair every
        # TIGHT_EVERY_S until the ladder reads shed_default.
        t0 = time.perf_counter()
        levels = [(0.0, ladder_level(m0))]
        fired: list = []
        background: list = []
        while levels[-1][1] < 3:
            if time.perf_counter() - t0 > LADDER_WAIT_S:
                raise AssertionError(f"19b: the ladder climbed only to "
                                     f"{levels}")
            i = len(fired) % len(bodies)
            fired.append(asyncio.ensure_future(res_task(
                http, gateway, RES_ASYNC, bodies[i],
                {"X-Deadline-Ms": TIGHT_MS, "X-Priority": "interactive"})))
            if levels[-1][1] >= 2:
                # Background work only where the ladder refuses it: an
                # admitted task's outcome would be evidence too, and would
                # stretch the descent.
                background.append(asyncio.ensure_future(res_task(
                    http, gateway, RES_ASYNC, bodies[i],
                    {"X-Priority": "background"})))
                background.append(asyncio.ensure_future(res_sync(
                    http, gateway, ONE_SYNC, bodies[i],
                    {"X-Priority": "background", "X-Cache-Bypass": "1"})))
            await asyncio.sleep(TIGHT_EVERY_S)
            level = ladder_level(await metrics_of(http, gateway))
            if level != levels[-1][1]:
                levels.append((time.perf_counter() - t0, level))
        # At shed_default and above a cache hit still answers, a default
        # request the cache cannot serve is refused.
        hit = await res_sync(http, gateway, ONE_SYNC, bodies[0])
        novel = await res_sync(http, gateway, ONE_SYNC, bodies[1])
        hit_level = ladder_level(await metrics_of(http, gateway))
        if hit["status"] != 200 or hit["xcache"] != "hit":
            raise AssertionError(f"19b: the cache hit at level {hit_level} "
                                 f"answered {hit}")
        check_served([hit], want, pixels, "19b cache hit")
        if novel["status"] != 503 or novel["shed"] != (
                "brownout at gateway_sync"):
            raise AssertionError(f"19b: a novel request at level "
                                 f"{hit_level}: {novel}")
        tight = await asyncio.gather(*fired)
        bg = await asyncio.gather(*background)
        statuses: dict = {}
        for run in tight:
            status = (run["record"]["Status"] if run["status"] == 200
                      else f"{run['status']} {run['shed']}")
            statuses[status] = statuses.get(status, 0) + 1
        if any(s.startswith("failed") for s in statuses):
            raise AssertionError(f"19b: tight tasks ended {statuses}")
        refusals: dict = {}
        for run in bg:
            key = (f"{run['status']} {run['shed']}" if run["status"] != 200
                   else "200")
            refusals[key] = refusals.get(key, 0) + 1
            if run["status"] == 200 and "result" not in run:
                raise AssertionError(f"19b: background request {run}")
        if not (refusals.get("429 brownout at gateway")
                and refusals.get("503 brownout at gateway_sync")):
            raise AssertionError(f"19b: background answers {refusals}")
        # The descent: an idle platform, knocked on every KNOCK_EVERY_S.
        t_top = time.perf_counter()
        knocks: dict = {}
        while levels[-1][1] > 0:
            if time.perf_counter() - t_top > LADDER_WAIT_S:
                raise AssertionError(f"19b: the ladder came down only to "
                                     f"{levels}")
            knock = await res_sync(http, gateway, ONE_SYNC, bodies[2], {
                "X-Priority": "interactive", "X-Cache-Bypass": "1"})
            key = str(knock["status"])
            knocks[key] = knocks.get(key, 0) + 1
            await asyncio.sleep(KNOCK_EVERY_S)
            level = ladder_level(await metrics_of(http, gateway))
            if level != levels[-1][1]:
                levels.append((time.perf_counter() - t0, level))
        m4 = await metrics_of(http, gateway)
        texts = (m0, m4)
        out["ladder"] = {
            "transitions_s_level": levels,
            "climb_s": next(t for t, lv in levels if lv >= 3),
            "descent_s": levels[-1][0] - (t_top - t0),
            "tight_tasks": statuses, "background": refusals,
            "cache_hit_at_level": hit_level, "knocks": knocks,
            "transitions": {f"{d} {m}": metric_sum(
                m4, "ai4e_orchestration_ladder_transitions_total",
                direction=d, mode=m)
                for d in ("up", "down") for m in (
                    "reroute_background", "shed_background", "shed_default",
                    "shed_interactive", "normal")
                if metric_sum(m4,
                              "ai4e_orchestration_ladder_transitions_total",
                              direction=d, mode=m)},
            "brownout_refusals": series_of(
                m4, "ai4e_orchestration_brownout_refusals_total"),
            "placements": {o: metric_delta(
                texts, "ai4e_orchestration_placements_total", outcome=o)
                for o in ("confident", "fallback", "probe", "forced")},
            "slo_breaches": metric_sum(m4, "ai4e_slo_breaches_total")}
        ups = {m for m in ("reroute_background", "shed_background",
                           "shed_default")
               if out["ladder"]["transitions"].get(f"up {m}")}
        if len(ups) != 3 or not out["ladder"]["transitions"].get(
                "down normal"):
            raise AssertionError(f"19b: ladder transitions "
                                 f"{out['ladder']['transitions']}")
        m0 = await metrics_of(http, gateway)
        # Deadline-free work: the cheapest tier clears, so all of it on A.
        runs = await asyncio.gather(*(res_task(http, gateway, RES_ASYNC,
                                               bodies[i])
                                      for i in range(N_PLACE)))
        check_served(runs, want, pixels, "19b placement")
        ledgers = await asyncio.gather(*(ledger_of(http, gateway,
                                                   r["task_id"])
                                         for r in runs))
        m1 = await metrics_of(http, gateway)
        placed = stamps_by(ledgers, "placed")
        delivered = {tag: metric_delta((m0, m1), "ai4e_dispatch_total",
                                       outcome="delivered", backend=h)
                     for tag, h in (("A", ha), ("B", hb))}
        out["placement"] = {"tasks": len(runs), "placed": placed,
                            "delivered": delivered}
        if placed != {f"confident {ha}": N_PLACE} or delivered["B"]:
            raise AssertionError(f"19b placement: {out['placement']}")
        # A stopped: deadline-carrying work goes to B.
        await asyncio.to_thread(kill_worker, a, "19b", book)
        runs = await asyncio.gather(*(res_task(
            http, gateway, RES_ASYNC, bodies[i],
            {"X-Deadline-Ms": DEADLINE_MS}) for i in range(N_DEADLINE)))
        check_served(runs, want, pixels, "19b with A down")
        ledgers = await asyncio.gather(*(ledger_of(http, gateway,
                                                   r["task_id"])
                                         for r in runs))
        m2 = await metrics_of(http, gateway)
        delivered = {tag: metric_delta((m1, m2), "ai4e_dispatch_total",
                                       outcome="delivered", backend=h)
                     for tag, h in (("A", ha), ("B", hb))}
        out["a_down"] = {
            "tasks": len(runs), "placed": stamps_by(ledgers, "placed"),
            "failover": stamps_by(ledgers, "failover"),
            "delivered": delivered,
            "opened_A": metric_delta((m1, m2),
                                     "ai4e_resilience_transitions_total",
                                     backend=ha, state="open")}
        if delivered != {"A": 0, "B": N_DEADLINE}:
            raise AssertionError(f"19b with A down: {out['a_down']}")
        # A back: after the cooldown its first placement is a probe.
        t0 = time.perf_counter()
        start_res_worker(a, env, device)
        await wait_healthy(http, a["url"] + "/v1/models/", a["proc"],
                           a["log"])
        up_s = time.perf_counter() - t0
        probes, waves = {}, 0
        while not probes.get(ha) and waves < 4:
            waves += 1
            runs = await asyncio.gather(*(res_task(http, gateway, RES_ASYNC,
                                                   bodies[i])
                                          for i in range(8)))
            check_served(runs, want, pixels, "19b probe")
            ledgers = await asyncio.gather(*(ledger_of(
                http, gateway, r["task_id"]) for r in runs))
            probes = stamps_by(ledgers, "probe")
        m3 = await metrics_of(http, gateway)
        out["probe"] = {
            "restart_up_s": up_s, "waves": waves, "probe_stamps": probes,
            "placed": stamps_by(ledgers, "placed"),
            "closed_A": metric_delta((m2, m3),
                                     "ai4e_resilience_transitions_total",
                                     backend=ha, state="closed"),
            "breaker_A": metric_sum(m3, "ai4e_resilience_breaker_state",
                                    backend=ha)}
        if probes.get(ha) != 1 or out["probe"]["breaker_A"] != 0:
            raise AssertionError(f"19b probe: {out['probe']}")
    return out


async def scale_turn_drive(gateway: str, cp: dict, bodies: list,
                           want: np.ndarray, pixels: int, shards: int,
                           rounds: int | None = None) -> dict:
    """19c's client for one turn: once every autoscale route has ticked
    (the idle routes at ``min_replicas``), ``N_SCALE`` land-cover tasks
    submitted through the deploy spec's route, ``SCALE_SUBMITTERS`` at a
    time, then each long-polled and its answer checked, in ``rounds``
    rounds (None: until a round meets a tick that scales up, at most
    ``SCALE_ROUNDS``); the autoscale gauges sampled every 0.25 s
    throughout; the ``published`` -> ``popped`` delta of every fourth
    task's ledger."""
    import aiohttp

    route = "/v1/landcover/classify-async"
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", cp["proc"], cp["log"])
        samples: list = []
        stop = asyncio.Event()
        t0 = time.perf_counter()

        async def sample() -> None:
            while not stop.is_set():
                text = await metrics_of(http, gateway)
                lc = {line.split('endpoint="')[1].split('"')[0]:
                      float(line.rsplit(" ", 1)[1])
                      for line in text.splitlines()
                      if line.startswith("ai4e_autoscale_replicas{")}
                ups = metric_sum(text, "ai4e_autoscale_decisions_total",
                                 direction="up")
                samples.append((time.perf_counter() - t0, lc, ups))
                await asyncio.sleep(0.25)

        sampler = asyncio.get_running_loop().create_task(sample())
        want_series = 4 * shards  # four autoscale routes, a series a shard
        while not samples or len(samples[-1][1]) < want_series:
            if time.perf_counter() - t0 > SCALE_TICK_WAIT_S:
                raise AssertionError(f"19c x{shards}: autoscale series "
                                     f"{samples[-1][1] if samples else {}}")
            await asyncio.sleep(0.05)
        first_tick_s = time.perf_counter() - t0
        t_backlog = time.perf_counter()

        async def backlog_round() -> tuple[list, float]:
            """``N_SCALE`` tasks submitted, then each long-polled."""
            from ai4e_tpu_torch.taskstore import TaskStatus

            queue: asyncio.Queue = asyncio.Queue()
            for i in range(N_SCALE):
                queue.put_nowait(i)
            created: dict = {}
            t_round = time.perf_counter()

            async def submitter() -> None:
                while not queue.empty():
                    i = queue.get_nowait()
                    async with http.post(gateway + route,
                                         data=bodies[i % len(bodies)],
                                         headers=OCTET) as r:
                        if r.status != 200:
                            raise AssertionError(f"19c submit {r.status}: "
                                                 f"{await r.text()}")
                        created[i] = ((await r.json())["TaskId"],
                                      time.perf_counter())

            async def finish(i: int) -> dict:
                task_id, t_sub = created[i]
                while True:
                    async with http.get(
                            f"{gateway}/v1/taskmanagement/task/{task_id}",
                            params={"wait": "60"}) as r:
                        record = await r.json()
                    if TaskStatus.canonical(record["Status"]) in \
                            TaskStatus.TERMINAL:
                        break
                run = {"status": 200, "task_id": task_id, "record": record,
                       "ms": (time.perf_counter() - t_sub) * 1e3}
                if record["Status"] == LC_DONE:
                    run["result"] = json.loads(await result_bytes(
                        http, gateway, task_id))
                return run

            await asyncio.gather(*(submitter()
                                   for _ in range(SCALE_SUBMITTERS)))
            submitted = time.perf_counter() - t_round
            return (list(await asyncio.gather(
                *(finish(i) for i in range(N_SCALE)))), submitted)

        # A round that drains between two ticks grows nothing: another
        # round then, up to SCALE_ROUNDS.
        order: list = []
        submitted_s = []
        while len(submitted_s) < (rounds or SCALE_ROUNDS):
            runs, submitted = await backlog_round()
            check_served(runs, want, pixels, f"19c x{shards}")
            order += runs
            submitted_s.append(submitted)
            if rounds is None and samples[-1][2] > 0:
                break
        backlog_s = time.perf_counter() - t_backlog
        stop.set()
        await sampler
        ledgers = await asyncio.gather(*(ledger_of(http, gateway,
                                                   r["task_id"])
                                         for r in order[::4]))
        metrics_text = await metrics_of(http, gateway)
    waits = []
    for ledger in ledgers:
        published = next((s["t"] for s in ledger if s["e"] == "published"),
                         None)
        popped = next((s["t"] for s in ledger if s["e"] == "popped"), None)
        if published is not None and popped is not None:
            waits.append((popped - published) * 1e3)
    # The decisions before the backlog were the idle routes' scale-downs.
    first_up = next((t - (t_backlog - t0) for t, _, ups in samples
                     if ups > 0), None)
    lc_series = {k: v for k, v in samples[-1][1].items()
                 if k.startswith(LC_QUEUE)}
    return {"tasks": len(order), "rounds": len(submitted_s),
            "first_tick_s": first_tick_s, "submitted_s": submitted_s,
            "backlog_s": backlog_s,
            "tasks_per_s": len(order) / backlog_s,
            "task_p50_ms": pct([r["ms"] for r in order], 50),
            "task_p95_ms": pct([r["ms"] for r in order], 95),
            "published_to_popped": pcts(waits),
            "first_scale_up_s": first_up,
            "landcover_replicas_peak": max(
                (sum(v for k, v in lc.items() if k.startswith(LC_QUEUE))
                 for _, lc, _ in samples), default=None),
            "landcover_replicas_last": lc_series,
            "autoscale_series": sorted(samples[-1][1]),
            "decisions": {d: metric_sum(metrics_text,
                                        "ai4e_autoscale_decisions_total",
                                        direction=d)
                          for d in ("up", "down")},
            "dispatch": family_outcomes(metrics_text, "ai4e_dispatch_total")}


def res_control_plane(out_dir: Path, tag: str, routes: dict, env: dict,
                      cp_port: int) -> dict:
    path = out_dir / f"{tag}_routes.json"
    path.write_text(json.dumps(routes))
    cp = {"log": out_dir / f"{tag}_control_plane.log"}
    cp["proc"] = start_child(["control-plane", "--routes", str(path),
                              "--port", str(cp_port)], cp["log"], env)
    return cp


def run_control_plane_part(cp: dict, what: str, drive) -> dict:
    """Drive a sub-phase against its control plane, which must then stop
    cleanly; killed if it did not."""
    try:
        out = asyncio.run(drive)
        stop_child(cp["proc"], cp["log"], what)
    finally:
        if cp["proc"].poll() is None:
            cp["proc"].kill()
            cp["proc"].wait(timeout=30)
    out["startup"] = posture_line(cp["log"].read_text(errors="replace"))
    return out


def phase_resilience(handoff: dict, wk: dict, cp_port: int, device: str,
                     book: dict) -> dict:
    """19a: admission and resilience on; workers A and B behind the async
    and the sync route."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    env = {**handoff["env"], "AI4E_PLATFORM_ADMISSION": "1",
           "AI4E_PLATFORM_RESILIENCE": "1",
           "AI4E_PLATFORM_RESILIENCE_RECOVERY_SECONDS": str(RES_RECOVERY_S),
           "AI4E_PLATFORM_RESILIENCE_FAILURE_THRESHOLD": str(RES_THRESHOLD),
           "AI4E_ROLLOUT_DRAIN_EJECT_TTL_S": str(RES_DRAIN_TTL_S),
           "AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT": str(RES_RESCUE_S),
           "AI4E_PLATFORM_REAPER_INTERVAL": "1"}
    cp = res_control_plane(out_dir, "resilience",
                           res_routes(wk["A"]["url"], wk["B"]["url"]), env,
                           cp_port)
    out = run_control_plane_part(cp, "19a control plane", resilience_drive(
        wk["gateway"], wk, cp, bodies, want, lc_pixels(handoff),
        handoff["env"], device, book))
    if "admission control ON, resilience ON" not in out["startup"]:
        raise AssertionError(f"19a: startup line {out['startup']!r}")
    return out


def phase_orchestration(handoff: dict, wk: dict, cp_port: int, device: str,
                        book: dict) -> dict:
    """19b: admission, resilience, orchestration and the SLO ladder on; A
    the cheap tier, B the dear one."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    ha, hb = host_of(wk["A"]["url"]), host_of(wk["B"]["url"])
    env = {**handoff["env"], "AI4E_PLATFORM_ADMISSION": "1",
           "AI4E_PLATFORM_RESILIENCE": "1",
           "AI4E_PLATFORM_RESILIENCE_RECOVERY_SECONDS": str(RES_RECOVERY_S),
           "AI4E_PLATFORM_RESILIENCE_FAILURE_THRESHOLD": str(RES_THRESHOLD),
           "AI4E_PLATFORM_ORCHESTRATION": "1",
           "AI4E_PLATFORM_ORCHESTRATION_COSTS": f"{ha}/=1,{hb}/=3",
           "AI4E_PLATFORM_ORCHESTRATION_LADDER_HOLD_S": str(LADDER_HOLD_S),
           "AI4E_PLATFORM_OBSERVABILITY": "1",
           "AI4E_PLATFORM_SLO_OBJECTIVES": f"{RES_ASYNC}=goodput:99",
           "AI4E_PLATFORM_SLO_TICK_S": "1",
           "AI4E_PLATFORM_SLO_FAST_WINDOW_S": "2",
           "AI4E_PLATFORM_SLO_SLOW_WINDOW_S": "6",
           "AI4E_PLATFORM_SLO_LADDER": "1",
           "AI4E_PLATFORM_RESULT_CACHE": "1",
           "AI4E_PLATFORM_REAPER_RUNNING_TIMEOUT": str(RES_RESCUE_S),
           "AI4E_PLATFORM_REAPER_INTERVAL": "1"}
    cp = res_control_plane(out_dir, "orchestration",
                           res_routes(wk["A"]["url"], wk["B"]["url"]), env,
                           cp_port)
    out = run_control_plane_part(cp, "19b control plane",
                                 orchestration_drive(
                                     wk["gateway"], wk, cp, bodies, want,
                                     lc_pixels(handoff), handoff["env"],
                                     device, book))
    if "orchestration ON" not in out["startup"]:
        raise AssertionError(f"19b: startup line {out['startup']!r}")
    out["ladder"]["logged_steps"] = ladder_log(
        cp["log"].read_text(errors="replace"))
    return out


def phase_sharded_scaler(handoff: dict, wk: dict, cp_port: int) -> dict:
    """19c: deploy/specs/routes.json as written (backends on worker A) on a
    4-shard store with orchestration, where its four ``autoscale`` routes
    each run a ``ShardedAutoscaleController``, a backlog sent until one
    meets a tick; with a second turn in ``SCALE_TURNS`` (one store without
    orchestration: the raw-depth scaler) the same backlog, as many rounds
    as the first turn needed."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    _, routes = deploy_specs(wk["gateway"], wk["A"]["url"])
    turns: dict = {}
    for name, shards in SCALE_TURNS:
        env = {**handoff["env"], "AI4E_PLATFORM_ADMISSION": "1",
               "AI4E_PLATFORM_RESILIENCE": "1",
               "AI4E_PLATFORM_OBSERVABILITY": "1"}
        if shards > 1:
            env.update({"AI4E_PLATFORM_TASK_SHARDS": str(shards),
                        "AI4E_PLATFORM_ORCHESTRATION": "1"})
        cp = res_control_plane(out_dir, f"scale_{name}", routes, env,
                               cp_port)
        t0 = time.perf_counter()
        turn = run_control_plane_part(cp, f"19c {name} control plane",
                                      scale_turn_drive(
                                          wk["gateway"], cp, bodies, want,
                                          lc_pixels(handoff), shards,
                                          rounds=next(
                                              (t["rounds"]
                                               for t in turns.values()),
                                              None)))
        turn["seconds"] = time.perf_counter() - t0
        series = turn["autoscale_series"]
        bases = {s.split("#")[0] for s in series}
        if len(bases) != 4 or len(series) != 4 * shards:
            raise AssertionError(f"19c {name}: autoscale series {series}")
        if (turn["dispatch"].get("failed")
                or turn["dispatch"].get("dead_letter")):
            raise AssertionError(f"19c {name}: deliveries "
                                 f"{turn['dispatch']}")
        if shards > 1 and turn["decisions"]["up"] < 1:
            raise AssertionError(f"19c {name}: the loops never grew: {turn}")
        log(f"scale 19c {name}: {json.dumps(turn)}")
        turns[name] = turn
    return turns


#: The worker starts that serve in each sub-phase: each must launch both
#: kernels there.
SERVED_BY_PART = {"19a": ("A1", "B1", "B2"), "19b": ("A1", "A2", "B2"),
                  "19c": ("A2",)}


def phase_19(handoff: dict, kernels: list[dict],
             device: str = "cuda", keep_workers: bool = False) -> dict:
    """Phase 19: land cover from phase 10's checkpoint on workers A and B,
    behind the port's control plane with resilience (a), orchestration and
    the SLO ladder (b), and the deploy spec's autoscale routes on a sharded
    store (c). Every process is a child of this one. ``keep_workers``
    leaves A and B serving, under ``report["workers"]``, for phase 20a."""
    log("phase 19: resilience and orchestration")
    t0 = time.perf_counter()
    out_dir = handoff["out_dir"]
    cp_port = free_port()
    gateway = f"http://127.0.0.1:{cp_port}"
    wk: dict = {"gateway": gateway}
    models, _ = cache_specs(gateway, "", ("landcover",))
    models_path = out_dir / "res_models.json"
    models_path.write_text(json.dumps(models))
    book: dict = {}
    report: dict = {"seconds_by_part": {}}
    try:
        for tag in ("A", "B"):
            port = free_port()
            wk[tag] = {"tag": tag, "port": port, "out_dir": out_dir,
                       "url": f"http://127.0.0.1:{port}",
                       "models": models_path}
            start_res_worker(wk[tag], handoff["env"], device)
        asyncio.run(wait_all_healthy(
            [(wk[t]["url"] + "/v1/models/", wk[t]["proc"], wk[t]["log"])
             for t in ("A", "B")]))
        report["workers_up_s"] = time.perf_counter() - t0
        for part, run in (
                ("19a", lambda: phase_resilience(handoff, wk, cp_port,
                                                 device, book)),
                ("19b", lambda: phase_orchestration(handoff, wk, cp_port,
                                                    device, book)),
                ("19c", lambda: phase_sharded_scaler(handoff, wk,
                                                     cp_port))):
            t = time.perf_counter()
            report[part] = run()
            report["seconds_by_part"][part] = time.perf_counter() - t
            for tag in ("A", "B"):
                take_launches(wk[tag], part, book)
            if part != "19c":
                log(f"{part}: {json.dumps(report[part])}")
        if not keep_workers:
            stop_res_workers(wk)
    except BaseException:
        kill_res_workers(wk)
        raise
    if keep_workers:
        report["workers"] = (wk, cp_port)
    report["seconds"] = time.perf_counter() - t0
    report["launches"] = book
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess"):
        for part, starts in SERVED_BY_PART.items():
            for start in starts:
                n = book.get(part, {}).get(start, {}).get(name, 0)
                if device == "cuda" and n < 1:
                    raise AssertionError(f"phase 19 {part}: {name} never "
                                         f"launched in worker {start}: "
                                         f"{book}")
        if name in rows:
            rows[name]["launches_phase19_by_worker"] = {
                part: {start: c.get(name, 0) for start, c in starts.items()}
                for part, starts in book.items()}
            rows[name]["launches_phase19"] = sum(
                c.get(name, 0) for starts in book.values()
                for c in starts.values())
    scale = report["19c"]
    log(f"phase 19: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'workers_up_s': report['workers_up_s'], 'ladder': report['19b']['ladder']['transitions_s_level'], 'first_scale_up_s': {k: v['first_scale_up_s'] for k, v in scale.items()}, 'published_to_popped': {k: v['published_to_popped'] for k, v in scale.items()}, 'launches': book, 'card': CARD.get('smi')})}")
    return report


def stop_res_workers(wk: dict) -> None:
    for tag in ("A", "B"):
        stop_child(wk[tag]["proc"], wk[tag]["log"], f"worker {tag}")


def kill_res_workers(wk: dict) -> None:
    for tag in ("A", "B"):
        proc = wk.get(tag, {}).get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


# -- phase 20: tenancy, a declared DAG, and the LM's token chunks ------------

#: 20a's tenants: ``name=key:weight[:rps:burst]`` (AI4E_TENANCY_TENANTS).
TENANTS = "noisy=kn:1,alpha=ka:4,beta=kb:1:5:5"
TENANT_KEYS = {"noisy": "kn", "alpha": "ka", "beta": "kb"}
TENANT_BURST = {"noisy": 192, "alpha": 32, "beta": 32}
BETA_RPS, BETA_BURST = 5.0, 5.0
TENANT_TOP_N = 2          # AI4E_TENANCY_LABEL_TOP_N: beta reads "other"
TENANT_LABEL = {"noisy": "noisy", "alpha": "alpha", "beta": "other"}
ALPHA_AFTER_S = 0.05      # alpha's burst starts this long after noisy's
N_SCENES, SCENE_PX = 16, 512   # 20b: PNG scenes, each fed to both stages
DAG_STAGES = ("landcover", "species")
SPECIES_SURE = 0.505      # top-1 above it: a top-two gap over 1e-2
N_CHUNK_STREAMS = 32      # 20c (12e): stream tasks through the gateway
CHUNK_NEW = 32            # 20c: tokens each asks for
CHUNK_LONG_NEW = 160      # past pipeline_chunk_replay's default 128


def tenant_costs(wk: dict) -> dict:
    """Each worker's placement cost, by host (A the cheap tier)."""
    return {host_of(wk["A"]["url"]): 1.0, host_of(wk["B"]["url"]): 3.0}


async def tenancy_drive(gateway: str, cp: dict, bodies: list, want,
                        pixels: int, tenancy_on: bool) -> dict:
    """20a's client: noisy's tiles at once, alpha's just after, beta's at
    once; every admitted task awaited by long poll and its answer checked;
    then each completed task's ledger and the control plane's series."""
    import aiohttp

    from ai4e_tpu_torch.taskstore import TaskStatus

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", cp["proc"],
                           cp["log"])

        async def one(tenant: str, i: int) -> dict:
            t0 = time.monotonic()
            headers = {**OCTET, "Ocp-Apim-Subscription-Key":
                       TENANT_KEYS[tenant]}
            async with http.post(gateway + RES_ASYNC,
                                 data=bodies[i % len(bodies)],
                                 headers=headers) as r:
                if r.status == 429:
                    return {"tenant": tenant, "status": 429, "t0": t0,
                            "retry_after": r.headers.get("Retry-After"),
                            "reason": r.headers.get("X-Shed-Reason")}
                if r.status != 200:
                    raise AssertionError(f"20a: {tenant} {r.status}: "
                                         f"{await r.text()}")
                task_id = (await r.json())["TaskId"]
            while True:
                async with http.get(
                        f"{gateway}/v1/taskmanagement/task/{task_id}",
                        params={"wait": "30"}) as r:
                    record = await r.json()
                if TaskStatus.canonical(record["Status"]) in \
                        TaskStatus.TERMINAL:
                    break
            ms = (time.monotonic() - t0) * 1e3
            if record["Status"] != LC_DONE:
                raise AssertionError(f"20a: {tenant} task {task_id} "
                                     f"{record['Status']}")
            check_histogram(json.loads(await result_bytes(
                http, gateway, task_id)), want[i % len(want)], pixels)
            return {"tenant": tenant, "status": 200, "t0": t0, "ms": ms,
                    "id": task_id}

        runs = [asyncio.ensure_future(one("noisy", i))
                for i in range(TENANT_BURST["noisy"])]
        await asyncio.sleep(ALPHA_AFTER_S)
        runs += [asyncio.ensure_future(one(t, i)) for t in ("alpha", "beta")
                 for i in range(TENANT_BURST[t])]
        done = await asyncio.gather(*runs)
        ledgers = {d["id"]: (await fetch_record(http, gateway, d["id"]))
                   .get("Ledger", []) for d in done if d["status"] == 200}
        async with http.get(gateway + "/metrics") as r:
            metrics = await r.text()
    return {"done": done, "ledgers": ledgers, "metrics": metrics}


def check_tenancy_run(run: dict, costs: dict, tenancy_on: bool) -> dict:
    """20a's gates on one run; returns its record."""
    done, metrics = run["done"], run["metrics"]
    out: dict = {"tenancy": tenancy_on}
    for tenant in TENANT_BURST:
        mine = [d for d in done if d["tenant"] == tenant]
        ok = [d["ms"] for d in mine if d["status"] == 200]
        out[tenant] = {"sent": len(mine), "completed": len(ok),
                       "refused": len(mine) - len(ok),
                       "task_ms_p50": pct(ok, 50) if ok else None,
                       "task_ms_p95": pct(ok, 95) if ok else None}
    if not tenancy_on:
        if any(d["status"] != 200 for d in done):
            raise AssertionError("20a: a refusal with tenancy off")
        return out
    beta = [d for d in done if d["tenant"] == "beta"]
    span = max(d["t0"] for d in beta) - min(d["t0"] for d in beta)
    bound = BETA_BURST + BETA_RPS * span + 1
    out["beta"]["admit_bound"] = bound
    if out["beta"]["completed"] > bound:
        raise AssertionError(f"20a: beta admitted {out['beta']} over "
                             f"{bound}")
    for d in beta:
        if d["status"] == 429 and not (
                int(d["retry_after"]) >= 1
                and d["reason"] == "tenant-quota at gateway"):
            raise AssertionError(f"20a: beta's refusal {d}")
    if out["beta"]["refused"] < 1:
        raise AssertionError("20a: beta was never refused")
    if not out["alpha"]["task_ms_p50"] < out["noisy"]["task_ms_p50"]:
        raise AssertionError(f"20a: alpha p50 {out['alpha']} not below "
                             f"noisy's {out['noisy']}")
    deliveries: dict = {}
    for d in done:
        for ev in run["ledgers"].get(d.get("id"), ()):
            if ev.get("e") == "delivered":
                label = TENANT_LABEL[d["tenant"]]
                by = deliveries.setdefault(label, {})
                by[ev["r"]] = by.get(ev["r"], 0) + 1
    delivered = {}
    for line in metrics.splitlines():
        if (line.startswith("ai4e_dispatch_total")
                and 'outcome="delivered"' in line):
            host = line.split('backend="', 1)[1].split('"')[0]
            delivered[host] = delivered.get(host, 0) + float(
                line.rsplit(" ", 1)[1])
    from_ledgers = {}
    for by in deliveries.values():
        for host, n in by.items():
            from_ledgers[host] = from_ledgers.get(host, 0) + n
    if from_ledgers != delivered:
        raise AssertionError(f"20a: ledger deliveries {from_ledgers} vs "
                             f"ai4e_dispatch_total {delivered}")
    for tenant, label in TENANT_LABEL.items():
        completed = sum(metric_sum(metrics, "ai4e_tenant_outcomes_total",
                                   tenant=label, outcome=o)
                        for o in ("ok", "late"))
        if completed != out[tenant]["completed"]:
            raise AssertionError(f"20a: {label} outcomes {completed} vs "
                                 f"{out[tenant]['completed']} completed")
        want_cost = sum(n * costs[h]
                        for h, n in deliveries.get(label, {}).items())
        got_cost = metric_sum(metrics, "ai4e_tenant_cost_total",
                              tenant=label)
        if abs(got_cost - want_cost) > 1e-6:
            raise AssertionError(f"20a: {label} cost {got_cost} vs "
                                 f"{want_cost} ({deliveries})")
        out[tenant].update({"label": label, "cost": got_cost,
                            "deliveries_by_host": deliveries.get(label, {})})
    out["shed"] = {label: metric_sum(metrics, "ai4e_tenant_admissions_total",
                                     tenant=label, decision="quota_shed")
                   for label in TENANT_LABEL.values()}
    return out


def phase_tenancy(handoff: dict, wk: dict, cp_port: int) -> dict:
    """20a: land cover on workers A (cheap) and B behind a control plane
    with admission, resilience, orchestration and tenancy; the same burst
    again with tenancy off."""
    out_dir = handoff["out_dir"]
    bodies, want = handoff["landcover"]
    bodies, want = bodies[-N_DEPLOY_ASYNC:], want[-N_DEPLOY_ASYNC:]
    costs = tenant_costs(wk)
    base = {**handoff["env"], "AI4E_PLATFORM_ADMISSION": "1",
            "AI4E_PLATFORM_RESILIENCE": "1",
            "AI4E_PLATFORM_ORCHESTRATION": "1",
            "AI4E_PLATFORM_ORCHESTRATION_COSTS": ",".join(
                f"{h}/={c:g}" for h, c in costs.items()),
            "AI4E_PLATFORM_OBSERVABILITY": "1"}
    out = {}
    for tag, on in (("tenancy_on", True), ("tenancy_off", False)):
        env = dict(base)
        if on:
            env.update({"AI4E_TENANCY_ENABLED": "1",
                        "AI4E_TENANCY_TENANTS": TENANTS,
                        "AI4E_TENANCY_LABEL_TOP_N": str(TENANT_TOP_N)})
        cp = res_control_plane(out_dir, tag, res_routes(
            wk["A"]["url"], wk["B"]["url"]), env, cp_port)
        t0 = time.perf_counter()
        run = run_control_plane_part(cp, f"20a {tag} control plane",
                                     tenancy_drive(wk["gateway"], cp, bodies,
                                                   want, lc_pixels(handoff),
                                                   on))
        record = check_tenancy_run(run, costs, on)
        record["seconds"] = time.perf_counter() - t0
        if on != ("tenancy ON (3 tenants)" in run["startup"]):
            raise AssertionError(f"20a: startup line {run['startup']!r}")
        out[tag] = record
        log(f"tenancy 20a {tag}: {json.dumps(record)}")
    out["alpha_p50_ms"] = {tag: out[tag]["alpha"]["task_ms_p50"]
                           for tag in ("tenancy_on", "tenancy_off")}
    out["noisy_p50_ms"] = {tag: out[tag]["noisy"]["task_ms_p50"]
                           for tag in ("tenancy_on", "tenancy_off")}
    return out


def dag_specs(gateway: str, worker: str) -> tuple[dict, dict]:
    """Phase 10's deploy spec cut to land cover and species, and their
    async routes without ``autoscale``."""
    models, routes = deploy_specs(gateway, worker)
    models["models"] = [m for m in models["models"]
                        if m["name"] in DAG_STAGES]
    routes["apis"] = [{k: v for k, v in a.items() if k != "autoscale"}
                      for a in routes["apis"]
                      if a.get("prefix") in (LC_ASYNC, SPECIES_ASYNC)]
    return models, routes


def scene_pngs(n: int, seed: int) -> list[bytes]:
    """``n`` SCENE_PX-square RGB PNGs: smooth random fields, 8-pixel
    blocks upsampled."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        blocks = rng.integers(0, 256, (SCENE_PX // 8, SCENE_PX // 8, 3),
                              dtype=np.uint8)
        img = Image.fromarray(blocks).resize((SCENE_PX, SCENE_PX),
                                             Image.BILINEAR)
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        out.append(buf.getvalue())
    return out


async def sse_read(http, url: str) -> list[dict]:
    """One task's SSE events until ``terminal``."""
    events, current = [], {}
    async with http.get(url, params={"wait": "120"}) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: {r.status} {await r.text()}")
        async for raw in r.content:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                current["event"] = line[len("event: "):]
            elif line.startswith("data: "):
                current["data"] = json.loads(line[len("data: "):])
            elif line == "" and current:
                current["at"] = time.monotonic()
                events.append(current)
                if current["event"] == "terminal":
                    break
                current = {}
    return events


async def dag_drive(gateway: str, w: dict, scenes: list[bytes]) -> dict:
    """20b's client: each scene to each model's own route, then three
    waves of the DAG: first (half the streams attached at once, half after
    completion), repeated under another request key (the stage cache),
    and with ``X-Cache-Bypass``."""
    import aiohttp

    png = {"Content-Type": "image/png"}
    out: dict = {"direct": {}, "waves": {}}
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, w["url"] + "/v1/models/", w["proc"],
                           w["log"])

        async def direct(route: str, body: bytes) -> dict:
            async with http.post(gateway + route, data=body,
                                 headers=png) as r:
                task_id = (await r.json())["TaskId"]
            await http_json(http, "GET", f"{gateway}/v1/taskmanagement/task/"
                            f"{task_id}", params={"wait": "60"})
            return json.loads(await result_bytes(http, gateway, task_id))

        for name, route in zip(DAG_STAGES, (LC_ASYNC, SPECIES_ASYNC)):
            out["direct"][name] = await asyncio.gather(
                *(direct(route, s) for s in scenes))
        for wave, (query, headers) in (
                ("first", ("", {})), ("repeat", ("?uniq=repeat", {})),
                ("bypass", ("", {"X-Cache-Bypass": "1"}))):
            before = launches_by_model_now(w)
            t0 = time.perf_counter()

            async def one(i: int, body: bytes) -> dict:
                async with http.post(gateway + DAG_PREFIX + query, data=body,
                                     headers={**png, **headers}) as r:
                    if r.status != 200:
                        raise AssertionError(f"20b: {r.status} "
                                             f"{await r.text()}")
                    root = (await r.json())["TaskId"]
                url = f"{gateway}/v1/taskmanagement/task/{root}/events"
                early = i % 2 == 0
                stream = (asyncio.ensure_future(sse_read(http, url))
                          if early else None)
                _, record = await http_json(
                    http, "GET", f"{gateway}/v1/taskmanagement/task/{root}",
                    params={"wait": "60"})
                events = await (stream if early else sse_read(http, url))
                doc = json.loads(await result_bytes(http, gateway, root))
                parts = {}
                for name in DAG_STAGES:
                    async with http.get(gateway + "/v1/taskstore/result",
                                        params={"taskId": root,
                                                "stage": name}) as r:
                        parts[name] = (json.loads(await r.read())
                                       if r.status == 200 else r.status)
                return {"root": root, "status": record["Status"],
                        "doc": doc, "parts": parts, "early": early,
                        "events": [(e["event"], e.get("data", {}).get(
                            "stage"), e.get("data", {}).get("state"))
                            for e in events]}

            roots = await asyncio.gather(*(one(i, s)
                                           for i, s in enumerate(scenes)))
            after = launches_by_model_now(w)
            out["waves"][wave] = {
                "roots": roots, "seconds": time.perf_counter() - t0,
                "launches": {m: {k: n - before.get(m, {}).get(k, 0)
                                 for k, n in c.items()}
                             for m, c in after.items()}}
    return out


def check_dag(run: dict, pixels: int) -> dict:
    """20b's gates; returns the record."""
    out: dict = {}
    direct = run["direct"]
    for wave, rec in run["waves"].items():
        executed = {"first": 2, "repeat": 0, "bypass": 2}[wave]
        lc_diff, sp_agree, sp_conf = 0, 0, 0.0
        for i, r in enumerate(rec["roots"]):
            want_status = (f"completed - pipeline {DAG_NAME} ({executed} "
                           f"executed, {2 - executed} cached)")
            if r["status"] != want_status:
                raise AssertionError(f"20b {wave}: {r['status']!r}, want "
                                     f"{want_status!r}")
            if r["doc"] != {"pipeline": DAG_NAME, "stages": r["parts"]}:
                raise AssertionError(f"20b {wave}: join document "
                                     f"{r['doc']} vs parts {r['parts']}")
            lc, sp = r["parts"]["landcover"], r["parts"]["species"]
            want_lc = direct["landcover"][i]["class_histogram"]
            keys = set(lc["class_histogram"]) | set(want_lc)
            diff = max(abs(lc["class_histogram"].get(k, 0)
                           - want_lc.get(k, 0)) for k in keys)
            if diff > COUNT_TOLERANCE * pixels:
                raise AssertionError(f"20b {wave}: land cover {lc} vs its "
                                     f"own route's {want_lc}")
            lc_diff = max(lc_diff, diff)
            want_sp = direct["species"][i]
            same = sp["class_id"] == want_sp["class_id"]
            if not same and want_sp["confidence"] > SPECIES_SURE:
                raise AssertionError(f"20b {wave}: species {sp} vs its own "
                                     f"route's {want_sp}")
            sp_agree += same
            sp_conf = max(sp_conf, abs(sp["confidence"]
                                       - want_sp["confidence"]))
            kinds = [e[0] for e in r["events"]]
            done = sorted(e[1] for e in r["events"]
                          if e[0] == "stage" and e[2] in ("completed",
                                                          "cached"))
            if (kinds[0] != "status" or kinds[-1] != "terminal"
                    or done != sorted(DAG_STAGES)):
                raise AssertionError(f"20b {wave}: events {r['events']}")
        launched = {m: sum(c.values()) for m, c in rec["launches"].items()}
        if wave == "repeat" and any(launched.values()):
            raise AssertionError(f"20b: the stage cache's wave launched "
                                 f"{rec['launches']}")
        out[wave] = {"seconds": rec["seconds"], "launches": rec["launches"],
                     "landcover_max_count_diff": lc_diff,
                     "species_agree": f"{sp_agree}/{len(rec['roots'])}",
                     "species_max_confidence_diff": sp_conf,
                     "streams_early_late": [
                         sum(r["early"] for r in rec["roots"]),
                         sum(not r["early"] for r in rec["roots"])]}
    return out


SPECIES_ASYNC = "/v1/camera-trap/classify-species-async"
DAG_NAME, DAG_PREFIX = "survey", "/v1/pipelines/survey"


def phase_dag(handoff: dict, device: str = "cuda") -> dict:
    """20b: the DAG ``survey`` (land cover and species, each an entry stage
    and a sink fed the original PNG) on a pipeline platform with the result
    cache in this process, the two models on one worker from phase 10's
    deploy spec."""
    from ai4e_tpu_torch.pipeline import PipelineSpec, StageSpec

    out_dir = handoff["out_dir"]
    cp_port, wk_port = free_port(), free_port()
    gateway = f"http://127.0.0.1:{cp_port}"
    w = {"url": f"http://127.0.0.1:{wk_port}",
         "log": out_dir / "dag_worker.log"}
    models, routes = dag_specs(gateway, w["url"])
    models_path = out_dir / "dag_models.json"
    models_path.write_text(json.dumps(models))
    w["proc"] = start_child(
        ["worker", "--models", str(models_path), "--host", "127.0.0.1",
         "--port", str(wk_port), "--device", device], w["log"],
        handoff["env"])
    backends = {a["prefix"]: a["backend"] for a in routes["apis"]}
    spec = PipelineSpec(DAG_NAME, DAG_PREFIX, [
        StageSpec(name, backends[route], input="original")
        for name, route in zip(DAG_STAGES, (LC_ASYNC, SPECIES_ASYNC))])
    env = {**handoff["env"], "AI4E_PLATFORM_PIPELINE": "1",
           "AI4E_PLATFORM_RESULT_CACHE": "1"}
    try:
        cp = ThreadedControlPlane(env, routes, cp_port)
        cp.platform.register_pipeline(spec)
        with cp:
            run = asyncio.run(dag_drive(gateway, w,
                                        scene_pngs(N_SCENES, SEED + 20)))
            run["subscribers_after"] = cp.call(
                lambda: cp.platform.task_events.subscriber_count)
        stop_child(w["proc"], w["log"], "20b worker")
    finally:
        if w["proc"].poll() is None:
            w["proc"].kill()
            w["proc"].wait(timeout=30)
    out = check_dag(run, lc_pixels(handoff))
    if run["subscribers_after"]:
        raise AssertionError(f"20b: {run['subscribers_after']} event "
                             "subscribers left behind")
    out["subscribers_after"] = run["subscribers_after"]
    out["launches_by_model"] = launches_by_model(
        w["log"].read_text(errors="replace"))
    log(f"dag 20b: {json.dumps(out)}")
    return out


def phase_20(handoff: dict, kernels: list[dict], workers,
             device: str = "cuda") -> dict:
    """Phase 20: tenancy on phase 19's workers (a), then a declared DAG
    with its event streams (b); the LM's token chunks ran as 12e. Workers
    A and B go on serving for phase 21; any failure kills them."""
    log("phase 20: tenancy and pipeline DAGs")
    t0 = time.perf_counter()
    wk, cp_port = workers
    report: dict = {"seconds_by_part": {}}
    book: dict = {}
    try:
        t = time.perf_counter()
        for tag in ("A", "B"):
            w = wk[tag]
            w["mark"] = launches_now(w)
        report["20a"] = phase_tenancy(handoff, wk, cp_port)
        for tag in ("A", "B"):
            take_launches(wk[tag], "20a", book)
        report["seconds_by_part"]["20a"] = time.perf_counter() - t
        t = time.perf_counter()
        report["20b"] = phase_dag(handoff, device)
        report["seconds_by_part"]["20b"] = time.perf_counter() - t
    except BaseException:
        kill_res_workers(wk)
        raise
    report["seconds"] = time.perf_counter() - t0
    rows = {k["name"]: k for k in kernels}
    lc_20b = report["20b"]["launches_by_model"].get("landcover", {})
    sp_20b = report["20b"]["launches_by_model"].get("species", {})
    counts = {"normalize_image": {"20a": sum(c.get("normalize_image", 0)
                                             for c in book["20a"].values()),
                                  "20b_landcover": lc_20b.get(
                                      "normalize_image", 0),
                                  "20b_species": sp_20b.get(
                                      "normalize_image", 0)},
              "fused_seg_postprocess": {
                  "20a": sum(c.get("fused_seg_postprocess", 0)
                             for c in book["20a"].values()),
                  "20b_landcover": lc_20b.get("fused_seg_postprocess", 0)}}
    for name, by in counts.items():
        if device == "cuda" and min(by.values()) < 1:
            raise AssertionError(f"phase 20: {name} never launched: {by}")
        if name in rows:
            rows[name]["launches_phase20"] = by
    log(f"phase 20: {json.dumps({'seconds': report['seconds'], 'seconds_by_part': report['seconds_by_part'], 'alpha_p50_ms': report['20a']['alpha_p50_ms'], 'noisy_p50_ms': report['20a']['noisy_p50_ms'], 'launches': counts, 'card': CARD.get('smi')})}")
    return report


# -- phase 21: chaos, the load client, the fleet view, the timeline ----------

CHAOS_ROUTE = "/v1/chaos/classify-async"
LOAD_ROUTE = "/v1/load/classify-async"
CHAOS_SEED = 20260803     # tests/test_chaos.py's AI4E_CHAOS_SEED default
N_CHAOS = 64              # 21a: held-out tiles a turn, as 15a
CHAOS_KILL_AFTER = 24     # 21a: tasks sent before the dispatcher is killed
CHAOS_DOWN_S = 1.0        # 21a: the dispatcher is down this long
OPEN_RATE, OPEN_S, OPEN_RAMP_S = 48.0, 4.0, 1.0   # 21b: the open loop
CLOSED_WIDTH, CLOSED_S, CLOSED_RAMP_S = 16, 3.0, 0.5  # 21b: the closed loop
CLOSED_DEADLINE_S = 1.0   # 21b: the closed loop's goodput budget
FLEET_INTERVAL_S = 1.0    # 21c: the collector's and top's interval
FLEET_RATE = 16.0         # 21c: the open loop that keeps A busy meanwhile


def chaos_platform(backend: str):
    """21a's control plane: ``tests/test_chaos.py``'s scenario config, the
    task store's HTTP surface on its gateway (workers A and B write their
    tasks there), one async route at ``backend``."""
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
    from ai4e_tpu_torch.taskstore.http import make_app

    platform = LocalPlatform(PlatformConfig(
        resilience=True, retry_delay=0.01, lease_seconds=2.0,
        resilience_retry_base_s=0.001, resilience_failure_threshold=3,
        resilience_recovery_seconds=0.1, observability=True),
        metrics=MetricsRegistry())
    make_app(platform.store, app=platform.gateway.app, lifecycle=platform)
    platform.publish_async_api(CHAOS_ROUTE, backend)
    return platform


def clean_platform(backends: list[str]):
    """21b and 21c's control plane: the defaults but a short redelivery
    delay, one async route over ``backends`` at equal weights."""
    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.platform_assembly import LocalPlatform, PlatformConfig
    from ai4e_tpu_torch.taskstore.http import make_app

    platform = LocalPlatform(PlatformConfig(
        retry_delay=TOPOLOGY_RETRY_DELAY), metrics=MetricsRegistry())
    make_app(platform.store, app=platform.gateway.app, lifecycle=platform)
    platform.publish_async_api(LOAD_ROUTE, [(b, 1.0) for b in backends])
    return platform


async def chaos_turn(gateway: str, bodies: list[bytes], checker,
                     outage=None) -> list[dict]:
    """One turn of 21a: every tile posted (``outage()`` starts the
    dispatcher's outage after the first ``CHAOS_KILL_AFTER`` and returns
    its end, awaited once every tile is posted), each task long-polled to
    terminal and its result read."""
    import aiohttp

    from ai4e_tpu_torch.taskstore import TaskStatus

    async with aiohttp.ClientSession() as http:
        ids = []
        restarted = None
        for i, body in enumerate(bodies):
            if outage is not None and i == CHAOS_KILL_AFTER:
                restarted = await outage()
            async with http.post(gateway + CHAOS_ROUTE, data=body,
                                 headers=OCTET) as r:
                if r.status != 200:
                    raise AssertionError(f"21a: POST {r.status}: "
                                         f"{await r.text()}")
                ids.append((await r.json())["TaskId"])
            checker.note_accepted(ids[-1])
        if restarted is not None:
            await restarted

        async def watch(task_id: str) -> dict:
            deadline = time.monotonic() + 120
            while time.monotonic() < deadline:
                async with http.get(
                        f"{gateway}/v1/taskmanagement/task/{task_id}",
                        params={"wait": "30"}) as r:
                    record = await r.json()
                if TaskStatus.canonical(record["Status"]) \
                        in TaskStatus.TERMINAL:
                    break
            else:
                raise AssertionError(f"21a: task {task_id} never finished")
            if record["Status"] != LC_DONE:
                raise AssertionError(f"21a: task {task_id}: {record}")
            return {"task_id": task_id, "result": json.loads(
                await result_bytes(http, gateway, task_id))}

        return list(await asyncio.gather(*(watch(t) for t in ids)))


def counted_outcomes(metrics, name: str) -> dict:
    out: dict = {}
    for _kind, _name, labels, value in metrics.counter(name, "").collect():
        key = labels.get("outcome", "")
        out[key] = out.get(key, 0) + value
    return out


def phase_chaos(handoff: dict, wk: dict, cp_port: int,
                device: str) -> tuple[dict, dict]:
    """21a: 64 held-out tiles through ``chaos_platform`` at worker A, a
    clean turn, then a turn under ``tests/test_chaos.py``'s faults (5xx,
    lost responses, duplicate publishes) plus refused connections and added
    latency, with the dispatcher killed and restarted. Every turn held to
    the port's ``InvariantChecker``; every faulted answer equal to the
    clean turn's within ``C8_CARD_BOUND``. Returns the report and what
    21d exports (ledgers and chaos times)."""
    from ai4e_tpu_torch.chaos import (FaultInjector, InvariantChecker,
                                      kill_dispatcher, restart_dispatcher,
                                      wrap_platform_http,
                                      wrap_publish_duplicates)

    bodies = handoff["landcover"][0][-N_CHAOS:]
    pixels = lc_pixels(handoff)
    gateway = wk["gateway"]
    platform = chaos_platform(wk["A"]["url"] + WK_ASYNC)
    flight = platform.observability.flight
    checker = InvariantChecker(flight=flight,
                               dump_dir=str(handoff["out_dir"] / "phase21"))
    checker.attach(platform.store)
    (queue,) = platform.dispatchers.dispatchers
    injector = FaultInjector(seed=CHAOS_SEED)
    # One rule for both surfaces: the first rule that matches decides, and
    # a catch-all first would shadow a queue rule after it.
    injector.add_rule(error_rate=0.2, error_status=500, drop_rate=0.05,
                      connect_error_rate=0.05, latency_rate=0.1,
                      latency_s=0.05, duplicate_rate=0.1)
    chaos: list[dict] = []
    report: dict = {"card": CARD.get("smi"), "tiles": len(bodies)}
    with ThreadedControlPlane({}, {}, cp_port, platform=platform) as cp:
        w = wk["A"]
        w["mark"] = launches_now(w)
        t = time.perf_counter()
        clean = asyncio.run(chaos_turn(gateway, bodies, checker))
        report["clean_s"] = time.perf_counter() - t
        report["launches_clean"] = launches_delta(w)
        cp.call(wrap_platform_http, platform, injector)
        cp.call(wrap_publish_duplicates, platform, injector)

        async def outage():
            # The tiles after the kill queue while no dispatcher drains.
            await asyncio.to_thread(cp.run, kill_dispatcher(platform, queue))
            chaos.append({"verb": "kill_dispatcher", "t": time.time(),
                          "queue": queue, "ok": True})

            async def restart() -> None:
                await asyncio.sleep(CHAOS_DOWN_S)
                await asyncio.to_thread(cp.run,
                                        restart_dispatcher(platform, queue))
                chaos.append({"verb": "restart_dispatcher",
                              "t": time.time(), "queue": queue, "ok": True})

            return asyncio.ensure_future(restart())

        before = cp.call(counted_outcomes, platform.metrics,
                         "ai4e_dispatch_total")
        t = time.perf_counter()
        faulted = asyncio.run(chaos_turn(gateway, bodies, checker, outage))
        report["faulted_s"] = time.perf_counter() - t
        report["launches_faulted"] = launches_delta(w)
        after = cp.call(counted_outcomes, platform.metrics,
                        "ai4e_dispatch_total")
        time.sleep(0.3)  # duplicate messages drain through suppression
        cp.call(checker.assert_ok)
        report["invariants"] = checker.summary()
        report["violations"] = len(checker.violations())
        ledgers = cp.call(platform.store.dump_ledgers)
    report["faults"] = injector.counts()
    report["dispatch_outcomes"] = {k: after.get(k, 0) - before.get(k, 0)
                                   for k in after
                                   if after.get(k, 0) - before.get(k, 0)}
    report["deliveries"] = report["dispatch_outcomes"].get("delivered", 0)
    worst = 0
    for c, f in zip(clean, faulted):
        a = {int(k): v for k, v in c["result"]["class_histogram"].items()}
        b = {int(k): v for k, v in f["result"]["class_histogram"].items()}
        if set(f["result"]) != {"class_histogram"} \
                or sum(a.values()) != pixels or sum(b.values()) != pixels:
            raise AssertionError(f"21a: {c['result']} and {f['result']} "
                                 f"against {pixels} px")
        worst = max([worst] + [abs(a.get(k, 0) - b.get(k, 0))
                               for k in set(a) | set(b)])
    report["max_count_diff_vs_clean"] = worst
    report["bound_px"] = C8_CARD_BOUND * pixels
    if worst > C8_CARD_BOUND * pixels:
        raise AssertionError(f"21a: a faulted answer moved {worst} px from "
                             f"the clean turn's: {report}")
    launches = report["launches_faulted"]
    report["launches_per_task"] = {k: n / len(bodies)
                                   for k, n in launches.items()}
    if device == "cuda":
        for kernel in ("normalize_image", "fused_seg_postprocess"):
            if launches.get(kernel, 0) < 1:
                raise AssertionError(f"21a: {kernel} never launched in "
                                     f"worker A's faulted turn: {report}")
    if not all(report["faults"].get(kind)
               for kind in ("error", "drop", "duplicate")):
        raise AssertionError(f"21a: the injector injected {report['faults']}")
    log(f"chaos 21a: {json.dumps(report)}")
    return report, {"ledgers": ledgers, "chaos": chaos,
                    "tasks": [r["task_id"] for r in clean + faulted]}


def load_summary(window: dict) -> dict:
    keys = ("target_rate", "offered", "offered_rate", "achieved_rate",
            "completed", "failed", "expired", "goodput", "late",
            "p50_latency_ms", "p95_latency_ms", "p99_latency_ms",
            "client_errors", "duration_s")
    return {k: window[k] for k in keys if k in window}


async def load_turns(gateway: str, body: bytes) -> dict:
    """21b: the port's open loop, then its closed loop, on land cover."""
    import aiohttp

    from ai4e_tpu_torch.utils.loadclient import run_closed_loop, run_open_loop

    def status(task_id: str) -> str:
        return f"{gateway}/v1/taskmanagement/task/{task_id}"

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as http:
        open_w = await run_open_loop(
            http, post_url=gateway + LOAD_ROUTE, payload=body,
            headers=OCTET, rate=OPEN_RATE, status_url_for=status,
            duration=OPEN_S, ramp=OPEN_RAMP_S, task_timeout=60.0)
        closed_w = await run_closed_loop(
            http, post_url=gateway + LOAD_ROUTE, payload=body,
            headers=OCTET, mode="async", status_url_for=status,
            concurrency=CLOSED_WIDTH, duration=CLOSED_S,
            ramp=CLOSED_RAMP_S, task_timeout=60.0,
            deadline_s=CLOSED_DEADLINE_S)
    return {"open": load_summary(open_w), "closed": load_summary(closed_w)}


async def fleet_view(handoff: dict, wk: dict, body: bytes) -> dict:
    """21c: an in-process ``FleetCollector`` over the control plane and
    workers A and B for two intervals, and ``top --once`` as a child
    process, both while a light open loop keeps the workers busy."""
    import aiohttp

    from ai4e_tpu_torch.metrics import MetricsRegistry
    from ai4e_tpu_torch.observability.federation import FleetCollector
    from ai4e_tpu_torch.observability.top import render_top
    from ai4e_tpu_torch.utils.loadclient import run_open_loop

    gateway = wk["gateway"]
    targets = {"cp": gateway, "a": wk["A"]["url"], "b": wk["B"]["url"]}
    collector = FleetCollector(targets, interval_s=FLEET_INTERVAL_S,
                               metrics=MetricsRegistry())
    def status(task_id: str) -> str:
        return f"{gateway}/v1/taskmanagement/task/{task_id}"

    top_log = handoff["out_dir"] / "phase21" / "top.log"
    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as http:
        load = asyncio.ensure_future(run_open_loop(
            http, post_url=gateway + LOAD_ROUTE, payload=body,
            headers=OCTET, rate=FLEET_RATE, status_url_for=status,
            duration=2 * FLEET_INTERVAL_S + 2.0, ramp=0.5,
            task_timeout=60.0))
        await asyncio.sleep(0.5)
        with open(top_log, "wb") as out:
            top = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "ai4e_tpu_torch", "top", "--once",
                "--interval", str(FLEET_INTERVAL_S), "--targets",
                ",".join(f"{k}={v}" for k, v in targets.items()),
                cwd=ROOT, env=handoff["env"], stdout=out,
                stderr=asyncio.subprocess.STDOUT)
        await collector.scrape_once()
        first = collector.snapshot()
        await asyncio.sleep(FLEET_INTERVAL_S)
        await collector.scrape_once()
        second = collector.snapshot()
        try:
            rc = await asyncio.wait_for(top.wait(), 60)
        finally:
            if top.returncode is None:
                top.kill()
                await top.wait()
        await load
    frame = render_top(second, first)
    log(f"fleet 21c frame:\n{frame}")
    text = top_log.read_text(errors="replace")
    log(f"fleet 21c top --once:\n{text}")
    rows = {line.split()[0]: line.split() for line in text.splitlines()
            if line.split() and line.split()[0] in targets}
    out = {"top_rc": rc, "top_rows": sorted(rows),
           "ups": {k: v["up"] for k, v in second["per_proc"].items()},
           "requests_total": {k: v["requests_total"]
                              for k, v in second["per_proc"].items()},
           "conservation_ok": second["conservation"]["ok"]}
    if rc != 0 or set(rows) != set(targets):
        raise AssertionError(f"21c: top exited {rc}, rows {sorted(rows)}:"
                             f"\n{text}")
    out["top_rate_a"] = float(rows["a"][3])
    if out["top_rate_a"] <= 0:
        raise AssertionError(f"21c: top shows no requests on A:\n{text}")
    if not all(out["ups"].values()) or not second["conservation"]["ok"]:
        raise AssertionError(f"21c: fleet {second}")
    if second["per_proc"]["a"]["requests_total"] \
            <= first["per_proc"]["a"]["requests_total"]:
        raise AssertionError(f"21c: A served nothing between the scrapes: "
                             f"{first} {second}")
    return out


def phase_timeline(handoff: dict, export: dict) -> dict:
    """21d: 21a's ledgers (``dump_ledgers``) and its chaos times as a run's
    directory, then ``python -m ai4e_tpu_torch timeline`` over it: one
    task slice per 21a task, the two chaos instants."""
    rig_dir = handoff["out_dir"] / "phase21"
    (rig_dir / "ledgers.json").write_text(json.dumps(
        {"Ledgers": export["ledgers"]}))
    (rig_dir / "rig.json").write_text(json.dumps({"chaos": export["chaos"]}))
    done = subprocess.run(
        [sys.executable, "-m", "ai4e_tpu_torch", "timeline", "--rig-dir",
         str(rig_dir)], cwd=ROOT, env=handoff["env"], capture_output=True,
        text=True, timeout=120)
    if done.returncode != 0:
        raise AssertionError(f"21d: timeline exited {done.returncode}:\n"
                             f"{done.stdout}{done.stderr}")
    doc = json.loads((rig_dir / "timeline.json").read_text())
    slices = {ev["args"]["task_id"] for ev in doc["traceEvents"]
              if ev["ph"] == "X" and ev["pid"] == 2}
    instants = sorted(ev["name"] for ev in doc["traceEvents"]
                      if ev["ph"] == "i" and ev["pid"] == 1)
    out = {"events": len(doc["traceEvents"]), "task_slices": len(slices),
           "tasks": len(export["tasks"]), "chaos_instants": instants,
           "hops": doc["otherData"]["hops"], "said": done.stdout.strip()}
    if slices != set(export["tasks"]) or instants != [
            "kill_dispatcher", "restart_dispatcher"]:
        raise AssertionError(f"21d: {out}")
    return out


def phase_21(handoff: dict, kernels: list[dict], workers,
             device: str = "cuda") -> dict:
    """Phase 21 on phase 19's workers A and B, in this process: chaos on
    the card (a), the port's load client (b), the fleet view (c) and the
    timeline export (d). Starts no worker; stops A and B at its end, or
    kills them on any failure."""
    log("phase 21: chaos, the load client, the fleet view, the timeline")
    t0 = time.perf_counter()
    wk, cp_port = workers
    (handoff["out_dir"] / "phase21").mkdir(parents=True, exist_ok=True)
    report: dict = {"seconds_by_part": {}, "card": CARD.get("smi")}
    body = handoff["landcover"][0][-1]
    try:
        t = time.perf_counter()
        report["21a"], export = phase_chaos(handoff, wk, cp_port, device)
        report["seconds_by_part"]["21a"] = time.perf_counter() - t
        platform = clean_platform([wk[tag]["url"] + WK_ASYNC
                                   for tag in ("A", "B")])
        with ThreadedControlPlane({}, {}, cp_port, platform=platform):
            for tag in ("A", "B"):
                wk[tag]["mark"] = launches_now(wk[tag])
            t = time.perf_counter()
            report["21b"] = asyncio.run(load_turns(wk["gateway"], body))
            report["21b"]["launches"] = {
                tag: launches_delta(wk[tag]) for tag in ("A", "B")}
            report["seconds_by_part"]["21b"] = time.perf_counter() - t
            log(f"load 21b: {json.dumps(report['21b'])}")
            t = time.perf_counter()
            report["21c"] = asyncio.run(fleet_view(handoff, wk, body))
            report["seconds_by_part"]["21c"] = time.perf_counter() - t
            log(f"fleet 21c: {json.dumps(report['21c'])}")
        t = time.perf_counter()
        report["21d"] = phase_timeline(handoff, export)
        report["seconds_by_part"]["21d"] = time.perf_counter() - t
        log(f"timeline 21d: {json.dumps(report['21d'])}")
        stop_res_workers(wk)
    except BaseException:
        kill_res_workers(wk)
        raise
    report["seconds"] = time.perf_counter() - t0
    rows = {k["name"]: k for k in kernels}
    for name in ("normalize_image", "fused_seg_postprocess"):
        if name in rows:
            rows[name]["launches_phase21"] = {
                "21a_clean": report["21a"]["launches_clean"].get(name, 0),
                "21a_faulted": report["21a"]["launches_faulted"].get(name, 0),
                "21b": sum(c.get(name, 0)
                           for c in report["21b"]["launches"].values())}
    summary = {"seconds": report["seconds"],
               "seconds_by_part": report["seconds_by_part"],
               "faults": report["21a"]["faults"],
               "deliveries": report["21a"]["deliveries"],
               "launches_per_task": report["21a"]["launches_per_task"],
               "open": report["21b"]["open"],
               "closed": report["21b"]["closed"],
               "card": CARD.get("smi")}
    log(f"phase 21: {json.dumps(summary)}")
    return report


async def wait_all_healthy(targets: list[tuple]) -> None:
    """Every ``(url, proc, log)`` answering 200, waited on together."""
    import aiohttp

    async with aiohttp.ClientSession() as http:
        await asyncio.gather(*(wait_healthy(http, url, proc, log_path)
                               for url, proc, log_path in targets))


def detector_dct_sweep(trainings: int) -> None:
    """``python3 chip_smoke.py --detector-dct-sweep N``: the megadetector
    recipe trained N times on the card (seed 0 each time; cuDNN's
    backward is not deterministic), each checkpoint served on rgb8,
    yuv420 and dct and held to 13a's detection gate, with and without
    JAX's 0.5 box-extent tolerance. Prints one ``dct sweep`` line a
    training."""
    from ai4e_tpu_torch.runtime.registry import ModelRuntime
    from ai4e_tpu_torch.train import make_checkpoints as mc

    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "build" / "chip_smoke" / "dct_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = wire_specs()["megadetector"]
    img, targets = mc.detector_batch(np.random.default_rng(5), 8,
                                     spec["image_size"])
    img = uint8_images(img)
    for run in range(trainings):
        result = mc.RECIPES["megadetector"](
            device="cuda", **mc.FULL_OVERRIDES["megadetector"])
        mc.make_checkpoint("megadetector", str(out_dir), result=result)
        row = {"card": CARD["smi"], "eval": result["eval"]}
        del result
        runtime = ModelRuntime("cuda")
        for wire in WIRES:
            servable = runtime.register(wire_servable(spec, wire, out_dir))
            out = runtime.run_batch(servable.name, wire_batch(wire, img))
            row[wire] = mc.detection_accuracy(out, targets,
                                              wh_rel_tolerance=0.5)
            row[wire + "_centres"] = mc.detection_accuracy(out, targets)
        log(f"dct sweep {run}: {json.dumps(row)}")
        del runtime
        torch.cuda.empty_cache()


# -- phase 22: the parallel plane ------------------------------------------


MESH_QKV = (8, 2, 4096, 128)  # longcontext's attention, batch 8, sp = 2
MESH_REPS = 3                 # timed calls a turn, after one untimed
MESH_OUT_TOL = 2              # ring/Ulysses vs plain, in flash tolerances
MESH_LOGIT_ATOL = 2e-2        # a meshed model's logits vs one device's
N_MESH_SYNC = 4
N_MESH_ASYNC = 32
N_MESH_IMAGES = 8             # the ViT at tp = 2: one bucket
N_MESH_SEQS = 8               # longcontext at sp = 2 and the moe at ep = 2
MESH_RANK_TIMEOUT_S = 240


def mesh_rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank))
    return env


def mesh_time_ms(fn) -> float:
    """Wall ms of one ``fn()`` on every rank in step: a barrier, then
    ``MESH_REPS`` calls, each rank waiting for its card."""
    import torch.distributed as dist

    fn()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_REPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / MESH_REPS


def mesh_attention_turns(rank: int) -> dict:
    """22a in one rank: ring and Ulysses at longcontext's full width, sp=2,
    causal and not, this rank's chunk held against the single-device flash
    kernel and its plain version on the whole sequence."""
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.parallel import comm
    from ai4e_tpu_torch.parallel.ring_attention import (ring_attention,
                                                        ulysses_attention)
    from ai4e_tpu_torch.parallel.sharding import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(sp=2), device_type="cuda")
    gen = torch.Generator().manual_seed(SEED)
    q, k, v = (torch.randn(MESH_QKV, generator=gen).to(torch.bfloat16).cuda()
               for _ in range(3))
    chunk = MESH_QKV[2] // 2
    sl = slice(rank * chunk, (rank + 1) * chunk)
    local = [t[:, :, sl] for t in (q, k, v)]
    out = {}
    for causal in (False, True):
        want_plain = flash_plain_chunked(q, k, v, causal)[:, :, sl]
        want_flash = fa.flash_attention(q, k, v, causal=causal)[:, :, sl]
        single_ms = device_ms(lambda: fa.flash_attention(q, k, v,
                                                          causal=causal), 10)
        for name, fn, want_launches in (
                ("ring", ring_attention, rank + 1 if causal else 2),
                ("ulysses", ulysses_attention, 1)):
            fa.launches = 0
            comm.reset()
            got = fn(*local, mesh, causal=causal)
            torch.cuda.synchronize()
            launches, moved = fa.launches, comm.counters()
            if launches != want_launches:
                raise AssertionError(f"{name} causal={causal}: rank {rank} "
                                     f"launched the flash forward {launches} "
                                     f"times, want {want_launches}")
            err, of_tol = flash_err(got, want_plain)
            err_flash = float((got.float() - want_flash.float()).abs().max())
            if not of_tol <= MESH_OUT_TOL:
                raise AssertionError(f"{name} causal={causal}: max abs err "
                                     f"{err} against the plain version "
                                     f"({of_tol:.3g} flash tolerances)")
            ms = mesh_time_ms(lambda: fn(*local, mesh, causal=causal))
            out[f"{name}_{'causal' if causal else 'full'}"] = {
                "flash_launches_a_call": launches,
                "max_abs_err_vs_plain": err, "err_in_flash_tolerances": of_tol,
                "max_abs_err_vs_single_device_flash": err_flash,
                "ms_a_call": ms, "single_device_flash_ms": single_ms,
                "host_copy_bytes_a_call": moved["host_copy_bytes"],
                "host_copies_a_call": moved["host_copies"],
                "collectives_a_call": moved["calls"],
                "collective_s_a_call": moved["seconds"]}
    return out


def mesh_model_turn(family: str, spec, kwargs: dict, batch: np.ndarray,
                    rank: int) -> dict:
    """22c in one rank: ``family`` on ``spec``'s mesh (eager, sharded by
    the servable's rules) against one device's replayed graph, on seed-0
    weights."""
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.parallel import comm
    from ai4e_tpu_torch.parallel.sharding import make_mesh
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    mesh = make_mesh(spec, device_type="cuda")
    meshed = ModelRuntime("cuda", mesh=mesh)
    servable = meshed.register(build_servable(family, mesh=mesh, **kwargs))
    name = servable.name
    meshed.run_batch(name, batch)  # its first run: "compile"
    fa.launches = 0
    comm.reset()
    got = meshed.run_batch(name, batch)
    launches, moved = fa.launches, comm.counters()
    single = ModelRuntime("cuda")
    single.register(build_servable(family, **kwargs))
    want = single.run_batch(name, batch)
    err = float(np.abs(got - want).max())
    agree, gap = check_classes([{"class_id": int(r.argmax()),
                                 "confidence": 0.0} for r in got], want)
    if err > MESH_LOGIT_ATOL:
        raise AssertionError(f"{family} on {spec}: logits {err} from one "
                             f"device's (tolerance {MESH_LOGIT_ATOL})")
    return {"mesh": str(spec), "max_abs_logit_err": err,
            "classes_agree": f"{agree}/{len(got)}",
            "flash_launches_a_batch": launches,
            "eager_ms": mesh_time_ms(lambda: meshed.run_batch(name, batch)),
            "single_replay_ms": mesh_time_ms(
                lambda: single.run_batch(name, batch)),
            "host_copy_bytes_a_batch": moved["host_copy_bytes"],
            "collectives_a_batch": moved["calls"],
            "collective_s_a_batch": moved["seconds"]}


N_MESH_TRAIN_STEPS = 3    # 22d: steps a turn; (iii) saves after the last
MESH_TRAIN_RTOL = 1e-4    # 22d (i), (iii): float32 ViT at tp = 2 vs one device
# 22d (ii): the bf16-bodied longcontext at dp = 2 against one device on
# the whole batch: a loss within one bfloat16 ulp (2^-8) relative. Two
# ranks sum a weight gradient's rows in two bf16 products and add them in
# float32, one device in one product, so the updates differ by bf16
# roundings of the gradients.
LC_TRAIN_RTOL = 2.0 ** -8


def params_digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: equal digests are equal
    bits."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).cpu()
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def mesh_vit_config() -> dict:
    """22d (i): ViT-S/16 (the served ``vit`` entry's widths) with a
    float32 body."""
    return dict(num_classes=1000, image_size=224, patch=16, dim=384,
                depth=6, heads=6, dtype=torch.float32)


def vit_train_batch(config: dict) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(SEED + 23)
    size = config["image_size"]
    return (rng.random((N_MESH_IMAGES, size, size, 3), dtype=np.float32),
            rng.integers(0, config["num_classes"], N_MESH_IMAGES)
            .astype(np.int32))


def step_report(report: dict) -> dict:
    """A meshed ``train_step_phases`` report with its step ms."""
    return dict(report, step_ms=sum(report[k] for k in
                                    ("forward", "backward", "optimizer")))


def mesh_train_vit(rank: int, out_dir: str, device: str = "cuda") -> dict:
    """22d (i) and the ranks' half of (iii): the ViT at tp = 2, three
    steps on one batch, held against one device's ``Trainer`` in rank 0;
    ``save_trainer`` after step 3 (rank 0 writes), then a fourth step."""
    from ai4e_tpu_torch.checkpoint import CheckpointManager, save_trainer
    from ai4e_tpu_torch.models.vit import TP_RULES, create_vit
    from ai4e_tpu_torch.parallel.sharding import MeshSpec, make_mesh
    from ai4e_tpu_torch.train import Trainer

    config = mesh_vit_config()
    mesh = make_mesh(MeshSpec(tp=2), device_type=torch.device(device).type)
    x, y = vit_train_batch(config)
    model = create_vit(torch.Generator().manual_seed(SEED), mesh=mesh,
                       device=device, **config)
    trainer = Trainer(model, device=device, mesh=mesh, tp_rules=TP_RULES)
    losses, reports = [], []
    for _ in range(N_MESH_TRAIN_STEPS):
        loss, report = trainer.train_step_phases(x, y)
        losses.append(loss)
        reports.append(step_report(report))
    params, state = trainer.gather_state()
    gathered = {"params": {k: params_digest([t]) for k, t in params.items()},
                "opt_state": {f"{sk}/{k}": params_digest([t])
                              for sk, by_name in state.items()
                              for k, t in by_name.items()}}
    del params, state
    saved = save_trainer(CheckpointManager(os.path.join(out_dir,
                                                        "mesh_ckpt")),
                         trainer, N_MESH_TRAIN_STEPS)
    if not saved:
        raise AssertionError("22d: save_trainer wrote nothing at step "
                             f"{N_MESH_TRAIN_STEPS}")
    fourth = trainer.train_step(x, y)
    shapes = {k: list(p.shape) for k, p in trainer.params.items()
              if k.startswith("blocks.0.attn.")}
    moments = {k: list(t.shape) for k, t in
               trainer.opt_state["exp_avg"].items() if k in shapes}
    dim = config["dim"]
    want = {"blocks.0.attn.qkv.weight": [3 * dim // 2, dim],
            "blocks.0.attn.out.weight": [dim, dim // 2]}
    for key, shape in want.items():
        if shapes[key] != shape or moments[key] != shape:
            raise AssertionError(f"22d: {key} local {shapes[key]}, moments "
                                 f"{moments[key]}, want {shape}")
    del trainer, model
    out = {"losses": losses, "fourth_loss": fourth, "reports": reports,
           "local_shapes": shapes, "moment_shapes": moments,
           "gathered_digests": gathered}
    if rank == 0:
        single = Trainer(create_vit(torch.Generator().manual_seed(SEED),
                                    device=device, **config), device=device)
        want_losses = [single.train_step(x, y)
                       for _ in range(N_MESH_TRAIN_STEPS)]
        del single
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
        if not gap <= MESH_TRAIN_RTOL:
            raise AssertionError(f"22d (i): tp=2 losses {losses} against one "
                                 f"device's {want_losses}: relative gap {gap}")
        out.update(single_losses=want_losses, max_relative_gap=gap)
    if not losses[1] < losses[0]:
        raise AssertionError(f"22d (i): the second loss {losses[1]} is not "
                             f"below the first {losses[0]}")
    return out


def mesh_train_longcontext(rank: int, device: str = "cuda") -> dict:
    """22d (ii): longcontext at its deployed width (float32 masters, bf16
    body, flash) at dp = 2, three steps on 8 seeded sequences (4 a rank):
    each rank's flash forward and backward launches a step, its parameter
    digest after each step, and one device's losses on the whole batch in
    rank 0."""
    from ai4e_tpu_torch.models import create_seqformer
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.parallel.sharding import MeshSpec, make_mesh
    from ai4e_tpu_torch.train import Trainer
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch

    config = longcontext_config()
    mesh = make_mesh(MeshSpec(dp=2), device_type=torch.device(device).type)
    x, y = longcontext_batch(np.random.default_rng(SEED + 24), N_MESH_SEQS,
                             config["seq_len"], config["vocab_size"],
                             config["num_classes"])

    def model():
        return create_seqformer(torch.Generator().manual_seed(SEED),
                                **config, attention="flash",
                                param_dtype=torch.float32, device=device)

    trainer = Trainer(model(), device=device, mesh=mesh)
    losses, reports, digests, launches = [], [], [], []
    for _ in range(N_MESH_TRAIN_STEPS):
        fa.launches = fa.bwd_launches = 0
        loss, report = trainer.train_step_phases(x, y)
        launches.append({"flash_attention": fa.launches,
                         "flash_attention_bwd": fa.bwd_launches})
        losses.append(loss)
        reports.append(step_report(report))
        digests.append(params_digest(trainer.params.values()))
    if device == "cuda":
        for n in launches:
            if set(n.values()) != {config["depth"]}:
                raise AssertionError(f"22d (ii): rank {rank} launched {n} in "
                                     f"a step, want {config['depth']} each")
    del trainer
    out = {"losses": losses, "reports": reports, "param_digests": digests,
           "launches_a_step": launches, "rows": N_MESH_SEQS // 2}
    if rank == 0:
        single = Trainer(model(), device=device)
        want = [single.train_step(x, y) for _ in range(N_MESH_TRAIN_STEPS)]
        del single
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if not gap <= LC_TRAIN_RTOL:
            raise AssertionError(f"22d (ii): dp=2 losses {losses} against one "
                                 f"device's {want}: relative gap {gap}")
        out.update(single_losses=want, max_relative_gap=gap)
    return out


#: 22e: the losses of a meshed run against one device's on the whole
#: batch, relative. longcontext at sp = 2 merges its two flash blocks by
#: their logsumexp and rounds each block's output to bf16 before the
#: merge, where one device's flash rounds once over all keys; the MoE at
#: ep = 2 computes the same products. Every turn runs, with its
#: one-device reference, under ``torch.use_deterministic_algorithms(True)``:
#: by default the flash backward's dQ adds land in any order, and one
#: device's own repeats part by 7.9e-5 (the MoE) in three steps on an
#: H100, the MoE gate's own size, and longcontext's Ulysses turn, whose
#: products are one device's, read 5.5e-4 from it; ordered, the MoE's two
#: runs' losses were bit-equal (PERF.md section 6).
SP_TRAIN_RTOL, EP_TRAIN_RTOL = 1e-3, 1e-4
N_MOE_TRAIN_SEQS = 16  # 22e: train_moe's batch
#: 22e: flash forward and backward launches a rank a step, predicted: the
#: ring runs both chunks of a layer (not causal), Ulysses one call a layer
#: on the whole sequence, the MoE's attention one call a layer.
SP_EP_LAUNCHES = {"longcontext_ring": 2 * 4, "longcontext_ulysses": 4,
                  "moe_ep2": 2}
#: 22e: collectives a rank a step, predicted: ring 4 hops forward, 8
#: backward, the pool and the gradient sum; Ulysses 8 exchanges each way,
#: the pool and the sum; the MoE 2 combines, 2 input sums backward and the
#: router's sum.
SP_EP_CALLS = {"longcontext_ring": 14, "longcontext_ulysses": 18,
               "moe_ep2": 5}


def mesh_train_sp_ep(rank: int, device: str = "cuda") -> dict:
    """22e: longcontext at sp = 2 (three steps with ring, three with
    Ulysses attention) and the deployed MoE (capacity dispatch) at ep = 2
    (three steps), float32 masters, each on one seeded batch: each step's
    loss, report (collectives, host-copy bytes, ms), flash launches and
    the digest of the replicated parameters; then, on rank 0, one
    device's losses on the whole batch."""
    from ai4e_tpu_torch.models import create_moe, create_seqformer
    from ai4e_tpu_torch.models.moe import MOE_EP_RULES
    from ai4e_tpu_torch.ops import flash_attention as fa
    from ai4e_tpu_torch.parallel.sharding import MeshSpec, make_mesh
    from ai4e_tpu_torch.train import Trainer
    from ai4e_tpu_torch.train.make_checkpoints import longcontext_batch

    lc = longcontext_config()
    moe = {k: v for k, v in moe_model().items()
           if k in ("seq_len", "input_dim", "dim", "depth", "heads",
                    "num_experts", "num_classes", "vocab_size", "dispatch",
                    "capacity_factor")}
    batches = {
        "longcontext": longcontext_batch(np.random.default_rng(SEED + 25),
                                         N_MESH_SEQS, lc["seq_len"],
                                         lc["vocab_size"],
                                         lc["num_classes"]),
        "moe": longcontext_batch(np.random.default_rng(SEED + 26),
                                 N_MOE_TRAIN_SEQS, moe["seq_len"],
                                 moe["vocab_size"], moe["num_classes"])}

    def model(turn: str, mesh=None):
        gen = torch.Generator().manual_seed(SEED)
        if turn == "moe_ep2":
            return create_moe(gen, **moe, mesh=mesh, attention="flash",
                              param_dtype=torch.float32, device=device)
        attention = turn.split("_")[1] if mesh is not None else "flash"
        return create_seqformer(gen, **lc, mesh=mesh, attention=attention,
                                param_dtype=torch.float32, device=device)

    turns = {"longcontext_ring": (MeshSpec(sp=2), "longcontext"),
             "longcontext_ulysses": (MeshSpec(sp=2), "longcontext"),
             "moe_ep2": (MeshSpec(ep=2), "moe")}
    out = {}
    for turn, (spec, data) in turns.items():
        mesh = make_mesh(spec, device_type=torch.device(device).type)
        trainer = Trainer(model(turn, mesh), device=device, mesh=mesh,
                          tp_rules=MOE_EP_RULES if turn == "moe_ep2"
                          else None)
        replicated = [k for k in trainer.params if k not in trainer.split]
        x, y = batches[data]
        rec = {"losses": [], "reports": [], "launches_a_step": [],
               "replicated_digests": [], "replicated": len(replicated),
               "split": sorted(trainer.split)}
        for _ in range(N_MESH_TRAIN_STEPS):
            fa.launches = fa.bwd_launches = 0
            with deterministic_algorithms():
                loss, report = trainer.train_step_phases(x, y)
            rec["launches_a_step"].append(
                {"flash_attention": fa.launches,
                 "flash_attention_bwd": fa.bwd_launches})
            rec["losses"].append(loss)
            rec["reports"].append(step_report(report))
            rec["replicated_digests"].append(params_digest(
                trainer.params[k] for k in replicated))
        del trainer
        out[turn] = rec
    if rank == 0:
        for turn, (_, data) in turns.items():
            single = Trainer(model(turn), device=device)
            x, y = batches[data]
            with deterministic_algorithms():
                out[turn]["single_losses"] = [
                    single.train_step(x, y)
                    for _ in range(N_MESH_TRAIN_STEPS)]
            del single
    return out


def phase_22e(ranks: list[dict], kernels: list[dict],
              device: str = "cuda") -> dict:
    """22e's gates: replicated parameters bit-equal on the two ranks after
    every step; losses within ``SP_TRAIN_RTOL`` (longcontext) or
    ``EP_TRAIN_RTOL`` (the MoE) of one device's on the whole batch; each
    rank's flash forward and backward launches a step and its collectives
    a step as predicted (``SP_EP_LAUNCHES``, ``SP_EP_CALLS``). Prints the
    ``mesh 22e`` line and adds the launches to the flash rows."""
    report = {"card": CARD.get("smi"), "ranks_s": ranks[0]["train_sp_ep_s"]}
    for turn in SP_EP_LAUNCHES:
        recs = [r["train_sp_ep"][turn] for r in ranks]
        if recs[0]["replicated_digests"] != recs[1]["replicated_digests"]:
            raise AssertionError(f"22e {turn}: the ranks' replicated "
                                 "parameters differ after a step")
        if recs[0]["losses"] != recs[1]["losses"]:
            raise AssertionError(f"22e {turn}: the ranks' losses differ: "
                                 f"{[r['losses'] for r in recs]}")
        want = recs[0]["single_losses"]
        tol = EP_TRAIN_RTOL if turn == "moe_ep2" else SP_TRAIN_RTOL
        gap = max(abs(a - b) / abs(b) for a, b in zip(recs[0]["losses"],
                                                       want))
        if not gap <= tol:
            raise AssertionError(f"22e {turn}: losses {recs[0]['losses']} "
                                 f"against one device's {want}: relative "
                                 f"gap {gap} over {tol}")
        for r, rec in zip(ranks, recs):
            for n, step in zip(rec["launches_a_step"], rec["reports"]):
                if device == "cuda" and set(n.values()) != {
                        SP_EP_LAUNCHES[turn]}:
                    raise AssertionError(
                        f"22e {turn}: rank {r['rank']} launched {n} in a "
                        f"step, predicted {SP_EP_LAUNCHES[turn]} each")
                if step["comm_calls"] != SP_EP_CALLS[turn]:
                    raise AssertionError(
                        f"22e {turn}: rank {r['rank']} ran "
                        f"{step['comm_calls']} collectives in a step, "
                        f"predicted {SP_EP_CALLS[turn]}")
        report[turn] = {
            "losses": recs[0]["losses"], "single_losses": want,
            "max_relative_gap": gap, "tolerance": tol,
            "replicated_bit_equal_after_steps":
                len(recs[0]["replicated_digests"]),
            "replicated_params": recs[0]["replicated"],
            "split": recs[0]["split"],
            "launches_a_step": {f"rank{r['rank']}":
                                r["train_sp_ep"][turn]["launches_a_step"]
                                for r in ranks},
            "steps": {f"rank{r['rank']}": [
                {k: step[k] for k in ("step_ms", "comm_calls",
                                      "comm_host_copy_bytes",
                                      "comm_seconds")}
                for step in r["train_sp_ep"][turn]["reports"]]
                for r in ranks}}
    log(f"mesh 22e: {json.dumps(report)}")
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_attention_bwd"):
            k["mesh_sp_ep_train_launches_a_step"] = {
                turn: [n[k["name"]] for n in
                       ranks[0]["train_sp_ep"][turn]["launches_a_step"]]
                for turn in SP_EP_LAUNCHES}
    return report


def mesh_resume_check(ranks: list[dict], out_dir: Path,
                      device: str = "cuda") -> dict:
    """22d (iii) in this process: (i)'s checkpoint, saved at tp = 2,
    resumed into a fresh one-device ``Trainer``: step 3, params and
    moments bit-equal to the gathered ones, and its next loss within
    (i)'s tolerance of the ranks' fourth."""
    from ai4e_tpu_torch.checkpoint import CheckpointManager, resume_trainer
    from ai4e_tpu_torch.models.vit import create_vit
    from ai4e_tpu_torch.train import Trainer

    config = mesh_vit_config()
    trainer = Trainer(create_vit(torch.Generator().manual_seed(SEED + 1),
                                 device=device, **config), device=device)
    t0 = time.perf_counter()
    step = resume_trainer(CheckpointManager(str(out_dir / "mesh_ckpt")),
                          trainer)
    resume_s = time.perf_counter() - t0
    if step != N_MESH_TRAIN_STEPS:
        raise AssertionError(f"22d (iii): resumed step {step}")
    want = ranks[0]["train_vit"]["gathered_digests"]
    got = {"params": {k: params_digest([t])
                      for k, t in trainer.params.items()},
           "opt_state": {f"{sk}/{k}": params_digest([t])
                         for sk, by_name in trainer.opt_state.items()
                         for k, t in by_name.items()}}
    for part in ("params", "opt_state"):
        differ = sorted(k for k in want[part] if got[part].get(k)
                        != want[part][k])
        if differ or set(got[part]) != set(want[part]):
            raise AssertionError(f"22d (iii): resumed {part} differ from "
                                 f"the gathered ones: {differ[:5]}")
    x, y = vit_train_batch(config)
    loss = trainer.train_step(x, y)
    fourth = [r["train_vit"]["fourth_loss"] for r in ranks]
    gap = max(abs(loss - f) / abs(f) for f in fourth)
    if not gap <= MESH_TRAIN_RTOL:
        raise AssertionError(f"22d (iii): resumed loss {loss} against the "
                             f"ranks' fourth {fourth}: relative gap {gap}")
    return {"step": step, "resume_s": resume_s, "next_loss": loss,
            "ranks_fourth": fourth, "max_relative_gap": gap,
            "params_bit_equal": len(want["params"]),
            "moments_bit_equal": len(want["opt_state"])}


def mesh_rank_main(rank: int, world: int, port: int, out_dir: str) -> None:
    """One rank of 22a and 22c (``chip_smoke.py --mesh-rank``)."""
    import torch.distributed as dist

    from ai4e_tpu_torch.parallel.sharding import MeshSpec, init_distributed

    os.environ.update(mesh_rank_env(rank, world, port))
    torch.backends.cuda.matmul.allow_tf32 = False
    init_distributed("cuda")
    torch.cuda.set_device(0)
    report = {"rank": rank, "backend": dist.get_backend(),
              "attention": mesh_attention_turns(rank)}
    rng = np.random.default_rng(SEED)
    moe = {k: v for k, v in moe_model().items()
           if k not in ("family", "checkpoint", "sync_path", "async_path")}
    moe["buckets"] = [N_MESH_SEQS]
    report["moe_ep2"] = mesh_model_turn(
        "moe", MeshSpec(ep=2), moe,
        rng.integers(0, moe["vocab_size"], (N_MESH_SEQS, moe["seq_len"]))
        .astype(np.int32), rank)
    # The served longcontext at sp = 2 (attention auto: ring) against one
    # device's (auto: flash), the meshed bucket eager, one device's a graph.
    lc = {k: v for k, v in longcontext_spec()["models"][0].items()
          if k not in ("family", "sync_path", "async_path")}
    lc.update(attention="auto", buckets=[N_MESH_SEQS])
    report["longcontext_sp2"] = mesh_model_turn(
        "seqformer", MeshSpec(sp=2), lc,
        rng.integers(0, lc["vocab_size"], (N_MESH_SEQS, lc["seq_len"]))
        .astype(np.int32), rank)
    report["vit_tp2"] = mesh_model_turn(
        "vit", MeshSpec(tp=2), {"name": "vit", "buckets": [N_MESH_IMAGES]},
        rng.random((N_MESH_IMAGES, 224, 224, 3), dtype=np.float32), rank)
    t0 = time.perf_counter()
    report["train_vit"] = mesh_train_vit(rank, out_dir)
    report["train_longcontext"] = mesh_train_longcontext(rank)
    report["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    report["train_sp_ep"] = mesh_train_sp_ep(rank)
    report["train_sp_ep_s"] = time.perf_counter() - t0
    Path(out_dir, f"mesh_rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()


def run_mesh_ranks(out_dir: Path) -> list[dict]:
    port = free_port()
    procs, logs = [], []
    try:
        for rank in range(2):
            logs.append(out_dir / f"mesh_rank{rank}.log")
            with open(logs[-1], "wb") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--mesh-rank", str(rank), "2", str(port), str(out_dir)],
                    cwd=ROOT, env=mesh_rank_env(rank, 2, port), stdout=fh,
                    stderr=subprocess.STDOUT))
        for proc, path in zip(procs, logs):
            try:
                code = proc.wait(timeout=MESH_RANK_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"mesh rank hung:\n{tail(path)}")
            if code != 0:
                raise AssertionError(f"mesh rank exited {code}:\n{tail(path)}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    return [json.loads((out_dir / f"mesh_rank{r}.json").read_text())
            for r in range(2)]


def mesh_worker_specs(gateway: str, worker: str) -> tuple[dict, dict]:
    """The deployed longcontext at full width and depth, attention ``auto``
    (ring at sp = 2; the deployed entry names ``flash``, which stays on
    one device), seed-0 weights, behind the control plane at ``gateway``."""
    models, routes = topology_specs(gateway, worker)
    models["models"] = [dict(m, attention="auto") for m in models["models"]
                        if m["name"] == "longcontext"]
    routes["apis"] = [a for a in routes["apis"]
                      if a["prefix"].startswith("/v1/longcontext/")]
    return models, routes


async def drive_mesh_worker(gateway: str, worker: str, procs: dict,
                            logs: dict, bodies: list[bytes]) -> dict:
    import aiohttp

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0),
            timeout=aiohttp.ClientTimeout(total=600)) as http:
        await wait_healthy(http, gateway + "/healthz", procs["cp"], logs["cp"])
        t0 = time.perf_counter()
        await wait_healthy(http, worker + "/v1/models/", procs["wk0"],
                           logs["wk0"])
        up_s = time.perf_counter() - t0
        async with http.get(worker + "/v1/models/models") as r:
            listing = await r.json()
        out = await drive_gateway(http, gateway, "/v1/longcontext/score",
                                  bodies, N_MESH_SYNC,
                                  "completed - class_id, confidence", worker)
    return {"listing": listing, "up_s": up_s, **out}


def phase_mesh_worker() -> dict:
    """22b: the control plane and a two-rank longcontext worker
    (``AI4E_RUNTIME_MESH_SPEC=sp=2``, ``--device cuda``, one card) as child
    processes; answers against one device's on the same weights."""
    from ai4e_tpu_torch.runtime.families import build_servable
    from ai4e_tpu_torch.runtime.registry import ModelRuntime

    out_dir = ROOT / "build" / "chip_smoke"
    cp_port, wk_port, master = free_port(), free_port(), free_port()
    gateway, worker = (f"http://127.0.0.1:{cp_port}",
                       f"http://127.0.0.1:{wk_port}")
    models, routes = mesh_worker_specs(gateway, worker)
    (out_dir / "mesh_models.json").write_text(json.dumps(models))
    (out_dir / "mesh_routes.json").write_text(json.dumps(routes))
    env = {k: v for k, v in os.environ.items() if not k.startswith("AI4E_")}
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""),
               AI4E_PLATFORM_RETRY_DELAY=str(TOPOLOGY_RETRY_DELAY))
    logs = {"cp": out_dir / "mesh_control_plane.log",
            "wk0": out_dir / "mesh_worker_rank0.log",
            "wk1": out_dir / "mesh_worker_rank1.log"}
    config = models["models"][0]
    seqs = np.random.default_rng(SEED + 22).integers(
        0, config["vocab_size"], (N_MESH_SYNC + N_MESH_ASYNC,
                                  config["seq_len"]), dtype=np.uint16)
    procs = {}
    try:
        procs["cp"] = start_child(
            ["control-plane", "--routes", str(out_dir / "mesh_routes.json"),
             "--port", str(cp_port)], logs["cp"], env)
        for rank in range(2):
            procs[f"wk{rank}"] = start_child(
                ["worker", "--models", str(out_dir / "mesh_models.json"),
                 "--host", "127.0.0.1", "--port", str(wk_port), "--device",
                 "cuda"], logs[f"wk{rank}"],
                dict(env, AI4E_RUNTIME_MESH_SPEC="sp=2",
                     **{k: v for k, v in mesh_rank_env(rank, 2, master).items()
                        if k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                 "RANK")}))
        out = asyncio.run(drive_mesh_worker(
            gateway, worker, procs, logs, [npy_bytes(s) for s in seqs]))
        stop_child(procs["wk0"], logs["wk0"], "mesh worker rank 0")
        code = procs["wk1"].wait(timeout=120)
        if code != 0:
            raise AssertionError(f"mesh follower exited {code} on the "
                                 f"sentinel:\n{tail(logs['wk1'])}")
        stop_child(procs["cp"], logs["cp"], "control plane")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    entry = out["listing"]["models"][0]
    mesh = entry.get("mesh", {})
    if (mesh.get("spec"), mesh.get("process_count"), mesh.get("healthy")) != (
            "sp=2", 2, True):
        raise AssertionError(f"/v1/models: {entry}")
    follower_log = logs["wk1"].read_text(errors="replace")
    if "follower 1: shutdown" not in follower_log:
        raise AssertionError(f"the follower missed the sentinel:\n"
                             f"{follower_log[-3000:]}")
    launches = served_launches(logs["wk0"].read_text(errors="replace"))
    if launches["flash_attention"] < 2 * config["depth"]:
        raise AssertionError(f"rank 0 launched the flash forward "
                             f"{launches['flash_attention']} times")

    # One device's worker runtime on the same seed-0 weights (the deployed
    # entry's attention: flash, a graph a bucket).
    runtime = ModelRuntime(device="cuda")
    lc = {k: v for k, v in config.items()
          if k not in ("family", "sync_path", "async_path")}
    servable = runtime.register(build_servable("seqformer",
                                               **dict(lc, attention="flash")))
    batch = np.zeros((servable.max_bucket, config["seq_len"]), np.int32)
    batch[:len(seqs)] = seqs
    want = runtime.run_batch("longcontext", batch)[:len(seqs)]
    agree, gap = check_classes(out["results"], want)
    del servable, runtime
    report = {"card": CARD["smi"], "worker_up_s": out["up_s"],
              "sync_p50_ms": out["sync_p50_ms"],
              "async_requests_per_s": out["async_requests_per_s"],
              "task_p50_ms": out["task_p50_ms"],
              "task_p95_ms": out["task_p95_ms"],
              "classes_agree_with_one_device":
                  f"{agree}/{len(out['results'])}",
              "max_confidence_gap": gap, "mesh_entry": mesh,
              "rank0_launches_while_serving": launches,
              "batch_sizes": batch_sizes(out["metrics"][1], "longcontext")}
    return report


def phase_22d(ranks: list[dict], out_dir: Path, kernels: list[dict],
              device: str = "cuda") -> dict:
    """22d's gates that need both ranks' reports: (ii)'s parameters
    bit-equal on the two ranks after every step and (iii)'s resume in this
    process; prints the ``mesh 22d`` line and adds (ii)'s launches to the
    flash rows of the kernels line."""
    lc = [r["train_longcontext"] for r in ranks]
    if lc[0]["param_digests"] != lc[1]["param_digests"]:
        raise AssertionError("22d (ii): the ranks' parameters differ after "
                             f"a step: {[x['param_digests'] for x in lc]}")
    if lc[0]["losses"] != lc[1]["losses"]:
        raise AssertionError(f"22d (ii): the ranks' losses differ: "
                             f"{[x['losses'] for x in lc]}")
    resume = mesh_resume_check(ranks, out_dir, device)
    vit = [r["train_vit"] for r in ranks]
    report = {
        "card": CARD.get("smi"),
        "vit_tp2": {
            "losses": vit[0]["losses"], "single_losses":
                vit[0]["single_losses"],
            "max_relative_gap": vit[0]["max_relative_gap"],
            "tolerance": MESH_TRAIN_RTOL,
            "local_shapes": vit[0]["local_shapes"],
            "moment_shapes": vit[0]["moment_shapes"],
            "steps": {f"rank{r['rank']}": r["train_vit"]["reports"]
                      for r in ranks}},
        "longcontext_dp2": {
            "losses": lc[0]["losses"], "single_losses":
                lc[0]["single_losses"],
            "max_relative_gap": lc[0]["max_relative_gap"],
            "tolerance": LC_TRAIN_RTOL,
            "params_bit_equal_after_steps": len(lc[0]["param_digests"]),
            "launches_a_step": {f"rank{r['rank']}":
                                r["train_longcontext"]["launches_a_step"]
                                for r in ranks},
            "steps": {f"rank{r['rank']}": r["train_longcontext"]["reports"]
                      for r in ranks}},
        "resume": resume,
        "ranks_s": max(r["train_s"] for r in ranks)}
    log(f"mesh 22d: {json.dumps(report)}")
    for k in kernels:
        if k["name"] in ("flash_attention", "flash_attention_bwd"):
            k["mesh_dp2_train_launches_a_step"] = {
                f"rank{r['rank']}": [n[k["name"]] for n in
                                     r["train_longcontext"]["launches_a_step"]]
                for r in ranks}
    return report


def phase_22(kernels: list[dict]) -> dict:
    """The parallel plane on one card: 22a ring and Ulysses, 22c the MoE at
    ep = 2 and the ViT at tp = 2, 22d training at tp = 2 and dp = 2, in
    two gloo ranks, and 22d's resume on one device in this process; 22b a
    two-rank sp = 2 longcontext worker behind the control plane."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(out_dir / "mesh_ckpt", ignore_errors=True)
    t0 = time.perf_counter()
    ranks = run_mesh_ranks(out_dir)
    rank_s = time.perf_counter() - t0
    for r in ranks:
        log(f"mesh 22a rank {r['rank']} ({r['backend']}): "
            f"{json.dumps(r['attention'])}")
        log(f"mesh 22c rank {r['rank']}: moe {json.dumps(r['moe_ep2'])}; "
            f"vit {json.dumps(r['vit_tp2'])}; longcontext "
            f"{json.dumps(r['longcontext_sp2'])}")
    trained = phase_22d(ranks, out_dir, kernels)
    sp_ep = phase_22e(ranks, kernels)
    resume_done = time.perf_counter()
    served = phase_mesh_worker()
    log(f"mesh 22b: {json.dumps(served)}")
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["mesh_sp2_launches_a_call"] = {
        f"rank{r['rank']}": {turn: v["flash_launches_a_call"]
                             for turn, v in r["attention"].items()}
        for r in ranks}
    flash["mesh_sp2_ms"] = {turn: v["ms_a_call"]
                            for turn, v in ranks[0]["attention"].items()}
    report = {"ranks_s": rank_s,
              "worker_s": time.perf_counter() - resume_done,
              "card": CARD["smi"], "train_ranks_s": trained["ranks_s"],
              "sp_ep_ranks_s": sp_ep["ranks_s"],
              "resume_s": trained["resume"]["resume_s"],
              "eager_against_replay_ms": {
                  turn: (ranks[0][turn]["eager_ms"],
                         ranks[0][turn]["single_replay_ms"])
                  for turn in ("longcontext_sp2", "moe_ep2", "vit_tp2")}}
    log(f"mesh: {json.dumps(report)}")
    return report


# -- phase 23: the multi-process rig -------------------------------------


RIG_SEED = 20260803
# make rig offers 1,500/s; the card's host achieved 161/s of that under
# the chaos timeline, so 23a offers make upgrade's 300/s.
RIG_RATE_23A = 300.0
RIG_DURATION_23A = 8.0  # build_timeline's shortest window
# A loadgen's wait for its last tasks' answers. Each run on the card sat
# out this timeout for a few answers (on the CPU none did; a long poll
# whose task's slot moves mid-wait answers only at its own wait, in both
# packages); the verdict reads the journals, which the driver drains
# itself.
RIG_TASK_TIMEOUT_23A = 5.0
# The shortest load window whose bad canary rolls back while the load
# still runs (the rollout starts a second into it).
RIG_DURATION_23B = 4.0
RIG_WALL_S = 150.0      # each run's hard limit, boot and drain included
RIG_FAULTS = ["kill_gateway", "kill_dispatcher", "move_slot",
              "kill_shard_primary"]


def rig_base_port(span: int = 100) -> int:
    """A base port whose whole block of ``span`` is free now, below the
    ephemeral range (every server this script starts elsewhere binds port
    0, so takes an ephemeral one): the rig's supervisor SIGKILLs whatever
    holds one of its ports, and no process of another phase holds one of
    these."""
    import random

    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 32000 - span) // span * span
        free = True
        for port in range(base, base + span):
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    free = False
                    break
        if free:
            return base
    raise AssertionError("23: no free block of 100 ports")


def stop_rig(proc: subprocess.Popen) -> list[tuple[int, str]]:
    """SIGKILL the rig's driver and every process of the rig below this
    one (the supervisor's children lead sessions of their own; this
    script, their subreaper, adopts them when the driver dies first)."""
    import signal

    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=30)
    left = [(pid, cmd) for pid, cmd in descendants()
            if "ai4e_tpu_torch.rig" in cmd]
    for pid, _ in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    return left


def rig_top_frame(proc: subprocess.Popen, spec: Path, env: dict,
                  deadline: float) -> dict:
    """Once the rig's balancer answers, one ``top --once --spec`` frame
    from a child process: its exit code, the roles it names and its
    fleet line."""
    import urllib.request

    while not spec.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError("23a: the rig wrote no topology")
        time.sleep(0.1)
    topo = json.loads(spec.read_text())
    balancer = (f"http://{topo['host']}:"
                f"{topo['base_port']}/healthz")
    while True:
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError("23a: the rig's balancer never answered")
        try:
            with urllib.request.urlopen(balancer, timeout=2) as r:
                if r.status == 200:
                    break
        except OSError:
            pass
        time.sleep(0.1)
    out = subprocess.run(
        [sys.executable, "-m", "ai4e_tpu_torch", "top", "--once",
         "--interval", "1", "--spec", str(spec)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=30)
    lines = out.stdout.splitlines()
    return {"rc": out.returncode, "fleet": lines[0] if lines else "",
            "names": sorted(line.split()[0] for line in lines[2:]
                            if line.split()),
            "stderr": out.stderr[-2000:]}


def rig_up(name: str, flags: list[str], out_dir: Path,
           top: bool = False) -> dict:
    """One ``python -m ai4e_tpu_torch.rig up`` run as a child process under
    ``RIG_WALL_S``; returns its exit code, its ``rig.json``, the seconds
    it took and (``top``) the ``top --spec`` frame taken while it ran."""
    import shutil

    work = out_dir / f"rig_{name}"
    shutil.rmtree(work, ignore_errors=True)
    base = rig_base_port()
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    argv = [sys.executable, "-m", "ai4e_tpu_torch.rig", "up", *flags,
            "--seed", str(RIG_SEED), "--base-port", str(base),
            "--workdir", str(work / "work"), "--out", str(work / "artifact")]
    log_path = out_dir / f"rig_{name}.log"
    t0 = time.monotonic()
    deadline = t0 + RIG_WALL_S
    with open(log_path, "wb") as out:
        proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    frame = None
    try:
        if top:
            frame = rig_top_frame(proc, work / "work" / "topology.json", env,
                                  deadline)
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"23{name}: the rig ran past {RIG_WALL_S} "
                                 f"s:\n{tail(log_path)}") from None
    finally:
        left = stop_rig(proc)
        if left:
            log(f"rig 23{name}: stopped what the rig left running: {left}")
    seconds = time.monotonic() - t0
    artifact = work / "artifact" / "rig.json"
    if rc != 0 or not artifact.exists():
        raise AssertionError(f"23{name}: the rig exited {rc}:\n"
                             f"{tail(log_path)}")
    return {"rc": rc, "result": json.loads(artifact.read_text()),
            "seconds": seconds, "frame": frame, "base_port": base,
            "artifact": work / "artifact"}


def phase_23() -> dict:
    """23a the chaos rig and one ``top --spec`` frame; 23b the bad-canary
    rollout."""
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    topo_flags = ["--gateways", "2", "--shards", "2", "--replicas", "1",
                  "--dispatchers", "1", "--workers", "1", "--loadgens", "1"]
    a = rig_up("a", topo_flags + [
        "--rate", f"{RIG_RATE_23A:g}", "--duration", f"{RIG_DURATION_23A:g}",
        "--ramp", "2", "--task-timeout", f"{RIG_TASK_TIMEOUT_23A:g}"],
        out_dir, top=True)
    result, verdict = a["result"], a["result"]["verdict"]
    fired = [(e["verb"], e.get("ok")) for e in result["chaos"]]
    if not (result["ok"] and verdict["ok"]):
        raise AssertionError(f"23a: the verdict is not ok: "
                             f"{json.dumps(verdict)[:4000]}")
    if fired != [(verb, True) for verb in RIG_FAULTS]:
        raise AssertionError(f"23a: the faults fired {fired}")
    if not verdict["accepted"] or verdict["terminal"] < verdict["accepted"]:
        raise AssertionError(f"23a: {verdict['accepted']} accepted, "
                             f"{verdict['terminal']} terminal")
    frame = a["frame"]
    from ai4e_tpu_torch.rig.topology import Topology

    want = {n for n in Topology.load(str(
        a["artifact"].parent / "work" / "topology.json")).metrics_urls()
        if n != "collector"}
    if frame["rc"] != 0 or not want <= set(frame["names"]):
        raise AssertionError(f"23a: top --spec: {frame}")
    windows = [w["window"] for w in verdict["windows"] if w.get("window")]
    load_end = max(w["samples"][-1]["t"] for w in verdict["windows"]
                   if w.get("samples"))
    report_a = {
        "seconds": a["seconds"],
        "load_ends_s_after_start": load_end - result["started_at"],
        "finished_s_after_start": result["finished_at"]
        - result["started_at"], "faults": fired,
        "accepted": verdict["accepted"], "terminal": verdict["terminal"],
        "duplicates": verdict["duplicates"],
        "violations": verdict["violation_count"],
        "offered_rate": sum(w["offered_rate"] for w in windows),
        "achieved_rate": sum(w["achieved_rate"] for w in windows),
        "per_shard": {s: {k: m[k] for k in ("accepted", "terminal",
                                            "promoted", "epochs")}
                      for s, m in verdict["per_shard"].items()},
        "conservation_ok": verdict["conservation"].get("ok"),
        "top_fleet_line": frame["fleet"], "top_names": frame["names"]}
    log(f"rig 23a: {json.dumps(report_a)}")

    b = rig_up("b", ["--gateways", "2", "--shards", "1", "--replicas", "1",
                     "--dispatchers", "1", "--workers", "2",
                     "--loadgens", "2", "--rate", "300",
                     "--duration", f"{RIG_DURATION_23B:g}", "--ramp", "2",
                     "--task-timeout", "45", "--no-chaos",
                     "--rollout", "bad-canary",
                     "--rollout-steps", "25,50,100", "--rollout-hold-s", "3",
                     "--rollout-drain-timeout-ms", "4000"], out_dir)
    result, verdict = b["result"], b["result"]["verdict"]
    rollout = result.get("rollout") or {}
    weights = rollout.get("weight_history") or []
    if not (result["ok"] and verdict["ok"]
            and rollout.get("gate", {}).get("ok")):
        raise AssertionError(f"23b: {json.dumps(rollout)[:3000]}; verdict "
                             f"{json.dumps(verdict)[:2000]}")
    if rollout.get("outcome") != "rolled_back" or not weights or \
            max(weights) >= 50.0:
        raise AssertionError(f"23b: the bad canary was not rolled back "
                             f"below 50%: {rollout.get('outcome')} {weights}")
    ledgers = json.loads((b["artifact"] / "ledgers.json").read_text())
    marker = ledgers["Ledgers"].get(rollout.get("marker_task") or "", [])
    stamped = [ev.get("r", "") for ev in marker if ev.get("e") == "rollback"]
    if not stamped:
        raise AssertionError(f"23b: no rollback stamp on the marker task "
                             f"{rollout.get('marker_task')}: {marker}")
    events = rollout.get("events") or []
    rolled_at = next(e["t"] for e in events if e["event"] == "rollback")
    report_b = {
        "seconds": b["seconds"], "duration_s": RIG_DURATION_23B,
        "outcome": rollout["outcome"], "rollback_step_pct": max(weights),
        "reason": rollout.get("reason"), "upgraded": rollout.get("upgraded"),
        "reverted": rollout.get("reverted"),
        "rollback_s_after_start": rolled_at - result["started_at"],
        "load_ends_s_after_start": max(
            w["samples"][-1]["t"] for w in verdict["windows"]
            if w.get("samples")) - result["started_at"],
        "rollback_stamps": stamped,
        "accepted": verdict["accepted"], "terminal": verdict["terminal"],
        "violations": verdict["violation_count"]}
    log(f"rig 23b: {json.dumps(report_b)}")
    report = {"events_fired": len(fired), "accepted": report_a["accepted"],
              "terminal": report_a["terminal"],
              "violations": report_a["violations"] + report_b["violations"],
              "rollback_step_pct": report_b["rollback_step_pct"],
              "seconds": time.perf_counter() - t0,
              "seconds_23a": a["seconds"], "seconds_23b": b["seconds"],
              "card": CARD.get("smi")}
    log(f"rig: {json.dumps(report)}")
    return report


# -- phase 24: the examples on the port -------------------------------------

EXAMPLE_WAIT_S = 60.0     # a child's server answers, a task completes
EXAMPLE_RUN_S = 180.0     # a child that runs to its end does so within this
LOADGEN_S = 2.0           # 24b: the load generator's window, 2 in flight:
#                           the example's backend scores two at a time


def example_env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def example_cmd(name: str, *args: str) -> list[str]:
    return [sys.executable, "-m", f"ai4e_tpu_torch.examples.{name}", *args]


def start_example(name: str, args: list[str], log_path: Path
                  ) -> subprocess.Popen:
    with open(log_path, "wb") as out:
        return subprocess.Popen(example_cmd(name, *args), cwd=ROOT,
                                env=example_env(), stdout=out,
                                stderr=subprocess.STDOUT)


def example_json(url: str, body: bytes | None = None) -> dict:
    """GET ``url``, or POST ``body`` to it; the JSON answer (a status
    other than 200 raises)."""
    import urllib.request

    req = urllib.request.Request(url, data=body,
                                 method="POST" if body is not None else "GET")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def wait_listening(url: str, proc: subprocess.Popen, log_path: Path) -> None:
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + EXAMPLE_WAIT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"{url}: the example exited "
                                 f"{proc.returncode}:\n{tail(log_path)}")
        try:
            urllib.request.urlopen(url, timeout=2).close()
            return
        except urllib.error.HTTPError:
            return  # it answers
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"{url} not up in {EXAMPLE_WAIT_S} s:\n"
                         f"{tail(log_path)}")


def wait_status(url: str, want: str) -> dict:
    deadline = time.monotonic() + EXAMPLE_WAIT_S
    while time.monotonic() < deadline:
        status = example_json(url)
        if status["Status"].startswith(("completed", "failed")):
            if status["Status"] != want:
                raise AssertionError(f"{url}: {status['Status']!r}, want "
                                     f"{want!r}")
            return status
        time.sleep(0.05)
    raise AssertionError(f"{url}: not {want!r} in {EXAMPLE_WAIT_S} s")


def stop_example(proc: subprocess.Popen, log_path: Path) -> int:
    """SIGTERM and wait: the exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"the example did not stop:\n{tail(log_path)}")


def phase_echo_example(out_dir: Path) -> dict:
    """24a: the echo service, one sync and one async request, then
    SIGTERM: ``APIService.run``'s drain and exit 0."""
    port = free_port()
    log_path = out_dir / "example_echo.log"
    proc = start_example("echo_service", [str(port)], log_path)
    base = f"http://127.0.0.1:{port}/v1/echo"
    try:
        wait_listening(f"{base}/", proc, log_path)
        t0 = time.perf_counter()
        sync = example_json(f"{base}/echo", b'{"hello":"world"}')
        sync_ms = (time.perf_counter() - t0) * 1e3
        if sync != {"echo": '{"hello":"world"}'}:
            raise AssertionError(f"24a: echo answered {sync}")
        t0 = time.perf_counter()
        task = example_json(f"{base}/echo-async", b'{"x":1}')
        done = wait_status(f"{base}/task/{task['TaskId']}",
                           "completed - echoed 7 bytes")
        task_ms = (time.perf_counter() - t0) * 1e3
    finally:
        code = stop_example(proc, log_path)
    if code != 0:
        raise AssertionError(f"24a: echo exited {code} on SIGTERM:\n"
                             f"{tail(log_path)}")
    return {"sync": sync, "sync_ms": sync_ms, "task": done["Status"],
            "task_ms": task_ms, "exit": code}


def phase_platform_example(out_dir: Path) -> dict:
    """24b: one task through the async platform to ``completed``, then the
    load generator against it for ``LOADGEN_S``."""
    gw, be = free_port(), free_port()
    log_path = out_dir / "example_async_platform.log"
    proc = start_example("async_platform", [str(gw), str(be)], log_path)
    base = f"http://127.0.0.1:{gw}"
    try:
        wait_listening(f"{base}/healthz", proc, log_path)
        t0 = time.perf_counter()
        task = example_json(f"{base}/v1/camera-trap/detect", b"\xff" * 1000)
        done = wait_status(f"{base}/v1/taskmanagement/task/{task['TaskId']}",
                           "completed - scored 1000 bytes")
        task_ms = (time.perf_counter() - t0) * 1e3
        payload = out_dir / "example_payload.bin"
        payload.write_bytes(b"\x01" * 1000)
        run = subprocess.run(
            example_cmd("loadgen", "--gateway", base, "--path",
                        "/v1/camera-trap/detect", "--payload", str(payload),
                        "--concurrency", "2", "--duration", str(LOADGEN_S),
                        "--ramp", "0.5", "--task-timeout", "30"),
            cwd=ROOT, env=example_env(), capture_output=True, text=True,
            timeout=EXAMPLE_RUN_S)
        if run.returncode != 0:
            raise AssertionError(f"24b: loadgen exited {run.returncode}:\n"
                                 f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        load = json.loads(run.stdout.strip().splitlines()[-1])
    finally:
        stop_example(proc, log_path)
    if load["completed"] < 1 or load["failed"] or load["client_errors"]:
        raise AssertionError(f"24b: loadgen {load}")
    return {"task": done["Status"], "task_ms": task_ms,
            "loadgen": {k: load[k] for k in load if k not in ("metric",)}}


def phase_stream_example(out_dir: Path) -> dict:
    """24c: the streaming pipeline on the card: both stages' chunks, each
    stage's completion, then the terminal line, in that order."""
    t0 = time.perf_counter()
    run = subprocess.run(example_cmd("streaming_pipeline"), cwd=ROOT,
                         env=example_env(), capture_output=True, text=True,
                         timeout=EXAMPLE_RUN_S)
    (out_dir / "example_streaming_pipeline.log").write_text(
        run.stdout + run.stderr)
    if run.returncode != 0:
        raise AssertionError(f"24c: exited {run.returncode}:\n"
                             f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    order, chunks = [], {}
    for line in run.stdout.splitlines():
        if line.startswith("  chunk  ["):
            stage = line.split("[")[1].split("]")[0]
            chunks[stage] = chunks.get(stage, 0) + 1
            what = f"chunk {stage}"
        elif line.startswith(("  stage  [", "terminal:")):
            what = line.strip()
        else:
            continue
        if not order or order[-1] != what:
            order.append(what)
    want = ["chunk transcribe", "stage  [transcribe] completed",
            "chunk summarize", "stage  [summarize] completed"]
    seen = [w for w in order if w in want]
    if seen != want or not order[-1].startswith("terminal: completed"):
        raise AssertionError(f"24c: events in the order {order}")
    return {"chunks": chunks, "events": order,
            "seconds": time.perf_counter() - t0}


def phase_24() -> dict:
    """The port's examples (``ai4e_tpu_torch/examples``) as child
    processes: 24a the echo service, 24b the async platform and the load
    generator against it, 24c the streaming pipeline's two LMs on the
    card. Prints the ``examples`` line."""
    from concurrent.futures import ThreadPoolExecutor

    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"card": CARD.get("smi")}

    def timed_part(fn) -> dict:
        t0 = time.perf_counter()
        out = fn(out_dir)
        out["s"] = time.perf_counter() - t0
        return out

    # The three parts share nothing but the card, which only 24c uses:
    # they run at once, each one's processes its own.
    parts = {"24a_echo": phase_echo_example,
             "24b_platform": phase_platform_example,
             "24c_stream": phase_stream_example}
    with ThreadPoolExecutor(len(parts)) as pool:
        futures = {part: pool.submit(timed_part, fn)
                   for part, fn in parts.items()}
        for part, future in futures.items():
            report[part] = future.result()
    log(f"examples: {json.dumps(report)}")
    return report


def main() -> None:
    if sys.argv[1:2] == ["--detector-dct-sweep"]:
        detector_dct_sweep(int(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(*map(int, sys.argv[2:5]), sys.argv[5])
        return
    if sys.argv[1:2] == ["--detector-batches"]:
        write_detector_batches(*map(int, sys.argv[2:6]))
        return
    if sys.argv[1:2] == ["--second-stream"]:
        second_stream_main(json.loads(sys.argv[2]))
        return
    import signal

    t0 = time.perf_counter()
    signal.signal(signal.SIGTERM, on_sigterm)
    kind = phase_device()
    adopt_orphans()
    seconds: dict[str, float] = {}
    try:
        kernels = run_phases(seconds, t0)
    finally:
        left = stop_leftovers()
        if left:
            log(f"processes still running at the end, stopped: {left}")
    log(f"seconds: {json.dumps({'phases': seconds, 'second_stream': list(SECOND_STREAM), 'whole': time.perf_counter() - t0})}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def timed_into(seconds: dict[str, float], t0: float, stream: str):
    """``timed(name, fn, *args)``: ``fn(*args)`` with its wall seconds
    into ``seconds[name]``; each phase's end also goes to standard error
    with the seconds since ``t0``, so a run stopped from outside shows
    how far each stream got."""
    def timed(name: str, fn, *args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            now = time.perf_counter()
            seconds[name] = now - t
            print(f"chip_smoke {stream}: phase {name} ended after "
                  f"{now - t:.1f} s, {now - t0:.1f} s into the run",
                  file=sys.stderr, flush=True)
    return timed


#: The phases of the second stream, in its order: those before the
#: ``None`` share nothing with the first stream's but the card; those
#: after it serve phase 10's checkpoints (``SecondStream.hand_over``).
SECOND_STREAM = ("topology", "lm", "22", "23", "24", None,
                 "cache", "17", "18", "19", "20", "21")


def run_phases(seconds: dict[str, float], t0: float) -> list[dict]:
    """Phases 2-24, each one's wall seconds into ``seconds``; returns the
    kernels' records. Phases 2-6 run alone (the kernels are timed on an
    otherwise idle card), then ``SECOND_STREAM`` runs in a child process
    beside the rest."""
    timed = timed_into(seconds, t0, "first stream")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in float32
    timed("build", phase_build)
    DETECTOR_AHEAD.append(DetectorBatchesAhead())
    log("kernels: parity against the plain versions on the card")
    kernels = timed("kernels", lambda: phase_kernels() + [phase_flash()])
    e2e = timed("end_to_end", phase_end_to_end)
    lc = timed("longcontext", phase_longcontext)
    for k in kernels:
        k["launches"] = {**e2e["launches"], **lc["launches"]}[k["name"]]
    bwd, trained_npz = timed("train", phase_train_then_serve)
    kernels += bwd
    second = SecondStream([k["name"] for k in kernels],
                          time.time() - (time.perf_counter() - t0))
    try:
        runtime = timed("runtime", phase_runtime, e2e, trained_npz)
        second.check()
        timed("camera_trap", phase_camera_trap, kernels)
        second.check()
        timed("moe_vit", phase_moe_vit, kernels)
        second.check()
        _, deployed = timed("deploy", phase_deploy, kernels)
        second.hand_over(deployed)
        timed("observability", phase_observability, deployed, kernels)
        second.check()
        timed("wires", phase_wires, deployed, kernels)
        second.check()
        timed("15", phase_15, deployed, kernels, runtime["graphs"]["buckets"]
              .get("landcover/64", {}).get("replay_ms"))
        second.check()
        timed("16", phase_16, deployed, kernels)
        done = second.join()
    finally:
        second.stop()
    seconds.update(done["seconds"])
    rows = {r["name"]: r for r in done["rows"]}
    for k in kernels:
        k.update(rows[k["name"]])
        # The same numbers under the names the port's docs use.
        k["kernel_ms"], k["max_err"] = k["ms"], k["max_abs_err"]
        k["validate"] = {row: VALIDATE[row] for row in VALIDATED[k["name"]]}
    return kernels


class SecondStream:
    """``SECOND_STREAM``'s phases in a child process
    (``chip_smoke.py --second-stream``), started once the kernels are timed:
    most of a phase's wall time is its processes starting and its host
    driving them, so two streams of phases on the one card take about
    half the wall time of one. Its lines come through this process's
    ``log``; its kernel rows and seconds come back in a JSON file."""

    def __init__(self, names: list[str], started: float):
        out_dir = ROOT / "build" / "chip_smoke"
        self.handoff = out_dir / "second_stream_handoff.pkl"
        self.result = out_dir / "second_stream_result.json"
        for path in (self.handoff, self.result):
            path.unlink(missing_ok=True)
        arg = json.dumps({"names": names, "card": CARD.get("smi"),
                          "started": started,
                          "handoff": str(self.handoff),
                          "result": str(self.result)})
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--second-stream",
             arg], cwd=ROOT, stdout=subprocess.PIPE)
        self.echo = threading.Thread(target=self._echo, daemon=True)
        self.echo.start()

    def _echo(self) -> None:
        for line in self.proc.stdout:
            log(line.decode(errors="replace").rstrip("\n"))

    def check(self) -> None:
        """Raise if the stream has failed (its own error is above)."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            raise AssertionError(f"the second stream exited {rc}")

    def hand_over(self, deployed: dict) -> None:
        """Phase 10's handoff, for the stream's later phases."""
        import pickle

        tmp = self.handoff.with_suffix(".tmp")
        tmp.write_bytes(pickle.dumps(deployed))
        os.replace(tmp, self.handoff)

    def join(self) -> dict:
        rc = self.proc.wait(timeout=SECOND_STREAM_WAIT_S)
        self.echo.join(timeout=30)
        if rc != 0:
            raise AssertionError(f"the second stream exited {rc}")
        return json.loads(self.result.read_text())

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


SECOND_STREAM_WAIT_S = 900.0  # the first stream's end to the second's


def second_stream_main(arg: dict) -> None:
    """The child process of ``SecondStream``: ``SECOND_STREAM``'s phases
    in order, the later ones once phase 10's handoff is there; then the
    kernel rows (only the keys its phases set) and its phases' seconds
    into the result file. The subreaper of its own descendants, as the
    script is."""
    import pickle
    import signal

    t0 = time.perf_counter() - (time.time() - arg["started"])
    signal.signal(signal.SIGTERM, on_sigterm)
    adopt_orphans()
    parent = os.getppid()
    CARD["smi"] = arg["card"]
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds: dict[str, float] = {}
    timed = timed_into(seconds, t0, "second stream")
    kernels = [{"name": name} for name in arg["names"]]
    handoff = Path(arg["handoff"])
    deployed = workers = None
    try:
        for name in SECOND_STREAM:
            if name is None:
                deadline = time.monotonic() + SECOND_STREAM_WAIT_S
                while not handoff.exists():
                    if os.getppid() != parent:
                        raise SystemExit("the script ended first")
                    if time.monotonic() > deadline:
                        raise AssertionError("phase 10's handoff never came")
                    time.sleep(0.2)
                deployed = pickle.loads(handoff.read_bytes())
            elif name == "topology":
                topology = timed(name, phase_topology)
                for k in kernels:
                    if k["name"] in topology["launches_while_serving"]:
                        k["launches_separate_processes"] = (
                            topology["launches_while_serving"][k["name"]])
            elif name == "lm":
                timed(name, phase_lm)
            elif name == "22":
                timed(name, phase_22, kernels)
            elif name == "23":
                timed(name, phase_23)
            elif name == "24":
                timed(name, phase_24)
            elif name == "cache":
                timed(name, phase_cache, deployed, kernels)
            elif name in ("17", "18"):
                timed(name, {"17": phase_17, "18": phase_18}[name],
                      deployed, kernels)
            elif name == "19":
                workers = timed(name, phase_19, deployed, kernels,
                                keep_workers=True)["workers"]
            elif name in ("20", "21"):
                try:
                    timed(name, {"20": phase_20, "21": phase_21}[name],
                          deployed, kernels, workers)
                except BaseException:
                    kill_res_workers(workers[0])
                    raise
            else:
                raise AssertionError(f"no phase {name}")
    finally:
        left = stop_leftovers()
        if left:
            log(f"second stream: processes still running at its end, "
                f"stopped: {left}")
    tmp = Path(arg["result"]).with_suffix(".tmp")
    tmp.write_text(json.dumps({"seconds": seconds, "rows": kernels}))
    os.replace(tmp, arg["result"])


if __name__ == "__main__":
    main()
