#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``ray_tpu_torch/csrc`` with nvcc,
   one compiler per source, all at once, and checks with ``cuobjdump`` that
   the flash library holds wgmma and TMA loads and the decode library
   cp.async.
2. Holds each kernel against its plain PyTorch version on the card: bf16 at
   the shapes its main path gives it and f32 at the repo's test shapes, and
   times kernel, plain version and a library yardstick
   (``scaled_dot_product_attention``; the port never calls it) beside the
   least time the card could take, printing each kernel's rate (TFLOP/s or
   TB/s), its share of the bound and its factor behind the yardstick. Kernel
   and yardstick times are device time (CUDA-graph replay); the time of
   back-to-back calls from Python is printed beside. Decode kernels: 32
   slots, 32 query / 8 KV heads, head_dim 128, block 32, lengths spread
   over 1..1024. Flash kernel: bench_400m's attention, batch 8 x seq 2048,
   8 query / 4 KV heads, head_dim 128, causal (and batch 2, the MoE path's
   shapes); and its gradient (the blockwise recompute) against autograd
   through the reference.
3. Serving path: ``LLMServer`` on the card with Llama-3-8B's widths (random
   weights from seed 0) answers one lone greedy request (96 prompt tokens,
   32 new; its token ids are kept for phases 12 and 13), then, every launch
   counter at 0, 16 requests through ``__call__`` and ``stream`` (prompts
   of 32-256 tokens, four sharing a 64-token prefix, 32 new tokens each),
   then one ``forward_step`` with T=1 on a dense cache. The paged kernel
   must have run once per layer per decode step, the ragged kernel once per
   layer.
4. Compares ``decode_step_paged`` through the kernel with the reference
   implementation on identical (cloned) live pools at the repo's bf16 bar.
5. Training path, every launch counter at 0 (the server freed first):
   ``run_train`` on ``LlamaConfig.bench_400m()`` at 8 of its 24 layers
   (``BENCH_LAYERS``: 191 M params, random from seed 0; every bench_400m
   of phases 5-10, 14, 15, 17-19 and 22(c) is cut so, phase 16 keeps 24),
   batch 8 x seq 2048, 2 warm-up + 10 timed AdamW steps of one batch,
   full remat. The flash kernel must have run twice per layer per step
   (forward and remat recompute), and the loss must fall.
6. The loss through the flash kernel against the blockwise path on the
   same f32 params and batch, at the repo's bar (rtol 1e-3, atol 1e-4).
7. The other model families train on the card, one after another, each
   from seed 0 through ``make_train_step`` with the default AdamW
   (``ray_tpu_torch.bench.run_family``), the flash counter at 0 before each
   and each freed before the next: the f32 MLP (784-512-512-10) on 256 rows
   for 2 + 50 steps; GPT-2 125M on 8 x 1024 tokens, ViT-L/16 on 32 images of
   224 x 224 x 3, both bf16 with remat, 2 + 10 steps; the einsum-dispatch
   MoE at bench_400m's widths (8 experts, top-2) on 2 x 2048 tokens, 2 + 5
   steps. Each prints step time, tokens/s or images/s, the first and last
   loss and its params (MFU for GPT-2 and ViT); the loss must fall. The MoE
   path must launch the flash kernel twice per layer per step, GPT-2 and
   ViT (head_dim 64: the dispatcher's reference attention, JAX's rule) never.
8. The MoE loss through the flash kernel against the blockwise path (f32
   params, batch 2 x 2048) at phase 6's bar; GPT-2 125M and ViT-L/16 in
   f32 on the card against the same port model on the CPU (GPT-2 1 x 256
   tokens, ViT 2 images), rtol 1e-3.

9. The mesh path (``ray_tpu_torch.parallel``): ``build_mesh(MeshSpec())``
   starts a world-size-1 NCCL group and a mesh with all six axes of size 1
   (NCCL refuses two ranks on one card, so one card holds no mesh of more
   than one rank; the sharded numbers are held against JAX on CPU meshes by
   tests/test_torch_spmd.py). Every counter at 0: ``run_train(mesh=...)``
   on bench_400m at phase 5's shapes, every leaf a DTensor and the flash
   kernel run on each rank's local shards, twice per layer per step; its
   first loss and grad norm must equal phase 5's (same seed and batch) at
   rtol 1e-3, and its loss must fall. Step time, tokens/s, MFU and kernel
   launches a step (one profiled step) are printed beside phase 5's. Then
   the GPT-2 DP example at full width (GPT-2 125M, 8 x 1024 tokens, 2 + 5
   steps, the all-dp mesh): the loss must fall; and phase 7's GPT-2 run on
   the mesh, its first loss held to phase 7's. Last, the sharded bench_400m
   params and AdamW state after one step are saved (``train.checkpoint``)
   and restored onto the mesh and with no mesh: every leaf bit for bit.
10. Sequence, expert and pipeline parallelism, every counter at 0 before
   each run: (a) phase 7's MoE workload with the expert all-to-all
   (``moe_dispatch="alltoall"``) on the one-rank mesh: at ep 1 it is the
   einsum scheme's math, so its first loss must equal phase 7's at rtol
   1e-3; the loss must fall and flash launch twice per layer per step;
   (b) ring and Ulysses attention at sp 1 (no exchange runs) at
   bench_400m's attention shapes: bf16 against the flash kernel at the
   bf16 bar, f32 gradients against autograd through the reference at the
   gradient bar, each timed; (c) the GPipe schedule (``pipelined``) over
   the mesh's one stage of bench_400m's 8 layers, ``PipelinedLlama``'s
   stage body and apply, 4 microbatches of 2 x 2048, remat: first loss
   against phase 5's at rtol 1e-3, flash launched 2 x 8 x 4 times a
   step, step time beside phase 5's; (d) ``dryrun_mesh(8)``: one step of
   each parallel layout on 8 gloo ranks of this machine's CPU (NCCL holds
   one rank a card, so meshes of more ranks meet this torch here), each
   loss against the port's one-device loss.
11. The RL learners (``ray_tpu_torch.rl``) on the port's runtime, every
   kernel counter at 0 before and read after (they launch none of the
   port's kernels): ``rl.Algorithm`` drives EnvRunner actors of
   ``ray_tpu_torch.init()`` on CartPole with the learner and the runners'
   policies on the card (sample, update, send the weights back through the
   object store's device tier; IMPALA and APPO one fragment an update, the
   weights to the runner that delivered it). (a) Each learner at the CPU
   tests' configurations (``RL_CASES``) takes one update on the card and
   on the CPU from the same state (``load_learner_state``), held to the
   tests' bars; (b) the JAX tests' learning bars on the card (PPO, IMPALA,
   SAC, DQN through ``Algorithm``; BC and CQL from logged batches); (c) the
   five tuned CartPole contracts through ``rl.tuned_examples.run`` (JAX's
   full-width RL configurations), reported and not gated: best return and
   iterations, update ms on the card and on this machine's CPU (median of
   5), gradient steps a second, one profiled update's launches a step and
   device-busy share, and an iteration split into the learner's update,
   the runners' work and the runtime's own cost; (d) ``LearnerGroup`` on
   the one-rank NCCL mesh, PPO's and IMPALA's update against the plain
   learner's at rtol 1e-6.
12. The runtime on the card (``ray_tpu_torch.init()``): (a) the card is
   detected as ``GPU``, a ``num_gpus=1`` task runs in this process on it
   and gives the resource back, and the GCS's KV snapshot, restored over
   a delete, an overwrite and a new key, gives its tables back; (b) a 256 MiB bf16 CUDA tensor through
   ``put``/``get`` keeps its storage and allocates nothing, a
   ``num_gpus=1`` task's sum of it equals this process's, and it is freed on
   ``del``; (c) ``LLMServer`` as a ``num_gpus=1``, ``max_concurrency=16``
   actor with phase 3's config: the lone request gives phase 3's token ids
   and, every counter at 0, phase 3's 16 requests go through
   ``__call__.remote`` and streaming ``stream`` calls, collected with
   ``wait``; the prefix path runs, the paged kernel once per layer per
   decode step and no other kernel; a ``num_gpus=1`` task submitted while
   the actor lives stays pending until ``kill``; tokens/s beside phase 3's;
   (d) no-op tasks, actor calls and 1 MiB put/get round trips a second;
   (e) phase 11's iteration split, printed with the card's power limit.
13. Serve on the card (``ray_tpu_torch.serve``), on a fresh ``init()``
   once phase 12's runtime and its server are gone, with phase 3's config
   and mix: (a) ``serve.run(build_llm_app(config))`` (one replica, weights
   from seed 0 in the replica): the lone request through the handle gives
   phase 3's token ids; every counter at 0, phase 3's 16 requests, 8
   unary and 8 streams (``handle.options(stream=True)``) in phase 12's
   order; the prefix path runs, the paged kernel once per layer per decode
   step of the replica's engine and no other kernel; tokens/s beside
   phases 3 and 12, the client's time to each stream's first chunk and the
   engine's ``ttft_s``; (b) ``serve.start_http_proxy``: the lone request as
   JSON and as SSE gives phase 3's token ids, then ``[DONE]``; (c)
   ``serve.delete``: no engine thread is left and the card's allocated
   bytes are back within 256 MiB of the base; (d)
   ``build_pd_disagg_app`` (one prefill, one decode replica, about 37 GB):
   the lone request through the orchestrator gives phase 3's token ids,
   then phase 3's 16 prompts at once, the paged kernel once per layer per
   decode step of the decode engine; tokens/s, the KV handoff's bytes and
   ms a request; freed on ``serve.shutdown`` as in (c); (e) the serve data
   plane's own cost on this host: 1,000 sequential handle calls and 1,000
   in flight at once on 2 no-op replicas, a second each, beside phase 12's
   actor calls. Alone: ``python -c "import chip_smoke, torch;
   chip_smoke.serve_path(torch.device('cuda'))"``.
14. The open-loop serving bench (``ray_tpu_torch.llm.bench``) on a fresh
   ``init()``, every counter at 0 before each run: (a)
   ``run_serving_bench(n_layers=8)`` (``bench_400m`` at max_seq 1024 and
   8 of its 24 layers, random from seed 0, one replica of 32 slots, the
   paged kernel; seeded Poisson arrivals at 6 requests/s for 16 s, 64
   clients, prompts of 32-256 tokens, 64 new tokens, every prefill bucket
   warmed first), streams through the
   handle: every scheduled request completes with no error and no
   abandoned client, the paged kernel once per layer per decode step of the
   replica's engine and no other kernel; ``serving_section`` with the
   client's TTFT/E2E/TPOT percentiles, goodput and the engine's own
   ``ttft_s``; (b) the same load as unary calls (the router's waiter path),
   beside (a); (c) ``run_http_proxy_bench(n_layers=8)``: 64 requests, 16
   at a time, 64 tokens, every SSE stream ending in ``[DONE]``; then the card's
   allocated bytes are back within 256 MiB of the base. Before (a), the
   paged kernel is held to its plain version at the bench's shapes (B 32,
   8 query / 4 KV heads, D 128, block 32, lengths 32-320 across the
   128-row chunk edges, bf16). Alone:
   ``python -c "import chip_smoke, torch;
   chip_smoke.serving_bench_path(torch.device('cuda'))"``.
15. The train driver (``ray_tpu_torch.train.JaxTrainer``) on a fresh
   ``init()``, the flash counter at 0 before each run: (a) one worker in a
   placement group whose bundle holds the card (``ScalingConfig(use_gpu=
   True)``) trains bench_400m for 6 AdamW steps at phase 5's batch (8 x
   2048, seed 0, full remat) through ``make_train_step``: the flash kernel
   2 x 8 times a step, the first loss held to phase 5's, a ``num_gpus=1``
   task submitted during ``fit()`` pending until the group is gone, the
   step time beside phase 5's; (b) the same with
   ``FailureConfig(max_failures=1)``: rank 0 checkpoints params and AdamW
   state after step 3 (2.3 GB in f32), the loop raises once before step 4,
   the group re-forms from the checkpoint and steps 4-5 are held to (a)'s;
   the checkpoint's write and restore seconds; (c) no train worker thread
   left and the card's allocated bytes back within 256 MiB of the base.
   Alone (it runs phase 5 first): ``python -c "import chip_smoke, torch;
   chip_smoke.train_driver_path(torch.device('cuda'))"``.
16. Tune and the utilities (``ray_tpu_torch.tune``, ``ray_tpu_torch.util``)
   on a fresh ``init()``, the flash counter at 0 before each part: (a) a
   ``Tuner`` over a function trainable (bench_400m at all of its 24
   layers, ``TUNE_LAYERS``, and phase 5's batch, up to 6 AdamW steps at
   the trial's lr, each reported) with
   ``AsyncHyperBandScheduler(grace_period=2, reduction_factor=2,
   max_t=6)`` over lr 1e-3, 0.0 and 3e-4, one trial at a time: every
   first loss is ``run_train``'s at that depth, the lr 0.0 trial is
   stopped at iteration 2 with the initial loss, the best lr is 1e-3, the
   scheduler's decisions replay on a fresh one, flash 2 x 24 times a
   reported step, and each
   trial starts with the card's bytes within 256 MiB of the base (a
   stopped trial's model is freed, ROADMAP C11); (b) Train-on-Tune: a
   ``Tuner`` over a ``JaxTrainer`` of phase 15's loop (3 steps,
   ``ScalingConfig(use_gpu=True)``) over two lrs, both trial actors at
   once: the second group's bundle waits until the first is gone, so the
   step windows do not overlap, each trial's metrics are its rank 0's last
   report, the peak bytes are one trial's; (c) ``util.collective`` between
   two ``num_gpus=0.5`` actors on 64 MiB bf16 CUDA tensors (allreduce
   against the sum in torch, allgather, broadcast, reducescatter,
   send/recv; every result on the card, in bf16, the parts uncopied),
   ``ActorPool.map`` and ``Queue`` handing a CUDA tensor over uncopied;
   after ``shutdown()`` no trial, train-worker, queue or collective thread
   is left and the card's bytes are back within 256 MiB of the base.
   Alone: ``python -c "import chip_smoke, torch;
   chip_smoke.tune_path(torch.device('cuda'))"``.
17. The data layer and the device feed (``ray_tpu_torch.data``) on a fresh
   ``init()``, the flash counter at 0: (a) ``JaxTrainer(datasets={"train":
   ds})`` with one worker holding the card, ``ds`` 64 x 2048 tokens from
   seed 0 (its first 8 rows phase 5's batch), targets added by
   ``map_batches``, 8 blocks; the loop feeds
   ``get_dataset_shard("train").to_jax(batch_size=8, prefetch=2)`` (pinned
   staging, a side-stream copy) into bench_400m's step for 6 AdamW steps
   (full remat): the flash kernel 2 x 8 x 6 times, the first batch phase
   5's and the first loss phase 5's to every printed digit, the step
   median beside phase 5's; (b) BASELINE config 4 at ImageNet's widths:
   2,048 records of a 224 x 224 x 3 uint8 image, a label and an index
   (seed 0, 308 MB; the count cut to the run's time) written with
   ``write_numpy`` as 16 shards, read back with ``read_numpy``,
   normalised to f32 by an actor pool, ``streaming_split(1)``; pass 1
   feeds the card alone (images/s, GB/s beside a plain pinned ``copy_`` of
   one batch, the object store's peak, the first batch held to its
   records' values), pass 2 feeds ViT-L/16's train step (8 of its 24
   layers, ``VIT_LAYERS``) at 32 images (images/s beside the bare step
   on a resident batch, the device-busy share of one profiled window;
   head_dim 64 runs the reference attention, so no kernel of the port);
   (c) TFRecord and Avro round trips, ``iter_torch_batches`` onto the
   card, the feed's pinned staging and side stream checked directly;
   after ``shutdown()`` no prefetch, map-pool, shuffle or train-worker
   thread is left and the card's bytes are back within 256 MiB of the
   base. Alone (it runs phase 5 first):
   ``python -c "import chip_smoke, torch;
   chip_smoke.data_path(torch.device('cuda'))"``.

18. Process workers, the runtime's default (every phase but 17 runs on
   it; phase 17 runs every task and actor on the driver's threads,
   ``IN_THREADS``, as the in-thread reference), on a fresh ``init()``:
   (a) 1,000 no-op tasks in worker processes (plain tasks take the fast
   lane, the default), none in the driver, ``CUDA_VISIBLE_DEVICES=''`` and
   ``torch.cuda.is_available()`` False in each, their rate beside the same
   tasks on a fresh ``init()`` with the lane off (the classic pipe) and on
   the driver's threads; a
   module on the card as an argument, a closure over a CUDA tensor and an
   actor given a factory closing over the card's device run in the driver
   and give CUDA tensors, and a process actor refuses a CUDA argument; a
   SIGKILLed process actor restarts; a task whose worker is SIGKILLed
   gives its retry's result; (b) phase 17(b) with the reads and the
   normalising actor pool in worker processes: images/s alone and into
   ViT-L/16's step beside phase 17's in-thread figures and the bare step;
   (c) phase 17(a) with the dataset's tasks in worker processes, the flash
   counter at 0: 2 x 8 x 6 launches, the first loss phase 5's exactly;
   (d) a 256 MiB bf16 CUDA tensor and a one-rank DTensor through
   ``wire_dumps``/``wire_loads``: back on the card bit-equal, and CPU
   tensors bit-equal in a worker; (e) after ``shutdown()`` and
   ``stop_worker_plane()`` no worker process, no forkserver and no bytes
   above the base on the card. Alone (it runs phase 5 first):
   ``python -c "import chip_smoke, torch;
   chip_smoke.process_path(torch.device('cuda'))"``.
19. The runtime's native host tier on a fresh ``init()``: the fast lane
   (``_private/fast_lane.py``, the C++ core ``csrc/daemon_core.cc`` on a
   thread of this process) and the shared-memory store
   (``native_store.py``, ``csrc/shm_store.cc``), both built with g++ from
   the checkout at the script's start: (a) 1,000 no-op tasks counted by the lane's core, none in
   the driver, every lane worker without the card, their rate beside 18(a)'s
   classic pipe and the driver's threads; a running lane task cancelled
   soft and forced; a lane worker SIGKILLed mid-task and its task's retry
   giving the result; (b) three lane tasks return q, k and v as f32 numpy
   arrays at bench_400m's attention shapes (8 x 2048 x 8 x 128 and 8 x 2048
   x 4 x 128, 128 MiB): the node's store takes each into its arena
   (``native_puts`` +3), ``get`` hands out read-only views inside the
   arena, equal to their seeds' values; the store's put and get times;
   the views go to the card as bf16 through ``flash_fwd_wgmma`` (one launch,
   counted) and are held to the plain version at the bf16 bar; the
   ``/dev/shm`` mount's size and the arena's; (c) phase 17(a) with the
   data's plain tasks on the lane (the core counts them), the flash
   counter at 0: 2 x 8 x 6 launches, the first loss phase 5's exactly;
   (d) after ``shutdown()`` and ``stop_worker_plane()`` no lane worker, the
   core's port closed, no ``/dev/shm`` segment of this process and no bytes
   above the base on the card. Alone (it runs phase 5 first):
   ``python -c "import chip_smoke, torch;
   chip_smoke.native_path(torch.device('cuda'))"``.
20. The daemon cluster, ``init(cluster="daemons", num_nodes=2,
   resources={"CPU": 4})``: a head and two node-daemon processes
   (``_private/{head,daemon,cluster}.py`` on the port's RPC wire, each
   daemon with PR 15's core and a 2 GiB arena): (a) the head and both
   daemons alive, ``daemon_ping`` gives each one's pid; 1,000 no-op tasks
   in the daemons' workers (their cores count them), none in the driver,
   their rate beside 19(a)'s lane and the driver's threads; a nested get
   reaches the owner; a STRICT_SPREAD group of two bundles committed on
   both daemons by the two-phase commit; (b) three daemon tasks (q and v
   on one daemon, k on the other) make q, k and v at bench_400m's
   attention shapes, each left in its daemon's arena; one chunked pull
   copies q (64 MiB) to the other daemon, where a task reads it as a view
   of its arena; the driver gets the three as read-only views inside the
   arenas, equal to their seeds' values; to the card as bf16 and
   ``flash_fwd_wgmma`` once (counted), held to the plain version; (c) the
   views released, the daemon holding k SIGKILLed: the head marks it dead,
   an actor on it (``max_restarts=1``) restarts on the other daemon, the
   driver's get of k rebuilds it through lineage there, and the kernel on
   it gives (b)'s output bit for bit (one more launch); (d) at init, after
   (b) and after (c) nvidia-smi lists one context on the card, no process
   of the cluster maps the CUDA driver and the driver does; (e) after
   ``shutdown()`` no head, daemon or worker process, no ``/dev/shm``
   segment of the arenas, no session dir and no bytes above the base on
   the card. Alone (it runs phase 5 first): ``python -c "import
   chip_smoke, torch; chip_smoke.daemon_path(torch.device('cuda'))"``.
   Phases 12-20 run on the runtime's default control-plane core, the
   asyncio one (``_private/{eventloop,aio}.py``).
21. The asyncio control-plane core, a cluster from the CLI, a drain and
   other drivers: (a) ``init()`` runs the loop core (``debug_state()`` has
   ``loop=``, the event loop runs); 1,000 no-op tasks on the driver's
   threads (``IN_THREADS``) on each core in three alternated pairs, the
   rates, the loop's largest lag sample and its slow-callback count;
   (b) ``python -m ray_tpu_torch.scripts.cli start --head --num-daemons 2``
   with ``RAY_TPU_ASYNC_CORE=0`` (the daemons on the threaded core), this
   driver joined with ``init(address=)`` on the asyncio core
   (``describe_peers`` says ``core=threaded``, ``cluster-status`` lists two
   alive); three daemon tasks make q, k and v at bench_400m's attention
   shapes (k on the second daemon), got as read-only views in the arenas,
   to the card as bf16 and ``flash_fwd_wgmma`` once (counted), held to the
   plain version; (c) an actor (``max_restarts=1``) and a 3 s task on k's
   daemon, ``drain_node(<k's node>, deadline_s=20)``: the head and
   ``cluster-status`` show it DRAINING, k is pushed to the other daemon
   (``drain_objects_migrated`` >= 1, nothing reconstructed), the actor
   answers from the survivor, the drained daemon leaves once its task is
   done and the head marks it dead; the get of k is a view in the
   survivor's arena and the kernel on it gives (b)'s output bit for bit
   (one more launch); the drain's ms to the migration, the actor's answer
   and the node's exit; (d) with this driver's tasks in flight, three
   more drivers at once: a CPU subprocess through ``cli attach`` runs tasks
   on the survivor, a ``cli job-submit`` entrypoint joins as a driver and
   runs to SUCCEEDED, a ``util.client`` subprocess puts 64 MiB through
   ``serve_cluster`` in this driver and gets a task's sum of it; each runs a
   lambda only it knows, each driver's worker lines reach it alone, and a
   task of this driver started after they joined runs a fresh function
   and a nested put/get; nvidia-smi lists one context and no process of
   the cluster maps the CUDA driver; (e) this driver's ``shutdown()`` leaves the cluster up
   (``cluster-status`` answers), then ``cli stop``: no head, daemon or
   worker process, no ``/dev/shm`` segment of the arenas, no cluster file
   or session dir and no bytes above the base on the card. Alone (it runs
   phase 5 first): ``python -c "import chip_smoke, torch;
   chip_smoke.control_plane_path(torch.device('cuda'))"``.
22. The rest of the cluster: (a) on ``init(cluster="daemons",
   num_nodes=2, resources={"CPU": 4})`` a serialized actor is lane-bound
   (a tag in its daemon's native core) and a ``max_concurrency=2`` one of
   the same class is not; 1,000 calls on each in three alternated pairs,
   calls/s, the cores' ``submitted`` count rising by every lane call and
   by no classic one; the lane-bound actor makes q, k and v at phase 20's
   seeds and shapes into the arenas (a worker ``put``), the driver reads
   them as read-only views into ``flash_fwd_wgmma`` (one launch, counted),
   held to the plain version; its worker SIGKILLed, the actor answers
   under a fresh tag; (b) ``csrc/cpp_client.cc`` and
   ``csrc/api_demo.cc``, g++-built into the build directory at the
   script's start; the demo (no Python in
   its process) drives the cluster and prints the CPU test's lines; the
   client (through ``cpp_client.py``) writes q's bytes into a daemon's
   table, the driver reads them (``get_object_blob``) into the kernel (one
   launch), bit for bit (a)'s output; the build and demo times and the
   put's MB/s; (d, first half) a ``ProcessHostProvider`` and
   ``Reconciler`` on (a)'s cluster provision a real daemon for a
   ``{"CPU": 16}`` bundle, a ``num_cpus=9`` task lands there, and idle it
   is drained and its process ends; (c) on a fresh ``init()``, bench_400m's
   app (phase 14's, 32 slots, 8 layers) behind ``start_grpc_proxy()`` takes 8
   ``predict`` and 8 ``predict_stream`` requests (prompts of 32-256 tokens,
   32 new, greedy, one at a time) and gives the tokens of the same requests
   through the handle of a second copy of the app, the paged kernel once
   per layer per decode step of both engines; a stream's first chunk, a
   unary result and tokens/s beside the handle's; (d, second half) ``cluster_launcher.up``
   from a JSON config (a head and two workers), a CPU driver (a subprocess,
   the card hidden) joins and runs tasks, ``down`` ends the three; (e) at
   (a), (b) and with the launcher's cluster up nvidia-smi lists one
   context and no process of the clusters maps the CUDA driver; after them
   no head, daemon or worker process, no ``/dev/shm`` segment of the
   arenas, no session dir and no bytes above the base on the card. Alone:
   ``python -c "import chip_smoke, torch;
   chip_smoke.cluster_tier_path(torch.device('cuda'))"``.
23. Observability: (a) on ``init(cluster="daemons", num_nodes=2,
   resources={"CPU": 4})`` with ``export_events`` on (the daemons spawned
   with the fast lane off: JAX's lane records no dispatch or exec span),
   daemon tasks make q, k and v at phase 20's seeds and shapes, the driver
   reads them as arena views into ``flash_fwd_wgmma`` (one launch) inside
   ``tracing.span("flash_forward")``, held to the plain version; the span
   covers the kernel's CUDA-event time; q's ``task_breakdown`` has the
   eight phases with dispatch, exec and result_flush above 0, and
   ``cluster_timeline()`` has its driver, daemon and worker lanes and the
   span; the export events' JSONL holds task, actor, node, job and
   placement-group states; (b) a user ``Counter`` incremented once a task
   on both daemons sums to the tasks at the head's federated exposition,
   whose ``ray_tpu_task_phase_seconds`` carries both daemons' dispatch
   series; the dashboard (a free port) answers ``/api/nodes``,
   ``/api/tasks``, ``/api/objects``, ``/api/timeline`` and ``/metrics``,
   each daemon's agent ``/api/stats``; ``cli status``, ``summary`` and
   ``timeline`` against the cluster's address exit 0; daemon workers'
   prints reach this process's stdout as ``(worker node=.. pid=..)``; (c)
   the kernel in a loop for 1.5 s while ``cluster_profile(duration_s=1.0)``
   samples: records from the driver (its stacks in the flash launcher,
   ``attention.py``), both daemons and each daemon's workers; (d) on a
   fresh ``init()`` the kernel's output ``put``: the owner store's
   ``device-hbm`` tier holds exactly its bytes, 0 once freed; the memory
   monitor's host limit; (e) 2,000 no-op tasks on the default ``init()``,
   ``task_trace`` on and off in three alternated pairs, and ``cli
   microbenchmark --duration 0.5``; (f) at (a) and (c) nvidia-smi lists one
   context and no process of the cluster maps the CUDA driver; after it no
   process, no ``/dev/shm`` segment, no listening dashboard or agent port,
   no session dir, and the card within 64 MiB of its base. Alone:
   ``python -c "import chip_smoke, torch;
   chip_smoke.observability_path(torch.device('cuda'))"``.
24. Chaos: (a) daemon tasks (two returns: the submit coalescer and the
   result pump) make q, k and v at phase 20's seeds and shapes into
   ``flash_fwd_wgmma`` (one launch, held to the plain version) on
   ``init(cluster="daemons", num_nodes=2, resources={"CPU": 4})``, once
   with nothing armed and once with seed 24's ``failpoints`` (the driver's
   ``batch.submit_flush`` drop, the daemons' ``batch.result_flush`` drops
   and ``daemon.push_task`` delays) and ``net_chaos`` (driver->daemon
   latency, jitter and duplicates): the outputs bit for bit, each body run
   once, the driver's fire counts and the daemons' ``ray_tpu_retries_total``
   and ``ray_tpu_link_chaos_injected_total`` at the head's federated
   exposition above 0, duplicated pings answered once; the time of each;
   (b) on a fresh cluster the lane's first connect rides ``RetryPolicy``
   past a ``cluster.lane_reconnect`` error arm (``max=2``), then a one-way
   driver->daemon partition (control link and lane, a 3 s window) opens
   mid-burst of lane and classic tasks: the silent flush times out
   (``control_call_timeout_s`` 1.5) and marks the node dead, every task
   gives its value once, the victim's late frames count in
   ``ray_tpu_fenced_results_total``, and q, k and v made across the
   partition give (a)'s output bit for bit; (c) ``memory_pressure`` with
   arenas of 8 x q's bytes, watermarks 0.2,0.45, a spill budget of 1.5 x
   q's bytes and a 0.1 s tick: a ballast past soft spills the cold q, whose
   get restores it into the kernel bit for bit (a)'s output; three more
   with the budget spent go hard: a task whose argument lives on the hard
   node lands on the other, a put rides ``RetryPolicy`` through
   ``MemoryPressureError`` until the ballast is freed; each level change is
   printed; (d) a daemon worker's task raises with post-mortem on: ``cli
   debug`` lists its session, ``rpdb.connect`` prints a local and
   continues, the error reaches the driver; (e) everything disarmed, the
   lane's no-op tasks/s on the default ``init()`` beside phase 19's; (f) at
   (a) and (c) nvidia-smi lists one context and no process of the clusters
   maps the CUDA driver; after it no process, no ``/dev/shm`` segment, no
   session or spill dir, and the card within 64 MiB of its base. Alone:
   ``python -c "import chip_smoke, torch;
   chip_smoke.chaos_path(torch.device('cuda'))"``.
25. Tenancy, job config, runtime envs and the compiled DAG (the flash
   counter at 0 before the phase): (a) JAX's isolation A/B
   (tests/test_tenancy.py:403) on ``init(num_nodes=1, resources={"CPU":
   2})``: a job "light" submits eight tasks one at a time, each making q,
   k and v at phase 20's seeds and shapes, which the driver runs through
   ``flash_fwd_wgmma`` (held to the plain version, bit for bit the first
   output); alone under ``fairshare``, then behind 160 queued 50 ms tasks
   of a job "heavy" with ``fairshare`` on (the light p99 within 3 x
   max(solo p99, 0.15 s)) and off (above 3 x solo); a third job with a hard
   CPU quota of 0 has its four tasks QUEUED (none runs) until the quota is
   raised, then all give their values; the dashboard's ``/api/jobs`` is
   printed; (b) ``init(job_config=JobConfig(...))`` with an env var and a
   ``code_search_path`` module: a worker task imports the module, reads the
   variable and makes q, k and v whose kernel output is (a)'s bit for bit;
   a task's own ``working_dir`` env runs in a worker process from the
   package cache; (c) process-worker stages ``Make -> Scale`` of q, k and v
   (batch 2, 32 MiB a round) compiled over shm channels: 50 rounds
   compiled and 50 through ``.execute()`` bit for bit, ms a round of each,
   the kernel on each compiled round in the driver; then a channel-mode
   DAG of in-process stages whose last one runs the kernel on the card,
   compiled and dynamic, bit for bit the driver's outputs; (d) after it no
   worker process or forkserver, no new ``/dev/shm`` segment, no session
   dir, and the card within 64 MiB of its base. Alone: ``python -c "import
   chip_smoke, torch; chip_smoke.tenancy_path(torch.device('cuda'))"``.
26. Topology (the flash counter at 0 after the driver's own launch): (a)
   with no pod variable set, ``detect_tpu_chips()`` is
   ``torch.cuda.device_count()``, ``accelerator_resources()`` is ``GPU``
   and the card's accelerator type, and ``detect_local_topology()`` is None
   for one card; (b) ``init(num_nodes=4, resources={"CPU": 4, "GPU": 4},
   _system_config={"tpu_topology": "v5p:2x2x4"})``, a virtual slice on one
   card: a PACK group of two 4-chip bundles claims one contiguous 8-chip
   box on exactly two hosts, and a ``num_gpus=1`` task in each bundle draws
   q, k and v on the card at phase 5's shapes and launches
   ``flash_fwd_wgmma``, each output bit for bit the driver's launch outside
   any group (held to the plain version); (c) a second group fills the 16
   chips and a third stays pending until the first is removed, then claims
   a contiguous box and its task launches the kernel; its node removed,
   it is placed again on the surviving hosts, the allocator holding one
   slice for it, and its task launches again; (d) a node that holds a
   running task while it drains takes no new bundle; (e) with the groups
   removed and after ``shutdown()`` the allocator is empty, no worker is
   left and the card is within 64 MiB of its base. Alone: ``python -c
   "import chip_smoke, torch;
   chip_smoke.topology_path(torch.device('cuda'))"``.

Early it prints the host's cores and a pure-Python yardstick; along the
way a ``stamp <label>: <s> s (at <s> s)`` line for each lettered sub-step
of phases 11-13 and 18-25 and each runtime ``init``/``shutdown``. It
prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script then exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # outside the tensor cores
# kernel vs plain, bf16 output: mostly relative, two bf16 ulps (2**-6); the
# atol covers outputs near 0, whose magnitude is ~1/sqrt(length)
BF16_TOL = dict(atol=5e-3, rtol=1.6e-2)
STEP_TOL = dict(atol=0.15, rtol=0.05)   # tests/test_llm_paged.py bf16 bar
F32_FLASH_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_ops.py:324
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)        # tests/test_ops.py:359
LOSS_TOL = dict(atol=1e-4, rtol=1e-3)        # tests/test_ops.py:378


# Phase 17 runs every task and actor on the driver's threads (JAX's
# RAY_TPU_PROCESS_WORKERS=0): its figures are the in-thread reference that
# phase 18(b, c) repeats with the data's tasks in worker processes. Every
# other phase runs on the runtime's default, process workers.
IN_THREADS = {"process_workers": False}

# Depth cut: the script's time limit stays fixed while its phases grow, so
# every bench_400m of phases 5-10, 14, 15, 17-19 and 22(c) runs
# BENCH_LAYERS of the preset's 24 layers, and the ViT-L/16 of phases 17(b)
# and 18(b) VIT_LAYERS of its 24. Widths, shapes, batches, step counts and
# checks are the presets'. The MoE, GPT-2 and ViT of phases 7, 8 and 10(a)
# keep their depth.
BENCH_LAYERS = 8
VIT_LAYERS = 8
# Phase 16 keeps bench_400m's 24 layers: its check that ASHA's best trial
# is lr 1e-3 holds that depth (at 8 layers lr 3e-4 reaches the lower loss)
TUNE_LAYERS = 24


def bench_config(n_layers: int = BENCH_LAYERS, **kw):
    """``LlamaConfig.bench_400m(**kw)`` at ``n_layers`` layers."""
    from ray_tpu_torch.models import LlamaConfig
    return dataclasses.replace(LlamaConfig.bench_400m(**kw),
                               n_layers=n_layers)


def vit_config():
    """``ViTConfig.vit_l16()`` at ``VIT_LAYERS`` layers."""
    from ray_tpu_torch.models import ViTConfig
    return dataclasses.replace(ViTConfig.vit_l16(), n_layers=VIT_LAYERS)


def log(msg: str) -> None:
    print(msg, flush=True)


T_START = time.perf_counter()


def poll(cond, timeout: float, what: str, every: float = 0.01) -> None:
    """Wait until ``cond()`` holds: the condition a fixed sleep would only
    hope for. Raises after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"phase {what}: not within {timeout} s")
        time.sleep(every)


class timed(contextlib.ContextDecorator):
    """A sub-step's host-clock seconds, logged as ``stamp <label>: <s> s
    (at <s since the script started> s)`` when a decorated function or a
    ``with`` block ends, passed or failed."""

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        log(f"stamp {self.label}: {now - self.t:.2f} s (at "
            f"{now - T_START:.1f} s)")
        return False


def tol_ratio(a, b, tol=BF16_TOL) -> float:
    """max |a - b| / (atol + rtol |b|): above 1 fails ``tol``."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())) \
        .max().item()


def bound_ms(bytes_moved: float, ops: float, dtype) -> tuple:
    dname = str(dtype).replace("torch.", "")
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_work(lengths, H, Hkv, D, elt, tables_read=0):
    """Bytes and operations one decode-attention call needs for these
    lengths: K and V of the live context, q, out, lengths and the table
    entries it reads; two multiply-adds per (head, row, d)."""
    live = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * live * Hkv * D * elt + 2 * B * H * D * elt + 4 * B
              + 4 * tables_read)
    return nbytes, 4 * H * D * live


def sdpa_ms(q, k_dense, v_dense, lengths, iters):
    """The library yardstick: one SDPA call on the dense [B, S, Hkv, D]
    view with a length mask and grouped heads."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.profile_kernels import graph_ms
    S = k_dense.shape[1]
    qq = q[:, :, None, :]                                   # [B, H, 1, D]
    kk = k_dense.transpose(1, 2)                            # [B, Hkv, S, D]
    vv = v_dense.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True), iters)


# the Hopper instructions each library must hold: wgmma (HGMMA) fed by TMA
# (UTMALDG) for the flash kernel, cp.async (LDGSTS) for the decode kernels
SASS_NEEDS = {"flash_attention": ("HGMMA", "UTMALDG", "SYNCS"),
              "decode_attention": ("LDGSTS",)}


def check_sass(name: str, lib_path) -> None:
    """Count the instructions of ``SASS_NEEDS`` in the built library with
    the toolkit's ``cuobjdump -sass``; raise if one is missing."""
    from pathlib import Path
    from ray_tpu_torch import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in SASS_NEEDS[name]}
    log(f"  sass of {lib_path.name}: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"{name}: instructions missing from the build: "
                           f"{counts}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, gen) -> list:
    import torch
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.profile_kernels import eager_ms, graph_ms

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # f32 at the repo's test shapes, the repo's own tolerances
    q, kp, vp = (rand((4, 8, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32))
    tables = torch.randperm(32, generator=gen, device=dev)[:24] \
        .view(4, 6).int()
    lens = torch.tensor([1, 16, 37, 96], dtype=torch.int32, device=dev)
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens,
                                      scale=128 ** -0.5)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    err_paged_f32 = (out - plain).abs().max().item()
    errs_ragged_f32 = []
    for B, S, H, Hkv, D, lengths in ((4, 256, 8, 2, 32, [1, 100, 200, 256]),
                                     (2, 96, 4, 4, 16, [37, 96])):
        q = rand((B, H, D), torch.float32)
        k = rand((B, S, Hkv, D), torch.float32)
        v = rand((B, S, Hkv, D), torch.float32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = dec.ragged_decode_attention_kernel(q, k, v, lens)
        plain = dec._ragged_decode_plain(q, k, v, lens, block_k=64,
                                         scale=D ** -0.5)
        torch.testing.assert_close(out, plain, atol=2e-6, rtol=2e-5)
        errs_ragged_f32.append((out - plain).abs().max().item())
    log(f"f32 at the repo's test shapes: paged max_abs_err "
        f"{err_paged_f32:.3e} (tol 1e-4), ragged {errs_ragged_f32} "
        f"(rtol 2e-5 atol 2e-6)")

    # bf16 at the slice's shapes
    B, H, Hkv, D, bs, maxb = 32, 32, 8, 128, 32, 32
    NB = B * maxb + 1                          # + the engine's scratch block
    dt = torch.bfloat16
    scale = D ** -0.5
    lengths = np.linspace(1, maxb * bs, B).round().astype(np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    # a wrong kernel to hold the bound against: each slot longer than 512
    # loses its last 32-row tile
    long_slots = torch.from_numpy(np.flatnonzero(lengths > 512)).to(dev)
    short = torch.from_numpy(lengths - ((lengths - 1) % 32 + 1)).to(dev)
    q = rand((B, H, D), dt)
    kp, vp = rand((NB, bs, Hkv, D), dt), rand((NB, bs, Hkv, D), dt)
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    rows = []

    # paged
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = paged._paged_decode_plain(q, kp, vp, tables, short, scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    call = (lambda: paged._launch_paged(q, kp, vp, tables, lens, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: paged._paged_decode_plain(
        q, kp, vp, tables, lens, scale=scale), 5)
    dense_k = kp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    dense_v = vp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    lib_ms = sdpa_ms(q, dense_k, dense_v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2,
                              tables_read=int(np.sum(-(-lengths // bs))))
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "paged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/paged_attention.py:55",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes,
                 "host_ms": host_ms})

    # ragged, dense cache [B, S, Hkv, D] with S = 1024
    S = maxb * bs
    k, v = dense_k.contiguous(), dense_v.contiguous()
    out = dec.ragged_decode_attention_kernel(q, k, v, lens)
    plain = dec._ragged_decode_plain(q, k, v, lens, block_k=128, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = dec._ragged_decode_plain(q, k, v, short, block_k=128,
                                     scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    call = (lambda: dec._launch_ragged(q, k, v, lens, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: dec._ragged_decode_plain(
        q, k, v, lens, block_k=128, scale=scale), 5)
    lib_ms = sdpa_ms(q, k, v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2)
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "ragged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/decode_attention.py:49",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes,
                 "host_ms": host_ms})
    for r in rows:
        log(f"{r['name']}: bf16 B={B} H={H} Hkv={Hkv} D={D} "
            f"sum(len)={int(lengths.sum())}: kernel {r['ms']:.4f} ms "
            f"({r['bytes'] / r['ms'] / 1e9:.3f} TB/s, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound, "
            f"{r['ms'] / r['library_ms']:.2f}x the sdpa time; "
            f"{r['host_ms']:.4f} ms a call back to back, host included), "
            f"plain "
            f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['tol_ratio']:.2f}x the tolerance "
            f"{BF16_TOL}; a version that skips the last tile of the slots "
            f"longer than 512 reads {r['skip_ratio']:.2f}x it")
        if r["skip_ratio"] <= 1:
            raise RuntimeError(f"{r['name']}: the bf16 tolerance does not "
                               f"tell a skipped last tile from the kernel")
    return rows


def check_flash(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_kernels import eager_ms, graph_ms

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # f32 at the repo's test shapes (tests/test_ops.py:318, 334)
    errs_f32 = []
    for B, S, H, Hkv, D, causal in ((2, 256, 4, 2, 32, True),
                                    (2, 256, 4, 2, 32, False),
                                    (1, 192, 2, 2, 16, True)):
        q = rand((B, S, H, D), torch.float32)
        k, v = rand((B, S, Hkv, D), torch.float32), \
            rand((B, S, Hkv, D), torch.float32)
        out = attn.flash_attention_kernel(q, k, v, causal)
        plain = attn._flash_forward_plain(q, k, v, causal=causal)
        torch.testing.assert_close(out, plain, **F32_FLASH_TOL)
        errs_f32.append((out - plain).abs().max().item())
    # the Function's gradient against autograd through the reference
    q, k, v = (rand((1, 128, 2, 16), torch.float32).requires_grad_()
               for _ in range(3))
    grads = torch.autograd.grad(
        (attn.flash_attention(q, k, v, True) ** 2).sum(), (q, k, v))
    ref = torch.autograd.grad(
        (attn.reference_attention(q, k, v) ** 2).sum(), (q, k, v))
    grad_err = 0.0
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL)
        grad_err = max(grad_err, (a - b).abs().max().item())
    log(f"flash f32 at the repo's test shapes: max_abs_err {errs_f32} "
        f"(rtol 2e-4 atol 2e-5); gradients vs the reference {grad_err:.3e} "
        f"(rtol 5e-3 atol 5e-4)")

    # bf16 at the training slice's shapes
    B, S, H, Hkv, D = 8, 2048, 8, 4, 128
    dt = torch.bfloat16
    scale = D ** -0.5
    q = rand((B, S, H, D), dt)
    k, v = rand((B, S, Hkv, D), dt), rand((B, S, Hkv, D), dt)
    out = attn.flash_attention_kernel(q, k, v, True)
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    # a wrong kernel to hold the bound against: each 128-row block of
    # queries (the kernel's tile) drops its last (diagonal) K tile; rows
    # 128.. compared
    rows = torch.arange(S, device=dev)
    wrong = attn.reference_attention(q, k, v,
                                     positions_q=rows // 128 * 128 - 1,
                                     positions_k=rows)
    skip_ratio = tol_ratio(wrong[:, 128:], plain[:, 128:])
    del wrong
    # the MoE path's shapes (phase 7): batch 2 of the same widths
    q2, k2, v2 = (t[:2].contiguous() for t in (q, k, v))
    out2 = attn.flash_attention_kernel(q2, k2, v2, True).float()
    plain2 = attn._flash_forward_plain(q2, k2, v2, causal=True).float()
    torch.testing.assert_close(out2, plain2, **BF16_TOL)
    moe_err = (out2 - plain2).abs().max().item()
    del q2, k2, v2, out2, plain2
    call = (lambda: attn._launch_flash(q, k, v, True, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: attn._flash_forward_plain(q, k, v,
                                                         causal=True), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elt = 2
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * elt   # q, o, k, v
    ops = 4 * B * H * D * (S * (S + 1) // 2)       # causal (row, col) pairs
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "ray_tpu_torch/csrc/flash_attention.cu",
           "replaces": "ray_tpu/ops/attention.py:128",
           "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    log(f"flash_attention: bf16 B={B} S={S} H={H} Hkv={Hkv} D={D} causal: "
        f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * b_ms / ms:.1f} % of the bound, {ms / lib_ms:.2f}x the sdpa "
        f"time; {host_ms:.4f} ms a call back to back, host included), plain "
        f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
        f"max_abs_err {row['max_abs_err']:.3e}, {row['tol_ratio']:.2f}x the "
        f"tolerance {BF16_TOL}; a version that drops each row block's "
        f"diagonal K tile reads {skip_ratio:.2f}x it; at the MoE path's "
        f"batch 2, max_abs_err {moe_err:.3e}")
    if skip_ratio <= 1:
        raise RuntimeError("flash_attention: the bf16 tolerance does not "
                           "tell a dropped K tile from the kernel")
    return row


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def request_mix(vocab: int, rng) -> dict:
    """The serving mix: 12 plain prompts of 32-256 tokens and four sharing a
    64-token prefix; then one lone prompt of 96 tokens."""
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    plain_lens = rng.integers(32, 257, 12)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in plain_lens]
    sharers = [prefix + [int(t) for t in rng.integers(0, vocab, n)]
               for n in (20, 60, 120, 192)]
    lone = [int(t) for t in rng.integers(0, vocab, 96)]
    return {"prompts": prompts, "sharers": sharers, "lone": lone,
            "prompt_tokens": int(plain_lens.sum()) + sum(map(len, sharers))}


def serve_requests(server, mix: dict) -> dict:
    """16 requests through ``__call__`` and ``stream``; four share a
    64-token prefix and arrive once the first of them has its first token
    (its prompt blocks are sealed at admission), so the prefix path runs."""
    prompts, sharers = mix["prompts"], mix["sharers"]
    results = {}
    lock = threading.Lock()

    def call(i, prompt):
        out = server({"prompt": prompt, "max_tokens": 32})
        with lock:
            results[i] = (out["finish_reason"], len(out["token_ids"]))

    def stream(i, prompt, first=None):
        n = 0
        reason = None
        for chunk in server.stream({"prompt": prompt, "max_tokens": 32}):
            if chunk.get("done"):
                reason = chunk["finish_reason"]
            else:
                n += 1
                if first is not None:
                    first.set()
        with lock:
            results[i] = (reason, n)

    t0 = time.perf_counter()
    first = threading.Event()
    threads = [threading.Thread(target=stream, args=(0, sharers[0], first))]
    for i, p in enumerate(prompts):
        fn = call if i % 2 else stream
        threads.append(threading.Thread(target=fn, args=(i + 1, p)))
    for t in threads:
        t.start()
    if not first.wait(600):
        raise RuntimeError(f"no first token from the prefix owner "
                           f"(server error: {server.error!r})")
    late = [threading.Thread(target=call if j % 2 else stream,
                             args=(13 + j, p))
            for j, p in enumerate(sharers[1:])]
    for t in late:
        t.start()
    for t in threads + late:
        t.join(900)
        if t.is_alive():
            raise RuntimeError("a request did not finish in 900 s")
    wall = time.perf_counter() - t0
    if server.error is not None:
        raise RuntimeError("the engine thread failed") from server.error
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in sorted(results.items()):
        if reason not in ("length", "stop") or not 1 <= n <= 32:
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    tokens = sum(n for _, n in results.values())
    return {"wall_s": wall, "tokens": tokens,
            "prompt_tokens": mix["prompt_tokens"]}


def dense_decode(model, params, gen, B: int, S: int, rng) -> None:
    """One ``forward_step`` with T=1 against a dense cache filled with
    random K/V, lengths spread over 1..S: the ragged kernel's path."""
    import torch
    cfg = model.cfg
    cache = model.init_kv_cache(B, S)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer.copy_(torch.randn(layer.shape, generator=gen,
                                    device=model.device))
    offsets = torch.from_numpy(
        np.linspace(0, S - 1, B).round().astype(np.int32)).to(model.device)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)) \
        .to(model.device)
    logits, cache = model.forward_step(params, tokens, cache, offsets)
    torch.cuda.synchronize()
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("forward_step(T=1) logits not finite/shaped")


def live_pool_compare(server, rng) -> dict:
    """decode_step_paged through the kernel and through the reference on
    two clones of one live pool; returns the decode step times."""
    import torch
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.models.llama import LlamaModel

    eng = server.engine
    vocab = eng.model.cfg.vocab_size
    for n in (100, 180, 260, 300):
        eng.submit([int(t) for t in rng.integers(0, vocab, n)],
                   SamplingParams(max_tokens=64))
    for _ in range(8):
        eng.step()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    if len(active) < 4 or (eng.offsets[active] <= eng.block_size).any():
        raise RuntimeError("live pool not set up: slots "
                           f"{active}, offsets {eng.offsets[active]}")
    ker = eng.model
    ref = LlamaModel(dataclasses.replace(ker.cfg,
                                         decode_attention="reference"),
                     device=ker.device)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, eng.max_slots).astype(np.int32)).to(ker.device)
    tables = torch.from_numpy(eng._tables.copy()).to(ker.device)
    offsets = torch.from_numpy(eng.offsets.copy()).to(ker.device)
    pools = [{k: v.clone() for k, v in eng.kv.items()} for _ in range(2)]
    lk, pk = ker.decode_step_paged(eng.params, tokens, pools[0], tables,
                                   offsets)
    lr, pr = ref.decode_step_paged(eng.params, tokens, pools[1], tables,
                                   offsets)
    torch.cuda.synchronize()
    rows = torch.tensor(active, device=ker.device)
    err = (lk[rows] - lr[rows]).abs().max().item()
    torch.testing.assert_close(lk[rows], lr[rows], **STEP_TOL)
    # the step's only pool writes outside the scratch block: each active
    # slot's new row in every layer
    off = offsets[rows].long()
    blk = tables[rows, off // eng.block_size].long()
    for name in ("k", "v"):
        torch.testing.assert_close(
            pk[name][:, blk, off % eng.block_size].float(),
            pr[name][:, blk, off % eng.block_size].float(), **STEP_TOL)
    del pr
    # decode step time, kernel and reference, on the clones
    times = {}
    for label, model, pool in (("kernel", ker, pk), ("reference", ref,
                                                     pools[1])):
        samples = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step_paged(eng.params, tokens, pool, tables,
                                    offsets)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[label] = float(np.median(samples[1:]))
    del pools, pk
    return {"logits_max_abs_err": err, "step_ms": times,
            "active_slots": len(active),
            "live_tokens": int(eng.offsets[active].sum())}


def prefix_logits_compare(server, prompt: list) -> dict:
    """The last-token logits of ``prompt`` through a full prefill and
    through the prefix path (its first whole blocks but one token taken
    from that prefill's K/V, the rest prefilled over them: the path a
    repeated prompt takes) at the repo's bf16 step bar."""
    import torch
    eng = server.engine
    n, bs = len(prompt), eng.block_size
    shared = (n - 1) // bs * bs

    def bucketed(seq):
        toks = np.zeros((1, eng._bucket_for(len(seq))), np.int32)
        toks[0, :len(seq)] = seq
        return eng._dev(toks)

    def count(k):
        return eng._dev(np.asarray([k], np.int32))

    full, small = eng._prefill(eng.params, bucketed(prompt), count(n))
    part, _ = eng.model.prefill_with_prefix(
        eng.params, bucketed(prompt[shared:]), small["k"][:, :, :shared],
        small["v"][:, :, :shared], count(shared), count(n - shared))
    torch.cuda.synchronize()
    err = (part - full).abs().max().item()
    torch.testing.assert_close(part, full, **STEP_TOL)
    top2 = full[0].topk(2).values
    return {"shared": shared, "max_abs_err": err,
            "argmax_equal": bool(part.argmax() == full.argmax()),
            "top2_gap": (top2[0] - top2[1]).item()}


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------

def train_path(dev, n_layers: int) -> dict:
    from ray_tpu_torch.bench import run_train
    from ray_tpu_torch.ops import attention as attn
    attn.flash_attention_kernel.launches = 0
    out = run_train(dev, batch=8, seq=2048, steps=10, warmup=2, seed=0,
                    config=bench_config())
    launches = attn.flash_attention_kernel.launches
    steps = out["steps"] + out["warmup"]
    log(f"run_train(bench_400m, {out['model_params']} params, batch 8 x seq "
        f"2048, remat {out['remat']}): {out['tokens_per_sec']:.1f} tokens/s, "
        f"step {out['step_ms']:.2f} ms, MFU {out['mfu']:.4f} (6N over 989 "
        f"TFLOP/s), loss {out['loss_first']:.4f} -> {out['loss_last']:.4f}, "
        f"grad_norm {out['grad_norm']:.4f}; flash launches {launches} "
        f"({steps} steps x {n_layers} layers x 2)")
    if launches != 2 * n_layers * steps:
        raise RuntimeError(f"flash kernel launches {launches} != 2 x "
                           f"{n_layers} layers x {steps} steps")
    if not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"the loss did not fall: {out}")
    out["launches"] = launches
    return out


def kernel_vs_blockwise_loss(dev, model_cls, cfg, batch: int) -> tuple:
    """``loss`` through the flash kernel and through the blockwise path on
    the same f32 params and batch (``batch`` x 2048 tokens)."""
    import torch
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, 2048)).astype(np.int64)) \
        .to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    params = model_cls(cfg, device=dev).init(1, param_dtype=torch.float32)
    losses = []
    with torch.no_grad():
        for impl in ("kernel", "blockwise"):
            model = model_cls(dataclasses.replace(cfg, attention_impl=impl),
                              device=dev)
            losses.append(model.loss(params, tokens, targets))
    torch.testing.assert_close(losses[0], losses[1], **LOSS_TOL)
    return losses[0].item(), losses[1].item()


# ---------------------------------------------------------------------------
# phases 7 and 8: the other model families
# ---------------------------------------------------------------------------

def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_families(dev, moe_layers: int) -> dict:
    """Each family's run of ``bench.WORKLOADS`` on the card, the flash
    counter set to 0 just before and read just after."""
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import attention as attn
    runs = {}
    for name in bench.WORKLOADS:
        attn.flash_attention_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = bench.run_family(name, dev)
        out["launches"] = attn.flash_attention_kernel.launches
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        free_card()
        steps = out["steps"] + out["warmup"]
        want = 2 * moe_layers * steps if name == "moe" else 0
        mfu = ("" if out["mfu"] is None
               else f", MFU {out['mfu']} (6N over 989 TFLOP/s)")
        shape = (f"{out['batch']} x {out['seq']}" if out["seq"]
                 else f"{out['batch']}")
        log(f"{name}: {out['params']:,} params, batch {shape}, "
            f"{out['warmup']} + {out['steps']} steps: step "
            f"{out['step_ms']:.2f} ms, {out['per_sec']:.1f} {out['unit']}/s"
            f"{mfu}, loss {out['loss_first']:.4f} -> {out['loss_last']:.4f},"
            f" grad_norm {out['grad_norm']:.4f}, peak allocated "
            f"{out['peak_gib']:.2f} GiB; flash launches {out['launches']} "
            f"(want {want})")
        if out["launches"] != want:
            raise RuntimeError(f"{name}: flash kernel launches "
                               f"{out['launches']} != {want}")
        if not out["loss_last"] < out["loss_first"]:
            raise RuntimeError(f"{name}: the loss did not fall: {out}")
        runs[name] = out
    return runs


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def card_vs_cpu_loss(dev, name: str) -> tuple:
    """The f32 loss of GPT-2 125M (1 x 256 tokens) or ViT-L/16 (2 images)
    on the card against the same port model and params on the CPU."""
    import torch
    from ray_tpu_torch.models import GPT2Config, GPT2Model, ViTConfig, \
        ViTModel
    rng = np.random.default_rng(2)
    if name == "gpt2":
        cfg = dataclasses.replace(GPT2Config.gpt2_125m(), dtype=torch.float32)
        model_cls = GPT2Model
        tokens = rng.integers(0, cfg.vocab_size, (1, 256))
        batch = (tokens, np.roll(tokens, -1, axis=1))
    else:
        cfg = dataclasses.replace(ViTConfig.vit_l16(), dtype=torch.float32)
        model_cls = ViTModel
        batch = (rng.normal(size=(2, 224, 224, 3)).astype(np.float32),
                 rng.integers(0, cfg.num_classes, 2))
    batch = tuple(torch.from_numpy(b) for b in batch)
    cpu = model_cls(cfg, device="cpu")
    params = cpu.init(2, param_dtype=torch.float32)
    with torch.no_grad():
        want = cpu.loss(params, *batch)
        got = model_cls(cfg, device=dev).loss(to_device(params, dev), *batch)
    if got.device.type != "cuda":
        raise RuntimeError(f"{name}: the card's loss came from {got.device}")
    got = got.cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    return got.item(), want.item()


# ---------------------------------------------------------------------------
# phase 9: the mesh path
# ---------------------------------------------------------------------------

def step_profile(model, batch) -> dict:
    """CUDA kernel launches and their summed device time in one train step
    of ``model`` on the host ``batch`` (one warm step, then one under the
    profiler), beside the step's wall time under the profiler."""
    import torch
    from ray_tpu_torch.train import make_train_step, shard_batch
    ts = make_train_step(model, mesh=getattr(model, "mesh", None))
    params, opt = ts.init_fn(0)
    data = shard_batch(batch, ts)
    ts.step_fn(params, opt, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ts.step_fn(params, opt, data)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    del params, opt
    free_card()
    return {"launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3, "profiled_wall_ms": wall}


def bench_batch(cfg, rows: int = 8):
    """Phase 5's batch: ``rows`` x 2048 tokens from seed 0."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (rows, 2048))
    return tokens, np.roll(tokens, -1, axis=1)


def launches_per_step(dev, mesh) -> dict:
    """One bench_400m train step (batch 8 x 2048) on ``mesh`` or with
    none, profiled (``step_profile``)."""
    from ray_tpu_torch.models import LlamaModel
    cfg = bench_config()
    return step_profile(LlamaModel(cfg, device=dev, mesh=mesh),
                        bench_batch(cfg))


def mesh_train(dev, mesh, plain: dict, n_layers: int) -> dict:
    """bench_400m through ``run_train(mesh=...)``, the flash counter at 0
    just before and read just after, held against phase 5's run."""
    from ray_tpu_torch.bench import run_train
    from ray_tpu_torch.ops import attention as attn
    attn.flash_attention_kernel.launches = 0
    out = run_train(dev, batch=8, seq=2048, steps=10, warmup=2, seed=0,
                    config=bench_config(), mesh=mesh)
    out["launches"] = attn.flash_attention_kernel.launches
    steps = out["steps"] + out["warmup"]
    gaps = {k: abs(out[k] / plain[k] - 1)
            for k in ("loss_first", "grad_norm_first")}
    log(f"run_train(bench_400m, mesh {out['mesh']}): "
        f"{out['tokens_per_sec']:.1f} tokens/s, step {out['step_ms']:.2f} ms, "
        f"MFU {out['mfu']:.4f}, loss {out['loss_first']:.6f} -> "
        f"{out['loss_last']:.6f}, first grad_norm "
        f"{out['grad_norm_first']:.6f}; flash launches {out['launches']} "
        f"({steps} steps x {n_layers} layers x 2)")
    log(f"  against phase 5 (no mesh): step {plain['step_ms']:.2f} ms, "
        f"{plain['tokens_per_sec']:.1f} tokens/s, MFU {plain['mfu']:.4f}; "
        f"step time ratio mesh / no mesh "
        f"{out['step_ms'] / plain['step_ms']:.4f}; first loss "
        f"{plain['loss_first']:.6f} (relative gap {gaps['loss_first']:.2e}),"
        f" first grad_norm {plain['grad_norm_first']:.6f} (relative gap "
        f"{gaps['grad_norm_first']:.2e}); bar rtol 1e-3")
    if out["launches"] != 2 * n_layers * steps:
        raise RuntimeError(f"mesh path: flash kernel launches "
                           f"{out['launches']} != 2 x {n_layers} x {steps}")
    if not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"mesh path: the loss did not fall: {out}")
    if max(gaps.values()) > 1e-3:
        raise RuntimeError(f"mesh path: first step off phase 5's: {gaps}")
    return out


def mesh_checkpoint(dev, mesh) -> dict:
    """The sharded bench_400m params and AdamW state after one step, saved
    and restored onto the mesh and with no mesh: every leaf bit for bit."""
    import os
    import shutil
    import tempfile
    import torch
    from ray_tpu_torch.models import LlamaModel
    from ray_tpu_torch.train import make_train_step, shard_batch
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.spmd import mirror_shardings
    cfg = bench_config()
    ts = make_train_step(LlamaModel(cfg, device=dev, mesh=mesh), mesh=mesh)
    params, opt = ts.init_fn(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 2048))
    ts.step_fn(params, opt, shard_batch((tokens, np.roll(tokens, -1, 1)),
                                        ts))
    state = {"params": params, "opt": opt.state_dict()}
    pl = {"params": ts.param_shardings,
          "opt": mirror_shardings(state["opt"], ts.param_shardings)}
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_pytree(state, path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        flat = []
        compared = 0
        for restored in (ckpt.to_pytree(pl, mesh), ckpt.to_pytree()):
            compared += _same_tree(state, restored, flat)
            del restored
    finally:
        shutil.rmtree(path, ignore_errors=True)
    del params, opt, state
    free_card()
    return {"save_s": save_s, "bytes": nbytes, "leaves": compared // 2,
            "restored_dtensors": sum(flat)}


def _same_tree(a, b, dtensors: list) -> int:
    """Leaves compared; raises unless ``b`` equals ``a`` bit for bit (a
    DTensor against its full value)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(a, torch.Tensor):
        dtensors.append(isinstance(b, DTensor))
        fa = a.full_tensor() if isinstance(a, DTensor) else a
        fb = b.full_tensor() if isinstance(b, DTensor) else b
        if fa.dtype != fb.dtype or not torch.equal(
                fa.detach(), fb.detach().to(fa.device)):
            raise RuntimeError("checkpoint: a restored leaf differs")
        return 1
    if isinstance(a, dict):
        if list(a) != list(b):
            raise RuntimeError(f"checkpoint: keys {list(a)} != {list(b)}")
        return sum(_same_tree(a[k], b[k], dtensors) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(_same_tree(x, y, dtensors) for x, y in zip(a, b))
    if a != b:
        raise RuntimeError(f"checkpoint: {a!r} != {b!r}")
    return 0


def mesh_gpt2(dev, mesh, plain: dict) -> dict:
    """Phase 7's GPT-2 workload and timing on ``mesh``: its first loss
    against phase 7's (same seed and batch) and its step time beside it."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import GPT2Config, GPT2Model
    _, batch = bench.family_workload("gpt2", dev)
    out = bench.time_train_steps(
        GPT2Model(GPT2Config.gpt2_125m(), device=dev, mesh=mesh), batch,
        steps=plain["steps"], warmup=plain["warmup"])
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"gpt2 on the mesh (phase 7's workload and timing): step "
        f"{out['step_ms']:.2f} ms against {plain['step_ms']:.2f} ms without "
        f"(ratio {out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"gpt2 on the mesh: {out}")
    return out


def mesh_path(dev, plain: dict, gpt2_plain: dict, n_layers: int) -> dict:
    """Phase 9: the one-rank mesh, bench_400m on it, the GPT-2 DP example
    and phase 7's GPT-2 run on it, the sharded checkpoint."""
    import torch.distributed as dist
    from ray_tpu_torch.examples import train_gpt2_dp
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec())
    log(f"mesh {mesh}: world size {dist.get_world_size()}, backend "
        f"{dist.get_backend()}")
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl" \
            or mesh.mesh_dim_names != ("pp", "dp", "fsdp", "sp", "tp", "ep"):
        raise RuntimeError(f"mesh path: not a one-rank NCCL mesh: {mesh}")
    out = mesh_train(dev, mesh, plain, n_layers)
    free_card()
    per_step = {"no mesh": launches_per_step(dev, None),
                "mesh": launches_per_step(dev, mesh)}
    ratio = per_step["mesh"]["launches"] / per_step["no mesh"]["launches"]
    log(f"one profiled bench_400m step (CUDA kernel launches, their device "
        f"ms, wall ms): {per_step} (launch ratio {ratio:.4f})")
    gpt2 = train_gpt2_dp.main(debug=False, steps=7, batch=8, seq=1024)
    free_card()
    log(f"GPT-2 DP example (gpt2_125m, {gpt2['batch']} x {gpt2['seq']}, "
        f"mesh {gpt2['mesh']}): loss {gpt2['losses'][0]:.4f} -> "
        f"{gpt2['losses'][-1]:.4f}, step {gpt2['step_ms']:.2f} ms "
        f"(mean of the last 5)")
    if not gpt2["losses"][-1] < gpt2["losses"][0]:
        raise RuntimeError(f"GPT-2 DP example: the loss did not fall: {gpt2}")
    gpt2_timed = mesh_gpt2(dev, mesh, gpt2_plain)
    free_card()
    ck = mesh_checkpoint(dev, mesh)
    log(f"checkpoint of the sharded bench_400m params + AdamW state: "
        f"{ck['leaves']} leaves, {ck['bytes'] / 1e9:.3f} GB saved in "
        f"{ck['save_s']:.2f} s ({ck['bytes'] / 1e9 / ck['save_s']:.3f} GB/s);"
        f" restored onto the mesh ({ck['restored_dtensors']} DTensors) and "
        f"with no mesh: bit for bit")
    if ck["restored_dtensors"] == 0:
        raise RuntimeError("checkpoint: nothing was restored onto the mesh")
    out.update(per_step=per_step, gpt2=gpt2, gpt2_timed=gpt2_timed,
               checkpoint=ck)
    return out


# ---------------------------------------------------------------------------
# phase 10: sequence, expert and pipeline parallelism
# ---------------------------------------------------------------------------

def moe_alltoall(dev, mesh, plain: dict) -> dict:
    """(a) Phase 7's MoE workload with the expert all-to-all on ``mesh``:
    the same seed and batch, so at ep 1 the same first loss."""
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import MoEModel
    from ray_tpu_torch.ops import attention as attn
    cfg = dataclasses.replace(bench.moe_bench_config(),
                              moe_dispatch="alltoall")
    n_layers = cfg.n_layers
    _, batch = bench.family_workload("moe", dev)
    torch.cuda.reset_peak_memory_stats(dev)
    attn.flash_attention_kernel.launches = 0
    out = bench.time_train_steps(MoEModel(cfg, device=dev, mesh=mesh), batch,
                                 steps=plain["steps"], warmup=plain["warmup"])
    out["launches"] = attn.flash_attention_kernel.launches
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    free_card()
    out["profile"] = {
        "einsum, no mesh": step_profile(MoEModel(bench.moe_bench_config(),
                                                 device=dev), batch),
        "alltoall, mesh": step_profile(MoEModel(cfg, device=dev, mesh=mesh),
                                       batch)}
    log(f"  one profiled MoE step (CUDA kernel launches, their device ms, "
        f"wall ms): {out['profile']}")
    steps = out["steps"] + out["warmup"]
    tokens = batch[0].size
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"moe[alltoall] on the mesh (phase 7's workload): step "
        f"{out['step_ms']:.2f} ms, {tokens / out['step_ms'] * 1e3:.1f} "
        f"tokens/s, against phase 7's einsum {plain['step_ms']:.2f} ms, "
        f"{plain['per_sec']:.1f} tokens/s (ratio "
        f"{out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}; "
        f"peak allocated {out['peak_gib']:.2f} GiB; flash launches "
        f"{out['launches']} ({steps} steps x {n_layers} layers x 2)")
    if out["launches"] != 2 * n_layers * steps:
        raise RuntimeError(f"moe[alltoall]: flash launches "
                           f"{out['launches']} != 2 x {n_layers} x {steps}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"moe[alltoall]: {out}")
    return out


def context_parallel_sp1(dev, gen) -> dict:
    """(b) Ring and Ulysses attention at sp 1 at bench_400m's attention
    shapes: bf16 forward against the flash kernel, f32 gradients against
    autograd through the reference, bf16 forward and forward+backward
    times."""
    import torch
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention
    from ray_tpu_torch.profile_kernels import eager_ms
    B, S, H, Hkv, D = 8, 2048, 8, 4, 128
    shapes = ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
               for sh in shapes)
    flash = attn.flash_attention_kernel(q, k, v, True)
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                 ulysses_attention)):
        got = fn(q, k, v)
        torch.testing.assert_close(got.float(), flash.float(), **BF16_TOL)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            fn(qg, kg, vg).float().sum().backward()
        out[name] = {"max_abs_err": (got.float() - flash.float()).abs()
                     .max().item(), "tol_ratio": tol_ratio(got, flash),
                     "ms": eager_ms(lambda: fn(q, k, v), 5, 1),
                     "fwd_bwd_ms": eager_ms(fwd_bwd, 3, 1)}
        del got, qg, kg, vg
        free_card()
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    cot = torch.randn((B, S, H, D), generator=gen, device=dev)
    ref = torch.autograd.grad((attn.reference_attention(q32, k32, v32)
                               * cot).sum(), (q32, k32, v32))
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                 ulysses_attention)):
        grads = torch.autograd.grad((fn(q32, k32, v32) * cot).sum(),
                                    (q32, k32, v32))
        for a, b in zip(grads, ref):
            torch.testing.assert_close(a, b, **GRAD_TOL)
        out[name]["grad_err"] = max((a - b).abs().max().item()
                                    for a, b in zip(grads, ref))
        del grads
        free_card()
    del ref, flash
    free_card()
    for name, r in out.items():
        log(f"{name}_attention at sp 1, bf16 B={B} S={S} H={H} Hkv={Hkv} "
            f"D={D} causal: forward {r['ms']:.3f} ms, forward+backward "
            f"{r['fwd_bwd_ms']:.3f} ms; against the flash kernel max_abs_err "
            f"{r['max_abs_err']:.3e} ({r['tol_ratio']:.2f}x the tolerance "
            f"{BF16_TOL}); f32 gradients against the reference "
            f"{r['grad_err']:.3e} ({GRAD_TOL})")
    return out


def pipeline_one_stage(dev, mesh, plain: dict, n_layers: int) -> dict:
    """(c) bench_400m through ``pipelined`` over the mesh's one pp stage:
    ``PipelinedLlama``'s init, stage body and apply, 4 microbatches of
    2 x 2048 (phase 5's batch and seed), remat."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import LlamaModel, PipelinedLlama
    from ray_tpu_torch.ops import attention as attn

    class OneStage(PipelinedLlama):
        """PipelinedLlama over one stage: the class refuses pp < 2, as
        JAX's does, while ``pipelined`` takes one stage."""

        def __init__(self, cfg, mesh, num_microbatches, device):
            self.cfg, self.mesh, self.rules = cfg, mesh, None
            self.num_microbatches, self.num_stages = num_microbatches, 1
            self.device = device
            self._base = LlamaModel(cfg, device=device, mesh=mesh)

    cfg = bench_config()
    micro = 4
    attn.flash_attention_kernel.launches = 0
    out = bench.time_train_steps(OneStage(cfg, mesh, micro, dev),
                                 bench_batch(cfg), steps=3, warmup=2)
    out["launches"] = attn.flash_attention_kernel.launches
    free_card()
    out["profile"] = step_profile(OneStage(cfg, mesh, micro, dev),
                                  bench_batch(cfg))
    log(f"  one profiled pipelined step (CUDA kernel launches, their device "
        f"ms, wall ms): {out['profile']}")
    steps = out["steps"] + out["warmup"]
    want = 2 * n_layers * micro * steps
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"pipelined bench_400m over one stage ({micro} microbatches of "
        f"2 x 2048, remat): step {out['step_ms']:.2f} ms against phase 5's "
        f"{plain['step_ms']:.2f} ms (ratio "
        f"{out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}; "
        f"flash launches {out['launches']} ({steps} steps x {n_layers} "
        f"layers x {micro} microbatches x 2)")
    if out["launches"] != want:
        raise RuntimeError(f"pipeline: flash launches {out['launches']} != "
                           f"{want}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"pipeline: {out}")
    return out


def parallel_layouts(dev, gen, plain: dict, moe_plain: dict,
                     n_layers: int) -> dict:
    """Phase 10 on the one-rank mesh of phase 9, then ``dryrun_mesh(8)``
    on this machine's CPU."""
    from ray_tpu_torch.dryrun import dryrun_mesh
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec())
    out = {"moe": moe_alltoall(dev, mesh, moe_plain)}
    out["context"] = context_parallel_sp1(dev, gen)
    out["pipeline"] = pipeline_one_stage(dev, mesh, plain, n_layers)
    log("dryrun_mesh(8): 8 gloo ranks on this machine's CPU, by design: "
        "NCCL holds one rank a card, so the multi-rank meshes meet this "
        "torch here")
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_mesh(8)
    log(f"dryrun_mesh(8): {len(out['dryrun'])} layouts in "
        f"{time.perf_counter() - t0:.1f} s, each at its one-device loss "
        f"(rtol 1e-4)")
    return out


# ---------------------------------------------------------------------------
# phase 11: the RL learners
# ---------------------------------------------------------------------------

# The CPU tests' configurations (tests/test_torch_rl.py holds the port's
# learners to JAX's with each): the learner's keywords, what one update
# takes (``rl_case_data``) and the bar, JAX's own for learner equality
# (tests/test_rl.py:259-264 for PPO; :284-289, IMPALA's, for the other
# Adam and RMSprop learners; the SGD learners at the first-step bar).
IMPALA_BAR = dict(rtol=5e-4, atol=5e-5)
RL_CASES = {
    "PPO": (dict(epochs=1, minibatch_size=128), "fragment",
            dict(rtol=2e-4, atol=2e-5)),
    "IMPALA": ({}, "fragment", IMPALA_BAR),
    "APPO": ({}, "fragment", IMPALA_BAR),
    "DQN": (dict(batch_size=64, updates_per_iter=4, target_update_every=2),
            "fragments", IMPALA_BAR),
    "SAC": (dict(batch_size=128, updates_per_call=4), "fragments",
            IMPALA_BAR),
    "BC": ({}, "batches", dict(rtol=1e-5, atol=1e-6)),
    "OfflineDQN": (dict(target_update_every=2), "batches",
                   dict(rtol=1e-5, atol=1e-6)),
}

# The repo's full-width RL configurations (ray_tpu/rl/tuned_examples.py:29-58,
# targets :105-121), run through the port's copy of the registry
# (ray_tpu_torch/rl/tuned_examples.py): each trains until its target return
# or its 40 iterations.
TUNED = {"PPO": "ppo-cartpole", "DQN": "dqn-cartpole",
         "IMPALA": "impala-cartpole", "APPO": "appo-cartpole",
         "SAC": "sac-cartpole"}


def transitions(fragments) -> dict:
    """EnvRunner fragments as (obs, next_obs, action, reward, done) rows, as
    the JAX package's ``write_experiences`` flattens them
    (``rl/offline.py:42-53``)."""
    def cat(key):
        return np.concatenate([f[key] for f in fragments])
    return {"obs": cat("obs"),
            "next_obs": np.concatenate([np.concatenate(
                [f["obs"][1:], f["next_obs_last"][None]])
                for f in fragments]),
            "actions": cat("actions").astype(np.int64),
            "rewards": cat("rewards"), "dones": cat("dones")}


class Transitions:
    """An experience dataset in memory: ``iter_batches`` over transition
    rows in order, as the JAX package's parquet reader yields them."""

    def __init__(self, rows: dict):
        self.rows = rows

    def iter_batches(self, batch_size: int):
        n = len(self.rows["rewards"])
        for lo in range(0, n, batch_size):
            yield {k: v[lo:lo + batch_size] for k, v in self.rows.items()}


def rl_case_data(seed: int = 0) -> dict:
    """The inputs of ``RL_CASES``' updates, numpy only: two CartPole
    fragments of 256 steps (runners seeded ``seed`` + 1 and + 2, each with
    a seed-``seed`` ``ActorCriticPolicy`` on the host), and four batches of
    64 of their transitions."""
    from ray_tpu_torch import rl
    frags = [rl.EnvRunner(rl.CartPoleEnv, lambda: rl.ActorCriticPolicy(
        4, 2, seed=seed, device="cpu"), seed=seed + 1 + i).sample(256)
        for i in range(2)]
    rows = transitions(frags)
    return {"fragment": frags[:1], "fragments": frags,
            "batches": [{k: v[i * 64:(i + 1) * 64] for k, v in rows.items()}
                        for i in range(4)]}


def rl_case_update(learner, name: str, data: dict) -> dict:
    """One update of case ``name`` on a learner of either package."""
    kind = RL_CASES[name][1]
    if kind != "batches":
        return learner.update(data[kind])
    for batch in data["batches"]:
        metrics = learner.update(batch)
    return metrics


def make_learner(name: str, dev, seed: int = 0, **kwargs):
    """The port's learner of algorithm ``name`` on CartPole."""
    from ray_tpu_torch import rl
    cls = {"PPO": rl.PPOLearner, "DQN": rl.DQNLearner,
           "IMPALA": rl.ImpalaLearner, "APPO": rl.APPOLearner,
           "SAC": rl.SACLearner, "BC": rl.BCLearner,
           "OfflineDQN": rl.OfflineDQNLearner}[name]
    return cls(4, 2, seed=seed, device=dev, **kwargs)


def algorithm(name: str, dev, *, runners: int = 2, fragment: int = 256,
              seed: int = 0, **learner_kwargs):
    """The port's ``rl.Algorithm`` of ``name`` on CartPole through the
    port's runtime: ``runners`` EnvRunner actors (runner i seeded ``seed +
    1 + i``), the learner and the runners' policies on ``dev``."""
    from ray_tpu_torch import rl
    return (rl.AlgorithmConfig(algo=name, seed=seed)
            .environment("CartPole-v1")
            .env_runners(runners, rollout_fragment_length=fragment)
            .training(device=dev, **learner_kwargs).build())


def flat_tree(tree, path: str = "") -> dict:
    """{path: numpy array} of a tree of dicts and lists (tensor, JAX or
    numpy leaves)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in flat_tree(sub, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in flat_tree(sub, f"{path}/{i}").items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu()
    return {path: np.asarray(tree)}


def flat_state(learner) -> dict:
    """``learner_state`` as {path: array}."""
    from ray_tpu_torch.rl import learner_state
    return flat_tree(learner_state(learner))


def state_ratio(a, b, bar: dict) -> float:
    """The worst ``tol_ratio`` over two learners' states."""
    import torch
    sa, sb = flat_state(a), flat_state(b)
    if set(sa) != set(sb):
        raise RuntimeError(f"states differ in keys: {sorted(sa)} "
                           f"{sorted(sb)}")
    return max(tol_ratio(torch.from_numpy(sa[k]), torch.from_numpy(sb[k]),
                         bar) for k in sa)


@timed("11(a) rl_card_vs_cpu")
def rl_card_vs_cpu(dev) -> dict:
    """(a) Each case's learner on the CPU and on ``dev`` from the same state
    (``load_learner_state``) takes the same update; params and metrics are
    held to the case's bar."""
    import torch
    from ray_tpu_torch.rl import learner_state, load_learner_state
    data = rl_case_data()
    worst = {}
    for name, (kw, _, bar) in RL_CASES.items():
        cpu, card = (make_learner(name, d, **kw) for d in ("cpu", dev))
        load_learner_state(card, learner_state(cpu))
        m_cpu, m_card = (rl_case_update(x, name, data) for x in (cpu, card))
        ratio = state_ratio(card, cpu, bar)
        for k, v in m_cpu.items():
            ratio = max(ratio, tol_ratio(torch.tensor(float(m_card[k])),
                                         torch.tensor(float(v)), bar))
        worst[name] = ratio
        if ratio > 1:
            raise RuntimeError(f"RL {name}: the card's update is off the "
                               f"CPU's by {ratio:.3f}x the bar {bar}")
    log("RL card vs CPU, one update each from the same state, worst "
        "|card - cpu| / (atol + rtol |cpu|) at the CPU tests' bars: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


@timed("11(b) rl_learning")
def rl_learning(dev) -> dict:
    """(b) The JAX package's learning bars (tests/test_rl.py) through the
    port's ``Algorithm``, learners on ``dev``."""
    from ray_tpu_torch import rl
    out = {}
    # PPO, tests/test_rl.py:24-43
    algo = algorithm("PPO", dev, runners=2, fragment=256, lr=1e-3,
                     epochs=4, minibatch_size=128)
    rets = [algo.train()["episode_return_mean"] for _ in range(12)]
    algo.stop()
    rets = [r for r in rets if np.isfinite(r)]
    out["PPO"] = (rets[0], rets[-1])
    if not (rets[-1] > rets[0] and rets[-1] > 40):
        raise RuntimeError(f"PPO did not learn: returns {rets}")
    # IMPALA, :193-216
    algo = algorithm("IMPALA", dev, runners=2, fragment=256, lr=1e-3,
                     ent_coef=0.01)
    rets = []
    for _ in range(12):
        m = algo.train()
        if not np.isnan(m["episode_return_mean"]):
            rets.append(m["episode_return_mean"])
    algo.stop()
    leading, trailing = float(np.mean(rets[:3])), float(np.mean(rets[-3:]))
    out["IMPALA"] = (leading, trailing, m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 24 and trailing > 35
            and trailing > leading * 0.7):
        raise RuntimeError(f"IMPALA did not learn: {out['IMPALA']} {rets}")
    # SAC, :218-233
    algo = algorithm("SAC", dev, runners=1, fragment=256, batch_size=128,
                     updates_per_call=8)
    for _ in range(4):
        m = algo.train()
    algo.stop()
    out["SAC"] = (m["alpha"], m["entropy"], m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 16 and np.isfinite(m["q_loss"])
            and m["alpha"] > 0 and 0 < m["entropy"] <= np.log(2) + 1e-5):
        raise RuntimeError(f"SAC off its bars: {m}")
    # DQN, :46-61
    algo = algorithm("DQN", dev, runners=2, fragment=128, lr=1e-3,
                     updates_per_iter=16)
    eps = []
    for _ in range(4):
        m = algo.train()
        eps.append(m["epsilon"])
    algo.stop()
    out["DQN"] = (eps[0], eps[-1], m["td_loss"])
    if not (eps[-1] < eps[0] and np.isfinite(m["td_loss"])):
        raise RuntimeError(f"DQN off its bars: {eps} {m}")
    # BC and CQL from the runner's logged batches, :130-162 without the
    # parquet IO
    runner = rl.EnvRunner(rl.CartPoleEnv, lambda: rl.ActorCriticPolicy(
        4, 2, seed=0, device="cpu"), seed=0)
    ds = Transitions(transitions([runner.sample(128) for _ in range(2)]))
    bc = rl.BCLearner(4, 2, seed=0, lr=3e-3, device=dev)
    first = next(ds.iter_batches(batch_size=256))
    before = bc.evaluate_accuracy(first)
    m = rl.train_offline(ds, bc, batch_size=64, epochs=10)
    after = bc.evaluate_accuracy(first)
    out["BC"] = (before, after)
    if not (np.isfinite(m["bc_loss"]) and after >= before and after > 0.45):
        raise RuntimeError(f"BC off its bars: {before} -> {after}, {m}")
    cql = rl.OfflineDQNLearner(4, 2, seed=0, cql_alpha=1.0, device=dev)
    m = rl.train_offline(ds, cql, batch_size=64, epochs=2)
    out["CQL"] = (m["loss"], m["cql_penalty"])
    if not (np.isfinite(m["loss"]) and m["cql_penalty"] >= 0.0
            and cql.act(np.zeros(4, np.float32)) in (0, 1)):
        raise RuntimeError(f"CQL off its bars: {m}")
    log(f"RL learning bars on {dev} (tests/test_rl.py): PPO return "
        f"{out['PPO'][0]:.1f} -> {out['PPO'][1]:.1f} (> first, > 40); "
        f"IMPALA leading {leading:.1f}, trailing {trailing:.1f} (> 35) "
        f"after {out['IMPALA'][2]} updates; SAC alpha {out['SAC'][0]:.4f}, "
        f"entropy {out['SAC'][1]:.4f} (0 < H <= ln 2); DQN epsilon "
        f"{eps[0]:.4f} -> {eps[-1]:.4f}, td_loss {out['DQN'][2]:.4f}; BC "
        f"accuracy {before:.4f} -> {after:.4f} (> 0.45); CQL loss "
        f"{out['CQL'][0]:.4f}, penalty {out['CQL'][1]:.4f}")
    return out


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def tuned_config(name: str):
    """The registry's config of tuned contract ``name`` (ray_tpu_torch.rl.
    tuned_examples, JAX's configs)."""
    from ray_tpu_torch.rl.tuned_examples import TUNED as registry
    return registry[TUNED[name]].make_config()


def rl_update_profile(name: str, dev) -> dict:
    """A fresh learner of a tuned config on ``dev`` and on the CPU, on the
    same rollouts (sampled by the config's ``Algorithm`` on the CPU; IMPALA
    and APPO: one fragment, their update's input): update ms, the median of
    5 after a warm-up update (which fills DQN's and SAC's replay buffers);
    gradient steps an update; and one profiled update on ``dev``: kernel
    launches, their device time and its share of the update's wall
    time."""
    import torch
    import ray_tpu_torch as rt
    cfg = tuned_config(name)
    kw = dict(cfg.learner_kwargs)
    sampler = cfg.training(device="cpu").build()
    rollouts = rt.get([r.sample.remote(cfg.rollout_fragment_length)
                       for r in sampler.runners])
    sampler.stop()
    if name in ("IMPALA", "APPO"):
        rollouts = rollouts[:1]
    out = {}
    for key, where in (("card_ms", dev), ("cpu_ms", "cpu")):
        learner = make_learner(name, where, **kw)
        learner.update(rollouts)
        times = []
        for _ in range(5):
            sync(where)
            t0 = time.perf_counter()
            learner.update(rollouts)
            sync(where)
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = float(np.median(times))
        if key == "card_ms":
            card = learner
    rows = sum(len(r["rewards"]) for r in rollouts)
    if name == "PPO":
        out["steps"] = card.epochs * -(-rows // card.minibatch_size)
    else:
        out["steps"] = {"DQN": getattr(card, "updates_per_iter", 1),
                        "SAC": getattr(card, "updates_per_call", 1)}.get(
                            name, 1)
    sync(dev)
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        card.update(rollouts)
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out["launches"] = sum(e.count for e in kernels)
    out["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    out["profiled_wall_ms"] = wall
    return out


def iteration_split(algo, iterations: int = 3) -> dict:
    """Where ``iterations`` calls of ``algo.train()`` spend their time, in
    ms an iteration: the wall time; the learner's update; the runners' own
    work (their sample, set_weights and episode_returns bodies, summed
    over the runners' threads); and the main thread's calls into the runtime —
    submits (``.remote``), ``wait``, ``get`` (both include waiting for the
    runners) and the weight ``put``. ``runtime_ms`` is the runtime's own
    cost as the main thread feels it: submits and puts, plus the time blocked in
    ``get`` and ``wait`` beyond the runners' work (none where the runners
    sample while the learner updates, as IMPALA's and APPO's do)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import actor as actor_mod
    from ray_tpu_torch._private import worker
    spent = dict.fromkeys(("update", "runners", "submit", "wait", "get",
                           "put"), 0.0)
    lock = threading.Lock()

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    spent[key] += time.perf_counter() - t0
        return wrapper

    from ray_tpu_torch._private.worker_process import _ProcessActorInstance
    instances = [worker.global_worker()._actor_executors[
        h._ray_actor_id].instance for h in algo.runners]
    if any(isinstance(i, _ProcessActorInstance) for i in instances):
        raise RuntimeError("a runner of a learner on the card was built in a "
                           "worker process, not in the driver")
    saved_api = {k: getattr(rt, k) for k in ("wait", "get", "put")}
    saved_remote = actor_mod.ActorMethod.remote
    try:
        for k, fn in saved_api.items():
            setattr(rt, k, timed(k, fn))
        actor_mod.ActorMethod.remote = timed("submit", saved_remote)
        algo.learner.update = timed("update", algo.learner.update)
        for inst in instances:
            for m in ("sample", "set_weights", "episode_returns"):
                setattr(inst, m, timed("runners", getattr(inst, m)))
        sync(algo.learner.device)
        t0 = time.perf_counter()
        for _ in range(iterations):
            algo.train()
        sync(algo.learner.device)
        wall = time.perf_counter() - t0
    finally:
        for k, fn in saved_api.items():
            setattr(rt, k, fn)
        actor_mod.ActorMethod.remote = saved_remote
        del algo.learner.update
        for inst in instances:
            for m in ("sample", "set_weights", "episode_returns"):
                delattr(inst, m)
    out = {f"{k}_ms": v * 1e3 / iterations for k, v in spent.items()}
    out["wall_ms"] = wall * 1e3 / iterations
    blocked = out["get_ms"] + out["wait_ms"] - out["runners_ms"]
    out["runtime_ms"] = out["submit_ms"] + out["put_ms"] + max(blocked, 0.0)
    return out


@timed("11(c) rl_contracts")
def rl_contracts(dev) -> dict:
    """(c) The tuned CartPole contracts on ``dev`` through
    ``rl.tuned_examples.run``, reported and not gated: each trains until
    its target return or its 40 iterations; then its update's time on the
    card and on this machine's CPU, one profiled update, and where an
    iteration of the runtime-driven loop spends its time."""
    from ray_tpu_torch.rl.tuned_examples import TUNED as registry
    from ray_tpu_torch.rl.tuned_examples import run
    out = {}
    for name, key in TUNED.items():
        t0 = time.perf_counter()
        m = run(key, device=dev)
        wall = time.perf_counter() - t0
        best, its = m["best_return"], m["training_iteration"]
        target = registry[key].target_return
        prof = rl_update_profile(name, dev)
        algo = tuned_config(name).training(device=dev).build()
        algo.train()        # warm-up: fills the replay buffers
        split = iteration_split(algo)
        algo.stop()
        out[name] = dict(prof, best=best, iterations=its, target=target,
                         wall_s=wall, split=split)
        log(f"RL tuned {name} ({key}): best return {best:.1f} in {its} "
            f"iterations (target {target:g}: "
            f"{'met' if best >= target else 'NOT met'}; {wall:.1f} s); "
            f"update {prof['card_ms']:.2f} ms on the card, "
            f"{prof['cpu_ms']:.2f} ms on the CPU ({prof['steps']} gradient "
            f"steps: {prof['steps'] / prof['card_ms'] * 1e3:.1f} steps/s on "
            f"the card, {prof['steps'] / prof['cpu_ms'] * 1e3:.1f} on the "
            f"CPU); profiled update: {prof['launches']} launches "
            f"({prof['launches'] / prof['steps']:.1f} a step), "
            f"{prof['device_ms']:.3f} ms of device time: busy "
            f"{prof['device_ms'] / prof['card_ms']:.1%} of the update's "
            f"{prof['card_ms']:.2f} ms, "
            f"{prof['device_ms'] / prof['profiled_wall_ms']:.1%} of its "
            f"{prof['profiled_wall_ms']:.2f} ms under the profiler")
        log(f"  an iteration through the runtime ({key}, learner on {dev}; "
            f"ms, mean of 3): wall {split['wall_ms']:.2f}, learner update "
            f"{split['update_ms']:.2f}, runners' own work "
            f"{split['runners_ms']:.2f}, the runtime's own "
            f"{split['runtime_ms']:.2f} "
            f"({split['runtime_ms'] / split['wall_ms']:.1%}); calls into the runtime: "
            f"submit {split['submit_ms']:.3f}, wait {split['wait_ms']:.2f}, "
            f"get {split['get_ms']:.2f}, weight put {split['put_ms']:.3f}")
    return out


@timed("11(d) rl_group_one_rank")
def rl_group_one_rank(dev, mesh) -> dict:
    """(d) ``LearnerGroup`` on the one-rank mesh: PPO's and IMPALA's update
    against the plain learner's at rtol 1e-6."""
    from ray_tpu_torch.rl import LearnerGroup
    data = rl_case_data()
    out = {}
    for name in ("PPO", "IMPALA"):
        kw, kind, _ = RL_CASES[name]
        plain, grouped = (make_learner(name, dev, **kw) for _ in range(2))
        group = LearnerGroup(grouped, mesh=mesh)
        plain.update(data[kind])
        group.update(data[kind])
        out[name] = state_ratio(grouped, plain, dict(rtol=1e-6, atol=0.0))
        if out[name] > 1:
            raise RuntimeError(f"LearnerGroup {name} on the one-rank mesh is "
                               f"off the plain learner: {out[name]:.3f}x "
                               "rtol 1e-6")
    log(f"LearnerGroup on the one-rank mesh (dp {group.num_learners}) "
        f"against the plain learner, rtol 1e-6: " + ", ".join(
            f"{k} {v:.3g}x the bar" for k, v in out.items()))
    return out


def rl_path(dev) -> dict:
    """Phase 11 on the port's runtime (its EnvRunner actors sample, the
    learner is on the card), every kernel counter at 0 before and read
    after: the RL learners launch none of the port's kernels."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    counters = (attn.flash_attention_kernel,
                dec.ragged_decode_attention_kernel,
                paged.paged_decode_attention_kernel)
    import ray_tpu_torch as rt
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rt.init()
    try:
        out = {"card_vs_cpu": rl_card_vs_cpu(dev),
               "learning": rl_learning(dev), "contracts": rl_contracts(dev),
               "group": rl_group_one_rank(dev, build_mesh(MeshSpec()))}
    finally:
        rt.shutdown()
    launches = [c.launches for c in counters]
    if any(launches):
        raise RuntimeError(f"the RL path launched the port's kernels: "
                           f"{launches}")
    log(f"phase 11 (RL) in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# phases 12 and 13: what both check
# ---------------------------------------------------------------------------

def kernel_counters() -> tuple:
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    return (paged.paged_decode_attention_kernel,
            dec.ragged_decode_attention_kernel, attn.flash_attention_kernel)


def read_launches() -> dict:
    return {c.__name__.replace("_kernel", ""): c.launches
            for c in kernel_counters()}


def check_paged_only(what: str, launches: dict, steps: int,
                     n_layers: int) -> None:
    """The paged kernel once per layer per decode step, no other kernel."""
    if steps < 1 or launches["paged_decode_attention"] != n_layers * steps:
        raise RuntimeError(f"{what}: paged kernel launches {launches} != "
                           f"{n_layers} x {steps} decode steps")
    if launches["ragged_decode_attention"] or launches["flash_attention"]:
        raise RuntimeError(f"{what}: other kernels launched: {launches}")


def finished_ok(reason, n: int) -> bool:
    """Phase 3's bar: 32 tokens, or fewer ending on the stop token."""
    return reason == "length" and n == 32 or \
        reason == "stop" and 1 <= n <= 32


# ---------------------------------------------------------------------------
# phase 12: the runtime on the card
# ---------------------------------------------------------------------------

@timed("12(a) runtime_resources")
def runtime_resources() -> dict:
    """(a) ``init()`` detects the card as ``GPU``; a ``num_gpus=1`` task runs
    in this process on the card and gives its resource back."""
    import os
    import torch
    import ray_tpu_torch as rt
    total = rt.cluster_resources()
    if total.get("GPU") != torch.cuda.device_count():
        raise RuntimeError(f"GPU not detected: {total}")

    @rt.remote(num_gpus=1)
    def where():
        return os.getpid(), torch.cuda.current_device()

    pid, current = rt.get(where.remote(), timeout=120)
    if pid != os.getpid():
        raise RuntimeError(f"a num_gpus task ran in process {pid}, not the "
                           f"caller's {os.getpid()}")
    avail = rt.available_resources()
    if avail.get("GPU") != total["GPU"]:
        raise RuntimeError(f"GPU not given back: {avail} of {total}")
    log(f"runtime resources {total}; a num_gpus=1 task ran in this process "
        f"(pid {pid}) on cuda:{current}; available afterwards {avail}")
    snapshot_restore()
    return {"total": total, "device": current}


def snapshot_restore() -> None:
    """The runtime's GCS snapshots its KV (two namespaces) to a file; after
    a delete, an overwrite and a new key, ``restore`` gives the snapshot's
    tables back."""
    import os
    import tempfile
    from ray_tpu_torch._private import worker
    gcs = worker.global_runtime().gcs
    gcs.kv_put(b"phase12", b"kept")
    gcs.kv_put(b"phase12", b"serve's", namespace=b"serve")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = gcs.snapshot(os.path.join(tmp, "gcs.snap"))
        size = os.path.getsize(path)
        gcs.kv_del(b"phase12")
        gcs.kv_put(b"phase12", b"changed", namespace=b"serve")
        gcs.kv_put(b"later", b"x")
        gcs.restore(path)
        ms = (time.perf_counter() - t0) * 1e3
    got = (gcs.kv_get(b"phase12"), gcs.kv_get(b"phase12", namespace=b"serve"),
           gcs.kv_get(b"later"))
    if got != (b"kept", b"serve's", None):
        raise RuntimeError(f"phase 12(a): the GCS restored {got}")
    log(f"phase 12(a): the GCS's KV snapshot ({size} bytes) restored over a "
        f"delete, an overwrite and a new key in {ms:.2f} ms")


@timed("12(b) runtime_device_tier")
def runtime_device_tier(gen) -> dict:
    """(b) A 256 MiB bf16 CUDA tensor through ``put``/``get`` keeps its
    storage and allocates nothing; a ``num_gpus=1`` task sums it on the
    card; dropping the ref and the tensor frees it."""
    import torch
    import ray_tpu_torch as rt
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    x = torch.randn(128 << 20, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ref = rt.put(x)
    got = rt.get(ref)
    round_trip_ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_allocated()
    if got.data_ptr() != x.data_ptr() or after > held:
        raise RuntimeError(f"device tier copied: data_ptr {got.data_ptr()} "
                           f"vs {x.data_ptr()}, allocated {after} vs {held}")

    @rt.remote(num_gpus=1)
    def total(t):
        return t.float().sum()

    remote_sum = rt.get(total.remote(ref), timeout=120)
    local_sum = x.float().sum()
    if not torch.equal(remote_sum, local_sum):
        raise RuntimeError(f"sum in the task {remote_sum.item()} != the "
                           f"caller's {local_sum.item()}")
    del ref, got, x, remote_sum, local_sum
    # the task's bookkeeping finishes on the runtime's threads: allow it
    # a moment to drop the last pin (other objects the collector frees
    # meanwhile may take the total below the base: released means the
    # tensor's bytes are gone)
    deadline = time.perf_counter() + 10.0
    while True:
        gc.collect()
        torch.cuda.synchronize()
        freed = torch.cuda.memory_allocated()
        if held - freed >= nbytes or time.perf_counter() > deadline:
            break
        time.sleep(0.01)
    if held - freed < nbytes:
        raise RuntimeError(f"device-tier object not released: {freed} "
                           f"bytes allocated, {held} with it, {base} "
                           f"before")
    log(f"device tier: put/get of a {nbytes} byte bf16 tensor in "
        f"{round_trip_ms:.3f} ms, same storage, allocated {after - held} "
        f"more bytes; a num_gpus=1 task's sum equal to the caller's; "
        f"released on del ({freed} bytes allocated, {base} before)")
    return {"bytes": nbytes, "round_trip_ms": round_trip_ms}


def actor_requests(server, mix: dict) -> dict:
    """Phase 3's mix through the ``LLMServer`` actor: the 12 plain prompts
    through ``__call__.remote``, the four prefix sharers through
    ``stream.options(num_returns="streaming").remote``, the last three once
    the first sharer's first token is out; everything collected with
    ``wait``."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    streams = [server.stream.options(num_returns="streaming").remote(
        {"prompt": mix["sharers"][0], "max_tokens": 32})]
    calls = [server.__call__.remote({"prompt": p, "max_tokens": 32})
             for p in mix["prompts"]]
    first = streams[0].next(timeout=600)
    streams += [server.stream.options(num_returns="streaming").remote(
        {"prompt": p, "max_tokens": 32}) for p in mix["sharers"][1:]]
    ready, pending = rt.wait(calls, num_returns=len(calls), timeout=900)
    if pending:
        raise RuntimeError(f"{len(pending)} calls not back in 900 s")
    # each stream's chunk refs, as the actor reports them
    chunk_refs = [first] + [ref for gen in streams for ref in gen]
    ready, pending = rt.wait(chunk_refs, num_returns=len(chunk_refs),
                             timeout=900)
    if pending:
        raise RuntimeError(f"{len(pending)} chunks not back in 900 s")
    wall = time.perf_counter() - t0
    results = [(out["finish_reason"], len(out["token_ids"]))
               for out in rt.get(calls)]
    by_request = {}
    for c in rt.get(chunk_refs):
        by_request.setdefault(c["id"], []).append(c)
    for cs in by_request.values():
        done = [c for c in cs if c.get("done")]
        results.append((done[0]["finish_reason"] if done else None,
                        len(cs) - len(done)))
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in enumerate(results):
        if not finished_ok(reason, n):
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    return {"wall_s": wall, "tokens": sum(n for _, n in results),
            "full": sum(n == 32 for _, n in results)}


@timed("12(c) runtime_serving")
def runtime_serving(llm_config, mix: dict, lone_ids: list,
                    phase3: dict) -> dict:
    """(c) ``LLMServer`` as a ``num_gpus=1`` actor with phase 3's config:
    the lone request gives phase 3's token ids, phase 3's mix goes through
    it, the paged kernel runs once a layer a decode step; a ``num_gpus=1``
    task waits for the card until the actor is killed."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMServer
    n_layers = llm_config.model_config.n_layers
    t0 = time.perf_counter()
    server = rt.remote(LLMServer).options(
        num_gpus=1, max_concurrency=16).remote(llm_config)
    stats0 = rt.get(server.stats.remote(), timeout=900)
    torch.cuda.synchronize()    # the actor's weight init is queued work
    up_s = time.perf_counter() - t0
    for c in kernel_counters():
        c.launches = 0
    lone = rt.get(server.__call__.remote(
        {"prompt": mix["lone"], "max_tokens": 32}), timeout=600)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through the actor gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    served = actor_requests(server, mix)
    stats = rt.get(server.stats.remote())
    launches = read_launches()
    steps = stats["decode_steps"] - stats0["decode_steps"]
    if stats["prefix_prefills"] < 3 or stats["prefix_tokens_reused"] < 192:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    check_paged_only("the actor's path", launches, steps, n_layers)

    @rt.remote(num_gpus=1)
    def on_card():
        return torch.cuda.current_device()

    probe = on_card.remote()
    ready, _ = rt.wait([probe], timeout=2.0)
    if ready:
        raise RuntimeError("a num_gpus=1 task ran while the actor held the "
                           "card")
    rt.get(server.shutdown.remote(), timeout=120)   # stop its engine thread
    rt.kill(server)
    rt.get(probe, timeout=120)
    del server
    free_card()
    rate, rate3 = (served["tokens"] / served["wall_s"],
                   phase3["tokens"] / phase3["wall_s"])
    log(f"LLMServer actor (num_gpus=1, max_concurrency=16) up in "
        f"{up_s:.1f} s; the lone request's 32 token ids equal phase 3's; "
        f"phase 3's 16 requests ({served['full']} of 16 gave 32 tokens): "
        f"{served['tokens']} tokens in "
        f"{served['wall_s']:.2f} s ({rate:.1f} tokens/s against phase 3's "
        f"direct {rate3:.1f}: x{rate / rate3:.3f}); engine stats {stats}; "
        f"launches {launches} ({steps} decode steps x {n_layers} layers); "
        f"a num_gpus=1 task stayed pending until kill(), then ran")
    return {"launches": launches, "steps": steps, "tokens": served["tokens"],
            "wall_s": served["wall_s"], "up_s": up_s}


@timed("12(d) runtime_rates")
def runtime_rates(smi: str) -> dict:
    """(d) The runtime's own cost on this host: no-op tasks, calls on one
    actor and put/get round trips of a 1 MiB numpy array, a second each."""
    import ray_tpu_torch as rt

    @rt.remote
    def noop():
        return None

    @rt.remote
    class Pinger:
        def ping(self):
            return None

    out = {}
    rt.get([noop.remote() for _ in range(100)])           # warm-up
    t0 = time.perf_counter()
    rt.get([noop.remote() for _ in range(1000)])
    out["tasks_per_s"] = 1000 / (time.perf_counter() - t0)
    actor = Pinger.remote()
    rt.get([actor.ping.remote() for _ in range(100)])     # warm-up
    t0 = time.perf_counter()
    rt.get([actor.ping.remote() for _ in range(1000)])
    out["actor_calls_per_s"] = 1000 / (time.perf_counter() - t0)
    rt.kill(actor)
    arr = np.arange(1 << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(100):
        got = rt.get(rt.put(arr))
    out["put_get_per_s"] = 100 / (time.perf_counter() - t0)
    if not np.array_equal(got, arr):
        raise RuntimeError("put/get changed the array")
    log(f"runtime cost on this host ({smi}), tasks and the actor in worker "
        f"processes (the default): {out['tasks_per_s']:.0f} "
        f"no-op tasks/s, {out['actor_calls_per_s']:.0f} actor calls/s, "
        f"{out['put_get_per_s']:.0f} put/get round trips/s of 1 MiB")
    return out


def runtime_path(gen, llm_config, mix: dict, lone_ids: list, phase3: dict,
                 rl: dict, smi: str) -> dict:
    """Phase 12: the runtime on the card, (a)-(d), then (e) phase 11's
    RL-through-the-runtime figures."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    rt.init()
    try:
        out = {"resources": runtime_resources(),
               "device_tier": runtime_device_tier(gen),
               "serving": runtime_serving(llm_config, mix, lone_ids,
                                          phase3),
               "rates": runtime_rates(smi)}
    finally:
        rt.shutdown()
    for name, c in rl["contracts"].items():
        split = c["split"]
        log(f"RL through the runtime ({name}, phase 11): an iteration "
            f"{split['wall_ms']:.2f} ms, the learner's update "
            f"{split['update_ms']:.2f} ms, the runtime's share "
            f"{split['runtime_ms']:.2f} ms ({smi})")
    log(f"phase 12 (runtime) in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: serve on the card
# ---------------------------------------------------------------------------

def serving_config(rng=None):
    """Phase 3's server config and request mix: Llama-3-8B widths (random
    weights from seed 0), the paged kernel, 32 slots, max_seq 1024; the mix
    drawn from ``rng`` (a fresh generator of seed 0 by default)."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              decode_attention="kernel")
    llm_config = LLMConfig(model_id="llama3-8b", model_config=cfg,
                           max_slots=32, max_seq=1024, seed=0)
    rng = np.random.default_rng(0) if rng is None else rng
    return llm_config, request_mix(cfg.vocab_size, rng)


def engine_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "llm-engine" and t.is_alive()]


def wait_freed(base: int, what: str, timeout: float = 10.0,
               threads=engine_threads) -> tuple:
    """Poll with ``gc.collect()`` until ``threads()`` (the engine threads by
    default) is empty and the card's allocated bytes are back within 256 MiB
    of ``base``. Each poll first clears torch's cuBLAS workspaces (one a
    thread that ran a matmul, 32 MiB on Hopper, kept by torch for the
    process's life): torch's cache, not the app's. Returns (allocated
    bytes, bytes the clearing released)."""
    import torch
    deadline = time.perf_counter() + timeout
    workspaces = 0
    while True:
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        left, alloc = threads(), torch.cuda.memory_allocated()
        workspaces += held - alloc
        if not left and alloc - base <= 256 << 20:
            return alloc, workspaces
        if time.perf_counter() > deadline:
            raise RuntimeError(f"{what}: threads {[t.name for t in left]} "
                               f"left, {alloc - base} bytes above the base "
                               f"after {timeout} s")
        time.sleep(0.05)


def handle_requests(handle, mix: dict) -> dict:
    """Phase 3's mix through a serve handle, in phase 12's order: the first
    prefix sharer, then the 12 plain prompts at once, then, once the first
    sharer's first chunk is out, the other three. Eight stream through
    ``handle.options(stream=True)`` (sharers 0 and 2, the even plain
    prompts), eight are unary (the odd plain prompts, sharers 1 and 3)."""
    prompts, sharers = mix["prompts"], mix["sharers"]
    lock = threading.Lock()
    streams = {}                # index -> (reason, tokens, first s, ttft)

    def stream(i, prompt, first=None):
        t0 = time.perf_counter()
        gen = handle.options(stream=True).remote(
            {"prompt": prompt, "max_tokens": 32, "stream": True})
        n, t_first, last = 0, None, None
        for chunk in gen:
            if chunk.get("done"):
                last = chunk
                continue
            n += 1
            if t_first is None:
                t_first = time.perf_counter() - t0
                if first is not None:
                    first.set()
        with lock:
            streams[i] = (last and last["finish_reason"], n, t_first,
                          last and last["ttft_s"])

    def start_stream(i, prompt, first=None):
        t = threading.Thread(target=stream, args=(i, prompt, first))
        t.start()
        return t

    t0 = time.perf_counter()
    first = threading.Event()
    threads = [start_stream(0, sharers[0], first)]
    threads += [start_stream(1 + i, p)
                for i, p in enumerate(prompts) if i % 2 == 0]
    unary = [handle.remote({"prompt": p, "max_tokens": 32})
             for i, p in enumerate(prompts) if i % 2]
    if not first.wait(600):
        raise RuntimeError("no first chunk from the prefix owner")
    unary.append(handle.remote({"prompt": sharers[1], "max_tokens": 32}))
    threads.append(start_stream(13, sharers[2]))
    unary.append(handle.remote({"prompt": sharers[3], "max_tokens": 32}))
    outs = [r.result(timeout=900) for r in unary]
    for t in threads:
        t.join(900)
        if t.is_alive():
            raise RuntimeError("a stream did not finish in 900 s")
    wall = time.perf_counter() - t0
    results = [(o["finish_reason"], len(o["token_ids"])) for o in outs]
    results += [(r, n) for r, n, _, _ in streams.values()]
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in enumerate(results):
        if not finished_ok(reason, n):
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    return {"wall_s": wall, "tokens": sum(n for _, n in results),
            "first_chunk_s": sorted(f for _, _, f, _ in streams.values()),
            "ttft_s": sorted([o["ttft_s"] for o in outs]
                             + [t for _, _, _, t in streams.values()])}


def http_lone(port: int, prompt: list, lone_ids: list) -> None:
    """(b) The lone prompt through the HTTP proxy: one JSON ``POST`` gives
    ``lone_ids``, and so do the ``data:`` chunks of one SSE request, then
    ``[DONE]``."""
    import urllib.request
    url = f"http://127.0.0.1:{port}/"

    def post(payload):
        return urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}), timeout=600)

    with post({"prompt": prompt, "max_tokens": 32}) as resp:
        out = json.loads(resp.read())
    if out.get("token_ids") != lone_ids:
        raise RuntimeError(f"HTTP JSON gave {out}, the handle {lone_ids}")
    ids, done = [], False
    with post({"prompt": prompt, "max_tokens": 32, "stream": True}) as resp:
        if resp.headers["Content-Type"] != "text/event-stream":
            raise RuntimeError(f"SSE content type {resp.headers}")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                done = True
                break
            chunk = json.loads(body)
            if "token_id" in chunk:
                ids.append(chunk["token_id"])
    if not done or ids != lone_ids:
        raise RuntimeError(f"SSE gave {ids} (done {done}), the handle "
                           f"{lone_ids}")


@timed("13(a-c) serve_llm_app")
def serve_llm_app(config, mix: dict, lone_ids: list, smi: str,
                  base: int) -> dict:
    """(a) the LLM app through a serve handle, (b) over HTTP, (c) freed on
    ``serve.delete``."""
    import torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app
    n_layers = config.model_config.n_layers
    t0 = time.perf_counter()
    handle = serve.run(build_llm_app(config))
    torch.cuda.synchronize()    # the replica's weight init is queued work
    up_s = time.perf_counter() - t0
    lone = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through the handle gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    stats0 = handle.stats.remote().result(timeout=60)
    for c in kernel_counters():
        c.launches = 0
    served = handle_requests(handle, mix)
    launches = read_launches()
    stats = handle.stats.remote().result(timeout=60)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    if stats["prefix_prefills"] < 3:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    check_paged_only("serve handle", launches, steps, n_layers)
    first, ttft = served["first_chunk_s"], served["ttft_s"]
    log(f"serve LLM app (one replica) up in {up_s:.1f} s; the lone "
        f"request's 32 token ids equal phase 3's; phase 3's 16 requests "
        f"(8 unary, 8 streams): {served['tokens']} tokens in "
        f"{served['wall_s']:.2f} s ({served['tokens'] / served['wall_s']:.1f}"
        f" tokens/s); client time to the first chunk of the 8 streams "
        f"median {np.median(first) * 1e3:.1f} ms, max {first[-1] * 1e3:.1f}"
        f" ms; engine ttft_s median {np.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms; launches {launches} ({steps} decode "
        f"steps x {n_layers} layers); engine stats {stats} ({smi})")

    # The lone prompt's blocks are in the engine's prefix cache since its
    # first request: asked again, it takes the prefix path (2 of its 3
    # blocks reused), whose bf16 numbers differ from a full prefill's, so
    # its ids are held to the handle's answer in the same state, not to
    # phase 3's cold request.
    warm = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    stats_warm = handle.stats.remote().result(timeout=60)
    if stats_warm["prefix_prefills"] != stats["prefix_prefills"] + 1:
        raise RuntimeError(f"the repeated lone prompt missed the prefix "
                           f"cache: {stats} then {stats_warm}")
    same = next((i for i, (a, b) in enumerate(zip(warm["token_ids"],
                                                  lone_ids)) if a != b), 32)
    port = serve.start_http_proxy(port=0)
    http_lone(port, mix["lone"], warm["token_ids"])
    log(f"HTTP proxy (port {port}): the lone prompt again (a prefix hit, "
        f"{stats_warm['prefix_tokens_reused'] - stats['prefix_tokens_reused']}"
        f" tokens reused) as JSON and as SSE gave the handle's 32 token ids "
        f"for it, then [DONE]; those equal phase 3's cold ids for the first "
        f"{same} tokens ({smi})")

    serve.delete("default")
    del handle
    freed, workspaces = wait_freed(base, "serve.delete of the LLM app")
    log(f"serve.delete: no engine thread left, {freed} bytes allocated "
        f"({base} before the app; {workspaces} bytes of cuBLAS workspaces "
        f"cleared) ({smi})")
    return {"launches": launches["paged_decode_attention"], "steps": steps,
            "tokens": served["tokens"], "wall_s": served["wall_s"],
            "first_chunk_s": first, "ttft_s": ttft, "up_s": up_s}


@timed("13(d) serve_pd_app")
def serve_pd_app(config, mix: dict, lone_ids: list, smi: str,
                 base: int) -> dict:
    """(d) the prefill/decode graph: the lone request, then phase 3's 16
    prompts at once through the orchestrator; freed on ``serve.shutdown``."""
    import torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.disagg import build_pd_disagg_app
    n_layers = config.model_config.n_layers
    t0 = time.perf_counter()
    handle = serve.run(build_pd_disagg_app(config, num_prefill=1,
                                           num_decode=1), name="pd")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    peak = torch.cuda.memory_allocated()
    lone = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through prefill/decode gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    decode = serve.get_deployment_handle(f"{config.model_id}-decode")
    prefill = serve.get_deployment_handle(f"{config.model_id}-prefill")
    stats0 = decode.stats.remote().result(timeout=60)
    for c in kernel_counters():
        c.launches = 0
    t0 = time.perf_counter()
    outs = [handle.remote({"prompt": p, "max_tokens": 32})
            for p in mix["prompts"] + mix["sharers"]]
    outs = [o.result(timeout=900) for o in outs]
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = decode.stats.remote().result(timeout=60)
    pre = prefill.stats.remote().result(timeout=60)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    for i, o in enumerate(outs):
        if not finished_ok(o["finish_reason"], len(o["token_ids"])):
            raise RuntimeError(f"request {i}: {o}")
    check_paged_only("prefill/decode", launches, steps, n_layers)
    tokens = sum(len(o["token_ids"]) for o in outs)
    handoffs = stats["handoffs"][-16:]
    kv_mb = np.median([b for b, _ in handoffs]) / 1e6
    copy_ms = np.median([s for _, s in handoffs]) * 1e3
    prefill_ms = np.median(pre["prefill_s"][-16:]) * 1e3
    log(f"prefill/decode graph (1 prefill + 1 decode replica, "
        f"{peak / 2**30:.1f} GiB allocated) up in {up_s:.1f} s; the lone "
        f"request's 32 token ids equal phase 3's; phase 3's 16 prompts at "
        f"once: {tokens} tokens in {wall:.2f} s ({tokens / wall:.1f} "
        f"tokens/s); KV handoff a request, median: {kv_mb:.2f} MB, its "
        f"copy onto the card {copy_ms:.2f} ms (host time, the stream's "
        f"queued work first), the prefill and its copy to the host "
        f"{prefill_ms:.2f} ms; launches "
        f"{launches} ({steps} decode steps x {n_layers} layers) ({smi})")
    del handle, decode, prefill
    serve.shutdown()
    freed, workspaces = wait_freed(
        base, "serve.shutdown of the prefill/decode graph")
    log(f"serve.shutdown: no engine thread left, {freed} bytes allocated "
        f"({base} before the apps; {workspaces} bytes of cuBLAS workspaces "
        f"cleared) ({smi})")
    return {"launches": launches["paged_decode_attention"], "steps": steps,
            "tokens": tokens, "wall_s": wall, "kv_mb": kv_mb,
            "copy_ms": copy_ms, "prefill_ms": prefill_ms}


@timed("13(e) serve_rates")
def serve_rates(smi: str, actor_calls_per_s=None) -> dict:
    """(e) The serve data plane's own cost on this host: a no-op function
    deployment with 2 replicas, 1,000 sequential calls and 1,000 in flight
    at once, a second each."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    def noop(x):
        return x

    handle = serve.run(noop.bind(), name="noop")
    for i in range(100):                                  # warm-up
        handle.remote(i).result(timeout=60)
    t0 = time.perf_counter()
    for i in range(1000):
        handle.remote(i).result(timeout=60)
    seq = 1000 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    resps = [handle.remote(i) for i in range(1000)]
    got = [r.result(timeout=120) for r in resps]
    burst = 1000 / (time.perf_counter() - t0)
    if got != list(range(1000)):
        raise RuntimeError("the no-op deployment changed its inputs")
    beside = (f"phase 12's actor calls {actor_calls_per_s:.0f}/s"
              if actor_calls_per_s else "phase 12 not run")
    log(f"serve data plane on this host ({smi}): {seq:.0f} sequential "
        f"handle calls/s, {burst:.0f} calls/s with 1,000 in flight "
        f"(2 no-op replicas), beside {beside}")
    serve.shutdown()
    return {"sequential_per_s": seq, "in_flight_per_s": burst}


def log_prefix_compare(server, prompt: list) -> None:
    cmp = prefix_logits_compare(server, prompt)
    log(f"the lone prompt's last logits through the prefix path "
        f"({cmp['shared']} tokens cached) against a full prefill: max abs "
        f"err {cmp['max_abs_err']:.3e} (atol 0.15 rtol 0.05), argmax equal "
        f"{cmp['argmax_equal']}, top-2 gap of the full prefill "
        f"{cmp['top2_gap']:.3e}")


def serve_path(dev, llm_config=None, mix=None, lone_ids=None, phase3=None,
               phase12=None, smi=None) -> dict:
    """Phase 13: serve on the card, (a)-(e), on a fresh ``init()``. Alone
    (``python -c "import chip_smoke, torch;
    chip_smoke.serve_path(torch.device('cuda'))"``) it first runs phase 3's
    lone request on a direct ``LLMServer`` for the token ids to hold."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMServer
    t0 = time.perf_counter()
    if smi is None:
        smi = card_name()
    if llm_config is None:
        llm_config, mix = serving_config()
    if lone_ids is None:
        server = LLMServer(llm_config, device=dev)
        try:
            lone_ids = server({"prompt": mix["lone"],
                               "max_tokens": 32})["token_ids"]
            log_prefix_compare(server, mix["lone"])
        finally:
            server.shutdown()
        del server
    if rt.is_initialized() or engine_threads():
        raise RuntimeError("phase 12's runtime or an engine thread is "
                           "still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    log(f"phase 13: no runtime and no engine thread up (phase 12's server "
        f"is gone); {base} bytes allocated as the base ({smi})")
    rt.init()
    try:
        app = serve_llm_app(llm_config, mix, lone_ids, smi, base)
        pd = serve_pd_app(llm_config, mix, lone_ids, smi, base)
        rates = serve_rates(smi, phase12 and phase12["rates"][
            "actor_calls_per_s"])
    finally:
        rt.shutdown()
    rate = app["tokens"] / app["wall_s"]
    beside = []
    if phase3:
        beside.append(f"phase 3's direct server "
                      f"{phase3['tokens'] / phase3['wall_s']:.1f}")
    if phase12:
        served = phase12["serving"]
        beside.append(f"phase 12's actor "
                      f"{served['tokens'] / served['wall_s']:.1f}")
    log(f"phase 13 (serve) in {time.perf_counter() - t0:.1f} s: the LLM "
        f"app {rate:.1f} tokens/s beside {', '.join(beside) or 'nothing'};"
        f" prefill/decode {pd['tokens'] / pd['wall_s']:.1f} tokens/s "
        f"({smi})")
    return {"app": app, "pd": pd, "rates": rates,
            "launches": app["launches"] + pd["launches"]}


# ---------------------------------------------------------------------------
# phase 14: the open-loop serving bench
# ---------------------------------------------------------------------------

def bench_row(what: str, out: dict, smi: str) -> dict:
    """Check one ``run_serving_bench`` result: every scheduled request
    completed, no error, no abandoned client; the paged kernel once per
    layer per decode step of the replica's engine (counters at 0 before the
    run) and no other kernel. Prints ``serving_section``."""
    from ray_tpu_torch.llm.bench import serving_section
    detail, s = out["detail"], out["serving"]
    if (s["completed"] != detail["scheduled_requests"] or s["errors"]
            or detail.get("abandoned_clients")):
        raise RuntimeError(f"{what}: {s['completed']} of "
                           f"{detail['scheduled_requests']} completed, "
                           f"{s['errors']} errors, "
                           f"{detail.get('abandoned_clients', 0)} clients "
                           f"abandoned")
    n_layers = BENCH_LAYERS
    launches = read_launches()
    steps = sum(st["decode_steps"] for st in detail["engine_stats"])
    check_paged_only(what, launches, steps, n_layers)
    log(f"{what}: serving {json.dumps(serving_section(detail))}; engine "
        f"ttft_s {json.dumps(detail['engine_ttft_s'])}; e2e "
        f"{json.dumps(detail['e2e_s'])}; queue "
        f"{json.dumps(detail['queue_s'])}; wall {detail['wall_s']} s; "
        f"launches {launches} ({steps} decode steps x {n_layers} layers); "
        f"engine stats {detail['engine_stats']} ({smi})")
    return {"serving": s, "launches": launches["paged_decode_attention"],
            "steps": steps, "engine_ttft_s": detail["engine_ttft_s"]}


def check_bench_paged(dev, smi: str) -> dict:
    """The paged kernel against its plain version at the bench engine's
    shapes: 32 slots of ``bench_400m`` (8 query / 4 KV heads, D 128), block
    32, a 32-block table (max_seq 1024, 8 chunks of 128 rows), bf16, at
    lengths from 32 to 320 that sit on and beside every chunk edge those
    lengths reach. A version that drops the last 32-row tile of the slots
    longer than 128 must read above the tolerance."""
    import torch
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.ops import paged_attention as paged
    cfg = LlamaConfig.bench_400m(max_seq_len=1024)
    B, H, Hkv, D, bs = 32, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 32
    maxb = 1024 // bs
    NB = B * maxb + 1                          # + the engine's scratch block
    dt, scale = torch.bfloat16, D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(14)
    edges = [32, 33, 63, 64, 65, 96, 127, 128, 129, 160, 191, 192, 193,
             224, 255, 256, 257, 288, 319, 320]
    rng = np.random.default_rng(14)
    lengths = np.array(edges + list(rng.integers(32, 321, B - len(edges))),
                       dtype=np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    short = torch.from_numpy(lengths - ((lengths - 1) % bs + 1)).to(dev)
    long_slots = torch.from_numpy(np.flatnonzero(lengths > 128)).to(dev)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, kp, vp = rand((B, H, D)), rand((NB, bs, Hkv, D)), \
        rand((NB, bs, Hkv, D))
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = paged._paged_decode_plain(q, kp, vp, tables, short, scale=scale)
    row = {"max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "tol_ratio": tol_ratio(out, plain),
           "skip_ratio": tol_ratio(wrong[long_slots], plain[long_slots])}
    log(f"paged kernel at the bench's shapes (bf16 B={B} H={H} Hkv={Hkv} "
        f"D={D} block {bs}, lengths {lengths.min()}-{lengths.max()} across "
        f"the 128-row chunk edges): max_abs_err {row['max_abs_err']:.3e}, "
        f"{row['tol_ratio']:.2f}x the tolerance {BF16_TOL}; a version that "
        f"skips the last tile of the slots longer than 128 reads "
        f"{row['skip_ratio']:.2f}x it ({smi})")
    if row["skip_ratio"] <= 1:
        raise RuntimeError("paged kernel at the bench's shapes: the bf16 "
                           "tolerance does not tell a skipped last tile "
                           "from the kernel")
    return row


def serving_bench_path(dev, smi=None) -> dict:
    """Phase 14: ``ray_tpu_torch.llm.bench`` on a fresh ``init()``, the
    paged kernel first held to its plain version at the bench's shapes,
    then every counter at 0 before each run: (a) ``run_serving_bench()``
    streaming through the handle, (b) the same load unary (the router's
    waiter path), (c) ``run_http_proxy_bench()``; then the card's allocated
    bytes are back within 256 MiB of the base. Alone: ``python -c "import
    chip_smoke, torch; chip_smoke.serving_bench_path(torch.device('cuda'))"``.
    ``python -m ray_tpu_torch.profile_serving`` compares the streams with
    the same load straight into an ``LLMServer``."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm.bench import run_http_proxy_bench, \
        run_serving_bench
    t0 = time.perf_counter()
    smi = smi or card_name()
    kernel_check = check_bench_paged(dev, smi)
    if rt.is_initialized() or engine_threads():
        raise RuntimeError("a runtime or an engine thread is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    rt.init()
    try:
        rows = {}
        for key, stream in (("stream", True), ("unary", False)):
            for c in kernel_counters():
                c.launches = 0
            out = run_serving_bench(dev, stream=stream,
                                    n_layers=BENCH_LAYERS)
            if out["device"] != smi:
                raise RuntimeError(f"the bench names {out['device']!r}")
            rows[key] = bench_row(
                f"open-loop bench ({'streams' if stream else 'unary'}, "
                f"bench_400m at {BENCH_LAYERS} layers, 6 requests/s for 16 "
                f"s, 64 clients)", out, smi)
        a, b = rows["stream"]["serving"], rows["unary"]["serving"]
        log(f"unary beside streams: {b['requests_per_second']} / "
            f"{a['requests_per_second']} requests/s, ttft p99 "
            f"{b['ttft_p99_s']} / {a['ttft_p99_s']} s, e2e p99 "
            f"{b['e2e_p99_s']} / {a['e2e_p99_s']} s, goodput "
            f"{b['goodput_requests_per_second']} / "
            f"{a['goodput_requests_per_second']} requests/s ({smi})")
        for c in kernel_counters():
            c.launches = 0
        http = run_http_proxy_bench(dev, n_layers=BENCH_LAYERS)
        launches = read_launches()
        d = http["detail"]
        steps = sum(st["decode_steps"] for st in d["engine_stats"])
        if d["streams_done"] != d["requests"] or d["requests"] != 64 \
                or d["output_tokens"] != 64 * 64:
            raise RuntimeError(f"HTTP bench: {d}")
        n_layers = BENCH_LAYERS
        check_paged_only("HTTP bench", launches, steps, n_layers)
        log(f"HTTP bench (64 requests, 16 at a time, 64 tokens, SSE): "
            f"every stream ended in [DONE]; {http['value']} tokens/s, ttft "
            f"p50 / p90 / p99 {d['ttft_p50_ms']} / {d['ttft_p90_ms']} / "
            f"{d['ttft_p99_ms']} ms, wall {d['wall_s']} s; launches "
            f"{launches} ({steps} decode steps x {n_layers} layers) ({smi})")
        rows["http"] = {"launches": launches["paged_decode_attention"],
                        "tokens_per_s": http["value"], "detail": d}
        freed, workspaces = wait_freed(base, "serve.shutdown of the bench")
        log(f"after the bench's serve.shutdown: no engine thread left, "
            f"{freed} bytes allocated ({base} before; {workspaces} bytes of "
            f"cuBLAS workspaces cleared) ({smi})")
    finally:
        rt.shutdown()
    rows["launches"] = sum(rows[k]["launches"]
                           for k in ("stream", "unary", "http"))
    rows["kernel_check"] = kernel_check
    log(f"phase 14 (open-loop bench) in {time.perf_counter() - t0:.1f} s; "
        f"paged launches {rows['launches']} ({smi})")
    return rows


# ---------------------------------------------------------------------------
# phase 15: the train driver
# ---------------------------------------------------------------------------

def bench_step(dev, lr=None, n_layers: int = BENCH_LAYERS) -> tuple:
    """bench_400m's train step at ``n_layers`` layers on ``dev`` through
    ``make_train_step`` (AdamW at ``lr``; None: the default, 3e-4) and
    phase 5's batch (8 x 2048, seed 0)."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import LlamaModel
    cfg = bench_config(n_layers)
    optimizer = None
    if lr is not None:
        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.1)
    ts = train.make_train_step(LlamaModel(cfg, device=dev),
                               optimizer=optimizer)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int64)
    return ts, train.shard_batch((tokens, np.roll(tokens, -1, axis=1)), ts)


def bench_train_loop(config: dict) -> None:
    """One rank of phases 15 and 16(b): ``bench_step`` at ``config["lr"]``
    on the card, ``config["steps"]`` AdamW steps, each reported with its
    loss, its time and its wall-clock window; rank 0 checkpoints params and
    AdamW state after step ``ckpt_at`` and raises once before step
    ``fail_at`` (the marker file says it did); a restarted group resumes
    from the checkpoint."""
    import os
    import torch
    from ray_tpu_torch import train
    loop_t0 = time.time()
    dev = torch.device(config["device"])
    ts, batch = bench_step(dev, config.get("lr"),
                           config.get("layers", BENCH_LAYERS))
    prev, start, restore_s = train.get_checkpoint(), 0, None
    if prev is None:
        params, opt = ts.init_fn(0)
    else:
        t0 = time.perf_counter()
        state = prev.to_pytree(device=dev)
        params = state["params"]
        opt = ts.opt_init(params)
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
        del state
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
    rank0 = train.get_context().get_world_rank() == 0
    for step in range(start, config["steps"]):
        if step == config.get("fail_at") and \
                not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError(f"injected failure before step {step}")
        t0, wall0 = time.perf_counter(), time.time()
        params, opt, m = ts.step_fn(params, opt, batch)
        metrics = {"step": step, "loss": m["loss"].item(),
                   "step_s": time.perf_counter() - t0, "lr": config.get("lr"),
                   "window": (wall0, time.time()), "loop_t0": loop_t0}
        if restore_s is not None:
            metrics["restore_s"], restore_s = restore_s, None
        ck = None
        if rank0 and step == config.get("ckpt_at"):
            t0 = time.perf_counter()
            ck = train.Checkpoint.from_pytree(
                {"params": params, "opt": opt.state_dict(), "step": step},
                os.path.join(config["dir"], f"step{step}"))
            metrics["write_s"] = time.perf_counter() - t0
        train.report(metrics, checkpoint=ck)


def actor_threads(class_names):
    """A function listing the live executor threads of the runtime's
    actors of these classes (their ids are read now, while the runtime is
    up)."""
    from ray_tpu_torch._private import worker
    rt = worker.global_runtime()
    ids = {aid.hex()[:8] for aid, info in rt.gcs.actors.items()
           if info.class_name in class_names}
    return lambda: [t for t in threading.enumerate() if t.is_alive()
                    and t.name.startswith("actor-") and t.name[6:14] in ids]


def train_driver_path(dev, phase5=None, smi=None) -> dict:
    """Phase 15: ``JaxTrainer`` on a fresh ``init()``, the flash counter at 0
    before each run: (a) one worker, ``ScalingConfig(use_gpu=True)``, 6
    steps of ``bench_train_loop``; a ``num_gpus=1`` task submitted at the
    first report stays pending until the group's bundle is gone; the first
    loss held to phase 5's; (b) the same with ``FailureConfig(max_failures=
    1)``: a checkpoint after step 3, a failure before step 4, the group
    re-formed from the checkpoint, steps 4-5 held to (a)'s; (c) no train
    worker thread left and the card's bytes back within 256 MiB of the
    base. Alone (it first runs phase 5 for its loss and step time):
    ``python -c "import chip_smoke, torch;
    chip_smoke.train_driver_path(torch.device('cuda'))"``."""
    import os
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train.callbacks import Callback
    t0 = time.perf_counter()
    smi = smi or card_name()
    n_layers = BENCH_LAYERS
    if phase5 is None:
        phase5 = train_path(dev, n_layers)
        free_card()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rt.init()
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")

        @rt.remote(num_gpus=1)
        def on_card():
            return "ran"

        class CardHeld(Callback):
            """At the first report, submit a ``num_gpus=1`` task; at every
            report, note whether it has run."""

            def __init__(self):
                self.ref, self.ran_during_fit = None, []

            def on_report(self, metrics, iteration, rank=0, trial_id=""):
                if self.ref is None:
                    self.ref = on_card.remote()
                ready, _ = rt.wait([self.ref], timeout=0)
                self.ran_during_fit.append(bool(ready))

        runs = {}
        for key, extra in (("a", {}), ("b", {"ckpt_at": 3, "fail_at": 4})):
            attn.flash_attention_kernel.launches = 0
            held = CardHeld()
            config = {"device": str(dev), "steps": 6,
                      "marker": os.path.join(tmp, f"failed_{key}"),
                      "dir": os.path.join(tmp, f"ckpt_{key}"), **extra}
            t1 = time.perf_counter()
            result = train.JaxTrainer(
                bench_train_loop, train_loop_config=config,
                scaling_config=train.ScalingConfig(use_gpu=True),
                run_config=train.RunConfig(
                    name=f"phase15{key}", storage_path=tmp,
                    callbacks=[held] if key == "a" else [],
                    failure_config=train.FailureConfig(
                        max_failures=1 if extra else 0))).fit()
            fit_s = time.perf_counter() - t1
            launches = attn.flash_attention_kernel.launches
            if result.error is not None:
                raise RuntimeError(f"phase 15({key}): {result.error}")
            hist = [e["metrics"] for e in result.metrics_history]
            if [m["step"] for m in hist] != list(range(6)):
                raise RuntimeError(f"phase 15({key}) steps: {hist}")
            if launches != 2 * n_layers * 6:
                raise RuntimeError(f"phase 15({key}): flash launches "
                                   f"{launches} != 2 x {n_layers} x 6")
            runs[key] = {"losses": [m["loss"] for m in hist],
                         "step_s": [m["step_s"] for m in hist],
                         "launches": launches, "fit_s": fit_s, "hist": hist}
            if key == "a":
                if not held.ran_during_fit or any(held.ran_during_fit):
                    raise RuntimeError(f"a num_gpus=1 task ran while the "
                                       f"group held the card: "
                                       f"{held.ran_during_fit}")
                if rt.get(held.ref, timeout=60) != "ran":
                    raise RuntimeError("the num_gpus=1 task did not run")
                runs[key]["pending_reports"] = len(held.ran_during_fit)
        a, b = runs["a"], runs["b"]
        torch.testing.assert_close(torch.tensor(a["losses"][0]),
                                   torch.tensor(phase5["loss_first"]),
                                   **LOSS_TOL)
        torch.testing.assert_close(torch.tensor(b["losses"][4:]),
                                   torch.tensor(a["losses"][4:]), **LOSS_TOL)
        write_s = next(m["write_s"] for m in b["hist"] if "write_s" in m)
        restore_s = next(m["restore_s"] for m in b["hist"]
                         if "restore_s" in m)
        ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(
                           os.path.join(tmp, "ckpt_b")) for f in fs)
        step_ms = float(np.median(a["step_s"][1:])) * 1e3
        log(f"JaxTrainer, one worker in a placement group holding the card "
            f"(ScalingConfig(use_gpu=True)), bench_400m 8 x 2048, 6 AdamW "
            f"steps: losses {a['losses']}; first loss against phase 5's "
            f"{phase5['loss_first']:.6f} (rtol 1e-3 atol 1e-4); step "
            f"median {step_ms:.2f} ms (steps 1-5, host clock around each "
            f"step and its loss's .item()) beside phase 5's "
            f"{phase5['step_ms']:.2f} ms; a num_gpus=1 task stayed pending "
            f"through {a['pending_reports']} reports and ran once the "
            f"group was gone; fit {a['fit_s']:.1f} s; flash launches "
            f"{a['launches']} ({smi})")
        log(f"with FailureConfig(max_failures=1): checkpoint of params and "
            f"AdamW state after step 3, {ck_bytes / 1e9:.2f} GB, written "
            f"in {write_s:.2f} s (device to host and np.savez); failure "
            f"before step 4; the group re-formed and restored it in "
            f"{restore_s:.2f} s (np.load and host to device); losses "
            f"{b['losses']}, steps 4-5 against the uninterrupted run's "
            f"(rtol 1e-3 atol 1e-4); fit {b['fit_s']:.1f} s; flash "
            f"launches {b['launches']} ({smi})")
        freed, workspaces = wait_freed(
            base, "after fit()", threads=actor_threads({"_TrainWorker"}))
        log(f"after fit(): no train worker thread left, {freed} bytes "
            f"allocated ({base} before; {workspaces} bytes of cuBLAS "
            f"workspaces cleared) ({smi})")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"launches": a["launches"] + b["launches"], "step_ms": step_ms,
           "write_s": write_s, "restore_s": restore_s,
           "ck_bytes": ck_bytes, "runs": runs}
    log(f"phase 15 (train driver) in {time.perf_counter() - t0:.1f} s; "
        f"flash launches {out['launches']} ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 16: tune and the utilities
# ---------------------------------------------------------------------------

def tune_trainable(config: dict, device, layers: int) -> None:
    """One trial of phase 16(a): the card's allocated bytes before the model
    is built, then ``bench_step`` at the trial's lr and ``layers`` for up to
    6 steps, each
    reported with its loss, its time and the card's peak bytes since the
    trial began (one trial runs at a time)."""
    import torch
    from ray_tpu_torch import tune
    dev = torch.device(device)
    start_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ts, batch = bench_step(dev, config["lr"], layers)
    params, opt = ts.init_fn(0)
    for i in range(6):
        t0 = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, batch)
        metrics = {"training_iteration": i + 1, "loss": m["loss"].item(),
                   "step_s": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(dev)}
        if i == 0:
            metrics["start_bytes"] = start_bytes
        tune.report(metrics)


def tune_asha(dev, ref: dict, base: int, n_layers: int, smi: str):
    """Phase 16(a): ASHA over three lrs of bench_400m at ``n_layers``
    layers, one trial at a time; ``ref`` is ``run_train``'s at that
    depth."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tune import AsyncHyperBandScheduler

    class Recording(AsyncHyperBandScheduler):
        """ASHA noting each result it was fed and its decision."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.fed = []

        def on_result(self, trial, result):
            decision = super().on_result(trial, result)
            self.fed.append((trial.config["lr"], dict(result), decision))
            return decision

    asha = dict(grace_period=2, reduction_factor=2, max_t=6)
    sched = Recording(**asha)
    attn.flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune.with_parameters(tune_trainable, device=dev, layers=n_layers),
        param_space={"lr": tune.grid_search([1e-3, 0.0, 3e-4])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1,
                                    scheduler=sched)).fit()
    fit_s = time.perf_counter() - t0
    launches = attn.flash_attention_kernel.launches
    if grid.errors:
        raise RuntimeError(f"phase 16(a) trials failed: {grid.errors}")
    trials = {t.config["lr"]: t for t in grid.trials}
    first = ref["loss_first"]
    for lr, t in trials.items():
        torch_close(t.results[0]["loss"], first)
        if t.results[0]["start_bytes"] - base > 256 << 20:
            raise RuntimeError(f"trial lr {lr} started with "
                               f"{t.results[0]['start_bytes']} bytes, "
                               f"{base} at the phase's start")
    zero, best = trials[0.0], trials[1e-3]
    stops = [(lr, r["training_iteration"]) for lr, r, d in sched.fed
             if d == "STOP"]
    # stopped at the rung: the one report after it is the one that raised
    if zero.status != "STOPPED" or \
            min(t for lr, t in stops if lr == 0.0) != 2 or \
            len(zero.results) > 3:
        raise RuntimeError(f"the lr 0.0 trial was not stopped at its rung: "
                           f"{zero.status}, stops {stops}, "
                           f"{len(zero.results)} reports")
    torch_close(zero.results[1]["loss"], first)
    if not best.results[1]["loss"] < zero.results[1]["loss"]:
        raise RuntimeError(f"rung 2: lr 0.0 {zero.results[1]['loss']}, "
                           f"lr 1e-3 {best.results[1]['loss']}")
    if grid.get_best_result().config["lr"] != 1e-3:
        raise RuntimeError(f"best {grid.get_best_result().config}")
    replay = AsyncHyperBandScheduler(**asha)
    again = [replay.on_result(None, r) for _, r, _ in sched.fed]
    if again != [d for _, _, d in sched.fed]:
        raise RuntimeError(f"decisions {sched.fed} replay as {again}")
    steps = sum(len(t.results) for t in grid.trials)
    if launches != 2 * n_layers * steps:
        raise RuntimeError(f"phase 16(a): flash launches {launches} != "
                           f"2 x {n_layers} x {steps} reported steps")
    step_s = [r["step_s"] for t in grid.trials for r in t.results[1:]]
    out = {"part": "16a", "trials": [
        {"lr": lr, "status": t.status,
         "iterations": [r["training_iteration"] for r in t.results],
         "losses": [r["loss"] for r in t.results],
         "start_bytes": t.results[0]["start_bytes"],
         "peak_bytes": max(r["peak"] for r in t.results)}
        for lr, t in trials.items()],
        "stops": stops, "best_lr": 1e-3, "ref_loss_first": first,
        "step_ms_median": float(np.median(step_s)) * 1e3,
        "ref_step_ms": ref["step_ms"], "base_bytes": base,
        "flash_launches": launches, "reported_steps": steps,
        "fit_s": fit_s, "card": smi}
    log(json.dumps(out))
    return out


def torch_close(a: float, b: float) -> None:
    import torch
    torch.testing.assert_close(torch.tensor(a), torch.tensor(b), **LOSS_TOL)


def tune_trainer(dev, ref: dict, asha: dict, tmp: str, n_layers: int,
                 smi: str) -> dict:
    """Phase 16(b): Train-on-Tune, two trials of a one-worker JaxTrainer
    holding the card, both trial actors started at once."""
    import torch
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train.callbacks import Callback

    class Reports(Callback):
        """Every worker report of both trials (they share the trainer's
        run config)."""

        def __init__(self):
            self.seen = []

        def on_report(self, metrics, iteration, rank=0, trial_id=""):
            self.seen.append(dict(metrics))

    reports = Reports()
    attn.flash_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    wall0, t0 = time.time(), time.perf_counter()
    grid = tune.Tuner(
        train.JaxTrainer(
            bench_train_loop,
            train_loop_config={"device": str(dev), "steps": 3,
                               "layers": n_layers},
            scaling_config=train.ScalingConfig(use_gpu=True),
            run_config=train.RunConfig(name="phase16b", storage_path=tmp,
                                       callbacks=[reports])),
        param_space={"train_loop_config": {
            "lr": tune.grid_search([1e-3, 3e-4])}},
        tune_config=tune.TuneConfig(max_concurrent_trials=2)).fit()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = attn.flash_attention_kernel.launches
    if grid.errors or [t.status for t in grid.trials] != ["TERMINATED"] * 2:
        raise RuntimeError(f"phase 16(b): {[t.status for t in grid.trials]}"
                           f" {grid.errors}")
    windows, waits, losses = [], {}, {}
    for t in grid.trials:
        lr = t.config["lr"]
        mine = [m for m in reports.seen if m["lr"] == lr]
        if [m["step"] for m in mine] != [0, 1, 2] or \
                t.last_result["step"] != 2 or \
                t.last_result["loss"] != mine[-1]["loss"]:
            raise RuntimeError(f"phase 16(b) lr {lr}: reports {mine}, "
                               f"result {t.last_result}")
        torch_close(mine[0]["loss"], ref["loss_first"])
        windows.append((mine[0]["window"][0], mine[-1]["window"][1]))
        waits[lr] = mine[0]["loop_t0"] - wall0
        losses[lr] = [m["loss"] for m in mine]
    (a0, a1), (b0, b1) = sorted(windows)
    if not a1 <= b0:
        raise RuntimeError(f"phase 16(b): the trials' step windows overlap "
                           f"({windows}): two groups held the card at once")
    if launches != 2 * 3 * 2 * n_layers:
        raise RuntimeError(f"phase 16(b): flash launches {launches} != "
                           f"2 x 3 x 2 x {n_layers}")
    one = max(tr["peak_bytes"] for tr in asha["trials"])
    if peak > 1.25 * one:
        raise RuntimeError(f"phase 16(b) peak {peak} bytes, one trial's "
                           f"peak in (a) {one}")
    out = {"part": "16b", "trials": [
        {"lr": t.config["lr"], "status": t.status,
         "metrics_step": t.last_result["step"],
         "losses": losses[t.config["lr"]]} for t in grid.trials],
        "loop_start_after_fit_start_s": waits,
        "gap_between_step_windows_s": b0 - a1, "peak_bytes": peak,
        "one_trial_peak_bytes_16a": one, "flash_launches": launches,
        "fit_s": fit_s, "card": smi}
    log(json.dumps(out))
    return out


def tune_utilities(dev, smi: str) -> dict:
    """Phase 16(c): ``util.collective`` between two ``num_gpus=0.5`` actors
    on 64 MiB bf16 CUDA tensors, ``ActorPool`` and ``Queue`` on the card."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import ActorPool, Queue
    from ray_tpu_torch.util import collective as col

    @rt.remote(num_gpus=0.5)
    class Rank:
        def __init__(self, rank: int, device: str):
            col.init_collective_group(2, rank, group_name="g")
            self.rank, self.dev = rank, torch.device(device)
            g = torch.Generator(device=self.dev).manual_seed(rank)
            self.part = torch.randn(32 << 20, generator=g, device=self.dev,
                                    dtype=torch.bfloat16)

        def get_part(self):
            return self.part

        def allreduce(self):
            out = col.allreduce(self.part, group_name="g")
            torch.cuda.synchronize(self.dev)
            return out

        def ops(self):
            gathered = col.allgather(self.part, group_name="g")
            bc = col.broadcast(self.part, src_rank=1, group_name="g")
            chunk = col.reducescatter(self.part, group_name="g")
            if self.rank == 0:
                col.send(self.part, 1, group_name="g")
                got = None
            else:
                got = col.recv(0, group_name="g")
            col.barrier(group_name="g")
            return gathered, bc, chunk, got

        def echo(self, x):
            return x

        def destroy(self):
            col.destroy_collective_group("g")

    ranks = [Rank.remote(r, str(dev)) for r in range(2)]
    parts = rt.get([r.get_part.remote() for r in ranks])
    want = parts[0] + parts[1]
    t0 = time.perf_counter()
    outs = rt.get([r.allreduce.remote() for r in ranks])
    allreduce_ms = (time.perf_counter() - t0) * 1e3
    for o in outs:
        if not (o.is_cuda and o.dtype == torch.bfloat16
                and torch.equal(o, want)):
            raise RuntimeError(f"allreduce gave {o.device} {o.dtype}, "
                               f"equal {torch.equal(o.cpu(), want.cpu())}")
    one_result = outs[0].data_ptr() == outs[1].data_ptr()
    chunks = torch.tensor_split(want, 2)
    for rank, (gathered, bc, chunk, got) in enumerate(
            rt.get([r.ops.remote() for r in ranks])):
        if [g.data_ptr() for g in gathered] != \
                [p.data_ptr() for p in parts] or \
                bc.data_ptr() != parts[1].data_ptr():
            raise RuntimeError("allgather or broadcast copied a part")
        if not (chunk.is_cuda and chunk.dtype == torch.bfloat16
                and torch.equal(chunk, chunks[rank])):
            raise RuntimeError(f"reducescatter's chunk {rank} is wrong")
        if rank == 1 and got.data_ptr() != parts[0].data_ptr():
            raise RuntimeError("recv did not get rank 0's tensor")
    rt.get([r.destroy.remote() for r in ranks])
    x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
    pool = ActorPool(ranks)
    pooled = list(pool.map(lambda a, v: a.echo.remote(v), [x, x]))
    q = Queue()
    q.put(x)
    queued = q.get()
    q.shutdown()
    if any(p.data_ptr() != x.data_ptr() for p in pooled) or \
            queued.data_ptr() != x.data_ptr():
        raise RuntimeError("ActorPool or Queue copied the tensor")
    for r in ranks:
        rt.kill(r)
    out = {"part": "16c", "allreduce_bytes": want.numel() * 2,
           "allreduce_ms_host": allreduce_ms,
           "ranks_share_one_result": one_result,
           "checked": ["allreduce", "allgather", "broadcast",
                       "reducescatter", "send/recv", "ActorPool.map",
                       "Queue"], "card": smi}
    log(json.dumps(out))
    return out


def tune_path(dev, smi=None) -> dict:
    """Phase 16: tune and the utilities on a fresh ``init()`` (see the
    module's docstring). Alone: ``python -c "import chip_smoke, torch;
    chip_smoke.tune_path(torch.device('cuda'))"``."""
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.bench import run_train
    t0 = time.perf_counter()
    smi = smi or card_name()
    n_layers = TUNE_LAYERS
    # the trials' reference at their depth (phase 5 runs BENCH_LAYERS)
    ref = run_train(dev, batch=8, seq=2048, steps=1, warmup=1, seed=0,
                    config=bench_config(n_layers))
    log(f"phase 16's reference: run_train(bench_400m, {n_layers} layers, "
        f"1 + 1 steps): first loss {ref['loss_first']:.6f}, step "
        f"{ref['step_ms']:.2f} ms")
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    rt.init()
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")
        asha = tune_asha(dev, ref, base, n_layers, smi)
        trainer = tune_trainer(dev, ref, asha, tmp, n_layers, smi)
        util = tune_utilities(dev, smi)
        threads = actor_threads({"_TrialActor", "_TrainWorker",
                                 "_QueueActor", "_Coordinator", "Rank"})
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    freed, workspaces = wait_freed(base, "after shutdown()", threads=threads)
    out = {"part": "16", "launches": asha["flash_launches"]
           + trainer["flash_launches"], "bytes_after_shutdown": freed,
           "base_bytes": base, "cublas_workspaces_cleared": workspaces,
           "seconds": time.perf_counter() - t0, "card": smi}
    log(json.dumps(out))
    out.update(asha=asha, trainer=trainer, util=util)
    return out


# ---------------------------------------------------------------------------
# phase 17: the data layer and the device feed
# ---------------------------------------------------------------------------

# ImageNet's per-channel mean and std, on the 0-255 scale
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255


def token_dataset(rdata, vocab: int, rows: int = 64, blocks: int = 8):
    """Phase 17(a)'s dataset: ``rows`` x 2048 tokens from seed 0 (its first
    8 rows are ``bench_batch``'s), targets added by ``map_batches``, then
    ``blocks`` blocks in row order."""
    tokens = np.random.default_rng(0).integers(0, vocab, (rows, 2048))
    return rdata.from_numpy(tokens, "tokens").map_batches(
        lambda b: {"tokens": b["tokens"],
                   "targets": np.roll(b["tokens"], -1, axis=1)}
    ).repartition(blocks)


def data_train_loop(config: dict) -> None:
    """One rank of phase 17(a): the train step of ``config["cfg"]``
    (bench_400m on the card) on ``config["device"]``, fed by
    ``get_dataset_shard("train").to_jax(batch_size=8, prefetch=2)``, for
    ``config["steps"]`` AdamW steps, each reported with its loss and time;
    the first batch is held to ``bench_batch``'s rows."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import LlamaModel
    dev = torch.device(config["device"])
    cfg = config["cfg"]
    ts = train.make_train_step(LlamaModel(cfg, device=dev))
    params, opt = ts.init_fn(0)
    want = bench_batch(cfg)
    it = train.get_dataset_shard("train").to_jax(batch_size=8, prefetch=2,
                                                 device=dev)
    try:
        for step, b in enumerate(it):
            if step == config["steps"]:
                break
            batch = (b["tokens"], b["targets"])
            metrics = {"step": step, "device": b["tokens"].device.type}
            if step == 0:
                metrics["first_batch_is_bench_batch"] = all(
                    torch.equal(t.cpu(), torch.from_numpy(w))
                    for t, w in zip(batch, want))
            t0 = time.perf_counter()
            params, opt, m = ts.step_fn(params, opt, batch)
            metrics.update(loss=m["loss"].item(),
                           step_s=time.perf_counter() - t0)
            train.report(metrics)
    finally:
        it.close()


@timed("17/18/19(c) data_llama")
def data_llama(dev, phase5: dict, cfg, tmp: str, smi: str,
               part: str = "17(a)") -> dict:
    """Phase 17(a) (and 18(c)): ``JaxTrainer(datasets={"train":
    token_dataset})``, one worker holding the card, 6 steps of
    ``data_train_loop``: the flash kernel 2 x layers x 6 times, the first
    batch phase 5's, its loss phase 5's to every printed digit, the step
    median beside phase 5's."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as attn
    steps = 6
    attn.flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    result = train.JaxTrainer(
        data_train_loop,
        train_loop_config={"device": str(dev), "steps": steps, "cfg": cfg},
        scaling_config=train.ScalingConfig(use_gpu=dev.type == "cuda"),
        run_config=train.RunConfig(name="phase" + part.strip("()")
                                   .replace("(", ""), storage_path=tmp),
        datasets={"train": token_dataset(rdata, cfg.vocab_size)}).fit()
    fit_s = time.perf_counter() - t0
    launches = attn.flash_attention_kernel.launches
    if result.error is not None:
        raise RuntimeError(f"phase {part}: {result.error}")
    hist = [e["metrics"] for e in result.metrics_history]
    if [m["step"] for m in hist] != list(range(steps)):
        raise RuntimeError(f"phase {part} steps: {hist}")
    if not hist[0]["first_batch_is_bench_batch"]:
        raise RuntimeError(f"phase {part}: the first batch is not "
                           f"phase 5's")
    if {m["device"] for m in hist} != {dev.type}:
        raise RuntimeError(f"phase {part}: batches on {hist}")
    want = 2 * cfg.n_layers * steps if dev.type == "cuda" else 0
    if launches != want:
        raise RuntimeError(f"phase {part}: flash launches {launches} != "
                           f"{want}")
    losses = [m["loss"] for m in hist]
    if f"{losses[0]:.6f}" != f"{phase5['loss_first']:.6f}":
        raise RuntimeError(f"phase {part}: first loss {losses[0]!r} is "
                           f"not phase 5's {phase5['loss_first']!r}")
    step_ms = float(np.median([m["step_s"] for m in hist[1:]])) * 1e3
    log(f"phase {part}: JaxTrainer(datasets=...) over 64 x 2048 tokens in "
        f"8 "
        f"blocks (seed 0, targets by map_batches), to_jax(batch_size=8, "
        f"prefetch=2) into bench_400m's step, one worker holding the card, "
        f"{steps} AdamW steps: losses {losses}; first loss "
        f"{losses[0]:.6f} against phase 5's {phase5['loss_first']:.6f}; "
        f"step median {step_ms:.2f} ms (steps 1-5, host clock around each "
        f"step and its loss's .item()) beside phase 5's "
        f"{phase5['step_ms']:.2f} ms; fit {fit_s:.1f} s; flash launches "
        f"{launches} ({smi})")
    return {"losses": losses, "step_ms": step_ms, "fit_s": fit_s,
            "launches": launches}


def image_records(n: int, size: int, seed: int = 0) -> np.ndarray:
    """``n`` records of an HWC uint8 image, a label of 1,000 classes and
    the record's index, from ``seed``."""
    rng = np.random.default_rng(seed)
    rec = np.empty(n, dtype=[("image", np.uint8, (size, size, 3)),
                             ("label", np.int64), ("index", np.int64)])
    rec["image"] = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    rec["label"] = rng.integers(0, 1000, n)
    rec["index"] = np.arange(n)
    return rec


class Normalize:
    """The actor pool's preprocessing: records to f32 images normalised by
    ImageNet's mean and std, labels and indices."""

    def __call__(self, batch):
        rec = batch["record"]
        images = rec["image"].astype(np.float32)
        images -= IMAGENET_MEAN
        images /= IMAGENET_STD
        return {"image": images,
                "label": np.ascontiguousarray(rec["label"]),
                "index": np.ascontiguousarray(rec["index"])}


def store_used() -> int:
    """Bytes the nodes' stores hold: the Python tier and the arena."""
    from ray_tpu_torch._private import worker
    return sum(node.store.used_bytes() + node.store.native_used_bytes()
               for node in worker.global_runtime().alive_nodes())


def pinned_copy_ms(dev, nbytes: int, iters: int = 20) -> float:
    """Device time of one plain ``copy_`` of ``nbytes`` from pinned host
    memory to the card (CUDA events around ``iters`` copies)."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for _ in range(3):
        dst.copy_(src, non_blocking=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def busy_share(prof, wall_ms: float) -> tuple:
    """The union of the device's kernel and copy intervals in a profiled
    window over its wall time, and the window's host-to-device copies by
    kind."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    copies = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "HtoD" in e.name:
            copies[e.name] = copies.get(e.name, 0) + 1
    return busy / 1e3 / wall_ms, copies


def vit_pass(ts, params, opt, batches, dev, profile_at=None,
             part: str = "17(b)") -> dict:
    """Train steps over ``batches`` (dicts of ``image`` and ``label`` on
    the card): images/s from the second step to the end (one sync at each
    end), the losses, the last batch, and with ``profile_at`` the
    device-busy share and host-to-device copies of 3 steps from there under
    the CUDA profiler."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, out = [], {"busy": float("nan"), "copies": {},
                       "window_ms": float("nan")}
    for i, b in enumerate(batches):
        if i == 1:
            sync()
            t0 = time.perf_counter()
        if i == profile_at and dev.type == "cuda":
            sync()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            w0 = time.perf_counter()
        last = (b["image"], b["label"])
        params, opt, m = ts.step_fn(params, opt, last)
        losses.append(m["loss"])
        if profile_at is not None and i == profile_at + 2 and \
                dev.type == "cuda":
            sync()
            out["window_ms"] = (time.perf_counter() - w0) * 1e3
            prof.stop()
            out["busy"], out["copies"] = busy_share(prof, out["window_ms"])
    sync()
    steps = len(losses)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"phase {part}: losses {losses}")
    out.update(steps=steps, losses=losses, last=last,
               images_s=(steps - 1) * last[1].shape[0]
               / (time.perf_counter() - t0))
    return out


@timed("17/18(b) data_stream")
def data_stream(dev, tmp: str, smi: str, n: int = 2048, size: int = 224,
                batch: int = 32, vit_cfg=None, part: str = "17(b)") -> dict:
    """Phase 17(b): ``n`` records of ``size`` x ``size`` x 3 uint8 images
    written as 16 ``.npy`` shards, read back with ``read_numpy``,
    normalised by an actor pool (``Normalize``) and ``streaming_split(1)``;
    pass 1 streams them to the card alone (images/s, GB/s beside a plain
    pinned copy, the object store's peak), pass 2 into ViT-L/16's train
    step (images/s beside the bare step on a resident batch and beside the
    same steps fed from the normalised blocks held in the store, the
    device-busy share of one profiled window)."""
    import os
    import torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.models import ViTModel
    from ray_tpu_torch.train import make_train_step
    vit_cfg = vit_cfg or vit_config()
    t0 = time.perf_counter()
    rec = image_records(n, size)
    path = os.path.join(tmp, "images")
    rdata.from_numpy(rec, "record").repartition(16).write_numpy(path,
                                                                 "record")
    write_s = time.perf_counter() - t0
    shards = sorted(os.listdir(path))
    if len(shards) != 16:
        raise RuntimeError(f"phase {part}: {len(shards)} shards written")
    mib = rec.nbytes / 2**20
    del rec
    ds = rdata.read_numpy(path, column="record").map_batches(
        Normalize, concurrency=(2, 4))
    shard = ds.streaming_split(1)[0]
    want = image_records(n, size)    # the expected values, by index

    def expect(index):
        images = want["image"][index].astype(np.float32)
        images -= IMAGENET_MEAN
        images /= IMAGENET_STD
        return images, want["label"][index]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # pass 1: the data alone
    seen, peak, labels = 0, 0, 0
    t0 = time.perf_counter()
    for i, b in enumerate(shard.to_jax(batch_size=batch, prefetch=2,
                                       device=dev)):
        if i == 0:
            images, lab = expect(b["index"].cpu().numpy())
            if not (torch.equal(b["image"].cpu(), torch.from_numpy(images))
                    and torch.equal(b["label"].cpu(),
                                    torch.from_numpy(lab))):
                raise RuntimeError(f"phase {part}: a batch on the card "
                                   f"is not its records' normalised "
                                   f"values")
        seen += b["label"].shape[0]
        labels += int(b["label"].sum())
        peak = max(peak, store_used())
    sync()
    pass1_s = time.perf_counter() - t0
    if seen != n or labels != int(want["label"].sum()):
        raise RuntimeError(f"phase {part}: {seen} images, label sum "
                           f"{labels} (want {n}, {want['label'].sum()})")
    batch_bytes = batch * (size * size * 3 * 4 + 8 + 8)
    fed_gbs = n / batch * batch_bytes / pass1_s / 1e9
    copy_ms = pinned_copy_ms(dev, batch_bytes) if dev.type == "cuda" \
        else float("nan")
    link_gbs = batch_bytes / copy_ms / 1e6
    log(f"phase {part} pass 1: {n} images ({mib:.1f} MiB of uint8 records "
        f"in 16 .npy shards, written in {write_s:.1f} s) read, normalised "
        f"by an actor pool and fed to {dev} in batches of {batch}: "
        f"{n / pass1_s:.1f} images/s, {fed_gbs:.2f} GB/s onto the card "
        f"beside {link_gbs:.2f} GB/s of a plain pinned copy_ of one batch's "
        f"{batch_bytes / 1e6:.2f} MB ({copy_ms:.3f} ms); the object store's "
        f"peak {peak / 2**20:.1f} MiB of its "
        f"{store_capacity() / 2**20:.0f} MiB ({smi})")

    # pass 2: into ViT-L/16's train step; then the same steps on one
    # resident batch, and fed from the normalised blocks held in the store
    model = ViTModel(vit_cfg, device=dev)
    ts = make_train_step(model)
    params, opt = ts.init_fn(0)
    streamed = vit_pass(ts, params, opt, shard.to_jax(
        batch_size=batch, prefetch=2, device=dev), dev,
        profile_at=min(30, n // batch - 4), part=part)
    if streamed["steps"] != n // batch:
        raise RuntimeError(f"phase {part}: {streamed['steps']} steps")
    resident = streamed.pop("last")
    sync()
    t1 = time.perf_counter()
    for _ in range(20):
        ts.step_fn(params, opt, resident)
    sync()
    bare_ms = (time.perf_counter() - t1) / 20 * 1e3
    held = ds.materialize()
    from_store = vit_pass(ts, params, opt, held.streaming_split(1)[0].to_jax(
        batch_size=batch, prefetch=2, device=dev), dev, part=part)
    from_store.pop("last")
    del held
    losses = streamed["losses"]
    log(f"phase {part} pass 2: the same stream into ViT-L/16's train step "
        f"at {vit_cfg.n_layers} of its 24 layers ({streamed['steps']} "
        f"steps of {batch} images, AdamW, bf16 with remat): "
        f"{streamed['images_s']:.1f} images/s from step 1 (one sync at each "
        f"end), beside {batch / bare_ms * 1e3:.1f} images/s "
        f"of the bare step on one resident batch ({bare_ms:.2f} ms, 20 "
        f"steps back to back) and {from_store['images_s']:.1f} images/s fed "
        f"from the normalised blocks held in the store (no reading or "
        f"normalising beside the steps); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; device busy {streamed['busy'] * 100:.1f} % of a "
        f"window of 3 streamed steps under the CUDA profiler "
        f"({streamed['window_ms']:.1f} ms); its host-to-device copies "
        f"{streamed['copies']} ({smi})")
    del model, ts, params, opt, resident
    free_card()
    return {"pass1_images_s": n / pass1_s, "fed_gbs": fed_gbs,
            "link_gbs": link_gbs, "store_peak": peak,
            "streamed_images_s": streamed["images_s"],
            "from_store_images_s": from_store["images_s"],
            "bare_step_ms": bare_ms, "busy": streamed["busy"],
            "copies": streamed["copies"]}


def store_capacity() -> int:
    from ray_tpu_torch._private import worker
    return sum(node.store.capacity_bytes
               for node in worker.global_runtime().alive_nodes())


def data_formats(dev, tmp: str) -> dict:
    """Phase 17(c): a TFRecord and an Avro round trip of a small table (the
    stdlib codecs, on the card's machine), ``iter_torch_batches`` onto the
    card, and the feed's own contract: pinned staging, the copy on a side
    stream, the consumer's stream waiting for it."""
    import os
    import torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.iterator import _CudaFeed
    rows = [{"name": f"r{i}", "score": i * 0.5, "labels": [i, i * 2]}
            for i in range(12)]
    tfr = os.path.join(tmp, "tfr")
    rdata.from_items(rows).write_tfrecords(tfr)
    back = {r["name"][0]: r for r in rdata.read_tfrecords(tfr).take_all()}
    if set(back) != {f"r{i}".encode() for i in range(12)} or \
            back[b"r3"] != {"name": [b"r3"], "score": [1.5],
                            "labels": [3, 6]}:
        raise RuntimeError(f"phase 17(c): TFRecord round trip gave {back}")
    avro = os.path.join(tmp, "avro")
    flat = [{"name": r["name"], "score": r["score"], "raw": bytes([i])}
            for i, r in enumerate(rows)]
    rdata.from_items(flat).write_avro(avro)
    got = sorted(rdata.read_avro(avro).take_all(), key=lambda r: r["name"])
    if got != sorted(flat, key=lambda r: r["name"]):
        raise RuntimeError(f"phase 17(c): Avro round trip gave {got}")
    batches = list(rdata.range(64, parallelism=4).iter_torch_batches(
        batch_size=16, device=str(dev)))
    if {b["id"].device.type for b in batches} != {dev.type} or \
            sorted(int(x) for b in batches for x in b["id"]) != \
            list(range(64)):
        raise RuntimeError("phase 17(c): iter_torch_batches off the card")
    checked = {}
    if dev.type == "cuda":
        feed = _CudaFeed(dev, 2)
        batch = {"x": np.arange(4096, dtype=np.float32).reshape(64, 64)}
        slot, staged = feed.stage(batch, {})
        out, done = feed.launch(slot, staged, {"x": torch.bfloat16}, None)
        out = feed.hand_over(out, done)
        checked = {"pinned": staged["x"].is_pinned(),
                   "side_stream": feed.stream != torch.cuda.current_stream(),
                   "equal": torch.equal(out["x"], torch.from_numpy(
                       batch["x"]).to(dev, torch.bfloat16))}
        if not all(checked.values()):
            raise RuntimeError(f"phase 17(c): the feed {checked}")
    log(f"phase 17(c): TFRecord and Avro round trips of 12 rows, "
        f"iter_torch_batches onto {dev} ({len(batches)} batches), the "
        f"feed's staging and side-stream copy: {checked}")
    return checked


def data_threads():
    """The data layer's threads still alive: prefetch threads, shuffle
    reapers, and the executors of its map-pool, shuffle and train-worker
    actors."""
    actors = actor_threads({"_MapWorker", "ShuffleAggregator",
                            "_TrainWorker"})
    return lambda: actors() + [
        t for t in threading.enumerate() if t.is_alive() and t.name in (
            "data-prefetch", "shuffle-aggregator-reaper")]


def data_path(dev, phase5=None, smi=None) -> dict:
    """Phase 17: the data layer and the device feed on a fresh ``init()``
    (see the module's docstring). Alone (it first runs phase 5 for its
    loss and step time): ``python -c "import chip_smoke, torch;
    chip_smoke.data_path(torch.device('cuda'))"``."""
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    smi = smi or card_name()
    cfg = bench_config()
    if phase5 is None:
        phase5 = train_path(dev, cfg.n_layers)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rt.init(_system_config=IN_THREADS)
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")
        llama = data_llama(dev, phase5, cfg, tmp, smi)
        free_card()
        stream = data_stream(dev, tmp, smi)
        formats = data_formats(dev, tmp)
        threads = data_threads()
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    freed, workspaces = wait_freed(base, "after shutdown()", threads=threads)
    out = {"part": "17", "launches": llama["launches"],
           "bytes_after_shutdown": freed, "base_bytes": base,
           "cublas_workspaces_cleared": workspaces,
           "seconds": time.perf_counter() - t0, "card": smi}
    log(json.dumps(out))
    out.update(llama=llama, stream=stream, formats=formats)
    return out



def noop(in_threads: bool = False):
    """A remote function that returns the pid it ran in."""
    import os
    import ray_tpu_torch as rt

    def pid():
        return os.getpid()
    return rt.remote(_in_process=True)(pid) if in_threads \
        else rt.remote(pid)


def noop_rate(fn, n: int = 1000) -> tuple:
    """``n`` calls of the no-op ``fn`` in flight at once, after 100 to warm
    up: (tasks/s, the pids that ran them)."""
    import ray_tpu_torch as rt
    rt.get([fn.remote() for _ in range(100)])
    t0 = time.perf_counter()
    pids = set(rt.get([fn.remote() for _ in range(n)]))
    return n / (time.perf_counter() - t0), pids


def probe_workers(pids: set, part: str) -> None:
    """Every worker process of ``pids`` sees no card: probe tasks until each
    has answered."""
    import os
    import ray_tpu_torch as rt

    @rt.remote
    def probe():
        import torch
        return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
                torch.cuda.is_available())

    probed = {}
    deadline = time.monotonic() + 120
    while not pids <= set(probed) and time.monotonic() < deadline:
        for pid, visible, cuda in rt.get([probe.remote()
                                          for _ in range(4 * len(pids))]):
            probed[pid] = (visible, cuda)
    if not pids <= set(probed) or any(v != ("", False)
                                      for v in probed.values()):
        raise RuntimeError(f"phase {part}: workers {sorted(pids)} probed "
                           f"as {probed}")


@timed("18(a) classic_rate")
def classic_rate() -> tuple:
    """Phase 18(a)'s classic-pipe reference: 1,000 no-op tasks on a fresh
    ``init()`` with the fast lane off, none in the driver; (tasks/s, worker
    processes)."""
    import os
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    rt.init(_system_config={"fast_lane": False})
    try:
        rate, pids = noop_rate(noop())
        lane = worker.global_runtime().process_router.fast_stats()
    finally:
        rt.shutdown()
    if os.getpid() in pids or lane:
        raise RuntimeError(f"phase 18(a): with the lane off no-op tasks ran "
                           f"in {pids} (the driver is {os.getpid()}), the "
                           f"lane's stats {lane}")
    return rate, len(pids)


@timed("18(a) process_checks")
def process_checks(smi: str, tmp: str, classic: tuple) -> dict:
    """Phase 18(a): 1,000 no-op tasks in worker processes (none in the
    driver, the card hidden in every one), their rate beside the same tasks
    through the pipe with the lane off (``classic``) and on the driver's
    threads; a SIGKILLed process actor restarts; a task whose worker is
    SIGKILLed gives its retried result."""
    import os
    import signal
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker_process as wp

    driver = os.getpid()
    proc_rate, pids = noop_rate(noop())
    thread_rate, thread_pids = noop_rate(noop(in_threads=True))
    if driver in pids or thread_pids != {driver}:
        raise RuntimeError(f"phase 18(a): no-op tasks ran in {pids} (the "
                           f"driver is {driver}); in-thread ones in "
                           f"{thread_pids}")
    probe_workers(pids, "18(a)")
    card = card_plane_checks(driver)

    @rt.remote(max_restarts=1)
    class Holder:
        def pid(self):
            return os.getpid()

    actor = Holder.remote()
    pid1 = rt.get(actor.pid.remote())
    os.kill(pid1, signal.SIGKILL)
    pid2, t0 = None, time.monotonic()
    while pid2 is None and time.monotonic() - t0 < 60:
        try:
            pid2 = rt.get(actor.pid.remote(), timeout=20)
        except Exception:
            time.sleep(0.1)
    restart_s = time.monotonic() - t0
    if pid2 is None or pid2 in (pid1, driver):
        raise RuntimeError(f"phase 18(a): the actor's process {pid1} was "
                           f"killed and it answered from {pid2}")
    rt.kill(actor)

    marker = os.path.join(tmp, "attempt")

    @rt.remote(max_retries=2)
    def slow():
        n = len([f for f in os.listdir(tmp) if f.startswith("attempt")])
        with open(f"{marker}.{n}", "w") as f:
            f.write(str(os.getpid()))
        if n == 0:
            time.sleep(60)      # the first attempt is killed
        return os.getpid(), n

    ref = slow.remote()
    first = None
    deadline = time.monotonic() + 30
    while first is None and time.monotonic() < deadline:
        try:
            with open(f"{marker}.0") as f:
                first = int(f.read().strip() or 0) or None
        except FileNotFoundError:
            time.sleep(0.02)
    if first is None:
        rt.get(ref, timeout=1)          # raises the task's own error
        raise RuntimeError("phase 18(a): the slow task never started")
    os.kill(first, signal.SIGKILL)
    retried_pid, attempt = rt.get(ref, timeout=60)
    if retried_pid in (first, driver) or attempt != 1:
        raise RuntimeError(f"phase 18(a): the killed task gave "
                           f"{(retried_pid, attempt)}")
    log(f"phase 18(a): 1,000 no-op tasks in {len(pids)} worker processes "
        f"(none in the driver; CUDA_VISIBLE_DEVICES='' and "
        f"torch.cuda.is_available() False in each): {proc_rate:.0f} "
        f"tasks/s (the default: plain tasks on the fast lane), beside "
        f"{classic[0]:.0f} tasks/s through the pipe with the lane off "
        f"({classic[1]} workers) and {thread_rate:.0f} tasks/s on the "
        f"driver's threads in the same runtime; a SIGKILLed process actor "
        f"answered again "
        f"from pid {pid2} after {restart_s:.2f} s; a task whose worker was "
        f"SIGKILLed gave its retry's result (attempt {attempt}, pid "
        f"{retried_pid}); {card}; {len(wp.live_workers())} workers live "
        f"({smi})")
    return {"tasks_per_s": proc_rate, "thread_tasks_per_s": thread_rate,
            "classic_tasks_per_s": classic[0], "workers": len(pids),
            "actor_restart_s": restart_s}


def card_plane_checks(driver: int) -> str:
    """Phase 18(a), the accelerator plane as the wire reads it: a module on
    the card as an argument, a closure over a CUDA tensor and an actor
    given a factory closing over the card's device run in the driver and
    give CUDA tensors equal to the caller's; a process actor's method
    refuses a CUDA tensor rather than copy it."""
    import os
    import torch
    import ray_tpu_torch as rt
    gen = torch.Generator(device="cuda").manual_seed(18)
    lin = torch.nn.Linear(256, 256, device="cuda")
    x = torch.randn(8, 256, generator=gen, device="cuda")

    @rt.remote
    def apply(m, v):
        return os.getpid(), m(v)

    def scaled_by(t):
        def scaled():
            return os.getpid(), t * 2
        return scaled

    @rt.remote
    class Runner:
        def __init__(self, factory):
            self.device = factory()

        def zeros(self):
            return os.getpid(), torch.zeros(1, device=self.device)

        def device_of(self, t):
            return str(t.device)

    card, host = torch.device("cuda"), torch.device("cpu")
    on_card = Runner.remote(lambda: card)   # RL's policy-factory shape
    on_host = Runner.remote(lambda: host)
    got = [rt.get(apply.remote(lin, x)),
           rt.get(rt.remote(scaled_by(x)).remote()),
           rt.get(on_card.zeros.remote())]
    with torch.no_grad():
        want = [lin(x), x * 2, torch.zeros(1, device="cuda")]
    host_pid = rt.get(on_host.zeros.remote())[0]
    try:
        rt.get(on_host.device_of.remote(x))
        refused = ""
    except Exception as e:   # noqa: BLE001 - the refusal is the check
        refused = str(e)
    for h in (on_card, on_host):
        rt.kill(h)
    bad = [(i, pid, out.device) for i, ((pid, out), w) in
           enumerate(zip(got, want))
           if pid != driver or not out.is_cuda or not torch.equal(out, w)]
    if bad or host_pid == driver or \
            "num_gpus or _in_process" not in refused:
        raise RuntimeError(f"phase 18(a): card-plane work {bad} (driver "
                           f"{driver}); the host actor in {host_pid}; its "
                           f"refusal {refused!r}")
    return ("a module on the card, a closure over a CUDA tensor and an "
            "actor given the card's device ran in the driver and gave "
            "CUDA tensors equal to the caller's; a process actor refused "
            "a CUDA argument")


@timed("18(d) wire_checks")
def wire_checks(dev, tmp: str, smi: str, mib: int = 256) -> dict:
    """Phase 18(d): a ``mib`` MiB bf16 tensor on ``dev`` (the card) and a
    one-rank DTensor through ``wire_dumps``/``wire_loads``: back on
    ``dev``, bit-equal, in the driver; CPU tensors (the DTensor a plain
    one), bit-equal, in a worker process."""
    import hashlib
    import os
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.device_objects import wire_dumps, wire_loads

    def digest(t):
        return hashlib.sha256(t.detach().cpu().contiguous().view(
            torch.uint8).numpy().tobytes()).hexdigest()

    @rt.remote
    def in_worker(blob):
        import hashlib as _hl
        import torch as _torch
        from ray_tpu_torch._private.device_objects import wire_loads as _wl
        out = []
        for t in _wl(blob):
            out.append((type(t).__name__, t.device.type, str(t.dtype),
                        tuple(t.shape), _hl.sha256(
                            t.contiguous().view(_torch.uint8).numpy()
                            .tobytes()).hexdigest()))
        return out, os.getpid()

    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method="file://" + os.path.join(tmp, "pg"),
            world_size=1, rank=0)
    try:
        gen = torch.Generator(device=dev).manual_seed(18)
        big = torch.randn(mib << 19, generator=gen, device=dev,
                          dtype=torch.float32).to(torch.bfloat16)
        mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("dp",))
        dt = distribute_tensor(torch.randn(64, 32, generator=gen,
                                           device=dev), mesh, [Shard(0)],
                               src_data_rank=None)
        t0 = time.perf_counter()
        blob = wire_dumps([big, dt])
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back_big, back_dt = wire_loads(blob)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        ok_driver = (back_big.device.type == dev.type
                     and back_big.dtype == torch.bfloat16
                     and torch.equal(back_big.view(torch.int16),
                                     big.view(torch.int16))
                     and isinstance(back_dt, DTensor)
                     and back_dt.device_mesh.mesh_dim_names == ("dp",)
                     and list(back_dt.placements) == [Shard(0)]
                     and back_dt.to_local().device.type == dev.type
                     and torch.equal(back_dt.full_tensor(),
                                     dt.full_tensor()))
        want = [("Tensor", "cpu", "torch.bfloat16", tuple(big.shape),
                 digest(big)),
                ("Tensor", "cpu", "torch.float32", tuple(dt.shape),
                 digest(dt.full_tensor()))]
        t0 = time.perf_counter()
        got, pid = rt.get(in_worker.remote(blob), timeout=300)
        worker_s = time.perf_counter() - t0
        if not ok_driver or got != want or pid == os.getpid():
            raise RuntimeError(f"phase 18(d): driver round trip "
                               f"{ok_driver}; in worker {pid}: {got} "
                               f"(want {want})")
        blob_mib = len(blob) / 2**20
        del big, dt, back_big, back_dt, blob
    finally:
        from ray_tpu_torch._private import device_objects
        device_objects._MESHES.clear()
        if own_group:
            dist.destroy_process_group()
    log(f"phase 18(d): a {mib} MiB bf16 tensor on {dev} and a one-rank "
        f"DTensor (Shard(0) on a ('dp',) mesh) through wire_dumps "
        f"({blob_mib:.1f} MiB, {dump_s:.2f} s) and wire_loads "
        f"({load_s:.2f} s): back on {dev} bit-equal, the DTensor on an "
        f"equivalent mesh; in a worker "
        f"process CPU tensors (the DTensor a plain one), bit-equal by "
        f"sha256 ({worker_s:.2f} s with the pipe) ({smi})")
    return {"blob_mib": blob_mib, "dump_s": dump_s, "load_s": load_s,
            "worker_s": worker_s}


def process_path(dev, phase5=None, phase12=None, phase17=None,
                 smi=None) -> dict:
    """Phase 18: the runtime's default path, process workers, on a fresh
    ``init()`` (see the module's docstring). Alone (it runs phase 5 first):
    ``python -c "import chip_smoke, torch;
    chip_smoke.process_path(torch.device('cuda'))"``."""
    import os
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private import worker_process as wp
    t0 = time.perf_counter()
    smi = smi or card_name()
    cfg = bench_config()
    if phase5 is None:
        phase5 = train_path(dev, cfg.n_layers)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_process_")
    for part in "abcd":
        os.makedirs(os.path.join(tmp, part))
    classic = classic_rate()
    rt.init()
    pids = set()
    try:
        if not worker.global_runtime().process_router.enabled:
            raise RuntimeError("phase 18: process workers are off")
        checks = process_checks(smi, os.path.join(tmp, "a"), classic)
        before = wp.calls_sent()
        stream = data_stream(dev, os.path.join(tmp, "b"), smi, part="18(b)")
        llama = data_llama(dev, phase5, cfg, os.path.join(tmp, "c"), smi,
                           part="18(c)")
        worker_calls = wp.calls_sent() - before
        if llama["losses"][0] != phase5["loss_first"]:
            raise RuntimeError(f"phase 18(c): first loss "
                               f"{llama['losses'][0]!r} is not phase 5's "
                               f"{phase5['loss_first']!r} exactly")
        if worker_calls <= 0:
            raise RuntimeError("phase 18(b, c): no data task ran in a "
                               "worker process")
        free_card()
        wire = wire_checks(dev, os.path.join(tmp, "d"), smi)
        threads = data_threads()
        pids = {w.pid for w in wp.live_workers()}
        template = wp.forkserver_pid()
    finally:
        rt.shutdown()
        wp.stop_worker_plane()
        shutil.rmtree(tmp, ignore_errors=True)
    left = [p for p in pids | {template} if _alive(p)]
    if wp.live_workers() or wp.forkserver_pid() is not None or left:
        raise RuntimeError(f"phase 18(e): processes {left} and "
                           f"{len(wp.live_workers())} workers left")
    freed, workspaces = wait_freed(base, "phase 18 after shutdown()",
                                   threads=threads)
    if freed > base:
        raise RuntimeError(f"phase 18(e): {freed - base} bytes above the "
                           f"base after shutdown()")
    p12 = (phase12 or {}).get("rates", {})
    p17 = (phase17 or {}).get("stream", {})
    log(f"phase 18: through processes {checks['tasks_per_s']:.0f} no-op "
        f"tasks/s (phase 12's {p12.get('tasks_per_s', float('nan')):.0f}, "
        f"on threads {checks['thread_tasks_per_s']:.0f}); images/s alone "
        f"{stream['pass1_images_s']:.1f} (phase 17's in-thread "
        f"{p17.get('pass1_images_s', float('nan')):.1f}), into ViT-L/16's "
        f"step {stream['streamed_images_s']:.1f} (phase 17's "
        f"{p17.get('streamed_images_s', float('nan')):.1f}; the bare step "
        f"{32 / stream['bare_step_ms'] * 1e3:.1f}); {worker_calls} calls "
        f"of the data's tasks and actors in worker processes; after "
        f"shutdown() and stop_worker_plane() no worker ({len(pids)} were "
        f"live) and no forkserver left, {freed - base} bytes above the "
        f"base ({smi})")
    out = {"part": "18", "launches": llama["launches"],
           "bytes_after_shutdown": freed, "base_bytes": base,
           "cublas_workspaces_cleared": workspaces,
           "seconds": time.perf_counter() - t0, "card": smi}
    log(json.dumps(out))
    out.update(checks=checks, stream=stream, llama=llama, wire=wire)
    return out


# ---------------------------------------------------------------------------
# phase 19: the native host tier (the fast lane and the shared-memory store)
# ---------------------------------------------------------------------------

ATTN_SHAPES = {"q": (8, 2048, 8, 128), "k": (8, 2048, 4, 128),
               "v": (8, 2048, 4, 128)}     # bench_400m's attention, f32


@timed("19(a) lane_checks")
def lane_checks(tmp: str, smi: str, classic: float) -> dict:
    """Phase 19(a): 1,000 no-op tasks counted by the lane's core, none in
    the driver, every lane worker without the card; tasks/s beside the pipe
    with the lane off (``classic``, phase 18(a)) and the driver's threads;
    a running lane task cancelled soft and forced; a lane worker SIGKILLed
    mid-task, its task's retry giving the result."""
    import os
    import signal
    import ray_tpu_torch as rt
    from ray_tpu_torch import exceptions as exc
    from ray_tpu_torch._private import worker
    router = worker.global_runtime().process_router
    driver = os.getpid()
    fn = noop()
    rt.get([fn.remote() for _ in range(100)])           # starts the lane
    before = router.fast_stats().get("submitted", 0)
    rate, pids = noop_rate(fn)
    through = router.fast_stats().get("submitted", 0) - before
    lane_pids = {w.pid for w in router._fast_workers}
    if through < 1000 or driver in pids or not pids <= lane_pids:
        raise RuntimeError(f"phase 19(a): the core counted {through} of "
                           f"1,100 no-op tasks; they ran in {pids}, the "
                           f"lane's workers are {lane_pids} (the driver "
                           f"{driver})")
    probe_workers(lane_pids, "19(a)")
    thread_rate, _ = noop_rate(noop(in_threads=True))

    @rt.remote(max_retries=0)
    def spin(path):
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        while True:
            time.sleep(0.01)

    def started(path):
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    text = f.read().strip()
                if text:
                    return int(text)
            except FileNotFoundError:
                pass
            time.sleep(0.01)
        raise RuntimeError(f"phase 19(a): {path} never started")

    cancels = {}
    before = router.fast_stats()["submitted"]
    for force in (False, True):
        path = os.path.join(tmp, f"spin{int(force)}")
        ref = spin.remote(path)
        pid = started(path)
        t0 = time.perf_counter()
        rt.cancel(ref, force=force)
        try:
            rt.get(ref, timeout=30)
            got = "a result"
        except exc.TaskCancelledError:
            got = "cancelled"
        except Exception as e:  # noqa: BLE001 - the error is the report
            got = repr(e)
        cancels[force] = (got, time.perf_counter() - t0, pid)
        if got != "cancelled":
            raise RuntimeError(f"phase 19(a): a cancel (force={force}) of "
                               f"a running lane task gave {got}")
    if not _alive(cancels[False][2]) or \
            router.fast_stats()["submitted"] - before != 2:
        raise RuntimeError(f"phase 19(a): cancels {cancels}, lane stats "
                           f"{router.fast_stats()}")
    marker = os.path.join(tmp, "attempt")

    @rt.remote(max_retries=2)
    def slow():
        n = len([f for f in os.listdir(tmp) if f.startswith("attempt")])
        with open(f"{marker}.{n}", "w") as f:
            f.write(str(os.getpid()))
        if n == 0:
            time.sleep(60)      # the first attempt is killed
        return os.getpid(), n

    before = router.fast_stats()["submitted"]
    ref = slow.remote()
    first = started(f"{marker}.0")
    t0 = time.perf_counter()
    os.kill(first, signal.SIGKILL)
    retried_pid, attempt = rt.get(ref, timeout=60)
    retry_s = time.perf_counter() - t0
    if retried_pid in (first, driver) or attempt != 1 or \
            router.fast_stats()["submitted"] - before != 2:
        raise RuntimeError(f"phase 19(a): the killed lane task gave "
                           f"{(retried_pid, attempt)}, lane stats "
                           f"{router.fast_stats()}")
    log(f"phase 19(a): the lane's core counted {through} tasks for 1,000 "
        f"no-op tasks and their 100 to warm up, run in {len(pids)} lane "
        f"workers (none in the driver; "
        f"CUDA_VISIBLE_DEVICES='' and torch.cuda.is_available() False in "
        f"each of {len(lane_pids)}): {rate:.0f} tasks/s, beside {classic:.0f}"
        f" through the pipe with the lane off (18(a)) and {thread_rate:.0f} "
        f"on the driver's threads; a running lane task cancelled soft in "
        f"{cancels[False][1] * 1e3:.1f} ms (its worker lives on), forced in "
        f"{cancels[True][1] * 1e3:.1f} ms (its worker exits); a lane worker "
        f"SIGKILLed mid-task: the retry (attempt {attempt}, pid "
        f"{retried_pid}) answered in {retry_s:.2f} s ({smi})")
    return {"tasks_per_s": rate, "classic_tasks_per_s": classic,
            "thread_tasks_per_s": thread_rate, "lane_workers": len(lane_pids),
            "cancel_soft_ms": cancels[False][1] * 1e3,
            "cancel_forced_ms": cancels[True][1] * 1e3,
            "kill_retry_s": retry_s, "lane_pids": lane_pids}


def shm_mount() -> tuple:
    """(size, free) bytes of the /dev/shm mount."""
    import os
    st = os.statvfs("/dev/shm")
    return st.f_blocks * st.f_frsize, st.f_bavail * st.f_frsize


@timed("19(b) store_flash")
def store_flash(dev, smi: str) -> dict:
    """Phase 19(b): lane tasks return q, k and v as f32 numpy arrays at
    bench_400m's attention shapes; the node's store takes each into its
    arena and ``get`` hands out read-only views over it; the views go to
    the card as bf16 through ``flash_fwd_wgmma``, held to the plain version
    at ``BF16_TOL``. Its one launch is counted."""
    import ctypes
    import os
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.ops import attention as attn
    runtime = worker.global_runtime()
    router = runtime.process_router
    (node,) = runtime.alive_nodes()
    store = node.store

    @rt.remote
    def make(shape, seed):
        return np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)

    before = (store.stats["native_puts"],
              router.fast_stats().get("submitted", 0))
    t0 = time.perf_counter()
    refs = {n: make.remote(shape, i)
            for i, (n, shape) in enumerate(ATTN_SHAPES.items())}
    views = dict(zip(refs, rt.get(list(refs.values()))))
    lane_s = time.perf_counter() - t0
    puts = store.stats["native_puts"] - before[0]
    through = router.fast_stats()["submitted"] - before[1]
    arena = store._native
    lo = ctypes.addressof(arena._buf)
    hi = lo + arena.capacity()
    in_arena = {n: lo <= v.__array_interface__["data"][0] < hi
                for n, v in views.items()}
    if puts != 3 or through != 3 or not all(in_arena.values()) or any(
            v.flags.writeable for v in views.values()):
        raise RuntimeError(f"phase 19(b): native puts {puts}, lane tasks "
                           f"{through}, views in the arena {in_arena}")
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        if not np.array_equal(views[n], np.random.default_rng(i)
                              .standard_normal(shape, dtype=np.float32)):
            raise RuntimeError(f"phase 19(b): {n} is not its seed's values")
    nbytes = sum(v.nbytes for v in views.values())
    nbytes_q = views["q"].nbytes
    # the store's own cost on q's array: put (one copy into the arena) and
    # get (a counted view); then a put into the range just freed, whose
    # pages the mount has backed and this process has mapped already
    put_ms = []
    for _ in range(2):
        probe_id = ObjectID.from_random()
        t0 = time.perf_counter()
        store.put(probe_id, views["q"])
        put_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        again = store.get(probe_id)
        get_ms = (time.perf_counter() - t0) * 1e3
        del again
        gc.collect()
        store.delete(probe_id)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        t0 = time.perf_counter()
        q, k, v = (torch.from_numpy(views[n]).to(dev).to(torch.bfloat16)
                   for n in ATTN_SHAPES)
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) * 1e3
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    err = (out.float() - plain.float()).abs().max().item()
    ratio = tol_ratio(out, plain)
    if launches != 1 or not torch.isfinite(out).all():
        raise RuntimeError(f"phase 19(b): flash launches {launches}")
    del q, k, v, out, plain, views
    gc.collect()
    size, free = shm_mount()
    log(f"phase 19(b): 3 lane tasks returned q {ATTN_SHAPES['q']}, k and v "
        f"{ATTN_SHAPES['k']} as f32 ({nbytes / 2**20:.0f} MiB) in "
        f"{lane_s:.2f} s; the node's store took all three into its arena "
        f"(native_puts +{puts}) and get gave read-only views over it, equal "
        f"to their seeds' values; the store's put of the "
        f"{nbytes_q / 2**20:.0f} MiB q {put_ms[0]:.2f} ms into fresh "
        f"pages, {put_ms[1]:.2f} ms into pages it had backed, its get "
        f"{get_ms:.3f} ms; to the card as bf16 "
        f"{copy_ms:.1f} ms; flash_fwd_wgmma on them, 1 launch, against the "
        f"plain version max_abs_err {err:.3e} ({ratio:.2f}x the tolerance "
        f"{BF16_TOL}); /dev/shm {size / 2**30:.1f} GiB ({free / 2**30:.1f} "
        f"GiB free), the arena {arena.capacity() / 2**30:.2f} GiB ({smi})")
    return {"launches": launches, "max_abs_err": err, "put_ms": put_ms[0],
            "warm_put_ms": put_ms[1], "get_ms": get_ms, "copy_ms": copy_ms, "lane_s": lane_s,
            "shm_bytes": size, "arena_bytes": arena.capacity()}


def native_path(dev, phase5=None, phase18=None, smi=None) -> dict:
    """Phase 19: the native host tier of the runtime on a fresh ``init()``
    (see the module's docstring). Alone (it runs phase 5 first):
    ``python -c "import chip_smoke, torch;
    chip_smoke.native_path(torch.device('cuda'))"``."""
    import glob
    import os
    import shutil
    import socket
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private import worker_process as wp
    t0 = time.perf_counter()
    smi = smi or card_name()
    cfg = bench_config()
    if phase5 is None:
        phase5 = train_path(dev, cfg.n_layers)
    classic = (phase18 or {}).get("checks", {}).get("classic_tasks_per_s")
    if classic is None:
        classic = classic_rate()[0]
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    for part in "ac":
        os.makedirs(os.path.join(tmp, part))
    def segments():
        return glob.glob(f"/dev/shm/rtpt_{os.getpid()}_*")

    rt.init()
    pids, port = set(), None
    try:
        router = worker.global_runtime().process_router
        if not segments():
            raise RuntimeError("phase 19: the node's store has no arena")
        lane = lane_checks(os.path.join(tmp, "a"), smi, classic)
        port = router._fast_core.port
        flash = store_flash(dev, smi)
        before = router.fast_stats()["submitted"]
        free_card()
        llama = data_llama(dev, phase5, cfg, os.path.join(tmp, "c"), smi,
                           part="19(c)")
        data_tasks = router.fast_stats()["submitted"] - before
        if llama["losses"][0] != phase5["loss_first"] or data_tasks <= 0:
            raise RuntimeError(f"phase 19(c): first loss "
                               f"{llama['losses'][0]!r} (phase 5's "
                               f"{phase5['loss_first']!r}); {data_tasks} "
                               f"data tasks on the lane")
        threads = data_threads()
        pids = {w.pid for w in wp.live_workers()} | lane["lane_pids"]
    finally:
        rt.shutdown()
        wp.stop_worker_plane()
        shutil.rmtree(tmp, ignore_errors=True)
    left = [p for p in pids if _alive(p)]
    listening = False
    if port is not None:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            listening = True
        except OSError:
            pass
    if left or listening or segments() or wp.live_workers():
        raise RuntimeError(f"phase 19(d): processes {left} left, the core's "
                           f"port {port} listening {listening}, segments "
                           f"{segments()}")
    freed, _ = wait_freed(base, "phase 19 after shutdown()",
                          threads=threads)
    if freed > base:
        raise RuntimeError(f"phase 19(d): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 19(c): {data_tasks} of the data's plain tasks went through "
        f"the lane; first loss phase 5's exactly, {llama['launches']} flash "
        f"launches")
    log(f"phase 19(d): after shutdown() and stop_worker_plane() no lane "
        f"worker ({len(lane['lane_pids'])} were live) and no other worker "
        f"left, the core's port {port} closed, no /dev/shm segment of pid "
        f"{os.getpid()}, {freed - base} bytes above the base ({smi})")
    out = {"part": "19", "launches": flash["launches"] + llama["launches"],
           "lane_tasks_per_s": lane["tasks_per_s"],
           "classic_tasks_per_s": classic,
           "thread_tasks_per_s": lane["thread_tasks_per_s"],
           "data_lane_tasks": data_tasks, "put_ms": flash["put_ms"],
           "warm_put_ms": flash["warm_put_ms"],
           "get_ms": flash["get_ms"], "shm_bytes": flash["shm_bytes"],
           "arena_bytes": flash["arena_bytes"],
           "bytes_after_shutdown": freed, "base_bytes": base,
           "seconds": seconds, "card": smi}
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 20: the daemon cluster (head and node-daemon processes)
# ---------------------------------------------------------------------------

def card_pids() -> list:
    """The pids nvidia-smi lists with a context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def maps_cuda(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda" in f.read()
    except (FileNotFoundError, ProcessLookupError, PermissionError):
        return False


def only_driver_on_card(pids: set, part: str, seen: list) -> None:
    """Phase 20(d), one sample: nvidia-smi lists one context on the card
    and no process of the cluster (head, daemons, their workers); none of
    them maps the CUDA driver, while the driver does. (The sandbox's pid
    namespace is not nvidia-smi's: the pid it lists is not this process's
    number here, so the maps name the one holder.) The listed pids are
    kept in ``seen``."""
    import os
    listed = card_pids()
    seen.append(listed)
    ours = {p for p in pids if _alive(p)}
    mapped = sorted(p for p in ours if maps_cuda(p))
    if (len(listed) != 1 or set(listed) & ours or mapped
            or not maps_cuda(os.getpid())):
        raise RuntimeError(f"phase 20(d) at {part}: nvidia-smi lists "
                           f"{listed}, the cluster's processes mapping "
                           f"libcuda {mapped} (the driver {os.getpid()})")


def cluster_pids(rt_obj, worker_pids: set) -> set:
    """The pids of the head, the daemons, their forkservers and the workers
    that answered."""
    backend = rt_obj.cluster_backend
    pids = {backend.head_proc.pid} | set(worker_pids)
    for h in backend.daemons.values():
        pids.add(h.proc.pid)
        try:
            with open(f"/proc/{h.proc.pid}/task/{h.proc.pid}/children") as f:
                pids.update(int(x) for x in f.read().split())
        except OSError:
            pass
    return pids


@timed("20(a) daemon_cluster_checks")
def daemon_cluster_checks(smi: str, phase19) -> dict:
    """Phase 20(a): the head and both daemons alive, ``daemon_ping`` gives
    each one's pid; 1,000 no-op tasks in the daemons' workers, none in the
    driver; a nested get of a task inside a task reaches the owner; a
    STRICT_SPREAD group of two bundles committed on both daemons by the
    two-phase commit."""
    import os
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    runtime = worker.global_runtime()
    backend = runtime.cluster_backend
    handles = list(backend.daemons.values())
    driver = os.getpid()
    pings = {h.node_id.hex()[:8]: h.client.call("daemon_ping")["pid"]
             for h in handles}
    if (backend.head_proc.poll() is not None or len(handles) != 2
            or any(h.proc.poll() is not None for h in handles)
            or sorted(pings.values()) != sorted(h.proc.pid
                                                for h in handles)):
        raise RuntimeError(f"phase 20(a): head {backend.head_proc.poll()}, "
                           f"daemons {[h.proc.poll() for h in handles]}, "
                           f"pings {pings}")
    def lane_submitted():
        return sum(h.client.call("daemon_stats")["fast_lane"].get(
            "submitted", 0) for h in handles)

    fn = noop()
    before = lane_submitted()
    rate, pids = noop_rate(fn)
    through = lane_submitted() - before
    daemon_pids = {h.proc.pid for h in handles}
    if driver in pids or pids & daemon_pids or through < 1000:
        raise RuntimeError(f"phase 20(a): no-op tasks ran in {pids} (the "
                           f"driver {driver}, the daemons {daemon_pids}); "
                           f"the daemons' cores counted {through}")

    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer():
        return sum(rt.get([inner.remote(i) for i in range(4)]))

    nested = rt.get(outer.remote())
    if nested != 10:
        raise RuntimeError(f"phase 20(a): the nested get gave {nested}")
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    if not pg.wait(30):
        raise RuntimeError("phase 20(a): the group was never placed")
    states = {}
    for h in handles:
        bundles = h.client.call("daemon_stats")["bundles"]
        states[h.node_id.hex()[:8]] = sorted(
            v for k, v in bundles.items() if k.startswith(pg.id.hex()))
    remove_placement_group(pg)
    if sorted(states.values()) != [["COMMITTED"], ["COMMITTED"]]:
        raise RuntimeError(f"phase 20(a): bundle records {states}")
    lane = (phase19 or {}).get("lane_tasks_per_s")
    threads = (phase19 or {}).get("thread_tasks_per_s")
    beside = (f"beside 19(a)'s {lane:.0f} through the driver's lane and "
              f"{threads:.0f} on the driver's threads" if lane else
              "(19(a) not run in this call)")
    log(f"phase 20(a): the head (pid {backend.head_proc.pid}) and 2 daemons "
        f"up, daemon_ping {pings}; 1,000 no-op tasks in {len(pids)} of the "
        f"daemons' workers (none in the driver {driver} or a daemon; the "
        f"daemons' cores counted {through} with the 100 to warm up): "
        f"{rate:.0f} tasks/s {beside}; a nested get reached the owner "
        f"({nested}); a STRICT_SPREAD group of 2 bundles committed on both "
        f"daemons {states} ({smi})")
    return {"tasks_per_s": rate, "worker_pids": pids, "pings": pings}


@timed("20(b) daemon_flash")
def daemon_flash(dev, smi: str) -> dict:
    """Phase 20(b): daemon tasks make q, k and v (q and v on one daemon, k
    on the other), each left in its daemon's arena; one chunked pull copies
    q (64 MiB) to the other daemon, where a task consumes it zero-copy;
    the driver gets the three as read-only views inside the arenas, equal
    to their seeds' values; to the card as bf16 and ``flash_fwd_wgmma``
    once, held to the plain version at ``BF16_TOL``."""
    import ctypes
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.ops import attention as attn
    runtime = worker.global_runtime()
    backend = runtime.cluster_backend
    handles = list(backend.daemons.values())
    home = {"q": handles[0], "k": handles[1], "v": handles[0]}

    @rt.remote(max_retries=3)
    def make(shape, seed):
        return np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)

    @rt.remote
    def consume(refs):
        from ray_tpu_torch.objectplane.arena import arena_stats
        x = rt.get(refs)[0]
        return (float(x[0, 0, 0, :4].sum()), x.shape,
                bool(x.flags.writeable), arena_stats())

    t0 = time.perf_counter()
    refs = {}
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        strat = rt.NodeAffinitySchedulingStrategy(
            node_id=home[n].node_id.hex(), soft=True)
        refs[n] = make.options(scheduling_strategy=strat).remote(shape, i)
    rt.wait(list(refs.values()), num_returns=3, timeout=120)
    make_s = time.perf_counter() - t0
    where = {}
    for n, ref in refs.items():
        where[n] = [h.node_id.hex()[:8] for h in handles
                    if runtime.get_node(h.node_id).store.contains(ref.id)]
        if where[n] != [home[n].node_id.hex()[:8]]:
            raise RuntimeError(f"phase 20(b): {n} is held by {where}")
    used = {h.node_id.hex()[:8]: h.client.call("daemon_stats")["store_used"]
            for h in handles}
    # one chunked pull of q to the other daemon, then a task there reads it
    other = runtime.get_node(handles[1].node_id)
    before = handles[1].client.call("daemon_stats")["pull_stats"]
    t0 = time.perf_counter()
    if not runtime.pull_to_node(refs["q"].id, other, priority=0):
        raise RuntimeError("phase 20(b): the pull of q failed")
    pull_s = time.perf_counter() - t0
    after = handles[1].client.call("daemon_stats")["pull_stats"]
    pulled = after["bytes_pulled"] - before["bytes_pulled"]
    chunks = after["chunks_transferred"] - before["chunks_transferred"]
    strat = rt.NodeAffinitySchedulingStrategy(
        node_id=handles[1].node_id.hex(), soft=False)
    head4, shape, writeable, stats = rt.get(
        consume.options(scheduling_strategy=strat).remote([refs["q"]]))
    q_seed = np.random.default_rng(0).standard_normal(ATTN_SHAPES["q"],
                                                      dtype=np.float32)
    if (pulled < q_seed.nbytes or chunks < 16 or writeable
            or stats.get("zero_copy_gets", 0) < 1 or tuple(shape)
            != ATTN_SHAPES["q"]
            or head4 != float(q_seed[0, 0, 0, :4].sum())):
        raise RuntimeError(f"phase 20(b): the pull moved {pulled} bytes in "
                           f"{chunks} chunks; the consumer saw {shape} "
                           f"writeable {writeable} stats {stats}")
    # the driver's gets: views inside the arenas
    t0 = time.perf_counter()
    views = dict(zip(refs, rt.get(list(refs.values()))))
    get_ms = (time.perf_counter() - t0) * 1e3
    spans = {}
    for h in handles:
        arena = backend.arenas.handle(h.arena_name)
        lo = ctypes.addressof(arena._buf)
        spans[h.node_id.hex()[:8]] = (lo, lo + arena.capacity())
    inside = {}
    for n, view in views.items():
        addr = view.__array_interface__["data"][0]
        # q has a copy in both arenas after the pull: either may serve it
        inside[n] = [d for d, (lo, hi) in spans.items() if lo <= addr < hi]
    if not all(inside.values()) or any(v.flags.writeable
                                       for v in views.values()):
        raise RuntimeError(f"phase 20(b): views inside the arenas {inside}")
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        if not np.array_equal(views[n], np.random.default_rng(i)
                              .standard_normal(shape, dtype=np.float32)):
            raise RuntimeError(f"phase 20(b): {n} is not its seed's values")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        t0 = time.perf_counter()
        q, k, v = (torch.from_numpy(views[n]).to(dev).to(torch.bfloat16)
                   for n in ATTN_SHAPES)
        torch.cuda.synchronize()   # the copies are done: views may go
        copy_ms = (time.perf_counter() - t0) * 1e3
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    err = (out.float() - plain.float()).abs().max().item()
    if launches != 1 or not torch.isfinite(out).all():
        raise RuntimeError(f"phase 20(b): flash launches {launches}")
    del plain, views
    nbytes = sum(int(np.prod(s)) * 4 for s in ATTN_SHAPES.values())
    log(f"phase 20(b): 3 daemon tasks made q {ATTN_SHAPES['q']}, k and v "
        f"{ATTN_SHAPES['k']} as f32 ({nbytes / 2**20:.0f} MiB) in "
        f"{make_s:.2f} s, q and v left in daemon {where['q'][0]}'s arena, "
        f"k in {where['k'][0]}'s (store_used {used}); one chunked pull of "
        f"q to daemon {handles[1].node_id.hex()[:8]}: {pulled} bytes in "
        f"{chunks} chunks, {pull_s * 1e3:.1f} ms "
        f"({pulled / pull_s / 1e9:.2f} GB/s), and a task there read it as "
        f"a read-only view of its arena (zero_copy_gets "
        f"{stats['zero_copy_gets']}); the driver's get of the three "
        f"{get_ms:.2f} ms, read-only views inside the arenas {inside}, "
        f"equal to their seeds' values; to the card as bf16 {copy_ms:.1f} "
        f"ms; flash_fwd_wgmma, 1 launch, against the plain version "
        f"max_abs_err {err:.3e} ({smi})")
    return {"refs": refs, "qkv": (q, k, v), "out": out, "launches": launches,
            "max_abs_err": err, "get_ms": get_ms, "pull_ms": pull_s * 1e3,
            "pull_bytes": pulled, "pull_chunks": chunks, "copy_ms": copy_ms,
            "make_s": make_s, "home": home}


@timed("20(c) daemon_death")
def daemon_death(dev, flash: dict, smi: str) -> dict:
    """Phase 20(c): the driver's views released, the daemon holding k is
    SIGKILLed; the head marks it dead; an actor on it (max_restarts=1)
    restarts on the other daemon; the driver's get of k reconstructs it
    through lineage there, and the kernel on the rebuilt k gives (b)'s
    output bit for bit (one more launch, counted)."""
    import os
    import signal
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.ops import attention as attn
    runtime = worker.global_runtime()
    backend = runtime.cluster_backend
    victim = flash["home"]["k"]
    survivor = flash["home"]["q"]

    @rt.remote(max_restarts=1, max_task_retries=2)
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    strat = rt.NodeAffinitySchedulingStrategy(
        node_id=victim.node_id.hex(), soft=True)
    actor = Where.options(scheduling_strategy=strat).remote()
    first = rt.get(actor.node.remote())
    gc.collect()
    held = {h.node_id.hex()[:8]:
            h.client.call("daemon_stats")["slot_refs"]["refs"]
            for h in (victim, survivor)}
    if first != victim.node_id.hex() or any(held.values()):
        raise RuntimeError(f"phase 20(c): the actor is on {first}; slot "
                           f"refs still held {held}")
    rebuilt0 = runtime.stats["objects_reconstructed"]
    t0 = time.perf_counter()
    os.kill(victim.proc.pid, signal.SIGKILL)
    victim.proc.wait()
    dead_s = None
    while time.perf_counter() - t0 < 30:
        if not any(n["node_id"] == victim.node_id.hex() and n["alive"]
                   for n in backend.head.list_nodes()):
            dead_s = time.perf_counter() - t0
            break
        time.sleep(0.01)
    if dead_s is None:
        raise RuntimeError("phase 20(c): the head never marked the daemon "
                           "dead")
    restart_s = None
    while time.perf_counter() - t0 < 60:
        try:
            node = rt.get(actor.node.remote(), timeout=10)
        except Exception:   # noqa: BLE001 - restarting
            time.sleep(0.05)
            continue
        if node == survivor.node_id.hex():
            restart_s = time.perf_counter() - t0
            break
    if restart_s is None:
        raise RuntimeError("phase 20(c): the actor never restarted on the "
                           "surviving daemon")
    t1 = time.perf_counter()
    k_view = rt.get(flash["refs"]["k"], timeout=120)
    rebuild_s = time.perf_counter() - t1
    holder = [n.node_id.hex()[:8] for n in runtime.alive_nodes()
              if n.store.contains(flash["refs"]["k"].id)]
    rebuilt = runtime.stats["objects_reconstructed"] - rebuilt0
    if rebuilt != 1 or holder != [survivor.node_id.hex()[:8]]:
        raise RuntimeError(f"phase 20(c): {rebuilt} reconstructions, k "
                           f"held by {holder}")
    q, _, v = flash["qkv"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        k = torch.from_numpy(k_view).to(dev).to(torch.bfloat16)
        torch.cuda.synchronize()
    del k_view
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    if launches != 1 or not torch.equal(out, flash["out"]):
        raise RuntimeError(f"phase 20(c): launches {launches}; the output "
                           f"on the rebuilt k differs by "
                           f"{(out.float() - flash['out'].float()).abs().max().item()}")
    del q, k, v, out
    rt.kill(actor)
    log(f"phase 20(c): the driver's views released (slot refs held {held}),"
        f" daemon {victim.node_id.hex()[:8]} (pid {victim.proc.pid}) "
        f"SIGKILLed: the head marked it dead after {dead_s * 1e3:.0f} ms; "
        f"the actor on it (max_restarts=1) answered from daemon "
        f"{survivor.node_id.hex()[:8]} {restart_s:.2f} s after the kill; "
        f"the get of k rebuilt it through lineage there in {rebuild_s:.2f} "
        f"s; flash_fwd_wgmma on the rebuilt k, 1 launch, equal to (b)'s "
        f"output bit for bit ({smi})")
    return {"launches": launches, "dead_ms": dead_s * 1e3,
            "restart_s": restart_s, "rebuild_s": rebuild_s}


def daemon_path(dev, phase5=None, phase19=None, smi=None) -> dict:
    """Phase 20: the daemon cluster, ``init(cluster="daemons",
    num_nodes=2, resources={"CPU": 4})`` (see the module's docstring).
    Alone (it runs phase 5 first): ``python -c "import chip_smoke, torch;
    chip_smoke.daemon_path(torch.device('cuda'))"``."""
    import glob
    import os
    import torch
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    smi = smi or card_name()
    if phase5 is None:
        phase5 = train_path(dev, BENCH_LAYERS)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    t_init = time.perf_counter()
    runtime = rt.init(cluster="daemons", num_nodes=2,
                      resources={"CPU": 4})
    init_s = time.perf_counter() - t_init
    backend = runtime.cluster_backend
    node_ids = [h.node_id.hex() for h in backend.daemons.values()]
    session = backend.session_dir
    seen: list = []
    pids: set = set()
    try:
        pids = cluster_pids(runtime, set())
        only_driver_on_card(pids, "init", seen)
        cluster = daemon_cluster_checks(smi, phase19)
        pids = cluster_pids(runtime, cluster["worker_pids"])
        flash = daemon_flash(dev, smi)
        pids |= cluster_pids(runtime, set())
        only_driver_on_card(pids, "(b)", seen)
        death = daemon_death(dev, flash, smi)
        pids |= cluster_pids(runtime, set())
        only_driver_on_card(pids, "(c)", seen)
        figures = {k: flash[k] for k in ("get_ms", "pull_ms", "pull_bytes",
                                         "pull_chunks", "copy_ms",
                                         "max_abs_err", "make_s")}
        launches = flash["launches"] + death["launches"]
        del flash
    finally:
        rt.shutdown()
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in pids if _alive(p))
    segments = [s for n in node_ids
                for s in glob.glob(f"/dev/shm/rtpt_{n[:12]}*")]
    if left or segments or os.path.exists(session):
        raise RuntimeError(f"phase 20(e): processes {left} left, segments "
                           f"{segments}, the session dir "
                           f"{os.path.exists(session)}")
    freed, _ = wait_freed(base, "phase 20 after shutdown()")
    if freed > base:
        raise RuntimeError(f"phase 20(e): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 20(d): nvidia-smi listed one context on the card, pids "
        f"{seen} in its namespace, at init, after (b) and after (c) (this "
        f"process is pid {os.getpid()} in the sandbox's); none of the "
        f"cluster's {len(pids)} processes (the head, the daemons, their "
        f"forkservers and workers) listed or mapping libcuda, the driver "
        f"mapping it")
    log(f"phase 20(e): after shutdown() no head, daemon or worker process "
        f"of the {len(pids)} left, no /dev/shm segment of the 2 arenas, no "
        f"session dir, {freed - base} bytes above the base; the cluster up "
        f"in {init_s:.2f} s, phase 20 in {seconds:.1f} s ({smi})")
    out = {"part": "20", "launches": launches, "init_s": init_s,
           "tasks_per_s": cluster["tasks_per_s"], **figures,
           "dead_ms": death["dead_ms"], "restart_s": death["restart_s"],
           "rebuild_s": death["rebuild_s"], "processes": len(pids),
           "bytes_after_shutdown": freed, "base_bytes": base,
           "seconds": seconds, "card": smi}
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 21: the asyncio core, a cluster from the CLI, a drain, other drivers
# ---------------------------------------------------------------------------

def cli(*argv, env=None, timeout=120) -> subprocess.CompletedProcess:
    """``python -m ray_tpu_torch.scripts.cli *argv`` from the checkout,
    its output captured; raises on a non-zero exit."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(env or os.environ)
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                          *argv], capture_output=True, text=True,
                         timeout=timeout, env=env, cwd=here)
    if out.returncode != 0:
        raise RuntimeError(f"cli {' '.join(argv[:2])} exited "
                           f"{out.returncode}: {out.stderr[-2000:]}")
    return out


def cli_nodes(address: str) -> list:
    return json.loads(cli("cluster-status", "--address",
                          address).stdout)["nodes"]


def descendants(pids: set) -> set:
    """``pids`` and every live process descended from them."""
    import os
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    parent[int(entry)] = int(
                        f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                pass
    out = set(pids)
    grew = True
    while grew:
        grew = False
        for pid, ppid in parent.items():
            if ppid in out and pid not in out:
                out.add(pid)
                grew = True
    return out


@timed("21(a) core_rates")
def core_rates(smi: str, pairs: int = 3) -> dict:
    """Phase 21(a): ``init()`` runs the loop core (``debug_state()`` has
    ``loop=`` and the process's event loop runs); 1,000 no-op tasks on the
    driver's threads on each core, in alternated pairs; the lag gauge's
    largest sample and the slow-callback count of the driver's loop."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import eventloop
    from ray_tpu_torch.util import metrics
    runtime = rt.init()
    try:
        state = runtime.debug_state()
        if "loop=" not in state or not eventloop.running():
            raise RuntimeError(f"phase 21(a): the default init() runs no "
                               f"loop core: {state[:300]}")
    finally:
        rt.shutdown()

    def driver_samples(name: str) -> list:
        m = metrics.registry().get(name)
        return [v for k, v in (m.samples() if m else ())
                if ("proc", "driver") in k]

    peak = [0.0]
    done = threading.Event()

    def sample_lag():
        while not done.wait(0.01):
            peak[0] = max([peak[0], *driver_samples(
                "ray_tpu_event_loop_lag_seconds")])

    sampler = threading.Thread(target=sample_lag, daemon=True)
    sampler.start()
    slow0 = sum(driver_samples("ray_tpu_event_loop_slow_callbacks_total"))
    rates = {"async": [], "threaded": []}
    try:
        for _ in range(pairs):
            for core, flag in (("async", True), ("threaded", False)):
                rt.init(_system_config={**IN_THREADS, "async_core": flag})
                try:
                    rate, _ = noop_rate(noop())
                finally:
                    rt.shutdown()
                rates[core].append(rate)
    finally:
        done.set()
        sampler.join()
    slow = sum(driver_samples("ray_tpu_event_loop_slow_callbacks_total")) \
        - slow0
    log(f"phase 21(a): the default init() runs the asyncio core (debug_state "
        f"has loop=, the event loop runs); 1,000 no-op tasks on the driver's "
        f"threads in {pairs} alternated pairs: asyncio core "
        f"{[round(r) for r in rates['async']]} tasks/s, threaded core "
        f"{[round(r) for r in rates['threaded']]} tasks/s; the driver loop's "
        f"largest lag sample {peak[0] * 1e3:.2f} ms, {slow:.0f} slow "
        f"callbacks over loop_slow_callback_s ({smi})")
    return {"async_tasks_per_s": rates["async"],
            "threaded_tasks_per_s": rates["threaded"],
            "lag_max_ms": peak[0] * 1e3, "slow_callbacks": slow}


@timed("21(b) cli_start")
def cli_start() -> tuple:
    """Phase 21(b)'s cluster: ``cli start --head`` with two daemons on the
    threaded core; (address, seconds)."""
    import os
    env = dict(os.environ, RAY_TPU_ASYNC_CORE="0")
    t0 = time.perf_counter()
    out = cli("start", "--head", "--num-daemons", "2",
              "--resources", json.dumps({"CPU": 4}), env=env)
    return (out.stdout.split("started at")[1].split()[0],
            time.perf_counter() - t0)


@timed("21(b) cli_cluster_flash")
def cli_cluster_flash(dev, address: str, up_s: float, smi: str) -> dict:
    """Phase 21(b): this driver joins the CLI's cluster (daemons on the
    threaded core) on the asyncio core (``init(address=)``); three daemon
    tasks make q, k and v (k on the second daemon), the driver gets them
    as read-only views in the arenas, and ``flash_fwd_wgmma`` runs once on
    them (counted), held to the plain version."""
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import attention as attn
    t0 = time.perf_counter()
    runtime = rt.init(address=address)
    attach_s = time.perf_counter() - t0
    backend = runtime.cluster_backend
    handles = sorted(backend.daemons.values(), key=lambda h: h.node_id.hex())
    peers = backend.describe_peers()
    alive = [n for n in cli_nodes(address) if n["alive"]]
    if (len(handles) != 2 or len(alive) != 2 or backend.head_proc is not None
            or any(h.proc is not None for h in handles)
            or not all("core=threaded" in p for p in peers)):
        raise RuntimeError(f"phase 21(b): joined {len(handles)} daemons, "
                           f"cluster-status lists {len(alive)} alive, peers "
                           f"{peers}")
    home = {"q": handles[0], "k": handles[1], "v": handles[0]}

    @rt.remote(max_retries=3)
    def make(shape, seed):
        return np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)

    refs = {}
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        strat = rt.NodeAffinitySchedulingStrategy(
            node_id=home[n].node_id.hex(), soft=False)
        refs[n] = make.options(scheduling_strategy=strat).remote(shape, i)
    rt.wait(list(refs.values()), num_returns=3, timeout=120)
    views = dict(zip(refs, rt.get(list(refs.values()))))
    spans = arena_spans(backend, handles)
    inside = {n: [d for d, (lo, hi) in spans.items()
                  if lo <= v.__array_interface__["data"][0] < hi]
              for n, v in views.items()}
    if (inside != {n: [home[n].node_id.hex()[:8]] for n in refs}
            or any(v.flags.writeable for v in views.values())):
        raise RuntimeError(f"phase 21(b): views inside the arenas {inside}")
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        if not np.array_equal(views[n], np.random.default_rng(i)
                              .standard_normal(shape, dtype=np.float32)):
            raise RuntimeError(f"phase 21(b): {n} is not its seed's values")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        q, k, v = (torch.from_numpy(views[n]).to(dev).to(torch.bfloat16)
                   for n in ATTN_SHAPES)
        torch.cuda.synchronize()
    del views
    attn.flash_attention_kernel.launches = 0
    y = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(y.float(), plain.float(), **BF16_TOL)
    err = (y.float() - plain.float()).abs().max().item()
    if launches != 1 or not torch.isfinite(y).all():
        raise RuntimeError(f"phase 21(b): flash launches {launches}")
    del plain, k
    log(f"phase 21(b): `cli start --head --num-daemons 2` with "
        f"RAY_TPU_ASYNC_CORE=0 up in {up_s:.2f} s at {address}; this driver "
        f"joined on the asyncio core in {attach_s:.2f} s (init(address=)), "
        f"describe_peers {peers}, cluster-status lists 2 alive; q and v made "
        f"in daemon {home['q'].node_id.hex()[:8]}'s arena, k in "
        f"{home['k'].node_id.hex()[:8]}'s, got as read-only views inside "
        f"them; flash_fwd_wgmma, 1 launch, against the plain version "
        f"max_abs_err {err:.3e} ({smi})")
    return {"address": address, "refs": refs, "qk_v": (q, v), "out": y,
            "home": home, "launches": launches, "max_abs_err": err,
            "up_s": up_s, "attach_s": attach_s}


def arena_spans(backend, handles) -> dict:
    """Each daemon's arena as the driver maps it: node hex8 -> [lo, hi)."""
    import ctypes
    spans = {}
    for h in handles:
        arena = backend.arenas.handle(h.arena_name)
        lo = ctypes.addressof(arena._buf)
        spans[h.node_id.hex()[:8]] = (lo, lo + arena.capacity())
    return spans


@timed("21(c) cli_cluster_drain")
def cli_cluster_drain(dev, part_b: dict, smi: str) -> dict:
    """Phase 21(c): an actor (``max_restarts=1``) and a 3 s task on k's
    daemon, then ``drain_node(<k's node>, deadline_s=20)``: the head and
    ``cli cluster-status`` show it DRAINING; k is pushed to the other
    daemon (``drain_objects_migrated`` >= 1, nothing reconstructed); the
    actor answers from the survivor; once the task is done the drained
    daemon leaves and the head marks it dead; the driver's get of k is a
    view in the survivor's arena, and the kernel on it gives (b)'s output
    bit for bit (one more launch)."""
    import os
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.ops import attention as attn
    runtime = worker.global_runtime()
    backend = runtime.cluster_backend
    victim, survivor = part_b["home"]["k"], part_b["home"]["q"]
    vhex, shex = victim.node_id.hex(), survivor.node_id.hex()
    victim_pid = victim.client.call("daemon_ping")["pid"]

    @rt.remote(max_restarts=1, max_task_retries=2)
    class Where:
        def node(self):
            return rt.get_runtime_context().get_node_id()

    @rt.remote(max_retries=0)
    def busy(s, path):
        open(path, "w").close()
        time.sleep(s)
        return rt.get_runtime_context().get_node_id()

    actor = Where.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=vhex, soft=True)).remote()
    first = rt.get(actor.node.remote())
    marker = os.path.join(backend.session_dir, "phase21c_busy")
    running = busy.options(scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
        node_id=vhex, soft=False)).remote(3.0, marker)
    poll(lambda: os.path.exists(marker), 30, "21(c): the busy task started")
    gc.collect()
    rebuilt0 = runtime.stats["objects_reconstructed"]
    t0 = time.perf_counter()
    if first != vhex or not rt.drain_node(vhex, deadline_s=20,
                                          reason="phase 21"):
        raise RuntimeError(f"phase 21(c): the actor on {first}; the drain "
                           f"did not start")
    head_view = {n["node_id"]: n for n in backend.head.list_nodes()}[vhex]
    cli_view = {n["node_id"]: n for n in cli_nodes(part_b["address"])}[vhex]
    if not (head_view["draining"] and cli_view["draining"]
            and cli_view["alive"]):
        raise RuntimeError(f"phase 21(c): the head shows {head_view}, "
                           f"cluster-status {cli_view}")
    migrate_s = answer_s = exit_s = None
    while time.perf_counter() - t0 < 30 and exit_s is None:
        now = time.perf_counter() - t0
        if migrate_s is None and runtime.stats["drain_objects_migrated"]:
            migrate_s = now
        if answer_s is None:
            try:
                if rt.get(actor.node.remote(), timeout=5) == shex:
                    answer_s = time.perf_counter() - t0
            except Exception:   # noqa: BLE001 - moving
                pass
        if (runtime.get_node(victim.node_id) is None
                and not _alive(victim_pid)):
            exit_s = time.perf_counter() - t0
        time.sleep(0.01)
    ran_on = rt.get(running, timeout=30)
    view = {n["node_id"]: n for n in backend.head.list_nodes()}[vhex]
    if (None in (migrate_s, answer_s, exit_s) or view["alive"]
            or not view["reason"].startswith("drained") or ran_on != vhex):
        raise RuntimeError(f"phase 21(c): migrated {migrate_s}, answered "
                           f"{answer_s}, left {exit_s}; the head's view "
                           f"{view}; the running task ran on {ran_on}")
    k_view = rt.get(part_b["refs"]["k"], timeout=60)
    spans = arena_spans(backend, [survivor])
    lo, hi = spans[shex[:8]]
    addr = k_view.__array_interface__["data"][0]
    rebuilt = runtime.stats["objects_reconstructed"] - rebuilt0
    if not lo <= addr < hi or k_view.flags.writeable or rebuilt:
        raise RuntimeError(f"phase 21(c): k at {addr:#x}, the survivor's "
                           f"arena [{lo:#x}, {hi:#x}); {rebuilt} rebuilt")
    q, v = part_b["qk_v"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        k = torch.from_numpy(k_view).to(dev).to(torch.bfloat16)
        torch.cuda.synchronize()
    del k_view
    attn.flash_attention_kernel.launches = 0
    y = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    if launches != 1 or not torch.equal(y, part_b["out"]):
        raise RuntimeError(f"phase 21(c): launches {launches}; the output on "
                           f"the migrated k differs by "
                           f"{(y.float() - part_b['out'].float()).abs().max().item()}")
    del q, k, v, y
    rt.kill(actor)
    log(f"phase 21(c): drain_node({vhex[:8]}, deadline_s=20) with an actor "
        f"and a 3 s task on it: the head and `cli cluster-status` showed it "
        f"DRAINING; k migrated after {migrate_s * 1e3:.0f} ms "
        f"(drain_objects_migrated {runtime.stats['drain_objects_migrated']}, "
        f"objects_reconstructed {runtime.stats['objects_reconstructed']}), "
        f"the actor answered from daemon {shex[:8]} after "
        f"{answer_s * 1e3:.0f} ms, the task finished on the drained daemon, "
        f"which left (pid {victim_pid} gone, the head's reason "
        f"{view['reason']!r}) after {exit_s * 1e3:.0f} ms; the driver's get of "
        f"k is a read-only view in the survivor's arena; flash_fwd_wgmma on "
        f"it, 1 launch, equal to (b)'s output bit for bit ({smi})")
    return {"launches": launches, "migrate_ms": migrate_s * 1e3,
            "answer_ms": answer_s * 1e3, "exit_ms": exit_s * 1e3,
            "survivor": survivor}


# 21(d)'s other drivers, each a CPU process attached at once: each waits at
# a barrier (a file a driver, in <dir>/joined.*) until all three have
# joined, runs a lambda only it knows, and prints a marker from a task. A
# driver's ``done.*`` file says its own marker reached its own stdout; it
# leaves once the phase writes ``release``.
_21D_COMMON = """\
import os, sys, time
DIR = sys.argv[1]
NAMES = ("attach", "job", "client")


class Tee:
    def __init__(self, inner):
        self.inner, self.text = inner, []

    def write(self, s):
        self.text.append(s)
        return self.inner.write(s)

    def flush(self):
        self.inner.flush()


def wait_for(path, what):
    deadline = time.monotonic() + 180
    while not os.path.exists(os.path.join(DIR, path)):
        if time.monotonic() > deadline:
            raise SystemExit(f"{what}: no {path} within 180 s")
        time.sleep(0.02)


def barrier(name):
    open(os.path.join(DIR, "joined." + name), "w").close()
    for other in NAMES:
        wait_for("joined." + other, name)


def finish(name, tee, mark):
    deadline = time.monotonic() + 30
    while mark not in "".join(tee.text):
        if time.monotonic() > deadline:
            raise SystemExit(f"{name}: its marker never reached its stdout")
        time.sleep(0.02)
    open(os.path.join(DIR, "done." + name), "w").close()
    wait_for("release", name)
"""

_21D_DRIVER = _21D_COMMON + """\
import ray_tpu_torch as rt
name, mark = sys.argv[2], sys.argv[3]
tee = sys.stdout = Tee(sys.stdout)
r = rt.init(address=sys.argv[4])
barrier(name)
if name == "attach":
    f = rt.remote(lambda x: (rt.get_runtime_context().get_node_id(), x * 3))
    out = rt.get([f.remote(i) for i in range(8)], timeout=120)
    print("SECOND", sorted({n for n, _ in out}), [x for _, x in out])
else:
    f = rt.remote(lambda: 6 * 7)
    print("job says", rt.get(f.remote(), timeout=120))
say = rt.remote(lambda m: print(m, flush=True) or m)
assert rt.get(say.remote(mark), timeout=120) == mark
finish(name, tee, mark)
rt.shutdown()
"""

_21D_CLIENT = _21D_COMMON + """\
import numpy as np
from ray_tpu_torch.util.client import connect
c = connect(sys.argv[2])
barrier("client")
x = np.arange(16 << 20, dtype=np.float32)
ref = c.put(x)
total = c.remote(lambda a: float(a.sum(dtype=np.float64)))
print("CLIENT", c.get(total.remote(ref), timeout=120),
      float(x.sum(dtype=np.float64)), flush=True)
open(os.path.join(DIR, "done.client"), "w").close()
wait_for("release", "client")
c.close()
"""


@timed("21(d) other_drivers")
def other_drivers(part_b: dict, survivor, smi: str) -> dict:
    """Phase 21(d): three more drivers at once, while this driver's tasks
    are in flight: a CPU subprocess through ``cli attach``, a ``cli
    job-submit`` entrypoint that joins as a driver, and a ``util.client``
    subprocess that puts 64 MiB through ``serve_cluster`` in this driver.
    Each runs a lambda only it knows and checks its answer; each driver's
    worker lines reach it alone; a task of this driver that starts after
    the others joined runs a fresh function and a nested put/get."""
    import os
    import tempfile
    import uuid
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.util.client import serve_cluster
    address = part_b["address"]
    backend = worker.global_runtime().cluster_backend
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=here)
    env.pop("RAY_TPU_ASYNC_CORE", None)
    work = tempfile.mkdtemp(prefix="phase21d_", dir=backend.session_dir)
    nonce = uuid.uuid4().hex[:8]
    marks = {k: f"MARK21D_{k}_{nonce}" for k in ("self", "attach", "job")}
    for name, body in (("driver.py", _21D_DRIVER),
                       ("client.py", _21D_CLIENT)):
        with open(os.path.join(work, name), "w") as f:
            f.write(body)
    driver_py = os.path.join(work, "driver.py")

    def linger(s):
        time.sleep(s)
        return os.getpid()

    t0 = time.perf_counter()
    in_flight = [rt.remote(linger).remote(4.0) for _ in range(2)]
    server = serve_cluster(port=0)
    tee = sys.stdout = _Tee(sys.stdout)
    procs = {}
    logs = {}

    def start(name, argv, penv):
        # output to files: a full pipe must not stall a driver at the barrier
        logs[name] = [open(os.path.join(work, f"{name}.{k}"), "w+")
                      for k in ("out", "err")]
        procs[name] = subprocess.Popen(
            argv, stdout=logs[name][0], stderr=logs[name][1], text=True,
            env=penv, cwd=here)

    def read(name, k):
        f = logs[name][k]
        f.flush()
        f.seek(0)
        return f.read()

    try:
        start("attach", [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                         "attach", "--cluster", address, "--",
                         sys.executable, driver_py, work, "attach",
                         marks["attach"], address], env)
        start("job", [sys.executable, "-m", "ray_tpu_torch.scripts.cli",
                      "job-submit", f"{sys.executable} {driver_py} {work} "
                      f"job {marks['job']} {address}"],
              dict(env, RAY_TPU_ADDRESS=address))
        start("client", [sys.executable, os.path.join(work, "client.py"),
                         work, f"{server.address[0]}:{server.address[1]}"],
              env)

        def joined():
            for name, p in procs.items():
                if p.poll() is not None:
                    raise RuntimeError(
                        f"phase 21(d): {name} exited {p.returncode} before "
                        f"the barrier: {read(name, 0)[-800:]} "
                        f"{read(name, 1)[-1500:]}")
            return all(os.path.exists(os.path.join(work, "joined." + n))
                       for n in procs)

        poll(joined, 180, "21(d): the three drivers joined", every=0.02)
        joined_s = time.perf_counter() - t0
        # this driver's fresh function and a nested put/get, with all the
        # others attached
        fresh = rt.remote(lambda a, m: (print(m, flush=True) or m,
                                        a * 5))
        nested = rt.remote(lambda: int(rt.get(rt.put(np.arange(9))).sum()))
        mine = rt.get([fresh.remote(7, marks["self"]), nested.remote()],
                      timeout=120)
        if mine != [(marks["self"], 35), 36]:
            raise RuntimeError(f"phase 21(d): this driver's fresh function "
                               f"and nested put/get gave {mine}")
        poll(lambda: marks["self"] in "".join(tee.seen) and all(
            os.path.exists(os.path.join(work, "done." + n)) for n in procs),
            120, "21(d): every driver's own marker arrived", every=0.02)
        time.sleep(0.6)     # a line routed wrong would land by now
        with open(os.path.join(work, "release"), "w"):
            pass
        outs = {}
        for name, p in procs.items():
            p.wait(timeout=180)
            outs[name] = read(name, 0)
            if p.returncode != 0:
                raise RuntimeError(f"phase 21(d): {name} exited "
                                   f"{p.returncode}: {outs[name][-800:]} "
                                   f"{read(name, 1)[-1500:]}")
        all_s = time.perf_counter() - t0
        pids = rt.get(in_flight, timeout=60)
    finally:
        sys.stdout = tee.out
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for files in logs.values():
            for f in files:
                f.close()
        server.shutdown()
    outs["self"] = "".join(tee.seen)
    want = f"SECOND {[survivor.node_id.hex()]} {[i * 3 for i in range(8)]}"
    if want not in outs["attach"]:
        raise RuntimeError(f"phase 21(d): the attached driver printed "
                           f"{outs['attach'][-500:]}")
    if "job says 42" not in outs["job"] or "SUCCEEDED" not in outs["job"]:
        raise RuntimeError(f"phase 21(d): the job printed "
                           f"{outs['job'][-500:]}")
    got = [ln.split()[1:] for ln in outs["client"].splitlines()
           if ln.startswith("CLIENT")]
    if not got or got[0][0] != got[0][1]:
        raise RuntimeError(f"phase 21(d): the client printed "
                           f"{outs['client'][-300:]}")
    for owner, mark in marks.items():
        wrong = [k for k in ("self", "attach", "job")
                 if (mark in outs[k]) != (k == owner)]
        if wrong:
            raise RuntimeError(f"phase 21(d): {owner}'s worker line "
                               f"{mark} misrouted: present/absent wrongly "
                               f"in {wrong}")
    if len(pids) != 2:
        raise RuntimeError(f"phase 21(d): the in-flight tasks gave {pids}")
    log(f"phase 21(d): with 2 of this driver's 4 s tasks in flight, a "
        f"`cli attach` driver, a `cli job-submit` entrypoint driver and a "
        f"util.client subprocess started at once and all joined after "
        f"{joined_s:.2f} s; each ran a lambda only it knew (8 tasks on the "
        f"survivor, 6 * 7, the sum of 64 MiB put through serve_cluster in "
        f"this driver: {got[0][0]}); after they joined this driver ran a "
        f"fresh function and a nested put/get; each driver's worker line "
        f"reached its own stdout and no other; all done in {all_s:.2f} s "
        f"({smi})")
    return {"joined_s": joined_s, "other_drivers_s": all_s}


def control_plane_path(dev, phase5=None, smi=None) -> dict:
    """Phase 21: the asyncio core, a cluster from the CLI, a drain and
    other drivers (see the module's docstring). Alone (it runs phase 5
    first): ``python -c "import chip_smoke, torch;
    chip_smoke.control_plane_path(torch.device('cuda'))"``."""
    import glob
    import os
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.scripts.cli import CLUSTER_FILE
    t0 = time.perf_counter()
    smi = smi or card_name()
    if phase5 is None:
        phase5 = train_path(dev, BENCH_LAYERS)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    rates = core_rates(smi)
    part_b = None
    pids: set = set()
    seen: list = []
    address, up_s = cli_start()
    try:
        part_b = cli_cluster_flash(dev, address, up_s, smi)
        figures = {k: part_b[k] for k in ("up_s", "attach_s", "max_abs_err")}
        from ray_tpu_torch._private import worker
        backend = worker.global_runtime().cluster_backend
        with open(CLUSTER_FILE) as f:
            record = json.load(f)
        node_ids = [h.node_id.hex() for h in backend.daemons.values()]
        pids = descendants({record["head_pid"], *record["daemon_pids"]})
        only_driver_on_card(pids, "21(b)", seen)
        drain = cli_cluster_drain(dev, part_b, smi)
        drivers = other_drivers(part_b, drain["survivor"], smi)
        pids |= descendants({record["head_pid"], *record["daemon_pids"]})
        only_driver_on_card(pids, "21(d)", seen)
        launches = part_b["launches"] + drain["launches"]
        part_b = None
        rt.shutdown()
        # this driver did not own the cluster: it is still up
        alive = [n["node_id"] for n in cli_nodes(address) if n["alive"]]
        if len(alive) != 1:
            raise RuntimeError(f"phase 21(e): after shutdown() "
                               f"cluster-status lists {alive} alive")
        pids |= descendants({record["head_pid"], *record["daemon_pids"]})
    finally:
        part_b = None
        if rt.is_initialized():
            rt.shutdown()
        cli("stop", "--address", address)
    deadline = time.monotonic() + 10
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in pids if _alive(p))
    segments = [s for n in node_ids
                for s in glob.glob(f"/dev/shm/rtpt_{n[:12]}*")]
    if left or segments or os.path.exists(CLUSTER_FILE) \
            or os.path.exists(record["session"]):
        raise RuntimeError(f"phase 21(e): processes {left} left, segments "
                           f"{segments}, the cluster file "
                           f"{os.path.exists(CLUSTER_FILE)}, the session "
                           f"{os.path.exists(record['session'])}")
    freed, _ = wait_freed(base, "phase 21 after cli stop")
    if freed > base:
        raise RuntimeError(f"phase 21(e): {freed - base} bytes above the "
                           f"base after cli stop")
    seconds = time.perf_counter() - t0
    log(f"phase 21(d): nvidia-smi listed one context on the card, pids "
        f"{seen} in its namespace, after (b) and after (d); none of the "
        f"cluster's {len(pids)} processes (the head, the daemons, their "
        f"forkservers and workers) listed or mapping libcuda, this driver "
        f"mapping it")
    log(f"phase 21(e): after this driver's shutdown() cluster-status still "
        f"answered (1 alive); after `cli stop` no head, daemon or worker "
        f"process of the {len(pids)} left, no /dev/shm segment of the 2 "
        f"arenas, no cluster file or session dir, {freed - base} bytes above "
        f"the base; phase 21 in {seconds:.1f} s ({smi})")
    out = {"part": "21", "launches": launches, **rates, **figures,
           "seconds": seconds, "card": smi,
           "migrate_ms": drain["migrate_ms"],
           "answer_ms": drain["answer_ms"], "exit_ms": drain["exit_ms"],
           **drivers, "processes": len(pids),
           "bytes_after_stop": freed, "base_bytes": base}
    log(json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 22: the rest of the cluster: the targeted actor lane, a native C++
# program, serve's second ingress, the autoscaler and the launcher
# ---------------------------------------------------------------------------

def lane_submitted(handles) -> int:
    """The daemons' native cores' submit count (pool and targeted)."""
    return sum(h.client.call("daemon_stats")["fast_lane"].get("submitted", 0)
               for h in handles)


def lane_actor_class():
    import os
    import ray_tpu_torch as rt

    @rt.remote(max_restarts=1)
    class Lane:
        def pid(self):
            return os.getpid()

        def make(self, shape, seed):
            # put from the worker: an array >= 256 KiB is written straight
            # into the daemon's arena, and the ref comes back in a list
            return [rt.put(np.random.default_rng(seed).standard_normal(
                shape, dtype=np.float32))]

    return Lane


def lane_rates(handles, lane, classic, pairs: int = 3) -> dict:
    """Phase 22(a)'s rates: 1,000 calls on the lane-bound actor and 1,000 on
    the ``max_concurrency=2`` one (the classic path) in alternated pairs;
    the cores count every lane call and none of the classic ones."""
    import ray_tpu_torch as rt
    rates = {"lane": [], "classic": []}
    counted = {"lane": 0, "classic": 0}
    for a in (lane, classic):
        rt.get([a.pid.remote() for _ in range(100)])      # warm up
    for _ in range(pairs):
        for key, a in (("lane", lane), ("classic", classic)):
            before = lane_submitted(handles)
            t0 = time.perf_counter()
            rt.get([a.pid.remote() for _ in range(1000)])
            rates[key].append(1000 / (time.perf_counter() - t0))
            counted[key] += lane_submitted(handles) - before
    if counted["lane"] < 1000 * pairs or counted["classic"]:
        raise RuntimeError(f"phase 22(a): the cores counted {counted} of "
                           f"{pairs} x 1,000 calls a path: the calls did "
                           f"not take the lane")
    return {"rates": rates, "submitted": counted}


def lane_flash(dev, lane) -> dict:
    """Phase 22(a)'s kernel: the lane-bound actor makes q, k and v at phase
    20's seeds and shapes; the driver gets them as read-only views inside
    the daemons' arenas, to the card as bf16 into ``flash_fwd_wgmma`` (one
    launch, counted), held to the plain version at ``BF16_TOL``."""
    import ctypes
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.ops import attention as attn
    backend = worker.global_runtime().cluster_backend
    t0 = time.perf_counter()
    refs = {n: rt.get(lane.make.remote(shape, i))[0]
            for i, (n, shape) in enumerate(ATTN_SHAPES.items())}
    views = dict(zip(refs, rt.get(list(refs.values()))))
    make_s = time.perf_counter() - t0
    spans = []
    for h in backend.daemons.values():
        arena = backend.arenas.handle(h.arena_name)
        lo = ctypes.addressof(arena._buf)
        spans.append((lo, lo + arena.capacity()))
    for i, (n, view) in enumerate(views.items()):
        addr = view.__array_interface__["data"][0]
        if (view.flags.writeable
                or not any(lo <= addr < hi for lo, hi in spans)
                or not np.array_equal(view, np.random.default_rng(i)
                                      .standard_normal(ATTN_SHAPES[n],
                                                       dtype=np.float32))):
            raise RuntimeError(f"phase 22(a): {n} is not a read-only view "
                               f"of its seed's values inside an arena")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        q, k, v = (torch.from_numpy(views[n]).to(dev).to(torch.bfloat16)
                   for n in ATTN_SHAPES)
        torch.cuda.synchronize()
    del views
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    err = (out.float() - plain.float()).abs().max().item()
    if launches != 1 or not torch.isfinite(out).all():
        raise RuntimeError(f"phase 22(a): flash launches {launches}")
    del plain, refs
    return {"qkv": (q, k, v), "out": out, "launches": launches,
            "max_abs_err": err, "make_s": make_s}


def lane_restart(runtime, lane) -> dict:
    """Phase 22(a)'s restart: the lane-bound actor's worker SIGKILLed; the
    actor comes back in a new worker under a fresh tag and answers."""
    import os
    import signal
    import ray_tpu_torch as rt
    tag1 = runtime._actor_executors[lane._actor_id].instance.fast_tag
    pid1 = rt.get(lane.pid.remote())
    t0 = time.perf_counter()
    os.kill(pid1, signal.SIGKILL)
    pid2 = None
    while time.perf_counter() - t0 < 60:
        try:
            pid2 = rt.get(lane.pid.remote(), timeout=10)
            break
        except Exception:   # noqa: BLE001 - restarting
            time.sleep(0.05)
    restart_s = time.perf_counter() - t0
    tag2 = runtime._actor_executors[lane._actor_id].instance.fast_tag
    if pid2 is None or pid2 == pid1 or not tag2 or tag2 == tag1:
        raise RuntimeError(f"phase 22(a): after the SIGKILL of {pid1} the "
                           f"actor answered from {pid2}, tags {tag1} -> "
                           f"{tag2}")
    return {"tags": (tag1, tag2), "pids": (pid1, pid2),
            "restart_s": restart_s}


@timed("22(a) lane_path")
def lane_path(dev, smi: str) -> dict:
    """Phase 22(a): the targeted actor lane on the daemon cluster."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    runtime = worker.global_runtime()
    handles = list(runtime.cluster_backend.daemons.values())
    Lane = lane_actor_class()
    lane = Lane.remote()
    classic = Lane.options(max_concurrency=2).remote()
    rt.get([lane.pid.remote(), classic.pid.remote()])
    tags = (runtime._actor_executors[lane._actor_id].instance.fast_tag,
            runtime._actor_executors[classic._actor_id].instance.fast_tag)
    if not tags[0] or tags[1] is not None:
        raise RuntimeError(f"phase 22(a): the actors' tags are {tags}")
    rates = lane_rates(handles, lane, classic)
    flash = lane_flash(dev, lane)
    restart = lane_restart(runtime, lane)
    rt.kill(classic)
    r = rates["rates"]
    log(f"phase 22(a): a lane-bound actor (tag {tags[0]}) and a "
        f"max_concurrency=2 one (no tag); 1,000 calls each in 3 alternated "
        f"pairs: the targeted lane {[round(x) for x in r['lane']]} calls/s, "
        f"the classic path {[round(x) for x in r['classic']]} calls/s; the "
        f"cores' submitted count rose {rates['submitted']['lane']} on the "
        f"lane and {rates['submitted']['classic']} on the classic path; the "
        f"actor made q, k and v {ATTN_SHAPES['q']} / {ATTN_SHAPES['k']} "
        f"into the arenas in {flash['make_s']:.2f} s, read as read-only "
        f"views, flash_fwd_wgmma 1 launch, max_abs_err "
        f"{flash['max_abs_err']:.3e} against the plain version; its worker "
        f"SIGKILLed (pid {restart['pids'][0]}): back in pid "
        f"{restart['pids'][1]} under tag {restart['tags'][1]} after "
        f"{restart['restart_s']:.2f} s ({smi})")
    return {**flash, "lane_calls_per_s": r["lane"],
            "classic_calls_per_s": r["classic"],
            "submitted": rates["submitted"]["lane"],
            "restart_s": restart["restart_s"]}


def build_demo() -> str:
    """g++ builds ``csrc/api_demo.cc`` into the build directory unless a
    build of this source and ``ray_tpu_api.h`` is there; its path."""
    import hashlib
    import os
    from ray_tpu_torch import _build
    src = _build.CSRC / "api_demo.cc"
    key = hashlib.sha256(src.read_bytes() + (
        _build.CSRC / "ray_tpu_api.h").read_bytes()).hexdigest()[:16]
    demo = _build.BUILD_DIR / f"api_demo-{key}"
    if not demo.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = demo.with_name(f"{demo.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-o", str(tmp),
                        str(src), "-ldl"], check=True, timeout=300)
        os.replace(tmp, demo)
    return str(demo)


def demo_lines(demo: str, lib: str, head_port: int, daemon) -> tuple:
    """Run the native demo against the cluster; (its KEY=value lines,
    seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([demo, "127.0.0.1", str(head_port), daemon.addr[0],
                          str(daemon.addr[1]), lib], capture_output=True,
                         text=True, timeout=120)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"phase 22(b): the demo exited {out.returncode}: "
                           f"{out.stdout[-1000:]} {out.stderr[-1000:]}")
    return (dict(line.split("=", 1)
                 for line in out.stdout.strip().splitlines()), seconds)


@timed("22(b) native_program")
def native_program(dev, flash: dict, smi: str) -> dict:
    """Phase 22(b): ``csrc/cpp_client.cc`` and the demo ``csrc/api_demo.cc``
    (over ``ray_tpu_api.h``), g++-built into the build directory (at the
    script's start, or here when run alone);
    the demo drives the cluster (KV, ping, objects, an exported task and
    actor) and prints the CPU test's lines; the client (through
    ``cpp_client.py``) writes q's bytes into a daemon's object table, the
    driver reads them into the flash kernel, bit for bit 22(a)'s output."""
    import warnings
    import torch
    from ray_tpu_torch import _build, xlang
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.cpp_client import CppClient
    from ray_tpu_torch.ops import attention as attn
    backend = worker.global_runtime().cluster_backend
    daemon = list(backend.daemons.values())[0]
    t0 = time.perf_counter()
    lib = str(_build.build_host("cpp_client"))
    demo = build_demo()
    build_s = time.perf_counter() - t0

    def add(a, b):
        return a + b

    def greet(who):
        return f"hello {who}"

    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k):
            self.n += k
            return self.n

    xlang.export_task("add", add)
    xlang.export_task("greet", greet)
    xlang.export_actor_class("Counter", Counter)
    lines, demo_s = demo_lines(demo, lib, backend.head.addr[1], daemon)
    want = {"KV": "embedded-value", "PING": str(daemon.proc.pid),
            "OBJ": "300000", "ADD": "42", "GREET": "hello embedded",
            "COUNT1": "101", "COUNT2": "106", "MISSING_OK": "0",
            "DONE": "1"}
    if lines != want:
        raise RuntimeError(f"phase 22(b): the demo printed {lines}")
    q_seed = np.random.default_rng(0).standard_normal(ATTN_SHAPES["q"],
                                                      dtype=np.float32)
    client = CppClient(daemon.addr)
    try:
        t1 = time.perf_counter()
        client.put_object(b"cpp-q", q_seed.tobytes())
        put_s = time.perf_counter() - t1
    finally:
        client.close()
    blob = daemon.get_object_blob(b"cpp-q")
    q_host = np.frombuffer(blob, dtype=np.float32).reshape(ATTN_SHAPES["q"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        q = torch.from_numpy(q_host).to(dev).to(torch.bfloat16)
    _, k, v = flash["qkv"]
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    if launches != 1 or not torch.equal(out, flash["out"]):
        raise RuntimeError(f"phase 22(b): launches {launches}; the output on "
                           f"the C++ client's q differs from 22(a)'s by "
                           f"{(out.float() - flash['out'].float()).abs().max().item()}")
    mb_s = q_seed.nbytes / put_s / 1e6
    del q, out, blob, q_host
    log(f"phase 22(b): the client library and the demo (g++ built them at "
        f"the script's start) found in {build_s:.1f} s; the demo (no Python "
        f"in its process) ran in {demo_s * 1e3:.0f} ms and printed the CPU "
        f"test's lines {lines}; "
        f"the client wrote q ({q_seed.nbytes / 2**20:.0f} MiB) into daemon "
        f"{daemon.node_id.hex()[:8]}'s table in {put_s * 1e3:.1f} ms "
        f"({mb_s:.0f} MB/s); flash_fwd_wgmma on it, 1 launch, equal to "
        f"22(a)'s output bit for bit ({smi})")
    return {"launches": launches, "build_s": build_s, "demo_ms": demo_s * 1e3,
            "put_mb_s": mb_s}


@timed("22(d) autoscale_checks")
def autoscale_checks(runtime, smi: str) -> dict:
    """Phase 22(d), the autoscaler: a ``ProcessHostProvider`` and a
    ``Reconciler`` on 22(a)'s cluster provision a real daemon for a
    ``{"CPU": 16}`` bundle; a task lands there; idle, the node is drained
    and its process ends."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler_v2 import (InstanceStatus,
                                             ProcessHostProvider, Reconciler)
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    before = {n.node_id for n in runtime.alive_nodes()}
    provider = ProcessHostProvider(runtime)
    rec = Reconciler(runtime, provider, idle_timeout_s=0.5)
    t0 = time.perf_counter()
    pg = placement_group([{"CPU": 16}], strategy="PACK")
    while time.perf_counter() - t0 < 60:
        rec.reconcile()
        if pg.wait(0.2):
            break
    up_s = time.perf_counter() - t0
    rec.reconcile()
    new = {n.node_id for n in runtime.alive_nodes()} - before
    running = rec.instance_manager.list(InstanceStatus.RAY_RUNNING)
    if len(new) != 1 or not running or running[0].node_type != "cpu-host":
        raise RuntimeError(f"phase 22(d): new nodes {new}, instances "
                           f"{[(i.node_type, i.status) for i in running]}")
    record = next(iter(provider._launched.values()))
    remove_placement_group(pg)

    @rt.remote(num_cpus=9)          # only the provisioned host fits it
    def where():
        return rt.get_runtime_context().get_node_id()

    t1 = time.perf_counter()
    node = rt.get(where.remote(), timeout=60)
    task_s = time.perf_counter() - t1
    if node != next(iter(new)).hex():
        raise RuntimeError(f"phase 22(d): the task ran on {node}")
    t2 = time.perf_counter()
    while time.perf_counter() - t2 < 60:
        rec.reconcile()
        if rec.instance_manager.list(InstanceStatus.TERMINATED):
            break
        time.sleep(0.1)
    end_s = time.perf_counter() - t2
    if (not rec.instance_manager.list(InstanceStatus.TERMINATED)
            or _alive(record["pid"])):
        raise RuntimeError(f"phase 22(d): the provisioned daemon (pid "
                           f"{record['pid']}) did not end")
    log(f"phase 22(d): the reconciler provisioned a real daemon (pid "
        f"{record['pid']}, cpu-host) for a CPU 16 bundle in {up_s:.2f} s, a "
        f"num_cpus=9 task landed there in {task_s:.2f} s, and idle it was "
        f"drained and its process ended in {end_s:.2f} s "
        f"({rec.stats}) ({smi})")
    return {"node_ids": [record["node_id"]], "pids": {record["pid"]},
            "provision_s": up_s, "task_s": task_s, "end_s": end_s}


@timed("22(c) grpc_ingress")
def grpc_ingress(dev, smi: str) -> dict:
    """Phase 22(c): bench_400m's app (32 slots, phase 14's; on the card
    ``BENCH_LAYERS`` deep) behind ``start_grpc_proxy()``: 8 requests by
    ``predict`` and 8 by ``predict_stream`` (prompts of 32-256 tokens, 32
    new tokens, greedy),
    one at a time; then the same 16 through the handle of a second copy of
    the app (same config and seed: both engines cold for each prompt, each
    serving one request at a time). The tokens must be equal, the paged
    kernel once per layer per decode step of both engines and no other
    kernel."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.bench import bench_setup, warm_replicas
    from ray_tpu_torch.llm.serving import (LLMConfig, build_llm_app,
                                           join_engine_threads)
    from ray_tpu_torch.serve.grpc_proxy import (GrpcServeClient,
                                                start_grpc_proxy,
                                                stop_grpc_proxy)
    setup = bench_setup(dev, n_layers=BENCH_LAYERS
                        if dev.type == "cuda" else None)
    mcfg = setup["model_config"]
    rng = np.random.default_rng(22)
    lens = rng.integers(32, 257, 16) if dev.type == "cuda" \
        else rng.integers(8, 25, 16)
    prompts = [rng.integers(1, mcfg.vocab_size, n).tolist() for n in lens]
    new = 32 if dev.type == "cuda" else 8
    rt.init()
    try:
        apps = {}
        for name in ("grpc", "handle"):
            cfg = LLMConfig(model_id=f"bench-{name}", model_config=mcfg,
                            max_slots=setup["max_slots"],
                            max_seq=setup["max_seq"])
            apps[name] = serve.run(build_llm_app(cfg, device=dev),
                                   name=name, route_prefix=f"/{name}")
            warm_replicas(rt, cfg.model_id, setup["warm_lens"])
        client = GrpcServeClient(f"127.0.0.1:{start_grpc_proxy()}")

        def engine_steps(model_id: str) -> int:
            reps = rt.get(rt.get_actor("serve_controller")
                          .get_replicas.remote(model_id))["replicas"]
            return sum(rt.get(r.handle_request.remote("stats", (), {}))
                       ["decode_steps"] for r in reps)

        def run(path: str) -> dict:
            tokens, first_ms, wall = [], [], 0.0
            for i, prompt in enumerate(prompts):
                req = {"prompt": prompt, "max_tokens": new}
                stream = i >= 8
                t0 = time.perf_counter()
                if path == "grpc" and not stream:
                    ids = client.predict(req, application="grpc")["token_ids"]
                    first = time.perf_counter() - t0
                elif path == "grpc":
                    ids, first = [], None
                    for chunk in client.predict_stream(
                            dict(req, stream=True), application="grpc"):
                        first = first or time.perf_counter() - t0
                        if "token_id" in chunk:
                            ids.append(chunk["token_id"])
                elif not stream:
                    ids = apps["handle"].remote(req).result()["token_ids"]
                    first = time.perf_counter() - t0
                else:
                    ids, first = [], None
                    for chunk in apps["handle"].options(stream=True).remote(
                            dict(req, stream=True)):
                        first = first or time.perf_counter() - t0
                        if "token_id" in chunk:
                            ids.append(chunk["token_id"])
                wall += time.perf_counter() - t0
                tokens.append(list(ids))
                first_ms.append(first * 1e3)
            # a unary call's first item is its whole result
            return {"tokens": tokens,
                    "unary_ms": float(np.median(first_ms[:8])),
                    "stream_first_ms": float(np.median(first_ms[8:])),
                    "tokens_per_s": sum(map(len, tokens)) / wall}

        steps0 = {n: engine_steps(f"bench-{n}") for n in apps}
        for c in kernel_counters():
            c.launches = 0
        # one path after the other: run at once, the two engines' threads
        # and clients share the host's cores and each ran ~4x slower on
        # the H100's host
        via = {n: run(n) for n in apps}
        launches = read_launches()
        steps = sum(engine_steps(f"bench-{n}") - steps0[n] for n in apps)
        client.close()
        stop_grpc_proxy()
    finally:
        serve.shutdown()
        rt.shutdown()
        join_engine_threads()
    check_paged_only("phase 22(c)", launches, steps, mcfg.n_layers)
    if (via["grpc"]["tokens"] != via["handle"]["tokens"]
            or not all(via["grpc"]["tokens"])):
        raise RuntimeError(f"phase 22(c): the proxy's tokens differ from "
                           f"the handle's: {via['grpc']['tokens'][:2]} / "
                           f"{via['handle']['tokens'][:2]}")
    g, h = via["grpc"], via["handle"]
    log(f"phase 22(c): bench_400m's app ({mcfg.n_layers} layers, 32 "
        f"slots) behind the second ingress: 8 predict + 8 predict_stream "
        f"requests (prompts {lens.min()}-{lens.max()} tokens, {new} new, "
        f"greedy, one at a time) gave the tokens of the same requests "
        f"through a second copy's handle; median time to the first item: "
        f"a stream's first chunk {g['stream_first_ms']:.1f} ms "
        f"through the proxy, {h['stream_first_ms']:.1f} ms through the "
        f"handle, a unary result {g['unary_ms']:.1f} / {h['unary_ms']:.1f} "
        f"ms; {g['tokens_per_s']:.1f} / {h['tokens_per_s']:.1f} tokens/s; "
        f"paged launches {launches['paged_decode_attention']} ({steps} "
        f"decode steps x {mcfg.n_layers} layers) ({smi})")
    return {"launches": launches["paged_decode_attention"],
            **{f"{n}_{k}": via[n][k] for n in via
               for k in ("stream_first_ms", "unary_ms", "tokens_per_s")}}


@timed("22(d) launcher_checks")
def launcher_checks(tmp: str, smi: str, seen: list) -> dict:
    """Phase 22(d), the launcher: ``cluster_launcher.up`` from a JSON config
    (a head and two workers, the subprocess provider); a CPU driver (a
    subprocess with the card hidden) joins it and runs tasks; ``down``
    ends the three."""
    import os
    from ray_tpu_torch import cluster_launcher as cl
    config = os.path.join(tmp, "cluster.json")
    with open(config, "w") as f:
        json.dump({"cluster_name": f"smoke-{os.getpid()}",
                   "provider": {"type": "subprocess"},
                   "head": {"resources": {"CPU": 2}},
                   "worker": {"resources": {"CPU": 2}, "count": 2}}, f)
    t0 = time.perf_counter()
    state = cl.up(config)
    pids = {n["pid"] for n in state["nodes"]}
    node_ids = [n["node_id"] for n in state["nodes"] if n["kind"] == "worker"]
    try:
        if not cl.wait_for_nodes(state["address"], 2, timeout=60):
            raise RuntimeError("phase 22(d): the launched workers never "
                               "registered")
        up_s = time.perf_counter() - t0
        pids = descendants(pids)
        only_driver_on_card(pids, "22(d)", seen)
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=here + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        script = ("import os, ray_tpu_torch as rt\n"
                  f"rt.init(address={state['address']!r})\n"
                  "f = rt.remote(lambda i: (i * i, os.getpid()))\n"
                  "out = rt.get([f.remote(i) for i in range(16)])\n"
                  "print('SQUARES', sum(v for v, _ in out))\n"
                  "print('PIDS', len({p for _, p in out}))\n"
                  "rt.shutdown()\n")
        t1 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=here)
        join_s = time.perf_counter() - t1
        if out.returncode != 0 or f"SQUARES {sum(i * i for i in range(16))}" \
                not in out.stdout:
            raise RuntimeError(f"phase 22(d): the CPU driver exited "
                               f"{out.returncode}: {out.stdout[-500:]} "
                               f"{out.stderr[-1500:]}")
        pids = descendants(pids)
    finally:
        t2 = time.perf_counter()
        n = cl.down(config)
        down_s = time.perf_counter() - t2
    if n != 3:
        raise RuntimeError(f"phase 22(d): down ended {n} nodes")
    log(f"phase 22(d): cluster_launcher.up from a JSON config stood up a "
        f"head and 2 workers in {up_s:.2f} s; a CPU driver joined and ran "
        f"16 tasks in {join_s:.2f} s ({out.stdout.split()}); down ended "
        f"{n} in {down_s:.2f} s ({smi})")
    return {"pids": pids, "node_ids": node_ids, "up_s": up_s,
            "join_s": join_s, "down_s": down_s}


def cluster_tier_path(dev, smi=None) -> dict:
    """Phase 22: the rest of the cluster (see the module's docstring).
    Alone: ``python -c "import chip_smoke, torch;
    chip_smoke.cluster_tier_path(torch.device('cuda'))"``."""
    import glob
    import os
    import tempfile
    import torch
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    smi = smi or card_name()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    runtime = rt.init(cluster="daemons", num_nodes=2, resources={"CPU": 4})
    backend = runtime.cluster_backend
    node_ids = [h.node_id.hex() for h in backend.daemons.values()]
    session = backend.session_dir
    pids: set = set()
    seen: list = []
    try:
        pids = cluster_pids(runtime, set())
        lane = lane_path(dev, smi)
        pids |= cluster_pids(runtime, set())
        only_driver_on_card(pids, "22(a)", seen)
        native = native_program(dev, lane, smi)
        pids |= cluster_pids(runtime, set())
        only_driver_on_card(pids, "22(b)", seen)
        scaled = autoscale_checks(runtime, smi)
        pids |= scaled["pids"]
        node_ids += scaled["node_ids"]
        figures = {"lane_calls_per_s": lane["lane_calls_per_s"],
                   "classic_calls_per_s": lane["classic_calls_per_s"],
                   "lane_submitted": lane["submitted"],
                   "lane_restart_s": lane["restart_s"],
                   "lane_max_abs_err": lane["max_abs_err"],
                   **{k: native[k] for k in ("build_s", "demo_ms",
                                             "put_mb_s")},
                   **{k: scaled[k] for k in ("provision_s", "task_s",
                                             "end_s")}}
        flash_launches = lane["launches"] + native["launches"]
    finally:
        lane = None
        rt.shutdown()
    ingress = grpc_ingress(dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launched = launcher_checks(tmp, smi, seen)
    pids |= launched["pids"]
    node_ids += launched["node_ids"]
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in pids if _alive(p))
    segments = [s for n in node_ids
                for s in glob.glob(f"/dev/shm/rtpt_{n[:12]}*")]
    if left or segments or os.path.exists(session):
        raise RuntimeError(f"phase 22(e): processes {left} left, segments "
                           f"{segments}, the session dir "
                           f"{os.path.exists(session)}")
    freed, _ = wait_freed(base, "phase 22 after shutdown()")
    if freed > base:
        raise RuntimeError(f"phase 22(e): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 22(e): nvidia-smi listed one context, pids {seen}, with the "
        f"daemon cluster up and with the launcher's; none of the "
        f"{len(pids)} processes of the clusters (heads, daemons, their "
        f"forkservers and workers, the provisioned daemon) left, no "
        f"/dev/shm segment of the {len(node_ids)} arenas, no session dir, "
        f"{freed - base} bytes above the base; phase 22 in {seconds:.1f} s "
        f"({smi})")
    out = {"part": "22", "flash_launches": flash_launches,
           "paged_launches": ingress["launches"], **figures,
           **{k: v for k, v in ingress.items() if k != "launches"},
           **{k: launched[k] for k in ("up_s", "join_s", "down_s")},
           "processes": len(pids), "bytes_after_shutdown": freed,
           "base_bytes": base, "seconds": seconds, "card": smi}
    log(json.dumps(out))
    return out


class _Tee:
    """A stand-in for ``sys.stdout`` that passes every write through and
    keeps a copy (23(d) reads the lines the runtime printed)."""

    def __init__(self, out):
        self.out, self.seen = out, []

    def write(self, s):
        self.seen.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def __getattr__(self, name):
        return getattr(self.out, name)


def trace_lanes(trace, task_hex: str) -> set:
    return {s["pid"].split(":")[0] for s in trace
            if s.get("args", {}).get("task_id") == task_hex}


@timed("23(a) obs_spans")
def obs_spans(dev, smi: str) -> dict:
    """Phase 23(a): daemon tasks make q, k and v (phase 20's seeds and
    shapes), the driver reads them as arena views into the flash kernel
    inside ``tracing.span("flash_forward")``; q's task breakdown, the merged
    timeline's lanes, the span against the kernel's CUDA-event time, and
    the export events of every kind."""
    import ctypes
    import warnings
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.export_events import get_export_logger
    from ray_tpu_torch.job import JobSubmissionClient
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)
    from ray_tpu_torch.util import state, tracing
    runtime = worker.global_runtime()
    backend = runtime.cluster_backend
    handles = list(backend.daemons.values())
    home = {"q": handles[0], "k": handles[1], "v": handles[0]}

    @rt.remote(max_retries=3)
    def make(shape, seed):
        from ray_tpu_torch.util.metrics import Counter
        Counter("phase23_tasks_total", "phase 23's tasks").inc()
        return np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)

    refs = {}
    for i, (n, shape) in enumerate(ATTN_SHAPES.items()):
        strat = rt.NodeAffinitySchedulingStrategy(
            node_id=home[n].node_id.hex(), soft=False)
        refs[n] = make.options(scheduling_strategy=strat,
                               name=f"make_{n}").remote(shape, i)
    views = dict(zip(refs, rt.get(list(refs.values()), timeout=120)))
    spans = []
    for h in handles:
        arena = backend.arenas.handle(h.arena_name)
        lo = ctypes.addressof(arena._buf)
        spans.append((lo, lo + arena.capacity()))
    for i, (n, view) in enumerate(views.items()):
        addr = view.__array_interface__["data"][0]
        if (view.flags.writeable
                or not any(lo <= addr < hi for lo, hi in spans)
                or not np.array_equal(view, np.random.default_rng(i)
                                      .standard_normal(ATTN_SHAPES[n],
                                                       dtype=np.float32))):
            raise RuntimeError(f"phase 23(a): {n} is not a read-only view "
                               f"of its seed's values inside an arena")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        q, k, v = (torch.from_numpy(views[n]).to(dev).to(torch.bfloat16)
                   for n in ATTN_SHAPES)
        torch.cuda.synchronize()
    del views
    tracing.enable_tracing()
    try:
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        attn.flash_attention_kernel.launches = 0
        with tracing.span("flash_forward", shapes=str(ATTN_SHAPES)):
            start.record()
            out = attn.flash_attention_kernel(q, k, v, True)
            end.record()
            torch.cuda.synchronize()
        launches = attn.flash_attention_kernel.launches
        kernel_ms = start.elapsed_time(end)
        span = [s for s in tracing.get_spans()
                if s["name"] == "flash_forward"][-1]
        span_ms = (span["end_ns"] - span["start_ns"]) / 1e6
        plain = attn._flash_forward_plain(q, k, v, causal=True)
        torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
        err = (out.float() - plain.float()).abs().max().item()
        del plain
        if launches != 1 or not torch.isfinite(out).all():
            raise RuntimeError(f"phase 23(a): flash launches {launches}")
        if span_ms < kernel_ms:
            raise RuntimeError(f"phase 23(a): the span ({span_ms:.3f} ms) "
                               f"is shorter than the kernel's CUDA-event "
                               f"time ({kernel_ms:.3f} ms)")

        # q's task: eight phases from the driver, its daemon and a worker
        q_task = next(e["task_id"] for e in runtime.task_events.events()
                      if e["name"] == "make_q" and e["event"] == "RUNNING")
        backend._flush_task_events()
        deadline = time.monotonic() + 20
        while True:
            bd = state.task_breakdown(q_task)
            trace = state.cluster_timeline()
            lanes = trace_lanes(trace, q_task)
            if (bd["exec"] > 0 and bd["dispatch"] > 0
                    and bd["result_flush"] > 0
                    and {"driver", "daemon", "worker"} <= lanes):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(f"phase 23(a): q's task has the "
                                   f"breakdown {bd} and lanes {lanes}")
            time.sleep(0.2)
        if not any(s["name"] == "flash_forward" and s["pid"] == "trace"
                   for s in trace):
            raise RuntimeError("phase 23(a): the span is not in the "
                               "merged timeline")
    finally:
        tracing.disable_tracing()
        tracing.clear_spans()

    # export events: a placement group made and removed, an actor killed,
    # a job run to its end
    pg = placement_group([{"CPU": 1}])
    rt.get(pg.ready(), timeout=60)
    remove_placement_group(pg)

    @rt.remote
    class Probe:
        def ping(self):
            return "pong"

    a = Probe.remote()
    rt.get(a.ping.remote(), timeout=60)
    rt.kill(a)
    client = JobSubmissionClient()
    job = client.submit_job(entrypoint="echo phase23")
    if client.wait_until_finished(job, timeout=60) != "SUCCEEDED":
        raise RuntimeError(f"phase 23(a): the job ended "
                           f"{client.get_job_status(job)}")
    logger = get_export_logger()
    deadline = time.monotonic() + 10
    while True:
        kinds = {kind: logger.read(kind) for kind in
                 ("TASK", "ACTOR", "NODE", "JOB", "PLACEMENT_GROUP")}
        states = {kind: sorted({str(e["state"]) for e in evs})
                  for kind, evs in kinds.items()}
        if ("FINISHED" in states["TASK"]
                and any("DEAD" in s for s in states["ACTOR"])
                and "ALIVE" in states["NODE"]
                and "SUCCEEDED" in states["JOB"]
                and {"CREATED", "REMOVED"} <= set(states["PLACEMENT_GROUP"])):
            break
        if time.monotonic() > deadline:
            raise RuntimeError(f"phase 23(a): export events {states}")
        time.sleep(0.1)
    log(f"phase 23(a): 3 daemon tasks (the classic path: fast_lane off) "
        f"made q, k and v as f32 arena views; flash_fwd_wgmma, 1 launch, "
        f"inside tracing.span('flash_forward'): span {span_ms:.3f} ms, the "
        f"kernel {kernel_ms:.3f} ms by CUDA events, max_abs_err {err:.3e}; "
        f"q's task breakdown (s) "
        f"{json.dumps({p: float(f'{x:.6g}') for p, x in bd.items()})}, "
        f"lanes {sorted(lanes)} in a merged timeline of {len(trace)} "
        f"slices; export events "
        f"{ {kind: len(evs) for kind, evs in kinds.items()} } with states "
        f"{states} ({smi})")
    return {"qkv": (q, k, v), "out": out, "launches": launches,
            "max_abs_err": err, "kernel_ms": kernel_ms, "span_ms": span_ms,
            "breakdown": bd, "refs": refs}


@timed("23(b) obs_federation")
def obs_federation(runtime, smi: str) -> dict:
    """Phase 23(b): a user counter incremented once a task on both daemons
    sums to the tasks at the head's federated exposition, with the phase
    histogram labelled by both daemons; the dashboard's and the agents'
    endpoints answer; the CLI's read commands against the cluster exit 0.
    A task's print on a daemon reaches this process's stdout with JAX's
    prefix (23(d)'s log check)."""
    import os
    import urllib.request
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard.server import start_dashboard, stop_dashboard
    from ray_tpu_torch.util.metrics import cluster_prometheus_text
    backend = runtime.cluster_backend
    handles = list(backend.daemons.values())
    node_hexes = [h.node_id.hex() for h in handles]

    @rt.remote
    def tick(i):
        from ray_tpu_torch.util.metrics import Counter
        Counter("phase23_tasks_total", "phase 23's tasks").inc()
        print(f"phase23 tick {i} on a daemon")
        return i

    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        n_ticks = 8
        got = rt.get([tick.options(scheduling_strategy=(
            rt.NodeAffinitySchedulingStrategy(node_id=node_hexes[i % 2],
                                              soft=False))).remote(i)
            for i in range(n_ticks)], timeout=120)
        if got != list(range(n_ticks)):
            raise RuntimeError(f"phase 23(b): ticks gave {got}")
        expected = 3 + n_ticks       # 23(a)'s three makes and the ticks
        pattern = re.compile(r"\(worker node=(\w+) pid=(\d+)\) phase23 tick")
        deadline = time.monotonic() + 20
        while True:
            text = cluster_prometheus_text()
            total = sum(float(ln.rsplit(" ", 1)[1])
                        for ln in text.splitlines()
                        if ln.startswith("phase23_tasks_total{"))
            # the dispatch phase is recorded in the daemons only: its
            # series reach this exposition through the head
            phase_nodes = {h for h in node_hexes if any(
                ln.startswith("ray_tpu_task_phase_seconds_count{")
                and f'node_id="{h}"' in ln and 'phase="dispatch"' in ln
                for ln in text.splitlines())}
            printed = pattern.findall("".join(tee.seen))
            if (total == expected and len(phase_nodes) == 2
                    and {n[:8] for n, _ in printed}
                    == {h[:8] for h in node_hexes}):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"phase 23(b): the federated counter sums to {total} "
                    f"of {expected}, phase histograms of {phase_nodes}, "
                    f"daemon print lines {printed}")
            time.sleep(0.2)
    finally:
        sys.stdout = tee.out
    phase_lines = [ln for ln in text.splitlines()
                   if ln.startswith("ray_tpu_task_phase_seconds_count{")
                   and 'node_id="' in ln]
    host, port = start_dashboard(port=0)
    codes = {}
    try:
        for path in ("/api/nodes", "/api/tasks", "/api/objects",
                     "/api/timeline", "/metrics"):
            with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                        timeout=30) as r:
                codes[path] = r.status
                r.read()
        agents = {}
        for h in handles:
            agent = h.client.call("daemon_stats")["agent_port"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{agent}/api/stats", timeout=30) as r:
                agents[h.node_id.hex()[:8]] = (r.status, agent,
                                                json.loads(r.read())["pid"])
    finally:
        stop_dashboard()
    if set(codes.values()) != {200} or any(
            c != 200 for c, _, _ in agents.values()):
        raise RuntimeError(f"phase 23(b): dashboard {codes}, agents "
                           f"{agents}")
    env = dict(os.environ, RAY_TPU_ADDRESS=f"127.0.0.1:{backend._head_port}",
               CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    tl = os.path.join(backend.session_dir, "timeline.json")
    # three drivers join the cluster at once, each a process of its own
    with ThreadPoolExecutor(3) as pool:
        runs = [pool.submit(cli, *argv, env=env) for argv in
                (("status",), ("summary",), ("timeline", "--output", tl))]
        status, summary, _ = (json.loads(r.result().stdout) if i < 2
                              else r.result() for i, r in enumerate(runs))
    cli_s = time.perf_counter() - t0
    with open(tl) as f:
        cli_trace = json.load(f)
    if len(status["nodes"]) < 2 or not cli_trace:
        raise RuntimeError(f"phase 23(b): cli status {status}, timeline of "
                           f"{len(cli_trace)} slices")
    log(f"phase 23(b): phase23_tasks_total sums to {total:.0f} over the "
        f"daemons' node_id-labelled samples at the head ({expected} tasks); "
        f"{len(phase_lines)} ray_tpu_task_phase_seconds series carry a "
        f"node_id (both daemons); dashboard on port {port}: {codes}; the "
        f"agents {agents}; daemon workers' prints reached this stdout as "
        f"{sorted(set(printed))[:4]}...; cli status, summary ({summary}) "
        f"and timeline ({len(cli_trace)} slices), at once, against the "
        f"cluster in {cli_s:.1f} s ({smi})")
    return {"counter_sum": total, "tasks": expected,
            "dashboard_port": port,
            "agent_ports": [p for _, p, _ in agents.values()],
            "cli_s": cli_s}


@timed("23(c) obs_profile")
def obs_profile(dev, runtime, qkv, smi: str) -> dict:
    """Phase 23(c): the flash kernel launched in a loop for ~1.5 s by this
    process's main thread while ``cluster_profile(duration_s=1.0)`` samples
    every process from a thread of its own; records from the driver, both
    daemons and their workers, and the driver's stacks name the flash
    launcher. First, three launches from a fresh thread (one whose first
    CUDA call is the launch)."""
    import torch
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.util import state
    q, k, v = qkv
    backend = runtime.cluster_backend
    attn.flash_attention_kernel.launches = 0
    probe = {}

    def fresh_thread():
        try:
            for i in range(3):
                attn.flash_attention_kernel(q, k, v, True)
                probe["launched"] = i + 1
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - logged below
            probe["error"] = repr(e)[:160]

    t = threading.Thread(target=fresh_thread, name="flash-probe")
    t.start()
    t.join()
    if probe.get("launched") != 3 or "error" in probe:
        raise RuntimeError(f"phase 23(c): launches from a fresh thread: "
                           f"{probe}")
    got = {}

    def sample():
        got["prof"] = state.cluster_profile(duration_s=1.0)

    sampler = threading.Thread(target=sample, name="cluster-profile")
    t_end = time.perf_counter() + 1.5
    sampler.start()
    while time.perf_counter() < t_end:
        attn.flash_attention_kernel(q, k, v, True)
    torch.cuda.synchronize()
    sampler.join()
    counted = {"launches": attn.flash_attention_kernel.launches}
    prof = got["prof"]
    records = {r["proc"]: r for r in prof["records"]}
    samples = {p: r.get("samples", 0) for p, r in records.items()}
    driver = records.get("driver") or {}
    launcher = sum(n for stack, n in (driver.get("counts") or {}).items()
                   if "attention.py:" in stack or "_build.py:" in stack)
    per_daemon = {}
    for h in backend.daemons.values():
        mine = descendants({h.proc.pid})
        own = records.get(f"daemon:{h.node_id.hex()[:8]}") or {}
        workers = [p for p in records if p.startswith("worker:")
                   and int(p.split(":")[1]) in mine
                   and records[p].get("counts")]
        per_daemon[h.node_id.hex()[:8]] = (len(own.get("counts") or {}),
                                            workers)
    frames = len(prof["speedscope"]["shared"]["frames"])
    if (not launcher or counted.get("launches", 0) < 1
            or any(not n or not w for n, w in per_daemon.values())):
        raise RuntimeError(f"phase 23(c): the driver's launcher samples "
                           f"{launcher}, launches {counted}, per daemon "
                           f"(stacks, workers) {per_daemon}")
    log(f"phase 23(c): three launches from a fresh thread: {probe}; "
        f"cluster_profile(1.0 s) with the kernel in a loop: "
        f"samples per process {samples}; {launcher} of the driver's "
        f"thread-samples in the flash launcher (attention.py); per daemon "
        f"(stacks, worker records) {per_daemon}; {frames} shared frames in "
        f"the speedscope document; {counted['launches']} flash launches "
        f"({smi})")
    return {"launches": counted["launches"], "samples": samples,
            "launcher_samples": launcher, "thread_probe": probe}


@timed("23(d) obs_memory")
def obs_memory(out, smi: str) -> dict:
    """Phase 23(d), memory: on the local runtime the kernel's output (a
    CUDA tensor) is ``put``; the owner store's ``device-hbm`` tier holds
    exactly its bytes, and 0 once the ref is freed; the driver's memory
    monitor reports the host's limit."""
    import ray_tpu_torch as rt
    runtime = rt.init()
    try:
        nbytes = out.numel() * out.element_size()
        ref = rt.put(out)
        held = runtime.memory_store.tier_bytes()["device-hbm"]
        del ref
        deadline = time.monotonic() + 10
        while runtime.memory_store.tier_bytes()["device-hbm"]:
            if time.monotonic() > deadline:
                break
            gc.collect()
            time.sleep(0.02)
        after = runtime.memory_store.tier_bytes()["device-hbm"]
        mon = runtime.memory_monitor
        limit, used = mon.limit, mon.usage_bytes()
        if held != nbytes or after != 0 or limit <= 0:
            raise RuntimeError(f"phase 23(d): device-hbm held {held} of "
                               f"{nbytes} bytes, {after} after the free; "
                               f"the monitor's limit {limit}")
    finally:
        rt.shutdown()
    log(f"phase 23(d): the kernel's output put on the local runtime: "
        f"device-hbm {held} bytes (its {nbytes}), {after} once freed; the "
        f"memory monitor's host limit {limit} bytes "
        f"({limit / 2**30:.1f} GiB), {used / 2**30:.2f} GiB in use "
        f"({smi})")
    return {"device_bytes": held, "limit": limit, "used": used}


@timed("23(e) obs_trace_cost")
def obs_trace_cost(smi: str, pairs: int = 3, n: int = 2000) -> dict:
    """Phase 23(e): 2,000 no-op tasks on the default local runtime with
    ``task_trace`` on and off, three alternated pairs (tasks/s each, the
    ratio of medians), then ``cli microbenchmark --duration 0.5``."""
    import os
    import statistics
    import ray_tpu_torch as rt
    rates = {True: [], False: []}
    for i in range(pairs):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            rt.init(_system_config={"task_trace": on})
            try:
                @rt.remote
                def noop():
                    return None

                rt.get([noop.remote() for _ in range(50)])   # warm
                t0 = time.perf_counter()
                rt.get([noop.remote() for _ in range(n)], timeout=300)
                rates[on].append(n / (time.perf_counter() - t0))
            finally:
                rt.shutdown()
    ratio = statistics.median(rates[True]) / statistics.median(rates[False])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    table = [json.loads(line) for line in cli(
        "microbenchmark", "--duration", "0.5", env=env,
        timeout=300).stdout.splitlines() if line.startswith("{")]
    log(f"phase 23(e): {n} no-op tasks on the default init(): task_trace "
        f"on {[round(r, 1) for r in rates[True]]} tasks/s, off "
        f"{[round(r, 1) for r in rates[False]]} tasks/s (alternated), "
        f"on/off ratio of medians {ratio:.3f}; cli microbenchmark "
        f"--duration 0.5 (host figures of this machine, card hidden): "
        f"{ {r['name']: r['throughput_per_s'] for r in table} } ({smi})")
    return {"trace_on": rates[True], "trace_off": rates[False],
            "ratio": ratio, "microbenchmark": table}


def port_open(port: int) -> bool:
    import socket
    with socket.socket() as s:
        s.settimeout(0.5)
        return s.connect_ex(("127.0.0.1", port)) == 0


def observability_path(dev, smi=None) -> dict:
    """Phase 23: observability (see the module's docstring). Alone:
    ``python -c "import chip_smoke, torch;
    chip_smoke.observability_path(torch.device('cuda'))"``."""
    import glob
    import os
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.export_events import reset_export_logger
    t0 = time.perf_counter()
    smi = smi or card_name()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    reset_export_logger()
    # the classic path (the daemons read the flag from the environment
    # they are spawned with): JAX's fast lane records no dispatch or exec
    # span, as its own trace test routes around it
    lane_env = os.environ.get("RAY_TPU_FAST_LANE")
    os.environ["RAY_TPU_FAST_LANE"] = "0"
    try:
        runtime = rt.init(cluster="daemons", num_nodes=2,
                          resources={"CPU": 4},
                          _system_config={"export_events": True})
    finally:
        if lane_env is None:
            os.environ.pop("RAY_TPU_FAST_LANE")
        else:
            os.environ["RAY_TPU_FAST_LANE"] = lane_env
    backend = runtime.cluster_backend
    node_ids = [h.node_id.hex() for h in backend.daemons.values()]
    session = backend.session_dir
    pids: set = set()
    seen: list = []
    ports: list = []
    try:
        spans = obs_spans(dev, smi)
        pids = descendants(cluster_pids(runtime, set()))
        only_driver_on_card(pids, "23(a)", seen)
        fed = obs_federation(runtime, smi)
        ports = [fed["dashboard_port"], *fed["agent_ports"]]
        prof = obs_profile(dev, runtime, spans["qkv"], smi)
        pids |= descendants(cluster_pids(runtime, set()))
        only_driver_on_card(pids, "23(c)", seen)
        out = spans.pop("out")
        spans.pop("qkv")
        spans.pop("refs")
    finally:
        rt.shutdown()
        reset_export_logger()
    mem = obs_memory(out, smi)
    del out
    cost = obs_trace_cost(smi)
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in pids if _alive(p))
    segments = [s for n in node_ids
                for s in glob.glob(f"/dev/shm/rtpt_{n[:12]}*")]
    listening = [p for p in ports if port_open(p)]
    mapped = [p for p in pids if _alive(p) and maps_cuda(p)]
    if left or segments or listening or mapped or os.path.exists(session):
        raise RuntimeError(f"phase 23(f): processes {left} left, segments "
                           f"{segments}, ports {listening} listening, "
                           f"libcuda mapped by {mapped}, the session dir "
                           f"{os.path.exists(session)}")
    freed, _ = wait_freed(base, "phase 23 after shutdown()")
    if freed - base > 64 << 20:
        raise RuntimeError(f"phase 23(f): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 23(f): nvidia-smi listed one context, pids {seen}; none of "
        f"the {len(pids)} processes of the cluster left, no /dev/shm "
        f"segment of its arenas, none of the ports {ports} listening, no "
        f"session dir, {freed - base} bytes above the base; phase 23 in "
        f"{seconds:.1f} s ({smi})")
    result = {"part": "23", "flash_launches": spans["launches"]
              + prof["launches"], **{k: v for k, v in spans.items()
                                     if k != "launches"},
              "counter_sum": fed["counter_sum"], "tasks": fed["tasks"],
              "cli_s": fed["cli_s"], "profile_samples": prof["samples"],
              "launcher_samples": prof["launcher_samples"],
              "profile_launches": prof["launches"],
              "device_bytes": mem["device_bytes"],
              "host_limit": mem["limit"],
              "trace_on_tasks_per_s": cost["trace_on"],
              "trace_off_tasks_per_s": cost["trace_off"],
              "trace_ratio": cost["ratio"],
              "microbenchmark": {r["name"]: r["throughput_per_s"]
                                 for r in cost["microbenchmark"]},
              "bytes_after_shutdown": freed, "base_bytes": base,
              "seconds": seconds, "card": smi}
    log(json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# 24. chaos: failpoints, network chaos, the retry policy, memory pressure and
# the remote debugger
# ---------------------------------------------------------------------------

CHAOS_SEED = 24
# the driver's flush resends one lost batch; each daemon's result pump
# resends two lost completion frames; half the daemons' pushes are late
CHAOS_FAILPOINTS = ("batch.submit_flush=drop:max=1;"
                    "batch.result_flush=drop:max=2;"
                    "daemon.push_task=delay(20):p=0.5")
# the driver's frames to each daemon: 2-5 ms late and half of them sent
# twice, from 300 ms after the link's first frame (the hello) on
CHAOS_LINKS = "driver>daemon=lat=2:jitter=3:dup=0.5:start=300"


def chaos_make():
    """Phase 24's daemon task: one of phase 20's arrays from its seed, with
    a second return (the classic path: the submit coalescer and the result
    pump) and one line in ``path`` for each run of its body."""
    import ray_tpu_torch as rt

    @rt.remote(num_returns=2, max_retries=5)
    def make(shape, seed, path):
        with open(path, "a") as f:
            f.write(f"{seed}\n")
        return (np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32), seed)
    return make


def chaos_flash(dev, views: dict, part: str) -> tuple:
    """q, k and v (host arrays or arena views) to the card as bf16 and
    ``flash_fwd_wgmma`` once (the counter at 0 before it), held to the plain
    version at ``BF16_TOL``: (output, launches, max_abs_err)."""
    import warnings
    import torch
    from ray_tpu_torch.ops import attention as attn
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        q, k, v = (torch.from_numpy(np.asarray(views[n])).to(dev)
                   .to(torch.bfloat16) for n in ATTN_SHAPES)
    attn.flash_attention_kernel.launches = 0
    out = attn.flash_attention_kernel(q, k, v, True)
    launches = attn.flash_attention_kernel.launches
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    err = (out.float() - plain.float()).abs().max().item()
    if launches != 1 or not torch.isfinite(out).all():
        raise RuntimeError(f"phase 24({part}): flash launches {launches}")
    return out, launches, err


def exposition_sum(text: str, name: str, **labels) -> dict:
    """node_id (or "" for the driver's own series) -> the sum of the
    samples of ``name`` whose labels include ``labels``."""
    out: dict = {}
    for line in text.splitlines():
        if not line.startswith(name + "{") and not line.startswith(
                name + " "):
            continue
        body, value = line.rsplit(" ", 1)
        got = dict(re.findall(r'(\w+)="([^"]*)"', body))
        if all(got.get(k) == v for k, v in labels.items()):
            node = got.get("node_id", "")
            out[node] = out.get(node, 0.0) + float(value)
    return out


def chaos_track(runtime, track: dict) -> None:
    """Remember a cluster's processes, arenas and session dir for 24(f)."""
    backend = runtime.cluster_backend
    track["pids"] |= descendants(cluster_pids(runtime, set()))
    track["nodes"] += [h.node_id.hex() for h in backend.daemons.values()]
    track["sessions"].append(backend.session_dir)


@timed("24(a) chaos_seeded")
def chaos_seeded(dev, tmp: str, smi: str, track: dict) -> dict:
    """Phase 24(a): q, k and v made by daemon tasks and read into the flash
    kernel, on a cluster with nothing armed and on one with seed 24's
    failpoints and link policy; the outputs bit for bit, the fire counts,
    the daemons' retries and injected link effects at the head's
    federated exposition, duplicates answered once at the caller."""
    import os
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private import netchaos as nc
    from ray_tpu_torch._private.rpc import _WIRE_CLIENT_REQS
    from ray_tpu_torch.util.metrics import (cluster_prometheus_text,
                                            prometheus_text)
    runs = {}
    for armed in (False, True):
        cfg = ({"failpoints": CHAOS_FAILPOINTS, "failpoints_seed": CHAOS_SEED,
                "net_chaos": CHAOS_LINKS, "net_chaos_seed": CHAOS_SEED}
               if armed else {})
        path = os.path.join(tmp, f"made_{int(armed)}.txt")
        runtime = rt.init(cluster="daemons", num_nodes=2,
                          resources={"CPU": 4}, _system_config=cfg)
        try:
            chaos_track(runtime, track)
            handles = list(runtime.cluster_backend.daemons.values())
            time.sleep(0.4)     # past the link policy's 300 ms start
            t0 = time.perf_counter()
            make = chaos_make()
            refs = {n: make.remote(shape, i, path)
                    for i, (n, shape) in enumerate(ATTN_SHAPES.items())}
            views = dict(zip(refs, rt.get([r[0] for r in refs.values()],
                                          timeout=120)))
            seeds = rt.get([r[1] for r in refs.values()], timeout=60)
            out, launches, err = chaos_flash(dev, views, "a")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            del views
            if seeds != [0, 1, 2]:
                raise RuntimeError(f"phase 24(a): seeds {seeds}")
            with open(path) as f:
                ran = sorted(int(x) for x in f.read().split())
            if ran != [0, 1, 2]:
                raise RuntimeError(f"phase 24(a) armed={armed}: the bodies "
                                   f"ran {ran} (each exactly once)")
            only_driver_on_card(track["pids"], f"24(a) armed={armed}",
                                track["seen"])
            run = {"out": out, "launches": launches, "max_abs_err": err,
                   "seconds": seconds}
            if armed:
                # duplicates: pings on the chaotic links, one reply each
                calls0 = _WIRE_CLIENT_REQS.get("daemon_ping", 0)
                for _ in range(8):
                    for h in handles:
                        h.client.call("daemon_ping", timeout=10.0)
                calls = _WIRE_CLIENT_REQS.get("daemon_ping", 0) - calls0
                run["fires"] = {n: fp.fire_count(n) for n in
                                ("batch.submit_flush",)}
                run["driver_injected"] = {
                    e: nc.injected_count(e) for e in ("delay", "dup")}
                # the daemons' counters reach the head on their beats
                deadline = time.monotonic() + 15
                while True:
                    text = cluster_prometheus_text()
                    nodes = {h.node_id.hex() for h in handles}
                    retries = exposition_sum(text, "ray_tpu_retries_total")
                    links = exposition_sum(
                        text, "ray_tpu_link_chaos_injected_total")
                    served = exposition_sum(
                        text, "ray_tpu_rpc_server_requests_total",
                        method="daemon_ping")
                    d_retries = sum(v for k, v in retries.items()
                                    if k in nodes)
                    d_links = sum(v for k, v in links.items() if k in nodes)
                    d_served = sum(v for k, v in served.items()
                                   if k in nodes)
                    if (d_retries > 0 and d_links > 0
                            and d_served > calls) \
                            or time.monotonic() > deadline:
                        break
                    time.sleep(0.25)
                run.update(daemon_retries=d_retries, daemon_links=d_links,
                           pings=calls, pings_served=d_served,
                           driver_retries=exposition_sum(
                               prometheus_text(), "ray_tpu_retries_total",
                               loop="batch.submit_flush").get("", 0.0))
                if (run["fires"]["batch.submit_flush"] < 1
                        or run["driver_injected"]["dup"] < 1
                        or d_retries <= 0 or d_links <= 0
                        or d_served <= calls):
                    raise RuntimeError(f"phase 24(a): fire counts "
                                       f"{run['fires']}, the driver's "
                                       f"injected effects "
                                       f"{run['driver_injected']}, the "
                                       f"daemons' retries {retries} and "
                                       f"link effects {links}, {calls} pings "
                                       f"served {served} times")
            runs[armed] = run
        finally:
            rt.shutdown()
            fp.reset()
            nc.reset()
    if not torch.equal(runs[True]["out"], runs[False]["out"]):
        raise RuntimeError("phase 24(a): the armed output differs from the "
                           "unarmed one")
    a = runs[True]
    log(f"phase 24(a): seed {CHAOS_SEED}, failpoints '{CHAOS_FAILPOINTS}', "
        f"links '{CHAOS_LINKS}': 3 daemon tasks made q, k and v (each body "
        f"ran once) into flash_fwd_wgmma (1 launch, max_abs_err "
        f"{a['max_abs_err']:.3e}), bit for bit the unarmed output; the "
        f"driver's fires {a['fires']}, its injected effects "
        f"{a['driver_injected']}, its submit-flush retries "
        f"{a['driver_retries']:.0f}; the daemons' ray_tpu_retries_total "
        f"{a['daemon_retries']:.0f} and ray_tpu_link_chaos_injected_total "
        f"{a['daemon_links']:.0f} at the head's exposition; {a['pings']} "
        f"pings served {a['pings_served']:.0f} times, each answered once; "
        f"make-to-kernel {runs[False]['seconds']:.2f} s unarmed, "
        f"{a['seconds']:.2f} s armed ({smi})")
    return {"out": runs[False]["out"], "launches": runs[False]["launches"]
            + a["launches"], "max_abs_err": a["max_abs_err"],
            "unarmed_s": runs[False]["seconds"], "armed_s": a["seconds"],
            "fires": a["fires"], "driver_injected": a["driver_injected"],
            "daemon_retries": a["daemon_retries"],
            "daemon_link_effects": a["daemon_links"],
            "pings": a["pings"], "pings_served": a["pings_served"]}


@timed("24(b) chaos_partition")
def chaos_partition(dev, ref_out, tmp: str, smi: str, track: dict) -> dict:
    """Phase 24(b): the lane's first connect rides ``RetryPolicy`` past two
    injected errors; a one-way driver->daemon partition with a 3 s window
    opens in the middle of a burst of lane and classic tasks; the silent
    link ends in a typed timeout and the node's death, every task gives its
    value once, the victim's late result frames are fenced, and q, k and v
    made across the partition give (a)'s output bit for bit."""
    import os
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private import netchaos as nc
    from ray_tpu_torch.util.metrics import prometheus_text
    path = os.path.join(tmp, "made_b.txt")
    runtime = rt.init(cluster="daemons", num_nodes=2, resources={"CPU": 4},
                      _system_config={"control_call_timeout_s": 1.5})
    try:
        chaos_track(runtime, track)
        victim, survivor = list(runtime.cluster_backend.daemons.values())
        vh = victim.node_id.hex()
        fp.configure("cluster.lane_reconnect", "error", max_fires=2)

        @rt.remote(max_retries=5)
        def plain(i):
            time.sleep(0.02)
            return i * 7

        @rt.remote(max_retries=5, num_returns=2)
        def pair(i):
            time.sleep(0.02)
            return i, i * 11

        @rt.remote(max_retries=5, num_returns=2)
        def slow(i, mark):
            open(f"{mark}.{i}", "w").close()
            time.sleep(2.5)
            return i, -i

        t0 = time.perf_counter()
        pre = [pair.remote(i) for i in range(8)]
        pre_plain = [plain.remote(i) for i in range(8)]
        rt.get([r for pr in pre for r in pr] + pre_plain, timeout=60)
        reconnects = fp.fire_count("cluster.lane_reconnect")
        lane_retries = exposition_sum(prometheus_text(),
                                      "ray_tpu_retries_total",
                                      loop="fast_lane.reconnect").get("", 0)
        fenced0 = sum(exposition_sum(
            prometheus_text(), "ray_tpu_fenced_results_total").values())
        at_victim = rt.NodeAffinitySchedulingStrategy(node_id=vh, soft=True)
        mark = os.path.join(tmp, "slow_b")
        stale = [slow.options(scheduling_strategy=at_victim).remote(i, mark)
                 for i in range(2)]
        poll(lambda: all(os.path.exists(f"{mark}.{i}") for i in range(2)),
             30, "24(b): the slow bodies started on the victim")
        nc.activate(f"driver>daemon@{vh}=partition:dur=3000;"
                    f"driver>daemon@lane:{vh}=partition:dur=3000",
                    seed=CHAOS_SEED)
        make = chaos_make()
        refs = {n: make.options(scheduling_strategy=at_victim).remote(
                    shape, i, path)
                for i, (n, shape) in enumerate(ATTN_SHAPES.items())}
        post = [pair.remote(i) for i in range(8, 16)]
        post_plain = [plain.options(scheduling_strategy=at_victim).remote(i)
                      for i in range(8, 16)]
        vals = rt.get([r for pr in pre + post + stale for r in pr],
                      timeout=120)
        want = ([x for i in range(16) for x in (i, i * 11)]
                + [x for i in range(2) for x in (i, -i)])
        plains = rt.get(pre_plain + post_plain, timeout=120)
        views = dict(zip(refs, rt.get([r[0] for r in refs.values()],
                                      timeout=120)))
        out, launches, err = chaos_flash(dev, views, "b")
        torch.cuda.synchronize()
        burst_s = time.perf_counter() - t0
        del views
        deadline = time.monotonic() + 15
        while True:
            fenced = sum(exposition_sum(
                prometheus_text(), "ray_tpu_fenced_results_total").values())
            if fenced > fenced0 or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        drops = nc.injected_count("drop")
        links = sorted({e["policy"] for e in nc.hit_log()})
        if (vals != want or plains != [i * 7 for i in range(16)]
                or not victim.dead or drops < 1 or fenced <= fenced0
                or reconnects != 2 or lane_retries < 2
                or not torch.equal(out, ref_out)):
            raise RuntimeError(f"phase 24(b): values {vals == want} "
                               f"{plains}, victim dead {victim.dead}, "
                               f"{drops} frames dropped on {links}, fenced "
                               f"{fenced0} -> {fenced}, lane reconnect "
                               f"errors {reconnects} and retries "
                               f"{lane_retries}, output equal "
                               f"{torch.equal(out, ref_out)}")
        survived = rt.get(plain.remote(99), timeout=60)
    finally:
        rt.shutdown()
        fp.reset()
        nc.reset()
    log(f"phase 24(b): the lane's first connect rode RetryPolicy past "
        f"{reconnects} injected errors ({lane_retries:.0f} retries of loop "
        f"fast_lane.reconnect); a one-way partition driver->daemon "
        f"{vh[:8]} (control and lane, 3 s window) mid-burst dropped {drops} "
        f"frames on {links}: the silent flush timed out (1.5 s) and marked "
        f"the node dead, 34 tasks gave their values once, "
        f"ray_tpu_fenced_results_total {fenced0:.0f} -> {fenced:.0f} from "
        f"the victim's late frames, the survivor answered ({survived}); q, "
        f"k and v made across the partition into flash_fwd_wgmma (1 launch, "
        f"max_abs_err {err:.3e}) bit for bit (a)'s output; {burst_s:.2f} s "
        f"({smi})")
    return {"launches": launches, "max_abs_err": err, "drops": drops,
            "fenced": fenced - fenced0, "reconnect_errors": reconnects,
            "lane_retries": lane_retries, "seconds": burst_s}


@timed("24(c) chaos_pressure")
def chaos_pressure(dev, ref_out, tmp: str, smi: str, track: dict) -> dict:
    """Phase 24(c) and (d): ``memory_pressure`` on, each arena 8 x q's
    bytes (512 MiB), watermarks 0.2,0.45 and a spill budget of 1.5 x q's
    bytes (96 MiB); plain tasks make the arrays (one return: an arena entry
    of the array's bytes). A ballast over soft spills the cold q, which
    restores bit for bit into the kernel; three more with the budget spent
    go hard: a put rides ``RetryPolicy``
    through ``MemoryPressureError`` until refs are freed, and a task
    preferring the hard node lands on the other. Then a daemon task raises
    with post-mortem on: ``cli debug`` lists its session, ``rpdb.connect``
    prints a local and continues, and the error reaches the driver."""
    import os
    import threading
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.util import rpdb
    from ray_tpu_torch.util.metrics import prometheus_text
    qbytes = int(np.prod(ATTN_SHAPES["q"])) * 4
    env = {"RAY_TPU_MEMORY_PRESSURE": "1", "RAY_TPU_PRESSURE_TICK_S": "0.1",
           "RAY_TPU_ARENA_SPILL_WATERMARKS": "0.2,0.45",
           "RAY_TPU_ARENA_SPILL_BUDGET_BYTES": str(3 * qbytes // 2)}
    os.environ.update(env)
    try:
        runtime = rt.init(cluster="daemons", num_nodes=2,
                          resources={"CPU": 4},
                          object_store_memory=8 * qbytes)
    finally:
        for k in env:
            os.environ.pop(k, None)
    levels: list = []
    try:
        chaos_track(runtime, track)
        backend = runtime.cluster_backend
        victim, other = list(backend.daemons.values())
        t_base = time.perf_counter()
        on_level = victim._on_node_pressure

        def record(level):
            levels.append((round(time.perf_counter() - t_base, 3), level))
            log(f"phase 24(c): daemon {victim.node_id.hex()[:8]} -> {level} "
                f"at {levels[-1][0]:.3f} s")
            on_level(level)
        victim._on_node_pressure = record

        def wait_level(want, what, timeout=20.0):
            deadline = time.monotonic() + timeout
            while victim.pressure_level != want:
                if time.monotonic() > deadline:
                    raise RuntimeError(f"phase 24(c): {what}: the level "
                                       f"stayed {victim.pressure_level} "
                                       f"({levels})")
                time.sleep(0.02)

        def spill():
            return victim.client.call("daemon_stats")["spill"]

        @rt.remote
        def make(shape, seed):
            return np.random.default_rng(seed).standard_normal(
                shape, dtype=np.float32)

        pin = {"q": victim, "k": other, "v": other}
        refs = {n: make.options(scheduling_strategy=(
                    rt.NodeAffinitySchedulingStrategy(
                        node_id=pin[n].node_id.hex(), soft=False))).remote(
                    shape, i)
                for i, (n, shape) in enumerate(ATTN_SHAPES.items())}
        rt.wait(list(refs.values()), num_returns=3, timeout=120)
        at_victim = rt.NodeAffinitySchedulingStrategy(
            node_id=victim.node_id.hex(), soft=False)
        ballast = [make.options(scheduling_strategy=at_victim).remote(
            ATTN_SHAPES["q"], 100)]
        rt.wait(ballast, timeout=60)
        # soft: the controller spills the cold q down to the soft line
        deadline = time.monotonic() + 20
        while spill()["spills"] < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        soft_spill = spill()
        if soft_spill["spills"] < 1 or not any(lv == "soft"
                                               for _, lv in levels):
            raise RuntimeError(f"phase 24(c): no soft spill ({soft_spill}, "
                               f"levels {levels})")
        views = dict(zip(refs, rt.get(list(refs.values()), timeout=60)))
        restored = spill()
        out, launches, err = chaos_flash(dev, views, "c")
        torch.cuda.synchronize()
        only_driver_on_card(track["pids"], "24(c)", track["seen"])
        del views
        if restored["restores"] < 1 or not torch.equal(out, ref_out):
            raise RuntimeError(f"phase 24(c): restores {restored}, output "
                               f"equal {torch.equal(out, ref_out)}")
        # hard: more ballast with the spill budget spent
        ballast += [make.options(scheduling_strategy=at_victim).remote(
            ATTN_SHAPES["q"], 101 + i) for i in range(3)]
        wait_level("hard", "three more arrays of q's size")

        @rt.remote
        def where(x):
            return rt.get_runtime_context().get_node_id()

        landed = rt.get(where.remote(ballast[-1]), timeout=60)
        done: dict = {}
        node = runtime.get_node(victim.node_id)

        def put():
            t0 = time.perf_counter()
            try:
                node.store.put(ObjectID.from_random(),
                               np.ones(1 << 18, np.float32))
                done["s"] = time.perf_counter() - t0
            except Exception as e:  # noqa: BLE001 - reported below
                done["error"] = repr(e)

        def retries():
            return exposition_sum(prometheus_text(), "ray_tpu_retries_total",
                                  loop="put.backpressure").get("", 0.0)

        putter = threading.Thread(target=put, name="pressure-put")
        putter.start()
        # the put meets the hard level: its first retry, or its end
        poll(lambda: retries() >= 1 or not putter.is_alive(), 30,
             "24(c): the put met the hard level", every=0.05)
        retries_hard = retries()
        ballast.clear()         # relief: the refs go, the arena drains
        gc.collect()
        putter.join(timeout=35)
        wait_level("ok", "the ballast freed")
        if (landed != other.node_id.hex() or "error" in done
                or putter.is_alive() or retries_hard < 1):
            raise RuntimeError(f"phase 24(c): the task landed on "
                               f"{landed[:8]}, the put {done} (alive "
                               f"{putter.is_alive()}), put.backpressure "
                               f"retries {retries_hard}")
        log(f"phase 24(c): arenas of {8 * qbytes / 2**20:g} MiB, watermarks "
            f"0.2,0.45, spill budget {1.5 * qbytes / 2**20:g} MiB, tick 0.1 "
            f"s: a {qbytes / 2**20:g} MiB ballast on daemon "
            f"{victim.node_id.hex()[:8]} spilled the cold q ({soft_spill}); "
            f"its get restored it ({restored['restores']} restores) into "
            f"flash_fwd_wgmma (1 launch, max_abs_err {err:.3e}) bit for bit "
            f"(a)'s output; three more with the budget spent went hard: a task "
            f"preferring the hard node landed on {landed[:8]}, a put rode "
            f"RetryPolicy through MemoryPressureError "
            f"({retries_hard:.0f} retries of loop put.backpressure by 0.5 s) "
            f"and landed {done['s']:.2f} s after its start once the ballast "
            f"was freed; levels {levels} ({smi})")

        # (d) the remote debugger on a daemon worker
        @rt.remote(max_retries=0)
        def crash():
            import os as _os
            _os.environ["RAY_TPU_POST_MORTEM"] = "1"
            clue = "phase-24-clue"
            raise ValueError(f"exploded with {clue}")

        t0 = time.perf_counter()
        ref = crash.remote()
        deadline = time.monotonic() + 30
        sessions = []
        while not sessions and time.monotonic() < deadline:
            sessions = rpdb.sessions_from_kv(backend.head)
            time.sleep(0.05)
        address = f"{backend.head.addr[0]}:{backend.head.addr[1]}"
        listed = cli("debug", "--cluster", address)
        if not sessions or listed.returncode != 0 or \
                f"{sessions[0]['host']}:{sessions[0]['port']}" \
                not in listed.stdout:
            raise RuntimeError(f"phase 24(d): sessions {sessions}, cli "
                               f"debug {listed.returncode} "
                               f"{listed.stdout!r} {listed.stderr[-500:]}")
        s = sessions[0]
        transcript = rpdb.connect(s["host"], s["port"],
                                  commands=["p clue", "c"])
        try:
            rt.get(ref, timeout=60)
            raised = None
        except Exception as e:  # noqa: BLE001 - checked below
            raised = e
        left = rpdb.sessions_from_kv(backend.head)
        debug_s = time.perf_counter() - t0
        if ("phase-24-clue" not in transcript or raised is None
                or "exploded" not in str(raised) or left):
            raise RuntimeError(f"phase 24(d): transcript {transcript!r}, "
                               f"the driver got {raised!r}, sessions left "
                               f"{left}")
        log(f"phase 24(d): a daemon worker's task (pid {s['pid']}) raised "
            f"with post-mortem on; cli debug listed {s['host']}:{s['port']} "
            f"(task {str(s.get('task_id'))[:12]}), rpdb.connect printed "
            f"the local ('phase-24-clue') and continued, the driver got "
            f"{type(raised).__name__}; the session retracted; {debug_s:.2f} "
            f"s ({smi})")
    finally:
        rt.shutdown()
    return {"launches": launches, "max_abs_err": err, "levels": levels,
            "spills": restored["spills"], "restores": restored["restores"],
            "put_retries": retries_hard, "put_s": done["s"],
            "debug_s": debug_s}


@timed("24(e) chaos_disarmed")
def chaos_disarmed(phase19, smi: str) -> dict:
    """Phase 24(e): everything disarmed, the lane's no-op tasks/s on the
    default ``init()`` beside phase 19's figure (every seam then costs one
    module-global boolean read)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private import netchaos as nc
    if fp.ENABLED or nc.ENABLED:
        raise RuntimeError("phase 24(e): chaos still armed")
    rt.init()
    try:
        rate, _ = noop_rate(noop())
    finally:
        rt.shutdown()
    before = (phase19 or {}).get("lane_tasks_per_s")
    log(f"phase 24(e): everything disarmed, {rate:.0f} no-op lane tasks/s "
        f"(phase 19's {before if before is None else round(before)}) "
        f"({smi})")
    return {"lane_tasks_per_s": rate, "phase19_lane_tasks_per_s": before}


def chaos_path(dev, phase19=None, smi=None) -> dict:
    """Phase 24: chaos (see the module's docstring). Alone: ``python -c
    "import chip_smoke, torch; chip_smoke.chaos_path(torch.device('cuda'))"``
    (phase 19's figure is then absent from (e))."""
    import glob
    import os
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private import netchaos as nc
    t0 = time.perf_counter()
    smi = smi or card_name()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    # warm the kernel and the plain version's matmuls on small inputs, so
    # (a)'s first, unarmed run pays no module load when run alone
    warm = {n: np.ones((1, 128) + tuple(shape[2:]), np.float32)
            for n, shape in ATTN_SHAPES.items()}
    chaos_flash(dev, warm, "warm-up")
    del warm
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    track = {"pids": set(), "nodes": [], "sessions": [], "seen": []}
    try:
        a = chaos_seeded(dev, tmp, smi, track)
        b = chaos_partition(dev, a["out"], tmp, smi, track)
        c = chaos_pressure(dev, a["out"], tmp, smi, track)
        e = chaos_disarmed(phase19, smi)
    finally:
        fp.reset()
        nc.reset()
        if rt.is_initialized():
            rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    del a["out"]
    pids = track["pids"]
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in pids if _alive(p))
    segments = [s for n in track["nodes"]
                for s in glob.glob(f"/dev/shm/rtpt_{n[:12]}*")]
    sessions = [s for s in track["sessions"] if os.path.exists(s)]
    if left or segments or sessions:
        raise RuntimeError(f"phase 24(f): processes {left} left, segments "
                           f"{segments}, session (and spill) dirs "
                           f"{sessions}")
    freed, _ = wait_freed(base, "phase 24 after shutdown()")
    if freed - base > 64 << 20:
        raise RuntimeError(f"phase 24(f): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 24(f): nvidia-smi listed one context, pids "
        f"{track['seen']}; none of the {len(pids)} processes of the four "
        f"clusters left, no /dev/shm segment of their arenas, no session "
        f"or spill dir, {freed - base} bytes above the base; phase 24 in "
        f"{seconds:.1f} s ({smi})")
    launches = a["launches"] + b["launches"] + c["launches"]
    result = {"part": "24", "launches": launches,
              "seeded": a, "partition": b,
              "pressure": {k: v for k, v in c.items() if k != "levels"},
              "levels": c["levels"], "disarmed": e,
              "bytes_after_shutdown": freed, "base_bytes": base,
              "seconds": seconds, "card": smi}
    log(json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phase 25: tenancy, job config, runtime envs and the compiled DAG
# ---------------------------------------------------------------------------

# the compiled DAG's q, k and v: bench_400m's attention at batch 2 (32 MiB
# of f32 a round through each shared-memory channel)
DAG_SHAPES = {"q": (2, 2048, 8, 128), "k": (2, 2048, 4, 128),
              "v": (2, 2048, 4, 128)}
DAG_SCALE = {"q": 0.5, "k": 2.0, "v": -1.0}
TENANT_MODULE = """import os

import numpy as np


def make(shapes):
    return ({n: np.random.default_rng(i).standard_normal(s, dtype=np.float32)
             for i, (n, s) in enumerate(shapes.items())},
            os.environ.get("PHASE25_FLAG"), os.getpid())
"""


def make_qkv(shapes, base: int = 0) -> dict:
    """q, k and v from seeds ``base``, ``base + 1`` and ``base + 2``
    (phase 20's at ``base`` 0)."""
    return {n: np.random.default_rng(base + i).standard_normal(
        s, dtype=np.float32) for i, (n, s) in enumerate(shapes.items())}


def flash_checked(dev, qkv: dict, part: str):
    """q, k and v to the card as bf16 and ``flash_fwd_wgmma`` once, held to
    the plain version at ``BF16_TOL``: (output, max_abs_err). The launch
    counter is the phase's (it is not reset here)."""
    import warnings
    import torch
    from ray_tpu_torch.ops import attention as attn
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # from_numpy of a read-only view
        q, k, v = (torch.from_numpy(np.asarray(qkv[n])).to(dev)
                   .to(torch.bfloat16) for n in ("q", "k", "v"))
    out = attn.flash_attention_kernel(q, k, v, True)
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    if not torch.isfinite(out).all():
        raise RuntimeError(f"phase 25({part}): a non-finite output")
    return out, (out.float() - plain.float()).abs().max().item()


def p99(xs) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


def fair_share_run(dev, fairshare: bool, heavy: int, ref_out) -> dict:
    """One run of 25(a)'s A/B on ``init(num_nodes=1, resources={"CPU": 2})``:
    ``heavy`` sleeping tasks of the job "heavy" queued first (none with
    ``heavy`` 0), then eight tasks of the job "light", one at a time, each
    making q, k and v at phase 20's seeds and shapes; the driver runs each
    through the kernel, bit for bit ``ref_out`` once there is one."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.tenancy import job_context
    rt.init(num_nodes=1, resources={"CPU": 2},
            _system_config={"fairshare": fairshare})
    try:
        @rt.remote
        def slow():
            time.sleep(0.05)

        @rt.remote
        def light(shapes):
            import numpy as np
            return {n: np.random.default_rng(i).standard_normal(
                s, dtype=np.float32) for i, (n, s) in enumerate(shapes.items())}

        with job_context("light"):
            rt.get(light.remote({n: (1, 128) + s[2:]
                                 for n, s in ATTN_SHAPES.items()}))
        with job_context("heavy"):
            backlog = [slow.remote() for _ in range(heavy)]
        lats, errs = [], []
        with job_context("light", weight=1.0):
            for _ in range(8):
                t0 = time.perf_counter()
                qkv = rt.get(light.remote(ATTN_SHAPES), timeout=300)
                lats.append(time.perf_counter() - t0)
                out, err = flash_checked(dev, qkv, "a")
                errs.append(err)
                if ref_out is None:
                    ref_out = out
                elif not torch.equal(out, ref_out):
                    raise RuntimeError("phase 25(a): a light task's output "
                                       "is not the first one's bit for bit")
                del qkv, out
        rt.get(backlog, timeout=300)        # the heavy work still completes
        return {"p99_s": p99(lats), "lats_s": lats, "max_abs_err": max(errs),
                "launches": len(lats), "out": ref_out}
    finally:
        rt.shutdown()


@timed("25(a) quota_checks")
def quota_checks(smi: str) -> dict:
    """25(a)'s third job: a hard CPU quota of 0 queues its four tasks (the
    verdicts QUEUED, none runs), raising it to 2 runs all four; the
    dashboard's ``/api/jobs`` view is printed."""
    import urllib.request
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker
    from ray_tpu_torch.dashboard.server import start_dashboard, stop_dashboard
    from ray_tpu_torch.tenancy import job_context
    from ray_tpu_torch.util import metrics
    rt.init(num_nodes=1, resources={"CPU": 2},
            _system_config={"fairshare": True})
    try:
        runtime = worker.global_runtime()
        runtime.tenancy.set_quota("capped", hard={"CPU": 0.0})

        @rt.remote
        def work(i):
            return i * 10

        queued0 = sum(exposition_sum(metrics.prometheus_text(),
                                     "ray_tpu_admission_total",
                                     verdict="queued").values())
        with job_context("capped") as jid:
            refs = [work.remote(i) for i in range(4)]
        queued = sum(exposition_sum(metrics.prometheus_text(),
                                    "ray_tpu_admission_total",
                                    verdict="queued").values()) - queued0
        ready, _ = rt.wait(refs, num_returns=4, timeout=1.0)
        if queued != 4 or ready:
            raise RuntimeError(f"phase 25(a): the capped job's verdicts "
                               f"QUEUED {queued} of 4, {len(ready)} ran "
                               f"over the quota")
        runtime.tenancy.set_quota("capped", hard={"CPU": 2.0})
        values = sorted(rt.get(refs, timeout=60))
        if values != [0, 10, 20, 30]:
            raise RuntimeError(f"phase 25(a): the capped job gave {values}")
        _host, port = start_dashboard(port=0)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/api/jobs", timeout=30) as r:
                view = json.loads(r.read())
        finally:
            stop_dashboard()
        row = view["jobs"].get(jid.hex(), {})
        if not view["fairshare_enabled"] or row.get("name") != "capped" \
                or row.get("quota", {}).get("hard") != {"CPU": 2.0}:
            raise RuntimeError(f"phase 25(a): /api/jobs gave {view}")
        log(f"phase 25(a): /api/jobs {json.dumps(view, sort_keys=True)}")
        return {"queued": queued, "values": values}
    finally:
        rt.shutdown()


@timed("25(a) fair_share")
def fair_share(dev, smi: str) -> dict:
    """Phase 25(a): JAX's isolation A/B (tests/test_tenancy.py:403) with
    the light job's tasks making q, k and v into the kernel, and the
    quota'd third job."""
    solo = fair_share_run(dev, True, 0, None)
    on = fair_share_run(dev, True, 160, solo["out"])
    off = fair_share_run(dev, False, 160, solo["out"])
    bound = 3.0 * max(solo["p99_s"], 0.15)
    if on["p99_s"] > bound:
        raise RuntimeError(f"phase 25(a): fair share on, the light job's "
                           f"p99 {on['p99_s']:.3f} s > {bound:.3f} s")
    if off["p99_s"] <= 3.0 * solo["p99_s"]:
        raise RuntimeError(f"phase 25(a): fair share off, the light job's "
                           f"p99 {off['p99_s']:.3f} s is not above 3 x "
                           f"solo {solo['p99_s']:.3f} s")
    quota = quota_checks(smi)
    launches = solo["launches"] + on["launches"] + off["launches"]
    err = max(solo["max_abs_err"], on["max_abs_err"], off["max_abs_err"])
    log(f"phase 25(a): the light job's tasks made q {ATTN_SHAPES['q']}, k "
        f"and v {ATTN_SHAPES['k']} f32 into flash_fwd_wgmma ({launches} "
        f"launches, max_abs_err {err:.3e} against the plain version, each "
        f"bit for bit the first): p99 solo {solo['p99_s'] * 1e3:.1f} ms, "
        f"with 160 heavy tasks queued first {on['p99_s'] * 1e3:.1f} ms "
        f"under fair share (bound {bound * 1e3:.1f} ms), "
        f"{off['p99_s'] * 1e3:.1f} ms without; the capped job QUEUED "
        f"{int(quota['queued'])} of 4 and all ran after the raise ({smi})")
    return {"launches": launches, "max_abs_err": err, "out": solo["out"],
            "p99_ms": {"solo": solo["p99_s"] * 1e3, "on": on["p99_s"] * 1e3,
                       "off": off["p99_s"] * 1e3},
            "bound_ms": bound * 1e3}


@timed("25(b) runtime_envs")
def runtime_envs(dev, ref_out, tmp: str, smi: str) -> dict:
    """Phase 25(b): ``init(job_config=JobConfig(...))`` with an env var and
    a ``code_search_path`` module: a worker task imports the module, which
    makes q, k and v (the kernel's output bit for bit (a)'s) and reads the
    variable; a task's own ``working_dir`` env runs in a worker process."""
    import os
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.job_config import JobConfig
    mods = os.path.join(tmp, "search")
    wd = os.path.join(tmp, "wd")
    for d in (mods, wd):
        os.makedirs(d)
    with open(os.path.join(mods, "phase25_tenant.py"), "w") as f:
        f.write(TENANT_MODULE)
    with open(os.path.join(wd, "phase25_wd.py"), "w") as f:
        f.write("VALUE = 'from-the-working-dir'\n")
    rt.init(job_config=JobConfig(
        runtime_env={"env_vars": {"PHASE25_FLAG": "on"}},
        metadata={"phase": "25"}, code_search_path=[mods]))
    try:
        # the modules are this phase's own files, named by argument: the
        # worker finds them only through the job's and the task's envs
        @rt.remote
        def tenant(module, shapes):
            import importlib
            return importlib.import_module(module).make(shapes)

        @rt.remote(runtime_env={"working_dir": wd})
        def in_wd(module):
            import importlib
            import os as _os
            mod = importlib.import_module(module)
            return mod.VALUE, mod.__file__, _os.getpid()

        t0 = time.perf_counter()
        qkv, flag, pid = rt.get(tenant.remote("phase25_tenant", ATTN_SHAPES),
                                timeout=120)
        tenant_s = time.perf_counter() - t0
        value, path, wd_pid = rt.get(in_wd.remote("phase25_wd"), timeout=120)
    finally:
        rt.shutdown()
    me = os.getpid()
    if flag != "on" or pid == me or wd_pid == me or \
            value != "from-the-working-dir" or "pkg_cache" not in path:
        raise RuntimeError(f"phase 25(b): flag {flag!r}, pids {pid} and "
                           f"{wd_pid} (driver {me}), {value!r} from {path}")
    out, err = flash_checked(dev, qkv, "b")
    if not torch.equal(out, ref_out):
        raise RuntimeError("phase 25(b): the code_search_path module's "
                           "q, k and v did not give (a)'s output")
    log(f"phase 25(b): a worker task (pid {pid}) imported the job's "
        f"code_search_path module and read PHASE25_FLAG={flag} from the "
        f"job's env in {tenant_s:.2f} s; its q, k and v into "
        f"flash_fwd_wgmma bit for bit (a)'s (max_abs_err {err:.3e}); a "
        f"task's working_dir env ran in worker {wd_pid} from the package "
        f"cache ({smi})")
    return {"launches": 1, "max_abs_err": err, "tenant_s": tenant_s}


def dag_actors(in_process: bool):
    """The compiled DAG's stages: ``Make`` (q, k and v from seeds ``seed``
    to ``seed + 2``), ``Scale`` (each times its ``DAG_SCALE``) and
    ``Attend`` (to the card and the kernel; in-process always)."""
    import ray_tpu_torch as rt
    opts = {"_in_process": True} if in_process else {}

    @rt.remote(**opts)
    class Make:
        def __init__(self, shapes):
            self.shapes = shapes

        def run(self, seed):
            import numpy as np
            return {n: np.random.default_rng(int(seed) + i).standard_normal(
                s, dtype=np.float32)
                for i, (n, s) in enumerate(self.shapes.items())}

    @rt.remote(**opts)
    class Scale:
        def __init__(self, scale):
            self.scale = scale

        def run(self, qkv):
            import numpy as np
            return {n: (qkv[n] * np.float32(self.scale[n])).astype(
                np.float32) for n in ("q", "k", "v")}

    @rt.remote(_in_process=True)
    class Attend:
        def __init__(self, dev):
            self.dev = dev

        def run(self, qkv):
            return flash_checked(self.dev, qkv, "c")[0]

    return Make, Scale, Attend


@timed("25(c) compiled_dag")
def compiled_dag(dev, smi: str, rounds: int = 50, card_rounds: int = 10):
    """Phase 25(c): process-worker stages over shm channels make and scale
    q, k and v; ``rounds`` rounds compiled and ``rounds`` through
    ``.execute()`` (the dynamic path) give the same arrays bit for bit, the
    driver runs the kernel on each compiled round; then a channel-mode DAG
    of in-process stages whose last one calls the kernel on the card gives
    the driver's outputs bit for bit, compiled and dynamic."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.ops import attention as attn
    seeds = [100 + 3 * i for i in range(rounds)]
    rt.init()
    try:
        Make, Scale, Attend = dag_actors(False)
        make, scale = Make.remote(DAG_SHAPES), Scale.remote(DAG_SCALE)
        rt.get([make.run.remote(0), scale.run.remote(
            make_qkv({n: (1, 8) for n in DAG_SHAPES}))])
        with InputNode() as inp:
            dag = scale.run.bind(make.run.bind(inp))
        nbytes = sum(int(np.prod(s)) * 4 for s in DAG_SHAPES.values())
        compiled = dag.experimental_compile(
            buffer_size_bytes=nbytes + (1 << 20))
        if compiled._proc is None:
            raise RuntimeError("phase 25(c): the shm channel mode did not "
                               "engage")
        rt.get(compiled.execute(seeds[0]), timeout=120)     # warm
        n0 = attn.flash_attention_kernel.launches
        outs, errs, comp = [], [], []
        t0 = time.perf_counter()
        refs = [compiled.execute(s) for s in seeds]
        for ref in refs:
            comp.append(rt.get(ref, timeout=300))
        compiled_ms = (time.perf_counter() - t0) * 1e3 / rounds
        for i, qkv in enumerate(comp):
            out, err = flash_checked(dev, qkv, "c")
            errs.append(err)
            if i < card_rounds:
                outs.append(out)
        t0 = time.perf_counter()
        for s, got in zip(seeds, comp):
            dyn = rt.get(dag.execute(s), timeout=300)
            if any(not np.array_equal(dyn[n], got[n]) for n in got):
                raise RuntimeError(f"phase 25(c): round {s} compiled and "
                                   f"dynamic differ")
        dynamic_ms = (time.perf_counter() - t0) * 1e3 / rounds
        compiled.teardown()
        del comp
        # the channel-mode DAG: in-process stages, the last one on the card
        Make2, Scale2, _ = dag_actors(True)
        make2, scale2 = Make2.remote(DAG_SHAPES), Scale2.remote(DAG_SCALE)
        attend = Attend.remote(dev)
        with InputNode() as inp:
            dag2 = attend.run.bind(scale2.run.bind(make2.run.bind(inp)))
        compiled2 = dag2.experimental_compile()
        if compiled2._executors is None:
            raise RuntimeError("phase 25(c): the channel mode did not "
                               "engage")
        t0 = time.perf_counter()
        card = [rt.get(compiled2.execute(s), timeout=300)
                for s in seeds[:card_rounds]]
        card_ms = (time.perf_counter() - t0) * 1e3 / card_rounds
        card_dyn = [rt.get(dag2.execute(s), timeout=300)
                    for s in seeds[:card_rounds]]
        compiled2.teardown()
        for a, b, c in zip(card, card_dyn, outs):
            if not (torch.equal(a, c) and torch.equal(b, c)):
                raise RuntimeError("phase 25(c): the card stage's output is "
                                   "not the driver's bit for bit")
        launches = attn.flash_attention_kernel.launches - n0
        del card, card_dyn, outs
    finally:
        rt.shutdown()
    if launches != rounds + 2 * card_rounds:
        raise RuntimeError(f"phase 25(c): {launches} flash launches, not "
                           f"{rounds} + 2 x {card_rounds}")
    log(f"phase 25(c): {rounds} rounds of Make -> Scale over shm channels "
        f"(q {DAG_SHAPES['q']}, k and v {DAG_SHAPES['k']} f32, "
        f"{nbytes / 2**20:.0f} MiB a round) {compiled_ms:.2f} ms a round "
        f"compiled, {dynamic_ms:.2f} ms through .execute(), bit for bit; "
        f"flash_fwd_wgmma on each in the driver (max_abs_err "
        f"{max(errs):.3e}); the channel-mode DAG with the kernel in its "
        f"last, in-process stage {card_ms:.2f} ms a round, compiled and "
        f"dynamic bit for bit the driver's outputs ({smi})")
    return {"launches": launches, "max_abs_err": max(errs),
            "compiled_ms": compiled_ms, "dynamic_ms": dynamic_ms,
            "card_dag_ms": card_ms}


def tenancy_path(dev, smi=None) -> dict:
    """Phase 25: tenancy, job config, runtime envs and the compiled DAG
    (see the module's docstring). Alone: ``python -c "import chip_smoke,
    torch; chip_smoke.tenancy_path(torch.device('cuda'))"``."""
    import glob
    import os
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker_process as wp
    from ray_tpu_torch.ops import attention as attn
    t0 = time.perf_counter()
    smi = smi or card_name()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    shm_before = set(glob.glob("/dev/shm/*"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tenancy_")
    sessions = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    sessions_before = set(glob.glob(os.path.join(sessions, "session_*")))
    attn.flash_attention_kernel.launches = 0
    pids = set()
    try:
        a = fair_share(dev, smi)
        b = runtime_envs(dev, a["out"], tmp, smi)
        c = compiled_dag(dev, smi)
        pids = {w.pid for w in wp.live_workers()}
        template = wp.forkserver_pid()
    finally:
        if rt.is_initialized():
            rt.shutdown()
        wp.stop_worker_plane()
        shutil.rmtree(tmp, ignore_errors=True)
    launches = attn.flash_attention_kernel.launches
    if launches != a["launches"] + b["launches"] + c["launches"]:
        raise RuntimeError(f"phase 25: {launches} flash launches, the parts "
                           f"count {a['launches']} + {b['launches']} + "
                           f"{c['launches']}")
    del a["out"]
    deadline = time.monotonic() + 15
    left = pids | {template}
    while any(_alive(p) for p in left) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in left if _alive(p))
    segments = sorted(set(glob.glob("/dev/shm/*")) - shm_before)
    new_sessions = sorted(set(glob.glob(os.path.join(sessions, "session_*")))
                          - sessions_before)
    if left or wp.live_workers() or segments or new_sessions:
        raise RuntimeError(f"phase 25(d): processes {left}, "
                           f"{len(wp.live_workers())} workers, segments "
                           f"{segments}, session dirs {new_sessions} left")
    freed, _ = wait_freed(base, "phase 25 after shutdown()")
    if freed - base > 64 << 20:
        raise RuntimeError(f"phase 25(d): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 25(d): after shutdown() and stop_worker_plane() no worker "
        f"({len(pids)} were live) and no forkserver left, no new /dev/shm "
        f"segment (DAG channels, arenas), no session dir, {freed - base} "
        f"bytes above the base; phase 25 in {seconds:.1f} s, {launches} "
        f"flash launches ({smi})")
    result = {"part": "25", "launches": launches,
              "fair_share": {k: v for k, v in a.items()},
              "runtime_envs": b, "dag": c,
              "bytes_after_shutdown": freed, "base_bytes": base,
              "seconds": seconds, "card": smi}
    log(json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phase 26: topology on the card
# ---------------------------------------------------------------------------

TOPO_SPEC = "v5p:2x2x4"     # 16 chips, four hosts of a (2, 2, 1) block
TOPO_SEED = 26
TPU_VARS = ("TPU_VISIBLE_CHIPS", "TPU_ACCELERATOR_TYPE", "TPU_WORKER_ID",
            "TPU_NAME", "TPU_TOPOLOGY")


def topology_detect() -> dict:
    """26(a): with no pod variable set, the chips are the cards, the
    resources are ``GPU`` and the card's accelerator type, and one card
    forms no slice (JAX's single-host fallback gives None for one device)."""
    import os
    import torch
    from ray_tpu_torch._private import accelerators as acc
    from ray_tpu_torch.parallel import detect_local_topology
    saved = {v: os.environ.pop(v) for v in TPU_VARS if v in os.environ}
    try:
        count = torch.cuda.device_count()
        chips = acc.detect_tpu_chips()
        res = acc.accelerator_resources()
        topo = detect_local_topology()
    finally:
        os.environ.update(saved)
    kind = torch.cuda.get_device_name(0).lower().replace(" ", "")
    want = {"GPU": float(count), f"accelerator_type:{kind}-{count}": 1.0}
    if chips != count or res != want or (count == 1 and topo is not None):
        raise RuntimeError(f"phase 26(a): chips {chips} of {count} cards, "
                           f"resources {res} (want {want}), topology "
                           f"{topo!r}")
    log(f"phase 26(a): detect_tpu_chips() {chips} = "
        f"torch.cuda.device_count(); accelerator_resources() {res}; "
        f"detect_local_topology() {topo!r}"
        + (f" (pod variables {sorted(saved)} set aside)" if saved else ""))
    return {"chips": chips, "resources": res, "topology": repr(topo)}


def topo_qkv(dev):
    """q, k and v at phase 5's attention shapes, bf16, drawn on the card
    from ``TOPO_SEED``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(TOPO_SEED)
    return tuple(torch.randn(ATTN_SHAPES[n], generator=gen, device=dev,
                             dtype=torch.bfloat16) for n in ("q", "k", "v"))


def topology_flash(dev, ref_out, pg, bundles, part: str) -> int:
    """One ``num_gpus=1`` task in each of ``bundles`` of ``pg``: it draws q, k
    and v on the card and launches the flash kernel; each output is held
    bit for bit to ``ref_out`` (the driver's launch outside any group), and
    each task ran in this process on its bundle's node. The number of
    tasks."""
    import os
    import torch
    import ray_tpu_torch as rt

    @rt.remote(num_gpus=1, num_cpus=0)      # the bundles hold chips only
    def gang_flash():
        from ray_tpu_torch.ops import attention as attn
        q, k, v = topo_qkv(torch.device("cuda"))
        out = attn.flash_attention_kernel(q, k, v, True)
        return (out, os.getpid(),
                rt.get_runtime_context().get_node_id())

    refs = [gang_flash.options(
        scheduling_strategy=rt.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in bundles]
    for i, (out, pid, node) in zip(bundles, rt.get(refs, timeout=300)):
        if not torch.equal(out, ref_out):
            raise RuntimeError(f"phase 26({part}): bundle {i}'s kernel "
                               f"output is not the driver's bit for bit")
        if pid != os.getpid() or node != pg.bundles[i].node_id.hex():
            raise RuntimeError(f"phase 26({part}): bundle {i}'s task ran in "
                               f"pid {pid} on node {node[:8]}, not here on "
                               f"{pg.bundles[i].node_id.hex()[:8]}")
        del out
    del refs
    return len(bundles)


def topology_entry(pg, mgr) -> dict:
    """The group's claimed chips (one contiguous box), nodes and hosts."""
    from ray_tpu_torch.util import placement_group_table
    e = placement_group_table()[pg.id.hex()]
    chips = [tuple(c) for cs in e["bundle_chips"] for c in cs or []]
    lo = [min(c[i] for c in chips) for i in range(len(chips[0]))]
    hi = [max(c[i] for c in chips) for i in range(len(chips[0]))]
    box = int(np.prod([b - a + 1 for a, b in zip(lo, hi)]))
    if box != len(chips) or len(set(chips)) != len(chips):
        raise RuntimeError(f"phase 26: the claimed chips {chips} are not "
                           f"one contiguous box")
    return {"origin": tuple(e["subslice"]["origin"]),
            "shape": tuple(e["subslice"]["shape"]), "chips": len(chips),
            "nodes": len(set(e["bundle_nodes"])),
            "hosts": mgr.topology.hosts_of_subslice(pg.subslice)}


def topology_gang(dev, ref_out) -> dict:
    """26(b)-(d) on ``init(num_nodes=4, resources={"CPU": 4, "GPU": 4},
    _system_config={"tpu_topology": "v5p:2x2x4"})``; returns the launches
    and what each part saw, with the topology manager for (e)."""
    import os
    import tempfile
    import ray_tpu_torch as rt
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.util import placement_group, remove_placement_group
    runtime = rt.init(num_nodes=4, resources={"CPU": 4, "GPU": 4},
                      _system_config={"tpu_topology": TOPO_SPEC})
    mgr = runtime.tpu_topology
    log(f"phase 26(b): tpu_topology {TOPO_SPEC!r} is {mgr.topology!r}, a "
        f"virtual slice on one card: its four torus hosts bind to the "
        f"runtime's four nodes of 4 GPU each, and the one card runs every "
        f"task a bundle places")
    groups, tasks = [], 0
    try:
        # (b) one 8-chip box on exactly two hosts, a task a bundle
        pg_a = placement_group([{"GPU": 4}, {"GPU": 4}], "PACK")
        groups.append(pg_a)
        if not pg_a.wait(30):
            raise RuntimeError("phase 26(b): the PACK group did not place")
        b = topology_entry(pg_a, mgr)
        if b["chips"] != 8 or b["nodes"] != 2 or len(b["hosts"]) != 2:
            raise RuntimeError(f"phase 26(b): the group claimed {b}")
        tasks += topology_flash(dev, ref_out, pg_a, [0, 1], "b")
        log(f"phase 26(b): [{{GPU: 4}}, {{GPU: 4}}] PACK claimed the box at "
            f"{b['origin']} of shape {b['shape']} on hosts {b['hosts']} "
            f"(two nodes); its two tasks launched the kernel, each output "
            f"the driver's bit for bit")

        # (c) fill the slice: a third group stays pending until the first
        # is removed, then claims a contiguous box; a node's death
        pg_b = placement_group([{"GPU": 4}, {"GPU": 4}], "PACK")
        groups.append(pg_b)
        if not pg_b.wait(30):
            raise RuntimeError("phase 26(c): the second group did not place")
        pg_c = placement_group([{"GPU": 4}], "PACK")
        groups.append(pg_c)
        if pg_c.wait(1.5) or pg_c.state != "PENDING":
            raise RuntimeError(f"phase 26(c): a third group on a full slice "
                               f"is {pg_c.state}")
        remove_placement_group(pg_a)
        if not pg_c.wait(30):
            raise RuntimeError("phase 26(c): the third group did not place "
                               "once the first was removed")
        c1 = topology_entry(pg_c, mgr)
        tasks += topology_flash(dev, ref_out, pg_c, [0], "c")
        first, victim = pg_c.subslice, pg_c.bundles[0].node_id
        runtime.remove_node(runtime.get_node(victim))
        if not pg_c.wait(30):
            raise RuntimeError("phase 26(c): the group was not placed again "
                               "after its node's death")
        c2 = topology_entry(pg_c, mgr)
        held = mgr.topology._allocated
        if (pg_c.bundles[0].node_id == victim or first in held
                or sum(s is pg_c.subslice for s in held) != 1
                or len(held) != 2):
            raise RuntimeError(f"phase 26(c): after the death the allocator "
                               f"holds {held}, the group {c2}")
        tasks += topology_flash(dev, ref_out, pg_c, [0], "c")
        log(f"phase 26(c): 16 of 16 chips claimed, a third group PENDING; "
            f"with the first removed it claimed {c1['origin']} "
            f"{c1['shape']} on host {c1['hosts']} and its task launched the "
            f"kernel; its node removed, it was placed again at "
            f"{c2['origin']} {c2['shape']} on host {c2['hosts']}, the "
            f"allocator holding one slice for it (and the second group's), "
            f"and its task launched the kernel again, bit for bit")

        # (d) C25: a node that holds a running task while it drains takes
        # no new bundle, though it has the most free capacity
        big = runtime.add_node({"CPU": 16})
        marker = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_c25_"),
                              "started")

        @rt.remote
        def hold(path):
            open(path, "w").close()
            # held until the driver has placed and checked the group
            deadline = time.monotonic() + 30
            while not os.path.exists(f"{path}.release") \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            return os.getpid()

        held_ref = hold.options(
            scheduling_strategy=rt.NodeAffinitySchedulingStrategy(
                big.node_id.hex(), soft=False)).remote(marker)
        deadline = time.monotonic() + 60
        while not os.path.exists(marker) and time.monotonic() < deadline:
            time.sleep(0.02)
        if not os.path.exists(marker):
            raise RuntimeError("phase 26(d): the pinned task never started")
        if not rt.drain_node(big.node_id.hex(), deadline_s=30):
            raise RuntimeError("phase 26(d): the drain did not start")
        pg_d = placement_group([{"CPU": 1}], "PACK")
        groups.append(pg_d)
        if not pg_d.wait(30) or pg_d.bundles[0].node_id == big.node_id:
            raise RuntimeError(f"phase 26(d): the bundle is {pg_d.state} on "
                               f"the draining node")
        if not runtime.get_node(big.node_id).draining:
            raise RuntimeError("phase 26(d): the node stopped draining "
                               "before the group was placed")
        open(f"{marker}.release", "w").close()
        worker_pid = rt.get(held_ref, timeout=60)
        deadline = time.monotonic() + 30
        while (runtime.get_node(big.node_id) is not None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        os.remove(marker)
        os.remove(f"{marker}.release")
        os.rmdir(os.path.dirname(marker))
        log(f"phase 26(d): a task running in worker {worker_pid} on a "
            f"16-CPU node that drains; a PACK [{{CPU: 1}}] group created "
            f"then landed on node {pg_d.bundles[0].node_id.hex()[:8]}, not "
            f"the draining {big.node_id.hex()[:8]}; the drained node left: "
            f"{runtime.get_node(big.node_id) is None}")
        for pg in groups:
            remove_placement_group(pg)
        if mgr.topology._allocated:
            raise RuntimeError(f"phase 26(e): the allocator holds "
                               f"{mgr.topology._allocated} with every "
                               f"group removed")
        launches = attn.flash_attention_kernel.launches
        if launches != tasks:
            raise RuntimeError(f"phase 26: {launches} flash launches for "
                               f"{tasks} tasks")
        return {"launches": tasks, "pack": b, "third": c1, "replaced": c2,
                "mgr": mgr}
    finally:
        rt.shutdown()


def topology_path(dev, smi=None) -> dict:
    """Phase 26: topology on the card (see the module's docstring). Alone:
    ``python -c "import chip_smoke, torch;
    chip_smoke.topology_path(torch.device('cuda'))"``."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker_process as wp
    from ray_tpu_torch.ops import attention as attn
    t0 = time.perf_counter()
    smi = smi or card_name()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    a = topology_detect()
    # the driver's launch outside any group, held to the plain version
    q, k, v = topo_qkv(dev)
    ref_out = attn.flash_attention_kernel(q, k, v, True)
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(ref_out.float(), plain.float(), **BF16_TOL)
    err = (ref_out.float() - plain.float()).abs().max().item()
    if not torch.isfinite(ref_out).all():
        raise RuntimeError("phase 26: a non-finite output")
    del q, k, v, plain
    attn.flash_attention_kernel.launches = 0
    pids = set()
    try:
        gang = topology_gang(dev, ref_out)
        pids = {w.pid for w in wp.live_workers()}
        template = wp.forkserver_pid()
    finally:
        if rt.is_initialized():
            rt.shutdown()
        wp.stop_worker_plane()
    launches = attn.flash_attention_kernel.launches
    mgr = gang.pop("mgr")
    del ref_out
    # (e) nothing left
    deadline = time.monotonic() + 15
    left = pids | {template}
    while any(_alive(p) for p in left) and time.monotonic() < deadline:
        time.sleep(0.05)
    left = sorted(p for p in left if _alive(p))
    if left or wp.live_workers() or mgr.topology._allocated:
        raise RuntimeError(f"phase 26(e): processes {left}, "
                           f"{len(wp.live_workers())} workers, allocator "
                           f"{mgr.topology._allocated} left")
    freed, _ = wait_freed(base, "phase 26 after shutdown()")
    if freed - base > 64 << 20:
        raise RuntimeError(f"phase 26(e): {freed - base} bytes above the "
                           f"base after shutdown()")
    seconds = time.perf_counter() - t0
    log(f"phase 26(e): with the groups removed and after shutdown() the "
        f"allocator is empty, no worker ({len(pids)} were live) and no "
        f"forkserver left, {freed - base} bytes above the base; phase 26 in "
        f"{seconds:.1f} s, {launches} flash launches in the groups' tasks, "
        f"max_abs_err {err:.2e} against the plain version ({smi})")
    result = {"part": "26", "launches": launches, "max_abs_err": err,
              "detect": a, **gang, "bytes_after_shutdown": freed,
              "base_bytes": base, "seconds": seconds, "card": smi}
    log(json.dumps(result))
    return result


def _alive(pid) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    if pid is None:
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def stamp_runtime_calls() -> None:
    """Stamp every ``init`` and ``shutdown`` of the port's runtime as a
    sub-step: a daemon cluster's boot and teardown are seconds of host
    time."""
    import functools
    import ray_tpu_torch as rt

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            what = kw.get("cluster") or ("address" if kw.get("address")
                                         else "local")
            with timed(f"{fn.__name__}({what})"):
                return fn(*args, **kw)
        return run
    rt.init, rt.shutdown = wrap(rt.init), wrap(rt.shutdown)


def host_class() -> str:
    """This host's cores and a fixed pure-Python workload's ms: the
    host-bound phases run at that interpreter's pace (phase 7's MLP step
    is the steadier yardstick)."""
    import os
    import pickle
    blob = {str(i): list(range(20)) for i in range(2000)}
    t = time.perf_counter()
    for _ in range(20):
        pickle.loads(pickle.dumps(blob))
        sum(i * i for i in range(20000))
    ms = (time.perf_counter() - t) * 1e3
    return (f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} "
            f"usable; the Python yardstick {ms:.1f} ms")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    log(host_class())
    stamp_runtime_calls()
    from ray_tpu_torch import _build
    from ray_tpu_torch.bench import moe_bench_config
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models import LlamaModel, MoEModel
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    import os
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    smi = card_name()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log(smi)
    # the worker template (numpy and torch preloaded) starts while the
    # kernels build: phase 11's first worker process forks at once
    from ray_tpu_torch._private import worker_process
    threading.Thread(target=worker_process._mp_context, daemon=True,
                     name="worker-template").start()

    # 1. build, one nvcc per source, all at once; beside them g++ builds
    # the host tier's libraries and the C++ demo that phases 19-22 run
    t0 = time.perf_counter()
    names = ("decode_attention", "flash_attention")
    host = ThreadPoolExecutor(len(_build.HOST_LIBS) + 1)
    host_builds = [host.submit(_build.build_host, n)
                   for n in _build.HOST_LIBS] + [host.submit(build_demo)]
    host.shutdown(wait=False)
    with ThreadPoolExecutor(len(names)) as pool:
        lib_paths = list(pool.map(_build.build, names))
    for name, lib_path in zip(names, lib_paths):
        _build.load_library(name)
        log(f"build: {lib_path.name}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"built {len(names)} sources in {time.perf_counter() - t0:.1f} s")
    for b in host_builds:
        log(f"build: {os.path.basename(str(b.result()))}")
    log(f"with the host code's {len(host_builds)} in "
        f"{time.perf_counter() - t0:.1f} s")
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(check_sass, names, lib_paths))

    # 2. kernels against their plain versions
    rows = check_kernels(dev, gen)
    rows.append(check_flash(dev, gen))

    # 3. the serving path, every counter at 0
    llm_config, mix = serving_config(rng)
    cfg = llm_config.model_config
    t0 = time.perf_counter()
    server = LLMServer(llm_config, device=dev)
    torch.cuda.synchronize()
    log(f"LLMServer(llama3_8b, {cfg.num_params() / 1e9:.2f} B params, "
        f"{server.engine.num_blocks + 1} pool blocks of "
        f"{server.engine.block_size}) up in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        # the lone greedy request that phase 12 repeats through the actor
        lone = server({"prompt": mix["lone"], "max_tokens": 32})
        if len(lone["token_ids"]) != 32:
            raise RuntimeError(f"the lone request gave {lone}")
        steps0 = server.engine.stats["decode_steps"]
        paged.paged_decode_attention_kernel.launches = 0
        dec.ragged_decode_attention_kernel.launches = 0
        attn.flash_attention_kernel.launches = 0
        serving = serve_requests(server, mix)
        server.shutdown()
        dense_decode(server.model, server.engine.params, gen, 32, 1024, rng)
        launches = {"paged_decode_attention":
                    paged.paged_decode_attention_kernel.launches,
                    "ragged_decode_attention":
                    dec.ragged_decode_attention_kernel.launches,
                    "flash_attention": attn.flash_attention_kernel.launches}
    finally:
        server.shutdown()
    stats = server.stats()
    steps = stats["decode_steps"] - steps0
    log(f"served 16 requests: {serving['tokens']} tokens in "
        f"{serving['wall_s']:.2f} s ({serving['tokens'] / serving['wall_s']:.1f}"
        f" tokens/s, {serving['prompt_tokens']} prompt tokens), engine stats "
        f"{stats}")
    log(f"launches on the main path: {launches} ({steps} decode steps x "
        f"{cfg.n_layers} layers; one dense T=1 step x {cfg.n_layers})")
    if stats["prefix_prefills"] < 3 or stats["prefix_tokens_reused"] < 192:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    if steps < 1 or launches["paged_decode_attention"] != \
            cfg.n_layers * steps:
        raise RuntimeError(f"paged kernel launches {launches} != "
                           f"{cfg.n_layers} x {steps} decode steps")
    if launches["ragged_decode_attention"] != cfg.n_layers:
        raise RuntimeError(f"ragged kernel launches {launches} != "
                           f"{cfg.n_layers}")
    if launches["flash_attention"]:
        raise RuntimeError(f"the serving path launched the flash kernel: "
                           f"{launches}")
    for r in rows[:2]:
        r["launches"] = launches[r["name"]]

    # 4. kernel decode against reference decode on a live pool
    live = live_pool_compare(server, rng)
    log(f"decode_step_paged kernel vs reference on a live pool "
        f"({live['active_slots']} slots, {live['live_tokens']} cached "
        f"tokens, max_slots 32): logits max_abs_err "
        f"{live['logits_max_abs_err']:.3e} (atol 0.15 rtol 0.05); decode "
        f"step {live['step_ms']['kernel']:.2f} ms with the kernel, "
        f"{live['step_ms']['reference']:.2f} ms with the reference")
    log_prefix_compare(server, mix["lone"])
    del server, live
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the training path
    train = train_path(dev, BENCH_LAYERS)
    rows[2]["launches"] = train["launches"]

    # 6. the flash kernel's loss against the blockwise path
    loss_k, loss_b = kernel_vs_blockwise_loss(dev, LlamaModel,
                                              bench_config(), 8)
    log(f"loss through the flash kernel {loss_k:.6f}, through the blockwise "
        f"path {loss_b:.6f} (rtol 1e-3 atol 1e-4; bench_400m, f32 params, "
        f"bf16 compute, batch 8 x seq 2048)")
    free_card()

    # 7. the other model families train, every counter at 0 before each
    moe_cfg = moe_bench_config()
    runs = train_families(dev, moe_cfg.n_layers)
    rows[2]["launches"] += runs["moe"]["launches"]

    # 8. the MoE's flash path against its blockwise path; GPT-2 and ViT on
    # the card against the CPU
    loss_k, loss_b = kernel_vs_blockwise_loss(dev, MoEModel, moe_cfg, 2)
    log(f"MoE loss through the flash kernel {loss_k:.6f}, through the "
        f"blockwise path {loss_b:.6f} (rtol 1e-3 atol 1e-4; f32 params, "
        f"bf16 compute, batch 2 x seq 2048)")
    free_card()
    for name in ("gpt2", "vit"):
        card, cpu = card_vs_cpu_loss(dev, name)
        log(f"{name} f32 loss on the card {card:.6f}, on the CPU {cpu:.6f} "
            f"(rtol 1e-3; relative difference {abs(card / cpu - 1):.2e})")
        free_card()

    # 9. the mesh path, every counter at 0
    mesh = mesh_path(dev, train, runs["gpt2"], BENCH_LAYERS)
    rows[2]["launches"] += mesh["launches"]

    # 10. sequence, expert and pipeline parallelism, every counter at 0
    par = parallel_layouts(dev, gen, train, runs["moe"], BENCH_LAYERS)
    rows[2]["launches"] += par["moe"]["launches"] + \
        par["pipeline"]["launches"]

    # 11. the RL learners on the runtime, every counter at 0: no kernel of
    # the port runs
    rl = rl_path(dev)

    # 12. the runtime on the card: resources, the device tier, phase 3's
    # serving through an LLMServer actor (counters at 0), its own cost
    runtime = runtime_path(gen, llm_config, mix, lone["token_ids"], serving,
                           rl, smi)
    rows[0]["launches"] += runtime["serving"]["launches"][rows[0]["name"]]

    # 13. serve on the card: the LLM app through a handle and over HTTP,
    # freed on delete, the prefill/decode graph, the data plane's cost
    served = serve_path(dev, llm_config, mix, lone["token_ids"], serving,
                        runtime, smi)
    rows[0]["launches"] += served["launches"]

    # 14. the open-loop serving bench, every counter at 0 before each run
    bench = serving_bench_path(dev, smi)
    rows[0]["launches"] += bench["launches"]

    # 15. the train driver: JaxTrainer in a placement group holding the
    # card, the flash counter at 0 before each run
    driver = train_driver_path(dev, train, smi)
    rows[2]["launches"] += driver["launches"]

    # 16. tune and the utilities: Tune trials and Train-on-Tune on the
    # card, the flash counter at 0 before each part; util.collective,
    # ActorPool and Queue on CUDA tensors
    tuned = tune_path(dev, smi)
    rows[2]["launches"] += tuned["launches"]

    # 17. the data layer and the device feed: datasets on the runtime,
    # streamed through the pinned-memory prefetcher into bench_400m's step
    # (the flash counter at 0) and ViT-L/16
    fed = data_path(dev, train, smi)
    rows[2]["launches"] += fed["launches"]

    # 18. process workers, the runtime's default path: tasks and actors in
    # processes that cannot see the card, phase 17's stream and trainer
    # with the data's tasks in them (the flash counter at 0), the tensor
    # wire, nothing left after shutdown
    procs = process_path(dev, train, runtime, fed, smi)
    rows[2]["launches"] += procs["launches"]

    # 19. the native host tier: plain tasks through the fast lane's C++
    # core, arrays through the shared-memory store into the flash kernel,
    # phase 17(a)'s feed on the lane (the flash counter at 0), nothing left
    native = native_path(dev, train, procs, smi)
    rows[2]["launches"] += native["launches"]

    # 20. the daemon cluster: a head and two node daemons on the port's
    # wire, q, k and v made by daemon tasks and read from their arenas
    # into the flash kernel (the counter at 0 before each launch), a
    # daemon SIGKILLed and k rebuilt through lineage, only this process on
    # the card, nothing left after shutdown
    daemons = daemon_path(dev, train, native, smi)
    rows[2]["launches"] += daemons["launches"]

    # 21. the asyncio control-plane core (the default) against the threaded
    # one, a cluster stood up by the CLI and joined with init(address=),
    # q, k and v from its arenas into the flash kernel, a drain that
    # pushes k to the survivor (the kernel on it bit for bit), other
    # drivers (attach, a job, util.client), nothing left after `cli stop`
    control = control_plane_path(dev, train, smi)
    rows[2]["launches"] += control["launches"]

    # 22. the rest of the cluster: a lane-bound actor's q, k and v from the
    # arenas into the flash kernel and a native C++ program's q (bit for
    # bit), serve's second ingress on bench_400m's app (the paged kernel),
    # the autoscaler's real daemon and the launcher's cluster, nothing left
    tier = cluster_tier_path(dev, smi)
    rows[2]["launches"] += tier["flash_launches"]
    rows[0]["launches"] += tier["paged_launches"]

    # 23. observability: daemon tasks' q, k and v into the flash kernel
    # inside a span, their eight-phase breakdown and the merged timeline,
    # the federated metrics, the dashboard and the CLI, a cluster profile
    # with the kernel in a loop, the device tier's bytes, the workers'
    # logs, tracing's cost, nothing left
    observed = observability_path(dev, smi)
    rows[2]["launches"] += observed["flash_launches"]

    # 24. chaos: seed 24's failpoints and link policy on a daemon cluster
    # (q, k and v into the flash kernel bit for bit the unarmed output), a
    # partition that heals, memory pressure to soft and hard, the remote
    # debugger on a daemon worker, the disarmed lane's rate, nothing left
    chaos = chaos_path(dev, native, smi)
    rows[2]["launches"] += chaos["launches"]

    # 25. tenancy, job config, runtime envs and the compiled DAG: the
    # light job's q, k and v into the flash kernel under fair share (on
    # and off) beside a heavy backlog, a quota'd job queued and resumed,
    # a job config's env and code search path and a working_dir env in
    # worker processes, a compiled DAG over shm channels into the kernel
    # and a channel-mode DAG whose last stage runs it, nothing left
    tenancy = tenancy_path(dev, smi)
    rows[2]["launches"] += tenancy["launches"]

    # 26. topology: detection on the card, a declared v5p slice over four
    # nodes, gang groups that claim contiguous sub-slices and whose tasks
    # launch the flash kernel (the counter at 0), fragmentation, a node's
    # death, a bundle beside a drain, nothing left
    topo = topology_path(dev, smi)
    rows[2]["launches"] += topo["launches"]

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
